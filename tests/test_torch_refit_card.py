"""The two kernels the consensus refits launch, against their plain twins on
a CUDA card: the KL numerator with its contraction split across blocks
(``mu_kl_numerator_split``, through ``kl_mu_w_numerator`` and
``kl_mu_h_numerator`` where ``ops.mu_kernels.split_plan`` splits them) and
the products-given CD sweep (``cd_sweep_from_products``: one launch, l2
added in the kernel, the violation summed inside it). Marked ``cuda``:
without a card every test skips. This file imports no JAX.

Run on a card from the repository's root (``chip_smoke.py``'s profiler
helper is imported from there): ``python -m pytest --noconftest
tests/test_torch_refit_card.py -q``.

Tolerance: ``KERNEL_REL`` of the largest value, as ``chip_smoke.py`` holds
every kernel (f32; the twins' products are cuBLAS's, in another order)."""

import numpy as np
import pytest
import torch

from chip_smoke import device_kernels
from cnmf_tpu_torch.ops import cd_kernels as ck
from cnmf_tpu_torch.ops import mu_kernels as mk
from torch_knobs import one_torch_thread  # noqa: F401 (autouse)

KERNEL_REL = 1e-4
# (B, N, G, K): one-row grids under 2 waves, so the numerators split; G and
# N off the 32-entry chunks
SPLIT_CASES = [(1, 1500, 700, 16), (1, 2700, 2000, 8), (2, 900, 333, 24),
               (1, 1201, 515, 64)]
# (B, M, K): the refits' B = 1 (each of the three tilings), a batch, a wide K
PRODUCT_CASES = [(1, 10000, 16), (1, 2700, 8), (1, 40000, 16), (3, 1001, 24),
                 (1, 5000, 64), (2, 300, 72)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run on a card only")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("side", ["w", "h"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: f"K{c[3]}")
def test_kl_numerator_split_matches_its_twin(card, case, side, view):
    """The split launch against the twin summing the same slices in order,
    the same bits on a second launch, zero K columns kept at zero; the
    wrapper counts both launches as the split entry point's."""
    B, N, G, K = case
    rng = np.random.RandomState(K + N)
    X = (rng.gamma(1.0, 1.0, (N, G)) * (rng.rand(N, G) > 0.3)).astype(
        np.float32)
    avg = np.sqrt(X.mean() / K)
    W = (avg * np.abs(rng.randn(B, N, K))).astype(np.float32)
    Ht = (avg * np.abs(rng.randn(B, G, K))).astype(np.float32)
    W[:, :, -2:] = 0.0
    Ht[:, :, -2:] = 0.0
    Xd = (torch.as_tensor(np.ascontiguousarray(X.T), device=card).T if view
          else torch.as_tensor(X, device=card))
    W, Ht = (torch.as_tensor(a, device=card) for a in (W, Ht))
    h = side == "h"
    kernel = mk.kl_mu_h_numerator if h else mk.kl_mu_w_numerator
    plain = mk.kl_mu_h_numerator_plain if h else mk.kl_mu_w_numerator_plain
    tiling = mk.kl_numerator_tiling(Xd, B, K, h)
    splits, per_split = tiling[4:]
    assert splits > 1, tiling
    before = kernel.launches_split
    out = kernel(Xd, W, Ht)
    again = kernel(Xd, W, Ht)
    torch.cuda.synchronize()
    assert kernel.launches_split == before + 2
    assert torch.equal(out, again)
    assert not out[:, :, -2:].any()
    assert _rel(out, plain(Xd, W, Ht, per_split=per_split)) <= KERNEL_REL


@pytest.mark.cuda
@pytest.mark.parametrize("l2", [0.0, 0.2])
@pytest.mark.parametrize("case", PRODUCT_CASES,
                         ids=lambda c: f"B{c[0]}M{c[1]}K{c[2]}")
def test_products_sweep_matches_its_twin(card, case, l2):
    """Factor and violation within KERNEL_REL of the twin (l1 = 0.1), one
    device kernel a call, and at B = 1 the factor's and the violation's bits
    of the same restart inside a batch that takes the bucket's whole tile
    of rows (another tiling)."""
    B, M, K = case
    rng = np.random.RandomState(M + K)
    avg = np.sqrt(1.0 / K)
    F = (avg * np.abs(rng.randn(B, M, K))).astype(np.float32)
    Hfix = (avg * np.abs(rng.randn(B, 700, K))).astype(np.float32)
    F[:, :, -2:] = 0.0
    Hfix[:, :, -2:] = 0.0
    F, Hfix = (torch.as_tensor(a, device=card) for a in (F, Hfix))
    gram = ck._gram(Hfix)
    P = torch.as_tensor(rng.gamma(1.0, 1.0, (B, M, K)).astype(np.float32),
                        device=card) * gram.diagonal(dim1=1, dim2=2)[:, None]
    regs = dict(l1_reg=0.1, l2_reg=l2)
    out, viol = ck.cd_sweep_from_products(F, gram, P, **regs)
    ref, ref_viol = ck.cd_sweep_from_products_plain(F, gram, P, **regs)
    assert _rel(out, ref) <= KERNEL_REL
    assert _rel(viol, ref_viol) <= KERNEL_REL
    assert not out[:, :, -2:].any()
    assert len(device_kernels(
        lambda: ck.cd_sweep_from_products(F, gram, P, **regs))) == 1
    if B == 1:
        # a block of the bucket's whole tile on every SM at least
        copies = torch.cuda.get_device_properties(card).multi_processor_count
        big = ck.products_tiling(copies, M, K)
        assert big[0] >= ck.products_tiling(1, M, K)[0]
        batch = [t.expand(copies, *t.shape[1:]).contiguous()
                 for t in (F, gram, P)]
        out_b, viol_b = ck.cd_sweep_from_products(*batch, **regs)
        assert torch.equal(out_b[:1], out) and torch.equal(viol_b[:1], viol)
