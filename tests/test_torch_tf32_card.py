"""The TF32 kernels of the MU precision ladder's coarse phase
(``csrc/mu_tf32.cu`` through the ``*_tf32`` wrappers of
``ops.mu_kernels``) against their plain twins, on a CUDA card: every
register bucket and a wide K, both sides (X read by rows and transposed by
its strides), B off the kernels' restart pairs, ragged rows and
contraction, zero K columns that must stay zero. Marked ``cuda``: without a
card every test skips. This file imports no JAX.

Run on a card: ``python -m pytest tests/test_torch_tf32_card.py -q``.

Tolerance: the kernel and its twin round the same operands to TF32 and
take exact products; they differ in two ways. (1) The f32 sums: the mma
adds each 8-entry product to its accumulator with its own rounding, so the
error grows with the contraction's C/8 steps (relative Frobenius error
1.1e-5 at C = 2700 on an H100; ``TF32_KERNEL_L2`` bounds it, and each
entry's share). (2) Where S differs in its last f32 bit, a TF32 rounding of
the elementwise factor can flip: one TF32 ulp, at most 2^-10 of that term.
Every term here is nonnegative, so flips move an entry by at most 2^-10 of
itself; a short contraction makes one term a large share of its entry (at
41-97 entries a flip moved the largest entry by 1.0-1.3e-4 of itself)."""

import numpy as np
import pytest
import torch

from cnmf_tpu_torch.ops import mu_kernels as mk
from torch_knobs import one_torch_thread  # noqa: F401 (autouse)

TF32_KERNEL_L2 = 1e-4
TF32_FLIP = 2.0 ** -10
# X's pitch a multiple of 4 floats (G=152, N=200; G=64) takes the kernels'
# 16-byte staging, any other their 4-byte one
CASES = [dict(B=3, N=131, G=77, K=8), dict(B=5, N=200, G=152, K=16),
         dict(B=1, N=67, G=300, K=24), dict(B=4, N=97, G=64, K=40),
         dict(B=2, N=90, G=45, K=64), dict(B=3, N=70, G=41, K=72)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the TF32 kernels run on a card only")
    return torch.device("cuda")


def _problem(dev, B, N, G, K, transposed):
    rng = np.random.RandomState(B * 1000 + K)
    X = (rng.gamma(1.0, 1.0, (N, G)) * (rng.rand(N, G) > 0.3)).astype(
        np.float32)
    avg = np.sqrt(X.mean() / K)
    W = (avg * np.abs(rng.randn(B, N, K))).astype(np.float32)
    Ht = (avg * np.abs(rng.randn(B, G, K))).astype(np.float32)
    W[:, :, -2:] = 0.0
    Ht[:, :, -2:] = 0.0
    Xd = (torch.as_tensor(np.ascontiguousarray(X.T), device=dev).T
          if transposed else torch.as_tensor(X, device=dev))
    return Xd, torch.as_tensor(W, device=dev), torch.as_tensor(Ht, device=dev)


def flip_bound(a, b):
    """Every entry within 2^-10 + TF32_KERNEL_L2 of itself (plus 1e-6 of
    the largest value), and the relative Frobenius error within
    TF32_KERNEL_L2: (ok, relative Frobenius error, max error / largest
    value)."""
    d, top = (a - b).abs(), float(b.abs().max())
    l2 = float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
    ok = bool((d <= (TF32_FLIP + TF32_KERNEL_L2) * b.abs()
               + 1e-6 * top).all())
    return ok and l2 <= TF32_KERNEL_L2, l2, float(d.max()) / max(top, 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("shape", CASES, ids=lambda s: f"K{s['K']}")
@pytest.mark.parametrize("name,beta", [
    ("kl_mu_w_numerator_tf32", None), ("kl_mu_h_numerator_tf32", None),
    ("kl_x_log_wh_tf32", None), ("beta_mu_w_terms_tf32", 0.0),
    ("beta_mu_h_terms_tf32", 0.0), ("beta_mu_w_terms_tf32", 1.5),
    ("beta_mu_h_terms_tf32", 1.5)])
def test_tf32_kernel_matches_its_twin(card, name, beta, shape, transposed):
    X, W, Ht = _problem(card, **shape, transposed=transposed)
    args = (X, W, Ht) if beta is None else (X, W, Ht, beta)
    fn, twin = getattr(mk, name), getattr(mk, name + "_plain")
    before = fn.launches
    out = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    outs = out if isinstance(out, tuple) else (out,)
    refs = twin(*args)
    refs = refs if isinstance(refs, tuple) else (refs,)
    for a, b in zip(outs, refs):
        assert torch.isfinite(a).all()
        ok, l2, rel = flip_bound(a, b)
        assert ok, (name, beta, shape, l2, rel)
        if a.ndim == 3:
            assert not a[:, :, -2:].any()


@pytest.mark.cuda
def test_tf32_wrappers_refuse_what_they_do_not_take(card):
    X, W, Ht = _problem(card, B=2, N=40, G=30, K=16, transposed=False)
    with pytest.raises(ValueError, match="own path"):
        mk.beta_mu_w_terms_tf32(X, W, Ht, 1.0)
    with pytest.raises(ValueError, match="multiple of 8"):
        mk.kl_mu_w_numerator_tf32(X, W[:, :, :12].contiguous(),
                                  Ht[:, :, :12].contiguous())
    with pytest.raises(TypeError, match="float32"):
        mk.kl_x_log_wh_tf32(X.double(), W.double(), Ht.double())
