"""The TF32 kernels of the MU precision ladder's coarse phase
(``csrc/mu_tf32.cu`` through the ``*_tf32`` wrappers of
``ops.mu_kernels``) against their plain twins, on a CUDA card: every
register bucket and a wide K, both sides (X read by rows and transposed by
its strides), beta 0, 0.5, 1.5 and 3, B off the kernels' restart tiles (1,
R - 1, R + 1 and 100 at every bucket), ragged rows and contraction, X's
pitch a multiple of 4 floats (TMA) or not (4-byte cp.async), zero K columns
that must stay zero; a restart's output bits the same at every B and in
every slot of the restart tile; the staging of the contracted factor bit
for bit against ``tf32_stage_plain``; the divergence term's partials per
row tile against their float64 plain version, the same bits on two
launches and whether X moves by TMA or by cp.async (an unaligned view). Marked ``cuda``: without a card every
test skips. This file imports no JAX.

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
         dict(B=2, N=90, G=45, K=64), dict(B=3, N=70, G=41, K=72),
         dict(B=6, N=150, G=96, K=32), dict(B=3, N=129, G=50, K=48),
         dict(B=2, N=70, G=128, K=56)]
BUCKETS = (8, 16, 24, 32, 40, 48, 56, 64)
# (wrapper, beta): the KL numerators, and the beta terms at each beta
TERMS = [("kl_mu_w_numerator_tf32", None), ("kl_mu_h_numerator_tf32", None)] + [
    (f"beta_mu_{side}_terms_tf32", beta) for beta in (0.0, 0.5, 1.5, 3.0)
    for side in "wh"]
DIVERGENCE = "kl_x_log_wh_tf32"
XLW = [(DIVERGENCE, None)]
# the divergence term per restart against its float64 plain version
XLW_EXACT = 1e-6


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


def _check_twin(name, beta, X, W, Ht, note):
    """One launch of the wrapper ``name``, counted, within ``flip_bound``
    of its twin, its zero K columns zero; returns its outputs."""
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
        assert ok, (name, beta, note, l2, rel)
        if a.ndim == 3:
            assert not a[:, :, -2:].any()
    if name == DIVERGENCE:
        exact = mk.kl_x_log_wh_tf32_partials_plain(
            X.cpu(), W.cpu(), Ht.cpu()).sum(dim=0)
        err = ((outs[0].double().cpu() - exact).abs() / exact.abs()).max()
        assert float(err) <= XLW_EXACT, (note, float(err))
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("shape", CASES, ids=lambda s: f"K{s['K']}")
@pytest.mark.parametrize("name,beta", [
    ("kl_mu_w_numerator_tf32", None), ("kl_mu_h_numerator_tf32", None),
    ("kl_x_log_wh_tf32", None), ("beta_mu_w_terms_tf32", 0.0),
    ("beta_mu_h_terms_tf32", 0.0), ("beta_mu_w_terms_tf32", 1.5),
    ("beta_mu_h_terms_tf32", 1.5), ("beta_mu_w_terms_tf32", 0.5),
    ("beta_mu_h_terms_tf32", 0.5), ("beta_mu_w_terms_tf32", 3.0),
    ("beta_mu_h_terms_tf32", 3.0)])
def test_tf32_kernel_matches_its_twin(card, name, beta, shape, transposed):
    X, W, Ht = _problem(card, **shape, transposed=transposed)
    _check_twin(name, beta, X, W, Ht, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("K", (8, 16, 64))
@pytest.mark.parametrize("name,beta", TERMS + XLW, ids=str)
def test_tf32_zero_rows(card, name, beta, K):
    """Zero rows of W and Ht make S zero along a row and a column: the
    floored factors (eps), and for 1 < beta < 2 the den factor of S
    unfloored (0), as the twin computes them."""
    X, W, Ht = _problem(card, 3, 131, 77, K, transposed=False)
    W[:, 5] = 0.0
    Ht[:, 7] = 0.0
    _check_twin(name, beta, X, W, Ht, ("zero rows", K))


def _tile(name, beta, K):
    """The restarts a block of the wrapper ``name``'s kernel owns at K (beta
    None: the KL numerator, or the divergence term)."""
    op = (mk.TF32_DIVERGENCE_OP if name == DIVERGENCE else mk.tf32_op(beta))
    return mk.library_constant("mu_tf32_restarts", K, op)


@pytest.mark.cuda
@pytest.mark.parametrize("K", BUCKETS)
@pytest.mark.parametrize("name,beta", TERMS[:4] + TERMS[6:7] + XLW, ids=str)
def test_tf32_restart_tiles(card, name, beta, K):
    """B = 1, R - 1, R + 1 and 100 restarts at every bucket, on ragged rows
    and contraction with X's pitch a multiple of 4 floats (TMA) and not
    (cp.async)."""
    R = _tile(name, beta, K)
    for B in sorted({1, max(R - 1, 1), R + 1, 100}):
        for N, G in ((131, 77), (200, 152)):
            X, W, Ht = _problem(card, B, N, G, K, transposed=False)
            _check_twin(name, beta, X, W, Ht, (B, N, G, K))


@pytest.mark.cuda
@pytest.mark.parametrize("K", BUCKETS)
@pytest.mark.parametrize("name,beta", TERMS + XLW, ids=str)
def test_tf32_restart_bits_do_not_depend_on_its_slot(card, name, beta, K):
    """Each restart of a batch of 2R + 1 has the bits it has alone (B=1) and
    in the batch rolled by one (every restart in another slot of its
    restart tile, the last one in the first tile)."""
    R = _tile(name, beta, K)
    B = 2 * R + 1
    X, W, Ht = _problem(card, B, 150, 120, K, transposed=False)
    fn = getattr(mk, name)
    args = () if beta is None else (beta,)

    def run(W, Ht):
        out = fn(X, W, Ht, *args)
        return out if isinstance(out, tuple) else (out,)

    full = run(W, Ht)
    rolled = run(W.roll(1, 0).contiguous(), Ht.roll(1, 0).contiguous())
    for a, b in zip(full, rolled):
        assert torch.equal(a, b.roll(-1, 0)), (name, beta, K)
    for b in (0, R - 1, R, B - 1):
        alone = run(W[b:b + 1].contiguous(), Ht[b:b + 1].contiguous())
        for a, c in zip(full, alone):
            assert torch.equal(a[b:b + 1], c), (name, beta, K, b)


@pytest.mark.cuda
@pytest.mark.parametrize("K", BUCKETS)
def test_tf32_stage_matches_plain(card, K):
    """``mu_tf32_stage`` writes ``tf32_stage_plain``'s bits: chunks past C
    and restarts past B zero."""
    chunk = mk.library_constant("mu_tf32_chunk")
    rng = np.random.RandomState(K)
    for B, C, Bp in ((1, 77, 4), (5, 200, 8), (3, 33, 3)):
        F = torch.as_tensor(rng.gamma(1.0, 1.0, (B, C, K)).astype(np.float32),
                            device=card)
        got = mk.tf32_stage(F, Bp)
        torch.cuda.synchronize()
        assert torch.equal(got, mk.tf32_stage_plain(F, Bp, chunk)), (B, C, K)


@pytest.mark.cuda
def test_tf32_x_mode(card):
    """X moves by TMA where its pitch is a multiple of 4 floats (read by
    rows or transposed), by 4-byte cp.async otherwise."""
    X, _, _ = _problem(card, 1, 40, 64, 8, transposed=False)
    assert mk.tf32_x_mode(X) == 0
    assert mk.tf32_x_mode(X, transposed=True) == 1
    X, _, _ = _problem(card, 1, 40, 63, 8, transposed=False)
    assert mk.tf32_x_mode(X) == 2
    assert mk.tf32_x_mode(X, transposed=True) == 2


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


@pytest.mark.cuda
@pytest.mark.parametrize("K", BUCKETS + (72,))
def test_tf32_divergence_partials(card, K):
    """The divergence kernel's partials, one a (``tf32_rows(K)``-row tile,
    restart), each within 1e-6 of its float64 plain version relative to
    the tile's sum of |X·log(max(S, eps))|, the same bits on a second
    launch; ``tf32_rows`` is the library's ``mu_tf32_rows``."""
    assert mk.tf32_rows(K) == mk.library_constant("mu_tf32_rows", K)
    X, W, Ht = _problem(card, 5, 300, 152, K, transposed=False)
    part = mk.kl_x_log_wh_tf32_partials(X, W, Ht)
    again = mk.kl_x_log_wh_tf32_partials(X, W, Ht)
    torch.cuda.synchronize()
    assert torch.equal(part, again)
    Xc, Wc, Hc = X.cpu(), W.cpu(), Ht.cpu()
    exact = mk.kl_x_log_wh_tf32_partials_plain(Xc, Wc, Hc)
    assert part.shape == exact.shape, (part.shape, exact.shape)
    WH = torch.bmm(mk.tf32_round(Wc).double(),
                   mk.tf32_round(Hc).double().transpose(1, 2))
    mag = torch.where(Xc.double() > mk.EPSILON, Xc.double() * torch.log(
        WH.clamp(min=mk.EPSILON)).abs(), 0.0)
    rows = mk.tf32_rows(K)
    for i in range(part.shape[0]):
        tile = mag[:, i * rows:(i + 1) * rows].sum(dim=(1, 2))
        err = (part[i].cpu() - exact[i]).abs() / tile.clamp(min=1e-30)
        assert float(err.max()) <= XLW_EXACT, (K, i, float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("K", (8, 16))
def test_tf32_divergence_unaligned_x_takes_cp_async(card, K):
    """A row shard of X whose pitch is not a multiple of 4 floats, and a
    view of X whose base is 4 bytes off 16, move X by 4-byte cp.async and
    give the bits of the same values in an aligned buffer (by TMA where
    its pitch allows)."""
    X, W, Ht = _problem(card, 5, 301, 77, K, transposed=False)
    shard, Ws = X[1:], W[:, 1:].contiguous()
    assert mk.tf32_x_mode(shard) == 2 and mk.tf32_x_mode(shard.clone()) == 2
    flat = torch.empty(300 * 76 + 1, device=card)
    off = flat[1:].view(300, 76)
    off.copy_(X[1:, :76])
    aligned = off.clone()
    assert mk.tf32_x_mode(off) == 2 and mk.tf32_x_mode(aligned) == 0
    Hs = Ht[:, :76].contiguous()
    for view, copy, w, h in ((shard, shard.clone(), Ws, Ht),
                             (off, aligned, Ws, Hs)):
        got = _check_twin(DIVERGENCE, None, view, w, h, ("view", K))
        assert torch.equal(got[0], mk.kl_x_log_wh_tf32(copy, w, h))
