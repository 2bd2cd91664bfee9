"""Fused multiplicative-update terms: CUDA kernels and their plain twins.

Port of the five Pallas kernels of ``cnmf_tpu/ops/pallas_mu.py``:
``kl_mu_w_numerator`` (:89), ``kl_mu_h_numerator`` (:394) and
``kl_x_log_wh`` (:357) for the KL loss (beta=1), ``beta_mu_w_terms`` (:198)
and ``beta_mu_h_terms`` (:281) for any other beta but 2 (0 is
Itakura-Saito). Each wrapper takes the solver layout — X (N, G) shared by
every restart, W (B, N, K), Ht (B, G, K) — and dispatches on where its
tensors lie:

* CUDA tensors launch the hand-written kernels of ``csrc/mu_kl.cu`` and
  ``csrc/mu_beta.cu`` (f32; W and Ht contiguous; X with any positive
  strides, so a transposed view of X needs no copy; K a positive multiple of
  8). Anything else on CUDA raises; there is no fallback to the plain
  version. The KL numerators take one of two kernels by shape
  (``kl_numerator_tiling``); both give the same bits. The general-beta
  terms and the KL divergence term do the same (``beta_terms_tiling``,
  ``kl_x_log_wh_tiling``), and where the one-row kernel's grid is too
  small to fill the card (``split_plan``: the B=1 consensus refits) all
  three split the contraction across blocks, whose partials are summed in
  a fixed order.
* CPU tensors run the plain PyTorch versions below at the tensors' dtype.

The plain versions follow the JAX package's XLA path (``_mu_w_terms_chunked``,
``_mu_h_terms_chunked`` and ``_beta_divergence_chunked`` of
``cnmf_tpu/ops/nmf.py``): they loop over chunks of restarts, so only a
(CHUNK, N, G) reconstruction is ever live. ``mu_w_terms_plain`` and
``mu_h_terms_plain`` give the numerator and denominator for any beta != 2.

Each wrapper counts its kernel launches in a ``launches`` attribute, and
those with one restart (B=1, the consensus and k-stats refits) also in
``launches_b1``; the f32 wrappers count their launches of a split entry
point also in ``launches_split``.

The ``*_tf32`` wrappers are the coarse phase of the MU precision ladder
(``ops.nmf.nmf_mu_precision_ladder``): the same functions with both
products in TF32 on the tensor cores (``csrc/mu_tf32.cu``; any K a multiple
of 8, any B). They replace no Pallas kernel: the JAX package's coarse phase
runs its "default"-precision XLA products (cnmf_tpu/ops/nmf.py:1092-1207,
:1036). At K = 8..64 all three run warpgroup ``wgmma`` products: the KL
numerators and the beta terms on two TF32 copies of the contracted factor,
which the same C call first writes into scratch the wrapper allocates
(``tf32_stage_plain`` is their plain version and ``tf32_stage_order``
their layout), the divergence term on the first copy alone, which its
kernel writes into shared memory itself, into double partials per tile of
``tf32_rows(K)`` rows (``kl_x_log_wh_tf32_partials_plain``). Their plain
twins round F, Fo and the elementwise factor to
TF32 with ``tf32_round``, as the kernels do, then run the f32 plain terms;
the twins serve the tests and ``chip_smoke.py``, never the solvers, which
take the TF32 route on CUDA tensors only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cnmf_tpu_torch.ops.kernel_lib import (
    F32,
    I32,
    I64,
    VP,
    check_cuda,
    check_k,
    device_kind,
    kernel_function,
    launch,
    library_constant,
)

EPSILON = float(np.finfo(np.float32).eps)
CHUNK = 8   # restarts per reconstruction in the plain versions


# ----------------------------------------------------------------------
# plain PyTorch versions
# ----------------------------------------------------------------------

def wh_chunks(W, Ht):
    """(restart slice, W chunk, Ht chunk, WH (CHUNK, N, G)) per chunk."""
    for s in range(0, W.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        yield sl, W[sl], Ht[sl], torch.bmm(W[sl], Ht[sl].transpose(1, 2))


def _num_ratio(X, WH, beta):
    """X ∘ WH^(β−2), WH floored at eps where the exponent is negative."""
    WH_num = WH.clamp(min=EPSILON) if beta < 2 else WH
    if beta == 1:
        return X / WH_num
    if beta == 0:
        return X / (WH_num * WH_num)
    return X * WH_num.pow(beta - 2.0)


def _den_factor(WH, beta):
    """WH^(β−1), WH floored at eps where the exponent is negative."""
    WH_den = WH.clamp(min=EPSILON) if beta < 1 else WH
    return WH_den.pow(beta - 1.0)


# segments of a factor's rows that ``restart_sums`` sums apart
SUM_SEGMENTS = 32


def restart_sums(F):
    """Σ over dim 1 of F (B, M, K) → (B, K), in an order that depends on
    neither B nor a restart's place in the batch. A PyTorch reduction picks
    its split from its output count (on one H100, ``F.sum(dim=1)`` gave
    other bits at K=64 for 56 of 104 restarts than inside the 104), so a
    device ladder's smaller batches would change the bits. Here each of
    ``SUM_SEGMENTS`` contiguous segments of the rows is summed in row order
    by one thread (a scan along an outer dimension runs sequentially), then
    the segments in order; rows past M are zeros."""
    B, M, K = F.shape
    rows = -(-M // SUM_SEGMENTS)
    pad = rows * SUM_SEGMENTS - M
    if pad:
        F = torch.cat([F, F.new_zeros((B, pad, K))], dim=1)
    seg = F.reshape(B, SUM_SEGMENTS, rows, K).cumsum(dim=2)[:, :, -1]
    return seg.cumsum(dim=1)[:, -1]


def kl_w_denominator(Ht):
    """The KL W-update denominator Σ_g H, (B, 1, K) (nmf.py:1071)."""
    return restart_sums(Ht)[:, None, :]


def kl_h_denominator(W):
    """The KL Ht-update denominator Σ_n W with 0 mapped to 1, (B, 1, K)
    (nmf.py:1147-1148)."""
    w_sum = restart_sums(W)
    return torch.where(w_sum == 0, 1.0, w_sum)[:, None, :]


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32``: the 13 low mantissa bits of the
    magnitude rounded off, a carry moving into the exponent (the largest
    finite values round to inf); inf and nan are kept. Subnormals round as
    their bits do."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.view(torch.int32)
    rounded = (bits + 0x1000) & -0x2000
    special = (bits & 0x7F800000) == 0x7F800000
    return torch.where(special, bits, rounded).view(torch.float32)


def _rounded(t, rnd):
    return t if rnd is None else rnd(t)


def _sliced_bmm(A, B, per_split):
    """A·B over their shared axis in slices of ``per_split`` entries (None:
    one slice), each slice's product and then the slices' sum in order."""
    if per_split is None:
        return torch.bmm(A, B)
    out = None
    for lo in range(0, A.shape[-1], per_split):
        part = torch.bmm(A[..., lo:lo + per_split], B[:, lo:lo + per_split])
        out = part if out is None else out + part
    return out


def mu_w_terms_plain(X, W, Ht, beta: float, per_split=None, rnd=None):
    """W-update numerator (X ∘ WH^(β−2))·Hᵀ and denominator (β=1:
    ``kl_w_denominator``, else WH^(β−1)·Hᵀ), each (B, N, K); beta != 2.
    ``per_split``: sum the contraction (G) in slices of that many entries and
    then the slices in order, as a split launch of the general-beta kernel
    does (``split_plan``). ``rnd``: applied to each elementwise factor
    before its product (the TF32 twins' ``tf32_round``)."""
    num = torch.empty_like(W)
    den = None if beta == 1 else torch.empty_like(W)
    for sl, _, Htb, WH in wh_chunks(W, Ht):
        num[sl] = _sliced_bmm(_rounded(_num_ratio(X, WH, beta), rnd), Htb,
                              per_split)
        if den is not None:
            den[sl] = _sliced_bmm(_rounded(_den_factor(WH, beta), rnd), Htb,
                                  per_split)
    if den is None:
        den = kl_w_denominator(Ht).expand_as(num)
    return num, den


def mu_h_terms_plain(X, W, Ht, beta: float, per_split=None, rnd=None):
    """Ht-update numerator Wᵀ·(X ∘ WH^(β−2)) and denominator (β=1:
    ``kl_h_denominator``, else Wᵀ·WH^(β−1)), each (B, G, K); beta != 2.
    ``per_split`` and ``rnd`` as in ``mu_w_terms_plain``, the contraction
    here over N."""
    num = torch.empty_like(Ht)
    den = None if beta == 1 else torch.empty_like(Ht)
    for sl, Wb, _, WH in wh_chunks(W, Ht):
        num[sl] = _sliced_bmm(
            _rounded(_num_ratio(X, WH, beta), rnd).transpose(1, 2), Wb,
            per_split)
        if den is not None:
            den[sl] = _sliced_bmm(
                _rounded(_den_factor(WH, beta), rnd).transpose(1, 2), Wb,
                per_split)
    if den is None:
        den = kl_h_denominator(W).expand_as(num)
    return num, den


def kl_mu_w_numerator_plain(X, W, Ht, per_split=None):
    """Plain version of ``kl_mu_w_numerator``; ``per_split`` as
    ``mu_w_terms_plain`` takes it."""
    return mu_w_terms_plain(X, W, Ht, 1.0, per_split=per_split)[0]


def kl_mu_h_numerator_plain(X, W, Ht, per_split=None):
    """Plain version of ``kl_mu_h_numerator``; ``per_split`` as
    ``mu_h_terms_plain`` takes it (the contraction over N)."""
    return mu_h_terms_plain(X, W, Ht, 1.0, per_split=per_split)[0]


# plain versions of beta_mu_w_terms and beta_mu_h_terms (beta ∉ {1, 2})
beta_mu_w_terms_plain = mu_w_terms_plain
beta_mu_h_terms_plain = mu_h_terms_plain


def kl_x_log_wh_plain(X, W, Ht, per_split=None):
    """Plain version of ``kl_x_log_wh``. ``per_split``: sum the contraction
    (G) in slices of that many entries, each slice's sum and then the slices'
    in order, as a split launch does (``split_plan``)."""
    mask = X > EPSILON
    out = torch.empty(W.shape[0], dtype=W.dtype, device=W.device)
    for sl, _, _, WH in wh_chunks(W, Ht):
        term = torch.where(mask, X * torch.log(WH.clamp(min=EPSILON)), 0.0)
        if per_split is None:
            out[sl] = term.sum(dim=(1, 2))
            continue
        slices = [term[..., lo:lo + per_split].sum(dim=(1, 2))
                  for lo in range(0, term.shape[-1], per_split)]
        out[sl] = functools.reduce(torch.add, slices)
    return out


# the TF32 kernels' staged copies of the contracted factor (csrc/mu_tf32.cu,
# stage_kernel): the second product takes S's accumulator column 2t of each
# 8 entries as its k = t and column 2t + 1 as its k = t + 4, so its copy holds
# the entries of each 8 in this order
TF32_PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32_stage_order(K: int, chunk: int):
    """(entry, k) of a restart's chunk of the contracted factor (``chunk``
    entries of K values) that each float of its staged copy holds, as two
    int arrays of 2·chunk·K: first the S product's operand [K/4][chunk][4],
    then the second product's [chunk/4][K][4] with the entries of each 8 in
    ``TF32_PERM``'s order."""
    i = np.arange(chunk * K)
    s_entry, s_k = i % (4 * chunk) // 4, i // (4 * chunk) * 4 + i % 4
    pos = i // (4 * K) * 4 + i % 4
    t_entry = pos // 8 * 8 + np.asarray(TF32_PERM)[pos % 8]
    return (np.concatenate([s_entry, t_entry]),
            np.concatenate([s_k, i % (4 * K) // 4]))


def tf32_stage_plain(F_other, Bp: int, chunk: int):
    """Plain version of ``mu_tf32_stage``: F_other (B, C, K) for Bp >= B
    restarts as (ceil(C / chunk), Bp, 2·chunk·K), each chunk of each restart
    in ``tf32_stage_order``'s layout, ``tf32_round``-ed, zero past C and
    B."""
    B, C, K = F_other.shape
    nq = -(-C // chunk)
    padded = F_other.new_zeros((Bp, nq * chunk, K))
    padded[:B, :C] = F_other
    entry, k = tf32_stage_order(K, chunk)
    rows = torch.as_tensor(np.arange(nq)[:, None] * chunk + entry[None, :])
    cols = torch.as_tensor(np.broadcast_to(k, rows.shape).copy())
    return tf32_round(padded[:, rows, cols].transpose(0, 1).contiguous())


# the TF32 twins: the operands of both products rounded as the kernels
# round them, the products and sums in f32

def kl_mu_w_numerator_tf32_plain(X, W, Ht):
    """Plain twin of ``kl_mu_w_numerator_tf32``."""
    return mu_w_terms_plain(X, tf32_round(W), tf32_round(Ht), 1.0,
                            rnd=tf32_round)[0]


def kl_mu_h_numerator_tf32_plain(X, W, Ht):
    """Plain twin of ``kl_mu_h_numerator_tf32``."""
    return mu_h_terms_plain(X, tf32_round(W), tf32_round(Ht), 1.0,
                            rnd=tf32_round)[0]


def kl_x_log_wh_tf32_plain(X, W, Ht):
    """Plain twin of ``kl_x_log_wh_tf32``."""
    return kl_x_log_wh_plain(X, tf32_round(W), tf32_round(Ht))


# rows of W a block of the TF32 divergence kernel owns (``mu_tf32_rows``):
# the Hopper kernel's at the register buckets, the mma.sync kernel's at a
# wide K
TF32_ROWS, TF32_WIDE_ROWS = 128, 32


def tf32_rows(K: int) -> int:
    """``csrc/mu_tf32.cu``'s ``mu_tf32_rows``: the rows of W each double
    partial of ``kl_x_log_wh_tf32`` sums at bucket K (0 for a K the kernels
    do not take)."""
    if K < 8 or K % 8:
        return 0
    return TF32_ROWS if K <= 64 else TF32_WIDE_ROWS


def kl_x_log_wh_tf32_partials_plain(X, W, Ht, rows=None):
    """Plain version of the TF32 divergence kernel's partials: W and Ht
    rounded by ``tf32_round``, then ``kl_x_log_wh_plain`` in float64 on
    each tile of ``rows`` rows of W (default ``tf32_rows(K)``) → (ceil(N /
    rows), B); summed over its tiles it is ``kl_x_log_wh_plain`` of the
    rounded factors."""
    rows = rows or tf32_rows(W.shape[2])
    X = X.double()
    W, Ht = (tf32_round(t).double() for t in (W, Ht))
    return torch.stack([kl_x_log_wh_plain(X[m:m + rows], W[:, m:m + rows], Ht)
                        for m in range(0, W.shape[1], rows)])


def beta_mu_w_terms_tf32_plain(X, W, Ht, beta: float):
    """Plain twin of ``beta_mu_w_terms_tf32``."""
    return mu_w_terms_plain(X, tf32_round(W), tf32_round(Ht), beta,
                            rnd=tf32_round)


def beta_mu_h_terms_tf32_plain(X, W, Ht, beta: float):
    """Plain twin of ``beta_mu_h_terms_tf32``."""
    return mu_h_terms_plain(X, tf32_round(W), tf32_round(Ht), beta,
                            rnd=tf32_round)


# ----------------------------------------------------------------------
# the CUDA kernels
# ----------------------------------------------------------------------

_ARGS = (VP, I32, I32, I64, I64, VP, VP, I32, I32, VP, VP)
_SPLIT_ARGS = (VP, I32, I32, I64, I64, VP, VP, I32, I32, I32, I32, VP, VP)
_NUM_SPLIT_ARGS = _SPLIT_ARGS + (VP,)
_BETA_ARGS = (VP, I32, I32, I64, I64, VP, VP, I32, I32, F32, VP, VP, VP)
_BETA_SPLIT_ARGS = (VP, I32, I32, I64, I64, VP, VP, I32, I32, F32, I32, I32,
                    VP, VP, VP, VP)
# each entry point's argument types
_ARGTYPES = {"mu_kl_numerator": _ARGS,
             "mu_kl_numerator_split": _NUM_SPLIT_ARGS,
             "mu_kl_x_log_wh": _ARGS,
             "mu_kl_x_log_wh_split": _SPLIT_ARGS,
             "mu_beta_terms": _BETA_ARGS,
             "mu_beta_terms_split": _BETA_SPLIT_ARGS,
             "mu_kl_x_log_wh_tf32": _ARGS,
             # the TF32 terms take their staging scratch before the outputs
             "mu_kl_numerator_tf32": _ARGS[:9] + (VP, VP, VP),
             "mu_beta_terms_tf32": _BETA_ARGS[:10] + (VP, VP, VP, VP),
             "mu_tf32_stage": (VP, I32, I32, I32, I32, VP, VP)}


def _x_strides(X, transposed):
    """(C, sxm, sxc): the contraction length and X's strides along the
    output's rows and along the contraction, as the kernels read X."""
    N, G = X.shape
    sn, sg = X.stride()
    return (N, sg, sn) if transposed else (G, sn, sg)


def split_plan(B: int, M: int, C: int, sms: int, rows: int, per_sm: int,
               chunk: int):
    """How the one-row kernels (the KL numerator and divergence term, the
    general-beta terms) split a contraction of C entries for B restarts of
    M output rows on a card of ``sms`` SMs, given their one-row kernel's
    ``rows`` a block, the blocks of it an SM holds at once and the
    ``chunk`` of entries a slice holds a whole number of (0: it cannot
    split) → (splits, entries_per_split).

    A wave here is one block on each SM. Where the one-row kernel's grid,
    B·⌈M/rows⌉ blocks, is under 2 waves, the contraction is split into slices
    of whole chunks, at least 2 a slice, the last slice taking the rest: as
    many slices as keep the grid within min(4, per_sm) waves, so every block
    is resident at once (2-4 blocks on every SM at the B=1 refits). The
    factorize's grids (B=100) are not split."""
    blocks = B * -(-M // rows)
    if chunk == 0 or blocks >= 2 * sms:
        return 1, C
    most = max(1, min(4, per_sm) * sms // blocks)
    chunks = -(-C // chunk)
    per_split = max(2, -(-chunks // most)) * chunk
    splits = -(-C // per_split)
    return (splits, per_split) if splits > 1 else (1, C)


_TILING_ARGS = (I32, I32, I32, I64, I64, F32, I32)
_XLW_TILING_ARGS = (I32, I32, I32, I64, I32)
_NUM_TILING_ARGS = (I32, I32, I64, I64, I32)
# the kernel families ``_tiling_report`` and ``_split`` take besides a beta
NUMERATOR, DIVERGENCE = "kl_numerator", "kl_x_log_wh"


def _tiling_report(family):
    """The library's tiling report of a kernel family — the KL numerator
    (``NUMERATOR``), the KL divergence term (``DIVERGENCE``) or the
    general-beta kernels at the beta ``family`` — as (K, B, M, sxm, sxc,
    field) → int."""
    if family == NUMERATOR:
        fn = kernel_function("mu_kl_numerator_tiling", _NUM_TILING_ARGS)
        return lambda K, B, M, sxm, sxc, field: fn(K, B, sxm, sxc, field)
    if family == DIVERGENCE:
        fn = kernel_function("mu_kl_x_log_wh_tiling", _XLW_TILING_ARGS)
        return lambda K, B, M, sxm, sxc, field: fn(K, B, M, sxc, field)
    fn = kernel_function("mu_beta_terms_tiling", _TILING_ARGS)
    return lambda K, B, M, sxm, sxc, field: fn(K, B, M, sxm, sxc,
                                               float(family), field)


@functools.lru_cache(maxsize=None)
def _one_row_plan_args(K: int, family, index: int):
    """(SMs, rows a block, blocks an SM holds, split chunk) of the one-row
    kernel at bucket K on device ``index`` (``family`` as ``_tiling_report``
    takes it), read once from the library."""
    fn = _tiling_report(family)
    with torch.cuda.device(index):
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        return (sms,) + tuple(fn(K, 1, 1, 1, 1, field) for field in (0, 3, 4))


@functools.lru_cache(maxsize=None)
def _numerator_tiled(K: int, B: int, sxm: int, sxc: int) -> bool:
    """Whether an unsplit KL numerator launch takes the restart-tiled kernel
    (the KL factorize's buckets where B fills a block's restarts and X has
    a unit stride), which is never split."""
    return _tiling_report(NUMERATOR)(K, B, 0, sxm, sxc, 1) > 1


def _split(X, B, M, K, transposed, family):
    """(splits, entries a split) of a launch with B restarts of M rows,
    ``split_plan`` with what the library reports of the card and the
    kernel (``family`` as ``_tiling_report`` takes it)."""
    C, sxm, sxc = _x_strides(X, transposed)
    if family == NUMERATOR and _numerator_tiled(K, B, sxm, sxc):
        return 1, C
    # the one-row general-beta kernel has two builds: beta = 0 and any other
    key = family if family in (NUMERATOR, DIVERGENCE) else (
        0.0 if family == 0 else 0.5)
    return split_plan(B, M, C, *_one_row_plan_args(K, key, X.device.index))


def launch_splits(X, B: int, K: int, beta: float) -> tuple:
    """The contraction splits (``split_plan``) of the kernel launches one MU
    iteration on CUDA makes with B restarts at bucket K: at beta 1 the
    divergence term's and the W and H numerators', at any other beta but 2
    (which runs no kernel) the general-beta terms' W and H sides."""
    N, G = X.shape
    if beta == 1:
        return (_split(X, B, N, K, False, DIVERGENCE)[0],
                _split(X, B, N, K, False, NUMERATOR)[0],
                _split(X, B, G, K, True, NUMERATOR)[0])
    return (_split(X, B, N, K, False, beta)[0],
            _split(X, B, G, K, True, beta)[0])


def _tiling(X, B, M, K, transposed, family):
    """(rows a block owns, restarts it owns, threads, blocks an SM holds at
    once, splits of the contraction, entries a split) of a launch."""
    splits, per_split = _split(X, B, M, K, transposed, family)
    _, sxm, sxc = _x_strides(X, transposed)
    fn = _tiling_report(family)
    b = 1 if splits > 1 else B   # a split runs the one-row kernel
    return tuple(fn(K, b, M, sxm, sxc, field)
                 for field in range(4)) + (splits, per_split)


def kl_numerator_tiling(X, B, K, transposed=False):
    """The grid the KL numerator takes at these inputs (the W numerator, or
    the H numerator for ``transposed``), as ``beta_terms_tiling`` reports
    it. The KL factorize's buckets (K = 8, 16) run the restart-tiled kernel
    where B fills its restarts and X has a unit stride, the B=1 refits a
    split contraction, everything else one row per thread."""
    M = X.shape[1 if transposed else 0]
    return _tiling(X, B, M, K, transposed, NUMERATOR)


def beta_terms_tiling(X, F, beta, transposed=False):
    """The grid the general-beta kernels take with F (B, M, K) owning the
    rows (W, or Ht for ``transposed``): (rows a block owns, restarts it
    owns, threads, blocks an SM holds at once, splits of the contraction,
    entries a split)."""
    B, M, K = F.shape
    return _tiling(X, B, M, K, transposed, beta)


def kl_x_log_wh_tiling(X, B, K):
    """The grid ``kl_x_log_wh`` takes for X (N, G) and B restarts at bucket
    K, as ``beta_terms_tiling`` reports it. The KL factorize's buckets (K =
    8, 16) run the restart-tiled kernel where X is read along its unit
    stride and the grid fills the card, the B=1 refits a split contraction,
    everything else one row per thread."""
    return _tiling(X, B, X.shape[0], K, False, DIVERGENCE)


def _launch(name, symbol, X, F, F_other, outs, transposed, *extra):
    """F (B, M, K) owns the rows, F_other (B, C, K) is contracted over: the W
    side reads X as (M=N, C=G), the H side transposed as (M=G, C=N).
    ``outs``: the output tensors; ``extra``: the entry point's arguments
    between K and its outputs (a tensor passes its pointer)."""
    B, M, K = F.shape
    N, G = X.shape
    C, sxm, sxc = _x_strides(X, transposed)
    if M != (G if transposed else N) or F_other.shape != (B, C, K):
        raise ValueError(f"{name}: shapes X {tuple(X.shape)}, factor "
                         f"{tuple(F.shape)}, other {tuple(F_other.shape)}")
    check_cuda(name, F, F_other, strided=(X,))
    check_k(name, K)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in (*extra, *outs)]
    launch(name, kernel_function(symbol, _ARGTYPES[symbol]), F,
           X.data_ptr(), M, C, sxm, sxc, F_other.data_ptr(), F.data_ptr(), B,
           K, *ptrs)
    return outs


def _count(fn, B):
    fn.launches += 1
    fn.launches_b1 += int(B == 1)


def _split_launch(fn, symbols, n_outs, X, F, F_other, transposed, family,
                  *extra):
    """The ``n_outs`` outputs of the wrapper ``fn``'s launch of a
    one-row-kernel family, its contraction split as ``split_plan`` says:
    ``symbols`` (whole entry point, split entry point), the split one given
    a workspace of each output's slices; ``extra`` as ``_launch`` takes it.
    Counts the launch on ``fn``."""
    name = fn.__name__
    B, M, K = F.shape
    check_k(name, K)
    splits, per_split = _split(X, B, M, K, transposed, family)
    outs = tuple(torch.empty_like(F) for _ in range(n_outs))
    if splits == 1:
        _launch(name, symbols[0], X, F, F_other, outs, transposed, *extra)
    else:
        work = torch.empty((n_outs, splits, *F.shape), dtype=F.dtype,
                           device=F.device)
        _launch(name, symbols[1], X, F, F_other, outs, transposed, *extra,
                splits, per_split, work)
        fn.launches_split += 1
    _count(fn, B)
    return outs


_BETA_SYMBOLS = ("mu_beta_terms", "mu_beta_terms_split")
_NUMERATOR_SYMBOLS = ("mu_kl_numerator", "mu_kl_numerator_split")


# ----------------------------------------------------------------------
# the wrappers the solvers call
# ----------------------------------------------------------------------

def kl_mu_w_numerator(X, W, Ht):
    """``(X / max(W·H, eps))·Hᵀ`` per restart → (B, N, K). Replaces
    cnmf_tpu/ops/pallas_mu.py:kl_mu_w_numerator."""
    if device_kind("kl_mu_w_numerator", W) == "cpu":
        return kl_mu_w_numerator_plain(X, W, Ht)
    (out,) = _split_launch(kl_mu_w_numerator, _NUMERATOR_SYMBOLS, 1, X,
                           W, Ht, False, NUMERATOR)
    return out


def kl_mu_h_numerator(X, W, Ht):
    """``Wᵀ·(X / max(W·H, eps))`` per restart in the Ht layout → (B, G, K).
    Replaces cnmf_tpu/ops/pallas_mu.py:kl_mu_h_numerator."""
    if device_kind("kl_mu_h_numerator", Ht) == "cpu":
        return kl_mu_h_numerator_plain(X, W, Ht)
    (out,) = _split_launch(kl_mu_h_numerator, _NUMERATOR_SYMBOLS, 1, X,
                           Ht, W, True, NUMERATOR)
    return out


def kl_x_log_wh(X, W, Ht):
    """Per restart, the sum over X > eps of X·log(max(W·H, eps)) → (B,), the
    reconstruction term of the KL divergence. Replaces
    cnmf_tpu/ops/pallas_mu.py:kl_x_log_wh."""
    name = "kl_x_log_wh"
    if device_kind(name, W) == "cpu":
        return kl_x_log_wh_plain(X, W, Ht)
    B, M, K = W.shape
    check_k(name, K)
    splits, per_split = _split(X, B, M, K, False, DIVERGENCE)
    # the rows a block owns (a split runs the one-row kernel, B = 1's)
    rows = kernel_function("mu_kl_x_log_wh_tiling", _XLW_TILING_ARGS)(
        K, 1 if splits > 1 else B, M, X.stride(1), 0)
    part = torch.empty((splits, -(-M // rows), B), dtype=torch.float64,
                       device=W.device)
    if splits == 1:
        _launch(name, "mu_kl_x_log_wh", X, W, Ht, (part,), False)
    else:
        _launch(name, "mu_kl_x_log_wh_split", X, W, Ht, (part,), False,
                splits, per_split)
        kl_x_log_wh.launches_split += 1
    _count(kl_x_log_wh, B)
    # the partials of every slice and row tile, summed in a fixed order
    return part.view(-1, B).sum(dim=0).to(torch.float32)


def _check_beta(name, beta):
    if beta in (1.0, 2.0):
        raise ValueError(f"{name}: beta={beta} has its own path (1: the KL "
                         "kernels, 2: plain matmuls)")


def beta_mu_w_terms(X, W, Ht, beta: float):
    """W-update numerator ``(X ∘ WH^(β−2))·Hᵀ`` and denominator
    ``WH^(β−1)·Hᵀ`` per restart, WH floored at eps where the exponent is
    negative, β ∉ {1, 2} → (num, den), each (B, N, K). Replaces
    cnmf_tpu/ops/pallas_mu.py:beta_mu_w_terms."""
    name = "beta_mu_w_terms"
    _check_beta(name, beta)
    if device_kind(name, W) == "cpu":
        return beta_mu_w_terms_plain(X, W, Ht, beta)
    return _split_launch(beta_mu_w_terms, _BETA_SYMBOLS, 2, X, W, Ht,
                         False, beta, float(beta))


def beta_mu_h_terms(X, W, Ht, beta: float):
    """Ht-update numerator ``Wᵀ·(X ∘ WH^(β−2))`` and denominator
    ``Wᵀ·WH^(β−1)`` per restart in the Ht layout, β ∉ {1, 2} → (num, den),
    each (B, G, K). Replaces cnmf_tpu/ops/pallas_mu.py:beta_mu_h_terms."""
    name = "beta_mu_h_terms"
    _check_beta(name, beta)
    if device_kind(name, Ht) == "cpu":
        return beta_mu_h_terms_plain(X, W, Ht, beta)
    return _split_launch(beta_mu_h_terms, _BETA_SYMBOLS, 2, X, Ht, W,
                         True, beta, float(beta))


# ----------------------------------------------------------------------
# the TF32 wrappers: the precision ladder's coarse phase
# ----------------------------------------------------------------------

# ``mu_tf32_restarts``' op of the divergence term
TF32_DIVERGENCE_OP = 3


def tf32_op(beta=None) -> int:
    """``mu_tf32_restarts``' op: 0 the KL numerator (beta None), 1 the beta
    terms at beta 0, 2 at any other beta (3: ``TF32_DIVERGENCE_OP``)."""
    return 0 if beta is None else 1 if beta == 0 else 2


def _tf32_scratch(F_other, op: int):
    """The scratch a TF32 KL-numerator or beta-terms launch (``tf32_op``)
    stages F_other (B, C, K) into at a register bucket
    (``tf32_stage_plain``'s shape, B rounded up to the kernel's restart
    tile); None at a wide K."""
    B, C, K = F_other.shape
    tile = library_constant("mu_tf32_restarts", K, op)
    if not tile:
        return None
    chunk = library_constant("mu_tf32_chunk")
    return torch.empty((-(-C // chunk), -(-B // tile) * tile, 2 * chunk * K),
                       dtype=torch.float32, device=F_other.device)


def tf32_stage(F_other, Bp: int):
    """``csrc/mu_tf32.cu``'s staging alone on a CUDA F_other (B, C, K) for
    Bp restarts: what ``tf32_stage_plain`` computes (the card tests hold
    the two to the same bits)."""
    name = "tf32_stage"
    check_cuda(name, F_other)
    B, C, K = F_other.shape
    chunk = library_constant("mu_tf32_chunk")
    out = torch.empty((-(-C // chunk), Bp, 2 * chunk * K),
                      dtype=torch.float32, device=F_other.device)
    launch(name, kernel_function("mu_tf32_stage", _ARGTYPES["mu_tf32_stage"]),
           F_other, F_other.data_ptr(), B, C, K, Bp, out.data_ptr())
    return out


def tf32_x_mode(X, transposed=False) -> int:
    """How a TF32 launch at a register bucket moves X (N, G) into shared
    memory: 0 TMA, 1 TMA with X read transposed, 2 four-byte cp.async (X's
    pitch or base not 16-byte aligned, or no unit stride)."""
    M = X.shape[1] if transposed else X.shape[0]
    C, sxm, sxc = _x_strides(X, transposed)
    return kernel_function("mu_tf32_x_mode", (VP, I32, I32, I64, I64))(
        X.data_ptr(), M, C, sxm, sxc)


def kl_mu_w_numerator_tf32(X, W, Ht):
    """``kl_mu_w_numerator`` with both products in TF32
    (``csrc/mu_tf32.cu``); replaces no Pallas kernel."""
    name = "kl_mu_w_numerator_tf32"
    if device_kind(name, W) == "cpu":
        return kl_mu_w_numerator_tf32_plain(X, W, Ht)
    (out,) = _launch(name, "mu_kl_numerator_tf32", X, W, Ht,
                     (torch.empty_like(W),), False, _tf32_scratch(Ht, 0))
    _count(kl_mu_w_numerator_tf32, W.shape[0])
    return out


def kl_mu_h_numerator_tf32(X, W, Ht):
    """``kl_mu_h_numerator`` with both products in TF32, X read transposed
    by its strides; replaces no Pallas kernel."""
    name = "kl_mu_h_numerator_tf32"
    if device_kind(name, Ht) == "cpu":
        return kl_mu_h_numerator_tf32_plain(X, W, Ht)
    (out,) = _launch(name, "mu_kl_numerator_tf32", X, Ht, W,
                     (torch.empty_like(Ht),), True, _tf32_scratch(W, 0))
    _count(kl_mu_h_numerator_tf32, W.shape[0])
    return out


def kl_x_log_wh_tf32_partials(X, W, Ht):
    """The TF32 divergence kernel's double partials on CUDA tensors: for
    each tile of ``mu_tf32_rows(K)`` rows of W and each restart, the sum
    over X > eps of X·log(max(W·H, eps)) with W·H in TF32 → (ceil(N /
    rows), B), what ``kl_x_log_wh_tf32_partials_plain`` computes. Counts
    the launch on ``kl_x_log_wh_tf32``."""
    name = "kl_x_log_wh_tf32"
    B, M, K = W.shape
    check_k(name, K)
    rows = library_constant("mu_tf32_rows", K)
    part = torch.empty((-(-M // rows), B), dtype=torch.float64,
                       device=W.device)
    _launch(name, "mu_kl_x_log_wh_tf32", X, W, Ht, (part,), False)
    _count(kl_x_log_wh_tf32, B)
    return part


def kl_x_log_wh_tf32(X, W, Ht):
    """``kl_x_log_wh`` with W·H in TF32: per row tile and restart a double
    partial (``kl_x_log_wh_tf32_partials``), summed over row tiles in their
    order, a scan along the tiles (a reduction's order could follow B);
    replaces no Pallas kernel."""
    if device_kind("kl_x_log_wh_tf32", W) == "cpu":
        return kl_x_log_wh_tf32_plain(X, W, Ht)
    part = kl_x_log_wh_tf32_partials(X, W, Ht)
    return part.cumsum(dim=0)[-1].to(torch.float32)


def beta_mu_w_terms_tf32(X, W, Ht, beta: float):
    """``beta_mu_w_terms`` with all four products in TF32; replaces no
    Pallas kernel."""
    name = "beta_mu_w_terms_tf32"
    _check_beta(name, beta)
    if device_kind(name, W) == "cpu":
        return beta_mu_w_terms_tf32_plain(X, W, Ht, beta)
    outs = _launch(name, "mu_beta_terms_tf32", X, W, Ht,
                   (torch.empty_like(W), torch.empty_like(W)), False,
                   float(beta), _tf32_scratch(Ht, tf32_op(beta)))
    _count(beta_mu_w_terms_tf32, W.shape[0])
    return outs


def beta_mu_h_terms_tf32(X, W, Ht, beta: float):
    """``beta_mu_h_terms`` with all four products in TF32, X read
    transposed by its strides; replaces no Pallas kernel."""
    name = "beta_mu_h_terms_tf32"
    _check_beta(name, beta)
    if device_kind(name, Ht) == "cpu":
        return beta_mu_h_terms_tf32_plain(X, W, Ht, beta)
    outs = _launch(name, "mu_beta_terms_tf32", X, Ht, W,
                   (torch.empty_like(Ht), torch.empty_like(Ht)), True,
                   float(beta), _tf32_scratch(W, tf32_op(beta)))
    _count(beta_mu_h_terms_tf32, W.shape[0])
    return outs


WRAPPERS = (kl_mu_w_numerator, kl_mu_h_numerator, kl_x_log_wh,
            beta_mu_w_terms, beta_mu_h_terms)
TF32_WRAPPERS = (kl_mu_w_numerator_tf32, kl_mu_h_numerator_tf32,
                 kl_x_log_wh_tf32, beta_mu_w_terms_tf32, beta_mu_h_terms_tf32)
for _fn in WRAPPERS + TF32_WRAPPERS:
    _fn.launches = _fn.launches_b1 = 0
for _fn in WRAPPERS:
    _fn.launches_split = 0
