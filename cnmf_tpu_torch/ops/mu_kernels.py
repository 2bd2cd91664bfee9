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
  ``kl_x_log_wh_tiling``), and where ``split_plan`` finds the grid too
  small to fill the card (the B=1 consensus refits) the contraction is
  split across blocks, whose partials are summed in a fixed order.
* CPU tensors run the plain PyTorch versions below at the tensors' dtype.

The plain versions follow the JAX package's XLA path (``_mu_w_terms_chunked``,
``_mu_h_terms_chunked`` and ``_beta_divergence_chunked`` of
``cnmf_tpu/ops/nmf.py``): they loop over chunks of restarts, so only a
(CHUNK, N, G) reconstruction is ever live. ``mu_w_terms_plain`` and
``mu_h_terms_plain`` give the numerator and denominator for any beta != 2.

Each wrapper counts its kernel launches in a ``launches`` attribute, and
those with one restart (B=1, the consensus and k-stats refits) also in
``launches_b1``.
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


def mu_w_terms_plain(X, W, Ht, beta: float, per_split=None):
    """W-update numerator (X ∘ WH^(β−2))·Hᵀ and denominator (β=1:
    ``kl_w_denominator``, else WH^(β−1)·Hᵀ), each (B, N, K); beta != 2.
    ``per_split``: sum the contraction (G) in slices of that many entries and
    then the slices in order, as a split launch of the general-beta kernel
    does (``split_plan``)."""
    num = torch.empty_like(W)
    den = None if beta == 1 else torch.empty_like(W)
    for sl, _, Htb, WH in wh_chunks(W, Ht):
        num[sl] = _sliced_bmm(_num_ratio(X, WH, beta), Htb, per_split)
        if den is not None:
            den[sl] = _sliced_bmm(_den_factor(WH, beta), Htb, per_split)
    if den is None:
        den = kl_w_denominator(Ht).expand_as(num)
    return num, den


def mu_h_terms_plain(X, W, Ht, beta: float):
    """Ht-update numerator Wᵀ·(X ∘ WH^(β−2)) and denominator (β=1:
    ``kl_h_denominator``, else Wᵀ·WH^(β−1)), each (B, G, K); beta != 2."""
    num = torch.empty_like(Ht)
    den = None if beta == 1 else torch.empty_like(Ht)
    for sl, Wb, _, WH in wh_chunks(W, Ht):
        num[sl] = torch.bmm(_num_ratio(X, WH, beta).transpose(1, 2), Wb)
        if den is not None:
            den[sl] = torch.bmm(_den_factor(WH, beta).transpose(1, 2), Wb)
    if den is None:
        den = kl_h_denominator(W).expand_as(num)
    return num, den


def kl_mu_w_numerator_plain(X, W, Ht):
    """Plain version of ``kl_mu_w_numerator``."""
    return mu_w_terms_plain(X, W, Ht, 1.0)[0]


def kl_mu_h_numerator_plain(X, W, Ht):
    """Plain version of ``kl_mu_h_numerator``."""
    return mu_h_terms_plain(X, W, Ht, 1.0)[0]


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


# ----------------------------------------------------------------------
# the CUDA kernels
# ----------------------------------------------------------------------

_ARGS = (VP, I32, I32, I64, I64, VP, VP, I32, I32, VP, VP)
_SPLIT_ARGS = (VP, I32, I32, I64, I64, VP, VP, I32, I32, I32, I32, VP, VP)
_BETA_ARGS = (VP, I32, I32, I64, I64, VP, VP, I32, I32, F32, VP, VP, VP)
_BETA_SPLIT_ARGS = (VP, I32, I32, I64, I64, VP, VP, I32, I32, F32, I32, I32,
                    VP, VP, VP, VP)
# each entry point's argument types
_ARGTYPES = {"mu_kl_numerator": _ARGS, "mu_kl_x_log_wh": _ARGS,
             "mu_kl_x_log_wh_split": _SPLIT_ARGS,
             "mu_beta_terms": _BETA_ARGS,
             "mu_beta_terms_split": _BETA_SPLIT_ARGS}


def _x_strides(X, transposed):
    """(C, sxm, sxc): the contraction length and X's strides along the
    output's rows and along the contraction, as the kernels read X."""
    N, G = X.shape
    sn, sg = X.stride()
    return (N, sg, sn) if transposed else (G, sn, sg)


def kl_numerator_tiling(X, B, K, transposed=False):
    """The tiling the KL numerator kernel takes at these inputs (the W
    numerator, or the H numerator for ``transposed``): (rows a block owns,
    restarts it owns, threads, blocks an SM holds at once). The KL
    factorize's buckets (K = 8, 16) run the restart-tiled kernel where B
    fills its restarts, everything else one row per thread."""
    _, sxm, sxc = _x_strides(X, transposed)
    fn = kernel_function("mu_kl_numerator_tiling", (I32, I32, I64, I64, I32))
    return tuple(fn(K, B, sxm, sxc, field) for field in range(4))


def split_plan(B: int, M: int, C: int, sms: int, rows: int, per_sm: int,
               chunk: int):
    """How the general-beta kernels and the KL divergence term split a
    contraction of C entries for B restarts of M output rows on a card of
    ``sms`` SMs, given their one-row kernel's ``rows`` a block, the blocks
    of it an SM holds at once and the ``chunk`` of entries a slice holds a
    whole number of (0: it cannot split) → (splits, entries_per_split).

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


def _tiling_report(beta):
    """The library's tiling report of the general-beta kernels at ``beta``,
    or of the KL divergence term for None, as (K, B, M, sxm, sxc, field) →
    int."""
    if beta is None:
        fn = kernel_function("mu_kl_x_log_wh_tiling", _XLW_TILING_ARGS)
        return lambda K, B, M, sxm, sxc, field: fn(K, B, M, sxc, field)
    fn = kernel_function("mu_beta_terms_tiling", _TILING_ARGS)
    return lambda K, B, M, sxm, sxc, field: fn(K, B, M, sxm, sxc,
                                               float(beta), field)


@functools.lru_cache(maxsize=None)
def _one_row_plan_args(K: int, beta, index: int):
    """(SMs, rows a block, blocks an SM holds, split chunk) of the one-row
    kernel at bucket K on device ``index`` (``beta`` as ``_tiling_report``
    takes it), read once from the library."""
    fn = _tiling_report(beta)
    with torch.cuda.device(index):
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        return (sms,) + tuple(fn(K, 1, 1, 1, 1, field) for field in (0, 3, 4))


def _split(X, B, M, K, transposed, beta):
    """(splits, entries a split) of a launch with B restarts of M rows,
    ``split_plan`` with what the library reports of the card and the
    kernel (``beta`` as ``_tiling_report`` takes it)."""
    # the one-row general-beta kernel has two builds: beta = 0 and any other
    key = None if beta is None else 0.0 if beta == 0 else 0.5
    C = X.shape[0 if transposed else 1]
    return split_plan(B, M, C, *_one_row_plan_args(K, key, X.device.index))


def launch_splits(X, B: int, K: int, beta: float) -> tuple:
    """The contraction splits (``split_plan``) of the kernel launches one MU
    iteration on CUDA makes with B restarts at bucket K: the divergence
    term's at beta 1, the general-beta terms' W and H sides at any other
    beta but 2 (which runs no kernel)."""
    if beta == 1:
        return (_split(X, B, X.shape[0], K, False, None)[0],)
    return (_split(X, B, X.shape[0], K, False, beta)[0],
            _split(X, B, X.shape[1], K, True, beta)[0])


def _tiling(X, B, M, K, transposed, beta):
    """(rows a block owns, restarts it owns, threads, blocks an SM holds at
    once, splits of the contraction, entries a split) of a launch."""
    splits, per_split = _split(X, B, M, K, transposed, beta)
    _, sxm, sxc = _x_strides(X, transposed)
    fn = _tiling_report(beta)
    b = 1 if splits > 1 else B   # a split runs the one-row kernel
    return tuple(fn(K, b, M, sxm, sxc, field)
                 for field in range(4)) + (splits, per_split)


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
    return _tiling(X, B, X.shape[0], K, False, None)


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


def _beta_launch(name, X, F, F_other, transposed, beta):
    """(num, den) of the general-beta kernels, split as ``split_plan``
    says."""
    B, M, K = F.shape
    check_k(name, K)
    splits, per_split = _split(X, B, M, K, transposed, beta)
    outs = (torch.empty_like(F), torch.empty_like(F))
    if splits == 1:
        return _launch(name, "mu_beta_terms", X, F, F_other, outs, transposed,
                       float(beta))
    work = torch.empty((2, splits, *F.shape), dtype=F.dtype, device=F.device)
    return _launch(name, "mu_beta_terms_split", X, F, F_other, outs,
                   transposed, float(beta), splits, per_split, work)


# ----------------------------------------------------------------------
# the wrappers the solvers call
# ----------------------------------------------------------------------

def kl_mu_w_numerator(X, W, Ht):
    """``(X / max(W·H, eps))·Hᵀ`` per restart → (B, N, K). Replaces
    cnmf_tpu/ops/pallas_mu.py:kl_mu_w_numerator."""
    if device_kind("kl_mu_w_numerator", W) == "cpu":
        return kl_mu_w_numerator_plain(X, W, Ht)
    (out,) = _launch("kl_mu_w_numerator", "mu_kl_numerator", X, W, Ht,
                     (torch.empty_like(W),), transposed=False)
    _count(kl_mu_w_numerator, W.shape[0])
    return out


def kl_mu_h_numerator(X, W, Ht):
    """``Wᵀ·(X / max(W·H, eps))`` per restart in the Ht layout → (B, G, K).
    Replaces cnmf_tpu/ops/pallas_mu.py:kl_mu_h_numerator."""
    if device_kind("kl_mu_h_numerator", Ht) == "cpu":
        return kl_mu_h_numerator_plain(X, W, Ht)
    (out,) = _launch("kl_mu_h_numerator", "mu_kl_numerator", X, Ht, W,
                     (torch.empty_like(Ht),), transposed=True)
    _count(kl_mu_h_numerator, W.shape[0])
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
    splits, per_split = _split(X, B, M, K, False, None)
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
    outs = _beta_launch(name, X, W, Ht, False, beta)
    _count(beta_mu_w_terms, W.shape[0])
    return outs


def beta_mu_h_terms(X, W, Ht, beta: float):
    """Ht-update numerator ``Wᵀ·(X ∘ WH^(β−2))`` and denominator
    ``Wᵀ·WH^(β−1)`` per restart in the Ht layout, β ∉ {1, 2} → (num, den),
    each (B, G, K). Replaces cnmf_tpu/ops/pallas_mu.py:beta_mu_h_terms."""
    name = "beta_mu_h_terms"
    _check_beta(name, beta)
    if device_kind(name, Ht) == "cpu":
        return beta_mu_h_terms_plain(X, W, Ht, beta)
    outs = _beta_launch(name, X, Ht, W, True, beta)
    _count(beta_mu_h_terms, W.shape[0])
    return outs


WRAPPERS = (kl_mu_w_numerator, kl_mu_h_numerator, kl_x_log_wh,
            beta_mu_w_terms, beta_mu_h_terms)
for _fn in WRAPPERS:
    _fn.launches = _fn.launches_b1 = 0
