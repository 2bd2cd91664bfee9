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
  (``kl_numerator_tiling``); both give the same bits.
* CPU tensors run the plain PyTorch versions below at the tensors' dtype.

The plain versions follow the JAX package's XLA path (``_mu_w_terms_chunked``,
``_mu_h_terms_chunked`` and ``_beta_divergence_chunked`` of
``cnmf_tpu/ops/nmf.py``): they loop over chunks of restarts, so only a
(CHUNK, N, G) reconstruction is ever live. ``mu_w_terms_plain`` and
``mu_h_terms_plain`` give the numerator and denominator for any beta != 2.

Each wrapper counts its kernel launches in a ``launches`` attribute.
"""

from __future__ import annotations

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
    library_constant,
    raise_on,
    stream_of,
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


def kl_w_denominator(Ht):
    """The KL W-update denominator Σ_g H, (B, 1, K) (nmf.py:1071)."""
    return Ht.sum(dim=1)[:, None, :]


def kl_h_denominator(W):
    """The KL Ht-update denominator Σ_n W with 0 mapped to 1, (B, 1, K)
    (nmf.py:1147-1148)."""
    w_sum = W.sum(dim=1)
    return torch.where(w_sum == 0, 1.0, w_sum)[:, None, :]


def mu_w_terms_plain(X, W, Ht, beta: float):
    """W-update numerator (X ∘ WH^(β−2))·Hᵀ and denominator (β=1:
    ``kl_w_denominator``, else WH^(β−1)·Hᵀ), each (B, N, K); beta != 2."""
    num = torch.empty_like(W)
    den = None if beta == 1 else torch.empty_like(W)
    for sl, _, Htb, WH in wh_chunks(W, Ht):
        num[sl] = torch.bmm(_num_ratio(X, WH, beta), Htb)
        if den is not None:
            den[sl] = torch.bmm(_den_factor(WH, beta), Htb)
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


def kl_x_log_wh_plain(X, W, Ht):
    """Plain version of ``kl_x_log_wh``."""
    mask = X > EPSILON
    out = torch.empty(W.shape[0], dtype=W.dtype, device=W.device)
    for sl, _, _, WH in wh_chunks(W, Ht):
        term = torch.where(mask, X * torch.log(WH.clamp(min=EPSILON)), 0.0)
        out[sl] = term.sum(dim=(1, 2))
    return out


# ----------------------------------------------------------------------
# the CUDA kernels
# ----------------------------------------------------------------------

_ARGS = (VP, I32, I32, I64, I64, VP, VP, I32, I32, VP, VP)
_BETA_ARGS = (VP, I32, I32, I64, I64, VP, VP, I32, I32, F32, VP, VP, VP)


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


def _launch(name, symbol, X, F, F_other, outs, transposed, beta=None):
    """F (B, M, K) owns the rows, F_other (B, C, K) is contracted over: the W
    side reads X as (M=N, C=G), the H side transposed as (M=G, C=N).
    ``outs``: the output tensors; ``beta``: the general-beta kernels' loss."""
    B, M, K = F.shape
    N, G = X.shape
    C, sxm, sxc = _x_strides(X, transposed)
    if M != (G if transposed else N) or F_other.shape != (B, C, K):
        raise ValueError(f"{name}: shapes X {tuple(X.shape)}, factor "
                         f"{tuple(F.shape)}, other {tuple(F_other.shape)}")
    check_cuda(name, F, F_other, strided=(X,))
    check_k(name, K)
    args = [X.data_ptr(), M, C, sxm, sxc, F_other.data_ptr(), F.data_ptr(),
            B, K]
    if beta is not None:
        args.append(float(beta))
    raise_on(name, kernel_function(
        symbol, _ARGS if beta is None else _BETA_ARGS
    )(*args, *[o.data_ptr() for o in outs], stream_of(F)))
    return outs


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
    kl_mu_w_numerator.launches += 1
    return out


def kl_mu_h_numerator(X, W, Ht):
    """``Wᵀ·(X / max(W·H, eps))`` per restart in the Ht layout → (B, G, K).
    Replaces cnmf_tpu/ops/pallas_mu.py:kl_mu_h_numerator."""
    if device_kind("kl_mu_h_numerator", Ht) == "cpu":
        return kl_mu_h_numerator_plain(X, W, Ht)
    (out,) = _launch("kl_mu_h_numerator", "mu_kl_numerator", X, Ht, W,
                     (torch.empty_like(Ht),), transposed=True)
    kl_mu_h_numerator.launches += 1
    return out


def kl_x_log_wh(X, W, Ht):
    """Per restart, the sum over X > eps of X·log(max(W·H, eps)) → (B,), the
    reconstruction term of the KL divergence. Replaces
    cnmf_tpu/ops/pallas_mu.py:kl_x_log_wh."""
    name = "kl_x_log_wh"
    if device_kind(name, W) == "cpu":
        return kl_x_log_wh_plain(X, W, Ht)
    tiles = -(-W.shape[1] // library_constant("mu_tile_rows"))
    part = torch.empty((tiles, W.shape[0]), dtype=torch.float64,
                       device=W.device)
    _launch(name, "mu_kl_x_log_wh", X, W, Ht, (part,), transposed=False)
    kl_x_log_wh.launches += 1
    return part.sum(dim=0).to(torch.float32)


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
    outs = _launch(name, "mu_beta_terms", X, W, Ht,
                   (torch.empty_like(W), torch.empty_like(W)),
                   transposed=False, beta=beta)
    beta_mu_w_terms.launches += 1
    return outs


def beta_mu_h_terms(X, W, Ht, beta: float):
    """Ht-update numerator ``Wᵀ·(X ∘ WH^(β−2))`` and denominator
    ``Wᵀ·WH^(β−1)`` per restart in the Ht layout, β ∉ {1, 2} → (num, den),
    each (B, G, K). Replaces cnmf_tpu/ops/pallas_mu.py:beta_mu_h_terms."""
    name = "beta_mu_h_terms"
    _check_beta(name, beta)
    if device_kind(name, Ht) == "cpu":
        return beta_mu_h_terms_plain(X, W, Ht, beta)
    outs = _launch(name, "mu_beta_terms", X, Ht, W,
                   (torch.empty_like(Ht), torch.empty_like(Ht)),
                   transposed=True, beta=beta)
    beta_mu_h_terms.launches += 1
    return outs


kl_mu_w_numerator.launches = 0
kl_mu_h_numerator.launches = 0
kl_x_log_wh.launches = 0
beta_mu_w_terms.launches = 0
beta_mu_h_terms.launches = 0
