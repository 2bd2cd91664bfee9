"""Batched NMF in PyTorch: HALS coordinate descent (frobenius) and
beta-divergence multiplicative updates (MU).

The CD and MU solvers of ``cnmf_tpu.ops.nmf``: the whole restart batch is one
solve whose factors carry a leading restart axis ``B`` and share the data
matrix X (cells × genes). Every CD half-sweep goes through ``ops.cd_kernels``
and every MU term at beta != 2 (KL, Itakura-Saito, any other beta) through
``ops.mu_kernels``: the fused Hopper kernels for CUDA tensors, the plain
PyTorch versions for CPU tensors. beta=2 MU runs plain matmuls everywhere,
and the divergence at beta ∉ {1, 2} plain torch ops (the JAX package has no
kernel for either).

CD semantics mirror sklearn's, as in the JAX package:

* cyclic coordinate descent in column order 0..K-1, W updated before H;
* ``violation_init`` is the summed projected-gradient violation of global
  sweep 0;
* a restart freezes once ``violation / max(violation_init, eps) <= tol``
  (``violation_init == 0`` counts as done) — frozen restarts stop changing,
  which matches the serial solver's early ``break``;
* ``n_iter`` counts sweeps per restart.

The JAX ``while_loop`` is a Python loop with masked ``torch.where`` updates.
Reading the all-done flag costs a device→host sync, so on a GPU it is read
every ``_DONE_CHECK_EVERY`` sweeps only; frozen restarts do not change, so
the results are the same as checking every sweep.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from cnmf_tpu_torch.ops.cd_kernels import (  # noqa: F401  (re-exported)
    _cd_half_sweep,
    _gram,
    _shared_x_dot,
    _shared_xt_dot,
    cd_h_half_sweep,
    cd_sweep_from_products,
    cd_w_half_sweep,
)
from cnmf_tpu_torch.ops.init import nnls_w_init
from cnmf_tpu_torch.ops.mu_kernels import (
    beta_mu_h_terms,
    beta_mu_w_terms,
    kl_h_denominator,
    kl_mu_h_numerator,
    kl_mu_w_numerator,
    kl_w_denominator,
    kl_x_log_wh,
    wh_chunks,
)

EPSILON = float(np.finfo(np.float32).eps)

_DONE_CHECK_EVERY = 10


def _check_every(t: torch.Tensor) -> int:
    return 1 if t.device.type == "cpu" else _DONE_CHECK_EVERY


def _update_state(j_global, violation, violation_init, done, n_iter, tol):
    """Shared stop rule of the full solver and the products refit: returns
    (violation_init, keep mask, n_iter, done) after global sweep ``j_global``."""
    if j_global == 0:
        violation_init = violation
    keep = ~done
    n_iter = torch.where(keep, j_global + 1, n_iter)
    newly_done = torch.where(
        violation_init == 0,
        True,
        violation / violation_init.clamp(min=EPSILON) <= tol,
    )
    return violation_init, keep, n_iter, done | newly_done


def _half_sweeps(X, W, Ht, update_H, l1_reg_W, l1_reg_H, l2_reg_W, l2_reg_H):
    """One full CD sweep, W half then H half (sklearn order), the H half
    against the new W. Returns (W_new, Ht_new, violation)."""
    W_new, viol = cd_w_half_sweep(X, W, Ht, l1_reg=l1_reg_W, l2_reg=l2_reg_W)
    if not update_H:
        return W_new, Ht, viol
    Ht_new, viol_h = cd_h_half_sweep(X, W_new, Ht, l1_reg=l1_reg_H,
                                     l2_reg=l2_reg_H)
    return W_new, Ht_new, viol + viol_h


def nmf_cd_segment(
    X, W, Ht, violation_init, n_iter, done, it0: int, *,
    seg_len: int, tol: float = 1e-4, update_H: bool = True,
    l1_reg_W: float = 0.0, l1_reg_H: float = 0.0,
    l2_reg_W: float = 0.0, l2_reg_H: float = 0.0,
):
    """Run up to ``seg_len`` CD sweeps from a resumable state.

    The convergence state (violation_init, per-restart sweep counts, done
    mask) is carried in and out; ``it0`` is the global sweep offset (sweep 0
    defines violation_init). Returns (W, Ht, violation_init, n_iter, done)."""
    check = _check_every(W)
    for j in range(seg_len):
        if j % check == 0 and bool(done.all()):
            break
        W_new, Ht_new, viol = _half_sweeps(
            X, W, Ht, update_H, l1_reg_W, l1_reg_H, l2_reg_W, l2_reg_H
        )
        violation_init, keep, n_iter, done = _update_state(
            it0 + j, viol.to(W.dtype), violation_init, done, n_iter, tol
        )
        W = torch.where(keep[:, None, None], W_new, W)
        Ht = torch.where(keep[:, None, None], Ht_new, Ht)
    return W, Ht, violation_init, n_iter, done


def nmf_coordinate_descent(
    X: torch.Tensor,
    W0: torch.Tensor,
    Ht0: torch.Tensor,
    *,
    tol: float = 1e-4,
    max_iter: int = 200,
    update_H: bool = True,
    l1_reg_W: float = 0.0,
    l1_reg_H: float = 0.0,
    l2_reg_W: float = 0.0,
    l2_reg_H: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched frobenius NMF via cyclic coordinate descent.

    X (N, G) shared data; W0 (B, N, K) and Ht0 (B, G, K) initial factors per
    restart. Returns W (B, N, K), Ht (B, G, K) and n_iter (B,) int32 sweeps
    executed. On CUDA the tensors must be float32 (the kernels' type);
    float64 runs on the CPU."""
    B = W0.shape[0]
    dev = W0.device
    W, Ht, _, n_iter, _ = nmf_cd_segment(
        X, W0, Ht0,
        torch.zeros(B, dtype=W0.dtype, device=dev),
        torch.zeros(B, dtype=torch.int32, device=dev),
        torch.zeros(B, dtype=torch.bool, device=dev),
        0, seg_len=max_iter, tol=tol, update_H=update_H,
        l1_reg_W=l1_reg_W, l1_reg_H=l1_reg_H,
        l2_reg_W=l2_reg_W, l2_reg_H=l2_reg_H,
    )
    return W, Ht, n_iter


def nnls_cd_from_products(
    gram: torch.Tensor,
    P: torch.Tensor,
    W0: torch.Tensor,
    *,
    tol: float = 1e-4,
    max_iter: int = 200,
    l1_reg: float = 0.0,
    l2_reg: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-factor CD NNLS from loop-invariant products.

    Solves ``min_{W>=0} ||X - W·Hfix||`` given only ``gram = Hfix·Hfixᵀ``
    (B,K,K) and ``P = X·Hfixᵀ`` (B,M,K): the ``update_H=False`` loop of the
    full solver with its invariants computed once, same sweeps and stopping.
    Returns (W, n_iter)."""
    B = W0.shape[0]
    dev = W0.device
    W = W0
    violation_init = torch.zeros(B, dtype=W0.dtype, device=dev)
    n_iter = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    check = _check_every(W0)
    for j in range(max_iter):
        if j % check == 0 and bool(done.all()):
            break
        W_new, viol = cd_sweep_from_products(
            W, gram, P, l1_reg=l1_reg, l2_reg=l2_reg
        )
        violation_init, keep, n_iter, done = _update_state(
            j, viol.to(W.dtype), violation_init, done, n_iter, tol
        )
        W = torch.where(keep[:, None, None], W_new, W)
    return W, n_iter


def fixed_factor_gram(F):
    """Gram of a fixed factor: F (B, M, K) → (B, K, K)."""
    return _gram(F)


def fixed_factor_product_transposed(F, X):
    """P = Xᵀ·F without materializing Xᵀ: the small (K, G) product Fᵀ·X,
    transposed. F: (M, K) or (1, M, K); X: (M, G). Returns (1, G, K)."""
    F2 = F[0] if F.ndim == 3 else F
    return (F2.T @ X).T.contiguous()[None]


def nnls_cd_fixed_spectra(
    X, Ht0, W0, *, tol=1e-4, max_iter=200, l1_reg=0.0, l2_reg=0.0,
):
    """Fixed-spectra CD NNLS: the loop-invariant products (``gram =
    HfixᵀHfix``, ``P = X·Hfix``) once, then nnls_cd_from_products.
    Returns (W (B,M,K), n_iter (B,))."""
    return nnls_cd_from_products(
        fixed_factor_gram(Ht0), _shared_x_dot(X, Ht0), W0, tol=tol,
        max_iter=max_iter, l1_reg=l1_reg, l2_reg=l2_reg,
    )


def reconstruction_sse(X, W, H, row_chunk: int = 4096):
    """sum((X − W·H)²), computed directly on row chunks of X: X (N, G),
    W (N, K), H (K, G). The K-selection prediction error (reference
    cnmf.py:925-930); the gram-trick form would cancel in float32. Only a
    (row_chunk × G) reconstruction is live at a time."""
    sse = torch.zeros((), dtype=X.dtype, device=X.device)
    for s in range(0, X.shape[0], row_chunk):
        diff = X[s:s + row_chunk] - W[s:s + row_chunk] @ H
        sse = sse + torch.sum(diff * diff)
    return sse


def frobenius_error(X, W, Ht, XHt: Optional[torch.Tensor] = None):
    """sqrt(||X - WH||²_F) per restart, computed via K×K grams."""
    X_sq = torch.sum(X * X)
    if XHt is None:
        XHt = _shared_x_dot(X, Ht)
    cross = torch.einsum("bnk,bnk->b", W, XHt)
    wh_norm = torch.einsum("bkl,bkl->b", _gram(W), _gram(Ht))
    sq = X_sq + wh_norm - 2.0 * cross
    return torch.sqrt(sq.clamp(min=0.0))


# ----------------------------------------------------------------------
# multiplicative updates
# ----------------------------------------------------------------------

_EPS64 = float(np.finfo(np.float64).eps)
_MU_CHECK_EVERY = 10   # sklearn's MU convergence check cadence

def _kl_x_terms(X):
    """The X-only terms of the KL divergence over X > eps: (Σ X·log X, Σ X)."""
    mask = X > EPSILON
    X_log_X = torch.where(mask, X * torch.log(X.clamp(min=EPSILON)), 0.0).sum()
    return X_log_X, torch.where(mask, X, 0.0).sum()


def _beta_divergence_chunked(X, W, Ht, beta: float):
    """beta ∉ {1, 2}: beta_div per restart from chunked reconstructions
    (sklearn's dense _beta_divergence: X <= eps excluded from the elementwise
    terms, WH floored at eps)."""
    mask = X > EPSILON
    divs = torch.empty(W.shape[0], dtype=W.dtype, device=W.device)
    for sl, _, _, WH in wh_chunks(W, Ht):
        WH_safe = WH.clamp(min=EPSILON)
        if beta == 0:
            ratio = X / WH_safe
            # sklearn subtracts the FULL element count
            divs[sl] = torch.where(
                mask, ratio - torch.log(ratio.clamp(min=EPSILON)), 0.0
            ).sum(dim=(1, 2)) - X.numel()
        else:
            sum_WH_beta = WH.pow(beta).sum(dim=(1, 2))
            sum_X_WH = torch.where(
                mask, X * WH_safe.pow(beta - 1.0), 0.0).sum(dim=(1, 2))
            sum_X_beta = torch.where(mask, X.pow(beta), 0.0).sum()
            divs[sl] = (sum_X_beta - beta * sum_X_WH
                        + sum_WH_beta * (beta - 1.0)) / (beta * (beta - 1.0))
    return divs


def beta_divergence_error(X, W, Ht, beta: float, x_terms=None):
    """sqrt(2·beta_div(X, WH)) per restart (sklearn square_root=True).
    ``x_terms``: ``_kl_x_terms(X)``, when the caller has it (beta=1)."""
    if beta == 2:
        return frobenius_error(X, W, Ht)
    if beta == 1:
        X_log_X, sum_X = x_terms if x_terms is not None else _kl_x_terms(X)
        # the full Σ(W·H) by the rank-K identity
        sum_WH = (W.sum(dim=1) * Ht.sum(dim=1)).sum(dim=1)
        divs = -kl_x_log_wh(X, W, Ht) + X_log_X - sum_X + sum_WH
    else:
        divs = _beta_divergence_chunked(X, W, Ht, beta)
    return torch.sqrt((2.0 * divs).clamp(min=0.0))


def _mu_step(F, numerator, denominator, gamma, l1_reg, l2_reg):
    """F ∘ (numerator / denominator)^gamma with sklearn's regularized
    denominator, 0 mapped to eps (nmf.py:1081-1089)."""
    if l1_reg > 0:
        denominator = denominator + l1_reg
    if l2_reg > 0:
        denominator = denominator + l2_reg * F
    denominator = torch.where(denominator == 0, EPSILON, denominator)
    delta = numerator / denominator
    if gamma != 1.0:
        delta = delta.pow(gamma)
    return F * delta


def _mu_update_w(X, W, Ht, beta, gamma, l1_reg, l2_reg):
    if beta == 2:
        numerator = _shared_x_dot(X, Ht)
        denominator = torch.bmm(W, _gram(Ht))
    elif beta == 1:
        numerator = kl_mu_w_numerator(X, W, Ht)
        denominator = kl_w_denominator(Ht)
    else:
        numerator, denominator = beta_mu_w_terms(X, W, Ht, beta)
    return _mu_step(W, numerator, denominator, gamma, l1_reg, l2_reg)


def _mu_update_h(X, W, Ht, beta, gamma, l1_reg, l2_reg):
    if beta == 2:
        numerator = _shared_xt_dot(X, W)
        denominator = torch.bmm(Ht, _gram(W))
    elif beta == 1:
        numerator = kl_mu_h_numerator(X, W, Ht)
        denominator = kl_h_denominator(W)
    else:
        numerator, denominator = beta_mu_h_terms(X, W, Ht, beta)
    return _mu_step(Ht, numerator, denominator, gamma, l1_reg, l2_reg)


def nmf_multiplicative_update(
    X: torch.Tensor,
    W0: torch.Tensor,
    Ht0: torch.Tensor,
    *,
    beta: float = 2.0,
    tol: float = 1e-4,
    max_iter: int = 200,
    update_H: bool = True,
    l1_reg_W: float = 0.0,
    l1_reg_H: float = 0.0,
    l2_reg_W: float = 0.0,
    l2_reg_H: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched beta-divergence NMF via multiplicative updates.

    beta: 2 = frobenius, 1 = kullback-leibler, 0 = itakura-saito. X (N, G);
    W0 (B, N, K); Ht0 (B, G, K). Every 10 iterations the restarts whose
    relative error improvement (previous_error - error) / error_at_init is
    below tol stop (sklearn's rule); the all-done flag is read on the host at
    those checks only, and frozen restarts stop changing. Returns W, Ht and
    n_iter (B,) int32."""
    B = W0.shape[0]
    dev = W0.device
    if beta < 1:
        gamma = 1.0 / (2.0 - beta)
    elif beta > 2:
        gamma = 1.0 / (beta - 1.0)
    else:
        gamma = 1.0
    x_terms = _kl_x_terms(X) if beta == 1 else None
    error_init = beta_divergence_error(X, W0, Ht0, beta, x_terms)
    prev_error = error_init
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n_iter = torch.zeros(B, dtype=torch.int32, device=dev)
    W, Ht = W0, Ht0
    for it in range(1, max_iter + 1):
        W_new = _mu_update_w(X, W, Ht, beta, gamma, l1_reg_W, l2_reg_W)
        if beta < 1:
            W_new = torch.where(W_new < _EPS64, 0.0, W_new)
        keep = ~done
        if update_H:
            Ht_new = _mu_update_h(X, W_new, Ht, beta, gamma, l1_reg_H,
                                  l2_reg_H)
            if beta <= 1:
                Ht_new = torch.where(Ht_new < _EPS64, 0.0, Ht_new)
            Ht = torch.where(keep[:, None, None], Ht_new, Ht)
        W = torch.where(keep[:, None, None], W_new, W)
        n_iter = torch.where(keep, it, n_iter)
        if tol > 0 and it % _MU_CHECK_EVERY == 0:
            error = beta_divergence_error(X, W, Ht, beta,
                                          x_terms).to(W0.dtype)
            done = done | ((prev_error - error)
                           / error_init.clamp(min=EPSILON) < tol)
            prev_error = error
            if bool(done.all()):
                break
    return W, Ht, n_iter


def nnls_multiplicative_update(X, H, *, beta=1.0, tol=1e-4, max_iter=200,
                               l1_reg_W=0.0, l2_reg_W=0.0):
    """Fixed-H NNLS via MU; W starts at sqrt(X.mean()/K) (sklearn 'mu'
    rule). X (N, G), H (K, G). Returns W (N, K) and the iteration count."""
    W0 = nnls_w_init(X, H.shape[0], "mu")
    Ht0 = H.T.to(X.dtype).contiguous()[None]
    W, _, n_iter = nmf_multiplicative_update(
        X, W0, Ht0, beta=beta, tol=tol, max_iter=max_iter, update_H=False,
        l1_reg_W=l1_reg_W, l2_reg_W=l2_reg_W,
    )
    return W[0], int(n_iter[0])
