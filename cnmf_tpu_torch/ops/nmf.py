"""Batched frobenius NMF by HALS coordinate descent, in PyTorch.

The CD subset of ``cnmf_tpu.ops.nmf``: the whole restart batch is one solve
whose factors carry a leading restart axis ``B`` and share the data matrix X
(cells × genes). Every half-sweep goes through ``ops.cd_kernels``: the fused
Hopper kernel for CUDA tensors, the plain PyTorch sweep for CPU tensors.

Solver semantics mirror sklearn's, as in the JAX package:

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


def frobenius_error(X, W, Ht, XHt: Optional[torch.Tensor] = None):
    """sqrt(||X - WH||²_F) per restart, computed via K×K grams."""
    X_sq = torch.sum(X * X)
    if XHt is None:
        XHt = _shared_x_dot(X, Ht)
    cross = torch.einsum("bnk,bnk->b", W, XHt)
    wh_norm = torch.einsum("bkl,bkl->b", _gram(W), _gram(Ht))
    sq = X_sq + wh_norm - 2.0 * cross
    return torch.sqrt(sq.clamp(min=0.0))
