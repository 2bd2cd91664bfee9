"""sklearn's NMF solvers, plainly, in batched PyTorch: HALS coordinate
descent (the frobenius loss) and multiplicative updates for the
Kullback-Leibler divergence, with sklearn's stopping rules; and the
fixed-factor refits (``update_H=False``) that consensus and k-selection run.

Every matrix product goes through ``mm``: at ``"f32"`` a float32 product
with TF32 off (the configurations' precision), at ``"tf32"`` the operands
first rounded to TF32's 10-bit mantissa (the control's precision: a
tensor-core TF32 product multiplies such operands exactly and adds in
float32).

A batch holds restarts of different K by zero columns past each K: a zero
column of W and of H stays zero under both solvers and adds nothing.
"""

from __future__ import annotations

import numpy as np
import torch

EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)
CHECK_EVERY = {"cd": 1, "mu": 10}


def no_tf32():
    """Switch TF32 off for every float32 product of this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest (ties to even) at 10 mantissa
    bits."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


def mm(a, b, prec: str):
    if prec == "tf32":
        a, b = tf32_round(a), tf32_round(b)
    return torch.matmul(a, b)


def _cd_half(F, gram, P, prec):
    """One cyclic pass over F's columns (sklearn ``_update_cdnmf_fast``,
    shuffle off): F (B, M, K), gram (B, K, K), P (B, M, K). Returns the
    new F and each restart's summed |projected gradient|."""
    F = F.clone()
    viol = torch.zeros(F.shape[0], dtype=F.dtype, device=F.device)
    for t in range(F.shape[2]):
        hess = gram[:, t, t]
        grad = mm(F, gram[:, :, t:t + 1], prec)[..., 0] - P[:, :, t]
        col = F[:, :, t]
        pg = torch.where(col == 0, grad.clamp(max=0.0), grad)
        live = hess != 0
        viol = viol + torch.where(live, pg.abs().sum(dim=1), 0.0)
        new = (col - grad / torch.where(live, hess, 1.0)[:, None]).clamp(min=0.0)
        F[:, :, t] = torch.where(live[:, None], new, col)
    return F, viol


def _cd_sweep(X, W, Ht, prec, update_H=True, fixed=None):
    """A full CD sweep (W then H); ``fixed``: (gram, P) of a fixed Ht."""
    if fixed is not None:
        W, viol = _cd_half(W, fixed[0], fixed[1], prec)
        return W, viol, None
    Htt = Ht.transpose(1, 2)
    W, vw = _cd_half(W, mm(Htt, Ht, prec), mm(X, Ht, prec), prec)
    if not update_H:
        return W, vw, None
    Wt = W.transpose(1, 2)
    Ht, vh = _cd_half(Ht, mm(Wt, W, prec), mm(X.T, W, prec), prec)
    return W, vw + vh, Ht


def _kl_ratio(X, W, Ht, mask, prec):
    """X / max(W H, eps) where X > 0, else 0: (B, N, G)."""
    WH = mm(W, Ht.transpose(1, 2), prec)
    return torch.where(mask, X / WH.clamp(min=EPS32), 0.0)


def _kl_error(X, W, Ht, x_terms, prec):
    """sqrt(2 * KL(X, W H)) per restart, sklearn's dense form: the terms
    over X > eps with W H floored at eps, and the full sum of W H."""
    gt, x_log_x, sum_x = x_terms
    WH = mm(W, Ht.transpose(1, 2), prec)
    x_log_wh = torch.where(gt, X * torch.log(WH.clamp(min=EPS32)), 0.0)
    sum_wh = (W.sum(dim=1) * Ht.sum(dim=1)).sum(dim=1)
    div = x_log_x - x_log_wh.sum(dim=(1, 2)) - sum_x + sum_wh
    return torch.sqrt((2.0 * div).clamp(min=0.0))


def _mu_kl_step(X, W, Ht, mask, prec, update_H=True):
    """One sklearn MU iteration at beta 1: W, then H against the new W,
    H's entries under float64's eps set to 0."""
    R = _kl_ratio(X, W, Ht, mask, prec)
    den = Ht.sum(dim=1, keepdim=True)
    W = W * mm(R, Ht, prec) / torch.where(den == 0, EPS32, den)
    if update_H:
        R = _kl_ratio(X, W, Ht, mask, prec)
        den = W.sum(dim=1, keepdim=True)
        Ht = Ht * mm(R.transpose(1, 2), W, prec) / torch.where(den == 0, EPS32,
                                                               den)
        Ht = torch.where(Ht < EPS64, 0.0, Ht)
    return W, Ht


def solve(X, W, Ht, *, solver: str, tol: float, max_iter: int, prec: str,
          target=None, update_H: bool = True):
    """Run a batch of restarts from (W (B, N, K), Ht (B, G, K)) under
    sklearn's stopping rule: CD stops after the sweep whose violation is
    within ``tol`` of the first sweep's, MU at the check (every 10
    iterations) whose error fell by less than ``tol`` of the initial error
    since the last check. Returns (W, Ht, n_iter (B,)), each restart frozen
    at its own stop.

    ``target`` (B,) iteration counts: each restart is also run to its
    target, and its factors there are returned instead, with its own stop
    still counted in n_iter. ``update_H=False``: Ht stays fixed (a refit;
    the CD products are formed once)."""
    B, dev = W.shape[0], W.device
    fixed = None
    if solver == "cd" and not update_H:
        fixed = (mm(Ht.transpose(1, 2), Ht, prec), mm(X, Ht, prec))
    if solver == "mu":
        mask = X > 0
        gt = X > EPS32
        x_terms = (gt, torch.where(gt, X * torch.log(X.clamp(min=EPS32)),
                                   0.0).sum(), torch.where(gt, X, 0.0).sum())
        err_init = _kl_error(X, W, Ht, x_terms, prec)
        prev = err_init.clone()
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    n_iter = torch.full((B,), max_iter, dtype=torch.int64, device=dev)
    tgt = (torch.zeros(B, dtype=torch.int64, device=dev) if target is None
           else torch.as_tensor(np.asarray(target), device=dev).long())
    outW, outH = W.clone(), Ht.clone()
    vinit = torch.zeros(B, dtype=W.dtype, device=dev)
    for it in range(max_iter):
        live = ~stopped | (it < tgt)
        if it % 10 == 0 and not bool(live.any()):   # a host read every 10
            break
        if solver == "cd":
            Wn, viol, Hn = _cd_sweep(X, W, Ht, prec, update_H, fixed)
            if it == 0:
                vinit = viol
            fired = torch.where(vinit == 0, True,
                                viol / vinit.clamp(min=EPS32) <= tol)
        else:
            Wn, Hn = _mu_kl_step(X, W, Ht, mask, prec, update_H)
            if (it + 1) % 10 == 0:
                err = _kl_error(X, Wn, Hn if update_H else Ht, x_terms, prec)
                fired = (prev - err) / err_init.clamp(min=EPS32) < tol
                prev = torch.where(live, err, prev)
            else:
                fired = torch.zeros(B, dtype=torch.bool, device=dev)
        W = torch.where(live[:, None, None], Wn, W)
        if Hn is not None:
            Ht = torch.where(live[:, None, None], Hn, Ht)
        newly = fired & ~stopped & live
        n_iter = torch.where(newly, it + 1, n_iter)
        stopped = stopped | newly
        snap = (tgt == it + 1) if target is not None else newly
        outW = torch.where(snap[:, None, None], W, outW)
        outH = torch.where(snap[:, None, None], Ht, outH)
    at_end = ~stopped if target is None else (tgt >= max_iter)
    outW = torch.where(at_end[:, None, None], W, outW)
    outH = torch.where(at_end[:, None, None], Ht, outH)
    return outW, outH, n_iter


def refit(X, H, *, solver: str, tol: float, max_iter: int, prec: str):
    """min over W >= 0 of the loss of X against W H with H (K, G) fixed,
    sklearn's ``non_negative_factorization(update_H=False)``: W starts at 0
    (CD) or everywhere at sqrt(mean(X) / K) (MU). Returns W (N, K)."""
    k = H.shape[0]
    if solver == "cd":
        W0 = torch.zeros((1, X.shape[0], k), dtype=X.dtype, device=X.device)
    else:
        W0 = torch.sqrt(X.mean() / k).expand(1, X.shape[0], k).contiguous()
    W, _, _ = solve(X, W0, H.T.contiguous()[None], solver=solver, tol=tol,
                    max_iter=max_iter, prec=prec, update_H=False)
    return W[0]
