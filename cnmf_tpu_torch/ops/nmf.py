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

The JAX ``while_loop`` becomes blocks of ``BLOCK`` steps with masked
``torch.where`` updates, a function of tensors only: the global step index
is a device counter and the ``max_iter`` guard sits in the keep mask, so a
block is the same code at every position, and the host reads the all-done
flag between blocks only. Frozen restarts do not change, so n_iter and the
factors are those of checking every step. (Replaying a block as a CUDA
graph was measured on an H100 and did not pay: PERF.md.)

The device ladders (``nmf_cd_device_ladder``, ``nmf_mu_device_ladder``) run
the same blocks on a batch that shrinks as restarts finish.

Cell-sharded solves (the JAX package's GSPMD solves on a ``cell`` mesh axis):
an X given as ``parallel.mesh.Shards`` of its rows, with W's rows following
X's shards and Ht replicated, runs the same blocks with the H-side products
and the stop rule's sums taken over shards (``parallel.collectives``). CD:
the W half is ``cd_w_half_sweep`` on each shard's rows; the H half sums the
shards' XᵀW and WᵀW (plain matmuls, as the JAX package takes them outside
any Pallas kernel on a mesh) and sweeps Ht with ``cd_sweep_from_products``.
MU: the W update runs per shard, the H update's terms and the divergence
are summed. The products-given refit takes P and W as row shards against a
replicated gram.
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
    pad_bucket,
)
from cnmf_tpu_torch.ops.init import nnls_w_init
from cnmf_tpu_torch.ops.mu_kernels import (
    CHUNK,
    beta_mu_h_terms,
    beta_mu_w_terms,
    kl_h_denominator,
    kl_mu_h_numerator,
    kl_mu_w_numerator,
    kl_w_denominator,
    kl_x_log_wh,
    restart_sums,
    wh_chunks,
)
from cnmf_tpu_torch.parallel.collectives import broadcast, sum_shards
from cnmf_tpu_torch.parallel.mesh import Shards

EPSILON = float(np.finfo(np.float32).eps)
# steps a block: the stop rules' check cadence (sklearn's MU checks every 10
# iterations; the CD loop reads its done flags as often)
BLOCK = 10


def _run_solve(block, state, steps: int):
    """Blocks of ``block()`` over ``state`` (done flags at ``state[-2]``)
    until every restart is done or ``steps`` steps have run."""
    for n in range(-(-max(steps, 0) // BLOCK)):
        if n and bool(state[-2].all()):
            break
        block()


def _cd_block(sweep, state, tol: float, limit: int):
    """``BLOCK`` CD sweeps (the JAX body, cnmf_tpu/ops/nmf.py:400-418) of
    ``state`` = [*factors, violation_init, n_iter, done, git], replaced in
    the list. ``sweep(*factors)`` returns (*new factors, violation); ``git``
    is the global sweep index (sweep 0 sets violation_init), a 0-d int32
    tensor, and no sweep at ``limit`` or past it changes anything."""
    *factors, vi, n_iter, done, git = state
    for _ in range(BLOCK):
        *new, violation = sweep(*factors)
        violation = violation.to(vi.dtype)
        vi = torch.where(git == 0, violation, vi)
        keep = ~done & (git < limit)
        factors = [_keep(keep, f_new, f) for f_new, f in zip(new, factors)]
        n_iter = torch.where(keep, git + 1, n_iter)
        newly_done = torch.where(
            vi == 0, True, violation / vi.clamp(min=EPSILON) <= tol)
        done = done | (keep & newly_done)
        git = git + 1
    state[:] = (*factors, vi, n_iter, done, git)


def _keep(keep, new, old):
    """``new`` where ``keep`` (B,) holds, else ``old``: (B, M, K) tensors or
    lists of them (shards; ``keep`` is copied to each shard's device)."""
    if isinstance(new, (list, tuple)):
        return [_keep(keep, n, o) for n, o in zip(new, old)]
    return torch.where(keep.to(new.device)[:, None, None], new, old)


def _each(fn, F):
    """``fn`` of a tensor, or of each shard of a list."""
    return [fn(f) for f in F] if isinstance(F, (list, tuple)) else fn(F)


def _cd_state(factors, violation_init, n_iter, done, it0: int):
    """A CD solve's state list."""
    git = torch.full((), it0, dtype=torch.int32, device=done.device)
    return [*factors, violation_init, n_iter, done, git]


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
    defines violation_init). Returns (W, Ht, violation_init, n_iter,
    done)."""
    state = _cd_state((W, Ht), violation_init, n_iter, done, it0)

    def sweep(W, Ht):
        return _half_sweeps(X, W, Ht, update_H, l1_reg_W, l1_reg_H, l2_reg_W,
                            l2_reg_H)

    _run_solve(lambda: _cd_block(sweep, state, tol, it0 + seg_len), state,
               seg_len)
    return tuple(state[:5])


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
    float64 runs on the CPU. X may be ``Shards`` of its rows, with W0 the
    matching (B, rows, K) ``Shards`` and Ht0 on the first shard's device
    (``_cd_cells``); W then comes back as ``Shards``."""
    regs = dict(l1_reg_W=l1_reg_W, l1_reg_H=l1_reg_H, l2_reg_W=l2_reg_W,
                l2_reg_H=l2_reg_H)
    if isinstance(X, Shards):
        return _cd_cells(X, W0, Ht0, tol=tol, max_iter=max_iter,
                         update_H=update_H, **regs)
    B = W0.shape[0]
    dev = W0.device
    W, Ht, _, n_iter, _ = nmf_cd_segment(
        X, W0, Ht0,
        torch.zeros(B, dtype=W0.dtype, device=dev),
        torch.zeros(B, dtype=torch.int32, device=dev),
        torch.zeros(B, dtype=torch.bool, device=dev),
        0, seg_len=max_iter, tol=tol, update_H=update_H, **regs,
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
    P and W0 may be row ``Shards`` (axis 1) with gram on the first shard's
    device: each shard sweeps its rows against the gram, and the summed
    violation stops every shard at the same sweep. Returns (W, n_iter), W
    laid out as W0."""
    sharded = isinstance(P, Shards)
    Ws = W0.parts if sharded else [W0]
    Ps = P.parts if sharded else [P]
    grams = broadcast(gram, [p.device for p in Ps])
    B = Ws[0].shape[0]
    dev = Ws[0].device
    state = _cd_state(Ws, torch.zeros(B, dtype=Ws[0].dtype, device=dev),
                      torch.zeros(B, dtype=torch.int32, device=dev),
                      torch.zeros(B, dtype=torch.bool, device=dev), 0)

    def sweep(*Ws):
        halves = [cd_sweep_from_products(W, g, p, l1_reg=l1_reg, l2_reg=l2_reg)
                  for W, g, p in zip(Ws, grams, Ps)]
        return (*[h[0] for h in halves], sum_shards([h[1] for h in halves]))

    _run_solve(lambda: _cd_block(sweep, state, tol, max_iter), state,
               max_iter)
    n = len(Ws)
    W = Shards(state[:n], W0.n_rows, axis=1) if sharded else state[0]
    return W, state[n + 1]


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
    Returns (W (B,M,K), n_iter (B,)). X may be ``Shards``: of its rows, W0
    the matching row ``Shards``; or of its columns, Ht0 the matching
    ``Shards`` (``_fixed_products``)."""
    gram, P = _fixed_products(X, Ht0)
    return nnls_cd_from_products(
        gram, P, W0, tol=tol, max_iter=max_iter, l1_reg=l1_reg, l2_reg=l2_reg,
    )


def _fixed_products(X, Ht):
    """(gram, P) of a fixed Ht against X: on one device HtᵀHt and X·Ht; for
    X's rows in shards (Ht replicated) the gram and P's row shards; for X's
    columns in shards (Ht's rows following them) both summed over shards."""
    if not isinstance(X, Shards):
        return fixed_factor_gram(Ht), _shared_x_dot(X, Ht)
    if X.axis == 0:
        Hts = broadcast(Ht, X.devices)
        return fixed_factor_gram(Ht), Shards(
            [_shared_x_dot(x, h) for x, h in zip(X.parts, Hts)], X.n_rows, 1)
    return (sum_shards([_gram(h) for h in Ht.parts]),
            sum_shards([_shared_x_dot(x, h) for x, h in zip(X.parts, Ht.parts)]))


def reconstruction_sse(X, W, H, row_chunk: int = 4096):
    """sum((X − W·H)²), computed directly on row chunks of X: X (N, G),
    W (N, K), H (K, G). The K-selection prediction error (reference
    cnmf.py:925-930); the gram-trick form would cancel in float32. Only a
    (row_chunk × G) reconstruction is live at a time. X and W may be row
    ``Shards`` (zero padding adds nothing); the shards' sums are added in
    order."""
    if isinstance(X, Shards):
        Hs = broadcast(H, X.devices)
        return sum_shards([reconstruction_sse(x, w, h, row_chunk)
                           for x, w, h in zip(X.parts, W.parts, Hs)])
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


def _kl_x_terms(X):
    """The X-only terms of the KL divergence over X > eps: (Σ X·log X, Σ X)."""
    mask = X > EPSILON
    X_log_X = torch.where(mask, X * torch.log(X.clamp(min=EPSILON)), 0.0).sum()
    return X_log_X, torch.where(mask, X, 0.0).sum()


def _beta_divergence_chunked(X, W, Ht, beta: float):
    """beta ∉ {1, 2}: beta_div per restart from chunked reconstructions
    (sklearn's dense _beta_divergence: X <= eps excluded from the elementwise
    terms, WH floored at eps). The batch is padded with copies of its first
    restart to whole chunks of ``mu_kernels.CHUNK``, so every chunk's
    reduction has one shape and a restart's bits do not depend on B."""
    B = W.shape[0]
    size = -(-B // CHUNK) * CHUNK
    W, Ht = _padded(W, size), _padded(Ht, size)
    mask = X > EPSILON
    divs = torch.empty(size, dtype=W.dtype, device=W.device)
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
    return divs[:B]


def beta_divergence_error(X, W, Ht, beta: float, x_terms=None):
    """sqrt(2·beta_div(X, WH)) per restart (sklearn square_root=True).
    ``x_terms``: ``_kl_x_terms(X)``, when the caller has it (beta=1)."""
    if beta == 2:
        return frobenius_error(X, W, Ht)
    if beta == 1:
        X_log_X, sum_X = x_terms if x_terms is not None else _kl_x_terms(X)
        # the full Σ(W·H) by the rank-K identity, in an order that does not
        # depend on the batch
        sum_WH = restart_sums(
            (restart_sums(W) * restart_sums(Ht))[:, :, None])[:, 0]
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


def _mu_state(W0, Ht0, error_init, done):
    """A MU solve's state list: [W, Ht, prev_error, error_init, n_iter,
    done, git], the counters on the done flags' device."""
    dev = done.device
    return [W0, Ht0, error_init, error_init,
            torch.zeros(done.shape[0], dtype=torch.int32, device=dev),
            done, torch.zeros((), dtype=torch.int32, device=dev)]


class _MuTerms:
    """The MU updates and the divergence of one X on one device."""

    def __init__(self, X, beta):
        self.X, self.beta = X, beta
        self.x_terms = _kl_x_terms(X) if beta == 1 else None

    def update_w(self, W, Ht, gamma, l1_reg, l2_reg):
        return _mu_update_w(self.X, W, Ht, self.beta, gamma, l1_reg, l2_reg)

    def update_h(self, W, Ht, gamma, l1_reg, l2_reg):
        return _mu_update_h(self.X, W, Ht, self.beta, gamma, l1_reg, l2_reg)

    def error(self, W, Ht):
        return beta_divergence_error(self.X, W, Ht, self.beta, self.x_terms)


def _mu_block(terms, state, beta, tol, limit, update_H,
              l1_reg_W, l1_reg_H, l2_reg_W, l2_reg_H):
    """A function running ``BLOCK`` MU iterations (the JAX body,
    cnmf_tpu/ops/nmf.py:1277-1308) of ``state`` (``_mu_state``), replaced
    in the list; ``terms`` computes the updates and the divergence
    (``_MuTerms``, or a sharded twin whose factors may be lists of shards).
    Blocks start at multiples of ``BLOCK`` of the global counter ``git``, so
    sklearn's every-10 check falls on each block's last iteration; no
    iteration at ``limit`` or past it, and no check past it, changes
    anything."""
    if beta < 1:
        gamma = 1.0 / (2.0 - beta)
    elif beta > 2:
        gamma = 1.0 / (beta - 1.0)
    else:
        gamma = 1.0

    def block():
        W, Ht, prev_error, error_init, n_iter, done, git = state
        for _ in range(BLOCK):
            W_new = terms.update_w(W, Ht, gamma, l1_reg_W, l2_reg_W)
            if beta < 1:
                W_new = _each(lambda f: torch.where(f < _EPS64, 0.0, f), W_new)
            keep = ~done & (git < limit)
            if update_H:
                Ht_new = terms.update_h(W_new, Ht, gamma, l1_reg_H, l2_reg_H)
                if beta <= 1:
                    Ht_new = _each(lambda f: torch.where(f < _EPS64, 0.0, f),
                                   Ht_new)
                Ht = _keep(keep, Ht_new, Ht)
            W = _keep(keep, W_new, W)
            n_iter = torch.where(keep, git + 1, n_iter)
            git = git + 1
        if tol > 0:
            error = terms.error(W, Ht).to(error_init.dtype)
            check = git <= limit
            done = done | (check & ((prev_error - error)
                                    / error_init.clamp(min=EPSILON) < tol))
            prev_error = torch.where(check, error, prev_error)
        state[:] = (W, Ht, prev_error, error_init, n_iter, done, git)

    return block


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
    chunk: int = CHUNK,
    error_init0: Optional[torch.Tensor] = None,
    prev_error0: Optional[torch.Tensor] = None,
    done0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched beta-divergence NMF via multiplicative updates.

    beta: 2 = frobenius, 1 = kullback-leibler, 0 = itakura-saito. X (N, G);
    W0 (B, N, K); Ht0 (B, G, K). Every 10 iterations the restarts whose
    relative error improvement (previous_error - error) / error_at_init is
    below tol stop (sklearn's rule); the all-done flag is read on the host at
    those checks only, and frozen restarts stop changing. Returns W, Ht and
    n_iter (B,) int32.

    ``chunk``: the JAX package's restart chunk of the reconstruction; here
    the reconstructions always go in chunks of ``mu_kernels.CHUNK``
    restarts, the fixed order the kernels' sums take, whatever is passed.
    ``error_init0`` / ``prev_error0``: (B,) starting values of the stopping
    rule's denominator and previous error (default: the divergence at W0,
    Ht0); ``done0``: (B,) bool, restarts that start stopped
    (cnmf_tpu/ops/nmf.py:1246-1253).

    X may be ``Shards``: of its rows, with W0 the matching (B, rows, K)
    ``Shards`` and Ht0 on the first shard's device; or of its columns (the
    transpose of a row-sharded matrix: the spectra refit), with Ht0 the
    matching ``Shards``, W0 on the first shard's device and update_H False.
    The sharded factor comes back as ``Shards``."""
    if isinstance(X, Shards):
        terms = (_RowShardTerms if X.axis == 0 else _ColShardTerms)(X, beta)
        if X.axis == 1 and update_H:
            raise ValueError("a column-sharded X solves with H fixed only")
        W0s, Ht0s = (f.parts if isinstance(f, Shards) else f
                     for f in (W0, Ht0))
    else:
        terms, W0s, Ht0s = _MuTerms(X, beta), W0, Ht0
    dtype = Ht0s.dtype if isinstance(W0s, list) else W0s.dtype
    B = Ht0s[0].shape[0] if isinstance(Ht0s, list) else Ht0s.shape[0]
    error_init = (error_init0 if error_init0 is not None else
                  terms.error(W0s, Ht0s)).to(dtype)
    dev = error_init.device
    state = _mu_state(W0s, Ht0s, error_init,
                      torch.zeros(B, dtype=torch.bool, device=dev)
                      if done0 is None else done0.to(torch.bool))
    if prev_error0 is not None:
        state[2] = prev_error0.to(dtype)
    block = _mu_block(terms, state, beta, tol, max_iter, update_H,
                      l1_reg_W, l1_reg_H, l2_reg_W, l2_reg_H)
    _run_solve(block, state, max_iter)
    W, Ht = (Shards(f, f0.n_rows, axis=1) if isinstance(f0, Shards) else f
             for f, f0 in ((state[0], W0), (state[1], Ht0)))
    return W, Ht, state[4]


def _data_and_fixed(X, H, device):
    """X and the fixed factor H as tensors on one device: a tensor X keeps
    its own; host arrays (the JAX API's arguments) go to ``device``."""
    X = X if isinstance(X, torch.Tensor) else torch.as_tensor(X, device=device)
    return X, torch.as_tensor(H, device=X.device)


def nnls_coordinate_descent(X, H, *, tol=1e-4, max_iter=200,
                            l1_reg_W=0.0, l2_reg_W=0.0, device="cuda"):
    """Solve min_{W>=0} ||X - W·H|| with H fixed via CD; W starts at zeros
    (the reference's refit path, cnmf.py:776-802 → sklearn update_H=False,
    zeros init for the CD solver). X (N, G), H (K, G): tensors, solved on
    X's device, or host arrays, put on ``device``. K is zero-padded to its
    bucket of 8 for the solve. Returns W (N, K) and the sweep count."""
    X, H = _data_and_fixed(X, H, device)
    k = H.shape[0]
    Ht0 = torch.nn.functional.pad(H.T.to(X.dtype), (0, pad_bucket(k) - k))
    W0 = nnls_w_init(X, k, "cd", pad_k=Ht0.shape[1])
    W, n_iter = nnls_cd_fixed_spectra(
        X, Ht0.contiguous()[None], W0, tol=tol, max_iter=max_iter,
        l1_reg=l1_reg_W, l2_reg=l2_reg_W,
    )
    return W[0, :, :k], int(n_iter[0])


def nnls_multiplicative_update(X, H, *, beta=1.0, tol=1e-4, max_iter=200,
                               l1_reg_W=0.0, l2_reg_W=0.0, chunk=CHUNK,
                               device="cuda"):
    """Fixed-H NNLS via MU; W starts at sqrt(X.mean()/K) (sklearn 'mu'
    rule). X (N, G), H (K, G), placed as in ``nnls_coordinate_descent``.
    Returns W (N, K) and the iteration count. ``chunk`` as in
    ``nmf_multiplicative_update`` (one restart here)."""
    X, H = _data_and_fixed(X, H, device)
    W0 = nnls_w_init(X, H.shape[0], "mu")
    Ht0 = H.T.to(X.dtype).contiguous()[None]
    W, _, n_iter = nmf_multiplicative_update(
        X, W0, Ht0, beta=beta, tol=tol, max_iter=max_iter, update_H=False,
        l1_reg_W=l1_reg_W, l2_reg_W=l2_reg_W, chunk=chunk,
    )
    return W[0], int(n_iter[0])


# ----------------------------------------------------------------------
# the device ladders: restart compaction on the card
# ----------------------------------------------------------------------

def _ladder(b0: int, min_bucket: int = 32):
    """Descending batch-size ladder (each a multiple of 8, halving down to
    ``min_bucket``): the rungs the device ladders shrink the batch through
    (cnmf_tpu/ops/nmf.py:_ladder)."""
    sizes = [max(8 * ((b0 + 7) // 8), 8)]
    while sizes[-1] > min_bucket:
        sizes.append(max(min_bucket, 8 * ((sizes[-1] // 2 + 7) // 8)))
    return sizes


def _padded(F0, size):
    """F0 (B0, M, K) with copies of its first restart appended up to
    ``size``."""
    pad = size - F0.shape[0]
    return torch.cat([F0, F0[:1].expand(pad, *F0.shape[1:])]) if pad else F0


def _check_ladder(ladder, B0):
    ladder = tuple(int(s) for s in ladder) or (B0,)
    if ladder[0] < B0 or any(a <= b for a, b in zip(ladder, ladder[1:])):
        raise ValueError(f"ladder {ladder}: descending sizes, the first at "
                         f"least the batch's {B0}")
    return ladder


def _run_ladder(state, make_block, ladder, B0: int, max_iter: int):
    """The ladder's rungs (cnmf_tpu/ops/nmf.py:772-817) over ``state`` =
    [W, Ht, ..., n_iter, done, git] at batch ``ladder[0]``, its rows past B0
    padding that starts done. Each rung runs ``make_block(state)``'s blocks
    until its live restarts fit the next rung or ``max_iter`` sweeps have
    run; then every row's spectra and n_iter land in a (B0 + 1)-row buffer
    under its original position (padding in the last row), and a stable
    argsort on ``done`` gathers the live restarts to the front of the next
    rung's batch. Returns (spectra (B0, K, G), n_iter (B0,), the sweeps run
    at each rung)."""
    Ht = state[1]
    dev, (_, G, K) = Ht.device, Ht.shape
    pos = torch.arange(ladder[0], device=dev).clamp(max=B0)
    out = torch.zeros((B0 + 1, K, G), dtype=Ht.dtype, device=dev)
    out_n = torch.zeros(B0 + 1, dtype=torch.int32, device=dev)
    stage_sweeps, it = [], 0
    for si, size in enumerate(ladder):
        nxt = ladder[si + 1] if si + 1 < len(ladder) else 0
        block, n = make_block(state), 0
        while (it + n * BLOCK < max_iter
               and size - int(state[-2].sum()) > nxt):
            block()
            n += 1
        stage_sweeps.append(min(it + n * BLOCK, max_iter) - min(it, max_iter))
        it += n * BLOCK
        # finished rows are final here; rows that ride on are overwritten by
        # a later rung
        out[pos] = state[1].transpose(1, 2)
        out_n[pos] = state[-3]
        if nxt:
            order = torch.argsort(state[-2].to(torch.int8), stable=True)[:nxt]
            state = [t[order] for t in state[:-1]] + [state[-1]]
            pos = pos[order]
    return out[:B0], out_n[:B0], stage_sweeps


def nmf_cd_device_ladder(
    X, W0, Ht0, *, tol: float = 1e-4, max_iter: int = 200,
    ladder: tuple = (), l1_reg_W: float = 0.0, l1_reg_H: float = 0.0,
    l2_reg_W: float = 0.0, l2_reg_H: float = 0.0,
):
    """Batched CD whose batch shrinks on the card as restarts finish
    (cnmf_tpu/ops/nmf.py:nmf_cd_device_ladder :710): ``_run_ladder`` over
    the rungs of ``ladder`` (descending, the first at least B0), the sweep
    blocks of ``nmf_cd_segment`` at each. The plain solver's batch runs as
    long as its slowest restart; here the work follows the distribution of
    sweeps. Frozen restarts never change and every row leaves the batch only
    once it is done or at ``max_iter``, so n_iter and the spectra are the
    plain solver's where the arithmetic of a restart does not depend on the
    batch it shares. A rung stops at a block boundary, up to 9 sweeps past
    the point where its live restarts fit the next one: the sweeps run sum
    to min(max_iter, 10·⌈max n_iter / 10⌉).

    Returns (spectra (B0, K, G), n_iter (B0,), stage_sweeps): the executed
    restart-sweeps are Σ ladder[i]·stage_sweeps[i]."""
    B0 = W0.shape[0]
    ladder = _check_ladder(ladder, B0)
    Bp = ladder[0]
    dev = W0.device
    state = _cd_state((_padded(W0, Bp), _padded(Ht0, Bp)),
                      torch.zeros(Bp, dtype=W0.dtype, device=dev),
                      torch.zeros(Bp, dtype=torch.int32, device=dev),
                      torch.arange(Bp, device=dev) >= B0, 0)

    def sweep(W, Ht):
        return _half_sweeps(X, W, Ht, True, l1_reg_W, l1_reg_H, l2_reg_W,
                            l2_reg_H)

    def make_block(st):
        return lambda: _cd_block(sweep, st, tol, max_iter)

    return _run_ladder(state, make_block, ladder, B0, max_iter)


def nmf_mu_device_ladder(
    X, W0, Ht0, *, beta: float = 2.0, tol: float = 1e-4,
    max_iter: int = 200, ladder: tuple = (),
    l1_reg_W: float = 0.0, l1_reg_H: float = 0.0,
    l2_reg_W: float = 0.0, l2_reg_H: float = 0.0,
):
    """Batched MU on a shrinking batch, the MU twin of
    ``nmf_cd_device_ladder`` (cnmf_tpu/ops/nmf.py:nmf_mu_device_ladder
    :1393): prev_error and error_init ride the gathers, and the every-10
    check follows the global counter, so done changes only at multiples of
    10 and each rung ends where the JAX package's does. The error at init is
    taken over the padded batch, as there. Returns (spectra (B0, K, G),
    n_iter (B0,), stage_sweeps)."""
    B0 = W0.shape[0]
    ladder = _check_ladder(ladder, B0)
    Bp = ladder[0]
    W, Ht = _padded(W0, Bp), _padded(Ht0, Bp)
    terms = _MuTerms(X, beta)
    error_init = terms.error(W, Ht).to(W0.dtype)
    state = _mu_state(W, Ht, error_init,
                      torch.arange(Bp, device=W0.device) >= B0)

    def make_block(st):
        return _mu_block(terms, st, beta, tol, max_iter, True,
                         l1_reg_W, l1_reg_H, l2_reg_W, l2_reg_H)

    return _run_ladder(state, make_block, ladder, B0, max_iter)


# ----------------------------------------------------------------------
# cell-sharded solves: X's rows (and W's) over a list of devices
# ----------------------------------------------------------------------

def _cd_cells(X, W0, Ht0, *, tol, max_iter, update_H, l1_reg_W, l1_reg_H,
              l2_reg_W, l2_reg_H):
    """``nmf_coordinate_descent`` on row shards (the JAX package's GSPMD
    solve on a ``cell`` axis, cnmf_tpu/pipeline/solvers.py:782-786): the W
    half is ``cd_w_half_sweep`` on each shard's rows against the replicated
    Ht; the H half sums the shards' WᵀW and XᵀW (plain matmuls) and sweeps
    Ht on the first shard's device with ``cd_sweep_from_products``; the
    violation is summed over shards. Padded rows are zero in X and W and
    stay zero (their gradient is 0)."""
    B = Ht0.shape[0]
    n = len(X.parts)
    dev = Ht0.device
    state = _cd_state((*W0.parts, Ht0),
                      torch.zeros(B, dtype=Ht0.dtype, device=dev),
                      torch.zeros(B, dtype=torch.int32, device=dev),
                      torch.zeros(B, dtype=torch.bool, device=dev), 0)

    def sweep(*factors):
        Ws, Ht = factors[:n], factors[n]
        halves = [cd_w_half_sweep(x, w, h, l1_reg=l1_reg_W, l2_reg=l2_reg_W)
                  for x, w, h in zip(X.parts, Ws, broadcast(Ht, X.devices))]
        Ws = [h[0] for h in halves]
        violation = sum_shards([h[1] for h in halves])
        if not update_H:
            return (*Ws, Ht, violation)
        gram = sum_shards([_gram(w) for w in Ws])
        P = sum_shards([_shared_xt_dot(x, w) for x, w in zip(X.parts, Ws)])
        Ht, viol_h = cd_sweep_from_products(Ht, gram, P, l1_reg=l1_reg_H,
                                            l2_reg=l2_reg_H)
        return (*Ws, Ht, violation + viol_h)

    _run_solve(lambda: _cd_block(sweep, state, tol, max_iter), state,
               max_iter)
    return Shards(state[:n], W0.n_rows, axis=1), state[n], state[n + 2]


def _sum_x_terms(parts):
    """``_kl_x_terms`` of a matrix in parts, summed over them."""
    terms = [_kl_x_terms(x) for x in parts]
    return tuple(sum_shards([t[i] for t in terms]) for i in range(2))


def _beta_div_from(divs, beta, pad_elems):
    """``_beta_divergence_chunked`` summed over shards, less what each
    shard's padding added: at beta 0 every shard subtracts its full element
    count, and the padded elements are no elements of X."""
    return divs + pad_elems if beta == 0 else divs


class _RowShardTerms:
    """The MU terms of X's row shards, W's rows following them (a list of
    (B, rows, K) parts) and Ht replicated on the first shard's device: the W
    update runs on each shard; the H update's numerator and denominator and
    the divergence's terms are summed over shards."""

    def __init__(self, X, beta):
        self.Xs, self.devices, self.beta = X.parts, X.devices, beta
        self.pad_elems = (X.padded_rows - X.n_rows) * X.shape[1]
        self.x_terms = _sum_x_terms(self.Xs) if beta == 1 else None
        self.x_sq = (sum_shards([torch.sum(x * x) for x in self.Xs])
                     if beta == 2 else None)

    def update_w(self, Ws, Ht, gamma, l1_reg, l2_reg):
        return [_mu_update_w(x, w, h, self.beta, gamma, l1_reg, l2_reg)
                for x, w, h in zip(self.Xs, Ws, broadcast(Ht, self.devices))]

    def update_h(self, Ws, Ht, gamma, l1_reg, l2_reg):
        beta = self.beta
        if beta == 2:
            numerator = sum_shards([_shared_xt_dot(x, w)
                                    for x, w in zip(self.Xs, Ws)])
            denominator = torch.bmm(Ht, sum_shards([_gram(w) for w in Ws]))
        elif beta == 1:
            Hts = broadcast(Ht, self.devices)
            numerator = sum_shards([kl_mu_h_numerator(x, w, h)
                                    for x, w, h in zip(self.Xs, Ws, Hts)])
            w_sum = sum_shards([restart_sums(w) for w in Ws])
            denominator = torch.where(w_sum == 0, 1.0, w_sum)[:, None, :]
        else:
            Hts = broadcast(Ht, self.devices)
            terms = [beta_mu_h_terms(x, w, h, beta)
                     for x, w, h in zip(self.Xs, Ws, Hts)]
            numerator = sum_shards([t[0] for t in terms])
            denominator = sum_shards([t[1] for t in terms])
        return _mu_step(Ht, numerator, denominator, gamma, l1_reg, l2_reg)

    def error(self, Ws, Ht):
        beta = self.beta
        if beta == 2:
            Hts = broadcast(Ht, self.devices)
            cross = sum_shards([torch.einsum("bnk,bnk->b", w, _shared_x_dot(x, h))
                                for x, w, h in zip(self.Xs, Ws, Hts)])
            wh_norm = torch.einsum("bkl,bkl->b",
                                   sum_shards([_gram(w) for w in Ws]), _gram(Ht))
            return torch.sqrt((self.x_sq + wh_norm - 2.0 * cross).clamp(min=0.0))
        Hts = broadcast(Ht, self.devices)
        if beta == 1:
            X_log_X, sum_X = self.x_terms
            w_sum = sum_shards([restart_sums(w) for w in Ws])
            sum_WH = restart_sums((w_sum * restart_sums(Ht))[:, :, None])[:, 0]
            divs = (-sum_shards([kl_x_log_wh(x, w, h)
                                 for x, w, h in zip(self.Xs, Ws, Hts)])
                    + X_log_X - sum_X + sum_WH)
        else:
            divs = _beta_div_from(sum_shards([
                _beta_divergence_chunked(x, w, h, beta)
                for x, w, h in zip(self.Xs, Ws, Hts)]), beta, self.pad_elems)
        return torch.sqrt((2.0 * divs).clamp(min=0.0))


class _ColShardTerms:
    """The MU terms of X's column shards (the transpose of a row-sharded
    matrix), Ht's rows following them and W replicated on the first shard's
    device, with H fixed: the fixed-usage spectra refit of a row-sharded
    TPM. They are ``_RowShardTerms`` of Xᵀ's row shards with the factors'
    roles swapped: W's update is their H update."""

    def __init__(self, X, beta):
        self.rows = _RowShardTerms(X.T, beta)

    def update_w(self, W, Hts, gamma, l1_reg, l2_reg):
        return self.rows.update_h(Hts, W, gamma, l1_reg, l2_reg)

    def error(self, W, Hts):
        return self.rows.error(Hts, W)
