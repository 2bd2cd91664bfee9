"""Fused HALS coordinate-descent half-sweeps: CUDA kernels and their plain twins.

Port of ``cnmf_tpu/ops/pallas_cd.py`` (``cd_w_half_sweep`` :118 and
``cd_h_half_sweep`` :162, both built on ``_column_sweep`` :58). Each
wrapper here takes the unpadded solver layout — X (N, G) shared by every
restart, W (B, N, K), Ht (B, G, K) — and dispatches on where its tensors lie:

* CUDA tensors launch the hand-written kernel of ``csrc/cd_half_sweep.cu``
  (f32, contiguous, K a positive multiple of 8: registers up to 64, a wide
  variant above). Anything else on CUDA raises; there is no fallback to the
  plain version.
* CPU tensors run the plain PyTorch version below: the same column-cyclic
  update as ``cnmf_tpu.ops.nmf._cd_half_sweep``, at the tensors' dtype, its
  product and gram summed in float64 for f32 tensors and each restart's
  product computed alone (its bits do not follow the batch); on a card the
  same function at f32 with one flat product is the kernels' yardstick.
  This is where ``compute_dtype=float64`` runs; the kernels are f32 only.

The kernel computes the data product (X·Ht for W, Xᵀ·W for Ht) inside its
own body, as the Pallas kernels did (pallas_cd.py:86, :100); the (K, K) grams
are computed outside, as pallas_cd.py:124 and :167 do. A third entry point,
``cd_sweep_from_products``, runs the same sweep on a precomputed product —
every fixed-factor refit of the consensus stage goes through it.

Each wrapper counts its kernel launches in a ``launches`` attribute, so a run
can show that its main path went through the kernels. The library is built
at first use by ``ops/kernel_lib.py``; importing this module needs neither
``nvcc`` nor a GPU.
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
    launch,
    library_constant,
)


def pad_bucket(k: int) -> int:
    """K zero-padded to the next multiple of 8, the K the kernels take. The
    padding is an exact no-op: a zero column has a zero gram diagonal and is
    skipped."""
    return -(-int(k) // 8) * 8


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy dtype (or a torch dtype, returned as is)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def numpy_dtype(dtype) -> np.dtype:
    """numpy dtype of a torch dtype (or of a numpy dtype, as np.dtype)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def factors_from_numpy(W0, Ht0, *, device, dtype):
    """The JAX package's (B, N, K) / (B, G, K) numpy factors as contiguous
    tensors on ``device`` — the same inits then feed both solvers."""
    dt = torch_dtype(dtype)
    return (
        torch.as_tensor(np.ascontiguousarray(W0), device=device).to(dt).contiguous(),
        torch.as_tensor(np.ascontiguousarray(Ht0), device=device).to(dt).contiguous(),
    )


# ----------------------------------------------------------------------
# plain PyTorch versions (CPU tensors, and the reference the kernels are
# held against on the card)
# ----------------------------------------------------------------------

def accumulation_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype the plain half-sweeps sum their products and grams in: on
    the CPU float64 for narrower floats (rounded once to the factor's
    dtype, so the plain version stays at least as close to the exact sweep
    as the JAX package's f32 references), else ``t``'s dtype (on a card the
    plain version is the f32 yardstick the kernels are held against)."""
    if t.device.type == "cpu" and t.dtype in (torch.float32, torch.float16,
                                               torch.bfloat16):
        return torch.float64
    return t.dtype


def _per_restart(A, F, acc=None):
    """A (M, C) shared by every restart · F (B, C, K) → (B, M, K). On the
    CPU each restart is its own (M, C)·(C, K) product of one batched call
    over a stride-0 A, so a restart's bits do not depend on the restarts
    beside it; on a card one flat (M, C)·(C, B·K) matmul (which may round
    a column by its place in the batch). ``acc``: the dtype to sum in,
    rounded to F's dtype at the end."""
    acc = acc or F.dtype
    B, C, K = F.shape
    if A.device.type == "cpu":
        out = torch.bmm(A.to(acc).expand(B, *A.shape), F.to(acc))
    else:
        flat = F.to(acc).permute(1, 0, 2).reshape(C, B * K)
        out = (A.to(acc) @ flat).reshape(A.shape[0], B, K).permute(1, 0, 2)
    return out.to(F.dtype).contiguous()


def _shared_x_dot(X, F, acc=None):
    """X (N,G) · F (B,G,K) → (B,N,K)."""
    return _per_restart(X, F, acc)


def _shared_xt_dot(X, F, acc=None):
    """Xᵀ (G,N) · F (B,N,K) → (B,G,K), reading X through its strides."""
    return _per_restart(X.T, F, acc)


def _gram(F, acc=None):
    """(B, M, K) → (B, K, K) = FᵀF per restart, summed in ``acc``."""
    Fa = F.to(acc or F.dtype)
    return torch.bmm(Fa.transpose(1, 2), Fa).to(F.dtype)


def _cd_half_sweep(F, G, P, l1_reg: float, l2_reg: float):
    """One cyclic CD pass updating factor F (cnmf_tpu.ops.nmf._cd_half_sweep).

    F (B, M, K) factor being updated; G (B, K, K) gram of the other factor;
    P (B, M, K) data product. Column order 0..K-1 (sklearn shuffle=False);
    columns whose hessian G[t, t] is 0 are skipped. Returns the updated F (a
    new tensor, updated in place column by column) and the per-restart summed
    |projected gradient| violation."""
    B, M, K = F.shape
    if l2_reg != 0.0:
        G = G + l2_reg * torch.eye(K, dtype=G.dtype, device=G.device)
    if l1_reg != 0.0:
        P = P - l1_reg
    F = F.clone()
    violation = torch.zeros(B, dtype=F.dtype, device=F.device)
    for t in range(K):
        g_col = G[:, :, t]
        hess = G[:, t, t]
        f_col = F[:, :, t]
        grad = torch.bmm(F, g_col.unsqueeze(2)).squeeze(2) - P[:, :, t]
        pgrad = torch.where(f_col == 0, grad.clamp(max=0.0), grad)
        live = hess != 0
        violation = violation + torch.where(live, pgrad.abs().sum(dim=1), 0.0)
        safe_hess = torch.where(live, hess, 1.0)
        f_new = (f_col - grad / safe_hess[:, None]).clamp(min=0.0)
        F[:, :, t] = torch.where(live[:, None], f_new, f_col)
    return F, violation


def cd_w_half_sweep_plain(X, W, Ht, *, l1_reg=0.0, l2_reg=0.0):
    """Plain version of ``cd_w_half_sweep``."""
    acc = accumulation_dtype(W)
    return _cd_half_sweep(W, _gram(Ht, acc), _shared_x_dot(X, Ht, acc),
                          l1_reg, l2_reg)


def cd_h_half_sweep_plain(X, W, Ht, *, l1_reg=0.0, l2_reg=0.0):
    """Plain version of ``cd_h_half_sweep``."""
    acc = accumulation_dtype(Ht)
    return _cd_half_sweep(Ht, _gram(W, acc), _shared_xt_dot(X, W, acc),
                          l1_reg, l2_reg)


def cd_sweep_from_products_plain(F, gram, P, *, l1_reg=0.0, l2_reg=0.0):
    """Plain version of ``cd_sweep_from_products``."""
    return _cd_half_sweep(F, gram, P, l1_reg, l2_reg)


# ----------------------------------------------------------------------
# the CUDA kernels
# ----------------------------------------------------------------------

_FUSED_ARGS = (VP, I32, I32, I64, I64, VP, VP, VP, F32, I32, I32, VP, VP, VP,
               VP)
_PRODUCTS_ARGS = (VP, I32, VP, VP, F32, I32, I32, VP, VP, VP)


# largest K whose rows the kernels hold in registers (csrc/common.cuh)
REGISTER_MAX_K = 64


def _tile_rows(name, K):
    """Rows one block of the products-given sweep owns at K; raises for a K
    that has no kernel."""
    check_k(name, K)
    return library_constant("cd_tile_rows", K)


def fused_tiling(K, transposed):
    """The fused half-sweep's tiling at K for the W half (``transposed``
    False) or the H half: (rows a block owns, restarts it owns, threads per
    block, blocks an SM holds at once). Raises for a K that has no kernel."""
    check_k("fused_tiling", K)
    return tuple(library_constant("cd_fused_tiling", K, int(transposed), field)
                 for field in range(4))


def _with_l2(gram, l2_reg):
    """gram + l2·I, the hessian the kernels take (pallas_cd.py:127-128)."""
    if l2_reg != 0.0:
        gram = gram + l2_reg * torch.eye(
            gram.shape[-1], dtype=gram.dtype, device=gram.device
        )
    return gram.contiguous()


def _launch_fused(name, X, F, F_other, gram, l1_reg, transposed):
    """F (B, M, K) against F_other (B, C, K): the W half reads X as (M=N, C=G),
    the H half reads it transposed as (M=G, C=N)."""
    B, M, K = F.shape
    N, G = X.shape
    if transposed:
        C, sxm, sxc = N, 1, G
    else:
        C, sxm, sxc = G, G, 1
    if M != (G if transposed else N) or F_other.shape != (B, C, K):
        raise ValueError(f"{name}: shapes X {tuple(X.shape)}, factor "
                         f"{tuple(F.shape)}, other {tuple(F_other.shape)}")
    check_cuda(name, X, F, F_other, gram)
    check_k(name, K)
    tiles = -(-M // library_constant("cd_fused_tiling", K, int(transposed), 0))
    out = torch.empty_like(F)
    part = torch.empty((tiles, B), dtype=torch.float32, device=F.device)
    # a K above the register buckets accumulates X·F_other in device memory
    scratch = torch.empty_like(F) if K > REGISTER_MAX_K else None
    launch(name, kernel_function("cd_half_sweep_fused", _FUSED_ARGS), F,
           X.data_ptr(), M, C, sxm, sxc, F_other.data_ptr(), F.data_ptr(),
           gram.data_ptr(), float(l1_reg), B, K, out.data_ptr(),
           part.data_ptr(), None if scratch is None else scratch.data_ptr())
    return out, part.sum(dim=0)


# ----------------------------------------------------------------------
# the wrappers the solvers call
# ----------------------------------------------------------------------

def cd_w_half_sweep(X, W, Ht, *, l1_reg=0.0, l2_reg=0.0):
    """One W half-sweep with Ht fixed: gram = HtᵀHt + l2·I, P = X·Ht − l1,
    then the K column updates of W. Returns (W_new (B,N,K), violation (B,)).
    Replaces cnmf_tpu/ops/pallas_cd.py:cd_w_half_sweep."""
    if device_kind("cd_w_half_sweep", W) == "cpu":
        return cd_w_half_sweep_plain(X, W, Ht, l1_reg=l1_reg, l2_reg=l2_reg)
    out = _launch_fused("cd_w_half_sweep", X, W, Ht, _with_l2(_gram(Ht), l2_reg),
                        l1_reg, transposed=False)
    cd_w_half_sweep.launches += 1
    return out


def cd_h_half_sweep(X, W, Ht, *, l1_reg=0.0, l2_reg=0.0):
    """One Ht half-sweep with W fixed: gram = WᵀW + l2·I, P = Xᵀ·W − l1.
    Returns (Ht_new (B,G,K), violation (B,)). Replaces
    cnmf_tpu/ops/pallas_cd.py:cd_h_half_sweep."""
    if device_kind("cd_h_half_sweep", Ht) == "cpu":
        return cd_h_half_sweep_plain(X, W, Ht, l1_reg=l1_reg, l2_reg=l2_reg)
    out = _launch_fused("cd_h_half_sweep", X, Ht, W, _with_l2(_gram(W), l2_reg),
                        l1_reg, transposed=True)
    cd_h_half_sweep.launches += 1
    return out


def cd_sweep_from_products(F, gram, P, *, l1_reg=0.0, l2_reg=0.0):
    """One half-sweep of F (B,M,K) from a precomputed gram (B,K,K) and data
    product P (B,M,K) — the fixed-factor refit loop of
    ``nnls_cd_from_products``. Returns (F_new, violation (B,))."""
    name = "cd_sweep_from_products"
    if device_kind(name, F) == "cpu":
        return cd_sweep_from_products_plain(F, gram, P, l1_reg=l1_reg,
                                            l2_reg=l2_reg)
    B, M, K = F.shape
    if P.shape != F.shape or gram.shape != (B, K, K):
        raise ValueError(f"{name}: shapes F {tuple(F.shape)}, gram "
                         f"{tuple(gram.shape)}, P {tuple(P.shape)}")
    gram = _with_l2(gram, l2_reg)
    check_cuda(name, F, gram, P)
    tiles = -(-M // _tile_rows(name, K))
    out = torch.empty_like(F)
    part = torch.empty((tiles, B), dtype=torch.float32, device=F.device)
    launch(name, kernel_function("cd_half_sweep_products", _PRODUCTS_ARGS), F,
           P.data_ptr(), M, F.data_ptr(), gram.data_ptr(), float(l1_reg), B,
           K, out.data_ptr(), part.data_ptr())
    cd_sweep_from_products.launches += 1
    return out, part.sum(dim=0)


cd_w_half_sweep.launches = 0
cd_h_half_sweep.launches = 0
cd_sweep_from_products.launches = 0
