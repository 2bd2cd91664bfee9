"""OLS of (optionally z-scored) targets on usages, in PyTorch.

Replaces the reference's chunked-on-CPU ``efficient_ols_all_cols``
(reference cnmf.py:55-125) as ``cnmf_tpu.ops.ols`` does: Beta = (UᵀU)⁻¹ Uᵀ Z
where Z is the per-column z-scored target matrix. For a Y on the device UᵀZ
is one matmul with the z-scoring folded in; a host Y (the atlas consensus,
whose TPM stays off the card) takes a row-blocked float64 SpMM when sparse
and a row-batched accumulation on the device when dense. The K×K solve runs
on the host with numpy's lstsq (LAPACK gelsd) to match the reference's
rcond=None semantics.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from cnmf_tpu_torch.ops.cd_kernels import numpy_dtype, torch_dtype
from cnmf_tpu_torch.ops.stats import column_moments, mean_var
from cnmf_tpu_torch.parallel.collectives import sum_shards
from cnmf_tpu_torch.parallel.mesh import Shards, shard_like

# nonzeros per accumulation block of the sparse host UᵀY product: bounds the
# block's float64 cast of the data at ~200 MB (tests shrink it to force
# several blocks)
SPMM_BLOCK_NNZ = 25_000_000


def _xty_zscored(U: torch.Tensor, Y: torch.Tensor, mean: torch.Tensor,
                 inv_std: torch.Tensor) -> torch.Tensor:
    """Uᵀ · ((Y - mean)·inv_std) without materializing the normalized Y:
    UᵀY·inv_std − (Uᵀ1)·(mean·inv_std). U and Y may be row ``Shards`` of
    one layout: UᵀY and Uᵀ1 are then summed over shards."""
    if isinstance(Y, Shards):
        uty = sum_shards([u.T @ y for u, y in zip(U.parts, Y.parts)])
        u_sum = sum_shards([torch.sum(u, dim=0) for u in U.parts])
    else:
        uty = U.T @ Y
        u_sum = torch.sum(U, dim=0)
    return (uty - u_sum[:, None] * mean[None, :]) * inv_std[None, :]


def _sparse_xty(U64: np.ndarray, Y) -> np.ndarray:
    """UᵀY in float64 by host SpMM over row blocks of at most
    ``SPMM_BLOCK_NNZ`` nonzeros: each block casts only its own data to
    float64, and the blocks are views of Y's arrays."""
    Yr = Y.tocsr()
    XtY = np.zeros((U64.shape[1], Y.shape[1]), dtype=np.float64)
    r0 = 0
    while r0 < Yr.shape[0]:
        # bound each block by its actual nonzeros, not the mean density:
        # cells sorted by depth would otherwise blow the block's cast
        r1 = int(np.searchsorted(
            Yr.indptr, int(Yr.indptr[r0]) + SPMM_BLOCK_NNZ, side="right")) - 1
        r1 = min(max(r1, r0 + 1), Yr.shape[0])
        p0, p1 = int(Yr.indptr[r0]), int(Yr.indptr[r1])
        block = sp.csr_matrix(
            (Yr.data[p0:p1].astype(np.float64), Yr.indices[p0:p1],
             Yr.indptr[r0:r1 + 1] - p0),
            shape=(r1 - r0, Yr.shape[1]), copy=False,
        )
        XtY += np.asarray(block.T @ U64[r0:r1]).T
        r0 = r1
    return XtY


def efficient_ols_all_cols(
    U: np.ndarray,
    Y,
    normalize_y: bool = False,
    *,
    device=None,
    dtype=None,
    batch_size: int = 16384,
) -> np.ndarray:
    """OLS coefficients (n_predictors × n_targets) of Y's columns on U.

    U: (N, K) host usages. Y: (N, G) targets: a tensor or row ``Shards``
    (U is split to match, padded rows zero; the sums run over shards, the
    moments divide by the real row count), whose device and dtype the
    products run in, or a host matrix, with ``device`` and ``dtype`` (numpy
    or torch) given. A sparse host Y takes a float64 host
    SpMM (``SPMM_BLOCK_NNZ`` nonzeros a block) and a dense one a row-batched
    accumulation on ``device`` (``batch_size`` rows a batch), so that only a
    (batch × G) tile is on the card at a time. With ``normalize_y``, Y's
    columns are z-scored (variance floored at 1e-12, reference
    cnmf.py:89-95), folded into the products; a host Y's moments come from
    ``ops.stats.mean_var``."""
    n = U.shape[0]
    if Y.shape[0] != n:
        raise ValueError("U and Y must have the same number of rows.")
    on_device = isinstance(Y, (torch.Tensor, Shards))
    if on_device:
        device, tdtype = Y.device, Y.dtype
    else:
        if device is None or dtype is None:
            raise ValueError("a host Y needs device= and dtype=")
        tdtype = torch_dtype(dtype)
    np_dtype = numpy_dtype(tdtype)
    U = np.ascontiguousarray(U, dtype=np_dtype)
    XtX = (U.T @ U).astype(np.float64)

    if normalize_y:
        if on_device:
            mean_y, var_y = column_moments(Y)
        else:
            mean_y, var_y = mean_var(Y)
        var_y = np.maximum(var_y, 1e-12)

    if sp.issparse(Y):
        # float64 throughout: the (Uᵀ1)·mean correction cancels, so it must
        # not take a compute-dtype rounding of the mean
        U64 = U.astype(np.float64)
        XtY = _sparse_xty(U64, Y)
        if normalize_y:
            XtY = ((XtY - U64.sum(axis=0)[:, None] * mean_y[None, :])
                   * (1.0 / np.sqrt(var_y))[None, :])
    else:
        Ud = (shard_like(U, Y) if isinstance(Y, Shards)
              else torch.as_tensor(U, device=device))
        if normalize_y:
            mean_d = torch.as_tensor(mean_y, device=device).to(tdtype)
            inv_d = torch.as_tensor(1.0 / np.sqrt(var_y),
                                    device=device).to(tdtype)

        def product(Ub, Yb):
            if normalize_y:
                return _xty_zscored(Ub, Yb, mean_d, inv_d)
            if isinstance(Yb, Shards):
                return sum_shards([u.T @ y for u, y in zip(Ub.parts, Yb.parts)])
            return Ub.T @ Yb

        if on_device:
            XtY = product(Ud, Y)
        else:
            XtY = torch.zeros((U.shape[1], Y.shape[1]), dtype=tdtype,
                              device=device)
            for start in range(0, n, batch_size):
                Yb = np.ascontiguousarray(Y[start:start + batch_size],
                                          dtype=np_dtype)
                XtY += product(Ud[start:start + batch_size],
                               torch.as_tensor(Yb, device=device))
        XtY = XtY.cpu().numpy().astype(np.float64)
    beta, *_ = np.linalg.lstsq(XtX, XtY, rcond=None)
    return beta
