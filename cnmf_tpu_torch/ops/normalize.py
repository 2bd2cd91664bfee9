"""Row/column normalization on the host (numpy/scipy, sparse-aware).

TPM (per-cell library-size) normalization and unit-variance gene scaling,
the same functions as ``cnmf_tpu.ops.normalize`` (which replace the
reference's ``sc.pp.normalize_total`` and ``sc.pp.scale(zero_center=False)``).
Under ``CNMF_TPU_HOST_ARENA=1`` a dense TPM lands in a reused host buffer
(``utils.arena``), so that a second prepare's large passes write warm
pages; ``scale_unit_variance(inplace=True)`` divides into its input. The
values are those of a fresh allocation. ``csr_column_subset`` (the HVG column gather on sparse
counts) lives here rather than in ``io/anndata_lite.py`` so that the stages
need no pandas.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from cnmf_tpu_torch import native
from cnmf_tpu_torch.utils.arena import host_arena


def normalize_total(X, target_sum: float = 1e6):
    """Scale each row (cell) to sum to ``target_sum``. Returns a new matrix.

    Float inputs keep their dtype (scanpy ``pp.normalize_total`` semantics:
    an f32 counts matrix yields an f32 TPM); integer counts widen to f64.
    Dtype preservation matters at atlas scale — upcasting a 242M-nnz TPM
    to f64 costs a 1.9 GB cast and doubles the h5ad bytes on a ~40 MB/s
    sustained disk."""
    if sp.issparse(X):
        totals = np.asarray(X.sum(axis=1)).ravel().astype(np.float64)
        scale = np.divide(
            target_sum, totals, out=np.zeros_like(totals, dtype=np.float64),
            where=totals != 0,
        )
        out_dtype = X.dtype if X.dtype.kind == "f" else np.float64
        # scale CSR rows in place on a fresh DATA array — only data mutates,
        # so the output can share the source's indices/indptr instead of
        # duplicating ~1 GB of index structure at atlas scale (a
        # diag @ X spgemm is ~100x slower still at 1e8 nnz). Sharing is
        # only safe when neither side can later canonicalize in place
        # (sort_indices/sum_duplicates reorder indices against the OTHER
        # matrix's data) — so share exactly when the source is already
        # canonical, making those calls no-ops on both.
        Xc = X.tocsr()
        if Xc.has_canonical_format:
            out = sp.csr_matrix(
                (Xc.data.astype(out_dtype), Xc.indices, Xc.indptr),
                shape=Xc.shape, copy=False,
            )
            out.has_canonical_format = True
        else:
            out = sp.csr_matrix(
                (Xc.data.astype(out_dtype), Xc.indices.copy(),
                 Xc.indptr.copy()),
                shape=Xc.shape, copy=False,
            )
        scale = scale.astype(out_dtype)
        try:
            from scipy.sparse import _sparsetools
            _sparsetools.csr_scale_rows(
                out.shape[0], out.shape[1], out.indptr, out.indices,
                out.data, scale,
            )
        except (ImportError, AttributeError):
            out.data *= np.repeat(scale, np.diff(out.indptr))
        return out
    X = np.asarray(X)
    out_dtype = X.dtype if X.dtype.kind == "f" else np.float64
    totals = X.sum(axis=1, keepdims=True, dtype=np.float64)
    safe = np.where(totals == 0, 1.0, totals)
    # ONE fused cast+scale pass: the ufunc casts integer input blocks on
    # the fly, so only the output is allocated (an arena buffer).
    # Values are bit-identical to cast-then-multiply.
    out = host_arena.take(X.shape, out_dtype)
    return np.multiply(X, (target_sum / safe).astype(np.float64),
                       dtype=out_dtype, out=out)


def scale_unit_variance(X, ddof: int = 1, zero_safe: bool = True,
                        inplace: bool = False):
    """Divide each column by its std (no centering).

    ``zero_safe`` maps std==0 → 1 (scanpy pp.scale semantics used on the
    reference's sparse path, cnmf.py:538); the dense reference path divides
    unguarded (cnmf.py:542) — pass zero_safe=False to reproduce it.
    ``inplace`` (dense float input only): divide into X itself instead of a
    new quotient (prepare hands it an arena buffer); the same bits.
    """
    if sp.issparse(X):
        n = X.shape[0]
        mean = np.asarray(X.mean(axis=0)).ravel()
        sq = np.asarray(X.multiply(X).mean(axis=0)).ravel()
        var = (sq - mean**2) * n / max(n - ddof, 1)
        std = np.sqrt(var)
        if zero_safe:
            std[std == 0] = 1.0
        inv = (np.divide(1.0, std, out=np.zeros_like(std), where=std != 0)
               if not zero_safe else 1.0 / std)
        # scale CSR columns in place on a copy (see normalize_total: the
        # X @ diag spgemm is the slow general path)
        out = X.tocsr().astype(np.result_type(X.dtype, inv.dtype))
        if out is X:
            out = out.copy()
        try:
            from scipy.sparse import _sparsetools
            _sparsetools.csr_scale_columns(
                out.shape[0], out.shape[1], out.indptr, out.indices,
                out.data, inv,
            )
        except (ImportError, AttributeError):
            out.data *= inv[out.indices]
        return out
    X = np.asarray(X)
    std = X.std(axis=0, ddof=ddof)
    if zero_safe:
        std = np.where(std == 0, 1.0, std)
    if inplace and X.dtype.kind == "f":
        return np.divide(X, std, out=X)
    return X / std


def csr_column_subset(X: sp.csr_matrix, cols: np.ndarray) -> sp.csr_matrix:
    """Column-subset of a CSR matrix in one O(nnz) pass.

    ``scipy``'s ``X[:, cols]`` on CSR routes through ``tocsc`` — two full
    conversions with sorts (measured 22-31 s on a 242M-nnz atlas TPM, vs
    ~2 s here). Strategy: map every stored column index through a
    gather table (-1 = dropped), mask, and rebuild the indptr as the
    running count of survivors sampled at the old row boundaries.

    ``cols`` must be duplicate-free integer positions; output column ``j``
    is input column ``cols[j]`` (any order)."""
    cols = np.asarray(cols)
    lookup = np.full(X.shape[1], -1, dtype=np.int32)
    lookup[cols] = np.arange(len(cols), dtype=np.int32)
    native_out = native.csr_col_subset(X, lookup)
    if native_out is not None:
        # two streaming C passes with exact-size outputs (the native library)
        data, indices, indptr = native_out
    else:
        new_cols = lookup[X.indices]
        mask = new_cols >= 0
        # per-ROW survivor counts, then a cumsum over n_rows — NOT over nnz.
        # reduceat runs over the NONEMPTY rows' start offsets only: those
        # are strictly increasing and all < nnz, so every segment covers
        # exactly one row — clamping empty-row starts instead would steal
        # elements from the preceding row's segment.
        n_rows = X.shape[0]
        counts = np.zeros(n_rows, dtype=np.int64)
        nonempty = np.diff(X.indptr) > 0
        if mask.size and nonempty.any():
            counts[nonempty] = np.add.reduceat(
                mask, X.indptr[:-1][nonempty], dtype=np.int64
            )
        indptr = np.concatenate(
            [np.zeros(1, dtype=np.int64), np.cumsum(counts, dtype=np.int64)]
        )
        data, indices = X.data[mask], new_cols[mask]
    out = sp.csr_matrix(
        (data, indices, indptr),
        shape=(X.shape[0], len(cols)),
    )
    if np.any(np.diff(cols) < 0):
        # reordered columns break within-row index sortedness
        out.sort_indices()
    else:
        out.has_sorted_indices = X.has_sorted_indices
    return out
