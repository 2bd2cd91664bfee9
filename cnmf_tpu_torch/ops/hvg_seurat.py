"""seurat_v3 highly-variable-gene selection (variance-stabilizing transform).

Replaces ``sc.pp.highly_variable_genes(flavor='seurat_v3')`` (reference
preprocess.py:314-315), which scanpy implements on top of scikit-misc's loess.
Algorithm (Stuart et al. 2019): fit a loess of log10(var) on log10(mean) over
genes, standardize counts by the fitted std with clipping at sqrt(N), rank by
the clipped standardized variance.

The loess here is a direct local-quadratic regression with tricube weights
(span 0.3), vectorized over gene chunks; the clipped-variance pass is one
numpy pass, dense or over the nonzeros of a sparse matrix. The same host code
as ``cnmf_tpu.ops.hvg_seurat``: both packages pick the same genes.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def loess_fit(x: np.ndarray, y: np.ndarray, span: float = 0.3, degree: int = 2,
              chunk: int = 512) -> np.ndarray:
    """Local polynomial regression ŷ(x) with tricube weights.

    For each point, the ``floor(span·n)`` nearest neighbors in x get tricube
    weights and a degree-``degree`` weighted polynomial is fit. O(n·q) with
    q = span·n, vectorized over chunks.
    """
    n = len(x)
    q = max(int(np.floor(span * n)), degree + 1)
    order = np.argsort(x, kind="stable")
    xs, ys = x[order], y[order]

    fitted_sorted = np.empty(n)
    # neighbor windows: for sorted x, the q nearest neighbors form a
    # contiguous window; slide it per point
    lefts = np.clip(np.searchsorted(xs, xs) - q // 2, 0, n - q)
    # refine: shift window to truly minimize max distance
    for i in range(n):
        lo = lefts[i]
        while lo > 0 and xs[i] - xs[lo - 1] < xs[lo + q - 1] - xs[i]:
            lo -= 1
        while lo + q < n and xs[lo + q] - xs[i] < xs[i] - xs[lo]:
            lo += 1
        lefts[i] = lo

    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        m = end - start
        idx = lefts[start:end, None] + np.arange(q)[None, :]  # (m, q)
        xw = xs[idx]
        yw = ys[idx]
        xi = xs[start:end, None]
        d = np.abs(xw - xi)
        dmax = d.max(axis=1, keepdims=True)
        dmax[dmax == 0] = 1.0
        w = (1 - (d / dmax) ** 3) ** 3
        w = np.maximum(w, 0)

        # weighted polynomial design: [1, (x-xi), (x-xi)^2]
        t = xw - xi
        cols = [np.ones_like(t)]
        for p in range(1, degree + 1):
            cols.append(t**p)
        A = np.stack(cols, axis=2)  # (m, q, deg+1)
        Aw = A * w[:, :, None]
        # normal equations per point: (deg+1 x deg+1)
        G = np.einsum("mqi,mqj->mij", Aw, A)
        b = np.einsum("mqi,mq->mi", Aw, yw)
        # solve; ŷ at xi is the intercept coefficient
        try:
            coef = np.linalg.solve(G, b[..., None])[..., 0]
        except np.linalg.LinAlgError:
            coef = np.stack([np.linalg.lstsq(G[j], b[j], rcond=None)[0] for j in range(m)])
        fitted_sorted[start:end] = coef[:, 0]

    fitted = np.empty(n)
    fitted[order] = fitted_sorted
    return fitted


def highly_variable_genes_seurat_v3(
    X, n_top_genes: int = 2000, span: float = 0.3,
) -> "tuple[np.ndarray, np.ndarray]":
    """Returns (highly_variable bool mask, normalized variance per gene).

    X: raw counts, cells × genes (sparse or dense).
    """
    N = X.shape[0]
    if sp.issparse(X):
        mean = np.asarray(X.mean(axis=0)).ravel()
        sq = np.asarray(X.multiply(X).mean(axis=0)).ravel()
        var = (sq - mean**2) * N / (N - 1)
    else:
        Xd = np.asarray(X)
        mean = Xd.mean(axis=0)
        var = Xd.var(axis=0, ddof=1)

    not_const = var > 0
    estimat_var = np.zeros(X.shape[1])
    x = np.log10(mean[not_const])
    y = np.log10(var[not_const])
    estimat_var[not_const] = loess_fit(x, y, span=span, degree=2)
    reg_std = np.sqrt(10**estimat_var)

    vmax = np.sqrt(N)
    clip_val = mean + vmax * reg_std

    if sp.issparse(X):
        # one vectorized pass over the nonzeros: clip each value at its
        # gene's ceiling, then segment-sum per gene via reduceat
        Xc = X.tocsc()
        gene_of_nz = np.repeat(
            np.arange(X.shape[1]), np.diff(Xc.indptr)
        )
        clipped = np.minimum(Xc.data, clip_val[gene_of_nz])
        squared_sum = np.bincount(gene_of_nz, weights=clipped**2,
                                  minlength=X.shape[1])
        clipped_sum = np.bincount(gene_of_nz, weights=clipped,
                                  minlength=X.shape[1])
    else:
        clipped = np.minimum(np.asarray(X), clip_val[None, :])
        squared_sum = (clipped**2).sum(axis=0)
        clipped_sum = clipped.sum(axis=0)

    norm_gene_var = np.zeros(X.shape[1])
    denom = (N - 1) * np.square(reg_std)
    ok = not_const & (denom > 0)
    norm_gene_var[ok] = (1.0 / denom[ok]) * (
        N * np.square(mean[ok]) + squared_sum[ok] - 2.0 * clipped_sum[ok] * mean[ok]
    )

    # rank descending; scanpy ties: ranked by value then original order
    ranked = np.argsort(-norm_gene_var, kind="stable")
    mask = np.zeros(X.shape[1], dtype=bool)
    mask[ranked[:n_top_genes]] = True
    return mask, norm_gene_var
