"""cNMF's prepare, plainly, in numpy: counts per million (TPM), the Fano
highly-variable genes (cNMF's ``get_highvar_genes`` with a gene count) and
the HVG counts scaled to unit variance without centering.

``dtype`` is the precision every step computes in: float64 as the
configurations state, float32 for the control.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def tpm(counts, dtype=np.float64):
    """Each cell's counts scaled to sum to 1e6 (cells with no counts stay
    0), dense or CSR like the counts."""
    if sp.issparse(counts):
        X = sp.csr_matrix(counts, dtype=dtype, copy=True)
        totals = np.asarray(X.sum(axis=1), dtype=dtype).ravel()
        scale = np.where(totals == 0, 0, dtype(1e6) / np.where(totals == 0, 1,
                                                                 totals))
        X.data *= np.repeat(scale.astype(dtype), np.diff(X.indptr))
        return X
    X = np.asarray(counts, dtype=dtype)
    totals = X.sum(axis=1, keepdims=True)
    return X * (dtype(1e6) / np.where(totals == 0, 1, totals))


def moments(X, dtype=np.float64):
    """Per-gene mean and variance (ddof 0) of the cells."""
    n = X.shape[0]
    if sp.issparse(X):
        X = sp.csr_matrix(X)
        mean = np.bincount(X.indices, weights=X.data.astype(np.float64),
                           minlength=X.shape[1]) / n
        sq = np.bincount(X.indices, weights=X.data.astype(np.float64) ** 2,
                         minlength=X.shape[1]) / n
        return mean.astype(dtype), (sq - mean ** 2).astype(dtype)
    X = np.asarray(X, dtype=dtype)
    mean = X.mean(axis=0)
    return mean, ((X - mean) ** 2).mean(axis=0)


def fano_hvgs(mean, var, n_genes: int) -> np.ndarray:
    """Positions (ascending) of the ``n_genes`` genes whose Fano factor most
    exceeds the one expected from their mean: expected = A^2 * mean + B^2,
    A the least coefficient of variation among the 20 genes of highest
    mean, B^2 the median Fano factor of the genes whose mean and Fano factor
    both lie strictly inside their 10 % - 90 % quantiles; genes of zero
    mean (no Fano factor) rank last."""
    mean = np.asarray(mean, dtype=np.float64)
    var = np.asarray(var, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        fano = var / mean
    top = np.argsort(-mean, kind="stable")[:20]
    A = np.min(np.sqrt(var[top]) / mean[top])
    m_lo, m_hi = np.quantile(mean, (0.10, 0.90))
    f_lo, f_hi = np.nanquantile(fano, (0.10, 0.90))
    box = (fano > f_lo) & (fano < f_hi) & (mean > m_lo) & (mean < m_hi)
    B2 = np.median(fano[box])
    with np.errstate(invalid="ignore"):
        ratio = fano / (A * A * mean + B2)
    chosen = np.argsort(-ratio, kind="stable")[:n_genes]
    return np.sort(chosen)


def normalized(counts, hvgs, dtype=np.float64):
    """The HVG columns of the counts divided by their standard deviation
    over cells (ddof 1), no centering; a sparse matrix's zero-variance
    genes keep their values (scanpy's scale), a dense one's are divided
    as they are."""
    if sp.issparse(counts):
        sub = sp.csr_matrix(counts)[:, hvgs].astype(dtype)
        n = sub.shape[0]
        mean = np.asarray(sub.mean(axis=0), dtype=np.float64).ravel()
        sq = np.asarray(sub.multiply(sub).mean(axis=0),
                        dtype=np.float64).ravel()
        std = np.sqrt((sq - mean ** 2) * n / (n - 1))
        std[std == 0] = 1.0
        out = sp.csr_matrix(sub, copy=True)
        out.data /= std.astype(dtype)[out.indices]
        return out
    sub = np.asarray(counts)[:, hvgs].astype(dtype)
    return sub / sub.std(axis=0, ddof=1)


def prepare(counts, n_genes: int, dtype=np.float64):
    """(TPM, its per-gene std (ddof 0), HVG positions, normalized HVG
    counts)."""
    T = tpm(counts, dtype)
    mean, var = moments(T, dtype)
    hvgs = fano_hvgs(mean, var, n_genes)
    return T, np.sqrt(var), hvgs, normalized(counts, hvgs, dtype)
