"""Per-gene statistics and high-variance gene (HVG) selection.

Implements the reference's Fano-factor overdispersion selection
(reference cnmf.py:136-242, both the sparse and dense twins share this single
code path) on plain mean/variance vectors, plus mean/var reductions for
dense and sparse host matrices (the sparse moments by the native library,
``cnmf_tpu_torch.native``, where it loads). Same math as
``cnmf_tpu.ops.stats``; the statistics come back as a dict of arrays (the
pipeline builds any frame).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from cnmf_tpu_torch.native import csr_col_moments
from cnmf_tpu_torch.parallel.collectives import sum_shards
from cnmf_tpu_torch.parallel.mesh import Shards


def mean_var(X, ddof: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-column mean and variance, zeros included (StandardScaler semantics,
    reference cnmf.py:131-134)."""
    n = X.shape[0]
    if sp.issparse(X):
        # one pass over the nonzeros — X.multiply(X) would allocate a full
        # transient copy of the matrix
        Xc = X.tocsr() if not (sp.isspmatrix_csr(X) or sp.isspmatrix_csc(X)) else X
        # threaded C++ where the native library loads (None: numpy below)
        moments = csr_col_moments(Xc)
        if moments is not None:
            mean, sq = moments[0] / n, moments[1] / n
        else:
            if sp.isspmatrix_csr(Xc):
                cols = Xc.indices
            else:
                cols = np.repeat(np.arange(Xc.shape[1]), np.diff(Xc.indptr))
            g = X.shape[1]
            mean = np.bincount(cols, weights=Xc.data, minlength=g) / n
            sq = np.bincount(cols, weights=np.square(Xc.data), minlength=g) / n
        var = sq - mean**2
    else:
        # two-pass (no sq−mean² cancellation), accumulated over COLUMN
        # blocks so the centered temporary stays ~32 MB instead of a full
        # copy of the matrix
        X = np.asarray(X)
        mean = X.mean(axis=0, dtype=np.float64)
        g = X.shape[1]
        block = max(1, int(4e6) // max(n, 1))
        var = np.empty(g, dtype=np.float64)
        for j0 in range(0, g, block):
            blk = X[:, j0:j0 + block].astype(np.float64, copy=False)
            d = blk - mean[j0:j0 + block]
            var[j0:j0 + block] = np.einsum("ij,ij->j", d, d) / n
    if ddof:
        var = var * n / (n - ddof)
    return mean.astype(np.float64), var.astype(np.float64)


def column_moments(Y) -> Tuple[np.ndarray, np.ndarray]:
    """Per-column mean and variance (ddof 0) of a tensor on its device, as
    host float64 arrays, by the two-pass form E[(Y-mean)²]: the one-pass
    E[Y²]-mean² cancels badly in f32 for high-mean, low-variance columns.
    Column chunks bound the centered temporary at ~800 MB. Y may be row
    ``Shards``: each pass sums the shards' real rows in shard order and
    divides by the real row count."""
    parts = Y.parts if isinstance(Y, Shards) else [Y]
    reals = ([Y.real_rows(i) for i in range(len(parts))]
             if isinstance(Y, Shards) else [Y.shape[0]])
    n = Y.shape[0]
    gchunk = max(1, int(8e8 // max(parts[0].shape[0] * Y.element_size(), 1)))
    means, variances = [], []
    for s in range(0, Y.shape[1], gchunk):
        blocks = [p[:r, s:s + gchunk] for p, r in zip(parts, reals)]
        m = sum_shards([torch.sum(b, dim=0) for b in blocks]) / n
        means.append(m)
        variances.append(sum_shards([
            torch.sum((b - m.to(b.device)[None, :]) ** 2, dim=0)
            for b in blocks]) / n)
    return (torch.cat(means).cpu().numpy().astype(np.float64),
            torch.cat(variances).cpu().numpy().astype(np.float64))


# Overdispersion baseline model (selection contract set by reference
# cnmf.py:136-242; restated): for Poisson sampling the Fano factor var/mean
# is 1, and multiplicative technical scaling inflates it to roughly
# A²·mean + B² — the A² term calibrated from the most highly expressed genes
# (where sampling noise is negligible and sqrt(var)/mean ≈ the technical
# coefficient of variation) and B² from the median Fano of "ordinary" genes.
# Genes are ranked by observed/expected Fano.
_N_CALIBRATION_GENES = 20        # top-mean genes that set A
_WINSOR_QUANTILES = (0.10, 0.90)  # mean/fano box that sets B


def fano_hvg_stats(
    gene_mean: np.ndarray,
    gene_var: np.ndarray,
    expected_fano_threshold: Optional[float] = None,
    minimal_mean: float = 0.5,
    numgenes: Optional[int] = None,
) -> Tuple[dict, dict]:
    """Fano-factor HVG selection given per-gene mean/var of the TPM matrix.

    With ``numgenes`` set, the ``numgenes`` genes with the largest
    observed/expected Fano ratio are selected; otherwise a ratio threshold
    ``T`` (given, or 1 + the winsor-box Fano std) combined with a minimum
    mean applies. Selection semantics match reference cnmf.py:136-188: NaN
    ratios (zero-mean genes) rank last and never pass the threshold, and
    quantiles/medians ignore NaN Fano values.
    """
    mean = np.asarray(gene_mean, dtype=np.float64)
    var = np.asarray(gene_var, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        fano = var / mean  # 0/0 → NaN, x/0 → inf, like the pandas original

    # A: cleanest coefficient of variation among the top-expressed genes
    calib = np.argsort(-mean, kind="stable")[:_N_CALIBRATION_GENES]
    A = float(np.min(np.sqrt(var[calib]) / mean[calib]))

    # B: median Fano inside the winsor box (both stats strictly within
    # their 10-90% quantiles; NaN Fano genes drop out of every comparison)
    mean_lo, mean_hi = np.quantile(mean, _WINSOR_QUANTILES)
    fano_lo, fano_hi = np.nanquantile(fano, _WINSOR_QUANTILES)
    in_box = (fano > fano_lo) & (fano < fano_hi) & (mean > mean_lo) & (mean < mean_hi)
    B = float(np.sqrt(np.median(fano[in_box])))

    expected_fano = A * A * mean + B * B
    with np.errstate(invalid="ignore"):
        fano_ratio = fano / expected_fano

    n_genes = mean.size
    if numgenes is not None:
        # descending ratio; numpy sorts NaN last, matching pandas
        ranked = np.argsort(-fano_ratio, kind="stable")
        high_var = np.zeros(n_genes, dtype=bool)
        high_var[ranked[:numgenes]] = True
        T = None
    else:
        # `or`-style falsy check kept from the reference: threshold 0 means
        # "derive from the box", not "select everything"
        T = (expected_fano_threshold
             or 1.0 + float(np.std(fano[in_box], ddof=1)))
        with np.errstate(invalid="ignore"):
            high_var = (fano_ratio > T) & (mean > minimal_mean)

    gene_counts_stats = {
        "mean": mean,
        "var": var,
        "fano": fano,
        "expected_fano": expected_fano,
        "high_var": high_var,
        "fano_ratio": fano_ratio,
    }
    fit_params = {"A": A, "B": B, "T": T, "minimal_mean": minimal_mean}
    return gene_counts_stats, fit_params


def get_highvar_genes(tpm_X, numgenes: Optional[int] = None,
                      expected_fano_threshold: Optional[float] = None,
                      minimal_mean: float = 0.5):
    """HVG selection from a TPM matrix (sparse or dense)."""
    mean, var = mean_var(tpm_X, ddof=0)
    return fano_hvg_stats(
        mean, var,
        expected_fano_threshold=expected_fano_threshold,
        minimal_mean=minimal_mean,
        numgenes=numgenes,
    )
