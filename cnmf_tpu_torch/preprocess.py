"""Preprocessing / batch-correction layer (reference preprocess.py:41-473).

The ``Preprocess`` of ``cnmf_tpu.preprocess``, in PyTorch: cell/gene
filtering, library-size normalization, seurat_v3 HVG selection,
quantile-ceiling variance scaling, PCA, Harmony batch correction applied to
the expression matrix (via ``cnmf_tpu_torch.harmony``), CITE-seq RNA/ADT
splitting + re-stacking, and mutual-information ADT feature selection.
Outputs feed back into ``cNMF.prepare`` as (counts, tpm, genes_file).

Filtering, normalization, HVG selection and scaling run on the host, as in
the JAX package; PCA, Harmony and the MOE ridge on X run on the object's
``device`` (the CUDA card unless the CPU is asked for). ``Preprocess.timings``
holds the last call's stage walls, synchronized with the device.
"""

from __future__ import annotations

from collections.abc import Collection
import time
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd
import scipy.sparse as sp
import torch

from cnmf_tpu_torch import harmony as harmony_mod
from cnmf_tpu_torch.io.anndata_lite import AnnData
from cnmf_tpu_torch.io.tenx import _make_index_unique
from cnmf_tpu_torch.ops.hvg_seurat import highly_variable_genes_seurat_v3
from cnmf_tpu_torch.ops.normalize import normalize_total, scale_unit_variance
from cnmf_tpu_torch.ops.pca import pca as run_pca


def _quantile_with_zeros(data: np.ndarray, n_zeros: int, q: float) -> float:
    """``np.quantile`` (linear interpolation) of the virtual array formed by
    ``data`` plus ``n_zeros`` implicit zeros, WITHOUT materializing it — the
    sparse global-quantile a dense ``X.todense().reshape(-1)`` would compute
    (at 100k×2000 that densify is ~1 GB for two order statistics)."""
    total = data.size + n_zeros
    if total == 0:
        return float("nan")
    h = q * (total - 1)
    lo_rank, hi_rank = int(np.floor(h)), int(np.ceil(h))
    n_neg = int((data < 0).sum())

    def data_rank(rank):
        # merged order: sorted negatives | zeros | sorted non-negatives;
        # None = inside the zero block
        if rank < n_neg:
            return rank
        if rank < n_neg + n_zeros:
            return None
        return rank - n_zeros

    r_lo, r_hi = data_rank(lo_rank), data_rank(hi_rank)
    ks = sorted({r for r in (r_lo, r_hi) if r is not None})
    part = np.partition(data, ks) if ks else None
    # selection is exact at any dtype; only the two selected scalars (and
    # the interpolation) promote to f64
    v_lo = 0.0 if r_lo is None else float(part[r_lo])
    if hi_rank == lo_rank:
        return v_lo
    v_hi = 0.0 if r_hi is None else float(part[r_hi])
    return v_lo + (h - lo_rank) * (v_hi - v_lo)


def stdscale_quantile_celing(adata: AnnData, max_value=None, quantile_thresh=None):
    """Unit-variance scale (no centering) then clamp values above the global
    quantile (reference preprocess.py:21-29). Mutates adata.X."""
    X = scale_unit_variance(adata.X, ddof=1, zero_safe=True)
    if max_value is not None:
        if sp.issparse(X):
            X.data = np.minimum(X.data, max_value)
        else:
            X = np.minimum(X, max_value)
    if quantile_thresh is not None:
        if sp.issparse(X):
            threshval = _quantile_with_zeros(
                np.asarray(X.data),
                X.shape[0] * X.shape[1] - X.data.size,
                quantile_thresh,
            )
            if threshval < 0:
                # the ceiling must also pull implicit zeros down — only
                # reachable with negative stored values (never from scaled
                # counts); match the dense branch exactly
                X = np.minimum(np.asarray(X.todense()), threshval)
            else:
                X.data[X.data > threshval] = threshval
        else:
            threshval = np.quantile(np.asarray(X).reshape(-1), quantile_thresh)
            X = np.minimum(X, threshval)
    adata.X = X
    return adata


def make_count_hist(adata: AnnData, num_cells: int = 1000):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    z = adata.X[:num_cells, :]
    if sp.issparse(z):
        z = z.todense()
    y = np.asarray(z).reshape(-1)
    fig, ax = plt.subplots()
    ax.hist(y[y > 0], bins=100)
    ax.set_title("Quantile thresholded normalized count distribution")
    return fig


class Preprocess:
    """Preprocessing pipeline for cNMF inputs, with optional Harmony batch
    correction of the counts themselves (reference preprocess.py:41-58).

    device: where PCA, Harmony and the MOE ridge run (default "cuda"; no
    fallback: without a CUDA device they raise unless ``device="cpu"``).
    After a call, ``timings`` holds its stage walls in seconds (hvg,
    scaling, pca, harmony, moe_x), ``pca_embedding`` the PCs Harmony was
    fed and ``harmony_result`` the converged Harmony state."""

    def __init__(self, random_seed: Optional[int] = None, *, device="cuda"):
        self.random_seed = random_seed
        self.device = torch.device(device)
        self.timings = {}
        self.pca_embedding = None
        self.harmony_result = None
        np.random.seed(random_seed)

    def _timed(self, stage: str, t0: float):
        """Record the wall since ``t0`` under ``stage``, after the device's
        queued work is done."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[stage] = time.perf_counter() - t0

    # ------------------------------------------------------------------
    def filter_adata(
        self,
        _adata: AnnData,
        filter_mito_thresh: Optional[float] = None,
        min_cells_per_gene: Optional[int] = 10,
        min_counts_per_cell: Optional[int] = 500,
        filter_mito_genes: bool = False,
        filter_dot_genes: bool = True,
        makeplots: bool = False,
    ) -> AnnData:
        """Gene/cell filters + optional mito-fraction filter
        (reference preprocess.py:60-132)."""
        if min_cells_per_gene is not None:
            detected = np.asarray((_adata.X > 0).sum(axis=0)).ravel()
            _adata = _adata[:, detected >= min_cells_per_gene]

        _adata.obs = _adata.obs.copy()
        _adata.obs["n_counts"] = np.asarray(_adata.X.sum(axis=1)).squeeze()

        if makeplots:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots()
            ax.hist(np.log10(np.maximum(_adata.obs["n_counts"].values, 1)), bins=100)
            ax.set_title("log10 n_counts")
            ylim = ax.get_ylim()
            if min_cells_per_gene:
                ax.vlines(x=np.log10(min_cells_per_gene), ymin=ylim[0], ymax=ylim[1])
            ax.set_ylim(ylim)

        if min_counts_per_cell is not None:
            _adata = _adata[np.asarray(_adata.obs["n_counts"] >= min_counts_per_cell), :]

        mt_genes = [x for x in _adata.var.index if "MT-" in x]
        if filter_mito_thresh is not None:
            num_mito = np.asarray(_adata[:, mt_genes].X.sum(axis=1)).squeeze() \
                if mt_genes else np.zeros(_adata.n_obs)
            pct_mito = num_mito / _adata.obs["n_counts"].values
            _adata.obs["pct_mito"] = pct_mito
            if makeplots:
                import matplotlib.pyplot as plt

                fig, ax = plt.subplots()
                ax.hist(pct_mito, bins=100)
                ax.set_title("pct_mito")
            _adata = _adata[np.asarray(pct_mito < filter_mito_thresh), :]

        tofilter: List[str] = []
        if filter_dot_genes:
            tofilter = [x for x in _adata.var.index if "." in x]
        if filter_mito_genes:
            tofilter += mt_genes
        ind = ~_adata.var.index.isin(tofilter)
        _adata = _adata[:, np.asarray(ind)]
        return _adata

    # ------------------------------------------------------------------
    def preprocess_for_cnmf(
        self,
        _adata,
        feature_type_col: Optional[str] = None,
        adt_feature_name: str = "Antibody Capture",
        harmony_vars=None,
        n_top_rna_genes: int = 2000,
        librarysize_targetsum: float = 1e4,
        max_scaled_thresh: Optional[float] = None,
        quantile_thresh: float = 0.9999,
        makeplots: bool = False,
        theta: float = 1,
        save_output_base: Optional[str] = None,
        max_iter_harmony: int = 20,
        exclude_genes=None,
    ) -> Tuple[AnnData, AnnData, List[str]]:
        """HVG-filtered, normalized, optionally batch-corrected counts (for
        cNMF input) + library-size tp10k (RNA ⊕ ADT) + the HVG list
        (reference preprocess.py:135-267)."""
        if (not isinstance(_adata, Collection)) and (feature_type_col is not None):
            is_adt = np.asarray(_adata.var[feature_type_col] == adt_feature_name)
            adata_ADT = _adata[:, is_adt]
            adata_RNA = _adata[:, ~is_adt]
        elif not isinstance(_adata, Collection):
            adata_RNA = _adata
            adata_RNA.var = adata_RNA.var.copy()
            adata_RNA.var.index = _make_index_unique(adata_RNA.var.index)
            adata_RNA.var["features_renamed"] = adata_RNA.var.index
            adata_ADT = None
        elif len(_adata) == 2:
            adata_RNA, adata_ADT = _adata[0], _adata[1]
            if adata_ADT.shape[0] != adata_RNA.shape[0]:
                raise Exception("ADT and RNA AnnDatas don't have the same number of cells")
            elif np.sum(adata_ADT.obs.index != adata_RNA.obs.index) > 0:
                raise Exception("Inconsistency of the index for the ADT and RNA AnnDatas")
        else:
            raise Exception(
                "data should either be an AnnData object or a list of 2 AnnData objects"
            )

        tp10k = AnnData(
            normalize_total(adata_RNA.X, target_sum=librarysize_targetsum),
            obs=adata_RNA.obs.copy(), var=adata_RNA.var.copy(),
        )

        if exclude_genes is not None:
            exclude_mask = adata_RNA.var_names.isin(exclude_genes)
            n_excluded = int(exclude_mask.sum())
            if n_excluded > 0:
                print(f"Excluding {n_excluded} genes from cNMF input (retained in tp10k):")
                print(list(adata_RNA.var_names[exclude_mask]))
                adata_RNA = adata_RNA[:, ~np.asarray(exclude_mask)]
            else:
                print("exclude_genes provided but none found in adata_RNA.var_names.")

        adata_RNA, hvgs = self.normalize_batchcorrect(
            adata_RNA, harmony_vars=harmony_vars, n_top_genes=n_top_rna_genes,
            librarysize_targetsum=librarysize_targetsum,
            max_scaled_thresh=max_scaled_thresh, quantile_thresh=quantile_thresh,
            theta=theta, makeplots=makeplots, max_iter_harmony=max_iter_harmony,
        )

        if adata_ADT is not None:
            adata_ADT = adata_ADT[adata_RNA.obs.index, :] \
                if not adata_ADT.obs.index.equals(adata_RNA.obs.index) else adata_ADT
            adt_norm = normalize_total(adata_ADT.X, target_sum=librarysize_targetsum)
            merge_var = pd.concat([tp10k.var, adata_ADT.var], axis=0)
            if sp.issparse(tp10k.X) or sp.issparse(adt_norm):
                merged_X = sp.hstack(
                    [sp.csr_matrix(tp10k.X), sp.csr_matrix(adt_norm)]
                ).tocsr()
            else:
                merged_X = np.hstack([tp10k.X, adt_norm])
            tp10k = AnnData(merged_X, obs=tp10k.obs, var=merge_var)

        if save_output_base is not None:
            from cnmf_tpu_torch.io.h5ad import write_h5ad

            write_h5ad(save_output_base + ".Corrected.HVG.Varnorm.h5ad", adata_RNA)
            write_h5ad(save_output_base + ".TP10K.h5ad", tp10k)
            with open(save_output_base + ".Corrected.HVGs.txt", "w") as F:
                F.write("\n".join(hvgs))

        return adata_RNA, tp10k, hvgs

    # ------------------------------------------------------------------
    def normalize_batchcorrect(
        self,
        _adata: AnnData,
        normalize_librarysize: bool = False,
        harmony_vars=None,
        n_top_genes: Optional[int] = None,
        librarysize_targetsum: float = 1e4,
        max_scaled_thresh: Optional[float] = None,
        quantile_thresh: float = 0.9999,
        theta: float = 1,
        makeplots: bool = False,
        max_iter_harmony: int = 20,
    ) -> Tuple[AnnData, List[str]]:
        """seurat_v3 HVGs → quantile-ceiling scaling → PCA → Harmony MOE
        correction of the expression matrix (reference preprocess.py:270-358)."""
        self.timings = {}
        _adata.var = _adata.var.copy()
        if n_top_genes is not None:
            t0 = time.perf_counter()
            mask, norm_var = highly_variable_genes_seurat_v3(
                _adata.X, n_top_genes=n_top_genes
            )
            _adata.var["highly_variable"] = mask
            _adata.var["variances_norm"] = norm_var
            self._timed("hvg", t0)
        elif "highly_variable" not in _adata.var.columns:
            raise Exception(
                "If a numeric value for n_top_genes is not provided, you must "
                "include a highly_variable column in _adata"
            )

        hv = np.asarray(_adata.var["highly_variable"])

        if harmony_vars is not None:
            t0 = time.perf_counter()
            anorm = AnnData(
                normalize_total(_adata.X, target_sum=librarysize_targetsum),
                obs=_adata.obs.copy(), var=_adata.var.copy(),
            )
            anorm = anorm[:, hv]
            stdscale_quantile_celing(
                anorm, max_value=max_scaled_thresh, quantile_thresh=quantile_thresh
            )

            _adata = _adata[:, hv]
            stdscale_quantile_celing(
                _adata, max_value=max_scaled_thresh, quantile_thresh=quantile_thresh
            )

            if makeplots:
                make_count_hist(anorm, num_cells=1000)

            anorm_X = anorm.X.toarray() if sp.issparse(anorm.X) else np.asarray(anorm.X)
            self._timed("scaling", t0)
            t0 = time.perf_counter()
            pcs, _, _ = run_pca(anorm_X, n_comps=50, device=self.device)
            self._timed("pca", t0)
            self.pca_embedding = pcs

            X_dense = _adata.X.toarray() if sp.issparse(_adata.X) else np.asarray(_adata.X)
            if normalize_librarysize:
                X_dense = anorm_X
                obs = anorm.obs
            else:
                obs = _adata.obs
            X_corr, pca_harmony = self.harmony_correct_X(
                X_dense, obs, pcs, harmony_vars,
                max_iter_harmony=max_iter_harmony, theta=theta,
            )
            _adata = AnnData(X_corr, obs=_adata.obs.copy(), var=_adata.var.copy())
            _adata.uns["X_pca_harmony"] = pca_harmony
        else:
            if normalize_librarysize:
                _adata = AnnData(
                    normalize_total(_adata.X, target_sum=librarysize_targetsum),
                    obs=_adata.obs.copy(), var=_adata.var.copy(),
                )
            _adata = _adata[:, hv]
            stdscale_quantile_celing(
                _adata, max_value=max_scaled_thresh, quantile_thresh=quantile_thresh
            )
            if makeplots:
                make_count_hist(_adata, num_cells=1000)

        hvgs = list(_adata.var.index)
        return _adata, hvgs

    # ------------------------------------------------------------------
    def harmony_correct_X(
        self, X, obs: pd.DataFrame, pca_embedding, harmony_vars,
        theta: float = 1, max_iter_harmony: int = 20,
    ):
        """Learn Harmony parameters on the PCA embedding, then apply the MOE
        ridge correction directly to the expression matrix and clip negatives
        (reference preprocess.py:362-422)."""
        t0 = time.perf_counter()
        result = harmony_mod.run_harmony(
            np.asarray(pca_embedding), obs, harmony_vars, theta=theta,
            max_iter_harmony=max_iter_harmony, random_state=0,
            device=self.device,
        )
        self._timed("harmony", t0)
        self.harmony_result = result
        t0 = time.perf_counter()
        X_corr = harmony_mod.moe_correct_ridge_X(np.asarray(X), result)
        self._timed("moe_x", t0)
        return X_corr, result.Z_corr

    # ------------------------------------------------------------------
    def select_features_MI(
        self, _adata: AnnData, cluster, max_scaled_thresh=None,
        quantile_thresh: float = 0.9999, n_top_features: int = 70,
        makeplots: bool = False,
    ) -> AnnData:
        """Rank features by mutual information against a clustering; mark the
        top-N as highly_variable (reference preprocess.py:425-473; used for
        ADT panels)."""
        from sklearn.feature_selection import mutual_info_classif

        # scanpy's normalize_total default: scale cells to the median library
        # size (reference preprocess.py:445 calls it with no target_sum)
        median_libsize = float(np.median(np.asarray(_adata.X.sum(axis=1)).ravel()))
        _adata.X = normalize_total(_adata.X, target_sum=median_libsize)
        stdscale_quantile_celing(
            _adata, max_value=max_scaled_thresh, quantile_thresh=quantile_thresh
        )

        Xd = _adata.X.toarray() if sp.issparse(_adata.X) else np.asarray(_adata.X)
        res = mutual_info_classif(
            Xd, cluster, discrete_features="auto", n_neighbors=3, copy=True,
            random_state=None,
        )
        res = pd.Series(res, index=_adata.var.index).sort_values(ascending=False)
        resdf = pd.DataFrame(
            [res.values, np.arange(res.shape[0])],
            columns=res.index, index=["MI", "MI_Rank"],
        ).T
        resdf["MI_diff"] = resdf["MI"].diff()

        _adata.var = _adata.var.copy()
        for v in resdf.columns:
            _adata.var[v] = resdf[v]
        _adata.var["highly_variable"] = _adata.var["MI_Rank"] < n_top_features
        return _adata
