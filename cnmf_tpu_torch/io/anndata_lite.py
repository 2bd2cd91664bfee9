"""A minimal AnnData-compatible container.

The reference pipeline stores cells × genes matrices as scanpy/anndata
``AnnData`` objects (reference cnmf.py:26, 384-433). This image ships no
anndata, so the framework provides its own lightweight container with the
subset of semantics the pipeline needs: a dense or CSR ``X``, ``obs``/``var``
DataFrames aligned to the matrix, column subsetting by gene name, and h5ad
round-tripping (see cnmf_tpu_torch.io.h5ad).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import pandas as pd
import scipy.sparse as sp

from cnmf_tpu_torch.ops.normalize import csr_column_subset

Matrix = Union[np.ndarray, sp.spmatrix]


class AnnData:
    """cells × genes annotated matrix.

    Attributes
    ----------
    X : np.ndarray or scipy.sparse.spmatrix, shape (n_obs, n_vars)
    obs : pd.DataFrame indexed by cell names
    var : pd.DataFrame indexed by gene names
    uns : dict of unstructured metadata
    """

    def __init__(
        self,
        X: Matrix,
        obs: Optional[pd.DataFrame] = None,
        var: Optional[pd.DataFrame] = None,
        uns: Optional[dict] = None,
    ):
        if sp.issparse(X) and not sp.isspmatrix_csr(X):
            X = X.tocsr()
        self.X = X
        n_obs, n_vars = X.shape
        if obs is None:
            obs = pd.DataFrame(index=pd.Index([str(i) for i in range(n_obs)]))
        if var is None:
            var = pd.DataFrame(index=pd.Index([str(i) for i in range(n_vars)]))
        if len(obs) != n_obs:
            raise ValueError(f"obs has {len(obs)} rows but X has {n_obs}")
        if len(var) != n_vars:
            raise ValueError(f"var has {len(var)} rows but X has {n_vars}")
        self.obs = obs
        self.var = var
        self.uns = {} if uns is None else uns

    # ------------------------------------------------------------------
    @property
    def shape(self):
        return self.X.shape

    @property
    def n_obs(self):
        return self.X.shape[0]

    @property
    def n_vars(self):
        return self.X.shape[1]

    @property
    def obs_names(self) -> pd.Index:
        return self.obs.index

    @property
    def var_names(self) -> pd.Index:
        return self.var.index

    def var_names_make_unique(self, join: str = "-") -> None:
        """Deduplicate gene names in place ('-1', '-2', ... suffixes —
        anndata/scanpy semantics, shared helper with the 10x loader)."""
        from cnmf_tpu_torch.io.tenx import _make_index_unique

        if not self.var.index.is_unique:
            self.var = self.var.copy()
            self.var.index = _make_index_unique(self.var.index, join=join)

    def copy(self) -> "AnnData":
        return AnnData(
            self.X.copy(),
            self.obs.copy(),
            self.var.copy(),
            dict(self.uns),
        )

    # ------------------------------------------------------------------
    def __getitem__(self, key) -> "AnnData":
        """Support adata[:, gene_list] / adata[cell_sel, gene_sel] subsetting."""
        if not isinstance(key, tuple):
            key = (key, slice(None))
        if len(key) != 2:
            raise IndexError("AnnData supports 2D indexing only")
        obs_idx = self._resolve(key[0], self.obs.index)
        var_idx = self._resolve(key[1], self.var.index)
        X = self.X
        if isinstance(obs_idx, slice) and obs_idx == slice(None):
            Xs = X
            obs = self.obs
        else:
            Xs = X[obs_idx]
            obs = self.obs.iloc[obs_idx]
        if isinstance(var_idx, slice) and var_idx == slice(None):
            Xs2 = Xs
            var = self.var
        else:
            var_arr = np.asarray(var_idx)
            if not sp.issparse(Xs):
                Xs2 = Xs[:, var_idx]
            elif (
                sp.isspmatrix_csr(Xs)
                and var_arr.dtype.kind in "iu"
                # negatives alias positive positions through the gather
                # table (lookup[-1] overwrites the last column's slot), so
                # only plain non-negative duplicate-free selections qualify
                and (var_arr.dtype.kind == "u" or (var_arr >= 0).all())
                and len(np.unique(var_arr)) == len(var_arr)
            ):
                Xs2 = csr_column_subset(Xs, var_arr)
            else:
                Xs2 = Xs.tocsc()[:, var_idx].tocsr()
            var = self.var.iloc[var_idx]
        return AnnData(Xs2, obs.copy(), var.copy(), dict(self.uns))

    @staticmethod
    def _resolve(sel, index: pd.Index):
        if isinstance(sel, slice):
            if sel == slice(None):
                return sel
            return np.arange(len(index))[sel]
        sel = np.asarray(sel)
        if sel.ndim == 0:
            sel = sel.reshape(1)
        if sel.dtype == bool:
            return np.where(sel)[0]
        if sel.dtype.kind in "iu":
            return sel
        # label-based selection (list of gene/cell names), keeping order
        locs = index.get_indexer(pd.Index(sel))
        if (locs < 0).any():
            missing = list(np.asarray(sel)[locs < 0][:5])
            raise KeyError(f"labels not found in index: {missing}")
        return locs

    def __repr__(self):
        kind = "sparse" if sp.issparse(self.X) else "dense"
        return f"AnnData(n_obs={self.n_obs}, n_vars={self.n_vars}, X={kind})"
