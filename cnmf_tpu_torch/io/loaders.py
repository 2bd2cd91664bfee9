"""Counts-matrix loading dispatcher.

Mirrors the reference's input-format matrix (reference cnmf.py:383-433):
``.h5ad`` → h5ad codec; ``.mtx``/``.mtx.gz`` → 10x directory; ``.npz`` →
DataFrame npz; anything else → tab-delimited text.

DataFrame-sourced inputs (txt / df.npz) stay DENSE, as in
``cnmf_tpu.io.loaders``: the reference wraps them in CSR unless
``--densify`` (cnmf.py:395-402); the sparse and dense Fano selections are
the same math, so only the h5ad storage encoding differs.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
import scipy.sparse as sp

from cnmf_tpu_torch.io.anndata_lite import AnnData
from cnmf_tpu_torch.io.dataframe import load_df_from_npz
from cnmf_tpu_torch.io.h5ad import read_h5ad
from cnmf_tpu_torch.io.tenx import read_10x_mtx


def load_counts(counts_fn: str, densify: bool = False) -> AnnData:
    if counts_fn.endswith(".h5ad"):
        adata = read_h5ad(counts_fn)
    elif counts_fn.endswith(".mtx") or counts_fn.endswith(".mtx.gz"):
        adata = read_10x_mtx(os.path.dirname(counts_fn))
    else:
        if counts_fn.endswith(".npz"):
            df = load_df_from_npz(counts_fn)
        else:
            df = pd.read_csv(counts_fn, sep="\t", index_col=0)
        adata = AnnData(
            X=df.values,
            obs=pd.DataFrame(index=df.index),
            var=pd.DataFrame(index=df.columns),
        )
    if densify and sp.issparse(adata.X):
        adata.X = np.asarray(adata.X.todense())
    return adata
