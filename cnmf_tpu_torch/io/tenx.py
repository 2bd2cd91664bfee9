"""10x Genomics mtx directory reader.

Replaces the reference's ``sc.read_10x_mtx`` (reference cnmf.py:385-387):
reads ``matrix.mtx[.gz]`` plus the barcode and feature/gene TSVs from the same
directory and returns a cells × genes AnnData (10x mtx files are genes × cells,
so the matrix is transposed on load).
"""

from __future__ import annotations

import gzip
import os

import numpy as np
import pandas as pd
import scipy.io
import scipy.sparse as sp

from cnmf_tpu_torch.io.anndata_lite import AnnData


def _find(path_dir: str, names) -> str:
    for n in names:
        p = os.path.join(path_dir, n)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"none of {names} found in {path_dir}")


def _read_tsv(path: str) -> pd.DataFrame:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return pd.read_csv(f, sep="\t", header=None)


def read_10x_mtx(path: str, var_names: str = "gene_symbols", make_unique: bool = True) -> AnnData:
    """Read a 10x-formatted mtx directory into cells × genes AnnData."""
    mtx_fn = _find(path, ["matrix.mtx.gz", "matrix.mtx"])
    barcodes_fn = _find(path, ["barcodes.tsv.gz", "barcodes.tsv"])
    features_fn = _find(
        path, ["features.tsv.gz", "features.tsv", "genes.tsv.gz", "genes.tsv"]
    )

    X = scipy.io.mmread(mtx_fn).T.tocsr()  # 10x stores genes x cells
    barcodes = _read_tsv(barcodes_fn)[0].astype(str).values
    feat = _read_tsv(features_fn)

    gene_ids = feat[0].astype(str).values
    if feat.shape[1] > 1 and var_names == "gene_symbols":
        names = feat[1].astype(str).values
        var = pd.DataFrame({"gene_ids": gene_ids}, index=pd.Index(names))
    else:
        var = pd.DataFrame(index=pd.Index(gene_ids))
        if feat.shape[1] > 1:
            var["gene_symbols"] = feat[1].astype(str).values
    if feat.shape[1] > 2:
        var["feature_types"] = feat[2].astype(str).values

    if make_unique:
        var.index = _make_index_unique(var.index)

    obs = pd.DataFrame(index=pd.Index(barcodes))
    if X.dtype.kind in "iu":
        X = X.astype(np.float32)
    return AnnData(sp.csr_matrix(X), obs=obs, var=var)


def _make_index_unique(index: pd.Index, join: str = "-") -> pd.Index:
    """Append '-1', '-2', ... to duplicated names (scanpy var_names_make_unique semantics)."""
    if index.is_unique:
        return index
    values = index.astype(str).values.copy()
    counts = {}
    seen = set(values)
    for i, v in enumerate(values):
        n = counts.get(v, 0)
        if n > 0:
            new = f"{v}{join}{n}"
            while new in seen:
                n += 1
                new = f"{v}{join}{n}"
            values[i] = new
            seen.add(new)
        counts[v] = n + 1
    return pd.Index(values)
