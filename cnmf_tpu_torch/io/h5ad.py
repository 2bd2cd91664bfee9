"""h5ad (AnnData-on-HDF5) codec built directly on h5py.

Implements the anndata on-disk specification (encoding-type/version attrs,
dense ``array`` or ``csr_matrix``/``csc_matrix`` X, ``dataframe`` obs/var with
string / numeric / categorical columns) so files written here are readable by
real anndata and vice versa. Replaces the reference's use of ``sc.read`` /
``sc.write`` (reference cnmf.py:384, 410, 433, 561, 726, 873, 950).

The same codec as ``cnmf_tpu.io.h5ad``, except that h5py is imported by the
functions that use it: the port's array stages run without it.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import scipy.sparse as sp

from cnmf_tpu_torch.io.anndata_lite import AnnData


def _str_dt():
    import h5py

    return h5py.string_dtype(encoding="utf-8")


# ----------------------------------------------------------------------
# writing
# ----------------------------------------------------------------------

def _set_enc(obj, enc_type: str, enc_version: str) -> None:
    obj.attrs["encoding-type"] = enc_type
    obj.attrs["encoding-version"] = enc_version


def _write_array(group: h5py.Group, name: str, values: np.ndarray) -> None:
    values = np.asarray(values)
    if values.dtype.kind in ("U", "O"):
        ds = group.create_dataset(name, data=values.astype(object), dtype=_str_dt())
        _set_enc(ds, "string-array", "0.2.0")
    elif values.dtype.kind == "b":
        ds = group.create_dataset(name, data=values)
        _set_enc(ds, "array", "0.2.0")
    else:
        ds = group.create_dataset(name, data=values)
        _set_enc(ds, "array", "0.2.0")


def _write_categorical(group: h5py.Group, name: str, values: pd.Categorical) -> None:
    sub = group.create_group(name)
    _set_enc(sub, "categorical", "0.2.0")
    sub.attrs["ordered"] = bool(values.ordered)
    _write_array(sub, "codes", values.codes.astype(np.int32))
    _write_array(sub, "categories", np.asarray(values.categories))


def _write_dataframe(parent: h5py.Group, name: str, df: pd.DataFrame) -> None:
    group = parent.create_group(name)
    _set_enc(group, "dataframe", "0.2.0")
    index_name = df.index.name if df.index.name else "_index"
    group.attrs["_index"] = index_name
    group.attrs["column-order"] = np.array(
        [str(c) for c in df.columns], dtype=object
    ) if len(df.columns) else np.array([], dtype=_str_dt())
    _write_array(group, index_name, np.asarray(df.index.astype(str)))
    for col in df.columns:
        vals = df[col]
        if isinstance(vals.dtype, pd.CategoricalDtype):
            _write_categorical(group, str(col), vals.values)
        else:
            _write_array(group, str(col), vals.to_numpy())


def _write_x(parent: h5py.Group, name: str, X) -> None:
    if sp.issparse(X):
        Xc = X.tocsr() if not (sp.isspmatrix_csr(X) or sp.isspmatrix_csc(X)) else X
        group = parent.create_group(name)
        enc = "csr_matrix" if sp.isspmatrix_csr(Xc) else "csc_matrix"
        _set_enc(group, enc, "0.1.0")
        group.attrs["shape"] = np.asarray(Xc.shape, dtype=np.int64)
        group.create_dataset("data", data=Xc.data)
        group.create_dataset(
            "indices",
            data=Xc.indices.astype(np.int32, copy=False)
            if Xc.shape[1] < 2**31 else Xc.indices,
        )
        group.create_dataset("indptr", data=Xc.indptr)
    else:
        ds = parent.create_dataset(name, data=np.asarray(X))
        _set_enc(ds, "array", "0.2.0")


def _write_mapping(parent: h5py.Group, name: str, mapping: dict) -> None:
    group = parent.create_group(name)
    _set_enc(group, "dict", "0.1.0")
    for key, val in mapping.items():
        if isinstance(val, dict):
            _write_mapping(group, str(key), val)
        elif isinstance(val, str):
            ds = group.create_dataset(str(key), data=val, dtype=_str_dt())
            _set_enc(ds, "string", "0.2.0")
        elif np.isscalar(val):
            ds = group.create_dataset(str(key), data=val)
            _set_enc(ds, "numeric-scalar", "0.2.0")
        else:
            _write_array(group, str(key), np.asarray(val))


def write_h5ad(filename: str, adata: AnnData) -> None:
    import h5py

    with h5py.File(filename, "w") as f:
        _set_enc(f, "anndata", "0.1.0")
        _write_x(f, "X", adata.X)
        _write_dataframe(f, "obs", adata.obs)
        _write_dataframe(f, "var", adata.var)
        _write_mapping(f, "uns", adata.uns)
        _write_mapping(f, "obsm", {})
        _write_mapping(f, "varm", {})
        _write_mapping(f, "obsp", {})
        _write_mapping(f, "varp", {})
        _write_mapping(f, "layers", {})


# ----------------------------------------------------------------------
# reading
# ----------------------------------------------------------------------

def _decode_strings(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.kind == "O" or arr.dtype.kind == "S":
        return np.array(
            [v.decode("utf-8") if isinstance(v, bytes) else v for v in arr.ravel()],
            dtype=object,
        ).reshape(arr.shape)
    return arr


def _read_array(node) -> np.ndarray:
    arr = node[()]
    if isinstance(arr, (bytes, str)):
        return arr.decode("utf-8") if isinstance(arr, bytes) else arr
    arr = np.asarray(arr)
    return _decode_strings(arr)


def _read_categorical(group: h5py.Group) -> pd.Categorical:
    codes = np.asarray(group["codes"][()])
    categories = _read_array(group["categories"])
    return pd.Categorical.from_codes(
        codes, categories=pd.Index(categories), ordered=bool(group.attrs.get("ordered", False))
    )


def _read_dataframe_legacy(node: h5py.Dataset) -> pd.DataFrame:
    """Pre-anndata-0.8 layout: obs/var stored as one structured-record
    dataset with an 'index' (or '_index') field."""
    rec = node[()]
    names = rec.dtype.names or ()
    index_key = "index" if "index" in names else "_index"
    data = {}
    index = None
    for name in names:
        col = _decode_strings(np.asarray(rec[name]))
        if name == index_key:
            index = pd.Index(col)
        else:
            data[name] = col
    if index is None:
        index = pd.RangeIndex(len(rec)).astype(str)
    return pd.DataFrame(data, index=index)


def _read_dataframe(group: h5py.Group) -> pd.DataFrame:
    import h5py

    enc = group.attrs.get("encoding-type", "")
    index_key = group.attrs.get("_index", "_index")
    if isinstance(index_key, bytes):
        index_key = index_key.decode("utf-8")
    index = pd.Index(_read_array(group[index_key]))
    if index_key != "_index":
        index.name = index_key
    col_order = group.attrs.get("column-order", None)
    if col_order is None:
        cols = [k for k in group.keys() if k != index_key]
    else:
        cols = [c.decode("utf-8") if isinstance(c, bytes) else str(c) for c in np.asarray(col_order).ravel()]
    data = {}
    for col in cols:
        if col not in group:
            continue
        node = group[col]
        if isinstance(node, h5py.Group):
            data[col] = _read_categorical(node)
        else:
            data[col] = _read_array(node)
    df = pd.DataFrame(data, index=index)
    del enc
    return df


def _read_x(node):
    import h5py

    if isinstance(node, h5py.Group):
        enc = node.attrs.get("encoding-type", "")
        if isinstance(enc, bytes):
            enc = enc.decode("utf-8")
        if not enc and "h5sparse_format" in node.attrs:
            # legacy h5sparse layout
            fmt = node.attrs["h5sparse_format"]
            fmt = fmt.decode("utf-8") if isinstance(fmt, bytes) else fmt
            enc = f"{fmt}_matrix"
            shape = tuple(int(s) for s in np.asarray(node.attrs["h5sparse_shape"]).ravel())
        else:
            shape = tuple(int(s) for s in np.asarray(node.attrs["shape"]).ravel())
        data = node["data"][()]
        indices = node["indices"][()]
        indptr = node["indptr"][()]
        if enc == "csc_matrix" or (not enc and len(indptr) == shape[1] + 1):
            return sp.csc_matrix((data, indices, indptr), shape=shape).tocsr()
        return sp.csr_matrix((data, indices, indptr), shape=shape)
    return np.asarray(node[()])


def _read_mapping(group: h5py.Group) -> dict:
    import h5py

    out = {}
    for key in group.keys():
        node = group[key]
        if isinstance(node, h5py.Group):
            enc = node.attrs.get("encoding-type", "")
            if isinstance(enc, bytes):
                enc = enc.decode("utf-8")
            if enc in ("csr_matrix", "csc_matrix"):
                out[key] = _read_x(node)
            elif enc == "categorical":
                out[key] = _read_categorical(node)
            else:
                out[key] = _read_mapping(node)
        else:
            out[key] = _read_array(node)
    return out


def read_h5ad_shape(filename: str) -> tuple:
    """X's (n_obs, n_vars) from the file's header, without reading any data:
    a sizing decision should not cost a multi-GB load."""
    import h5py

    with h5py.File(filename, "r") as f:
        node = f["X"]
        if isinstance(node, h5py.Group):
            key = "shape" if "shape" in node.attrs else "h5sparse_shape"
            return tuple(int(s) for s in np.asarray(node.attrs[key]).ravel())
        return tuple(int(s) for s in node.shape)


def read_h5ad_x_is_sparse(filename: str) -> bool:
    """Whether X is stored sparse (a CSR/CSC group), from the header only."""
    import h5py

    with h5py.File(filename, "r") as f:
        return isinstance(f["X"], h5py.Group)


def read_h5ad(filename: str) -> AnnData:
    import h5py

    with h5py.File(filename, "r") as f:
        X = _read_x(f["X"])

        def read_df(key):
            if key not in f:
                return None
            node = f[key]
            if isinstance(node, h5py.Dataset):
                return _read_dataframe_legacy(node)
            return _read_dataframe(node)

        obs = read_df("obs")
        var = read_df("var")
        uns = _read_mapping(f["uns"]) if "uns" in f else {}
    return AnnData(X, obs=obs, var=var, uns=uns)
