"""Native (C++/OpenMP) host kernels, loaded via ctypes.

The solves run on the device; these cover the host-bound pieces that feed
it: the CSR→dense expansion of multi-GB counts / TPM matrices (scipy's
``.toarray()`` is single-threaded; rows expand independently, so this
threads linearly), per-column moments of a CSR matrix, and the CSR column
subset. The same functions as ``cnmf_tpu.native``, from the same C++ source
(``densify.cpp``).

The shared library builds with g++ at first use into the directory of the
kernel library (``ops.kernel_lib.build_dir``: ``_build/`` in the package,
or the user's cache directory where that is not writable), named by a hash
of the flags and the source. Every entry point falls back to scipy/numpy
when no compiler is available, so the package works without a native
toolchain; ``library_loaded`` says which route runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np
import scipy.sparse as sp

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "densify.cpp")
# no -march=native: the library may be built on one host and loaded on another
_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None
_lib_failed = False


def _lib_path() -> str:
    from cnmf_tpu_torch.ops.kernel_lib import build_dir

    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(build_dir(),
                        f"libcnmf_densify_{digest.hexdigest()[:16]}.so")


def _build(lib_path: str) -> bool:
    # compile to a private temp path and atomically rename, so concurrent
    # processes never load a half-written library
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp_path], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp_path, lib_path)
        return True
    except (OSError, subprocess.SubprocessError):
        # no compiler or a failed build: the scipy/numpy fallback
        try:
            os.remove(tmp_path)
        except OSError:
            pass
        return False


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        lib_path = _lib_path()
        if not os.path.exists(lib_path) and not _build(lib_path):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(lib_path)
            _bind_symbols(lib)
        except (OSError, AttributeError):
            _lib_failed = True
            return None
        _lib = lib
        return _lib


def library_loaded() -> bool:
    """Whether the native library is built and loaded (building it now if
    it is not); False means the scipy/numpy fallbacks run."""
    return _load() is not None


def _bind_symbols(lib) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    # every kernel exists for int32 and int64 stored-index dtypes (scipy
    # promotes indices to int64 at nnz >= 2^31); the _i64 suffix selects
    for suffix, idx_p in [("", i32p), ("_i64", i64p)]:
        for name, data_t in [
            ("densify_csr_f32", ctypes.c_float),
            ("densify_csr_f64", ctypes.c_double),
        ]:
            fn = getattr(lib, name + suffix)
            fn.restype = None
            fn.argtypes = [
                ctypes.POINTER(data_t), idx_p, i64p,
                ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(data_t),
            ]
        fn = getattr(lib, "densify_csr_f64_to_f32" + suffix)
        fn.restype = None
        fn.argtypes = [
            f64p, idx_p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        for name, data_t in [
            ("csr_col_moments_f64", ctypes.c_double),
            ("csr_col_moments_f32", ctypes.c_float),
        ]:
            fn = getattr(lib, name + suffix)
            fn.restype = None
            fn.argtypes = [
                ctypes.POINTER(data_t), idx_p,
                ctypes.c_int64, ctypes.c_int64, f64p, f64p,
            ]
        fn = getattr(lib, "csr_col_subset_count" + suffix)
        fn.restype = ctypes.c_int64
        fn.argtypes = [idx_p, ctypes.c_int64, i32p]
        # fill writes indices at the INPUT index dtype (uniform scipy dtype,
        # no recast over nnz-length arrays)
        for name, data_t in [
            ("csr_col_subset_fill_f64", ctypes.c_double),
            ("csr_col_subset_fill_f32", ctypes.c_float),
        ]:
            fn = getattr(lib, name + suffix)
            fn.restype = None
            fn.argtypes = [
                ctypes.POINTER(data_t), idx_p, i64p, ctypes.c_int64,
                i32p, ctypes.POINTER(data_t), idx_p, i64p,
            ]


def _covered(X) -> bool:
    return (sp.isspmatrix_csr(X) and X.dtype in (np.float64, np.float32)
            and X.indices.dtype in (np.int32, np.int64))


def _index_types(X):
    """(symbol suffix, ctypes index pointer type) of X's stored indices."""
    if X.indices.dtype == np.int64:
        return "_i64", ctypes.POINTER(ctypes.c_int64)
    return "", ctypes.POINTER(ctypes.c_int32)


def _data_type(dtype):
    return ctypes.c_double if dtype == np.float64 else ctypes.c_float


def csr_col_moments(X):
    """Per-column (sum, sum of squares) over the nonzeros of a CSR matrix,
    in float64, one threaded pass. Returns None when the native library is
    unavailable or the layout/dtype is not covered (the caller falls back
    to numpy)."""
    if not _covered(X):
        return None
    lib = _load()
    if lib is None:
        return None
    suffix, idx_p = _index_types(X)
    data = np.ascontiguousarray(X.data)
    indices = np.ascontiguousarray(X.indices)
    s = np.zeros(X.shape[1], dtype=np.float64)
    q = np.zeros(X.shape[1], dtype=np.float64)
    fn = getattr(lib, ("csr_col_moments_f64" if X.dtype == np.float64
                       else "csr_col_moments_f32") + suffix)
    data_t = _data_type(X.dtype)
    f64p = ctypes.POINTER(ctypes.c_double)
    fn(data.ctypes.data_as(ctypes.POINTER(data_t)),
       indices.ctypes.data_as(idx_p), np.int64(data.size),
       np.int64(X.shape[1]), s.ctypes.data_as(f64p), q.ctypes.data_as(f64p))
    return s, q


def csr_col_subset(X, lookup):
    """Column-subset a CSR matrix through a gather table (``lookup[j]`` =
    output column of input column j, -1 = drop) in two streaming passes.
    Returns ``(data, indices, indptr)`` arrays (indices at the input's index
    dtype, indptr int64), or None when the native library is unavailable or
    the layout is not covered (the caller falls back to numpy)."""
    if not _covered(X):
        return None
    lib = _load()
    if lib is None:
        return None
    suffix, idx_p = _index_types(X)
    data = np.ascontiguousarray(X.data)
    indices = np.ascontiguousarray(X.indices)
    indptr = np.ascontiguousarray(X.indptr, dtype=np.int64)
    lookup = np.ascontiguousarray(lookup, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    kept = getattr(lib, "csr_col_subset_count" + suffix)(
        indices.ctypes.data_as(idx_p), np.int64(data.size),
        lookup.ctypes.data_as(i32p))
    out_data = np.empty(kept, dtype=X.dtype)
    out_indices = np.empty(kept, dtype=X.indices.dtype)
    out_indptr = np.empty(X.shape[0] + 1, dtype=np.int64)
    data_p = ctypes.POINTER(_data_type(X.dtype))
    getattr(lib, ("csr_col_subset_fill_f64" if X.dtype == np.float64
                  else "csr_col_subset_fill_f32") + suffix)(
        data.ctypes.data_as(data_p), indices.ctypes.data_as(idx_p),
        indptr.ctypes.data_as(i64p), np.int64(X.shape[0]),
        lookup.ctypes.data_as(i32p), out_data.ctypes.data_as(data_p),
        out_indices.ctypes.data_as(idx_p), out_indptr.ctypes.data_as(i64p))
    return out_data, out_indices, out_indptr


def densify_csr(X, out_dtype=None) -> np.ndarray:
    """A sparse matrix as a C-contiguous dense array, threaded; a dense
    input is returned as an array (cast to ``out_dtype`` where given).
    ``out_dtype`` casts during the expansion (f64 data → f32 dense without
    an intermediate). Falls back to scipy without the native library."""
    if not sp.issparse(X):
        arr = np.asarray(X)
        if out_dtype is not None:
            arr = arr.astype(out_dtype, copy=False)
        return arr
    Xc = X.tocsr()
    out_dtype = np.dtype(out_dtype) if out_dtype is not None else Xc.dtype
    lib = _load()
    if lib is None or out_dtype not in (np.float32, np.float64):
        return Xc.toarray().astype(out_dtype, copy=False)
    # stream indices at their stored dtype: recasting int64 indices at
    # >2.1B nnz would materialize an 8+ GB temporary
    if Xc.indices.dtype not in (np.int32, np.int64):
        Xc = sp.csr_matrix((Xc.data, Xc.indices.astype(np.int32), Xc.indptr),
                           shape=Xc.shape)
    suffix, idx_p = _index_types(Xc)
    indices = np.ascontiguousarray(Xc.indices)
    indptr = np.ascontiguousarray(Xc.indptr, dtype=np.int64)
    n_rows, n_cols = Xc.shape
    out = np.empty((n_rows, n_cols), dtype=out_dtype)
    if Xc.dtype == np.float64 and out_dtype == np.float32:
        name, data = "densify_csr_f64_to_f32", np.ascontiguousarray(Xc.data)
    elif out_dtype == np.float32:
        name = "densify_csr_f32"
        data = np.ascontiguousarray(Xc.data, dtype=np.float32)
    else:
        name = "densify_csr_f64"
        data = np.ascontiguousarray(Xc.data, dtype=np.float64)
    getattr(lib, name + suffix)(
        data.ctypes.data_as(ctypes.POINTER(_data_type(data.dtype))),
        indices.ctypes.data_as(idx_p),
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_rows, n_cols,
        out.ctypes.data_as(ctypes.POINTER(_data_type(out_dtype))))
    return out
