"""The port's native host library (cnmf_tpu_torch/native: threaded CSR
densify, column moments and column subset) and the CSR column subset
against scipy/numpy, with the numpy fallbacks, and against the JAX package's
library (tests/test_native.py and tests/test_csr_subset.py for the port).

Densify and the column subset are exact; the column moments within rtol
1e-12 of numpy in float64 and 1e-6 for float32 data (accumulated in
float64), the JAX tests' tolerances."""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

from cnmf_tpu import native as jax_native
from cnmf_tpu_torch import native
from cnmf_tpu_torch.io.anndata_lite import AnnData
from cnmf_tpu_torch.ops.normalize import csr_column_subset
from cnmf_tpu_torch.ops.stats import mean_var


def _rand_csr(seed, n=60, g=40, density=0.2):
    rng = np.random.RandomState(seed)
    X = sp.random(n, g, density=density, random_state=rng, format="csr")
    X.data = rng.gamma(1.0, 2.0, size=X.nnz)
    return X


def test_library_builds_and_loads():
    """The package's own build (g++ into the kernel library's build
    directory) loads here; the other tests then cover the native route."""
    assert native.library_loaded()
    assert native._lib_path().startswith(
        __import__("cnmf_tpu_torch.ops.kernel_lib",
                   fromlist=["build_dir"]).build_dir())


@pytest.mark.parametrize("out_dtype", [np.float32, np.float64])
def test_densify_matches_scipy_and_jax(out_dtype):
    X = sp.random(500, 300, density=0.15, format="csr", random_state=1,
                  dtype=np.float64)
    out = native.densify_csr(X, out_dtype=out_dtype)
    assert out.dtype == np.dtype(out_dtype) and out.flags.c_contiguous
    np.testing.assert_array_equal(out, X.toarray().astype(out_dtype))
    np.testing.assert_array_equal(
        out, jax_native.densify_csr(X, out_dtype=out_dtype))


def test_densify_handles_empty_rows_and_dense_input():
    np.testing.assert_array_equal(
        native.densify_csr(sp.csr_matrix((10, 6)), out_dtype=np.float32),
        np.zeros((10, 6), np.float32))
    D = np.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(native.densify_csr(D, out_dtype=np.float32),
                                  D.astype(np.float32))


def test_densify_fallback_path(monkeypatch):
    """With the native library unavailable, the scipy fallback is exact."""
    monkeypatch.setattr(native, "_load", lambda: None)
    X = sp.random(50, 40, density=0.2, format="csr", random_state=2,
                  dtype=np.float64)
    np.testing.assert_array_equal(native.densify_csr(X, out_dtype=np.float32),
                                  X.toarray().astype(np.float32))
    assert native.csr_col_moments(X) is None
    assert native.csr_col_subset(X, np.zeros(40, np.int32)) is None


def test_csr_col_moments_matches_numpy():
    X = sp.random(300, 200, density=0.1, format="csr", random_state=2,
                  dtype=np.float64)
    s, q = native.csr_col_moments(X)
    np.testing.assert_allclose(s, np.asarray(X.sum(axis=0)).ravel(),
                               rtol=1e-12)
    np.testing.assert_allclose(
        q, np.asarray(X.multiply(X).sum(axis=0)).ravel(), rtol=1e-12)
    sf, _ = native.csr_col_moments(X.astype(np.float32))
    np.testing.assert_allclose(sf, s, rtol=1e-6)
    # CSC and other layouts decline
    assert native.csr_col_moments(X.tocsc()) is None


def test_csr_col_moments_same_bits_every_run():
    """The per-thread sums merge in thread order: repeated calls, and int32
    or int64 indices, give the same bits (a merge in finishing order did
    not)."""
    X = sp.random(4000, 130, density=0.3, format="csr", random_state=3)
    X64 = X.copy()
    X64.indices, X64.indptr = (X.indices.astype(np.int64),
                               X.indptr.astype(np.int64))
    first = native.csr_col_moments(X)
    for Y in [X] * 10 + [X64]:
        for a, b in zip(native.csr_col_moments(Y), first):
            np.testing.assert_array_equal(a, b)


def test_mean_var_native_matches_fallback(monkeypatch):
    X = _rand_csr(12, n=200, g=70, density=0.3)
    mean, var = mean_var(X)
    monkeypatch.setattr(native, "_load", lambda: None)
    mean_np, var_np = mean_var(X)
    np.testing.assert_allclose(mean, mean_np, rtol=1e-12)
    np.testing.assert_allclose(var, var_np, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(var, X.toarray().var(axis=0), rtol=1e-10)


@pytest.mark.parametrize("seed", [0, 1])
def test_subset_matches_scipy_ordered(seed):
    X = _rand_csr(seed)
    cols = np.sort(np.random.RandomState(seed + 10).choice(40, 17,
                                                           replace=False))
    ref = X.tocsc()[:, cols].tocsr()
    got = csr_column_subset(X, cols)
    assert got.shape == ref.shape
    assert (got != ref).nnz == 0
    assert got.has_sorted_indices


def test_subset_matches_scipy_unordered():
    X = _rand_csr(3)
    cols = np.random.RandomState(4).permutation(40)[:15]
    assert (csr_column_subset(X, cols) != X.tocsc()[:, cols].tocsr()).nnz == 0


def test_trailing_empty_rows_numpy_fallback(monkeypatch):
    """The reduceat fallback keeps the last stored element of the final
    nonempty row when trailing (or interleaved) rows are empty."""
    monkeypatch.setattr(native, "csr_col_subset", lambda *a: None)
    X = sp.csr_matrix(np.array([[1.0, 2.0, 3.0], [0, 0, 0]]))
    np.testing.assert_array_equal(
        csr_column_subset(X, np.array([0, 2])).toarray(),
        [[1.0, 3.0], [0.0, 0.0]])
    X2 = sp.csr_matrix(np.array([[0, 0, 0], [4.0, 0, 5.0], [0, 0, 0],
                                 [0, 6.0, 7.0], [0, 0, 0]]))
    np.testing.assert_array_equal(
        csr_column_subset(X2, np.array([2, 1])).toarray(),
        [[0, 0], [5.0, 0], [0, 0], [7.0, 6.0], [0, 0]])


def test_subset_empty_rows_and_all_columns_dropped():
    X = sp.csr_matrix(np.array([[0, 1, 0], [0, 0, 0], [2, 0, 3]],
                               dtype=float))
    np.testing.assert_array_equal(csr_column_subset(X, np.array([1])).toarray(),
                                  [[1.0], [0.0], [0.0]])
    empty = csr_column_subset(X, np.array([], dtype=int))
    assert empty.shape == (3, 0) and empty.nnz == 0


def test_numpy_fallback_matches_native(monkeypatch):
    X = _rand_csr(7, n=50, g=30, density=0.3)
    cols = np.array([4, 0, 29, 11, 12])
    ref = csr_column_subset(X, cols)
    monkeypatch.setattr(native, "csr_col_subset", lambda *a: None)
    assert (csr_column_subset(X, cols) != ref).nnz == 0


@pytest.mark.parametrize("pick", [["g3", "g17", "g0", "g9"],   # fast path
                                  ["g2", "g2", "g5"]])          # duplicates
def test_anndata_label_slices(pick):
    X = _rand_csr(5, n=30, g=20)
    ad = AnnData(X, var=pd.DataFrame(index=[f"g{j}" for j in range(20)]))
    sub = ad[:, pick]
    ref = X.tocsc()[:, [int(p[1:]) for p in pick]].tocsr()
    assert (sub.X != ref).nnz == 0
    assert list(sub.var.index) == pick


def test_anndata_negative_int_indices():
    X = _rand_csr(8, n=12, g=4, density=0.6)
    ad = AnnData(X, var=pd.DataFrame(index=[f"g{j}" for j in range(4)]))
    assert (ad[:, np.array([-1, 3])].X != X.tocsc()[:, [3, 3]].tocsr()).nnz == 0
