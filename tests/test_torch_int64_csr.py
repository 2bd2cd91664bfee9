"""int64-index CSR through the port (tests/test_int64_csr.py for the port).

scipy promotes CSR indices and indptr to int64 once nnz >= 2^31. A matrix of
that size does not fit a test host, so these tests give small matrices int64
index arrays (the code paths branch on the index dtype, not its magnitude)
and hold the native kernels, the column subset, the device densify and the
pipeline (both consensus branches: the TPM on the device and forced over
the limit) to the int32 run. Kernels exact or within rtol 1e-12; the
pipeline's artifacts within SSE 1e-6 of the int32 run, the JAX test's
bound."""

import numpy as np
import pytest
import scipy.sparse as sp

from cnmf_tpu_torch.native import csr_col_moments, csr_col_subset, densify_csr
from cnmf_tpu_torch.ops.device_densify import device_densify_csr
from cnmf_tpu_torch.ops.normalize import csr_column_subset
from torch_knobs import (  # noqa: F401 (autouse)
    host_draws_by_default,
    one_torch_thread,
)


def _as_i64(X: sp.csr_matrix) -> sp.csr_matrix:
    # the constructor turns small indices back to int32: set the arrays
    # directly, as scipy leaves them at nnz >= 2^31
    out = X.copy()
    out.indices = out.indices.astype(np.int64)
    out.indptr = out.indptr.astype(np.int64)
    assert out.indices.dtype == np.int64 and out.indptr.dtype == np.int64
    return out


def _rand_csr(n, g, density=0.3, dtype=np.float64, seed=0):
    return sp.random(n, g, density=density, format="csr", dtype=dtype,
                     random_state=np.random.RandomState(seed))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_densify_int64_matches_int32(dtype):
    X = _rand_csr(40, 30, dtype=dtype, seed=1)
    out = densify_csr(_as_i64(X), out_dtype=np.float32)
    np.testing.assert_array_equal(out, densify_csr(X, out_dtype=np.float32))
    np.testing.assert_array_equal(out, X.toarray().astype(np.float32))
    np.testing.assert_array_equal(
        device_densify_csr(_as_i64(X), np.float32, "cpu").numpy(), out)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_col_moments_int64(dtype):
    X = _rand_csr(50, 25, dtype=dtype, seed=2)
    s, q = csr_col_moments(_as_i64(X))
    d = X.toarray().astype(np.float64)
    np.testing.assert_allclose(s, d.sum(0), rtol=1e-12)
    np.testing.assert_allclose(q, (d ** 2).sum(0), rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_col_subset_int64(dtype):
    X = _rand_csr(30, 40, dtype=dtype, seed=3)
    cols = np.array([5, 1, 17, 33, 8])
    lookup = np.full(40, -1, dtype=np.int32)
    lookup[cols] = np.arange(len(cols), dtype=np.int32)
    data, indices, indptr = csr_col_subset(_as_i64(X), lookup)
    # the output keeps the input's index dtype
    assert indices.dtype == np.int64
    out = sp.csr_matrix((data, indices, indptr), shape=(30, len(cols)))
    out.sort_indices()
    np.testing.assert_array_equal(out.toarray(), X[:, cols].toarray())


def test_csr_column_subset_int64_end_to_end():
    X = _rand_csr(25, 60, seed=4)
    cols = np.sort(np.random.RandomState(5).choice(60, 20, replace=False))
    a = csr_column_subset(X, cols)
    b = csr_column_subset(_as_i64(X), cols)
    np.testing.assert_array_equal(a.toarray(), b.toarray())
    np.testing.assert_array_equal(a.toarray(), X[:, cols].toarray())


@pytest.mark.parametrize("branch", ["device", "sparse_products"])
def test_pipeline_int64_sparse_counts(branch):
    """prepare → factorize → combine → consensus through pipeline/stages.py
    on in-memory CSR counts, with every sparse matrix an entry point takes
    (the counts, the normalized counts, the TPM) given int64 indices,
    reproduces the int32 run: the TPM on the device (``device``) and
    forced over the limit onto the host-SpMM branch
    (``sparse_products``)."""
    import torch

    from cnmf_tpu_torch.ops.device_densify import to_device_dense
    from cnmf_tpu_torch.pipeline import stages

    rng = np.random.RandomState(42)
    W = rng.gamma(0.7, 1.0, size=(90, 4))
    H = rng.gamma(0.5, 1.0, size=(4, 130)) * (rng.rand(4, 130) < 0.4)
    X = rng.poisson(W @ H * 2.0).astype(np.float64)
    X[X.sum(axis=1) == 0, 0] = 1
    kwargs = stages.nmf_run_params()
    _, seeds = stages.replicate_seeds([4], 4, 14)

    results = {}
    for tag, cast in [("i32", lambda m: m), ("i64", _as_i64)]:
        prep = stages.prepare_arrays(cast(sp.csr_matrix(X)), 70)
        norm, tpm = cast(prep.norm), cast(prep.tpm)
        Xd = to_device_dense(norm, np.float32, "cpu")
        spectra, _, _ = stages.factorize_k(norm, Xd, 4, seeds, kwargs)
        tpm_src = (to_device_dense(tpm, np.float32, "cpu")
                   if branch == "device" else tpm)
        assert isinstance(tpm_src, torch.Tensor) == (branch == "device")
        result = stages.consensus_arrays(
            stages.combine_arrays(list(spectra)), 4, Xd, tpm_src,
            prep.tpm_std, prep.hvg_idx, kwargs, zero_safe=True)
        results[tag] = result
    for key in ["spectra", "usages", "spectra_tpm", "spectra_score"]:
        a, b = getattr(results["i32"], key), getattr(results["i64"], key)
        np.testing.assert_array_equal(a, b, err_msg=key)
