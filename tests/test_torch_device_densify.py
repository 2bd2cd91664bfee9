"""The port's device densify (ops/device_densify.py) on CPU tensors: exact
equality with the host expansion, blocked against single-shot, int64
indices, and the eligibility gate (tests/test_device_densify.py for the
port). The expansion is torch ops, the same on the CPU and the card."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_tpu.ops.device_densify import (
    device_densify_eligible as jax_eligible,
)
from cnmf_tpu_torch.native import densify_csr
from cnmf_tpu_torch.ops import device_densify as dd


def _random_csr(n, g, density, seed, dtype=np.float64):
    rng = np.random.RandomState(seed)
    X = sp.random(n, g, density=density, random_state=rng, format="csr")
    X.data = (rng.gamma(1.0, 2.0, size=X.nnz) + 0.5).astype(dtype)
    return X


def _densify(X, dtype, **kw):
    return dd.device_densify_csr(X, out_dtype=dtype, device="cpu",
                                 **kw).numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("density", [0.0, 0.03, 0.4])
def test_matches_host_densify(dtype, density):
    X = _random_csr(257, 129, density, seed=3)
    dense = _densify(X, dtype)
    assert dense.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(dense, X.toarray().astype(dtype))
    np.testing.assert_array_equal(dense, densify_csr(X, out_dtype=dtype))


def test_csc_and_noncanonical_inputs():
    X = _random_csr(64, 40, 0.1, seed=5)
    np.testing.assert_array_equal(_densify(X.tocsc(), np.float32),
                                  X.toarray().astype(np.float32))
    # duplicate coordinates: scipy sums them on densify, and so must this
    dup = sp.csr_matrix((np.array([1.0, 2.0, 4.0, 8.0]), np.array([3, 3, 0, 1]),
                         np.array([0, 2, 4, 4])), shape=(3, 5))
    assert not dup.has_canonical_format
    np.testing.assert_array_equal(_densify(dup, np.float64), dup.toarray())


def test_empty_rows_zero_nnz_and_int64_indices():
    np.testing.assert_array_equal(_densify(sp.csr_matrix((5, 7)), np.float32),
                                  np.zeros((5, 7), np.float32))
    X = _random_csr(90, 70, 0.2, seed=6)
    X64 = X.copy()
    X64.indices = X64.indices.astype(np.int64)
    X64.indptr = X64.indptr.astype(np.int64)
    np.testing.assert_array_equal(_densify(X64, np.float32),
                                  X.toarray().astype(np.float32))


def test_blocked_scatter_matches_single_shot():
    X = _random_csr(300, 200, 0.2, seed=7)   # about 12,000 nonzeros
    expect = X.toarray().astype(np.float32)
    np.testing.assert_array_equal(_densify(X, np.float32), expect)
    # many blocks, not aligned to rows
    np.testing.assert_array_equal(_densify(X, np.float32, block_nnz=1000),
                                  expect)


def test_eligibility_gate(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_DEVICE_DENSIFY", "1")
    sparse_enough = _random_csr(100, 100, 0.05, seed=1)
    too_dense = _random_csr(100, 100, 0.5, seed=2)
    assert not dd.device_densify_eligible(np.ones((4, 4)), np.float32, "cuda")
    # the CPU device never takes the scatter: the host densify is its
    # own upload
    assert not dd.device_densify_eligible(sparse_enough, np.float32, "cpu")
    assert dd.device_densify_eligible(sparse_enough, np.float32, "cuda")
    assert dd.device_densify_eligible(sparse_enough, np.float32,
                                      torch.device("cuda", 0))
    assert not dd.device_densify_eligible(too_dense, np.float32, "cuda")
    # the byte rule is the JAX package's
    monkeypatch.setattr("cnmf_tpu.ops.device_densify.jax.default_backend",
                        lambda: "tpu")
    for X in (sparse_enough, too_dense):
        for dtype in (np.float32, np.float64):
            assert (dd.device_densify_eligible(X, dtype, "cuda")
                    == jax_eligible(X, dtype))
    monkeypatch.setenv("CNMF_TPU_DEVICE_DENSIFY", "0")
    assert not dd.device_densify_eligible(sparse_enough, np.float32, "cuda")


def test_to_device_dense_routes():
    """The host route (CPU device, or a dense input) equals the expansion."""
    X = _random_csr(50, 30, 0.2, seed=8)
    got = dd.to_device_dense(X, np.float32, "cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), X.toarray().astype(np.float32))
    D = dd.to_device_dense(X.toarray(), np.float64, "cpu")
    np.testing.assert_array_equal(D.numpy(), X.toarray())
