"""The port's K-selection ops (cnmf_tpu_torch.ops.kstats, ops.silhouette,
ops.nmf.reconstruction_sse) against the JAX package on the same numpy
inputs, in float64 on the CPU, and the silhouette also against sklearn.

The K-stats chain uses the same kmeans++ seeds, the same Lloyd loop and
the same refit as the JAX package, so silhouettes agree to 1e-10 absolute
and prediction errors to 1e-10 relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnmf_tpu.ops import kstats as jax_kstats
from cnmf_tpu.ops import nmf as jax_nmf
from cnmf_tpu.ops import silhouette as jax_sil
from cnmf_tpu_torch.ops import kstats as pt_kstats
from cnmf_tpu_torch.ops import nmf as pt_nmf
from cnmf_tpu_torch.ops import silhouette as pt_sil
from torch_knobs import one_torch_thread  # noqa: F401 (autouse)

SIL_ABS = 1e-10
SSE_REL = 1e-10


def _labelled(n=237, d=40, k=6, seed=7):
    rng = np.random.RandomState(seed)
    return rng.rand(n, d), rng.randint(0, k, size=n)


@pytest.mark.parametrize("row_chunk", [7, 4096])
def test_reconstruction_sse_matches_jax(row_chunk):
    """Direct row-chunked SSE, a chunk that cuts the rows raggedly and one
    larger than them."""
    rng = np.random.RandomState(0)
    X, W, H = rng.rand(50, 30), rng.rand(50, 4), rng.rand(4, 30)
    ref = float(jax_nmf.reconstruction_sse(jnp.asarray(X), jnp.asarray(W),
                                           jnp.asarray(H), row_chunk=row_chunk))
    ours = float(pt_nmf.reconstruction_sse(torch.from_numpy(X),
                                           torch.from_numpy(W),
                                           torch.from_numpy(H),
                                           row_chunk=row_chunk))
    assert abs(ours - ref) / ref < 1e-13
    assert abs(ours - float(((X - W @ H) ** 2).sum())) / ref < 1e-13


def test_silhouette_matches_jax_and_sklearn():
    from sklearn.metrics import silhouette_score as sk_sil

    X, labels = _labelled()
    ref = sk_sil(X, labels, metric="euclidean")
    ours = pt_sil.silhouette_score(torch.from_numpy(X), labels, 6)
    assert abs(ours - ref) < 1e-9
    assert abs(ours - jax_sil.silhouette_score(X, labels, 6)) < 1e-12
    padded = pt_sil.silhouette_score_padded(X, labels, 6)
    assert abs(padded - ref) < 1e-9
    assert abs(padded - jax_sil.silhouette_score_padded(X, labels, 6)) < 1e-12


def test_silhouette_singletons_and_empty_clusters_match_jax():
    """A singleton cluster scores 0 and an empty cluster slot is masked."""
    X, labels = _labelled(n=40, k=3, seed=1)
    labels[5] = 3          # a singleton; slot 4 stays empty
    dist_p = pt_sil.pairwise_euclidean(torch.from_numpy(X))
    ours = float(pt_sil.silhouette_from_distances(
        dist_p, torch.from_numpy(labels), 5))
    ref = float(jax_sil.silhouette_from_distances(
        jnp.asarray(np.asarray(dist_p)), jnp.asarray(labels), 5))
    assert abs(ours - ref) < 1e-12


@pytest.mark.parametrize("solver,beta", [("cd", 2.0), ("mu", 1.0), ("mu", 0.0)])
@pytest.mark.parametrize("k,n_spectra", [(4, 31), (3, 20)])
def test_consensus_k_stats_matches_jax(solver, beta, k, n_spectra):
    """CD, KL and Itakura-Saito refits; an odd spectra count exercises the
    exact-median branch, an even one the mean of the two central values."""
    rng = np.random.RandomState(11 + k)
    Xnc = rng.rand(60, 40) + 0.01
    spectra = rng.rand(n_spectra, 40) + 0.01
    l2 = spectra / np.linalg.norm(spectra, axis=1, keepdims=True)
    kw = dict(solver=solver, beta=beta, refit_tol=1e-4, refit_max_iter=200,
              l1_reg_W=0.1 if solver == "cd" else 0.0)
    sil_j, sse_j = jax_kstats.consensus_k_stats(jnp.asarray(Xnc), l2, k, **kw)
    sil_p, sse_p = pt_kstats.consensus_k_stats(torch.from_numpy(Xnc), l2, k,
                                               **kw)
    assert abs(sil_p - float(sil_j)) < SIL_ABS
    assert abs(sse_p - float(sse_j)) / float(sse_j) < SSE_REL


def test_cluster_medians_match_jax():
    """pandas groupby-median semantics; an empty cluster gives a zero row."""
    rng = np.random.RandomState(3)
    X = rng.rand(12, 5)
    labels = np.array([0, 0, 1, 1, 1, 0, 2, 0, 1, 2, 0, 1])
    ours = pt_kstats._cluster_medians(
        torch.from_numpy(X), torch.from_numpy(labels),
        torch.ones(12, dtype=torch.bool), 4, 4).numpy()
    ref = np.asarray(jax_kstats._cluster_medians(
        jnp.asarray(X), jnp.asarray(labels), jnp.ones(12, bool), 4, 4))
    np.testing.assert_array_equal(ours, ref)
    assert not ours[3].any()
