"""The port's consensus ops (KNN density, KMeans, z-score OLS) against the JAX
package on the same numpy inputs, in float64 on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnmf_tpu.ops import distance as jax_distance
from cnmf_tpu.ops import kmeans as jax_kmeans
from cnmf_tpu.ops import ols as jax_ols
from cnmf_tpu_torch.ops import distance as pt_distance
from cnmf_tpu_torch.ops import kmeans as pt_kmeans
from cnmf_tpu_torch.ops import ols as pt_ols
from torch_knobs import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-8, atol=1e-8)


def clustered_spectra(n_per=25, k=6, g=50, seed=0):
    """L2-normalized rows scattered around k nonnegative programs, with a few
    outliers (the density filter's targets)."""
    rng = np.random.RandomState(seed)
    centers = rng.gamma(0.5, 1.0, (k, g))
    rows = [c * rng.gamma(20.0, 0.05, (n_per, g)) for c in centers]
    rows.append(rng.gamma(1.0, 1.0, (4, g)))
    X = np.concatenate(rows)
    return X / np.linalg.norm(X, axis=1, keepdims=True)


@pytest.mark.parametrize("n_neighbors", [1, 7, 30])
def test_local_density_matches_jax(n_neighbors):
    l2 = clustered_spectra()
    ref = jax_distance.local_density_from_spectra(l2, n_neighbors)
    ours = pt_distance.local_density_from_spectra(torch.from_numpy(l2),
                                                  n_neighbors)
    np.testing.assert_allclose(ours, ref, **TOL)
    d_ref = np.asarray(jax_distance.pairwise_euclidean(jnp.asarray(l2)))
    d = pt_distance.pairwise_euclidean(torch.from_numpy(l2)).numpy()
    np.testing.assert_allclose(d, d_ref, **TOL)
    assert (np.diag(d) == 0).all()


@pytest.mark.parametrize("k,seed", [(6, 0), (4, 1), (9, 2)])
def test_kmeans_fit_matches_jax(k, seed):
    X = clustered_spectra(seed=seed)
    labels_j, centers_j, inertia_j = jax_kmeans.kmeans_fit(X, k, n_init=10,
                                                           random_state=1)
    labels_p, centers_p, inertia_p = pt_kmeans.kmeans_fit(
        torch.from_numpy(X), k, n_init=10, random_state=1)
    np.testing.assert_array_equal(labels_p, labels_j)
    np.testing.assert_allclose(centers_p, centers_j, **TOL)
    np.testing.assert_allclose(inertia_p, inertia_j, **TOL)


def test_lloyd_relocates_empty_clusters_like_jax():
    """Inits whose far-away centres own no point exercise the empty-cluster
    relocation; every run must match the JAX Lloyd loop."""
    X = clustered_spectra(n_per=10, k=3, seed=3)
    rng = np.random.RandomState(5)
    centers0 = X[rng.choice(len(X), size=(4, 5))].copy()
    centers0[:, 3] = 50.0      # no point is nearest to centre 3
    centers0[1:, 4] = -50.0    # nor to centre 4 (runs 1..3)
    tol = 1e-4 * float(np.mean(np.var(X, axis=0)))
    lab_j, in_j, cen_j = jax_kmeans._lloyd_batched(
        jnp.asarray(X), jnp.asarray(centers0), jnp.asarray(tol),
        np.int32(len(X)), np.int32(5), 300)
    lab_p, in_p, cen_p = pt_kmeans._lloyd_batched(
        torch.from_numpy(X), torch.from_numpy(centers0), tol, len(X), 5, 300)
    np.testing.assert_array_equal(lab_p.numpy(), np.asarray(lab_j))
    np.testing.assert_allclose(cen_p.numpy(), np.asarray(cen_j), **TOL)
    np.testing.assert_allclose(in_p.numpy(), np.asarray(in_j), **TOL)


@pytest.mark.parametrize("normalize_y", [True, False])
def test_efficient_ols_matches_jax(normalize_y):
    rng = np.random.RandomState(7)
    U = np.abs(rng.randn(200, 6))
    Y = rng.gamma(0.5, 100.0, (200, 80)) + 1e3 * (rng.rand(80) < 0.2)
    Y[:, 3] = 5.0   # a zero-variance column (variance floored at 1e-12)
    ref = jax_ols.efficient_ols_all_cols(U, jnp.asarray(Y),
                                         normalize_y=normalize_y,
                                         dtype=np.float64)
    ours = pt_ols.efficient_ols_all_cols(U, torch.from_numpy(Y),
                                         normalize_y=normalize_y)
    assert ours.shape == (6, 80)
    np.testing.assert_allclose(ours, ref, **TOL)
