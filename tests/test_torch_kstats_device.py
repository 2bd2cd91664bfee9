"""The port's k-stats chain and its device-fed variant
(cnmf_tpu_torch.ops.kstats: ``_k_stats_chain``,
``consensus_k_stats_device``) and the padded Lloyd loop
(``ops.kmeans._lloyd_batched``) against the JAX package's, on the same
numpy inputs in float64 on the CPU. The k-stats contract (PERF.md §2):
silhouette within 1e-8 absolute, prediction error within 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_tpu.ops import kmeans as jax_kmeans
from cnmf_tpu.ops import kstats as jax_kstats
from cnmf_tpu_torch.ops import kmeans as pt_kmeans
from cnmf_tpu_torch.ops import kstats as pt_kstats
from cnmf_tpu_torch.pipeline import stages

SIL_ABS = 1e-8
ERR_REL = 1e-6


def planted(k=4, n_spectra=36, seed=11):
    """(normalized counts (60 × 40), raw merged spectra) with k programs."""
    rng = np.random.RandomState(seed)
    H = rng.rand(k, 40) * (rng.rand(k, 40) < 0.6) + 0.01
    raw = np.concatenate([H + 0.05 * rng.rand(k, 40)
                          for _ in range(n_spectra // k)])
    Xnc = rng.gamma(0.7, 1.0, (60, k)) @ H + 0.01 * rng.rand(60, 40)
    return Xnc, raw


def assert_stats(ours, ref):
    sil, sse = (float(v) for v in ours)
    sil_j, sse_j = (float(v) for v in ref)
    assert abs(sil - sil_j) <= SIL_ABS
    assert abs(sse - sse_j) <= ERR_REL * abs(sse_j)


def refit_kw(solver):
    return dict(solver=solver, beta=2.0 if solver == "cd" else 1.0,
                refit_tol=1e-4, refit_max_iter=200,
                l1_reg_W=0.1 if solver == "cd" else 0.0, l2_reg_W=0.0)


@pytest.mark.parametrize("solver", ["cd", "mu"])
def test_k_stats_chain_matches_jax(solver):
    """The chain from given padded points and sentinel seeds: 36 real rows
    of 64, k=5 of 8 cluster slots (one cluster left empty by its seed)."""
    Xnc, raw = planted(k=4)
    l2 = raw / np.linalg.norm(raw, axis=1, keepdims=True)
    R, D = l2.shape
    Xp = np.zeros((64, D))
    Xp[:R] = l2
    rng = np.random.RandomState(3)
    centers0 = np.full((3, 8, D), pt_kmeans.PAD_SENTINEL)
    centers0[:, :5] = l2[rng.choice(R, size=(3, 5))]
    centers0[1, 4] = 40.0          # owns no point: relocated
    tol = 1e-4 * float(np.mean(np.var(l2, axis=0)))
    kw = dict(n_cluster_pad=8, lloyd_max_iter=300, mu_chunk=8,
              use_pallas=False, **refit_kw(solver))
    ref = jax_kstats._fused_k_stats(
        jnp.asarray(Xnc), jnp.asarray(Xp), jnp.asarray(centers0),
        jnp.asarray(tol), np.int32(R), np.int32(5), np.int32(60), **kw)
    ours = pt_kstats._k_stats_chain(
        torch.from_numpy(Xnc), torch.from_numpy(Xp),
        torch.from_numpy(centers0), tol, R, 5, 60, **kw)
    assert_stats(ours, ref)


@pytest.mark.parametrize("solver", ["cd", "mu"])
@pytest.mark.parametrize("k", [3, 4])
def test_consensus_k_stats_device_matches_jax(solver, k):
    """The raw spectra on the device: normalization, padding, tolerance
    scaling and the threefry kmeans++ there, in both packages."""
    Xnc, raw = planted(k=4)
    ref = jax_kstats.consensus_k_stats_device(
        jnp.asarray(Xnc), jnp.asarray(raw), k, **refit_kw(solver))
    ours = pt_kstats.consensus_k_stats_device(
        torch.from_numpy(Xnc), torch.from_numpy(raw), k, **refit_kw(solver))
    assert all(isinstance(v, torch.Tensor) and v.ndim == 0 for v in ours)
    assert_stats(ours, ref)


def test_k_stats_arrays_takes_raw_tensors_and_host_arrays():
    """``stages.k_stats_arrays``: a raw tensor goes through the device-fed
    chain, a host array through the host-seeded one; both match the JAX
    package's functions of the same seeding."""
    Xnc, raw = planted(k=4)
    kwargs = stages.nmf_run_params()
    rows = stages.k_stats_arrays({3: torch.from_numpy(raw), 4: raw},
                                 torch.from_numpy(Xnc), kwargs)
    assert [r[0] for r in rows] == [3, 4]
    kw = dict(solver="cd", beta=2.0, refit_tol=1e-4, refit_max_iter=1000)
    assert_stats(rows[0][2:], jax_kstats.consensus_k_stats_device(
        jnp.asarray(Xnc), jnp.asarray(raw), 3, **kw))
    l2 = raw / np.linalg.norm(raw, axis=1, keepdims=True)
    assert_stats(rows[1][2:], jax_kstats.consensus_k_stats(
        jnp.asarray(Xnc), l2, 4, **kw))


@pytest.mark.parametrize("n_points, n_clusters", [(30, 5), (512, 8)])
def test_padded_lloyd_matches_jax(n_points, n_clusters):
    """Padded points of zero weight and sentinel clusters at +inf; empty
    clusters relocated on the device (runs 1-3 start with two far-away
    centres), each run stopping on its own."""
    rng = np.random.RandomState(n_points)
    X = np.zeros((512, 12))
    X[:n_points] = rng.rand(n_points, 12)
    centers0 = np.full((4, 8, 12), pt_kmeans.PAD_SENTINEL)
    centers0[:, :n_clusters] = X[rng.choice(n_points, (4, n_clusters))]
    centers0[:, n_clusters - 1] = 50.0
    centers0[1:, n_clusters - 2] = -50.0
    tol = 1e-4 * float(np.mean(np.var(X[:n_points], axis=0)))
    ref = jax_kmeans._lloyd_batched(
        jnp.asarray(X), jnp.asarray(centers0), jnp.asarray(tol),
        np.int32(n_points), np.int32(n_clusters), 300)
    ours = pt_kmeans._lloyd_batched(
        torch.from_numpy(X), torch.from_numpy(centers0), tol, n_points,
        n_clusters, 300)
    np.testing.assert_array_equal(ours[0].numpy()[:, :n_points],
                                  np.asarray(ref[0])[:, :n_points])
    for a, b in zip(ours[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)
