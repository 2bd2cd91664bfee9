"""The port's device kmeans++ (cnmf_tpu_torch.ops.kmeans.seed_kmeanspp_batch)
against the JAX package's (cnmf_tpu/ops/consensus_fused.py
_seed_kmeanspp_batch), and consensus seeded on the device in both packages
(the verify recipe: 300×400 counts with 6 planted programs, 5 restarts of
K=6, 200 HVGs), on the CPU in float64.

Given one key the centres are equal to JAX's within CENTER_TOL (they are
rows of the points: the same draws pick the same rows). Consensus with
CNMF_TPU_DEVICE_KMEANSPP=force — the one-program consensus of each
package — within SSE 1e-4 for every artifact, as
tests/test_torch_pipeline.py holds consensus."""

import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cnmf_tpu import cNMF as JaxCNMF
from cnmf_tpu.io.dataframe import load_df_from_npz
from cnmf_tpu.ops.consensus_fused import (
    _seed_kmeanspp_batch as jax_seed_kmeanspp_batch,
)
from cnmf_tpu_torch import cNMF as TorchCNMF
from cnmf_tpu_torch.ops import prng
from cnmf_tpu_torch.ops.kmeans import PAD_SENTINEL, seed_kmeanspp_batch
from cnmf_tpu_torch.pipeline import stages
from torch_knobs import (  # noqa: F401 (autouse)
    host_draws_by_default,
    one_torch_thread,
)

CENTER_TOL = 1e-12
SSE_TOL = 1e-4
K = 6
ARTIFACTS = ["consensus_spectra", "consensus_usages", "gene_spectra_tpm",
             "gene_spectra_score", "starcat_spectra"]


@pytest.mark.parametrize("seed", [1, 0, 2**32 - 1])
@pytest.mark.parametrize("n_points, k", [(57, 7), (128, 3), (9, 9)])
def test_seeded_centers_match_jax(seed, n_points, k):
    """Rp = 128 padded rows of which n_points are valid, K padded to 8 (or
    16): the same centres from the same key, sentinel rows past k."""
    rng = np.random.RandomState(n_points)
    Rp, G = 128, 30
    X = rng.rand(Rp, G)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Xp = np.where((np.arange(Rp) < n_points)[:, None], X, 0.0)
    w = (np.arange(Rp) < n_points).astype(np.float64)
    kp = -(-k // 8) * 8
    kw = dict(n_init=10, n_cluster_pad=kp, n_local_trials=2 + int(np.log(k)))
    key = prng.prng_key(seed)
    ours = seed_kmeanspp_batch(torch.as_tensor(Xp), torch.as_tensor(w),
                               n_points, k, key, **kw).numpy()
    theirs = np.asarray(jax_seed_kmeanspp_batch(
        jnp.asarray(Xp), jnp.asarray(w), jnp.int32(n_points), jnp.int32(k),
        jnp.asarray(key.numpy().astype(np.uint32)), **kw))
    assert ours.shape == theirs.shape == (10, kp, G)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=CENTER_TOL)
    assert (ours[:, k:] == PAD_SENTINEL).all()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The verify recipe prepared, factorized and combined by each package
    (host inits: the CPU default)."""
    tmp_path = tmp_path_factory.mktemp("torch_devkmeanspp")
    rng = np.random.RandomState(42)
    W = rng.gamma(0.7, 1.0, size=(300, K))
    H = rng.gamma(0.5, 1.0, size=(K, 400)) * (rng.rand(K, 400) < 0.3)
    X = rng.poisson(W @ H * 2.0).astype(float)
    X[X.sum(axis=1) == 0, 0] = 1
    counts_fn = str(tmp_path / "counts.txt")
    pd.DataFrame(X, index=[f"cell{i}" for i in range(300)],
                 columns=[f"gene{j}" for j in range(400)]).to_csv(
        counts_fn, sep="\t")
    out = {}
    for pkg, make in (("jax", lambda: JaxCNMF(
            output_dir=str(tmp_path / pkg), name="devkpp",
            compute_dtype=np.float64)),
                      ("torch", lambda: TorchCNMF(
            output_dir=str(tmp_path / pkg), name="devkpp",
            compute_dtype=np.float64, device="cpu"))):
        obj = make()
        obj.prepare(counts_fn=counts_fn, components=[K], n_iter=5, seed=14,
                    num_highvar_genes=200)
        obj.factorize(verbose=False)
        obj.combine()
        out[pkg] = obj
    return out


def record_seeding(mp, seeding):
    """Record, for each consensus of the port, whether its KMeans was
    seeded on the device: the one-program consensus seeds there in
    ``fused_consensus_full`` and on the host in ``fused_consensus``; the
    step-by-step path as ``kmeans_fit`` is told."""
    for name, on_device in (("fused_consensus_full", True),
                            ("fused_consensus", False)):
        fn = getattr(stages, name)
        mp.setattr(stages, name, lambda *a, _fn=fn, _dev=on_device, **kw:
                   seeding.append(_dev) or _fn(*a, **kw))
    fit = stages.kmeans_fit
    mp.setattr(stages, "kmeans_fit", lambda *a, **kw: seeding.append(
        kw.get("device_seeding")) or fit(*a, **kw))


@pytest.fixture(scope="module")
def forced(runs):
    """Consensus with the device seeding forced in both packages; the
    port's seedings recorded."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CNMF_TPU_DEVICE_KMEANSPP", "force")
    seeding = []
    record_seeding(mp, seeding)
    try:
        for obj in runs.values():
            obj.consensus(k=K, density_threshold=0.5, show_clustering=False)
    finally:
        mp.undo()
    return {pkg: {name: load_df_from_npz(obj.paths[name] % (K, "0_5"))
                  for name in ARTIFACTS}
            for pkg, obj in runs.items()}, seeding


@pytest.mark.parametrize("artifact", ARTIFACTS)
def test_consensus_device_kmeanspp_matches_jax(forced, artifact):
    arts, seeding = forced
    assert seeding == [True]
    a, b = arts["jax"][artifact], arts["torch"][artifact]
    assert a.shape == b.shape and list(a.index) == list(b.index)
    sse = float(((a.values - b.values) ** 2).sum())
    assert sse < SSE_TOL, f"{artifact}: SSE {sse:.2e}"


def test_zero_survivors_raise_as_in_jax(runs, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_DEVICE_KMEANSPP", "force")
    for obj in runs.values():
        cache_fn = obj.paths["local_density_cache"] % K
        if os.path.isfile(cache_fn):
            os.remove(cache_fn)
        with pytest.raises(RuntimeError, match="Zero components remain"):
            obj.consensus(k=K, density_threshold=1e-9, show_clustering=False)


def test_consensus_default_on_the_cpu_seeds_on_the_host(runs, monkeypatch):
    """Without the knob the CPU consensus keeps the host seeding."""
    monkeypatch.delenv("CNMF_TPU_DEVICE_KMEANSPP", raising=False)
    seeding = []
    record_seeding(monkeypatch, seeding)
    runs["torch"].consensus(k=K, density_threshold=0.5, show_clustering=False)
    assert seeding == [False]
