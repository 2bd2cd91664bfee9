"""The port's one-program consensus (cnmf_tpu_torch.ops.consensus_fused)
against the JAX package's (cnmf_tpu.ops.consensus_fused) on the same numpy
inputs, and against the port's step-by-step consensus, in float64 on the
CPU.

Both packages seed the same kmeans++ centres (host: the RandomState stream;
device: the threefry key) and run the same chain, so the labels are
identical and every artifact agrees within the JAX package's own
fused-against-step-by-step bound (tests/test_consensus_options.py: rtol
1e-6, atol 1e-8 of the artifact's largest value); the KNN densities within
1e-12 of the largest density (a distance between two close spectra comes
from a cancelling gram-trick sum, whose rounding follows the matmul's
order)."""

import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cnmf_tpu.ops import consensus_fused as jax_fused
from cnmf_tpu_torch import cNMF as TorchCNMF
from cnmf_tpu_torch.io.dataframe import load_df_from_npz, save_df_to_npz
from cnmf_tpu_torch.ops import consensus_fused as pt_fused
from cnmf_tpu_torch.parallel.mesh import split_rows
from cnmf_tpu_torch.pipeline import stages
from torch_knobs import host_draws_by_default  # noqa: F401 (autouse)

RTOL, ATOL_REL = 1e-6, 1e-8
DENSITY_REL = 1e-12
K = 5
ARTIFACTS = ["consensus_spectra", "consensus_usages", "gene_spectra_tpm",
             "gene_spectra_score"]


def assert_close(ours, ref, name=""):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL_REL * scale,
                               err_msg=name)


@pytest.fixture(scope="module")
def data():
    """Planted programs: TPM (cells × all genes), 40 HVGs scaled to unit
    variance, and 8 noisy restarts of the K programs as merged spectra."""
    rng = np.random.RandomState(0)
    n, g_all, g = 120, 90, 40
    W = rng.gamma(0.7, 1.0, (n, K))
    H = rng.gamma(0.5, 1.0, (K, g_all)) * (rng.rand(K, g_all) < 0.4)
    counts = rng.poisson(W @ H * 3).astype(float)
    counts[counts.sum(axis=1) == 0, 0] = 1
    tpm = counts / counts.sum(axis=1, keepdims=True) * 1e6
    hvg = np.sort(rng.choice(np.flatnonzero(tpm.std(axis=0) > 0), g,
                             replace=False))
    Xnc = tpm[:, hvg] / tpm[:, hvg].std(axis=0, ddof=1)
    raw = np.concatenate([H[:, hvg] + 0.05 * rng.rand(K, g)
                          for _ in range(8)])
    l2 = raw / np.linalg.norm(raw, axis=1, keepdims=True)
    return dict(Xnc=Xnc, tpm=tpm, hvg=hvg, raw=raw, l2=l2,
                std=tpm.std(axis=0), n=n,
                n_neighbors=int(0.3 * raw.shape[0] / K))


def assert_density_close(ours, ref):
    ref = np.asarray(ref)
    assert np.abs(ours - ref).max() <= DENSITY_REL * np.abs(ref).max()


def kwargs(solver):
    return dict(solver=solver, beta=2.0 if solver == "cd" else 1.0,
                tol=1e-4, max_iter=200)


def port_args(d):
    return (torch.from_numpy(d["Xnc"]), torch.from_numpy(d["tpm"]))


def jax_args(d):
    return (jnp.asarray(d["Xnc"]), jnp.asarray(d["tpm"]))


@pytest.mark.parametrize("solver", ["cd", "mu"])
def test_fused_consensus_matches_jax(data, solver):
    """Host kmeans++ seeding, then the chain: CD and the KL solver."""
    d = data
    rest = (d["l2"], K, d["std"], d["hvg"], d["n"])
    ref = jax_fused.fused_consensus(*jax_args(d), *rest, **kwargs(solver))
    ours = pt_fused.fused_consensus(*port_args(d), *rest, **kwargs(solver))
    np.testing.assert_array_equal(ours[0], np.asarray(ref[0]))
    for i, (a, b) in enumerate(zip(ours[1:], ref[1:])):
        assert a.shape == np.asarray(b).shape
        assert_close(a, b, f"output {i + 1}")


@pytest.fixture(scope="module")
def full_results(data):
    """The whole chain in both packages, density computed in it."""
    d = data
    rest = (d["l2"], K, d["std"], d["hvg"], d["n"])
    kw = dict(density_threshold=0.5, n_neighbors=d["n_neighbors"],
              **kwargs("cd"))
    return (pt_fused.fused_consensus_full(*port_args(d), *rest, **kw),
            jax_fused.fused_consensus_full(*jax_args(d), *rest, **kw), kw)


def test_fused_consensus_full_matches_jax(full_results):
    ours, ref, _ = full_results
    assert_density_close(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    for i, (a, b) in enumerate(zip(ours[2:], ref[2:])):
        assert_close(a, b, f"output {i + 2}")


def test_fused_full_raw_tensor_matches_host_l2(data, full_results):
    """The raw merged spectra as a tensor: L2 normalization and padding on
    the device give the host-normalized input's results."""
    d = data
    ours, _, kw = full_results
    raw = pt_fused.fused_consensus_full(
        *port_args(d), torch.from_numpy(d["raw"]), K, d["std"], d["hvg"],
        d["n"], **kw)
    assert_density_close(raw[0], ours[0])
    np.testing.assert_array_equal(raw[1], ours[1])
    for i, (a, b) in enumerate(zip(raw[2:], ours[2:])):
        assert_close(a, b, f"output {i + 2}")


def test_fused_full_cached_density_f32_borderline(data):
    """A cached f64 density just under the threshold whose float32 rounding
    reaches the (rounded) threshold must be kept, as the host's f64 filter
    keeps it: the labels line up with the host's kept rows."""
    d = data
    Xnc, tpm = (torch.from_numpy(d[name]).float() for name in ("Xnc", "tpm"))
    thresh = 0.30000001
    R = d["l2"].shape[0]
    dens = np.full(R, 0.1)
    dens[3] = thresh - 1e-12
    assert np.float32(dens[3]) >= np.float32(thresh)
    dens[7] = 0.9                   # dropped by both
    out = pt_fused.fused_consensus_full(
        Xnc, tpm, d["l2"].astype(np.float32), K, d["std"], d["hvg"], d["n"],
        density_threshold=thresh, n_neighbors=d["n_neighbors"],
        cached_density=dens, **kwargs("cd"))
    assert len(out[1]) == int((dens < thresh).sum()) == R - 1
    # the borderline value enters nudged under the float32 threshold
    others = np.arange(R) != 3
    np.testing.assert_array_equal(out[0][others],
                                  dens.astype(np.float32)[others])
    assert out[0][3] < np.float32(thresh)
    assert out[2].shape[0] == K and np.isfinite(out[6]).all()


def test_fused_full_zero_survivors_raise(data):
    d = data
    with pytest.raises(RuntimeError, match="Zero components remain"):
        pt_fused.fused_consensus_full(
            *port_args(d), d["l2"], K, d["std"], d["hvg"], d["n"],
            density_threshold=1e-9, n_neighbors=d["n_neighbors"],
            **kwargs("cd"))


@pytest.mark.parametrize("solver", ["cd", "mu"])
def test_fused_on_cell_shards_matches_one_device(data, solver):
    """The normalized counts and the TPM as three row shards (the last
    padded with zero rows): the chain sums over shards, the padded rows
    neutral, and gives the single-device artifacts."""
    d = data
    devices = [torch.device("cpu")] * 3
    assert d["n"] % 3 == 0
    rows = d["n"] - 1      # 119 real rows: 40 a shard, one padded
    kw = dict(kwargs(solver), max_iter=50)
    sharded = pt_fused.fused_consensus(
        split_rows(d["Xnc"][:rows], devices), split_rows(d["tpm"][:rows],
                                                         devices),
        d["l2"], K, d["std"], d["hvg"], rows, **kw)
    single = pt_fused.fused_consensus(
        torch.from_numpy(d["Xnc"][:rows]), torch.from_numpy(d["tpm"][:rows]),
        d["l2"], K, d["std"], d["hvg"], rows, **kw)
    np.testing.assert_array_equal(sharded[0], single[0])
    for i, (a, b) in enumerate(zip(sharded[1:], single[1:])):
        assert a.shape == b.shape
        assert_close(a, b, f"output {i + 1}")


@pytest.mark.parametrize("full", [False, True])
def test_fused_matches_step_by_step_arrays(data, full):
    """``stages.consensus_arrays`` on the one-program path against its
    step-by-step path on the same inputs, the KMeans seeded on the host
    (``fused_consensus``) or on the device (``fused_consensus_full``)."""
    d = data
    kw = dict(nmf_kwargs=stages.nmf_run_params(), density_threshold=0.5,
              device_kmeanspp=full)
    args = (d["raw"], K, *port_args(d), d["std"], d["hvg"])
    fused = stages.consensus_arrays(*args, fused=True, **kw)
    steps = stages.consensus_arrays(*args, fused=False, **kw)
    np.testing.assert_array_equal(fused.labels, steps.labels)
    np.testing.assert_array_equal(fused.density_filter, steps.density_filter)
    assert_density_close(fused.local_density, steps.local_density)
    for name in ("spectra", "usages", "spectra_tpm", "spectra_score"):
        assert_close(getattr(fused, name), getattr(steps, name), name)


def test_chain_helpers_match_jax(data):
    """The blocked masked column moments and the MU W init on padded rows."""
    rng = np.random.RandomState(2)
    X = rng.rand(37, 4100) * 1e3
    mean = X[:30].mean(axis=0)
    mask = np.arange(37) < 30
    ref = jax_fused._masked_col_sumsq_blocked(jnp.asarray(X),
                                              jnp.asarray(mean),
                                              jnp.asarray(mask)[:, None])
    ours = pt_fused._masked_col_sumsq_blocked(torch.from_numpy(X),
                                              torch.from_numpy(mean),
                                              torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-13)
    ref = jax_fused._mu_w0(jnp.asarray(X), 30, 4100, 5.0, 37, 8, jnp.float64)
    ours = pt_fused._mu_w0(torch.from_numpy(X), 30, 4100, 5.0, 37, 8,
                           torch.float64)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-14)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A small run prepared, factorized and combined by the port (f64)."""
    tmp_path = tmp_path_factory.mktemp("torch_fused")
    rng = np.random.RandomState(5)
    W = rng.gamma(0.7, 1.0, size=(180, 5))
    H = rng.gamma(0.5, 1.0, size=(5, 220)) * (rng.rand(5, 220) < 0.35)
    X = rng.poisson(W @ H * 2.0).astype(float)
    X[X.sum(axis=1) == 0, 0] = 1
    fn = str(tmp_path / "counts.txt")
    pd.DataFrame(X, index=[f"c{i}" for i in range(180)],
                 columns=[f"g{j}" for j in range(220)]).to_csv(fn, sep="\t")
    obj = TorchCNMF(output_dir=str(tmp_path), name="fused",
                    compute_dtype=np.float64, device="cpu")
    obj.prepare(counts_fn=fn, components=[K], n_iter=6, seed=7,
                num_highvar_genes=120)
    obj.factorize(verbose=False)
    obj.combine()
    return obj


@pytest.mark.parametrize("kmeanspp", ["0", "force"])
def test_cnmf_consensus_fused_knob(run, monkeypatch, kmeanspp):
    """``cNMF.consensus`` with CNMF_TPU_FUSED_CONSENSUS at 1 (the one-program
    path: the whole chain where the kmeans++ runs on the device) and at 0
    (step by step): the same artifacts, and the one-program path called
    exactly when the knob is 1."""
    monkeypatch.setenv("CNMF_TPU_DEVICE_KMEANSPP", kmeanspp)
    calls = []
    for name in ("fused_consensus", "fused_consensus_full"):
        fn = getattr(stages, name)
        monkeypatch.setattr(stages, name, lambda *a, _fn=fn, _n=name, **kw:
                            calls.append(_n) or _fn(*a, **kw))
    results = {}
    cache = run.paths["local_density_cache"] % K
    for flag in ("1", "0"):
        monkeypatch.setenv("CNMF_TPU_FUSED_CONSENSUS", flag)
        if os.path.isfile(cache):
            os.remove(cache)
        run.consensus(k=K, density_threshold=1.7, show_clustering=False,
                      build_ref=False)
        assert os.path.isfile(cache)
        results[flag] = {key: load_df_from_npz(run.paths[key] % (K, "1_7"))
                         for key in ARTIFACTS}
    assert calls == ["fused_consensus_full" if kmeanspp == "force"
                     else "fused_consensus"]
    for key in ARTIFACTS:
        a, b = results["1"][key], results["0"][key]
        assert list(a.index) == list(b.index), key
        assert_close(a.values, b.values, key)


def test_cnmf_consensus_zero_survivors_raise_on_the_whole_chain(
        run, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_DEVICE_KMEANSPP", "force")
    cache = run.paths["local_density_cache"] % K
    if os.path.isfile(cache):
        os.remove(cache)
    with pytest.raises(RuntimeError, match="Zero components remain"):
        run.consensus(k=K, density_threshold=1e-9, show_clustering=False)
    # a cached density enters the chain verbatim
    merged = load_df_from_npz(run.paths["merged_spectra"] % K)
    save_df_to_npz(pd.DataFrame(np.full(len(merged), 0.1),
                                columns=["local_density"], index=merged.index),
                   cache)
    run.consensus(k=K, density_threshold=0.2, show_clustering=False,
                  build_ref=False)
    assert load_df_from_npz(run.paths["consensus_usages"] % (K, "0_2")).shape \
        == (180, K)
