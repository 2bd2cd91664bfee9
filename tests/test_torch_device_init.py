"""The port's device-drawn restart inits and seeded solves against the JAX
package's (cnmf_tpu/ops/init.py random_init_batch_device, cnmf_tpu/
pipeline/solvers.py solve_nmf_batch_ladder_seeded, solve_nmf_sharded_device,
solve_nmf_batch_sharded_seeded), on the CPU in float64 unless stated. The
JAX package runs on its 8 virtual CPU devices (tests/conftest.py); the
port's mesh is a list of "cpu" devices.

The draws are jax.random's to within the normals' ulps (ops.prng), so the
port's inits are within INIT_RTOL of JAX's; solves from them within
SOLVE_TOL with equal sweeps. The port's restart axis is bit-equal to its
one device. End to end (CNMF_TPU_DEVICE_INIT=force in both packages):
merged spectra within MERGED_TOL (max abs over max), consensus artifacts
within SSE 1e-4, as tests/test_torch_pipeline.py holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cnmf_tpu import cNMF as JaxCNMF
from cnmf_tpu.io.dataframe import load_df_from_npz
from cnmf_tpu.ops.init import random_init_batch_device as jax_init
from cnmf_tpu.parallel import mesh as jax_mesh
from cnmf_tpu.pipeline import solvers as jax_solvers
from cnmf_tpu_torch import cNMF as TorchCNMF
from cnmf_tpu_torch.ops.init import random_init_batch_device
from cnmf_tpu_torch.parallel import mesh as pm
from cnmf_tpu_torch.pipeline import solvers, stages

INIT_RTOL = {np.float32: 1e-6, np.float64: 1e-14}
SOLVE_TOL = dict(rtol=1e-9, atol=1e-12)
MERGED_TOL = 1e-6
SSE_TOL = 1e-4
KWARGS = {
    "frobenius": {"solver": "cd", "beta_loss": "frobenius", "tol": 1e-4,
                  "max_iter": 50},
    "kullback-leibler": {"solver": "mu", "beta_loss": "kullback-leibler",
                         "tol": 1e-4, "max_iter": 40},
}


@pytest.fixture()
def force_device_paths(monkeypatch):
    """tests/test_sharded_device.py's fixture, for both packages."""
    monkeypatch.setenv("CNMF_TPU_DEVICE_INIT", "force")
    monkeypatch.setenv("CNMF_TPU_DEVICE_LADDER", "1")


def make_problem(n=70, g=48, b=12, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.gamma(1.0, 1.0, (n, g)) * (rng.rand(n, g) < 0.5) + 0.05
    return X, rng.randint(1, 2**31 - 1, size=b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_random_init_batch_device_matches_jax(dtype):
    seeds = np.array([11, 7, 12345, 7, 2**31 - 2])
    W, Ht = random_init_batch_device(2.5, 60, 40, 5, seeds, pad_k=8,
                                     dtype=dtype, device="cpu")
    Wj, Htj = jax_init(2.5, 60, 40, 5, seeds, pad_k=8, dtype=dtype)
    assert W.dtype == Ht.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    assert W.shape == (5, 60, 8) and Ht.shape == (5, 40, 8)
    assert not W[:, :, 5:].any() and not Ht[:, :, 5:].any()
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=INIT_RTOL[dtype])
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Htj),
                               rtol=INIT_RTOL[dtype])
    # a restart's draw is its seed's alone: the same in any chunk
    assert torch.equal(W[1], W[3]) and torch.equal(Ht[1], Ht[3])
    for chunk in ([1], [2, 3], [4, 0]):
        Wc, Htc = random_init_batch_device(2.5, 60, 40, 5, seeds[chunk],
                                           pad_k=8, dtype=dtype, device="cpu")
        assert torch.equal(Wc, W[chunk]) and torch.equal(Htc, Ht[chunk])


@pytest.mark.parametrize("loss", ["frobenius", "kullback-leibler"])
def test_seeded_ladder_matches_jax(force_device_paths, loss):
    """One device: the port's seeded ladder is its draw then its ladder, bit
    for bit, and matches JAX's fused seeded ladder."""
    X, seeds = make_problem()
    kwargs = KWARGS[loss]
    x_mean = float(X.mean())
    Xt = torch.as_tensor(X)
    spec, n_iter, (ladder, sweeps) = solvers.solve_nmf_batch_ladder_seeded(
        Xt, seeds, x_mean, 5, 8, kwargs)
    W0, Ht0 = random_init_batch_device(x_mean, *X.shape, 5, seeds, pad_k=8,
                                       dtype=np.float64, device="cpu")
    spec_d, n_d, _ = solvers.solve_nmf_batch_ladder(Xt, W0, Ht0, kwargs)
    assert torch.equal(spec, spec_d) and torch.equal(n_iter, n_d)
    assert len(sweeps) == len(ladder)
    spec_j, n_j, _ = jax_solvers.solve_nmf_batch_ladder_seeded(
        jnp.asarray(X), seeds, x_mean, 5, 8, kwargs)
    np.testing.assert_array_equal(n_iter.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(spec.numpy(), np.asarray(spec_j), **SOLVE_TOL)


@pytest.mark.parametrize("loss", ["frobenius", "kullback-leibler"])
def test_restart_axis_seeded_is_one_device_and_matches_jax(
        force_device_paths, loss):
    """12 restarts over 8 restart shards (4 padding restarts) and 5 over 2:
    bit-equal to the port's single-device seeded ladder, within SOLVE_TOL
    of JAX's shard_map program on its mesh."""
    X, seeds = make_problem()
    kwargs = KWARGS[loss]
    x_mean = float(X.mean())
    Xt = torch.as_tensor(X)
    one, n_one, _ = solvers.solve_nmf_batch_ladder_seeded(Xt, seeds, x_mean,
                                                          5, 8, kwargs)
    for n_dev, b in ((8, 12), (2, 5)):
        mesh = pm.build_mesh(["cpu"] * n_dev, cell_axis=1)
        spec, n_iter, (ladder, sweeps) = solvers.solve_nmf_sharded_device(
            mesh, Xt, seeds[:b], x_mean, 5, 8, kwargs)
        assert torch.equal(spec, one[:b]) and torch.equal(n_iter, n_one[:b])
        assert len(sweeps) == len(ladder)
    spec_j, n_j, _ = jax_solvers.solve_nmf_sharded_device(
        jax_mesh.build_mesh(jax.devices()[:8], cell_axis=1), jnp.asarray(X),
        seeds, x_mean, 5, 8, kwargs)
    np.testing.assert_array_equal(n_one.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(one.numpy(), np.asarray(spec_j), **SOLVE_TOL)


@pytest.mark.parametrize("loss", ["frobenius", "kullback-leibler"])
def test_cell_axis_seeded_matches_jax(force_device_paths, loss):
    """Restart 4 × cell 2 with N = 63 (one padded cell): within SOLVE_TOL of
    JAX's GSPMD seeded program, with equal sweeps; the W rows of the padded
    cell are cut off."""
    X, seeds = make_problem(n=63, b=6)
    kwargs = KWARGS[loss]
    x_mean = float(X.mean())
    mesh = pm.build_mesh(["cpu"] * 8, cell_axis=2)
    W, Ht, n_iter = solvers.solve_nmf_batch_sharded_seeded(
        mesh, torch.as_tensor(X), seeds, x_mean, 5, 8, kwargs)
    Wj, Htj, nj = jax_solvers.solve_nmf_batch_sharded_seeded(
        jax_mesh.build_mesh(jax.devices()[:8], cell_axis=2), jnp.asarray(X),
        seeds, x_mean, 5, 8, kwargs)
    assert W.shape == (6, 63, 8)
    np.testing.assert_array_equal(n_iter.numpy(), np.asarray(nj))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Htj), **SOLVE_TOL)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), **SOLVE_TOL)


def test_knob_defaults(monkeypatch):
    """Off on the CPU, on for a CUDA device (no card needed: the device's
    type decides); 'force' on anywhere, '0' off anywhere."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    for name, knob in (("CNMF_TPU_DEVICE_INIT", solvers.device_init_enabled),
                       ("CNMF_TPU_DEVICE_KMEANSPP",
                        solvers.device_kmeanspp_enabled)):
        monkeypatch.delenv(name, raising=False)
        assert not knob(cpu) and knob(cuda)
        monkeypatch.setenv(name, "1")
        assert not knob(cpu) and knob(cuda)
        monkeypatch.setenv(name, "force")
        assert knob(cpu) and knob(cuda)
        monkeypatch.setenv(name, "0")
        assert not knob(cpu) and not knob(cuda)


def test_factorize_k_default_on_the_cpu_is_the_host_draw(monkeypatch):
    """Without the knob the CPU factorize keeps sklearn's host draw bit for
    bit; with 'force' it draws on the device, as device_init=True does."""
    monkeypatch.delenv("CNMF_TPU_DEVICE_INIT", raising=False)
    X, seeds = make_problem(b=4)
    Xt = torch.as_tensor(X)
    kw = KWARGS["frobenius"]
    default = stages.factorize_k(X, Xt, 5, seeds, kw)
    host = stages.factorize_k(X, Xt, 5, seeds, kw, device_init=False)
    drawn = stages.factorize_k(X, Xt, 5, seeds, kw, device_init=True)
    for a, b in zip(default[:2], host[:2]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(default[0], drawn[0])
    monkeypatch.setenv("CNMF_TPU_DEVICE_INIT", "force")
    forced = stages.factorize_k(X, Xt, 5, seeds, kw)
    for a, b in zip(forced[:2], drawn[:2]):
        np.testing.assert_array_equal(a, b)


def test_x_mean_for_init_matches_jax():
    import scipy.sparse as sp

    X, _ = make_problem()
    X32 = X.astype(np.float32)
    for arr in (X32, sp.csr_matrix(X32)):
        assert stages.x_mean_for_init(arr, np.float32) == \
            JaxCNMF._x_mean_for_init(arr, np.float32)


@pytest.fixture(scope="module")
def forced_runs(tmp_path_factory):
    """A small recipe end to end in both packages with the device init
    forced, factorize on one device (the JAX package's 8 virtual devices
    would take its host-init mesh path) and the plain solver (the CPU
    default)."""
    root = tmp_path_factory.mktemp("device_init")
    rng = np.random.RandomState(7)
    W = rng.gamma(0.7, 1.0, size=(200, 5))
    H = rng.gamma(0.5, 1.0, size=(5, 220)) * (rng.rand(5, 220) < 0.35)
    X = rng.poisson(W @ H * 2.0).astype(float)
    X[X.sum(1) == 0, 0] = 1
    pd.DataFrame(X, index=[f"cell{i}" for i in range(200)],
                 columns=[f"gene{j}" for j in range(220)]).to_csv(
        root / "counts.txt", sep="\t")
    mp = pytest.MonkeyPatch()
    mp.setenv("CNMF_TPU_DEVICE_INIT", "force")
    out = {}
    try:
        for pkg, make in (
                ("jax", lambda d: JaxCNMF(output_dir=str(d), name="v",
                                          compute_dtype=np.float64)),
                ("torch", lambda d: TorchCNMF(output_dir=str(d), name="v",
                                              compute_dtype=np.float64,
                                              device="cpu"))):
            obj = make(root / pkg)
            obj.prepare(counts_fn=str(root / "counts.txt"), components=[5],
                        n_iter=8, seed=11, num_highvar_genes=140,
                        max_NMF_iter=200)
            obj.factorize(verbose=False, use_mesh=False)
            obj.combine()
            obj.consensus(k=5, density_threshold=0.5, show_clustering=False)
            out[pkg] = obj
    finally:
        mp.undo()
    return out


def test_forced_device_init_merged_spectra_match_jax(forced_runs):
    a = load_df_from_npz(forced_runs["jax"].paths["merged_spectra"] % 5)
    b = load_df_from_npz(forced_runs["torch"].paths["merged_spectra"] % 5)
    assert list(a.index) == list(b.index)
    assert np.max(np.abs(b.values - a.values)) / np.max(np.abs(a.values)) \
        < MERGED_TOL


@pytest.mark.parametrize("artifact", ["consensus_spectra", "consensus_usages",
                                      "gene_spectra_tpm", "gene_spectra_score",
                                      "starcat_spectra"])
def test_forced_device_init_consensus_matches_jax(forced_runs, artifact):
    a = load_df_from_npz(forced_runs["jax"].paths[artifact] % (5, "0_5"))
    b = load_df_from_npz(forced_runs["torch"].paths[artifact] % (5, "0_5"))
    assert a.shape == b.shape and list(a.index) == list(b.index)
    sse = float(((a.values - b.values) ** 2).sum())
    assert sse < SSE_TOL, f"{artifact}: SSE {sse:.2e}"


@pytest.mark.parametrize("cell_axis", ["1", "2"])
def test_cnmf_factorize_on_a_mesh_takes_the_seeded_solves(
        force_device_paths, tmp_path, monkeypatch, cell_axis):
    """cNMF.factorize over 4 CPU devices with the device init forced: the
    inits are drawn on the device (no host draw) and go to the mesh solver
    the host's inits go to; the restart axis (with the ladder,
    solve_nmf_ladder_sharded) writes the single device's spectra bit for
    bit; restart 2 × cell 2 (solve_nmf_batch_sharded) within SOLVE_TOL."""
    rng = np.random.RandomState(12)
    W = rng.gamma(0.7, 1.0, size=(90, 4))
    H = rng.gamma(0.5, 1.0, size=(4, 120)) * (rng.rand(4, 120) < 0.35)
    X = rng.poisson(W @ H * 2.0).astype(float)
    X[X.sum(axis=1) == 0, 0] = 1
    fn = str(tmp_path / "counts.txt")
    pd.DataFrame(X, index=[f"c{i}" for i in range(90)],
                 columns=[f"g{j}" for j in range(120)]).to_csv(fn, sep="\t")
    cfg = dict(components=[4], n_iter=6, seed=3, num_highvar_genes=80,
               max_NMF_iter=100)
    monkeypatch.setattr(pm, "local_devices", lambda: [torch.device("cpu")] * 4)
    monkeypatch.setattr(solvers, "RESTART_AXIS_WORK", 0)
    monkeypatch.setenv("CNMF_TPU_CELL_AXIS", cell_axis)
    calls = {}

    def spy(name):
        orig = getattr(stages, name)
        monkeypatch.setattr(stages, name, lambda *a, **kw: calls.setdefault(
            name, []).append(1) or orig(*a, **kw))

    name = ("solve_nmf_ladder_sharded" if cell_axis == "1"
            else "solve_nmf_batch_sharded")
    for spied in (name, "draw_restart_factors", "restart_inits"):
        spy(spied)
    runs = {}
    for tag, use_mesh in (("mesh", True), ("one", False)):
        obj = TorchCNMF(output_dir=str(tmp_path), name=tag,
                        compute_dtype=np.float64, device="cpu")
        obj.prepare(counts_fn=fn, **cfg)
        obj.factorize(verbose=False, use_mesh=use_mesh)
        runs[tag] = obj
    assert len(calls.get(name, [])) == 1, f"{name} not taken"
    assert len(calls.get("draw_restart_factors", [])) == 2, calls
    assert "restart_inits" not in calls, "drew on the host"
    for it in range(6):
        a, b = (load_df_from_npz(runs[t].paths["iter_spectra"] % (4, it))
                .values for t in ("mesh", "one"))
        if cell_axis == "1":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **SOLVE_TOL)
