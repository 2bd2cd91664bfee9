"""The port's public surface against the JAX package's: cNMF's public
methods and the ``ops`` namespace, name by name and parameter by parameter,
the names the port had lacked called with JAX-API arguments, and the stage
timers (tests/test_pipeline_api.py::test_stage_timings_recorded for the
port), on the CPU.

A JAX parameter may be missing from the port only when it is private (a
leading underscore) or a TPU-only keyword (``TPU_ONLY``); a parameter only
the port has must have a default, so that a JAX-API call binds. Values:
float64, the refits within rtol 1e-10 of the JAX package's."""

import inspect

import numpy as np
import pandas as pd
import pytest
import torch

import cnmf_tpu.ops as jax_ops
from cnmf_tpu import cNMF as JaxCNMF
from cnmf_tpu_torch import cNMF
from cnmf_tpu_torch import ops as pt_ops
from cnmf_tpu_torch.io.anndata_lite import AnnData
from cnmf_tpu_torch.utils import timing
from torch_knobs import host_draws_by_default  # noqa: F401 (autouse)

# keywords of the JAX API that select TPU code paths (Pallas kernels, their
# interpret mode, the TPU matmul precision)
TPU_ONLY = {"use_pallas", "interpret", "precision"}
OPS_NAMES = ["nmf_coordinate_descent", "nmf_multiplicative_update",
             "nnls_coordinate_descent", "nnls_multiplicative_update",
             "frobenius_error", "random_init_batch", "nndsvd_init",
             "nnls_w_init"]
TOL = dict(rtol=1e-10, atol=1e-12)


def public_methods(cls):
    return {name for name, value in vars(cls).items()
            if not name.startswith("_") and callable(value)}


def signature_gaps(jax_fn, port_fn):
    """The JAX parameters the port lacks or takes otherwise (kind), and the
    port's own parameters without a default."""
    ours = inspect.signature(port_fn).parameters
    theirs = inspect.signature(jax_fn).parameters
    gaps = [f"{name} ({p.kind.name})" for name, p in theirs.items()
            if not name.startswith("_") and name not in TPU_ONLY
            and (name not in ours or ours[name].kind != p.kind)]
    gaps += [f"{name} without a default" for name, p in ours.items()
             if name not in theirs and p.default is p.empty
             and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    return gaps


def test_cnmf_public_api_matches_jax():
    assert public_methods(cNMF) == public_methods(JaxCNMF)
    gaps = {name: signature_gaps(getattr(JaxCNMF, name), getattr(cNMF, name))
            for name in sorted(public_methods(JaxCNMF)) + ["__init__"]}
    assert not {k: v for k, v in gaps.items() if v}, gaps


def test_ops_namespace_matches_jax():
    exported = {n for n in vars(jax_ops) if not n.startswith("_")
                and callable(getattr(jax_ops, n))}
    assert exported == set(OPS_NAMES)
    assert {n for n in vars(pt_ops) if not n.startswith("_")
            and callable(getattr(pt_ops, n))} == exported
    gaps = {n: signature_gaps(getattr(jax_ops, n), getattr(pt_ops, n))
            for n in OPS_NAMES}
    assert not {k: v for k, v in gaps.items() if v}, gaps


def test_mesh_surface_matches_jax():
    """``cnmf_tpu_torch.parallel.mesh`` has the JAX module's public
    functions, parameter by parameter and with their defaults; the package
    exports what ``cnmf_tpu.parallel`` does; ``cNMF.factorize`` shards by
    default (``use_mesh=True``, as the JAX package), and consensus splits
    the cells over the devices unless ``shard_cells`` is False."""
    import cnmf_tpu.parallel as jax_parallel
    import cnmf_tpu_torch.parallel as pt_parallel
    from cnmf_tpu.parallel import mesh as jax_mesh
    from cnmf_tpu_torch.parallel import mesh as pt_mesh

    names = {n for n, v in vars(jax_mesh).items() if not n.startswith("_")
             and inspect.isfunction(v) and v.__module__ == jax_mesh.__name__}
    assert names == {"build_mesh", "cell_sharding", "put_cells",
                     "pad_to_multiple", "shard_factorize_inputs"}
    gaps = {n: signature_gaps(getattr(jax_mesh, n), getattr(pt_mesh, n))
            for n in names}
    assert not {k: v for k, v in gaps.items() if v}, gaps
    for n in names:
        ours = inspect.signature(getattr(pt_mesh, n)).parameters
        for name, p in inspect.signature(getattr(jax_mesh, n)).parameters.items():
            assert ours[name].default == p.default, (n, name)
    public = {n for n in vars(jax_parallel) if not n.startswith("_")
              and callable(getattr(jax_parallel, n))}
    assert public <= set(vars(pt_parallel)), public
    for cls in (JaxCNMF, cNMF):
        assert inspect.signature(cls.factorize).parameters[
            "use_mesh"].default is True
    assert cNMF.shard_cells is True


def _problem(seed=0, n=60, g=40, k=4):
    rng = np.random.RandomState(seed)
    H = rng.gamma(1.0, 1.0, (k, g))
    X = rng.gamma(1.0, 1.0, (n, k)) @ H + rng.gamma(1.0, 0.1, (n, g))
    return X, H


def test_nnls_solvers_with_jax_arguments():
    """Host arrays go to the card unless ``device`` says otherwise (here
    the CPU); a tensor keeps its own device."""
    for fn in (pt_ops.nnls_coordinate_descent,
               pt_ops.nnls_multiplicative_update):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    X, H = _problem()
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            pt_ops.nnls_coordinate_descent(X, H)
    W, n = pt_ops.nnls_coordinate_descent(X, H, tol=1e-6, max_iter=300,
                                          device="cpu")
    W_j, n_j = jax_ops.nnls_coordinate_descent(X, H, tol=1e-6, max_iter=300)
    assert n == n_j
    np.testing.assert_allclose(W.numpy(), np.asarray(W_j), **TOL)
    W_t, _ = pt_ops.nnls_coordinate_descent(
        torch.from_numpy(X), H, tol=1e-6, max_iter=300)
    assert W_t.device.type == "cpu" and torch.equal(W_t, W)
    W, n = pt_ops.nnls_multiplicative_update(X, H, beta=1.0, max_iter=60,
                                             chunk=8, device="cpu")
    W_j, n_j = jax_ops.nnls_multiplicative_update(X, H, beta=1.0, max_iter=60,
                                                  chunk=8)
    assert n == n_j
    np.testing.assert_allclose(W.numpy(), np.asarray(W_j), **TOL)
    for solver in ("cd", "mu"):
        w = pt_ops.nnls_w_init(X, 4, solver, dtype=np.float64)
        np.testing.assert_allclose(
            w[0].numpy(), jax_ops.nnls_w_init(X, 4, solver, dtype=np.float64),
            rtol=1e-15)


def test_mu_stopping_state_overrides():
    """done0 all true leaves every restart at its start; error_init0 /
    prev_error0 at their defaults reproduce the plain solve."""
    X, H = _problem(1)
    Xt = torch.from_numpy(X)
    W0 = torch.full((2, 60, 4), 0.5, dtype=torch.float64)
    Ht0 = torch.from_numpy(np.stack([H.T, H.T * 1.1]))
    kw = dict(beta=1.0, max_iter=40)
    W, Ht, n_iter = pt_ops.nmf_multiplicative_update(Xt, W0, Ht0, **kw)
    from cnmf_tpu_torch.ops.nmf import beta_divergence_error
    err0 = beta_divergence_error(Xt, W0, Ht0, 1.0)
    W2, Ht2, n2 = pt_ops.nmf_multiplicative_update(
        Xt, W0, Ht0, error_init0=err0, prev_error0=err0, chunk=4, **kw)
    assert torch.equal(W, W2) and torch.equal(Ht, Ht2)
    assert torch.equal(n_iter, n2)
    W3, Ht3, n3 = pt_ops.nmf_multiplicative_update(
        Xt, W0, Ht0, done0=torch.ones(2, dtype=torch.bool), **kw)
    assert torch.equal(W3, W0) and torch.equal(Ht3, Ht0) and not n3.any()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """tests/test_pipeline_api.py's run (150 × 200 counts, K=5 × 6
    restarts, 120 HVGs) through the port, with factorize(use_mesh=True)
    as the JAX API calls it."""
    tmp_path = tmp_path_factory.mktemp("torch_api")
    rng = np.random.RandomState(9)
    W = rng.gamma(0.7, 1.0, size=(150, 5))
    H = rng.gamma(0.5, 1.0, size=(5, 200)) * (rng.rand(5, 200) < 0.35)
    X = rng.poisson(W @ H * 2.0).astype(float)
    X[X.sum(axis=1) == 0, 0] = 1
    df = pd.DataFrame(X, index=[f"c{i}" for i in range(150)],
                      columns=[f"g{j}" for j in range(200)])
    fn = str(tmp_path / "counts.txt")
    df.to_csv(fn, sep="\t")
    timing.reset_timings()
    obj = cNMF(output_dir=str(tmp_path), name="api", device="cpu",
               compute_dtype=np.float64)
    obj.prepare(counts_fn=fn, components=[5], n_iter=6, seed=2,
                num_highvar_genes=120)
    obj.factorize(use_mesh=True, verbose=False)
    obj.combine()
    obj.consensus(k=5, density_threshold=0.5, show_clustering=False)
    obj.counts = df
    return obj


def test_stage_timings_recorded(run):
    t = timing.timings()
    for stage in ["prepare", "factorize", "combine", "consensus",
                  "prepare.load_counts", "prepare.tpm", "prepare.tpm_stats",
                  "prepare.norm_counts", "prepare.write_norm_counts"]:
        assert stage in t and len(t[stage]) >= 1, stage


def test_consensus_prints_sub_stages(run, monkeypatch, capsys):
    """The one-program path (the default) marks the host density and the
    chain; the step-by-step path (CNMF_TPU_FUSED_CONSENSUS=0) each of its
    phases."""
    monkeypatch.setenv("CNMF_TPU_TIMINGS", "1")
    for knob, labels in (("1", ("density", "fused_consensus")),
                         ("0", ("density", "kmeans", "refit_usages",
                                "refit_spectra_tpm", "ols", "final_refit"))):
        monkeypatch.setenv("CNMF_TPU_FUSED_CONSENSUS", knob)
        run.consensus(k=5, density_threshold=0.5, show_clustering=False)
        err = capsys.readouterr().err
        line = [ln for ln in err.splitlines() if "consensus k=5:" in ln]
        assert len(line) == 1, err
        for label in labels:
            assert f" {label} " in line[0], line
        assert "[cnmf-tpu timing] consensus:" in err


def test_profiler_trace_written(run, monkeypatch, tmp_path):
    monkeypatch.setenv("CNMF_TPU_PROFILE_DIR", str(tmp_path))
    run.combine()
    traces = list((tmp_path / "combine").glob("*.pt.trace.json"))
    assert len(traces) == 1, traces


def test_warmup_and_clear_device_caches(run, capsys):
    done = run.warmup(components=[5], verbose=True, parallel=4)
    assert done["native_library"] >= 0   # g++ builds it here
    assert "kernel_library" not in done  # the CPU device builds no kernels
    out = capsys.readouterr().out
    assert "150 x 120" in out and "kept on the device" in out
    run.tpm_device_bytes_limit = 1
    try:
        run.warmup()
    finally:
        del run.tpm_device_bytes_limit
    assert "kept on the host" in capsys.readouterr().out
    assert run.clear_device_caches(host_caches=True) is None


def test_get_norm_counts_with_tpm_moments(run):
    from cnmf_tpu_torch.ops.normalize import normalize_total
    from cnmf_tpu_torch.ops.stats import mean_var

    counts = AnnData(run.counts.values,
                     obs=pd.DataFrame(index=run.counts.index),
                     var=pd.DataFrame(index=run.counts.columns))
    tpm = AnnData(normalize_total(counts.X), obs=counts.obs, var=counts.var)
    plain = run.get_norm_counts(counts, tpm, num_highvar_genes=120)
    given = run.get_norm_counts(counts, tpm, num_highvar_genes=120,
                                tpm_moments=mean_var(tpm.X))
    assert list(given.var.index) == list(plain.var.index)
    np.testing.assert_array_equal(given.X, plain.X)
    ref = JaxCNMF(output_dir=str(run.output_dir), name="api_jax")
    from cnmf_tpu.io.anndata_lite import AnnData as JaxAnnData
    jax_counts = JaxAnnData(counts.X, obs=counts.obs, var=counts.var)
    jax_tpm = JaxAnnData(tpm.X, obs=counts.obs, var=counts.var)
    ref_norm = ref.get_norm_counts(jax_counts, jax_tpm, num_highvar_genes=120,
                                   tpm_moments=mean_var(tpm.X))
    assert list(ref_norm.var.index) == list(given.var.index)
    np.testing.assert_allclose(given.X, ref_norm.X, **TOL)
