"""The port's command line (cnmf_tpu_torch.cli) against the JAX package's
(cnmf_tpu.cli), on the same counts, on the CPU.

``CNMF_TPU_PLATFORM=cpu`` puts the port's stages on the CPU (without it they
run on the CUDA card). Both CLIs run the five subcommands with the same
flags in float32: the same files land in both run directories; the
consensus spectra and usages are within SSE 1e-4 and the TPM, z-score and
starCAT spectra within relative SSE 1e-4 (their TPM units make absolute
squares large); the k-selection silhouettes are within 1e-4. Two workers
reproduce the single-worker spectra within 1e-5 relative.
"""

import os

import numpy as np
import pandas as pd
import pytest

from cnmf_tpu import cli as jax_cli
from cnmf_tpu.io.dataframe import load_df_from_npz
from cnmf_tpu_torch import cli as torch_cli
from torch_knobs import host_draws_by_default  # noqa: F401 (autouse)

SSE_TOL = 1e-4
SIL_ABS = 1e-4
SHARD_REL = 1e-5
CLIS = {"jax": jax_cli, "torch": torch_cli}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def counts_fn(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.RandomState(4)
    W = rng.gamma(0.7, 1.0, size=(120, 4))
    H = rng.gamma(0.5, 1.0, size=(4, 150)) * (rng.rand(4, 150) < 0.35)
    X = rng.poisson(W @ H * 2.0).astype(float)
    X[X.sum(axis=1) == 0, 0] = 1
    df = pd.DataFrame(X, index=[f"c{i}" for i in range(120)],
                      columns=[f"g{j}" for j in range(150)])
    fn = str(tmp / "counts.txt")
    df.to_csv(fn, sep="\t")
    return fn


def drive(cli, out, counts_fn, *extra):
    """The five subcommands: consensus over every K (no -k)."""
    base = ["--output-dir", out, "--name", "run"]
    cli.main(["prepare", *base, "-c", counts_fn, "-k", "4", "5", "-n", "5",
              "--seed", "14", "--numgenes", "100", *extra])
    cli.main(["factorize", *base])
    cli.main(["combine", *base])
    cli.main(["k_selection_plot", *base])
    cli.main(["consensus", *base, "--show-clustering"])
    return os.path.join(out, "run")


@pytest.fixture(scope="module")
def run_dirs(counts_fn, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("CNMF_TPU_PLATFORM", "cpu")
    try:
        return {pkg: drive(cli, str(tmp_path_factory.mktemp(f"cli_{pkg}")),
                           counts_fn)
                for pkg, cli in CLIS.items()}
    finally:
        mp.undo()


def files(run_dir):
    return {os.path.relpath(os.path.join(d, f), run_dir)
            for d, _, fs in os.walk(run_dir) for f in fs}


def test_cli_writes_the_jax_file_set(run_dirs):
    got, want = files(run_dirs["torch"]), files(run_dirs["jax"])
    assert got == want
    for k in (4, 5):
        for fn in (f"run.spectra.k_{k}.dt_0_5.consensus.txt",
                   f"run.usages.k_{k}.dt_0_5.consensus.txt",
                   f"run.starcat_spectra.k_{k}.dt_0_5.txt",
                   f"run.clustering.k_{k}.dt_0_5.png"):
            assert fn in got, fn
    assert {"run.k_selection.png", "run.k_selection_stats.df.npz",
            "run.overdispersed_genes.txt"} <= got


@pytest.mark.parametrize("k", [4, 5])
def test_cli_consensus_matches_jax(run_dirs, k):
    def load(pkg, key):
        return load_df_from_npz(os.path.join(
            run_dirs[pkg], "cnmf_tmp", f"run.{key}.k_{k}.dt_0_5"
            + (".consensus" if key in ("spectra", "usages") else "")
            + ".df.npz"))

    for key in ("spectra", "usages"):
        got, want = load("torch", key), load("jax", key)
        assert got.index.equals(want.index) and got.columns.equals(
            want.columns)
        assert float(((got.values - want.values) ** 2).sum()) < SSE_TOL, key
    for key in ("gene_spectra_tpm", "gene_spectra_score", "starcat_spectra"):
        got, want = load("torch", key).values, load("jax", key).values
        assert float(((got - want) ** 2).sum() / (want ** 2).sum()) \
            < SSE_TOL, key


def test_cli_k_selection_matches_jax(run_dirs):
    got, want = (load_df_from_npz(os.path.join(
        run_dirs[pkg], "run.k_selection_stats.df.npz"))
        for pkg in ("torch", "jax"))
    np.testing.assert_array_equal(got["k"], want["k"])
    np.testing.assert_allclose(got["silhouette"], want["silhouette"],
                               atol=SIL_ABS)
    np.testing.assert_allclose(got["prediction_error"],
                               want["prediction_error"], rtol=1e-4)


def test_cli_worker_sharding(counts_fn, tmp_path):
    """Two workers, then combine: the single worker's merged spectra."""
    merged = {}
    for workers in (1, 2):
        out = str(tmp_path / f"w{workers}")
        base = ["--output-dir", out, "--name", "w"]
        torch_cli.main(["prepare", *base, "-c", counts_fn, "-k", "4", "-n",
                        "4", "--seed", "3", "--numgenes", "80"])
        for i in range(workers):
            torch_cli.main(["factorize", *base, "--worker-index", str(i),
                            "--total-workers", str(workers)])
        torch_cli.main(["combine", *base])
        merged[workers] = load_df_from_npz(os.path.join(
            out, "w", "cnmf_tmp", "w.spectra.k_4.merged.df.npz"))
    assert merged[2].shape == (4 * 4, 80)
    assert list(merged[2].index[:4]) == [f"iter0_topic{t}" for t in range(1, 5)]
    np.testing.assert_allclose(
        merged[2].values, merged[1].values,
        atol=SHARD_REL * np.abs(merged[1].values).max())


def test_cli_nndsvd_init(counts_fn, tmp_path):
    base = ["--output-dir", str(tmp_path), "--name", "n"]
    torch_cli.main(["prepare", *base, "-c", counts_fn, "-k", "4", "-n", "2",
                    "--seed", "3", "--numgenes", "80", "--init", "nndsvd"])
    torch_cli.main(["factorize", *base])
    spectra = load_df_from_npz(os.path.join(
        str(tmp_path), "n", "cnmf_tmp", "n.spectra.k_4.iter_1.df.npz"))
    assert spectra.shape == (4, 80) and np.isfinite(spectra.values).all()


def test_cli_rejects_unknown_command():
    with pytest.raises(SystemExit):
        torch_cli.main(["frobnicate"])


def test_cli_warmup_calls_cnmf_warmup(tmp_path, capsys, monkeypatch):
    """``warmup`` calls cNMF.warmup with the command's components and
    prints what it returns, as the JAX CLI does; on the CPU that is the
    native library's build alone (no kernel library to build)."""
    from cnmf_tpu_torch.pipeline.cnmf import cNMF

    base = ["--output-dir", str(tmp_path), "--name", "x"]
    torch_cli.main(["warmup", *base])
    out = capsys.readouterr().out
    assert "nothing to do" not in out
    assert "warmup: {'native_library': " in out and "kernel_library" not in out
    calls = []

    def spy(self, components=None, verbose=True, parallel=4):
        calls.append((self.device.type, components))
        return {"kernel_library": 1.25}

    monkeypatch.setattr(cNMF, "warmup", spy)
    torch_cli.main(["warmup", *base, "-k", "5", "7"])
    assert calls == [("cpu", [5, 7])]
    assert "warmup: {'kernel_library': 1.25}" in capsys.readouterr().out


def test_autowarm_noop_on_cpu_and_wired(counts_fn, tmp_path, monkeypatch):
    """The autowarm (tests/test_warmup.py::test_autowarm_sweep_noop_on_cpu_
    and_wired for the port): factorize and k_selection_plot each call
    ``_autowarm`` once, before their work; on the CPU it starts no build.
    On a CUDA device it starts ``kernel_lib.start_build`` (once per process:
    that function's own guard), and CNMF_TPU_AUTOWARM=0 opts out."""
    import torch

    from cnmf_tpu_torch.ops import kernel_lib
    from cnmf_tpu_torch.pipeline.cnmf import cNMF

    builds = []
    monkeypatch.setattr(kernel_lib, "start_build",
                        lambda: builds.append(1))
    obj = cNMF(output_dir=str(tmp_path), name="aw", device="cpu")
    obj.prepare(counts_fn=counts_fn, components=[4, 5], n_iter=3, seed=2,
                num_highvar_genes=40)
    calls = []
    orig = obj._autowarm
    monkeypatch.setattr(obj, "_autowarm", lambda: (calls.append(1),
                                                   orig()))
    obj.factorize(verbose=False, use_mesh=False)
    assert len(calls) == 1
    obj.combine()
    obj.k_selection_plot(close_fig=True)
    assert len(calls) == 2 and builds == []
    obj.device = torch.device("cuda")   # no tensor is made: the gate alone
    monkeypatch.setenv("CNMF_TPU_AUTOWARM", "0")
    obj._autowarm()
    assert builds == []
    monkeypatch.delenv("CNMF_TPU_AUTOWARM")
    obj._autowarm()
    cNMF(output_dir=str(tmp_path), name="aw2", device="cuda")._autowarm()
    assert builds == [1, 1]


def test_failed_background_build_raises_at_first_load(monkeypatch):
    """A build the autowarm started and that failed is not hidden: every
    ``load_library`` call raises its very error, and the build's start and
    end are recorded."""
    from cnmf_tpu_torch.ops import kernel_lib

    failure = RuntimeError("nvcc failed: csrc/x.cu")

    def broken():
        raise failure

    kernel_lib.load_library.cache_clear()   # nothing loads on the CPU
    monkeypatch.setattr(kernel_lib, "_WARM", {})
    monkeypatch.setattr(kernel_lib, "_load_library", broken)
    build = kernel_lib.start_build()
    assert kernel_lib.start_build() is build
    for _ in range(2):
        with pytest.raises(RuntimeError) as info:
            kernel_lib.load_library()
        assert info.value is failure
    started, ended = kernel_lib.warm_times()
    assert started <= ended


def test_cli_device_follows_the_platform_knob(monkeypatch):
    assert torch_cli.cli_device() == "cpu"
    monkeypatch.delenv("CNMF_TPU_PLATFORM")
    assert torch_cli.cli_device() == "cuda"
    monkeypatch.setenv("CNMF_TPU_PLATFORM", "tpu")
    assert torch_cli.cli_device() == "cuda"
    assert torch_cli.build_parser().prog == "cnmf-tpu-torch"
    jax_flags = {a.dest: (a.default, a.help) for a in
                 jax_cli.build_parser()._actions}
    ours = {a.dest: (a.default, a.help) for a in
            torch_cli.build_parser()._actions}
    assert ours == jax_flags
