"""The port's cNMF (cnmf_tpu_torch) against the JAX package's on one recipe,
against the goldens, and across run directories, in float64 on the CPU.

The recipe is the verify recipe (300×400 counts with 6 planted programs,
components [5, 6], 5 restarts, 200 HVGs, consensus k=6 at density threshold
0.5, then k_selection_plot), with the default frobenius loss (CD solver) and
with ``beta_loss="kullback-leibler"`` and ``"itakura-saito"`` (MU solver,
200 iterations at most). Consensus artifacts are compared at SSE < 1e-4
computed as in tests/test_golden.py; merged spectra at 1e-6; the
K-selection table's silhouettes at 1e-8 absolute and prediction errors at
1e-6 relative (the Itakura-Saito refits' errors span many decades)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import yaml

from cnmf_tpu import cNMF as JaxCNMF
from cnmf_tpu.io.dataframe import load_df_from_npz, save_df_to_npz
from cnmf_tpu.simulate import simulate_counts
from cnmf_tpu_torch import cNMF as TorchCNMF
from cnmf_tpu_torch.io.h5ad import read_h5ad, write_h5ad
from cnmf_tpu_torch.pipeline import stages
from torch_knobs import host_draws_by_default  # noqa: F401 (autouse)

NAME = "v"
K = 6
DT = "0_5"
SSE_TOL = 1e-4
MERGED_TOL = 1e-6
SIL_ABS = 1e-8
PRED_ERR_REL = 1e-6
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
CONSENSUS_ARTIFACTS = ["consensus_spectra", "consensus_usages",
                       "gene_spectra_tpm", "gene_spectra_score",
                       "starcat_spectra"]
PREPARE_FILES = ["norm_counts.h5ad", "tpm.h5ad", "tpm_stats.df.npz",
                 "nmf_params.df.npz", "nmf_idvrun_params.yaml"]


def sse(a, b):
    return float(((a.values.astype(float) - b.values.astype(float)) ** 2).sum())


def make(pkg, out_dir):
    if pkg == "jax":
        return JaxCNMF(output_dir=str(out_dir), name=NAME,
                       compute_dtype=np.float64)
    return TorchCNMF(output_dir=str(out_dir), name=NAME,
                     compute_dtype=np.float64, device="cpu")


def finish(obj):
    obj.factorize(verbose=False)
    obj.combine()
    obj.consensus(k=K, density_threshold=0.5, show_clustering=False)
    return obj


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipeline")
    rng = np.random.RandomState(42)
    W = rng.gamma(0.7, 1.0, size=(300, 6))
    H = rng.gamma(0.5, 1.0, size=(6, 400)) * (rng.rand(6, 400) < 0.3)
    X = rng.poisson(W @ H * 2.0).astype(float)
    X[X.sum(1) == 0, 0] = 1
    pd.DataFrame(X, index=[f"cell{i}" for i in range(300)],
                 columns=[f"gene{j}" for j in range(400)]).to_csv(
        root / "counts.txt", sep="\t")
    return root


def run_recipe(workdir, tag, **prepare_kwargs):
    """The recipe through each package end to end, k-selection included."""
    out = {}
    for pkg in ("jax", "torch"):
        obj = make(pkg, workdir / f"{pkg}{tag}")
        obj.prepare(counts_fn=str(workdir / "counts.txt"), components=[5, 6],
                    n_iter=5, seed=14, num_highvar_genes=200, **prepare_kwargs)
        out[pkg] = finish(obj)
        obj.k_selection_plot(close_fig=True)
    return out


@pytest.fixture(scope="module")
def runs(workdir):
    return run_recipe(workdir, "")


@pytest.fixture(scope="module")
def kl_runs(workdir):
    return run_recipe(workdir, "_kl", beta_loss="kullback-leibler",
                      max_NMF_iter=200)


@pytest.fixture(scope="module")
def is_runs(workdir):
    return run_recipe(workdir, "_is", beta_loss="itakura-saito",
                      max_NMF_iter=200)


RECIPES = {"frobenius": "runs", "kullback-leibler": "kl_runs",
           "itakura-saito": "is_runs"}


@pytest.fixture(scope="module")
def crossed(workdir, runs):
    """Each package finishes (factorize → consensus) from a run directory the
    other package prepared; then the preparing package runs
    k_selection_plot on the directory the other one factorized."""
    out = {}
    for prep_pkg, fin_pkg in (("jax", "torch"), ("torch", "jax")):
        dst = workdir / f"{prep_pkg}_prepared"
        os.makedirs(dst / NAME / "cnmf_tmp")
        src = runs[prep_pkg].paths
        for f in PREPARE_FILES:
            shutil.copy(os.path.join(os.path.dirname(src["tpm"]), f"{NAME}.{f}"),
                        dst / NAME / "cnmf_tmp")
        shutil.copy(src["nmf_genes_list"], dst / NAME)
        out[prep_pkg] = finish(make(fin_pkg, dst))
        make(prep_pkg, dst).k_selection_plot(close_fig=True)
    return out


def _listing(obj):
    top = os.path.join(obj.output_dir, NAME)
    return sorted(os.listdir(top)), sorted(os.listdir(os.path.join(top, "cnmf_tmp")))


def test_same_artifact_files(runs):
    assert _listing(runs["torch"]) == _listing(runs["jax"])


def assert_prepare_match(jp, tp):
    with open(jp["nmf_genes_list"]) as a, open(tp["nmf_genes_list"]) as b:
        assert a.read() == b.read()
    for key in ("tpm_stats", "nmf_replicate_parameters"):
        a, b = load_df_from_npz(jp[key]), load_df_from_npz(tp[key])
        assert list(a.index) == list(b.index) and list(a.columns) == list(b.columns)
        np.testing.assert_allclose(b.values.astype(float),
                                   a.values.astype(float), rtol=1e-12)
    with open(jp["nmf_run_parameters"]) as a, open(tp["nmf_run_parameters"]) as b:
        assert yaml.safe_load(a) == yaml.safe_load(b)
    na, nb = read_h5ad(jp["normalized_counts"]), read_h5ad(tp["normalized_counts"])
    assert list(na.var.index) == list(nb.var.index)
    np.testing.assert_allclose(nb.X, na.X, rtol=1e-12)


def test_prepare_artifacts_match(runs):
    assert_prepare_match(runs["jax"].paths, runs["torch"].paths)


@pytest.mark.parametrize("given", ["genes_file", "tpm_reordered"])
def test_prepare_with_given_genes_or_tpm_matches_jax(workdir, runs, given,
                                                    tmp_path):
    """prepare with a user HVG list (its order kept) or a precomputed TPM
    whose genes are in another order than the counts' (HVGs matched by
    name) writes what the JAX package writes."""
    counts_fn = str(workdir / "counts.txt")
    if given == "genes_file":
        with open(runs["jax"].paths["nmf_genes_list"]) as fh:
            hvgs = fh.read().split("\n")[::-1][:150]
        (tmp_path / "genes.txt").write_text("\n".join(hvgs))
        extra = dict(genes_file=str(tmp_path / "genes.txt"))
    else:
        counts = pd.read_csv(counts_fn, sep="\t", index_col=0)
        tpm = counts.div(counts.sum(axis=1), axis=0) * 1e6
        tpm[tpm.columns[::-1]].to_csv(tmp_path / "tpm.txt", sep="\t")
        extra = dict(tpm_fn=str(tmp_path / "tpm.txt"))
    objs = {}
    for pkg in ("jax", "torch"):
        objs[pkg] = make(pkg, tmp_path / pkg)
        objs[pkg].prepare(counts_fn=counts_fn, components=[5, 6], n_iter=5,
                          seed=14, num_highvar_genes=200, **extra)
    assert_prepare_match(objs["jax"].paths, objs["torch"].paths)
    if given == "genes_file":
        with open(objs["torch"].paths["nmf_genes_list"]) as fh:
            assert fh.read().split("\n") == hvgs


def assert_merged_match(runs, k):
    a = load_df_from_npz(runs["jax"].paths["merged_spectra"] % k)
    b = load_df_from_npz(runs["torch"].paths["merged_spectra"] % k)
    assert list(a.index) == list(b.index)
    assert list(a.columns) == list(b.columns)
    assert np.max(np.abs(b.values - a.values)) / np.max(np.abs(a.values)) \
        < MERGED_TOL


def assert_artifact_match(runs, artifact):
    a = load_df_from_npz(runs["jax"].paths[artifact] % (K, DT))
    b = load_df_from_npz(runs["torch"].paths[artifact] % (K, DT))
    assert a.shape == b.shape and list(a.index) == list(b.index)
    assert sse(a, b) < SSE_TOL, f"{artifact}: SSE {sse(a, b):.2e}"


@pytest.mark.parametrize("k", [5, 6])
def test_merged_spectra_match(runs, k):
    assert_merged_match(runs, k)


@pytest.mark.parametrize("artifact", CONSENSUS_ARTIFACTS)
def test_consensus_artifacts_match_jax(runs, artifact):
    assert_artifact_match(runs, artifact)


@pytest.mark.parametrize("k", [5, 6])
def test_kl_merged_spectra_match(kl_runs, k):
    assert_merged_match(kl_runs, k)


@pytest.mark.parametrize("artifact", CONSENSUS_ARTIFACTS)
def test_kl_consensus_artifacts_match_jax(kl_runs, artifact):
    assert_artifact_match(kl_runs, artifact)


def test_kl_run_persists_mu_kwargs(kl_runs):
    """The KL run's persisted kwargs select the MU solver, and the port reads
    back what it wrote."""
    kw = kl_runs["torch"]._load_run_params()
    assert kw["solver"] == "mu" and kw["beta_loss"] == "kullback-leibler"
    assert kw["max_iter"] == 200


@pytest.mark.parametrize("k", [5, 6])
def test_is_merged_spectra_match(is_runs, k):
    assert_merged_match(is_runs, k)


@pytest.mark.parametrize("artifact", CONSENSUS_ARTIFACTS)
def test_is_consensus_artifacts_match_jax(is_runs, artifact):
    assert_artifact_match(is_runs, artifact)


def assert_k_stats_match(ref_obj, obj):
    a = load_df_from_npz(ref_obj.paths["k_selection_stats"])
    b = load_df_from_npz(obj.paths["k_selection_stats"])
    assert list(b.columns) == list(a.columns) == [
        "k", "local_density_threshold", "silhouette", "prediction_error"]
    assert list(b.index) == list(a.index)
    np.testing.assert_array_equal(b[["k", "local_density_threshold"]].values,
                                  a[["k", "local_density_threshold"]].values)
    np.testing.assert_allclose(b.silhouette.values, a.silhouette.values,
                               rtol=0, atol=SIL_ABS)
    np.testing.assert_allclose(b.prediction_error.values,
                               a.prediction_error.values, rtol=PRED_ERR_REL)
    assert os.path.getsize(obj.paths["k_selection_plot"]) > 0
    return b


@pytest.mark.parametrize("loss", list(RECIPES))
def test_k_selection_stats_match_jax(request, loss):
    recipe = request.getfixturevalue(RECIPES[loss])
    stats = assert_k_stats_match(recipe["jax"], recipe["torch"])
    assert list(stats.k) == [5, 6]
    assert np.isfinite(stats.values).all()


def test_k_selection_silhouette_peaks_at_planted_k(runs):
    stats = load_df_from_npz(runs["torch"].paths["k_selection_stats"])
    assert stats.k[stats.silhouette.idxmax()] == K


@pytest.mark.parametrize("prepared_by", ["jax", "torch"])
def test_k_selection_on_crossed_directories(runs, crossed, prepared_by):
    """k_selection_plot on a directory the other package factorized agrees
    with the JAX package's own run."""
    assert_k_stats_match(runs["jax"], crossed[prepared_by])


@pytest.mark.parametrize("prepared_by", ["jax", "torch"])
@pytest.mark.parametrize("artifact", CONSENSUS_ARTIFACTS)
def test_run_directories_cross_packages(runs, crossed, prepared_by, artifact):
    ref = load_df_from_npz(runs["jax"].paths[artifact] % (K, DT))
    ours = load_df_from_npz(crossed[prepared_by].paths[artifact] % (K, DT))
    assert ours.shape == ref.shape and list(ours.index) == list(ref.index)
    assert sse(ours, ref) < SSE_TOL


def test_load_results_and_usage_rows(runs):
    usage, scores, tpm, top = runs["torch"].load_results(K=K,
                                                         density_threshold=0.5)
    np.testing.assert_allclose(usage.sum(axis=1).values, 1.0, rtol=1e-12)
    assert list(usage.columns) == list(range(1, K + 1))
    assert scores.shape == tpm.shape == (400, K)
    assert top.shape == (100, K)


# ----------------------------------------------------------------------
# consensus options
# ----------------------------------------------------------------------

STATS_REL = 1e-8


def stats_row(obj, **kwargs):
    return obj.consensus(k=K, density_threshold=0.7, show_clustering=False,
                         skip_density_and_return_after_stats=True, **kwargs)


@pytest.mark.parametrize("loss", list(RECIPES))
def test_consensus_stats_row_matches_jax(request, loss):
    """consensus(skip_density_and_return_after_stats=True) returns the
    JAX package's K_STATS_FIELDS row, the threshold as given, and writes
    nothing."""
    recipe = request.getfixturevalue(RECIPES[loss])
    before = _listing(recipe["torch"])
    a, b = stats_row(recipe["jax"]), stats_row(recipe["torch"])
    assert _listing(recipe["torch"]) == before
    assert list(b.index) == list(a.index) == [
        "k", "local_density_threshold", "silhouette", "prediction_error"]
    assert list(b.columns) == list(a.columns) == ["stats"]
    np.testing.assert_array_equal(b.values[:2, 0], [K, 0.7])
    np.testing.assert_allclose(b.values[:, 0].astype(float),
                               a.values[:, 0].astype(float), rtol=STATS_REL,
                               atol=0)


def test_consensus_stats_row_with_given_norm_counts(runs):
    """A given norm_counts gives the row the run directory's file gives."""
    obj = runs["torch"]
    given = read_h5ad(obj.paths["normalized_counts"])
    pd.testing.assert_frame_equal(stats_row(obj, norm_counts=given),
                                  stats_row(obj))


def test_density_cache_saved_before_empty_filter_raises(runs, tmp_path,
                                                        monkeypatch):
    """A threshold that keeps no spectrum raises "Zero components remain"
    after the local density is cached; a rerun at 2.0 reads the cache
    instead of computing the density again."""
    shutil.copytree(os.path.join(runs["torch"].output_dir, NAME),
                    tmp_path / NAME)
    obj = make("torch", tmp_path)
    cache = obj.paths["local_density_cache"] % K
    os.remove(cache)
    calls = []
    density = stages.local_density_from_spectra
    monkeypatch.setattr(stages, "local_density_from_spectra",
                        lambda *a, **kw: calls.append(1) or density(*a, **kw))
    with pytest.raises(RuntimeError, match="Zero components remain"):
        obj.consensus(k=K, density_threshold=0.0, show_clustering=False)
    assert os.path.isfile(cache) and len(calls) == 1
    obj.consensus(k=K, density_threshold=2.0, show_clustering=False)
    assert len(calls) == 1
    np.testing.assert_array_equal(
        load_df_from_npz(cache).values,
        load_df_from_npz(runs["torch"].paths["local_density_cache"] % K).values)
    assert os.path.isfile(obj.paths["consensus_usages"] % (K, "2_0"))


# ----------------------------------------------------------------------
# goldens (the pattern of tests/test_golden.py)
# ----------------------------------------------------------------------

def _golden_counts(tmp_path):
    adata, _, _ = simulate_counts(n_cells=300, n_genes=400, n_identities=5,
                                  n_activities=1, n_markers_per_program=40,
                                  seed=7)
    counts_fn = str(tmp_path / "counts.h5ad")
    write_h5ad(counts_fn, adata)
    return counts_fn


@pytest.fixture(scope="module")
def golden_rerun(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("torch_golden")
    obj = TorchCNMF(output_dir=str(tmp_path), name="rerun",
                    compute_dtype=np.float64, device="cpu")
    obj.prepare(counts_fn=_golden_counts(tmp_path), components=[K], n_iter=10,
                seed=14, num_highvar_genes=200)
    # skip factorize: the golden merged spectra (made by sklearn) go in
    save_df_to_npz(
        load_df_from_npz(os.path.join(GOLDEN_DIR, f"merged_spectra.k_{K}.df.npz")),
        obj.paths["merged_spectra"] % K,
    )
    obj.consensus(k=K, density_threshold=0.5, show_clustering=False)
    return obj


@pytest.mark.parametrize("artifact", CONSENSUS_ARTIFACTS)
def test_consensus_matches_golden(golden_rerun, artifact):
    ours = load_df_from_npz(golden_rerun.paths[artifact] % (K, DT))
    golden = load_df_from_npz(
        os.path.join(GOLDEN_DIR, f"{artifact}.k_{K}.dt_{DT}.df.npz"))
    assert ours.shape == golden.shape
    assert list(ours.index) == list(golden.index)
    assert sse(ours, golden) < SSE_TOL, f"{artifact}: SSE {sse(ours, golden):.2e}"


def test_factorize_reproduces_golden_merged(tmp_path):
    obj = TorchCNMF(output_dir=str(tmp_path), name="live",
                    compute_dtype=np.float64, device="cpu")
    obj.prepare(counts_fn=_golden_counts(tmp_path), components=[K], n_iter=10,
                seed=14, num_highvar_genes=200)
    obj.factorize(verbose=False)
    obj.combine()
    ours = load_df_from_npz(obj.paths["merged_spectra"] % K)
    golden = load_df_from_npz(
        os.path.join(GOLDEN_DIR, f"merged_spectra.k_{K}.df.npz"))
    assert sse(ours, golden) < SSE_TOL


# ----------------------------------------------------------------------
# isolation
# ----------------------------------------------------------------------

def test_port_imports_without_jax():
    """A fresh interpreter that imports the port has neither jax nor the JAX
    package loaded, and full-f32 matmuls (TF32 off)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, cnmf_tpu_torch\n"
        "import cnmf_tpu_torch.pipeline.stages, cnmf_tpu_torch.ops.cd_kernels\n"
        "import cnmf_tpu_torch.ops.mu_kernels, cnmf_tpu_torch.ops.kstats\n"
        "import cnmf_tpu_torch.ops.silhouette\n"
        "import cnmf_tpu_torch.preprocess, cnmf_tpu_torch.harmony\n"
        "import cnmf_tpu_torch.cli, cnmf_tpu_torch.simulate\n"
        "import cnmf_tpu_torch.ops.pca, cnmf_tpu_torch.ops.hvg_seurat\n"
        "import cnmf_tpu_torch.parallel.mesh\n"
        "import cnmf_tpu_torch.parallel.collectives\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'cnmf_tpu' or m.startswith('cnmf_tpu.')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_top_level_exports():
    """The package exports what the JAX package does (cNMF, Preprocess, the
    file layer and its version); the file-layer names are the
    cnmf_tpu_torch.io objects."""
    import cnmf_tpu
    import cnmf_tpu_torch
    import cnmf_tpu_torch.io as tio
    from cnmf_tpu_torch import (  # noqa: F401
        AnnData,
        __version__,
        load_df_from_npz,
        read_h5ad,
        save_df_to_npz,
        save_df_to_text,
        write_h5ad,
    )

    file_layer = ["AnnData", "read_h5ad", "write_h5ad", "save_df_to_npz",
                  "save_df_to_text", "load_df_from_npz"]
    for name in file_layer:
        assert getattr(cnmf_tpu_torch, name) is getattr(tio, name), name
    assert set(cnmf_tpu_torch.__all__) == set(cnmf_tpu.__all__)
    assert __version__ == cnmf_tpu.__version__
    assert cnmf_tpu_torch.cNMF is TorchCNMF
    from cnmf_tpu_torch.preprocess import Preprocess

    assert cnmf_tpu_torch.Preprocess is Preprocess


def test_entry_points_default_to_the_card(workdir):
    """cNMF and Preprocess run on CUDA unless the CPU is asked for; on a
    machine without a CUDA device, factorize raises rather than solving on
    the CPU."""
    import inspect

    import torch

    from cnmf_tpu_torch import Preprocess

    for cls in (TorchCNMF, Preprocess):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    obj = TorchCNMF(output_dir=str(workdir / "default_device"), name=NAME)
    assert obj.device.type == "cuda"
    assert Preprocess(random_seed=0).device.type == "cuda"
    if torch.cuda.is_available():
        return
    obj.prepare(counts_fn=str(workdir / "counts.txt"), components=[5],
                n_iter=2, seed=14, num_highvar_genes=200)
    with pytest.raises((RuntimeError, AssertionError)):
        obj.factorize(verbose=False)
    run_params = load_df_from_npz(obj.paths["nmf_replicate_parameters"])
    assert not any(os.path.exists(obj.paths["iter_spectra"] % (5, it))
                   for it in run_params["iter"])


def test_stages_run_without_file_packages():
    """ops/ and pipeline/stages.py import, and run the four stages on arrays,
    in an interpreter where pandas, yaml, h5py and matplotlib cannot be
    imported: the route a machine without the file layer's packages takes."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "BLOCKED = ('pandas', 'yaml', 'h5py', 'matplotlib')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np, torch\n"
        "from cnmf_tpu_torch.ops import cd_kernels\n"
        "from cnmf_tpu_torch.pipeline import stages\n"
        "rng = np.random.RandomState(0)\n"
        "W = rng.gamma(0.7, 1.0, (80, 3))\n"
        "H = rng.gamma(0.5, 1.0, (3, 120)) * (rng.rand(3, 120) < 0.4)\n"
        "counts = rng.poisson(W @ H * 3.0).astype(float)\n"
        "counts[counts.sum(1) == 0, 0] = 1\n"
        "prep = stages.prepare_arrays(counts, num_highvar_genes=60)\n"
        "X = np.ascontiguousarray(prep.norm)\n"
        "kw = stages.nmf_run_params(max_iter=200)\n"
        "_, seeds = stages.replicate_seeds([3], 4, 14)\n"
        "spectra, n_iter, _ = stages.factorize_k(X, torch.as_tensor(X), 3, seeds, kw)\n"
        "merged = stages.combine_arrays(list(spectra))\n"
        "res = stages.consensus_arrays(merged, 3, torch.as_tensor(X),\n"
        "    torch.as_tensor(np.asarray(prep.tpm)), prep.tpm_std, prep.hvg_idx,\n"
        "    kw, density_threshold=2.0)\n"
        "assert res.usages.shape == (80, 3) and np.isfinite(res.usages).all()\n"
        "assert res.spectra_tpm.shape == (3, 120)\n"
        "rows = stages.k_stats_arrays({3: merged}, torch.as_tensor(X), kw)\n"
        "assert [r[:2] for r in rows] == [(3, 0.5)]\n"
        "assert np.isfinite(rows[0][2:]).all()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
