"""The port's preprocessing layer (cnmf_tpu_torch.preprocess, simulate,
ops/hvg_seurat, ops/pca) against the JAX package's, on the CPU.

Host code (the simulator, loess, seurat_v3 HVGs, filtering, scaling, the
CITE-seq split, MI feature selection) is the same numpy code in both
packages: results are equal. PCA runs ``torch.linalg.eigh`` of the Gram in
float32: pcs and components within 1e-4 × max, explained variance within
1e-5 relative (in a rank-deficient input, the signal directions; the null
directions are any orthonormal completion, so both are held to the null
convention instead: unit-norm rows, no variance). With Harmony, the HVG list
is the same and the corrected matrix within 5e-4 × max.
"""

import os

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

import cnmf_tpu.io.anndata_lite as jax_ad
import cnmf_tpu.preprocess as jax_pp
import cnmf_tpu_torch.io.anndata_lite as torch_ad
import cnmf_tpu_torch.preprocess as torch_pp
from cnmf_tpu.ops import hvg_seurat as jax_hvg
from cnmf_tpu.ops.pca import pca as jax_pca
from cnmf_tpu.simulate import simulate_counts as jax_simulate
from cnmf_tpu_torch.ops import hvg_seurat as torch_hvg
from cnmf_tpu_torch.ops.pca import pca as torch_pca
from cnmf_tpu_torch.simulate import simulate_counts as torch_simulate
from torch_knobs import one_torch_thread  # noqa: F401 (autouse)

PKGS = {"jax": (jax_ad.AnnData, jax_pp), "torch": (torch_ad.AnnData, torch_pp)}
PCA_ABS = 1e-4
PCA_EV_REL = 1e-5
HARMONY_X_ABS = 5e-4


def batched(pkg, n_per_batch=150, n_genes=120, seed=0, shift_genes=30):
    """tests/test_preprocess.py's two-batch counts, as ``pkg``'s AnnData."""
    AnnData = PKGS[pkg][0]
    rng = np.random.RandomState(seed)
    W = rng.gamma(1.0, 1.0, size=(2 * n_per_batch, 4))
    H = rng.gamma(1.0, 1.0, size=(4, n_genes)) * (rng.rand(4, n_genes) < 0.4)
    lam = W @ H + 0.5
    lam[n_per_batch:, :shift_genes] *= 2.5
    X = rng.poisson(lam).astype(np.float64)
    X[X.sum(axis=1) == 0, 0] = 1
    obs = pd.DataFrame({"batch": ["a"] * n_per_batch + ["b"] * n_per_batch},
                       index=[f"c{i}" for i in range(2 * n_per_batch)])
    var = pd.DataFrame(index=[f"g{j}" for j in range(n_genes)])
    return AnnData(sp.csr_matrix(X), obs=obs, var=var)


def preprocessor(pkg, seed=0):
    if pkg == "jax":
        return jax_pp.Preprocess(random_seed=seed)
    return torch_pp.Preprocess(random_seed=seed, device="cpu")


def dense(X):
    return X.toarray() if sp.issparse(X) else np.asarray(X)


def assert_same_adata(got, want):
    assert got.shape == want.shape
    assert sp.issparse(got.X) == sp.issparse(want.X)
    np.testing.assert_array_equal(dense(got.X), dense(want.X))
    pd.testing.assert_frame_equal(got.obs, want.obs)
    pd.testing.assert_frame_equal(got.var, want.var)


# ----------------------------------------------------------------------
# host code: equal
# ----------------------------------------------------------------------

def test_simulate_counts_equal():
    kw = dict(n_cells=200, n_genes=300, n_identities=4, n_markers_per_program=20,
              seed=5)
    got, got_u, got_s = torch_simulate(**kw)
    want, want_u, want_s = jax_simulate(**kw)
    assert isinstance(got, torch_ad.AnnData)
    assert_same_adata(got, want)
    pd.testing.assert_frame_equal(got_u, want_u)
    pd.testing.assert_frame_equal(got_s, want_s)


def test_loess_fit_equal():
    rng = np.random.RandomState(0)
    x = rng.uniform(-2, 2, 700)
    y = 1.5 + 0.7 * x - 0.3 * x ** 2 + rng.normal(0, 0.05, 700)
    np.testing.assert_array_equal(torch_hvg.loess_fit(x, y, chunk=128),
                                  jax_hvg.loess_fit(x, y, chunk=128))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_seurat_v3_hvgs_equal(sparse):
    rng = np.random.RandomState(1)
    X = rng.poisson(3.0, size=(400, 200)).astype(float)
    X[:, :20] = rng.poisson(6.0, size=(400, 20)) * (rng.rand(400, 20) < 0.5)
    X[:, 25] = 0.0   # a constant gene
    X = sp.csr_matrix(X) if sparse else X
    got = torch_hvg.highly_variable_genes_seurat_v3(X, n_top_genes=25)
    want = jax_hvg.highly_variable_genes_seurat_v3(X, n_top_genes=25)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_filter_adata_equal():
    rng = np.random.RandomState(3)
    X = rng.poisson(5.0, size=(80, 40)).astype(float)
    X[:, 5] = 0.0
    X[:70, 7] = 0.0
    X[4, :] = 0.0
    X[4, 0] = 3
    X[10:20, 30:34] *= 8   # mito-heavy cells
    names = [f"g{j}" for j in range(40)]
    names[9], names[12] = "weird.gene", "other.gene"
    for j in range(30, 34):
        names[j] = f"MT-{j}"
    out = {}
    for pkg, (AnnData, _) in PKGS.items():
        adata = AnnData(sp.csr_matrix(X), var=pd.DataFrame(index=names))
        out[pkg] = preprocessor(pkg).filter_adata(
            adata, filter_mito_thresh=0.3, min_cells_per_gene=10,
            min_counts_per_cell=50, filter_mito_genes=True,
            filter_dot_genes=True)
    assert_same_adata(out["torch"], out["jax"])
    assert not any("." in g or "MT-" in g for g in out["torch"].var.index)


def run_both(make_input, **kwargs):
    out = {}
    for pkg in PKGS:
        out[pkg] = preprocessor(pkg).preprocess_for_cnmf(make_input(pkg),
                                                         **kwargs)
    return out


def assert_same_outputs(out):
    (got_x, got_tp, got_h), (want_x, want_tp, want_h) = out["torch"], out["jax"]
    assert got_h == want_h
    assert_same_adata(got_x, want_x)
    assert_same_adata(got_tp, want_tp)


def test_preprocess_rna_only_equal():
    out = run_both(lambda pkg: batched(pkg), n_top_rna_genes=40)
    assert_same_outputs(out)
    assert len(out["torch"][2]) == 40


def test_preprocess_citeseq_feature_column_equal():
    def make(pkg):
        rna = batched(pkg, n_per_batch=60, n_genes=50)
        adt = np.random.RandomState(2).poisson(40.0, size=(120, 8))
        var = pd.DataFrame(
            {"feature_types": ["Gene Expression"] * 50
             + ["Antibody Capture"] * 8},
            index=list(rna.var.index) + [f"ab{j}" for j in range(8)])
        return PKGS[pkg][0](sp.hstack([rna.X, sp.csr_matrix(adt)]).tocsr(),
                            obs=rna.obs.copy(), var=var)

    out = run_both(make, feature_type_col="feature_types", n_top_rna_genes=20)
    assert_same_outputs(out)
    assert out["torch"][1].shape == (120, 58)


def test_preprocess_list_of_two_equal():
    def make(pkg):
        rna = batched(pkg, n_per_batch=80, n_genes=60)
        adt = PKGS[pkg][0](
            sp.csr_matrix(np.random.RandomState(5).poisson(
                50.0, size=(160, 10)).astype(float)),
            obs=rna.obs.copy(),
            var=pd.DataFrame(index=[f"adt{j}" for j in range(10)]))
        return [rna, adt]

    out = run_both(make, n_top_rna_genes=30)
    assert_same_outputs(out)
    assert list(out["torch"][1].var.index[-10:]) == [f"adt{j}"
                                                     for j in range(10)]


def test_preprocess_exclude_genes_and_saved_outputs_equal(tmp_path):
    """exclude_genes, and the save_output_base files read back."""
    from cnmf_tpu.io.h5ad import read_h5ad as jax_read
    from cnmf_tpu_torch.io.h5ad import read_h5ad as torch_read

    out, saved = {}, {}
    for pkg in PKGS:
        base = str(tmp_path / pkg)
        out[pkg] = preprocessor(pkg).preprocess_for_cnmf(
            batched(pkg, n_per_batch=60, n_genes=50), n_top_rna_genes=20,
            exclude_genes=["g0", "g1", "g2", "nope"], save_output_base=base)
        with open(base + ".Corrected.HVGs.txt") as fh:
            hvgs = fh.read().split("\n")
        saved[pkg] = (torch_read if pkg == "torch" else jax_read)(
            base + ".Corrected.HVG.Varnorm.h5ad"), (
            torch_read if pkg == "torch" else jax_read)(
            base + ".TP10K.h5ad"), hvgs
        assert hvgs == out[pkg][2]
    assert_same_outputs(out)
    assert_same_outputs(saved)
    assert not {"g0", "g1", "g2"} & set(out["torch"][2])
    assert {"g0", "g1", "g2"} <= set(out["torch"][1].var.index)


def test_normalize_librarysize_path_equal():
    out = {}
    for pkg in PKGS:
        out[pkg] = preprocessor(pkg).normalize_batchcorrect(
            batched(pkg, n_per_batch=60, n_genes=50),
            normalize_librarysize=True, n_top_genes=15)
    assert out["torch"][1] == out["jax"][1]
    assert_same_adata(out["torch"][0], out["jax"][0])


def test_select_features_mi_equal():
    pytest.importorskip("sklearn")
    out = {}
    for pkg in PKGS:
        adata = batched(pkg, n_per_batch=60, n_genes=40)
        cluster = (adata.obs["batch"] == "b").astype(int).values
        pp = preprocessor(pkg)
        np.random.seed(11)
        out[pkg] = pp.select_features_MI(adata, cluster, n_top_features=10)
    assert_same_adata(out["torch"], out["jax"])
    assert out["torch"].var["highly_variable"].sum() == 10


def test_quantile_ceiling_equal():
    rng = np.random.RandomState(2)
    S = sp.random(70, 40, density=0.3, random_state=rng, format="csr")
    S.data = rng.gamma(2.0, 1.0, size=S.nnz)
    for X in (S, S.toarray()):
        got = torch_pp.stdscale_quantile_celing(torch_ad.AnnData(X.copy()),
                                                max_value=2.5,
                                                quantile_thresh=0.98)
        want = jax_pp.stdscale_quantile_celing(jax_ad.AnnData(X.copy()),
                                               max_value=2.5,
                                               quantile_thresh=0.98)
        np.testing.assert_array_equal(dense(got.X), dense(want.X))


# ----------------------------------------------------------------------
# PCA (torch eigh) and the Harmony path
# ----------------------------------------------------------------------

def pca_input(shape, rank=None, seed=0):
    rng = np.random.RandomState(seed)
    if rank is not None:
        return rng.standard_normal((shape[0], rank)) @ rng.standard_normal(
            (rank, shape[1]))
    base = rng.standard_normal((shape[0], 12)) * np.linspace(10, 2, 12)
    return (base @ rng.standard_normal((12, shape[1]))
            + 0.01 * rng.standard_normal(shape))


@pytest.mark.parametrize("shape", [(300, 80), (60, 200)],
                         ids=["feature-gram", "row-gram"])
def test_pca_matches_jax(shape):
    X = pca_input(shape)
    got = torch_pca(X, n_comps=8, device="cpu")
    want = jax_pca(X, n_comps=8)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=PCA_ABS * np.abs(w).max())
    np.testing.assert_allclose(got[2], want[2], rtol=PCA_EV_REL)


@pytest.mark.parametrize("shape", [(50, 20), (20, 50)],
                         ids=["feature-gram", "row-gram"])
def test_pca_rank_deficient_matches_jax(shape):
    rank, n_comps = 3, 6
    X = pca_input(shape, rank=rank, seed=2)
    got = torch_pca(X, n_comps=n_comps, device="cpu")
    want = jax_pca(X, n_comps=n_comps)
    np.testing.assert_allclose(got[0][:, :rank], want[0][:, :rank],
                               atol=PCA_ABS * np.abs(want[0]).max())
    np.testing.assert_allclose(got[1][:rank], want[1][:rank],
                               atol=PCA_ABS * np.abs(want[1]).max())
    np.testing.assert_allclose(got[2][:rank], want[2][:rank], rtol=PCA_EV_REL)
    for pcs, comps, ev in (got, want):
        np.testing.assert_allclose(np.linalg.norm(comps, axis=1), 1.0,
                                   rtol=1e-4)
        assert ev[rank:].max() < 1e-6 * ev[0]


def test_pca_clamps_components():
    X = pca_input((30, 12))
    pcs, comps, ev = torch_pca(X, n_comps=50, device="cpu")
    assert pcs.shape == (30, 11) and comps.shape == (11, 12)


@pytest.fixture(scope="module")
def harmony_runs():
    out, pps = {}, {}
    for pkg in PKGS:
        pps[pkg] = preprocessor(pkg)
        out[pkg] = pps[pkg].preprocess_for_cnmf(
            batched(pkg), harmony_vars=["batch"], n_top_rna_genes=60,
            max_iter_harmony=5)
    return out, pps


def test_preprocess_harmony_matches_jax(harmony_runs):
    out, pps = harmony_runs
    (got_x, got_tp, got_h), (want_x, want_tp, want_h) = out["torch"], out["jax"]
    assert got_h == want_h and len(got_h) == 60
    assert got_x.shape == want_x.shape == (300, 60)
    want = dense(want_x.X)
    np.testing.assert_allclose(dense(got_x.X), want,
                               atol=HARMONY_X_ABS * np.abs(want).max())
    assert (dense(got_x.X) >= 0).all()
    np.testing.assert_allclose(got_x.uns["X_pca_harmony"],
                               want_x.uns["X_pca_harmony"],
                               atol=HARMONY_X_ABS * np.abs(
                                   want_x.uns["X_pca_harmony"]).max())
    assert_same_adata(got_tp, want_tp)
    assert set(pps["torch"].timings) == {"hvg", "scaling", "pca", "harmony",
                                         "moe_x"}
    assert pps["torch"].harmony_result.iterations >= 1


def test_preprocess_harmony_reduces_batch_effect(harmony_runs):
    """tests/test_preprocess.py's batch-centroid separation, on the port."""
    out, _ = harmony_runs
    corrected, _, hvgs = out["torch"]
    adata = batched("torch")
    batch = (adata.obs["batch"] == "b").values
    X_hvg = dense(adata.X)[:, adata.var.index.get_indexer(hvgs)]
    X_hvg = X_hvg / X_hvg.std(axis=0, ddof=1)

    def sep(M):
        d = M[batch].mean(0) - M[~batch].mean(0)
        return float(np.linalg.norm(d / (M.std(0) + 1e-9)))

    assert sep(dense(corrected.X)) < 0.7 * sep(X_hvg)


def test_preprocess_defaults_to_the_card():
    import inspect

    pp = torch_pp.Preprocess(random_seed=0)
    assert pp.device.type == "cuda"
    params = inspect.signature(torch_pca).parameters
    assert params["device"].default == "cuda"


def test_preprocess_and_refits_run_without_h5py_or_matplotlib(tmp_path):
    """The route of a machine without h5py and matplotlib: Preprocess with
    Harmony (save_output_base=None) and cNMF's run parameters and refits
    import and run with numpy, scipy, torch, pandas and pyyaml only."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('h5py', 'matplotlib'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np, pandas as pd, scipy.sparse as sp\n"
        "from cnmf_tpu_torch import AnnData, Preprocess, cNMF\n"
        "rng = np.random.RandomState(0)\n"
        "X = rng.poisson(2.0, (120, 60)).astype(np.float32)\n"
        "X[60:, :10] *= 3\n"
        "obs = pd.DataFrame({'b': ['x'] * 60 + ['y'] * 60},\n"
        "                   index=[f'c{i}' for i in range(120)])\n"
        "ad = AnnData(sp.csr_matrix(X), obs=obs,\n"
        "             var=pd.DataFrame(index=[f'g{j}' for j in range(60)]))\n"
        "out, tp, hvgs = Preprocess(0, device='cpu').preprocess_for_cnmf(\n"
        "    ad, harmony_vars='b', n_top_rna_genes=30, max_iter_harmony=2)\n"
        "obj = cNMF(output_dir=sys.argv[1], name='r', device='cpu')\n"
        "obj.save_nmf_iter_params(*obj.get_nmf_iter_params(ks=[3], n_iter=2))\n"
        "u = obj.refit_usage(np.asarray(out.X), rng.gamma(1, 1, (3, 30)))\n"
        "s = obj.refit_spectra(np.asarray(out.X), u)\n"
        "assert u.shape == (120, 3) and s.shape == (3, 30)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('h5py', 'matplotlib', 'jax', 'cnmf_tpu')]\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=repo, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")
