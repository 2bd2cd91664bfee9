"""The port's NNDSVD inits and the cNMF methods beside factorize
(cnmf_tpu_torch) against the JAX package's, on the CPU.

* ``_randomized_topk_svd`` and ``nndsvd_init`` (nndsvd, nndsvda, nndsvdar ×
  float32 / float64 × dense / CSR): bit-equal, the same host code;
* a run prepared with ``init="nndsvd"``, factorized by each package (CD and
  KL, float64): per-restart spectra within 1e-6 relative to the largest;
* ``_nmf``, ``refit_usage`` and ``refit_spectra`` (float64): within 1e-8
  relative to the largest value; ``factorize_multi_process`` runs the whole
  grid and prints the JAX package's line for ignored workers.
"""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

from cnmf_tpu import cNMF as JaxCNMF
from cnmf_tpu.io.dataframe import load_df_from_npz
from cnmf_tpu.ops import init as jinit
from cnmf_tpu_torch import cNMF as TorchCNMF
from cnmf_tpu_torch.ops import init as tinit
from torch_knobs import (  # noqa: F401 (autouse)
    host_draws_by_default,
    one_torch_thread,
)

VARIANTS = ["nndsvd", "nndsvda", "nndsvdar"]
FACTORIZE_REL = 1e-6
API_REL = 1e-8


def counts(n_cells=120, n_genes=90, k=4, seed=3):
    rng = np.random.RandomState(seed)
    W = rng.gamma(0.7, 1.0, size=(n_cells, k))
    H = rng.gamma(0.5, 1.0, size=(k, n_genes)) * (rng.rand(k, n_genes) < 0.4)
    X = rng.poisson(W @ H * 2.0).astype(np.float64)
    X[X.sum(axis=1) == 0, 0] = 1
    return X


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ----------------------------------------------------------------------
# the inits: bit-equal
# ----------------------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_nndsvd_init_bit_equal(variant, dtype, sparse):
    X = counts().astype(dtype)
    X = sp.csr_matrix(X) if sparse else X
    for seed in (1, 12345):
        W_t, H_t = tinit.nndsvd_init(X, 5, dtype=dtype, variant=variant,
                                     seed=seed)
        W_j, H_j = jinit.nndsvd_init(X, 5, dtype=dtype, variant=variant,
                                     seed=seed)
        assert W_t.dtype == W_j.dtype == dtype
        np.testing.assert_array_equal(W_t, W_j)
        np.testing.assert_array_equal(H_t, H_j)
        assert (W_t >= 0).all() and (H_t >= 0).all()


@pytest.mark.parametrize("shape", [(120, 90), (60, 150)], ids=["tall", "wide"])
def test_randomized_topk_svd_bit_equal(shape):
    """Both branches of the transpose heuristic, dense and CSR."""
    X = counts(*shape)
    for M in (X, sp.csr_matrix(X), X.astype(np.float32)):
        for got, want in zip(tinit._randomized_topk_svd(M, 6, 7),
                             jinit._randomized_topk_svd(M, 6, 7)):
            np.testing.assert_array_equal(got, want)


def test_nndsvd_batch_stacks_per_seed_inits():
    X = counts()
    W0, Ht0 = tinit.nndsvd_init_batch(X, 4, [3, 9], variant="nndsvda",
                                      dtype=np.float64)
    assert W0.shape == (2, 120, 4) and Ht0.shape == (2, 90, 4)
    for i, seed in enumerate((3, 9)):
        W, H = jinit.nndsvd_init(X, 4, dtype=np.float64, variant="nndsvda",
                                 seed=seed)
        np.testing.assert_array_equal(W0[i], W)
        np.testing.assert_array_equal(Ht0[i], H.T)


# ----------------------------------------------------------------------
# factorize from nndsvd inits, and the methods beside it
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def counts_file(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_init")
    X = counts(150, 120, k=5, seed=11)
    fn = root / "counts.txt"
    pd.DataFrame(X, index=[f"c{i}" for i in range(X.shape[0])],
                 columns=[f"g{j}" for j in range(X.shape[1])]).to_csv(
        fn, sep="\t")
    return root, str(fn)


def prepared(pkg, root, counts_fn, tag, **kwargs):
    if pkg == "jax":
        obj = JaxCNMF(output_dir=str(root / f"jax{tag}"), name="r",
                      compute_dtype=np.float64)
    else:
        obj = TorchCNMF(output_dir=str(root / f"torch{tag}"), name="r",
                        compute_dtype=np.float64, device="cpu")
    obj.prepare(counts_fn=counts_fn, components=[4, 5], n_iter=3, seed=14,
                num_highvar_genes=80, **kwargs)
    return obj


@pytest.mark.parametrize("beta_loss", ["frobenius", "kullback-leibler"])
def test_factorize_nndsvd_matches_jax(counts_file, beta_loss):
    root, counts_fn = counts_file
    tag = "_" + beta_loss[:2]
    spectra = {}
    for pkg in ("jax", "torch"):
        obj = prepared(pkg, root, counts_fn, tag, init="nndsvd",
                       beta_loss=beta_loss, max_NMF_iter=200)
        obj.factorize(verbose=False) if pkg == "torch" else obj.factorize()
        spectra[pkg] = {
            (k, it): load_df_from_npz(obj.paths["iter_spectra"] % (k, it))
            for k in (4, 5) for it in range(3)}
    for key, want in spectra["jax"].items():
        got = spectra["torch"][key]
        assert list(got.columns) == list(want.columns)
        assert rel(got.values, want.values) < FACTORIZE_REL, key


@pytest.fixture(scope="module")
def api_pair(counts_file):
    root, counts_fn = counts_file
    return {pkg: prepared(pkg, root, counts_fn, "_api")
            for pkg in ("jax", "torch")}


def test_refit_usage_and_spectra_match_jax(api_pair):
    """DataFrame pairs give DataFrames with the JAX package's labels; an
    array or sparse X gives arrays."""
    rng = np.random.RandomState(5)
    X = pd.DataFrame(counts(100, 60, seed=2),
                     index=[f"c{i}" for i in range(100)],
                     columns=[f"g{j}" for j in range(60)])
    spectra = pd.DataFrame(rng.gamma(1.0, 1.0, (5, 60)), index=range(1, 6),
                           columns=X.columns)
    jax_obj, torch_obj = api_pair["jax"], api_pair["torch"]
    want = jax_obj.refit_usage(X, spectra)
    got = torch_obj.refit_usage(X, spectra)
    assert isinstance(got, pd.DataFrame)
    assert got.index.equals(want.index) and got.columns.equals(want.columns)
    assert rel(got.values, want.values) < API_REL
    assert rel(torch_obj.refit_usage(sp.csr_matrix(X.values), spectra.values),
               want.values) < API_REL

    usage = want
    want_s = jax_obj.refit_spectra(X, usage)
    got_s = torch_obj.refit_spectra(X, usage)
    assert isinstance(got_s, pd.DataFrame)
    assert got_s.index.equals(want_s.index)
    assert got_s.columns.equals(want_s.columns)
    assert rel(got_s.values, want_s.values) < API_REL
    got_arr = torch_obj.refit_spectra(sp.csr_matrix(X.values), usage.values)
    assert isinstance(got_arr, np.ndarray)
    assert rel(got_arr, want_s.values) < API_REL


@pytest.mark.parametrize("init", ["random", "nndsvd", "nndsvdar"])
def test_nmf_matches_jax(api_pair, init):
    X = counts(100, 60, seed=8)
    kwargs = dict(api_pair["torch"]._load_run_params(), init=init,
                  n_components=5, random_state=21, max_iter=300)
    spectra_j, usages_j = api_pair["jax"]._nmf(X, dict(kwargs))
    spectra_t, usages_t = api_pair["torch"]._nmf(sp.csr_matrix(X),
                                                 dict(kwargs))
    assert spectra_t.shape == (5, 60) and usages_t.shape == (100, 5)
    assert rel(spectra_t, spectra_j) < API_REL
    assert rel(usages_t, usages_j) < API_REL


def test_nmf_fixed_spectra_matches_jax(api_pair):
    X = counts(100, 60, seed=8)
    H = np.random.RandomState(4).gamma(1.0, 1.0, (5, 60))
    kwargs = dict(api_pair["torch"]._load_run_params(), H=H, update_H=False)
    H_j, usages_j = api_pair["jax"]._nmf(X, dict(kwargs))
    H_t, usages_t = api_pair["torch"]._nmf(X, dict(kwargs))
    np.testing.assert_array_equal(H_t, H_j)
    assert rel(usages_t, usages_j) < API_REL


def test_factorize_multi_process_runs_every_restart(api_pair, capsys):
    obj = api_pair["torch"]
    obj.factorize_multi_process(total_workers=4)
    assert "total_workers=4 ignored" in capsys.readouterr().out
    table = load_df_from_npz(obj.paths["nmf_replicate_parameters"])
    for row in table.itertuples():
        assert load_df_from_npz(
            obj.paths["iter_spectra"] % (row.n_components, row.iter)
        ).shape == (row.n_components, 80)
