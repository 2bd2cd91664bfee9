"""The port's atlas branch: sparse host matrices through the refits, the OLS
and consensus without a dense copy, against the port's dense path and the
JAX package's sparse path (tests/test_sparse_products.py, minus its mesh
case), on the CPU.

Tolerances: relative SSE ``sum((a - b)²) / sum(b²)``. Float64 refits and OLS
within 1e-12 of the dense path and of the JAX package; a consensus forced
over the TPM device limit within 1e-6 of the resident one in float32 (the
verify skill's "Sparse atlas branch" contract) and within 1e-12 of the JAX
package's forced run in float64; the KL (MU) forced run, which takes the
gene-chunk fallback, within 1e-5 of its resident run, as the JAX test."""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from cnmf_tpu import cNMF as JaxCNMF
from cnmf_tpu.io.anndata_lite import AnnData as JaxAnnData
from cnmf_tpu.io.h5ad import write_h5ad as jax_write_h5ad
from cnmf_tpu.ops.ols import efficient_ols_all_cols as jax_ols
from cnmf_tpu.pipeline.solvers import (
    refit_spectra_transposed as jax_refit_spectra,
    refit_usages as jax_refit_usages,
)
from cnmf_tpu_torch import cNMF
from cnmf_tpu_torch.io.dataframe import load_df_from_npz
from cnmf_tpu_torch.ops import ols as pt_ols
from cnmf_tpu_torch.pipeline import solvers, stages
from torch_knobs import (  # noqa: F401 (autouse)
    host_draws_by_default,
    one_torch_thread,
)

KW = {"solver": "cd", "beta_loss": "frobenius", "tol": 1e-4, "max_iter": 300,
      "alpha_W": 0.0, "l1_ratio": 0.0}
F64_SSE = 1e-12
FORCED_F32_SSE = 1e-6
KL_FORCED_SSE = 1e-5
ON = dict(device="cpu", dtype=np.float64)
ARTIFACTS = ["gene_spectra_tpm", "gene_spectra_score", "consensus_usages"]


def rel_sse(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(((a - b) ** 2).sum()) / max(float((b ** 2).sum()), 1e-300)


def _problem(seed, n=150, g=90, k=4, density=0.25):
    rng = np.random.RandomState(seed)
    X = sp.random(n, g, density=density, random_state=rng, format="csr")
    X.data = rng.gamma(1.0, 2.0, size=X.nnz) + 0.1
    spectra = np.abs(rng.standard_normal((k, g)))
    usages = np.abs(rng.standard_normal((n, k)))
    return X, spectra, usages


def test_refit_usages_sparse_matches_dense_and_jax():
    X, spectra, _ = _problem(0)
    dense = solvers.refit_usages(torch.from_numpy(X.toarray()), spectra, KW)
    sparse = solvers.refit_usages(X, spectra, KW, **ON)
    ref = jax_refit_usages(X, spectra, KW, dtype=np.float64)
    assert rel_sse(sparse, dense) < F64_SSE
    assert rel_sse(sparse, ref) < F64_SSE


def test_refit_usages_sparse_mu_densifies():
    X, spectra, _ = _problem(1)
    kw = dict(KW, solver="mu", beta_loss="kullback-leibler", max_iter=60)
    dense = solvers.refit_usages(torch.from_numpy(X.toarray()), spectra, kw)
    sparse = solvers.refit_usages(X, spectra, kw, **ON)
    ref = jax_refit_usages(X, spectra, kw, dtype=np.float64)
    assert rel_sse(sparse, dense) < F64_SSE
    assert rel_sse(sparse, ref) < F64_SSE


def test_refit_spectra_transposed_sparse_matches_dense_and_jax():
    X, _, usages = _problem(2)
    dense = solvers.refit_spectra_transposed(torch.from_numpy(X.toarray()),
                                             usages, KW)
    sparse = solvers.refit_spectra_transposed(X, usages, KW, **ON)
    ref = jax_refit_spectra(X, usages, KW, dtype=np.float64)
    assert rel_sse(sparse, dense) < F64_SSE
    assert rel_sse(sparse, ref) < F64_SSE
    # both equal the literal transpose trick through refit_usages
    literal = solvers.refit_usages(torch.from_numpy(X.toarray().T.copy()),
                                   np.ascontiguousarray(usages.T), KW)
    assert rel_sse(dense, literal) < F64_SSE
    with pytest.raises(ValueError, match="CD-only"):
        solvers.refit_spectra_transposed(
            X, usages, dict(KW, solver="mu", beta_loss="kullback-leibler"),
            **ON)


@pytest.mark.parametrize("normalize_y", [False, True])
def test_ols_sparse_spmm_matches_dense_and_jax(normalize_y):
    rng = np.random.RandomState(3)
    Y = sp.random(200, 120, density=0.3, random_state=rng, format="csr")
    Y.data = rng.gamma(1.0, 3.0, size=Y.nnz) + 0.5
    U = np.abs(rng.standard_normal((200, 5)))
    on_device = pt_ols.efficient_ols_all_cols(
        U, torch.from_numpy(Y.toarray()), normalize_y=normalize_y)
    host_dense = pt_ols.efficient_ols_all_cols(
        U, Y.toarray(), normalize_y=normalize_y, batch_size=64, **ON)
    sparse = pt_ols.efficient_ols_all_cols(U, Y, normalize_y=normalize_y,
                                           **ON)
    ref = jax_ols(U, Y, normalize_y=normalize_y, dtype=np.float64)
    for got in (host_dense, sparse, ref):
        assert rel_sse(got, on_device) < F64_SSE
    assert rel_sse(sparse, ref) < F64_SSE


def test_ols_sparse_multiblock_matches_single(monkeypatch):
    """Several accumulation blocks (and a float32 input that is cast per
    block) against the one-block result (rtol 1e-10 in f64, 2e-5 for the
    float32 data, as the JAX test)."""
    rng = np.random.RandomState(11)
    Y = sp.random(300, 80, density=0.25, random_state=rng, format="csr")
    Y.data = rng.gamma(1.0, 2.0, size=Y.nnz) + 0.5
    U = np.abs(rng.standard_normal((300, 6)))
    ref = pt_ols.efficient_ols_all_cols(U, Y, normalize_y=True, **ON)
    monkeypatch.setattr(pt_ols, "SPMM_BLOCK_NNZ", 500)   # about 12 blocks
    got = pt_ols.efficient_ols_all_cols(U, Y, normalize_y=True, **ON)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
    got32 = pt_ols.efficient_ols_all_cols(U, Y.astype(np.float32),
                                          normalize_y=True, **ON)
    np.testing.assert_allclose(got32, ref, rtol=2e-5, atol=1e-7)


def _sparse_counts(seed, n, g, k, fill):
    rng = np.random.RandomState(seed)
    W = rng.gamma(0.7, 1.0, size=(n, k))
    H = rng.gamma(0.5, 1.0, size=(k, g)) * (rng.rand(k, g) < fill)
    X = rng.poisson(W @ H * 2.0).astype(np.float64)
    X[X.sum(axis=1) == 0, 0] = 1
    return sp.csr_matrix(X)


def _write_counts(path, X):
    jax_write_h5ad(str(path), JaxAnnData(
        X, obs=pd.DataFrame(index=[f"c{i}" for i in range(X.shape[0])]),
        var=pd.DataFrame(index=[f"g{j}" for j in range(X.shape[1])])))
    return str(path)


def _consensus(obj, k, forced):
    """consensus at density threshold 2.0, resident or forced over the TPM
    device limit; returns the three artifacts."""
    obj.tpm_device_bytes_limit = 1 if forced else None
    try:
        obj.consensus(k=k, density_threshold=2.0, show_clustering=False)
    finally:
        del obj.tpm_device_bytes_limit
    return {key: load_df_from_npz(obj.paths[key] % (k, "2_0")).values
            for key in ARTIFACTS}


@pytest.fixture(scope="module")
def atlas_runs(tmp_path_factory):
    """The CD recipe of tests/test_sparse_products.py (160 × 240 sparse
    counts, K=5 × 6 restarts, 150 HVGs): the port in float32 resident and
    forced, the port and the JAX package in float64 forced."""
    root = tmp_path_factory.mktemp("torch_sparse_products")
    fn = _write_counts(root / "c.h5ad", _sparse_counts(9, 160, 240, 5, 0.3))
    out = {"tpm kinds": []}
    consensus_arrays = stages.consensus_arrays

    def spy(merged, k, norm_counts, tpm, *args, **kwargs):
        out["tpm kinds"].append(type(tpm).__name__)
        return consensus_arrays(merged, k, norm_counts, tpm, *args, **kwargs)

    patch = pytest.MonkeyPatch.context()
    with patch as mp:
        mp.setattr(stages, "consensus_arrays", spy)
        _run_three(root, fn, out)
    return out


def _run_three(root, fn, out):
    for tag, make in (
        ("f32", lambda: cNMF(output_dir=str(root), name="f32", device="cpu")),
        ("f64", lambda: cNMF(output_dir=str(root), name="f64", device="cpu",
                             compute_dtype=np.float64)),
        ("jax", lambda: JaxCNMF(output_dir=str(root), name="jax",
                                compute_dtype=np.float64)),
    ):
        obj = make()
        obj.prepare(counts_fn=fn, components=[5], n_iter=6, seed=7,
                    num_highvar_genes=150)
        obj.factorize(verbose=False)
        obj.combine()
        if tag == "f32":
            out["resident"] = _consensus(obj, 5, forced=False)
        out[tag] = _consensus(obj, 5, forced=True)


def _atlas_recipe(n_cells, n_genes, k_true=12, seed=11, h_density=0.08):
    """extras/atlas_validate.synthesize's counts (planted gamma programs, a
    sparse program mask, a base rate, Poisson) as a CSR matrix."""
    rng = np.random.RandomState(seed)
    W = rng.gamma(0.5, 1.0, size=(n_cells, k_true))
    H = (rng.gamma(0.45, 1.0, size=(k_true, n_genes))
         * (rng.rand(k_true, n_genes) < h_density))
    base = rng.gamma(0.3, 0.02, size=(n_genes,))
    X = rng.poisson(W @ H + base).astype(np.float64)
    X[X.sum(axis=1) == 0, 0] = 1
    return sp.csr_matrix(X)


def test_atlas_recipe_factorize_from_csr_matches_jax():
    """The atlas factorize on a subsample of its recipe (2,000 cells ×
    2,000 genes, 200 HVGs, K=12 padded to 16, 4 restarts, the run's
    max_iter 1000 and tol 1e-4), float64: the port's factorize from the
    normalized CSR (inits read from the CSR) stops each restart at the JAX
    package's sweep and gives its spectra within 1e-12 relative SSE."""
    import jax.numpy as jnp
    from cnmf_tpu.ops.init import random_init_batch as jax_random_init
    from cnmf_tpu.pipeline.solvers import solve_nmf_batch as jax_solve

    prep = stages.prepare_arrays(_atlas_recipe(2000, 2000), 200)
    assert sp.issparse(prep.norm)
    kw = stages.nmf_run_params()
    _, seeds = stages.replicate_seeds([12], 4, 14)
    norm = torch.from_numpy(prep.norm.toarray())
    spectra, n_iter, _ = stages.factorize_k(prep.norm, norm, 12, seeds, kw)
    W0, Ht0 = jax_random_init(norm.numpy(), 12, seeds, dtype=np.float64)
    _, Ht_j, n_j = jax_solve(jnp.asarray(norm.numpy()), jnp.asarray(W0),
                             jnp.asarray(Ht0), kw, allow_pallas=False)
    np.testing.assert_array_equal(n_iter, np.asarray(n_j))
    assert rel_sse(spectra, np.asarray(Ht_j).transpose(0, 2, 1)) < F64_SSE


@pytest.mark.parametrize("artifact", ARTIFACTS)
def test_consensus_forced_matches_resident_and_jax(atlas_runs, artifact):
    # the port's three consensus calls: resident, then forced twice
    assert atlas_runs["tpm kinds"] == ["Tensor", "csr_matrix", "csr_matrix"]
    assert rel_sse(atlas_runs["f32"][artifact],
                   atlas_runs["resident"][artifact]) < FORCED_F32_SSE
    assert rel_sse(atlas_runs["f64"][artifact],
                   atlas_runs["jax"][artifact]) < F64_SSE


def test_consensus_sparse_atlas_kl_takes_gene_chunks(tmp_path, monkeypatch):
    """KL (MU) consensus over the limit cannot take the CD products: its
    spectra refit goes in gene chunks (each chunk natively densified) and
    reproduces the resident artifacts."""
    fn = _write_counts(tmp_path / "ckl.h5ad", _sparse_counts(13, 80, 120, 4,
                                                             0.35))
    obj = cNMF(output_dir=str(tmp_path), name="skl", device="cpu")
    obj.prepare(counts_fn=fn, components=[4], n_iter=4, seed=3,
                num_highvar_genes=80, beta_loss="kullback-leibler",
                max_NMF_iter=120)
    obj.factorize(verbose=False)
    obj.combine()
    resident = _consensus(obj, 4, forced=False)
    chunks = []
    densify = stages.densify_csr
    monkeypatch.setattr(stages, "densify_csr",
                        lambda X, **kw: chunks.append(X.shape) or
                        densify(X, **kw))
    forced = _consensus(obj, 4, forced=True)
    # one chunk holding every TPM gene, as (genes × cells)
    assert chunks[0] == (120, 80), chunks
    for key in ("gene_spectra_tpm", "consensus_usages"):
        assert rel_sse(forced[key], resident[key]) < KL_FORCED_SSE, key


def test_tpm_device_limit_on_the_cpu():
    """Off a CUDA card the limit is the JAX package's off-TPU 4e9 bytes; an
    override wins, and 1 sends any TPM to the host branch."""
    assert stages.tpm_device_limit("cpu") == 4e9
    assert stages.tpm_device_limit("cpu", override=123) == 123
    assert stages.tpm_fits_device((1000, 999_999), "cpu")
    assert not stages.tpm_fits_device((1000, 1_000_000), "cpu")
    assert not stages.tpm_fits_device((2, 2), "cpu", override=1)


@pytest.mark.parametrize("loss", ["frobenius", "kullback-leibler"])
def test_cnmf_refits_and_nmf_take_sparse_x(tmp_path, loss):
    """cNMF.refit_usage / refit_spectra / _nmf on a CSR X (CD: host-SpMM
    products; MU: a native densify) equal the same calls on X dense."""
    X, spectra, usages = _problem(5)
    obj = cNMF(output_dir=str(tmp_path), name="rf", device="cpu",
               compute_dtype=np.float64)
    obj.save_nmf_iter_params(*obj.get_nmf_iter_params(
        ks=[4], n_iter=2, random_state_seed=3, beta_loss=loss,
        max_iter=200))
    pairs = [
        (obj.refit_usage(X, spectra), obj.refit_usage(X.toarray(), spectra)),
        (obj.refit_spectra(X, usages),
         obj.refit_spectra(X.toarray(), usages)),
    ]
    kwargs = dict(obj._load_run_params(), n_components=4, random_state=3)
    pairs.append((obj._nmf(X, kwargs)[1], obj._nmf(X.toarray(), kwargs)[1]))
    for sparse, dense in pairs:
        assert rel_sse(sparse, dense) < F64_SSE
