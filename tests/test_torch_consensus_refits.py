"""The CD recipe's consensus in the port against the JAX package's, from
the same merged spectra (tests/goldens, made by sklearn) on the golden
counts, with the refit tolerance of the run's nmf_idvrun_params.yaml at
1e-4 (the default) and 1e-5, in float64 on the CPU.

Every consensus artifact must agree within SSE 1e-4 (tests/test_golden.py's
contract). The refits stop at their tolerance, and a CD refit's iterates
follow its column order: both packages must hand them the spectra in the
same order, so the port's KMeans must keep the JAX package's labels when
its n_init runs end in the same partition under permuted labels (the tie
goes to the first run)."""

import os

import numpy as np
import pytest
import torch
import yaml

from cnmf_tpu import cNMF as JaxCNMF
from cnmf_tpu.io.dataframe import load_df_from_npz, save_df_to_npz
from cnmf_tpu.ops import kmeans as jax_kmeans
from cnmf_tpu_torch import cNMF as TorchCNMF
from cnmf_tpu_torch.ops import kmeans
from cnmf_tpu_torch.pipeline import stages

from test_torch_pipeline import GOLDEN_DIR, _golden_counts
from torch_knobs import (  # noqa: F401 (autouse)
    host_draws_by_default,
    one_torch_thread,
)

K = 6
SSE_TOL = 1e-4
ARTIFACTS = ["consensus_spectra", "consensus_usages", "gene_spectra_tpm",
             "gene_spectra_score", "starcat_spectra"]
TOLS = [1e-4, 1e-5]


def golden_merged():
    return load_df_from_npz(
        os.path.join(GOLDEN_DIR, f"merged_spectra.k_{K}.df.npz"))


@pytest.fixture(scope="module")
def consensus_by_tol(tmp_path_factory):
    """{tol: {package: {artifact: frame}}}: each package prepares the golden
    counts, takes the golden merged spectra and runs consensus at K=6."""
    root = tmp_path_factory.mktemp("consensus_refits")
    counts_fn = _golden_counts(root)
    out = {}
    for tol in TOLS:
        out[tol] = {}
        for pkg, make in (
                ("jax", lambda d: JaxCNMF(output_dir=str(d), name="g",
                                          compute_dtype=np.float64)),
                ("torch", lambda d: TorchCNMF(output_dir=str(d), name="g",
                                              compute_dtype=np.float64,
                                              device="cpu"))):
            obj = make(root / f"{pkg}_{tol:g}")
            obj.prepare(counts_fn=counts_fn, components=[K], n_iter=10,
                        seed=14, num_highvar_genes=200)
            params_fn = obj.paths["nmf_run_parameters"]
            with open(params_fn) as fh:
                params = yaml.safe_load(fh)
            params["tol"] = tol
            with open(params_fn, "w") as fh:
                yaml.safe_dump(params, fh)
            save_df_to_npz(golden_merged(), obj.paths["merged_spectra"] % K)
            obj.consensus(k=K, density_threshold=0.5, show_clustering=False)
            out[tol][pkg] = {name: load_df_from_npz(obj.paths[name]
                                                    % (K, "0_5"))
                             for name in ARTIFACTS}
    return out


@pytest.mark.parametrize("artifact", ARTIFACTS)
@pytest.mark.parametrize("tol", TOLS)
def test_cd_consensus_matches_jax_at_refit_tol(consensus_by_tol, tol,
                                               artifact):
    a = consensus_by_tol[tol]["jax"][artifact]
    b = consensus_by_tol[tol]["torch"][artifact]
    assert a.shape == b.shape and list(a.index) == list(b.index)
    sse = float(((a.values - b.values) ** 2).sum())
    assert sse < SSE_TOL, f"{artifact} at tol {tol:g}: SSE {sse:.2e}"


def test_kmeans_tied_runs_keep_the_jax_labels():
    """On the golden run's filtered spectra all ten runs end in one
    partition under permuted labels: every run's inertia is the same, and
    the port returns the JAX package's labels."""
    l2 = stages.l2_normalize(golden_merged().values)
    density = stages.spectra_local_density(golden_merged().values, K, "cpu",
                                           torch.float64)
    X = np.ascontiguousarray(l2[density < 0.5])
    labels, _, _ = kmeans.kmeans_fit(torch.as_tensor(X), K)
    labels_j, _, _ = jax_kmeans.kmeans_fit(X, K)
    np.testing.assert_array_equal(labels, labels_j)
    rng = np.random.RandomState(1)
    centers0 = np.stack([kmeans._kmeans_plusplus(X, K, rng)
                         for _ in range(10)])
    tol = 1e-4 * float(np.mean(np.var(X, axis=0)))
    _, inertia, _ = kmeans._lloyd_batched(torch.as_tensor(X),
                                          torch.as_tensor(centers0), tol,
                                          len(X), K, 300)
    assert len(set(inertia.tolist())) == 1
