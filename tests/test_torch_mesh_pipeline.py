"""The port's cNMF on a mesh of CPU devices against its own single-device
runs and against the JAX package's cNMF on its 8 virtual CPU devices
(tests/conftest.py). The port's devices come from a monkeypatched
``parallel.mesh.local_devices``; ``cpu_mesh`` also sets
``solvers.RESTART_AXIS_WORK`` to 0, so that factorize takes the restart
axis at these sizes.

Tolerances: the sharded consensus (84 cells over 8 shards, as
tests/test_sharding.py::test_consensus_sharded_matches_replicated) within
1e-9 of the replicated run and of JAX's sharded run, in float64;
``use_mesh=True`` on one device bit-equal to ``use_mesh=False``, the
restart axis too, the cell axis within 1e-9. The whole slice against JAX's
mesh is tests/test_torch_mesh_slice.py."""

import numpy as np
import pandas as pd
import pytest
import torch

from cnmf_tpu import cNMF as JaxCNMF
from cnmf_tpu.io.dataframe import load_df_from_npz
from cnmf_tpu_torch import cNMF
from cnmf_tpu_torch.parallel import mesh as pm
from cnmf_tpu_torch.pipeline import solvers
from torch_knobs import host_draws_by_default  # noqa: F401 (autouse)

TOL = dict(rtol=1e-9, atol=1e-12)
ARTIFACTS = ["consensus_spectra", "consensus_usages", "gene_spectra_tpm",
             "gene_spectra_score"]


def planted_counts(n, g, k, seed):
    """tests/test_sharding.py:_planted_counts."""
    rng = np.random.RandomState(seed)
    X = rng.poisson(
        rng.gamma(0.7, 1.0, (n, k))
        @ (rng.gamma(0.5, 1.0, (k, g)) * (rng.rand(k, g) < 0.4)) + 0.2
    ).astype(float)
    X[X.sum(axis=1) == 0, 0] = 1
    return X


def write_counts(path, X):
    pd.DataFrame(X, index=[f"c{i}" for i in range(X.shape[0])],
                 columns=[f"g{j}" for j in range(X.shape[1])]).to_csv(
        path, sep="\t")
    return str(path)


def cpu_mesh(monkeypatch, n, restart_axis_work=0):
    monkeypatch.setattr(pm, "local_devices",
                        lambda: [torch.device("cpu")] * n)
    monkeypatch.setattr(solvers, "RESTART_AXIS_WORK", restart_axis_work)


def artifacts(obj, k, dt="0_5"):
    return {key: load_df_from_npz(obj.paths[key] % (k, dt)).values
            for key in ARTIFACTS}


@pytest.mark.parametrize("beta_loss", ["frobenius", "kullback-leibler"])
def test_consensus_sharded_matches_replicated_and_jax(tmp_path, monkeypatch,
                                                      beta_loss):
    """84 cells (not a multiple of 8) over 8 shards: the refits, the z-score
    OLS, the final refit and the k-stats on row shards against the same run
    on one device and against the JAX package's cell-sharded consensus of
    the same run directory."""
    fn = write_counts(tmp_path / "counts.txt", planted_counts(84, 150, 4, 11))
    cpu_mesh(monkeypatch, 8)
    name = f"cons_{beta_loss[:4]}"
    obj = cNMF(output_dir=str(tmp_path), name=name, compute_dtype=np.float64,
               device="cpu")
    obj.prepare(counts_fn=fn, components=[4], n_iter=8, seed=5,
                num_highvar_genes=80, beta_loss=beta_loss, max_NMF_iter=300)
    obj.factorize(verbose=False)
    obj.combine()

    results = {}
    for mode in ("replicated", "sharded", "jax"):
        if mode == "jax":
            run = JaxCNMF(output_dir=str(tmp_path), name=name,
                          compute_dtype=np.float64)
        else:
            run = cNMF(output_dir=str(tmp_path), name=name,
                       compute_dtype=np.float64, device="cpu")
            run.shard_cells = mode == "sharded"
        stats = run.consensus(k=4, skip_density_and_return_after_stats=True,
                              show_clustering=False)
        run.consensus(k=4, density_threshold=0.5, show_clustering=False,
                      build_ref=False)
        results[mode] = artifacts(run, 4)
        results[mode]["stats"] = stats.values.astype(float)
    for other in ("replicated", "jax"):
        for key, value in results["sharded"].items():
            np.testing.assert_allclose(value, results[other][key], **TOL,
                                       err_msg=f"{key} vs {other}")


def test_use_mesh_on_one_device_is_the_single_device_path(tmp_path,
                                                          monkeypatch, capsys):
    """With one local device, factorize(use_mesh=True) (the default) writes
    the bits of use_mesh=False; on 4 devices the restart axis keeps them
    too on the CPU, and a restart 2 × cell 2 mesh (CNMF_TPU_CELL_AXIS=2,
    N = 61: one padding row) comes within 1e-9. With the restart axis'
    gate as it ships (solvers.restart_axis_pays), 4 devices solve this
    small K on one device."""
    fn = write_counts(tmp_path / "counts.txt", planted_counts(61, 90, 3, 4))
    spectra, printed = {}, {}
    for label, n_dev, use_mesh, work in (
            ("off", 1, False, 0), ("one", 1, True, 0), ("four", 4, True, 0),
            ("gated", 4, True, solvers.RESTART_AXIS_WORK),
            ("cell", 4, True, 0)):
        cpu_mesh(monkeypatch, n_dev, restart_axis_work=work)
        monkeypatch.setenv("CNMF_TPU_CELL_AXIS", "2" if label == "cell"
                           else "1")
        obj = cNMF(output_dir=str(tmp_path), name=label,
                   compute_dtype=np.float64, device="cpu")
        obj.prepare(counts_fn=fn, components=[3], n_iter=6, seed=2,
                    num_highvar_genes=50)
        capsys.readouterr()
        obj.factorize(use_mesh=use_mesh)
        printed[label] = capsys.readouterr().out
        spectra[label] = [load_df_from_npz(obj.paths["iter_spectra"] % (3, i))
                          .values for i in range(6)]
    assert "on a mesh {'restart': 4, 'cell': 1}" in printed["four"]
    assert "on a mesh {'restart': 2, 'cell': 2}" in printed["cell"]
    assert "on one device" in printed["gated"]
    for label in ("one", "four", "gated"):
        for a, b in zip(spectra[label], spectra["off"]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(spectra["cell"], spectra["off"]):
        np.testing.assert_allclose(a, b, **TOL)
