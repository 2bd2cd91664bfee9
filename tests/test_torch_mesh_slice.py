"""The whole slice on a mesh of CPU devices (the port's devices from a
monkeypatched ``parallel.mesh.local_devices``) against the JAX package's
cNMF on its 8 virtual CPU devices (tests/conftest.py): prepare →
factorize(use_mesh=True) on 4 restart shards → combine → consensus and
k-selection on 4 cell shards.

Tolerances: merged spectra within 1e-9 of JAX's in float64; consensus
artifacts within SSE 1e-4 relative to the artifact's sum of squares (as
chip_smoke.py measures float32 runs: the TPM-unit spectra reach 3e4, where
float32 rounding alone gives an absolute SSE near 1e-2), in float32 and
float64; the K-selection table as tests/test_torch_pipeline.py holds it in
float64 (silhouette 1e-8 absolute, prediction error 1e-6 relative), 1e-4 in
float32."""

import numpy as np
import pytest

from cnmf_tpu import cNMF as JaxCNMF
from cnmf_tpu.io.dataframe import load_df_from_npz
from cnmf_tpu_torch import cNMF
from test_torch_mesh_pipeline import (
    ARTIFACTS,
    TOL,
    artifacts,
    cpu_mesh,
    planted_counts,
    write_counts,
)
from torch_knobs import (  # noqa: F401 (autouse)
    host_draws_by_default,
    one_torch_thread,
)


def rel_sse(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(((a - b) ** 2).sum() / (b ** 2).sum())


def run_slice(pkg, out_dir, fn, dtype, ks=(4, 5), k=5):
    """prepare → factorize(use_mesh=True) → combine → consensus →
    k_selection_plot; returns the object, the merged spectra, the
    artifacts and the K-selection table."""
    obj = (JaxCNMF(output_dir=str(out_dir), name="m", compute_dtype=dtype)
           if pkg == "jax" else
           cNMF(output_dir=str(out_dir), name="m", compute_dtype=dtype,
                device="cpu"))
    obj.prepare(counts_fn=fn, components=list(ks), n_iter=8, seed=7,
                num_highvar_genes=90)
    obj.factorize(use_mesh=True, verbose=False)
    obj.combine()
    obj.consensus(k=k, density_threshold=0.5, show_clustering=False)
    stats = obj.k_selection_plot(close_fig=True)
    merged = {kk: load_df_from_npz(obj.paths["merged_spectra"] % kk).values
              for kk in ks}
    return merged, artifacts(obj, k), np.asarray(stats, dtype=float)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_slice_on_a_mesh_matches_jax(tmp_path, monkeypatch, dtype):
    """The whole slice with the port's factorize on 4 restart shards and
    its consensus and k-selection on 4 cell shards, against the JAX
    package's cNMF on its 8-device mesh: merged spectra within 1e-9 in
    float64, consensus within SSE 1e-4 (both dtypes), the K-selection
    table as tests/test_torch_pipeline.py holds it."""
    fn = write_counts(tmp_path / "counts.txt", planted_counts(120, 180, 4, 3))
    cpu_mesh(monkeypatch, 4)
    ours = run_slice("torch", tmp_path / "torch", fn, dtype)
    theirs = run_slice("jax", tmp_path / "jax", fn, dtype)
    if dtype == np.float64:
        for kk in ours[0]:
            np.testing.assert_allclose(ours[0][kk], theirs[0][kk], **TOL)
    for key in ARTIFACTS:
        assert rel_sse(ours[1][key], theirs[1][key]) < 1e-4, key
    np.testing.assert_allclose(ours[2][:, 2], theirs[2][:, 2], rtol=0,
                               atol=1e-8 if dtype == np.float64 else 1e-4)
    np.testing.assert_allclose(ours[2][:, 3], theirs[2][:, 3],
                               rtol=1e-6 if dtype == np.float64 else 1e-4)
