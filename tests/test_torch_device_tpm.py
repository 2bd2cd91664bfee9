"""The port's compact integer TPM (cnmf_tpu_torch.ops.device_tpm), its CSR
upload, the TPM prefetch and the device-derived factorize input, on the
CPU: the same decisions and values as the JAX package's
(cnmf_tpu.ops.device_tpm), the device TPM within rtol 3e-7 of the host's
``normalize_total`` product (≤ 2 ulp in float32), the CSR densify and the
one-pass derive bit-identical to the dense upload and the two separate
expansions, and a pipeline on the derived input within 1e-4 of the float
path."""

import numpy as np
import pandas as pd
import pytest
import torch

from cnmf_tpu.ops import device_tpm as jax_tpm
from cnmf_tpu_torch import cNMF as TorchCNMF
from cnmf_tpu_torch.io.dataframe import load_df_from_npz
from cnmf_tpu_torch.ops import device_tpm
from cnmf_tpu_torch.ops.normalize import normalize_total
from cnmf_tpu_torch.parallel import mesh as parallel_mesh
from cnmf_tpu_torch.parallel.mesh import Shards
from torch_knobs import (  # noqa: F401 (autouse)
    host_draws_by_default,
    one_torch_thread,
)


def counts(n=130, g=220, lam=1.5, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.poisson(lam, size=(n, g)).astype(np.float64)
    X[X.sum(axis=1) == 0, 0] = 1
    return X


@pytest.mark.parametrize("make, dtype", [
    (lambda X: X, np.uint8),
    (lambda X: X * 100, np.int16),
    (lambda X: X * 10000, None),         # past int16
    (lambda X: X + 0.5, None),           # not integral
    (lambda X: -X, None),                # negative
    (lambda X: X.astype(np.uint8), np.uint8),
])
def test_compact_integer_counts_as_jax(make, dtype):
    X = make(counts(n=20, g=15))
    ours = device_tpm.compact_integer_counts(X)
    ref = jax_tpm.compact_integer_counts(X)
    if dtype is None:
        assert ours is None and ref is None
        return
    assert ours.dtype == ref.dtype == dtype
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, X)
    if X.dtype == dtype:
        assert not ours.flags.writeable


def test_device_tpm_matches_host_product():
    X = counts()
    ints = device_tpm.compact_integer_counts(X)
    scale = device_tpm.tpm_row_scale(X)
    np.testing.assert_array_equal(scale, jax_tpm.tpm_row_scale(X))
    dev = device_tpm.device_tpm_from_counts(ints, scale.astype(np.float32),
                                            "cpu").numpy()
    host = normalize_total(X, target_sum=1e6).astype(np.float32)
    np.testing.assert_allclose(dev, host, rtol=3e-7, atol=0)


def test_csr_upload_bit_identical(monkeypatch):
    """The CSR components (as the JAX package builds them) scattered on the
    device give the dense image bit for bit; a dense image is declined."""
    monkeypatch.setenv("CNMF_TPU_CSR_UPLOAD", "force")
    ints = device_tpm.compact_integer_counts(counts(n=4000, g=1000, lam=0.05))
    csr = device_tpm.int_image_csr(ints)
    for ours, ref in zip(csr, jax_tpm.int_image_csr(ints)):
        np.testing.assert_array_equal(ours, ref)
    dense, nbytes = device_tpm.upload_int_image(ints, device="cpu")
    assert dense.dtype == torch.uint8
    np.testing.assert_array_equal(dense.numpy(), ints)
    assert nbytes == sum(a.nbytes for a in csr) < ints.nbytes
    full = device_tpm.compact_integer_counts(counts(n=60, g=50, lam=9.0))
    assert device_tpm.int_image_csr(full) is None
    image, nbytes = device_tpm.upload_int_image(full, device="cpu")
    assert nbytes == full.nbytes
    np.testing.assert_array_equal(image.numpy(), full)
    monkeypatch.setenv("CNMF_TPU_CSR_UPLOAD", "0")
    assert not device_tpm.csr_upload_enabled("cpu")
    monkeypatch.setenv("CNMF_TPU_CSR_UPLOAD", "1")
    assert not device_tpm.csr_upload_enabled("cpu")
    assert device_tpm.csr_upload_enabled("cuda")


def test_derive_norm_and_tpm_bit_identical():
    """One pass gives the two separate expansions' bits; the norm side is
    within 2 ulp of the host's float64 scaling."""
    X = counts()
    X[:, 5] += 1
    ints = device_tpm.compact_integer_counts(X)
    names = pd.Index([f"g{j}" for j in range(X.shape[1])])
    hvg = pd.Index(["g7", "g2", "g19", "g5"])
    cols, std = device_tpm.norm_column_spec(names, hvg, ints,
                                            np.dtype(np.float32))
    ref = jax_tpm.norm_column_spec(names, hvg, ints, np.dtype(np.float32))
    np.testing.assert_array_equal(cols, ref[0])
    np.testing.assert_array_equal(std, ref[1])
    scale = device_tpm.tpm_row_scale(X).astype(np.float32)
    t = [torch.as_tensor(a) for a in (ints, cols, std, scale)]
    norm, tpm = device_tpm.derive_norm_and_tpm(*t)
    assert torch.equal(norm, device_tpm.norm_from_counts(*t[:3]))
    assert torch.equal(tpm, device_tpm.tpm_from_counts(t[0], t[3]))
    sub = X[:, cols]
    np.testing.assert_allclose(
        norm.numpy(), (sub / sub.std(axis=0, ddof=1)).astype(np.float32),
        rtol=3e-7, atol=0)
    const = X.copy()
    const[:, 2] = 3
    assert device_tpm.norm_column_spec(
        names, hvg, device_tpm.compact_integer_counts(const),
        np.dtype(np.float32)) is None


def test_put_int_image_cells_pads_zero_tpm_rows():
    X = counts(n=13, g=9)
    ints = device_tpm.compact_integer_counts(X)
    scale = device_tpm.tpm_row_scale(X).astype(np.float32)
    i_sh, s_sh = parallel_mesh.put_int_image_cells(
        ints, scale, [torch.device("cpu")] * 3)
    tpm = device_tpm.tpm_from_counts(i_sh, s_sh)
    assert isinstance(tpm, Shards) and tpm.padded_rows == 15
    whole = torch.cat(tpm.parts).numpy()
    np.testing.assert_array_equal(whole[:13], ints * scale[:, None])
    assert not whole[13:].any()


def prepared(tmp_path, name, dtype=np.float32, n=130, g=220, k=4):
    X = counts(n=n, g=g).astype(np.int64)
    fn = str(tmp_path / f"{name}.txt")
    pd.DataFrame(X, index=[f"c{i}" for i in range(n)],
                 columns=[f"g{j}" for j in range(g)]).to_csv(fn, sep="\t")
    obj = TorchCNMF(output_dir=str(tmp_path), name=name, compute_dtype=dtype,
                    device="cpu")
    obj.prepare(counts_fn=fn, components=[k], n_iter=6, seed=14,
                num_highvar_genes=90, max_NMF_iter=50)
    return obj


def test_prepare_stashes_keyed_to_readback(tmp_path, monkeypatch):
    obj = prepared(tmp_path, "stash")
    ref, ints, scale = obj._tpm_compact
    assert ints.dtype == np.uint8 and scale.dtype == np.float32
    tpm = obj._read_h5ad_cached(obj.paths["tpm"])
    assert ref() is tpm
    np.testing.assert_allclose(
        device_tpm.device_tpm_from_counts(ints, scale, "cpu").numpy(),
        np.asarray(tpm.X, dtype=np.float64), rtol=3e-7, atol=1e-12)
    nref, nints, cols, std = obj._norm_compact
    norm = obj._read_h5ad_cached(obj.paths["normalized_counts"])
    assert nref() is norm and nints is ints
    np.testing.assert_allclose(
        device_tpm.norm_from_counts(*(torch.as_tensor(a) for a in
                                      (ints, cols, std))).numpy(),
        np.asarray(norm.X), rtol=3e-7, atol=1e-12)
    monkeypatch.setenv("CNMF_TPU_DEVICE_TPM", "0")
    off = prepared(tmp_path, "stash_off")
    assert off._tpm_compact is None and off._norm_compact is None


@pytest.mark.parametrize("knob", ["1", "0"])
def test_prefetch_seeds_the_consensus_tpm_cache(tmp_path, monkeypatch, knob):
    """Factorize starts the prefetch; joined, it seeds the consensus TPM
    cache keyed to the TPM's read-back (none when the knob is off), and
    consensus runs on it."""
    monkeypatch.setenv("CNMF_TPU_PREFETCH_TPM", knob)
    obj = prepared(tmp_path, f"pf{knob}")
    obj.factorize(verbose=False)
    obj._join_tpm_prefetch()
    cached = getattr(obj, "_tpm_dev_cache", None)
    if knob == "0":
        assert cached is None
        return
    tpm = obj._read_h5ad_cached(obj.paths["tpm"])
    assert cached is not None and cached[0]() is tpm
    np.testing.assert_allclose(cached[1].numpy(), tpm.X, rtol=3e-7, atol=0)
    obj.combine()
    obj.consensus(k=4, density_threshold=2.0, show_clustering=False)
    assert obj._tpm_dev_cache[1] is cached[1]


def test_prefetch_sharded_on_cell_devices(tmp_path, monkeypatch):
    """With several devices the integer image goes out in the cell layout
    of ``_put_cells`` (zero padded rows) and consensus runs on the
    sharded TPM."""
    monkeypatch.setattr(parallel_mesh, "local_devices",
                        lambda: [torch.device("cpu")] * 3)
    obj = prepared(tmp_path, "pf_mesh", n=131)
    obj.factorize(verbose=False, use_mesh=False)
    obj._join_tpm_prefetch()
    tpm_dev = obj._tpm_dev_cache[1]
    assert isinstance(tpm_dev, Shards) and tpm_dev.padded_rows == 132
    whole = torch.cat(tpm_dev.parts).numpy()
    tpm = obj._read_h5ad_cached(obj.paths["tpm"])
    np.testing.assert_allclose(whole[:131], tpm.X, rtol=3e-7, atol=0)
    assert not whole[131:].any()
    obj.combine()
    obj.consensus(k=4, density_threshold=2.0, show_clustering=False)


def test_device_norm_pipeline_within_contract(tmp_path, monkeypatch):
    """CNMF_TPU_DEVICE_NORM=1 on the CPU: factorize derives its input from
    the integer image (and, the prefetch on, the consensus TPM in the same
    pass); every consensus artifact within relative SSE 1e-4 of the float
    path's."""
    keys = ("consensus_spectra", "consensus_usages", "gene_spectra_tpm",
            "gene_spectra_score")
    outs = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("CNMF_TPU_DEVICE_NORM", knob)
        obj = prepared(tmp_path, f"dn{knob}")
        obj.factorize(verbose=False)
        assert (getattr(obj, "_ints_dev", None) is not None) == (knob == "1")
        if knob == "1":
            # derived beside the input, so the prefetch had nothing to move
            assert obj._tpm_dev_cache[0]() is obj._read_h5ad_cached(
                obj.paths["tpm"])
        obj.combine()
        obj.consensus(k=4, density_threshold=2.0, show_clustering=False)
        outs[knob] = {key: load_df_from_npz(obj.paths[key] % (4, "2_0"))
                      .values for key in keys}
    for key in keys:
        a, b = outs["1"][key], outs["0"][key]
        assert ((a - b) ** 2).sum() / (b ** 2).sum() < 1e-4, key
