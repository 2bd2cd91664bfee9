"""CNMF_TPU_ASYNC_WRITES=1 in the port (the JAX package's
tests/test_async_writes.py): prepare's h5ad files, factorize's
per-iteration files, combine's merged file and consensus's ten results are
written on one background writer. The artifacts equal the synchronous
path's, a same-process read joins the pending write, ``flush_writes()``
raises a failed write, the seeded read cache still yields to a rewrite by
another process, and the f64 pipeline matches the JAX package's with the
knob on in both. The CLI turns the knob on for its command and flushes."""

import os

import numpy as np
import pandas as pd
import pytest

import cnmf_tpu_torch.pipeline.cnmf as cnmf_mod
from cnmf_tpu_torch.io.anndata_lite import AnnData
from cnmf_tpu_torch.io.dataframe import load_df_from_npz
from cnmf_tpu_torch.io.h5ad import read_h5ad, write_h5ad
from torch_handoff import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread,
    assert_pipeline_matches_jax,
    deadline,
    make,
    prepare,
    stalled_writer,
    write_counts,
)
from torch_knobs import host_draws_by_default  # noqa: F401 (autouse)

CONS = dict(density_threshold=2.0, local_neighborhood_size=2.0,
            show_clustering=False)


@pytest.fixture()
def counts_fn(tmp_path):
    return write_counts(tmp_path / "counts.h5ad", 3)


def _prepare(tmp_path, counts_fn, name):
    return prepare(make(tmp_path, name), counts_fn)


def _dense(X):
    return np.asarray(X.todense() if hasattr(X, "todense") else X)


def test_async_artifacts_match_sync(tmp_path, counts_fn, monkeypatch):
    sync_obj = _prepare(tmp_path, counts_fn, "sync")
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    async_obj = _prepare(tmp_path, counts_fn, "async")
    async_obj.flush_writes()
    for key in ("tpm", "normalized_counts"):
        a = read_h5ad(sync_obj.paths[key])
        b = read_h5ad(async_obj.paths[key])
        np.testing.assert_array_equal(_dense(a.X), _dense(b.X))
        assert list(a.var.index) == list(b.var.index)


def test_same_process_read_joins_pending_write(tmp_path, counts_fn,
                                               monkeypatch):
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    obj = _prepare(tmp_path, counts_fn, "joined")
    # no flush: the cached read joins the pending write (or hits what the
    # writer seeded), never a missing or partial file
    adata = obj._read_h5ad_cached(obj.paths["normalized_counts"])
    assert adata.X.shape[0] == 60
    obj.flush_writes()


def test_end_to_end_pipeline_with_async_writes(tmp_path, counts_fn,
                                               monkeypatch):
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    obj = prepare(make(tmp_path, "e2e"), counts_fn, n_iter=10)
    obj.factorize(verbose=False)
    obj.combine()
    obj.consensus(k=4, density_threshold=2.0, show_clustering=False)
    obj.flush_writes()
    assert os.path.exists(obj.paths["consensus_spectra__txt"] % (4, "2_0"))


def test_external_rewrite_invalidates_seeded_cache(tmp_path, counts_fn,
                                                   monkeypatch):
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    obj = _prepare(tmp_path, counts_fn, "inval")
    obj.flush_writes()
    path = obj.paths["normalized_counts"]
    seeded = obj._read_h5ad_cached(path)
    replacement = AnnData(np.ones((2, 3)),
                          obs=pd.DataFrame(index=["a", "b"]),
                          var=pd.DataFrame(index=["x", "y", "z"]))
    # a rewrite by another process: the new mtime wins over the seed
    os.utime(path, ns=(1, 1))
    write_h5ad(path, replacement)
    assert obj._read_h5ad_cached(path).X.shape != seeded.X.shape


def test_flush_surfaces_write_failure(tmp_path, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    obj = make(tmp_path, "fail")
    bad = AnnData(np.ones((2, 2)), obs=pd.DataFrame(index=["a", "b"]),
                  var=pd.DataFrame(index=["x", "y"]))
    obj._write_prepare_h5ad(
        os.path.join(str(tmp_path), "no_such_dir", "x.h5ad"), bad)
    with pytest.raises(OSError):
        obj.flush_writes()


def test_flush_raises_injected_npz_failure(tmp_path, counts_fn, monkeypatch):
    """A failed write of combine's merged file on the writer is raised by
    ``flush_writes()``, and only once."""
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    obj = _prepare(tmp_path, counts_fn, "inject")
    obj.factorize(verbose=False)
    obj.flush_writes()
    orig = cnmf_mod.save_df_to_npz

    def failing(frame, path):
        if ".merged." in path:
            raise OSError("injected write failure")
        return orig(frame, path)

    monkeypatch.setattr(cnmf_mod, "save_df_to_npz", failing)
    obj.combine()
    with pytest.raises(OSError, match="injected"):
        obj.flush_writes()
    obj.flush_writes()


def test_async_combine_merged_write(tmp_path, counts_fn, monkeypatch):
    """combine's merged file rides the writer: the memo serves consensus at
    once, the file lands equal to the synchronous one after the flush, and
    a fresh object (no memo) reads it."""
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "0")
    sync = _prepare(tmp_path, counts_fn, "sync_c")
    sync.factorize(verbose=False)
    sync.combine()
    ref = load_df_from_npz(sync.paths["merged_spectra"] % 4)

    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    obj = _prepare(tmp_path, counts_fn, "async_c")
    obj.factorize(verbose=False)
    obj.combine()
    obj.consensus(k=4, **CONS)
    obj.flush_writes()
    got = load_df_from_npz(obj.paths["merged_spectra"] % 4)
    np.testing.assert_array_equal(got.values, ref.values)
    assert list(got.index) == list(ref.index)
    make(tmp_path, "async_c").consensus(k=4, **CONS)


def test_async_combine_memo_declined_writes_synchronously(
        tmp_path, counts_fn, monkeypatch):
    """Where the artifact memo declines (byte cap), readers go to the file,
    so combine writes it before returning."""
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    obj = _prepare(tmp_path, counts_fn, "declined")
    obj.factorize(verbose=False)
    monkeypatch.setattr(obj, "_ARTIFACT_MEMO_BYTES", 0)
    monkeypatch.setattr(obj, "_STACK_MEMO_BYTES", 0)
    obj.combine()
    got = load_df_from_npz(obj.paths["merged_spectra"] % 4)
    assert got.shape[0] == 2 * 4
    obj.flush_writes()


def _artifact_paths(obj, k, dt):
    out = []
    for key in ["consensus_spectra", "consensus_usages", "gene_spectra_tpm",
                "gene_spectra_score", "starcat_spectra"]:
        out += [obj.paths[key] % (k, dt), obj.paths[key + "__txt"] % (k, dt)]
    return out


def test_async_consensus_artifacts_match_sync(tmp_path, counts_fn,
                                              monkeypatch):
    """The ten consensus and starCAT files land as the synchronous path
    writes them: the text byte for byte (the reference's text round trip
    of build_reference included), the npz array for array."""
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "0")
    sync = _prepare(tmp_path, counts_fn, "sync_k")
    sync.factorize(verbose=False)
    sync.combine()
    sync.consensus(k=4, **CONS)

    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    obj = _prepare(tmp_path, counts_fn, "async_k")
    obj.factorize(verbose=False)
    obj.combine()
    obj.consensus(k=4, **CONS)
    obj.flush_writes()
    for p_sync, p_async in zip(_artifact_paths(sync, 4, "2_0"),
                               _artifact_paths(obj, 4, "2_0")):
        if p_sync.endswith(".txt"):
            with open(p_sync, "rb") as a, open(p_async, "rb") as b:
                assert a.read() == b.read(), p_async
        else:
            a, b = load_df_from_npz(p_sync), load_df_from_npz(p_async)
            np.testing.assert_array_equal(a.values, b.values)
            assert list(a.index) == list(b.index)


def test_factorize_iter_writes_pending_combine_uses_stack_memo(
        tmp_path, counts_fn, monkeypatch):
    """With the writer held, factorize's per-iteration files are not on
    disk when combine runs: the scan counts the pending writes, the stack
    memo serves their content, and the files land equal after the flush."""
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    obj = _prepare(tmp_path, counts_fn, "stall")
    obj.flush_writes()
    k = 4
    path0 = obj.paths["iter_spectra"] % (k, 0)
    with deadline(60), stalled_writer(obj) as gate:
        obj.factorize(verbose=False)
        assert not os.path.exists(path0)
        assert obj._write_pending(path0)
        obj.combine()
        gate.set()
        obj.flush_writes()
    merged = load_df_from_npz(obj.paths["merged_spectra"] % k)
    assert merged.shape[0] == 2 * k
    np.testing.assert_array_equal(load_df_from_npz(path0).values,
                                  merged.values[:k])


def test_factorize_stack_memo_declined_stays_durable(tmp_path, counts_fn,
                                                     monkeypatch):
    """Where the stack memo declines (byte cap), factorize's files are on
    disk when it returns: a same-process combine reads them."""
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    obj = _prepare(tmp_path, counts_fn, "nostack")
    obj.flush_writes()
    monkeypatch.setattr(obj, "_STACK_MEMO_BYTES", 0)
    obj.factorize(verbose=False)
    for it in range(2):
        assert os.path.exists(obj.paths["iter_spectra"] % (4, it))
    obj.combine()
    obj.flush_writes()


def test_load_results_joins_pending_consensus_writes(tmp_path, counts_fn,
                                                     monkeypatch):
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    obj = _prepare(tmp_path, counts_fn, "lr")
    obj.factorize(verbose=False)
    obj.combine()
    obj.consensus(k=4, **CONS)
    usage, scores, tpm, top = obj.load_results(4, 2.0)
    assert usage.shape == (60, 4)
    assert scores.shape[1] == 4
    obj.flush_writes()


def test_build_reference_joins_pending_txt(tmp_path, counts_fn, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    obj = _prepare(tmp_path, counts_fn, "br")
    obj.factorize(verbose=False)
    obj.combine()
    obj.consensus(k=4, build_ref=False, **CONS)
    obj.build_reference(4, 2.0)
    obj.flush_writes()
    assert os.path.exists(obj.paths["starcat_spectra__txt"] % (4, "2_0"))


def test_remove_individual_iterations_joins_pending_writes(
        tmp_path, counts_fn, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    obj = _prepare(tmp_path, counts_fn, "rm")
    obj.factorize(verbose=False)
    obj.combine_nmf(4, remove_individual_iterations=True)
    obj.flush_writes()
    for it in range(2):
        assert not os.path.exists(obj.paths["iter_spectra"] % (4, it))
    assert os.path.exists(obj.paths["merged_spectra"] % 4)


def test_cli_turns_async_writes_on_and_flushes(tmp_path, counts_fn,
                                               monkeypatch):
    """The CLI runs its command with the writer (the knob unset) and
    returns with the files on disk and the environment as it was."""
    from cnmf_tpu_torch import cli

    monkeypatch.setenv("CNMF_TPU_PLATFORM", "cpu")
    seen = []
    orig = cnmf_mod.cNMF._submit_pending_write

    def spy(self, path, fn, extra_paths=()):
        seen.append(path)
        return orig(self, path, fn, extra_paths)

    monkeypatch.setattr(cnmf_mod.cNMF, "_submit_pending_write", spy)
    cli.main(["prepare", "--output-dir", str(tmp_path), "--name", "cli",
              "-c", counts_fn, "-k", "4", "-n", "2", "--seed", "7",
              "--numgenes", "50"])
    assert "CNMF_TPU_ASYNC_WRITES" not in os.environ
    assert seen and all(os.path.exists(p) for p in seen)


def test_async_pipeline_matches_jax(tmp_path, monkeypatch):
    """CNMF_TPU_ASYNC_WRITES=1 in both packages: the f64 pipeline's
    artifacts match the JAX package's."""
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    assert_pipeline_matches_jax(tmp_path,
                                write_counts(tmp_path / "c.h5ad", 5))


def test_compress_knob_writes_deflated_npz(tmp_path, monkeypatch):
    """CNMF_TPU_COMPRESS=1 writes each array deflated; both forms read
    back equal."""
    import zipfile

    from cnmf_tpu_torch.io.dataframe import save_df_to_npz

    frame = pd.DataFrame(np.arange(24.0).reshape(4, 6), index=list("abcd"))
    for knob, method in (("0", zipfile.ZIP_STORED),
                         ("1", zipfile.ZIP_DEFLATED)):
        monkeypatch.setenv("CNMF_TPU_COMPRESS", knob)
        path = str(tmp_path / f"f{knob}.df.npz")
        save_df_to_npz(frame, path)
        with zipfile.ZipFile(path) as zf:
            assert {i.compress_type for i in zf.infolist()} == {method}
        back = load_df_from_npz(path)
        np.testing.assert_array_equal(back.values, frame.values)
        assert list(back.index) == list(frame.index)
