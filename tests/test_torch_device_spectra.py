"""CNMF_TPU_DEVICE_SPECTRA in the port (the JAX package's
tests/test_device_spectra.py): a same-process factorize leaves its packed
true-K spectra on the device as the twin that the whole-chain consensus and
the k-selection sweep take instead of uploading the merged spectra again
(normalized in the chain); with CNMF_TPU_ASYNC_WRITES=1 the drain itself
rides the background writer, combine queues the merge behind it, and
consensus runs from the registered twin without joining the copy.

On the CPU the knob's ``force`` value turns it on, and the whole chain
needs CNMF_TPU_DEVICE_KMEANSPP=force (the default on CUDA). In float64 the
twin's normalization differs from the host's in reduction order only; the
Lloyd loop and the refits carry that to about 1e-7 on the artifacts,
compared at 1e-5 relative (norm), inside the consensus contract."""

import os

import numpy as np
import pytest

import cnmf_tpu_torch.pipeline.cnmf as cnmf_mod
import cnmf_tpu_torch.pipeline.stages as stages_mod
from cnmf_tpu_torch.io.dataframe import load_df_from_npz
from torch_handoff import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread,
    assert_pipeline_matches_jax,
    deadline,
    make,
    prepare,
    stalled_writer,
    write_counts,
    write_planted,
)
from torch_knobs import host_draws_by_default  # noqa: F401 (autouse)

CONS = dict(density_threshold=2.0, local_neighborhood_size=2.0)


@pytest.fixture(autouse=True)
def _whole_chain(monkeypatch):
    # the twin applies to the whole chain (device kmeans++) only: both arms
    # of each comparison run that chain, so only the spectra source differs
    monkeypatch.setenv("CNMF_TPU_DEVICE_KMEANSPP", "force")


@pytest.fixture()
def counts_fn(tmp_path):
    return write_counts(tmp_path / "counts.h5ad", 5)


def _run(tmp_path, counts_fn, name, k=4, n_iter=6, **consensus_kw):
    obj = prepare(make(tmp_path, name), counts_fn, ks=(k,), n_iter=n_iter)
    obj.factorize(verbose=False)
    obj.combine()
    kw = dict(show_clustering=False)
    kw.update(consensus_kw)
    obj.consensus(k=k, **CONS, **kw)
    obj.flush_writes()
    return obj


def _paths(obj, k, dt):
    return [obj.paths[key] % (k, dt) for key in (
        "consensus_spectra", "consensus_usages", "gene_spectra_tpm",
        "gene_spectra_score", "starcat_spectra")] + [
        obj.paths["merged_spectra"] % k]


def _assert_runs_match(ref, got, k, rtol):
    for p_ref, p_got in zip(_paths(ref, k, "2_0"), _paths(got, k, "2_0")):
        a, b = load_df_from_npz(p_ref), load_df_from_npz(p_got)
        assert list(a.index) == list(b.index), p_got
        assert list(a.columns) == list(b.columns), p_got
        av, bv = np.nan_to_num(a.values), np.nan_to_num(b.values)
        rel = float(np.sqrt(((av - bv) ** 2).sum())) / max(
            float(np.sqrt((av ** 2).sum())), 1e-30)
        assert rel < rtol, (p_got, rel)


def test_device_spectra_twin_matches_host_upload(tmp_path, counts_fn,
                                                 monkeypatch):
    """The twin-fed chain gives the host upload's artifacts."""
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "0")
    host = _run(tmp_path, counts_fn, "host")
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "force")
    dev = _run(tmp_path, counts_fn, "dev")
    _assert_runs_match(host, dev, 4, 1e-5)


def test_twin_validates_and_invalidates(tmp_path, counts_fn, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "force")
    obj = prepare(make(tmp_path, "tv"), counts_fn, n_iter=6)
    obj.factorize(verbose=False)
    obj.combine()
    path = obj.paths["merged_spectra"] % 4
    merged = obj._recall_artifact(path, copy=False)
    twin = obj._device_spectra_twin(4, merged)
    assert twin is not None and tuple(twin.shape) == (6 * 4, 50)
    np.testing.assert_array_equal(twin.numpy(), merged.values)
    # another frame object does not validate
    assert obj._device_spectra_twin(4, merged.copy()) is None
    # a cache clear drops the handles
    obj.clear_device_caches()
    merged2 = obj._recall_artifact(path, copy=False)
    assert obj._device_spectra_twin(4, merged2) is None
    # consensus still runs (the host values)
    obj.consensus(k=4, show_clustering=False, **CONS)
    obj.flush_writes()


def test_deferred_drain_pipeline_matches_sync(tmp_path, counts_fn,
                                              monkeypatch):
    """ASYNC_WRITES=1 with the twin: the drain rides the writer, combine
    defers the merge, consensus takes the twin, and every file (merged and
    per-iteration included) matches the synchronous run's after the
    flush."""
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "0")
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "0")
    sync = _run(tmp_path, counts_fn, "sd_sync")
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "force")
    deferred = _run(tmp_path, counts_fn, "sd_def")
    _assert_runs_match(sync, deferred, 4, 1e-5)
    for it in range(6):
        np.testing.assert_array_equal(
            load_df_from_npz(sync.paths["iter_spectra"] % (4, it)).values,
            load_df_from_npz(deferred.paths["iter_spectra"] % (4, it)).values)


def test_deferred_consensus_never_joins_drain(tmp_path, counts_fn,
                                              monkeypatch):
    """With the writer held, factorize, combine and consensus all return
    while the drain is still queued; the files land once the gate opens."""
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "force")
    obj = prepare(make(tmp_path, "stall"), counts_fn, n_iter=6)
    obj.flush_writes()
    merged_path = obj.paths["merged_spectra"] % 4
    with deadline(60), stalled_writer(obj) as gate:
        obj.factorize(verbose=False)
        obj.combine()
        assert not os.path.exists(merged_path)
        assert obj._deferred_merged_meta(merged_path) is not None
        obj.consensus(k=4, show_clustering=False, build_ref=False, **CONS)
        assert not os.path.exists(merged_path)
        assert not os.path.exists(obj.paths["iter_spectra"] % (4, 0))
        gate.set()
        obj.flush_writes()
    assert os.path.exists(merged_path)
    assert os.path.exists(obj.paths["iter_spectra"] % (4, 0))
    usages = load_df_from_npz(obj.paths["consensus_usages"] % (4, "2_0"))
    assert usages.shape == (60, 4)


def test_deferred_combine_nmf_direct_call_materializes(tmp_path, counts_fn,
                                                       monkeypatch):
    """A direct combine_nmf() call returns the merged frame itself while
    the drain is queued."""
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "force")
    obj = prepare(make(tmp_path, "direct"), counts_fn, n_iter=6)
    obj.factorize(verbose=False)
    frame = obj.combine_nmf(4)
    assert frame.shape == (6 * 4, 50)
    assert list(frame.index)[:4] == ["iter0_topic1", "iter0_topic2",
                                     "iter0_topic3", "iter0_topic4"]
    obj.flush_writes()
    on_disk = load_df_from_npz(obj.paths["merged_spectra"] % 4)
    np.testing.assert_array_equal(frame.values, on_disk.values)


def test_deferred_meta_expires_after_flush(tmp_path, counts_fn, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "force")
    obj = prepare(make(tmp_path, "meta"), counts_fn, n_iter=6)
    obj.flush_writes()
    merged_path = obj.paths["merged_spectra"] % 4
    # the writer held, so that the merge is still queued when combine runs
    # (on the CPU an unheld drain may land first, and combine then merges
    # the host batch itself)
    with deadline(60), stalled_writer(obj) as gate:
        obj.factorize(verbose=False)
        obj.combine()
        assert obj._deferred_merged_meta(merged_path) is not None
        gate.set()
        obj.flush_writes()
    assert obj._deferred_merged_meta(merged_path) is None
    obj.consensus(k=4, show_clustering=False, **CONS)
    obj.flush_writes()


@pytest.fixture()
def planted_fn(tmp_path):
    # well-separated programs: the threefry kmeans++ and the host seeding
    # find the same clustering here
    return write_planted(tmp_path / "planted.h5ad", seed=3, n_cells=150,
                         n_genes=200)


def _through_combine(tmp_path, counts, name, ks=(3, 4, 5), n_iter=8):
    obj = prepare(make(tmp_path, name), counts, ks=ks, n_iter=n_iter, seed=9,
                  hvg=120)
    obj.factorize(verbose=False)
    obj.combine()
    return obj


def test_k_selection_twin_matches_host(tmp_path, planted_fn, monkeypatch):
    """The sweep fed by the twins (normalized and seeded on the device)
    gives the host-fed sweep's table; the host-fed chain is not reached."""
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "0")
    host_stats = _through_combine(tmp_path, planted_fn,
                                  "ksel_host").k_selection_plot(close_fig=True)
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "force")
    dev = _through_combine(tmp_path, planted_fn, "ksel_dev")

    def bomb(*a, **k):
        raise AssertionError("the host k-stats chain ran despite the twins")

    monkeypatch.setattr(stages_mod, "consensus_k_stats", bomb)
    dev_stats = dev.k_selection_plot(close_fig=True)
    np.testing.assert_array_equal(host_stats["k"].values,
                                  dev_stats["k"].values)
    assert (host_stats.set_index("k")["silhouette"].idxmax()
            == dev_stats.set_index("k")["silhouette"].idxmax())
    np.testing.assert_allclose(dev_stats["silhouette"].values,
                               host_stats["silhouette"].values, rtol=1e-4)
    np.testing.assert_allclose(dev_stats["prediction_error"].values,
                               host_stats["prediction_error"].values,
                               rtol=1e-4)


def test_k_selection_never_joins_deferred_drain(tmp_path, planted_fn,
                                                monkeypatch):
    """With the writer held, the whole sweep runs from the deferred merges'
    twins, and its table matches a fresh object's sweep of the drained
    files."""
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "force")
    obj = prepare(make(tmp_path, "ksel_gate"), planted_fn, ks=(3, 4, 5),
                  n_iter=8, seed=9, hvg=120)
    obj.flush_writes()
    with deadline(60), stalled_writer(obj) as gate:
        obj.factorize(verbose=False)
        obj.combine()
        stats = obj.k_selection_plot(close_fig=True)
        assert not os.path.exists(obj.paths["merged_spectra"] % 4)
        gate.set()
        obj.flush_writes()
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "0")
    stats2 = make(tmp_path, "ksel_gate").k_selection_plot(close_fig=True)
    np.testing.assert_allclose(stats["silhouette"].values,
                               stats2["silhouette"].values, rtol=1e-4)
    np.testing.assert_allclose(stats["prediction_error"].values,
                               stats2["prediction_error"].values, rtol=1e-4)


def test_deferred_clustergram_materializes(tmp_path, counts_fn, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "force")
    obj = _run(tmp_path, counts_fn, "plot", show_clustering=True,
               close_clustergram_fig=True)
    assert os.path.exists(obj.paths["clustering_plot"] % (4, "2_0"))


def test_device_spectra_pipeline_matches_jax(tmp_path, monkeypatch):
    """The twin in both packages (DEVICE_SPECTRA and DEVICE_KMEANSPP
    forced): the f64 pipeline's artifacts match the JAX package's."""
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "force")
    ours = assert_pipeline_matches_jax(tmp_path,
                                       write_counts(tmp_path / "c.h5ad", 5))
    assert ours._device_spectra_twin(
        4, ours._recall_artifact(ours.paths["merged_spectra"] % 4,
                                 copy=False)) is not None


def test_spectra_knob_resolves_per_device(monkeypatch):
    """'1' (the default) applies on CUDA only, 'force' anywhere, '0'
    nowhere."""
    from cnmf_tpu_torch.pipeline.solvers import device_spectra_enabled

    monkeypatch.delenv("CNMF_TPU_DEVICE_SPECTRA", raising=False)
    assert device_spectra_enabled("cuda") and not device_spectra_enabled("cpu")
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "force")
    assert device_spectra_enabled("cpu")
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "0")
    assert not device_spectra_enabled("cuda")
    assert cnmf_mod._PendingBatch((1, 1, 1), 8).nbytes == 8
