"""The deferred packed drain in the port (cnmf_tpu/pipeline/cnmf.py:
1671-1769; the JAX package's tests/test_drain_hold.py without the hold):
under CNMF_TPU_ASYNC_WRITES=1 with the spectra twin on, factorize returns
before its packed copy has landed, and the background writer waits for
it, fills the stack memo's placeholders and writes the per-iteration files.
The port has no CNMF_TPU_DRAIN_HOLD_S: the JAX package holds the copy off
its TPU's one relay channel while consensus reads, and a card's copy runs
on a copy engine of its own. Each test has a deadline well below a hang,
so that a drain that never lands fails instead of hanging."""

import os
import time

import numpy as np
import pytest

from cnmf_tpu_torch.io.dataframe import load_df_from_npz
from cnmf_tpu_torch.pipeline import stages
from torch_handoff import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread,
    assert_pipeline_matches_jax,
    deadline,
    make,
    prepare,
    write_counts,
)
from torch_knobs import host_draws_by_default  # noqa: F401 (autouse)

DEADLINE_S = 40
CONS = dict(density_threshold=2.0, local_neighborhood_size=2.0,
            show_clustering=False)


@pytest.fixture(autouse=True)
def _deferred_drain_env(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_ASYNC_WRITES", "1")
    monkeypatch.setenv("CNMF_TPU_DEVICE_SPECTRA", "force")
    monkeypatch.setenv("CNMF_TPU_DEVICE_KMEANSPP", "force")
    with deadline(DEADLINE_S):
        yield


@pytest.fixture()
def counts_fn(tmp_path):
    return write_counts(tmp_path / "counts.h5ad", 8)


def _prep_factorize(tmp_path, counts_fn, name, ks=(4,), n_iter=6):
    obj = prepare(make(tmp_path, name), counts_fn, ks=ks, n_iter=n_iter)
    obj.factorize(verbose=False)
    return obj


def test_consensus_beside_deferred_drain(tmp_path, counts_fn):
    """factorize queues the drain on the writer; combine defers the merge
    behind it, consensus runs from the twin, and the flush lands every
    file."""
    obj = _prep_factorize(tmp_path, counts_fn, "cons")
    assert obj._write_pending(obj.paths["iter_spectra"] % (4, 0)) or \
        os.path.exists(obj.paths["iter_spectra"] % (4, 0))
    obj.combine()
    obj.consensus(k=4, **CONS)
    obj.flush_writes()
    assert os.path.exists(obj.paths["iter_spectra"] % (4, 0))
    assert os.path.exists(obj.paths["merged_spectra"] % 4)
    usages = load_df_from_npz(obj.paths["consensus_usages"] % (4, "2_0"))
    assert usages.shape == (60, 4)


def test_reader_join_gets_drained_frame(tmp_path, counts_fn):
    """A direct combine_nmf() (a reader that joins) waits for the drain;
    its frame equals the drained file."""
    obj = _prep_factorize(tmp_path, counts_fn, "join")
    frame = obj.combine_nmf(4)
    assert frame.shape == (6 * 4, 50)
    obj.flush_writes()
    on_disk = load_df_from_npz(obj.paths["merged_spectra"] % 4)
    np.testing.assert_array_equal(frame.values, on_disk.values)


def test_flush_lands_deferred_files(tmp_path, counts_fn):
    obj = _prep_factorize(tmp_path, counts_fn, "flush")
    obj.flush_writes()
    for it in range(6):
        assert os.path.exists(obj.paths["iter_spectra"] % (4, it))


def test_k_selection_sweep_beside_deferred_drain(tmp_path, counts_fn):
    obj = _prep_factorize(tmp_path, counts_fn, "sweep", ks=(3, 4))
    obj.combine()
    obj.k_selection_plot(close_fig=True)
    obj.flush_writes()
    assert os.path.exists(obj.paths["k_selection_stats"])
    stats = load_df_from_npz(obj.paths["k_selection_stats"])
    assert list(stats["k"]) == [3, 4]


def test_drain_lands_without_a_reader(tmp_path, counts_fn):
    """Nothing waits on the drain: a caller that never reads or flushes
    still gets its files."""
    obj = _prep_factorize(tmp_path, counts_fn, "alone")
    path = obj.paths["iter_spectra"] % (4, 5)
    stop = time.perf_counter() + 30.0
    while not os.path.exists(path) and time.perf_counter() < stop:
        time.sleep(0.05)
    assert os.path.exists(path)
    obj.flush_writes()


def test_failed_copy_raises_at_reader_and_flush(tmp_path, counts_fn,
                                                monkeypatch):
    """A copy that fails on the writer drops the stack memo's placeholders:
    ``flush_writes`` raises its error, and so does a reader of the spectra
    (whose join takes the failed writes off the pending list)."""

    class FailingFetch:
        def __init__(self, src):
            self.src = src

        def wait(self):
            raise RuntimeError("injected copy failure")

    monkeypatch.setattr(stages, "HostFetch", FailingFetch)
    flushed = _prep_factorize(tmp_path, counts_fn, "fail_flush")
    with pytest.raises(RuntimeError, match="injected copy failure"):
        flushed.flush_writes()
    assert not os.path.exists(flushed.paths["iter_spectra"] % (4, 0))
    read = _prep_factorize(tmp_path, counts_fn, "fail_read")
    with pytest.raises(RuntimeError, match="injected copy failure"):
        read.combine_nmf(4)
    assert not os.path.exists(read.paths["merged_spectra"] % 4)


def test_deferred_pipeline_matches_jax(tmp_path):
    """The deferred drain in both packages (ASYNC_WRITES=1, the twin and
    device kmeans++ forced): the f64 pipeline's artifacts match the JAX
    package's."""
    assert_pipeline_matches_jax(tmp_path,
                                write_counts(tmp_path / "c.h5ad", 5))
