"""Helpers the port's tests of the in-process stage hand-off share
(tests/test_torch_host_arena.py, test_torch_packed_drain.py,
test_torch_async_writes.py, test_torch_device_spectra.py,
test_torch_deferred_drain.py): small counts, the port's cNMF on the CPU, a
deadline for the tests that stall the background writer, and one f64
pipeline (prepare → factorize → combine → k_selection_plot → consensus)
through the JAX package's cNMF and the port's with the same counts, seeds
and knobs.

Every parity run uses the same recipe, so the JAX package compiles its
programs once for all five files (its persistent compile cache). Its
artifacts agree within ``ARTIFACT_SSE`` relative SSE; the merged spectra of
the two packages' CD solves differ in the last bits of float64 (the
products sum in another order), so the stacks are held to
``STACK_RTOL``."""

import contextlib
import signal
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from cnmf_tpu_torch import cNMF
from cnmf_tpu_torch.io.anndata_lite import AnnData
from cnmf_tpu_torch.io.dataframe import load_df_from_npz
from cnmf_tpu_torch.io.h5ad import write_h5ad

ARTIFACTS = ("consensus_spectra", "consensus_usages", "gene_spectra_tpm",
             "gene_spectra_score", "starcat_spectra")
ARTIFACT_SSE = 1e-10
STACK_RTOL = 1e-12
PARITY = dict(ks=(3, 4), k=4, n_iter=6, seed=7, hvg=50, max_iter=200)
CONSENSUS = dict(density_threshold=2.0, local_neighborhood_size=2.0,
                 show_clustering=False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch ops on one intra-op thread (restored after):
    its tensors are tiny, and beside the other test workers the default
    thread count oversubscribes the cores, where each op's parallel region
    stalls (these five files took 764 s under ``-n 4`` with eight threads a
    process, 36 s with one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_counts(path, seed, n_cells=60, n_genes=120):
    """Binomial counts (no planted structure) as an h5ad; returns its
    path."""
    rng = np.random.RandomState(seed)
    counts = rng.binomial(200, 0.02, size=(n_cells, n_genes)).astype(
        np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1
    return _write(path, counts)


def write_planted(path, seed=3, n_cells=150, n_genes=200, k=4):
    """Gamma-Poisson counts with ``k`` planted programs as an h5ad."""
    rng = np.random.RandomState(seed)
    W = rng.gamma(0.7, 1.0, size=(n_cells, k))
    H = rng.gamma(0.5, 1.0, size=(k, n_genes)) * (rng.rand(k, n_genes) < 0.35)
    counts = rng.poisson(W @ H * 2.0).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1
    return _write(path, counts)


def _write(path, counts):
    write_h5ad(str(path), AnnData(
        counts,
        obs=pd.DataFrame(index=[f"c{i}" for i in range(counts.shape[0])]),
        var=pd.DataFrame(index=[f"g{j}" for j in range(counts.shape[1])])))
    return str(path)


def make(tmp_path, name, **kwargs):
    """The port's cNMF on the CPU under ``tmp_path``."""
    return cNMF(output_dir=str(tmp_path), name=name, device="cpu", **kwargs)


def prepare(obj, counts_fn, ks=(4,), n_iter=2, seed=7, hvg=50,
            max_iter=100):
    obj.prepare(counts_fn=counts_fn, components=list(ks), n_iter=n_iter,
                seed=seed, num_highvar_genes=hvg, max_NMF_iter=max_iter)
    return obj


def rel_sse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).sum() / max(float((b ** 2).sum()), 1e-300))


@contextlib.contextmanager
def deadline(seconds):
    """Raise TimeoutError in the test's (main) thread after ``seconds``, so
    that a drain or write that is never released fails the test instead of
    hanging it."""
    def expire(signum, frame):
        raise TimeoutError(f"not done within {seconds} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@contextlib.contextmanager
def stalled_writer(obj):
    """Hold ``obj``'s background writer (FIFO) behind a gate until the
    block sets the yielded event; the gate opens on the way out whatever
    happens, so that no writer thread outlives a failed test."""
    gate = threading.Event()
    obj._submit_pending_write("__stall__", gate.wait)
    try:
        yield gate
    finally:
        gate.set()


def run_pipeline(obj, counts_fn):
    """The parity recipe on ``obj`` (either package's cNMF): returns the
    k-selection table."""
    obj.prepare(counts_fn=counts_fn, components=list(PARITY["ks"]),
                n_iter=PARITY["n_iter"], seed=PARITY["seed"],
                num_highvar_genes=PARITY["hvg"],
                max_NMF_iter=PARITY["max_iter"])
    obj.factorize(verbose=False, use_mesh=False)
    obj.combine()
    stats = obj.k_selection_plot(close_fig=True)
    obj.consensus(k=PARITY["k"], **CONSENSUS)
    obj.flush_writes()
    return stats


def assert_pipeline_matches_jax(tmp_path, counts_fn):
    """The parity recipe through both packages in float64 under the knobs
    the caller set: merged spectra within ``STACK_RTOL``, consensus
    artifacts and the k-selection table within ``ARTIFACT_SSE``. Returns
    the port's object."""
    from cnmf_tpu import cNMF as JaxCNMF

    ref = JaxCNMF(output_dir=str(tmp_path), name="jax",
                  compute_dtype=np.float64)
    ref_stats = run_pipeline(ref, counts_fn)
    ours = make(tmp_path, "port", compute_dtype=np.float64)
    stats = run_pipeline(ours, counts_fn)
    for k in PARITY["ks"]:
        a = load_df_from_npz(ours.paths["merged_spectra"] % k)
        b = load_df_from_npz(ref.paths["merged_spectra"] % k)
        assert list(a.index) == list(b.index)
        np.testing.assert_allclose(a.values, b.values, rtol=STACK_RTOL,
                                   atol=STACK_RTOL * np.abs(b.values).max())
    for key in ARTIFACTS:
        a = load_df_from_npz(ours.paths[key] % (PARITY["k"], "2_0"))
        b = load_df_from_npz(ref.paths[key] % (PARITY["k"], "2_0"))
        assert list(a.index) == list(b.index), key
        assert rel_sse(a.values, b.values) < ARTIFACT_SSE, key
    assert rel_sse(stats.values, ref_stats.values) < ARTIFACT_SSE
    return ours
