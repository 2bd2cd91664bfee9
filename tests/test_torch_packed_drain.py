"""The packed spectra drain (``ops.nmf.pack_spectra_true_k``,
``stages.factorize_grid``; the JAX package's tests/test_packed_drain.py): the
pack only copies the true-K rows the per-K path slices anyway, so the
per-iteration files are bit-equal to the per-K drain's; every pad bucket
goes into one pack and one copy (the JAX package's default
CNMF_TPU_PACK_ALL=1; the port has no per-bucket packs); a same-process
combine reads no per-iteration file; and the f64 pipeline matches the JAX
package's."""

import numpy as np
import torch

import cnmf_tpu_torch.pipeline.cnmf as cnmf_mod
from cnmf_tpu_torch.io.dataframe import load_df_from_npz
from cnmf_tpu_torch.ops.nmf import pack_spectra_true_k
from cnmf_tpu_torch.pipeline import stages
from torch_handoff import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread,
    assert_pipeline_matches_jax,
    make,
    write_counts,
)
from torch_knobs import host_draws_by_default  # noqa: F401 (autouse)


def test_pack_spectra_true_k_rows():
    """The pack is each handle's first k rows, restart by restart, in
    handle order; one handle comes back as its (B·k, G) rows."""
    rng = np.random.RandomState(0)
    hs = [torch.as_tensor(rng.rand(b, 8, 11)) for b in (3, 2)]
    packed = pack_spectra_true_k(tuple(hs), ks=(5, 7))
    want = np.concatenate([hs[0][:, :5].reshape(15, 11).numpy(),
                           hs[1][:, :7].reshape(14, 11).numpy()])
    np.testing.assert_array_equal(packed.numpy(), want)
    one = pack_spectra_true_k((hs[1],), ks=(8,))
    assert one.data_ptr() == hs[1].data_ptr() and one.shape == (16, 11)


def test_factorize_grid_matches_factorize_k():
    """The grid's packed spectra, and the twin rows it hands ``write``, are
    bit-equal to each K's own ``factorize_k``."""
    rng = np.random.RandomState(4)
    X = rng.gamma(1.0, 1.0, size=(40, 30))
    Xd = torch.as_tensor(X)
    kwargs = stages.nmf_run_params(max_iter=30)
    jobs = [(k, np.arange(1, 4) + 10 * k, np.arange(3)) for k in (3, 5, 9)]
    got = {}

    def write(k, iters, batch, dev):
        packed, off, rows = dev
        np.testing.assert_array_equal(
            packed[off:off + rows].numpy().reshape(batch.shape), batch)
        got[k] = batch.copy()

    sweeps = stages.factorize_grid(X, Xd, jobs, kwargs, write, twin=True)
    for k, seeds, _ in jobs:
        spectra, n_iter, executed = stages.factorize_k(X, Xd, k, seeds,
                                                       kwargs)
        np.testing.assert_array_equal(got[k], spectra)
        np.testing.assert_array_equal(sweeps[k][0], n_iter)
        assert sweeps[k][1] == executed


def test_packed_drain_matches_per_k(tmp_path):
    """Two K in the pad-8 bucket and one in the pad-16 bucket, packed,
    against the per-K drain that ``restart_chunk`` forces (a chunk of at
    least B keeps the same single-batch solve)."""
    fn = write_counts(tmp_path / "counts.h5ad", 11)
    ks, n_iter = [5, 7, 9], 3
    cfg = dict(components=ks, n_iter=n_iter, seed=3, num_highvar_genes=50,
               max_NMF_iter=100)
    packed = make(tmp_path, "packed")
    packed.prepare(counts_fn=fn, **cfg)
    packed.factorize(verbose=False)
    perk = make(tmp_path, "perk")
    perk.prepare(counts_fn=fn, **cfg)
    perk.factorize(verbose=False, restart_chunk=10_000)
    for k in ks:
        for it in range(n_iter):
            a = load_df_from_npz(packed.paths["iter_spectra"] % (k, it))
            b = load_df_from_npz(perk.paths["iter_spectra"] % (k, it))
            assert a.shape == (k, 50)
            np.testing.assert_array_equal(a.values, b.values)
            assert list(a.index) == list(b.index)


def test_pack_all_single_transfer(tmp_path, monkeypatch):
    """Both pad buckets (K 5, 7 and 9) go into one pack, which crosses in
    one copy."""
    fn = write_counts(tmp_path / "counts.h5ad", 12)
    cfg = dict(components=[5, 7, 9], n_iter=3, seed=6, num_highvar_genes=50,
               max_NMF_iter=100)
    calls, fetches = [], []
    orig, fetch = stages.pack_spectra_true_k, stages.HostFetch

    def spy(handles, *, ks):
        calls.append(tuple(ks))
        return orig(handles, ks=ks)

    class Counted(fetch):
        def __init__(self, src):
            fetches.append(tuple(src.shape))
            super().__init__(src)

    monkeypatch.setattr(stages, "pack_spectra_true_k", spy)
    monkeypatch.setattr(stages, "HostFetch", Counted)
    obj = make(tmp_path, "all")
    obj.prepare(counts_fn=fn, **cfg)
    obj.factorize(verbose=False)
    assert calls == [(5, 7, 9)], calls
    assert fetches == [(3 * (5 + 7 + 9), 50)], fetches


def test_combine_reads_no_iteration_file(tmp_path, monkeypatch):
    """A same-process combine takes the stack memo: no per-iteration file
    is read, and the merged spectra equal the files' stack."""
    fn = write_counts(tmp_path / "counts.h5ad", 3)
    obj = make(tmp_path, "memo")
    obj.prepare(counts_fn=fn, components=[3, 4], n_iter=3, seed=7,
                num_highvar_genes=50, max_NMF_iter=100)
    obj.factorize(verbose=False)
    read = []
    orig = cnmf_mod.load_df_from_npz

    def spy(path):
        read.append(path)
        return orig(path)

    monkeypatch.setattr(cnmf_mod, "load_df_from_npz", spy)
    obj.combine()
    assert not [p for p in read if ".iter_" in p], read
    monkeypatch.undo()
    for k in (3, 4):
        merged = load_df_from_npz(obj.paths["merged_spectra"] % k)
        stack = np.concatenate([
            load_df_from_npz(obj.paths["iter_spectra"] % (k, it)).values
            for it in range(3)])
        np.testing.assert_array_equal(merged.values, stack)


def test_packed_pipeline_matches_jax(tmp_path):
    """One pack of every K in both packages (their defaults): the f64
    pipeline's artifacts match the JAX package's."""
    assert_pipeline_matches_jax(tmp_path,
                                write_counts(tmp_path / "c.h5ad", 5))


def test_phases_split_factorize(tmp_path, monkeypatch, capsys):
    """CNMF_TPU_PHASES=1 fills ``_factorize_phases``: the packed bytes are
    Σ B·k·G·itemsize, the upload the input's, every time non-negative, and
    the split is printed with the ``[Worker]`` lines."""
    monkeypatch.setenv("CNMF_TPU_PHASES", "1")
    obj = make(tmp_path, "phases")
    obj.prepare(counts_fn=write_counts(tmp_path / "c.h5ad", 4),
                components=[3, 5], n_iter=2, seed=7, num_highvar_genes=50,
                max_NMF_iter=50)
    obj.factorize(verbose=True)
    phases = obj._factorize_phases
    assert phases["result_bytes"] == 2 * (3 + 5) * 50 * 4
    assert phases["upload_bytes"] == 60 * 50 * 4
    assert min(v for k, v in phases.items() if k.endswith("_s")) >= 0
    assert "[Worker 0] phases upload_s" in capsys.readouterr().out
