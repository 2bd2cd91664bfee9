"""The port's tail-compacting CD schedulers (cnmf_tpu_torch.ops.nmf:
``nmf_coordinate_descent_compacted``, ``nmf_cd_grid``, ``nmf_cd_staged``;
their solvers and their branches in ``pipeline.stages``) against the JAX
package's on the same numpy inputs, in float64 on the CPU.

The cases are tests/test_grid_solver.py's and
tests/test_nmf_kernels.py::test_compacted_cd_matches_plain, at their
shapes: identical n_iter at every restart, spectra within the JAX tests'
own tolerances (GRID_ATOL; the compacted factors at COMPACT_TOL), and the
factorize-level A/B through both packages' ``cNMF`` (FILE_ATOL of the
largest value). On the CPU the port's plain half-sweeps compute each
restart alone, so a scheduler also gives the port's per-K bits, which the
tests hold too. With the knobs unset, every dispatch keeps its default
path's bits."""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from cnmf_tpu.ops import nmf as jax_nmf
from cnmf_tpu.ops.init import random_init_batch
from cnmf_tpu_torch import cNMF
from cnmf_tpu_torch.io.dataframe import load_df_from_npz, save_df_to_npz
from cnmf_tpu_torch.ops import nmf as pt_nmf
from cnmf_tpu_torch.pipeline import solvers, stages
from torch_handoff import one_torch_thread  # noqa: F401 (autouse)
from torch_knobs import host_draws_by_default  # noqa: F401 (autouse)

GRID_ATOL = 2e-6          # tests/test_grid_solver.py
COMPACT_TOL = dict(rtol=1e-10, atol=1e-12)   # test_compacted_cd_matches_plain
FILE_ATOL = 1e-5          # of the largest value, test_factorize_*_matches_per_k
SCHEDULE_KNOBS = ("CNMF_TPU_STAGED", "CNMF_TPU_GRID", "CNMF_TPU_COMPACT")


def _mk(B, N, G, K, pad_k, seed):
    rng = np.random.RandomState(seed)
    pad = ((0, 0), (0, 0), (0, pad_k - K))
    return (np.pad(np.abs(rng.standard_normal((B, N, K))), pad),
            np.pad(np.abs(rng.standard_normal((B, G, K))), pad))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plain(X, W0, Ht0, tol, max_iter):
    """The port's plain batched solve: (spectra (B, K, G), n_iter)."""
    _, Ht, n = pt_nmf.nmf_coordinate_descent(_t(X), _t(W0), _t(Ht0), tol=tol,
                                             max_iter=max_iter)
    return Ht.transpose(1, 2).numpy(), n.numpy()


def test_ladder_shapes():
    for b0, m, sizes in ((500, 32, [504, 256, 128, 64, 32]),
                         (400, 32, [400, 200, 104, 56, 32]),
                         (24, 32, [24])):
        assert pt_nmf._ladder(b0, m) == jax_nmf._ladder(b0, m) == sizes
    assert all(s % 8 == 0 for s in pt_nmf._ladder(1000, 32))


@pytest.mark.parametrize("seg_len,max_iter", [(10, 95), (25, 100)])
def test_grid_matches_jax_merged_ks(seg_len, max_iter):
    """Three K share the pad-8 bucket, converging at different speeds."""
    rng = np.random.RandomState(0)
    N, G = 60, 40
    X = np.abs(rng.standard_normal((N, G)))
    inits = [_mk(8, N, G, k, 8, seed=i) for i, k in enumerate([5, 6, 7])]
    W0 = np.concatenate([w for w, _ in inits])
    Ht0 = np.concatenate([h for _, h in inits])
    spec_j, n_j = jax_nmf.nmf_cd_grid(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0), tol=1e-3,
        max_iter=max_iter, seg_len=seg_len, min_bucket=8)
    spec, n, executed = pt_nmf.nmf_cd_grid(
        _t(X), _t(W0), _t(Ht0), tol=1e-3, max_iter=max_iter,
        seg_len=seg_len, min_bucket=8)
    np.testing.assert_array_equal(n, np.asarray(n_j))
    np.testing.assert_allclose(spec, np.asarray(spec_j), rtol=0,
                               atol=GRID_ATOL)
    assert n.min() < n.max()   # heterogeneous convergence, as targeted
    spec_p, n_p = _plain(X, W0, Ht0, 1e-3, max_iter)
    np.testing.assert_array_equal(n, n_p)
    np.testing.assert_array_equal(spec, spec_p)
    # the device's work counts at least every restart's own sweeps
    assert (executed >= n).all()


def test_grid_single_ladder_level():
    """A batch too small to shrink: the plain solver."""
    rng = np.random.RandomState(3)
    X = np.abs(rng.standard_normal((30, 20)))
    W0, Ht0 = _mk(4, 30, 20, 4, 8, seed=9)
    spec_j, n_j = jax_nmf.nmf_cd_grid(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0), tol=1e-4,
        max_iter=40, seg_len=15, min_bucket=32)
    spec, n, _ = pt_nmf.nmf_cd_grid(_t(X), _t(W0), _t(Ht0), tol=1e-4,
                                    max_iter=40, seg_len=15, min_bucket=32)
    np.testing.assert_array_equal(n, np.asarray(n_j))
    np.testing.assert_allclose(spec, np.asarray(spec_j), rtol=0,
                               atol=GRID_ATOL)
    np.testing.assert_array_equal(spec, _plain(X, W0, Ht0, 1e-4, 40)[0])


@pytest.mark.parametrize("s0,seg_len,max_iter", [(20, 10, 95), (30, 25, 100)])
def test_staged_matches_jax(s0, seg_len, max_iter):
    """Mixed pad buckets (K=5, 6 → 8; K=11 → 16) through one staged call,
    through the solver entry point."""
    rng = np.random.RandomState(1)
    N, G = 60, 40
    X = np.abs(rng.standard_normal((N, G)))
    inits = [_mk(8, N, G, k, pad_k, seed=10 + i)
             for i, (k, pad_k) in enumerate([(5, 8), (6, 8), (11, 16)])]
    outs_j = jax_nmf.nmf_cd_staged(
        jnp.asarray(X), [(jnp.asarray(w), jnp.asarray(h)) for w, h in inits],
        tol=1e-3, max_iter=max_iter, s0=s0, seg_len=seg_len, min_bucket=8)
    outs = solvers.solve_nmf_staged(
        _t(X), [(_t(w), _t(h)) for w, h in inits],
        dict(solver="cd", beta_loss="frobenius", tol=1e-3,
             max_iter=max_iter), s0=s0, seg_len=seg_len, min_bucket=8)
    assert len(outs) == 3
    tails = 0
    for (spec, n, executed), (spec_j, n_j), (W0, Ht0) in zip(outs, outs_j,
                                                              inits):
        np.testing.assert_array_equal(n, np.asarray(n_j))
        np.testing.assert_allclose(spec, np.asarray(spec_j), rtol=0,
                                   atol=GRID_ATOL)
        spec_p, n_p = _plain(X, W0, Ht0, 1e-3, max_iter)
        np.testing.assert_array_equal(n, n_p)
        np.testing.assert_allclose(spec, spec_p, rtol=0, atol=1e-12)
        assert (executed >= n).all()
        tails += int((n > s0).sum())
    assert tails > 0   # the continuation really ran


def test_staged_all_converge_in_phase1():
    rng = np.random.RandomState(2)
    X = np.abs(rng.standard_normal((30, 20)))
    W0, Ht0 = _mk(4, 30, 20, 4, 8, seed=3)
    spec_p, n_p = _plain(X, W0, Ht0, 1e-2, 200)
    assert n_p.max() < 150
    (spec_j, n_j), = jax_nmf.nmf_cd_staged(
        jnp.asarray(X), [(jnp.asarray(W0), jnp.asarray(Ht0))], tol=1e-2,
        max_iter=200, s0=150, seg_len=25, min_bucket=8)
    (spec, n, _), = pt_nmf.nmf_cd_staged(
        _t(X), [(_t(W0), _t(Ht0))], tol=1e-2, max_iter=200, s0=150,
        seg_len=25, min_bucket=8)
    np.testing.assert_array_equal(n, np.asarray(n_j))
    np.testing.assert_allclose(spec, np.asarray(spec_j), rtol=0,
                               atol=GRID_ATOL)
    np.testing.assert_array_equal(n, n_p)
    np.testing.assert_array_equal(spec, spec_p)


def test_compacted_cd_matches_jax():
    """Between-segment compaction through ``solve_nmf_batch(compact=True)``
    against the JAX package's compacted and plain solves: the same sweeps
    and factors (tests/test_nmf_kernels.py's case)."""
    rng = np.random.RandomState(12)   # test_nmf_kernels.make_counts(80, 50)
    X = rng.poisson(rng.gamma(2.0, 1.0, size=(80, 4))
                    @ rng.gamma(2.0, 1.0, size=(4, 50))).astype(np.float64)
    X += 1e-8
    seeds = list(range(31, 41))
    W0, Ht0 = random_init_batch(X, 6, seeds, dtype=np.float64)
    W_p, Ht_p, n_p = jax_nmf.nmf_coordinate_descent(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0), tol=1e-4,
        max_iter=600)
    W_c, Ht_c, n_c = jax_nmf.nmf_coordinate_descent_compacted(
        jnp.asarray(X), W0, Ht0, tol=1e-4, max_iter=600, seg_len=50,
        bucket=4)
    info = {}
    W, Ht, n = pt_nmf.nmf_coordinate_descent_compacted(
        _t(X), _t(W0), _t(Ht0), tol=1e-4, max_iter=600, seg_len=50,
        bucket=4, info=info)
    for ref_n, ref_W, ref_Ht in ((n_p, W_p, Ht_p), (n_c, W_c, Ht_c)):
        np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
        np.testing.assert_allclose(Ht.numpy(), np.asarray(ref_Ht),
                                   **COMPACT_TOL)
        np.testing.assert_allclose(W.numpy(), np.asarray(ref_W),
                                   **COMPACT_TOL)
    kwargs = dict(solver="cd", beta_loss="frobenius", tol=1e-4, max_iter=600)
    W_s, Ht_s, n_s = solvers.solve_nmf_batch(_t(X), _t(W0), _t(Ht0), kwargs,
                                             compact=True)
    assert n.sum() <= info["executed"] <= 10 * 600
    W_d, Ht_d, n_d = solvers.solve_nmf_batch(_t(X), _t(W0), _t(Ht0), kwargs)
    for a, b in ((W_s, W_d), (Ht_s, Ht_d), (n_s, n_d)):
        assert torch.equal(a, b)


def _counts_file(tmp_path, seed):
    """tests/test_grid_solver.py's factorize counts (80 × 120)."""
    rng = np.random.RandomState(seed)
    W = rng.gamma(0.7, 1.0, size=(80, 5))
    H = rng.gamma(0.5, 1.0, size=(5, 120)) * (rng.rand(5, 120) < 0.4)
    X = rng.poisson(W @ H * 2.0).astype(float)
    X[X.sum(axis=1) == 0, 0] = 1
    path = str(tmp_path / "counts.df.npz")
    save_df_to_npz(pd.DataFrame(X, index=[f"c{i}" for i in range(80)],
                                columns=[f"g{j}" for j in range(120)]), path)
    return path


@pytest.mark.parametrize("knob,seed,ks", [("CNMF_TPU_GRID", 42, [4, 5, 9]),
                                          ("CNMF_TPU_STAGED", 7, [4, 9])])
def test_factorize_schedule_matches_jax(tmp_path, monkeypatch, knob, seed, ks):
    """The schedule through both packages' cNMF.factorize (float64, three
    restarts a K, tests/test_grid_solver.py's A/B): each per-iteration file
    within FILE_ATOL of the JAX package's under the same knob, and the
    port's per-K files bit for bit."""
    from cnmf_tpu import cNMF as JaxCNMF

    counts = _counts_file(tmp_path, seed)
    prep = dict(counts_fn=counts, components=ks, n_iter=3, seed=14,
                num_highvar_genes=60)
    runs = {}
    for name, cls, mode in (("jax", JaxCNMF, "1"), ("port", cNMF, "1"),
                            ("port_per_k", cNMF, "0")):
        monkeypatch.setenv(knob, mode)
        extra = dict(device="cpu") if cls is cNMF else {}
        obj = cls(output_dir=str(tmp_path), name=name,
                  compute_dtype=np.float64, **extra)
        obj.prepare(**prep)
        obj.factorize(verbose=False, use_mesh=False)
        runs[name] = {(k, i): load_df_from_npz(obj.paths["iter_spectra"]
                                               % (k, i))
                      for k in ks for i in range(3)}
    for key, ref in runs["jax"].items():
        ours = runs["port"][key]
        assert ours.index.equals(ref.index) and ours.columns.equals(ref.columns)
        np.testing.assert_allclose(
            ours.values, ref.values, rtol=0,
            atol=FILE_ATOL * max(1.0, np.abs(ref.values).max()))
        np.testing.assert_array_equal(ours.values,
                                      runs["port_per_k"][key].values)


def test_knobs_unset_keep_the_default_bits(monkeypatch):
    """With the knobs unset: the solver dispatch runs the plain CD and
    MU solves (no compaction), factorize_grid packs
    every K on the device as before, and torch's float32 products are full
    precision (``highest``, TF32 off)."""
    for knob in SCHEDULE_KNOBS + ("CNMF_TPU_MATMUL_PRECISION",):
        monkeypatch.delenv(knob, raising=False)
    rng = np.random.RandomState(5)
    X = np.abs(rng.standard_normal((40, 30))) + 0.05
    W0, Ht0 = _mk(6, 40, 30, 4, 8, seed=6)
    cd = dict(solver="cd", beta_loss="frobenius", tol=1e-4, max_iter=100)
    kl = dict(solver="mu", beta_loss="kullback-leibler", tol=1e-4,
              max_iter=50)
    got = solvers.solve_nmf_batch(_t(X), _t(W0), _t(Ht0), cd)
    ref = pt_nmf.nmf_coordinate_descent(_t(X), _t(W0), _t(Ht0), tol=1e-4,
                                        max_iter=100)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    got = solvers.solve_nmf_batch(_t(X), _t(W0), _t(Ht0), kl)
    ref = pt_nmf.nmf_multiplicative_update(_t(X), _t(W0), _t(Ht0), beta=1.0,
                                           tol=1e-4, max_iter=50)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert not (solvers.compact_enabled() or solvers.grid_enabled()
                or solvers.staged_enabled())
    assert solvers.autowarm_enabled()
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32

    seeds = np.arange(1, 5)
    jobs = [(4, seeds, np.arange(4)), (9, seeds + 10, np.arange(4))]
    Xd = _t(X)
    written = {}

    def write(k, iters, batch, dev):
        written[k] = (batch.copy(), dev)

    sweeps = stages.factorize_grid(X, Xd, jobs, cd, write, twin=True)
    for k, s, _ in jobs:
        spec, n_iter, executed = stages.factorize_k(X, Xd, k, s, cd)
        batch, dev = written[k]
        assert dev is not None   # the default path's pack and twin
        np.testing.assert_array_equal(batch, spec)
        np.testing.assert_array_equal(sweeps[k][0], n_iter)
        assert sweeps[k][1] == executed
