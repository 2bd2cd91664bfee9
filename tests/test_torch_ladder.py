"""The port's solver loops in blocks and its device ladders
(cnmf_tpu_torch.ops.nmf, pipeline.solvers, pipeline.stages) against the JAX
package on the same numpy inputs, in float64 on the CPU.

The CPU runs the same blocks of steps as the card. Ladders: identical
n_iter, spectra within LADDER_ATOL of the JAX ladder (the cases of
tests/test_device_ladder.py). Block loops: identical n_iter and the JAX
plain solvers' factors at max_iter 15 and 23, which are not multiples of
the block. Both packages' f64 matmuls sum in other orders,
so the factors agree to rounding, not bits."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnmf_tpu.ops import nmf as jax_nmf
from cnmf_tpu_torch.ops import mu_kernels as mk
from cnmf_tpu_torch.ops import nmf as pt_nmf
from cnmf_tpu_torch.pipeline import solvers as pt_solvers
from cnmf_tpu_torch.pipeline import stages
from torch_knobs import (  # noqa: F401 (autouse)
    host_draws_by_default,
    one_torch_thread,
)

LADDER_ATOL = 1e-10
FACTOR_TOL = 1e-10   # the block loops against the JAX plain solvers, f64


def _mk(B, N, G, K, pad_k, seed):
    rng = np.random.RandomState(seed)
    pad = ((0, 0), (0, 0), (0, pad_k - K))
    return (np.pad(np.abs(rng.standard_normal((B, N, K))), pad),
            np.pad(np.abs(rng.standard_normal((B, G, K))), pad))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _executed_sweeps(n_iter, max_iter):
    """Sweeps the ladder's rungs run in all: whole blocks up to the slowest
    restart, at most max_iter."""
    block = pt_nmf.BLOCK
    return min(max_iter, block * -(-int(np.max(n_iter)) // block))


@pytest.mark.parametrize("b0,min_bucket", [(100, 16), (20, 8), (8, 8),
                                           (18, 8), (1, 32), (250, 32)])
def test_ladder_sizes_match_jax(b0, min_bucket):
    assert pt_nmf._ladder(b0, min_bucket) == jax_nmf._ladder(b0, min_bucket)
    if (b0, min_bucket) == (100, 16):
        assert pt_nmf._ladder(b0, min_bucket) == [104, 56, 32, 16]


@pytest.mark.parametrize("B,max_iter,min_bucket", [
    (20, 120, 8),     # ladder (24, 16, 8): padding + two re-packs
    (20, 15, 8),      # max_iter hit mid-ladder: unfinished rows must flush
    (8, 200, 8),      # single-rung ladder == plain solver
])
def test_cd_device_ladder_matches_jax(B, max_iter, min_bucket):
    rng = np.random.RandomState(0)
    N, G, k, pad_k = 60, 40, 6, 8
    X = np.abs(rng.standard_normal((N, G)))
    W0, Ht0 = _mk(B, N, G, k, pad_k, seed=3)
    ladder = tuple(jax_nmf._ladder(B, min_bucket))
    spec_j, n_j, _ = jax_nmf.nmf_cd_device_ladder(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0), tol=1e-3,
        max_iter=max_iter, ladder=ladder)
    spec, n, stage_sweeps = pt_nmf.nmf_cd_device_ladder(
        _t(X), _t(W0), _t(Ht0), tol=1e-3, max_iter=max_iter, ladder=ladder)
    assert spec.shape == (B, pad_k, G) and len(stage_sweeps) == len(ladder)
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(spec.numpy(), np.asarray(spec_j), rtol=0,
                               atol=LADDER_ATOL)
    assert sum(stage_sweeps) == _executed_sweeps(n_j, max_iter)


def test_cd_device_ladder_heterogeneous_convergence_matches_jax():
    """Restarts planted at very different convergence speeds (some start at
    the solution, some from noise): the ladder's early re-packs with mixed
    done patterns, K=4 unpadded."""
    rng = np.random.RandomState(7)
    N, G, k, B = 50, 30, 4, 18
    Wt = np.abs(rng.standard_normal((N, k)))
    Htt = np.abs(rng.standard_normal((G, k)))
    X = Wt @ Htt.T
    W0 = np.abs(rng.standard_normal((B, N, k)))
    Ht0 = np.abs(rng.standard_normal((B, G, k)))
    for b in (1, 4, 5, 11, 16):
        W0[b] = Wt + 1e-5
        Ht0[b] = Htt + 1e-5
    ladder = tuple(jax_nmf._ladder(B, 8))
    spec_j, n_j, _ = jax_nmf.nmf_cd_device_ladder(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0), tol=1e-4,
        max_iter=300, ladder=ladder)
    spec, n, stage_sweeps = pt_nmf.nmf_cd_device_ladder(
        _t(X), _t(W0), _t(Ht0), tol=1e-4, max_iter=300, ladder=ladder)
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(spec.numpy(), np.asarray(spec_j), rtol=0,
                               atol=LADDER_ATOL)
    assert n.numpy()[[1, 4, 5, 11, 16]].max() < 50
    # the fast restarts left the batch: later rungs ran fewer rows
    assert stage_sweeps[0] < sum(stage_sweeps) == _executed_sweeps(n_j, 300)


@pytest.mark.parametrize("beta", [0.0, 1.0, 2.0])
def test_mu_device_ladder_matches_jax(beta):
    rng = np.random.RandomState(2)
    N, G, k, B = 40, 30, 4, 20
    X = np.abs(rng.standard_normal((N, G))) + 0.1
    W0 = np.abs(rng.standard_normal((B, N, k))) + 0.1
    Ht0 = np.abs(rng.standard_normal((B, G, k))) + 0.1
    ladder = tuple(jax_nmf._ladder(B, 8))
    spec_j, n_j, _ = jax_nmf.nmf_mu_device_ladder(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0), beta=beta,
        tol=1e-3, max_iter=200, ladder=ladder)
    spec, n, stage_sweeps = pt_nmf.nmf_mu_device_ladder(
        _t(X), _t(W0), _t(Ht0), beta=beta, tol=1e-3, max_iter=200,
        ladder=ladder)
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(spec.numpy(), np.asarray(spec_j), rtol=0,
                               atol=LADDER_ATOL)
    # MU stops only at its every-10 checks: the rungs end where the JAX
    # package's do
    assert sum(stage_sweeps) == int(np.max(n_j))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1.0)


@pytest.mark.parametrize("max_iter", [15, 23])
def test_cd_segment_blocks_match_jax(max_iter):
    """Sweep blocks past max_iter change nothing, violation_init comes from
    sweep 0, and a segment resumed at it0 > 0 continues the same
    trajectory."""
    rng = np.random.RandomState(4)
    N, G, k, B = 50, 35, 5, 6
    X = np.abs(rng.standard_normal((N, G))) + 0.05
    W0, Ht0 = _mk(B, N, G, k, 8, seed=5)
    zeros = (np.zeros(B), np.zeros(B, np.int32), np.zeros(B, bool))
    out_j = jax_nmf.nmf_cd_segment(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0),
        *(jnp.asarray(z) for z in zeros), jnp.asarray(0, jnp.int32),
        seg_len=max_iter, tol=1e-6)
    out_p = pt_nmf.nmf_cd_segment(_t(X), _t(W0), _t(Ht0),
                                  *(_t(z) for z in zeros), 0,
                                  seg_len=max_iter, tol=1e-6)
    W_j, Ht_j, vi_j, n_j, done_j = (np.asarray(a) for a in out_j)
    np.testing.assert_array_equal(out_p[3].numpy(), n_j)
    np.testing.assert_array_equal(out_p[4].numpy(), done_j)
    assert n_j.max() == max_iter and (vi_j > 0).all()
    np.testing.assert_allclose(out_p[2].numpy(), vi_j, rtol=1e-12)
    assert _rel(out_p[0], W_j) < FACTOR_TOL and _rel(out_p[1], Ht_j) < FACTOR_TOL
    # the same sweeps as two segments, the second from global sweep 8
    first = pt_nmf.nmf_cd_segment(_t(X), _t(W0), _t(Ht0),
                                  *(_t(z) for z in zeros), 0, seg_len=8,
                                  tol=1e-6)
    second = pt_nmf.nmf_cd_segment(_t(X), *first, 8, seg_len=max_iter - 8,
                                   tol=1e-6)
    for a, b in zip(second, out_p):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("max_iter", [15, 23])
def test_cd_and_products_blocks_match_jax(max_iter):
    rng = np.random.RandomState(6)
    N, G, k, B = 45, 30, 4, 5
    X = np.abs(rng.standard_normal((N, G))) + 0.1
    W0, Ht0 = _mk(B, N, G, k, 8, seed=8)
    W_j, Ht_j, n_j = jax_nmf.nmf_coordinate_descent(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0), tol=1e-6,
        max_iter=max_iter, l1_reg_W=0.1, l2_reg_H=0.2)
    W_p, Ht_p, n_p = pt_nmf.nmf_coordinate_descent(
        _t(X), _t(W0), _t(Ht0), tol=1e-6, max_iter=max_iter, l1_reg_W=0.1,
        l2_reg_H=0.2)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    assert int(np.max(n_j)) == max_iter
    assert _rel(W_p, W_j) < FACTOR_TOL and _rel(Ht_p, Ht_j) < FACTOR_TOL

    # the products-given refit (every consensus and k-stats CD refit)
    Wr_j, nr_j = jax_nmf.nnls_cd_fixed_spectra(
        jnp.asarray(X), jnp.asarray(Ht0[:1]), jnp.zeros((1, N, 8)), tol=1e-8,
        max_iter=max_iter, l1_reg=0.3, l2_reg=0.1)
    Wr_p, nr_p = pt_nmf.nnls_cd_fixed_spectra(
        _t(X), _t(Ht0[:1]), torch.zeros(1, N, 8, dtype=torch.float64),
        tol=1e-8, max_iter=max_iter, l1_reg=0.3, l2_reg=0.1)
    np.testing.assert_array_equal(nr_p.numpy(), np.asarray(nr_j))
    assert int(np.max(nr_j)) == max_iter
    assert _rel(Wr_p, Wr_j) < FACTOR_TOL


@pytest.mark.parametrize("beta", [0.0, 1.0])
@pytest.mark.parametrize("max_iter", [15, 23])
def test_mu_blocks_match_jax(beta, max_iter):
    """max_iter off the block: the last block's iterations past max_iter and
    its check past max_iter change nothing."""
    rng = np.random.RandomState(9)
    N, G, k, B = 35, 28, 4, 4
    X = np.abs(rng.standard_normal((N, G))) + 0.1
    W0 = np.abs(rng.standard_normal((B, N, k))) + 0.1
    Ht0 = np.abs(rng.standard_normal((B, G, k))) + 0.1
    W_j, Ht_j, n_j = jax_nmf.nmf_multiplicative_update(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0), beta=beta,
        tol=1e-6, max_iter=max_iter)
    W_p, Ht_p, n_p = pt_nmf.nmf_multiplicative_update(
        _t(X), _t(W0), _t(Ht0), beta=beta, tol=1e-6, max_iter=max_iter)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    assert int(np.max(n_j)) == max_iter
    assert _rel(W_p, W_j) < FACTOR_TOL and _rel(Ht_p, Ht_j) < FACTOR_TOL


@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_step_sums_do_not_depend_on_the_batch(beta):
    """``mu_kernels.restart_sums`` gives each restart's row sums, and it and
    the divergence give a restart the same bits on any sub-batch in any
    order (the ladder's gathers) as in the whole batch, M off the sum's
    segments and B off the divergence's chunks."""
    rng = np.random.RandomState(12)
    N, G, K, B = 45, 101, 8, 20
    X = torch.from_numpy(rng.rand(N, G).astype(np.float32))
    W = torch.from_numpy(rng.rand(B, N, K).astype(np.float32))
    Ht = torch.from_numpy(rng.rand(B, G, K).astype(np.float32))
    sums = mk.restart_sums(Ht)
    np.testing.assert_allclose(sums.numpy(), Ht.numpy().astype(np.float64)
                               .sum(axis=1), rtol=1e-5)
    err = pt_nmf.beta_divergence_error(X, W, Ht, beta)
    for idx in (torch.arange(16), torch.from_numpy(rng.permutation(B)[:8])):
        assert torch.equal(mk.restart_sums(Ht[idx]), sums[idx])
        assert torch.equal(pt_nmf.beta_divergence_error(X, W[idx], Ht[idx],
                                                        beta), err[idx])


def test_device_ladder_knob(monkeypatch):
    """Unset, the knob leaves the CPU on the plain solver; '1' and '0' force
    it; an explicit argument wins over the knob."""
    cpu = torch.zeros(1)
    monkeypatch.delenv("CNMF_TPU_DEVICE_LADDER", raising=False)
    assert not pt_solvers.device_ladder_enabled(cpu)
    assert pt_solvers.device_ladder_enabled(cpu, ladder=True)
    monkeypatch.setenv("CNMF_TPU_DEVICE_LADDER", "1")
    assert pt_solvers.device_ladder_enabled(cpu)
    assert not pt_solvers.device_ladder_enabled(cpu, ladder=False)
    monkeypatch.setenv("CNMF_TPU_DEVICE_LADDER", "0")
    assert not pt_solvers.device_ladder_enabled(cpu)
    assert pt_solvers.device_ladder_enabled(cpu, ladder=True)
    # off CUDA no kernel splits a contraction: every rung stays
    for kw in (stages.nmf_run_params(),
               stages.nmf_run_params(beta_loss="itakura-saito")):
        assert pt_solvers.ladder_rungs(cpu, 100, 16, kw) == (104, 56, 32, 16)
    with pytest.raises(ValueError, match="ladder"):
        pt_nmf.nmf_cd_device_ladder(cpu, torch.zeros(20, 3, 8),
                                    torch.zeros(20, 4, 8), ladder=(16, 8))


@pytest.mark.parametrize("beta_loss", ["frobenius", "kullback-leibler"])
def test_factorize_k_ladder_on_off_same_spectra(beta_loss):
    """In one process, the ladder chosen by argument: ``factorize_k`` gives
    the same spectra and sweeps on the device ladder as with the plain
    solver, in f64 (and the plain solver's are the JAX package's, held by
    tests/test_torch_nmf.py and tests/test_torch_mu.py)."""
    rng = np.random.RandomState(11)
    counts = rng.poisson(np.abs(rng.standard_normal((80, 120))) * 2.0)
    counts = counts.astype(float)
    counts[counts.sum(1) == 0, 0] = 1
    prep = stages.prepare_arrays(counts, num_highvar_genes=60)
    X = np.ascontiguousarray(prep.norm)
    kw = stages.nmf_run_params(beta_loss=beta_loss, max_iter=300)
    _, seeds = stages.replicate_seeds([5], 21, 9)
    spec_off, n_off, exec_off = stages.factorize_k(X, _t(X), 5, seeds, kw,
                                                   ladder=False)
    spec_on, n_on, exec_on = stages.factorize_k(X, _t(X), 5, seeds, kw,
                                                ladder=True)
    np.testing.assert_array_equal(n_on, n_off)
    np.testing.assert_allclose(spec_on, spec_off, rtol=0, atol=1e-12)
    # ladder (24, 16): 3 padding rows, and 21 restarts' blocks in the plain
    assert exec_off == 21 * _executed_sweeps(n_off, 300)
    assert exec_on <= 24 * _executed_sweeps(n_off, 300)
    assert spec_on.shape == (21, 5, 60)
