"""The port's CD solver (cnmf_tpu_torch.ops.nmf, pipeline.solvers) against the
JAX package on the same numpy inputs, in float64 on the CPU: the sklearn
parity contract — identical sweep counts, factors to 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnmf_tpu.ops import init as jax_init
from cnmf_tpu.ops import nmf as jax_nmf
from cnmf_tpu.pipeline import solvers as jax_solvers
from cnmf_tpu_torch.ops import init as pt_init
from cnmf_tpu_torch.ops import nmf as pt_nmf
from cnmf_tpu_torch.ops.cd_kernels import factors_from_numpy
from cnmf_tpu_torch.pipeline import solvers as pt_solvers
from torch_knobs import one_torch_thread  # noqa: F401 (autouse)

FACTOR_TOL = 1e-6


def make_counts(n=60, g=40, k=4, seed=0):
    rng = np.random.RandomState(seed)
    W = rng.gamma(2.0, 1.0, (n, k))
    H = rng.gamma(2.0, 1.0, (k, g))
    return rng.poisson(W @ H).astype(np.float64) + 0.1


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / max(
        np.max(np.abs(np.asarray(b))), 1.0)


@pytest.mark.parametrize("update_H", [True, False])
@pytest.mark.parametrize("regs", [(0.0, 0.0, 0.0, 0.0), (0.3, 0.1, 0.2, 0.4)])
def test_cd_solver_matches_jax_f64(update_H, regs):
    X = make_counts()
    W0, Ht0 = jax_init.random_init_batch(X, 5, [11, 12, 13], dtype=np.float64)
    if not update_H:
        W0 = np.zeros_like(W0)
    l1w, l1h, l2w, l2h = regs
    kw = dict(tol=1e-4, max_iter=300, update_H=update_H, l1_reg_W=l1w,
              l1_reg_H=l1h, l2_reg_W=l2w, l2_reg_H=l2h)
    W_j, Ht_j, n_j = jax_nmf.nmf_coordinate_descent(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0), **kw)
    W0t, Ht0t = factors_from_numpy(W0, Ht0, device="cpu", dtype=np.float64)
    W_p, Ht_p, n_p = pt_nmf.nmf_coordinate_descent(torch.from_numpy(X), W0t,
                                                   Ht0t, **kw)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    assert _rel(W_p.numpy(), W_j) < FACTOR_TOL
    assert _rel(Ht_p.numpy(), Ht_j) < FACTOR_TOL


def test_nnls_fixed_spectra_and_refit_usages_match_jax():
    X = make_counts(seed=1)
    rng = np.random.RandomState(2)
    spectra = np.abs(rng.randn(6, X.shape[1]))   # (k, genes), k off-bucket
    kwargs = dict(solver="cd", beta_loss="frobenius", tol=1e-4, max_iter=200,
                  alpha_W=0.0, alpha_H=0.0, l1_ratio=0.0)
    rf_j = jax_solvers.refit_usages(X, spectra, kwargs, dtype=np.float64)
    rf_p = pt_solvers.refit_usages(torch.from_numpy(X), spectra, kwargs)
    assert rf_p.shape == rf_j.shape == (X.shape[0], 6)
    assert _rel(rf_p, rf_j) < FACTOR_TOL

    Ht0 = np.ascontiguousarray(spectra.T)[None]
    W0 = np.zeros((1, X.shape[0], 6))
    W_j, n_j = jax_nmf.nnls_cd_fixed_spectra(
        jnp.asarray(X), jnp.asarray(Ht0), jnp.asarray(W0), tol=1e-4,
        max_iter=200, l1_reg=0.5, l2_reg=0.25)
    W_p, n_p = pt_nmf.nnls_cd_fixed_spectra(
        torch.from_numpy(X), torch.from_numpy(Ht0), torch.from_numpy(W0),
        tol=1e-4, max_iter=200, l1_reg=0.5, l2_reg=0.25)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    assert _rel(W_p.numpy(), W_j) < FACTOR_TOL


def test_refit_spectra_transposed_matches_jax():
    X = make_counts(seed=3)
    usages = np.abs(np.random.RandomState(4).randn(X.shape[0], 5))
    kwargs = dict(solver="cd", beta_loss="frobenius", tol=1e-4, max_iter=200,
                  alpha_W=0.01, alpha_H="same", l1_ratio=0.5)
    sp_j = jax_solvers.refit_spectra_transposed(X, usages, kwargs,
                                                dtype=np.float64)
    sp_p = pt_solvers.refit_spectra_transposed(torch.from_numpy(X), usages,
                                               kwargs)
    assert sp_p.shape == sp_j.shape == (X.shape[1], 5)
    assert _rel(sp_p, sp_j) < FACTOR_TOL


def test_k_padding_exact_noop():
    """Zero-padding K is an exact no-op: same sweep counts, same real block,
    padded columns stay 0."""
    X = torch.from_numpy(make_counts(40, 30, seed=9))
    W0, H0 = pt_init.random_init(X.numpy(), 5, 21, dtype=np.float64)
    W0, Ht0 = W0[None], np.ascontiguousarray(H0.T)[None]
    pad = ((0, 0), (0, 0), (0, 3))
    W, Ht, n = pt_nmf.nmf_coordinate_descent(
        X, torch.from_numpy(W0), torch.from_numpy(Ht0), max_iter=300)
    Wp, Htp, n_p = pt_nmf.nmf_coordinate_descent(
        X, torch.from_numpy(np.pad(W0, pad)), torch.from_numpy(np.pad(Ht0, pad)),
        max_iter=300)
    assert int(n[0]) == int(n_p[0])
    np.testing.assert_allclose(Wp[0, :, :5].numpy(), W[0].numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(Htp[0, :, :5].numpy(), Ht[0].numpy(),
                               rtol=1e-12, atol=1e-12)
    assert not Wp[0, :, 5:].any() and not Htp[0, :, 5:].any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_random_init_batch_bit_identical(dtype):
    X = make_counts(seed=5).astype(dtype)
    seeds = [7, 1234567, 2**31 - 2]
    W_j, Ht_j = jax_init.random_init_batch(X, 6, seeds, dtype=dtype)
    W_p, Ht_p = pt_init.random_init_batch(X, 6, seeds, dtype=dtype)
    np.testing.assert_array_equal(W_p, W_j)
    np.testing.assert_array_equal(Ht_p, Ht_j)
    assert W_p.dtype == np.dtype(dtype)
    for solver in ("cd", "mu"):
        w_p = pt_init.nnls_w_init(torch.from_numpy(X), 4, solver, pad_k=8)
        w_j = jax_init.nnls_w_init(X, 4, solver, dtype=dtype)
        assert w_p.shape == (1, X.shape[0], 8)
        assert w_p.numpy().dtype == W_p.dtype
        np.testing.assert_allclose(w_p[0, :, :4].numpy(), w_j, rtol=1e-6)
        # MU spreads the real k's value over the padded columns
        np.testing.assert_array_equal(w_p[0, :, 4:].numpy(),
                                      w_p[0, :, :4].numpy())


def test_frobenius_error_matches_jax():
    X = make_counts(seed=6)
    W0, Ht0 = jax_init.random_init_batch(X, 4, [1, 2], dtype=np.float64)
    err_j = jax_nmf.frobenius_error(jnp.asarray(X), jnp.asarray(W0),
                                    jnp.asarray(Ht0))
    err_p = pt_nmf.frobenius_error(torch.from_numpy(X), torch.from_numpy(W0),
                                   torch.from_numpy(Ht0))
    np.testing.assert_allclose(err_p.numpy(), np.asarray(err_j), rtol=1e-10)


def test_mu_solver_not_ported_raises():
    """Off the CPU, MU at every beta reaches a kernel wrapper, which refuses
    a device it has no kernel for before any work (meta tensors stand in
    for one) instead of running its plain version there. The divergence at
    beta ∉ {1, 2} is plain torch ops on any device (the JAX package has no
    kernel for it)."""
    W0 = torch.ones(1, 60, 8, device="meta")
    Ht0 = torch.ones(1, 40, 8, device="meta")
    X = torch.ones(60, 40, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pt_solvers.solve_nmf_batch(
            X, W0, Ht0, dict(solver="mu", beta_loss="itakura-saito"))
    err = pt_nmf.beta_divergence_error(X, W0, Ht0, 0.5)
    assert err.shape == (1,) and err.device.type == "meta"
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pt_solvers.solve_nmf_batch(
            X, W0, Ht0, dict(solver="mu", beta_loss="kullback-leibler"))
    assert pt_solvers.beta_loss_to_float("itakura-saito") == 0.0
    assert pt_solvers.compute_regularization(0.1, "same", 0.5, (10, 20)) == \
        jax_solvers.compute_regularization(0.1, "same", 0.5, (10, 20))


@pytest.mark.parametrize("solver", ["cd", "mu"])
def test_wide_k_solve_matches_jax(solver):
    """K = 70, padded to 72 (the card runs the kernels' wide variants there):
    the same iteration counts and factors as the JAX package at K = 70."""
    X = make_counts(n=90, g=80, k=6, seed=8)
    W0, Ht0 = jax_init.random_init_batch(X, 70, [3, 4], dtype=np.float64)
    kwargs = dict(solver=solver, tol=1e-4, max_iter=40, alpha_W=0.0,
                  alpha_H="same", l1_ratio=0.0,
                  beta_loss="frobenius" if solver == "cd" else "itakura-saito")
    W_j, Ht_j, n_j = jax_solvers.solve_nmf_batch(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0), kwargs,
        allow_pallas=False)
    pad = ((0, 0), (0, 0), (0, 2))
    W0t, Ht0t = factors_from_numpy(np.pad(W0, pad), np.pad(Ht0, pad),
                                   device="cpu", dtype=np.float64)
    W_p, Ht_p, n_p = pt_solvers.solve_nmf_batch(torch.from_numpy(X), W0t,
                                                Ht0t, kwargs)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    assert _rel(W_p[:, :, :70].numpy(), W_j) < FACTOR_TOL
    assert _rel(Ht_p[:, :, :70].numpy(), Ht_j) < FACTOR_TOL
    assert not W_p[:, :, 70:].any() and not Ht_p[:, :, 70:].any()


def test_atlas_f32_stop_rule_matches_jax():
    """The atlas recipe (extras/atlas_validate.synthesize) at 2,000 cells ×
    1,000 genes, 200 HVGs, K=12 (padded to 16) × 3 restarts, float32: the
    plain CD solves of both packages stop at the same sweep of every
    restart, well before max_iter, where the port's float64 solve stops
    too. (On the card
    the atlas at 100,000 cells runs its float32 restarts to max_iter, the
    kernels and the plain float32 solve alike; the stop rule is the JAX
    package's.)"""
    from extras.atlas_validate import synthesize
    from cnmf_tpu_torch.pipeline import stages

    prep = stages.prepare_arrays(synthesize(2000, 1000, block=1000),
                                 num_highvar_genes=200)
    norm = prep.norm.toarray() if hasattr(prep.norm, "toarray") else prep.norm
    n_iter, inputs = {}, {}
    for dtype in (np.float64, np.float32):
        X = np.ascontiguousarray(norm, dtype=dtype)
        W0, Ht0 = jax_init.random_init_batch(X, 12, [1, 2, 3], dtype=dtype)
        pad = ((0, 0), (0, 0), (0, 4))
        W0, Ht0 = np.pad(W0, pad), np.pad(Ht0, pad)
        inputs[dtype] = X, W0, Ht0
        _, _, n = pt_nmf.nmf_coordinate_descent(
            torch.from_numpy(X), torch.from_numpy(W0), torch.from_numpy(Ht0),
            tol=1e-4, max_iter=1000)
        n_iter[dtype] = n.numpy()
    _, _, n_j = jax_nmf.nmf_coordinate_descent(
        *map(jnp.asarray, inputs[np.float32]), tol=1e-4, max_iter=1000)
    np.testing.assert_array_equal(n_iter[np.float32], np.asarray(n_j))
    assert n_iter[np.float32].max() < 100
    np.testing.assert_array_equal(n_iter[np.float32], n_iter[np.float64])
