"""The port's multiplicative-update path (cnmf_tpu_torch.ops.mu_kernels,
ops.nmf's MU solver, pipeline.solvers' MU branches) against the JAX package
on the same numpy inputs, on the CPU.

* The plain versions of the five MU kernels against the Pallas kernels of
  cnmf_tpu/ops/pallas_mu.py in interpret mode, in f32, at the bounds of
  tests/test_pallas_kernels.py (rtol 2e-5 for the KL numerators, 3e-5 for
  the general-beta terms, 1e-4 relative for the divergence term).
* The solvers against the JAX package's XLA path (use_pallas=False) in f64:
  identical iteration counts, factors to 1e-6.

The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cnmf_tpu.ops.pallas_mu as pm
from cnmf_tpu.ops import init as jax_init
from cnmf_tpu.ops import nmf as jax_nmf
from cnmf_tpu.pipeline import solvers as jax_solvers
from cnmf_tpu_torch.ops import mu_kernels as mk
from cnmf_tpu_torch.ops import nmf as pt_nmf
from cnmf_tpu_torch.pipeline import solvers as pt_solvers

NUM_RTOL = 2e-5
BETA_RTOL = 3e-5
XLOGWH_REL = 1e-4
FACTOR_TOL = 1e-6
KERNELS = ["kl_mu_w_numerator", "kl_mu_h_numerator", "kl_x_log_wh"]
BETA_KERNELS = ["beta_mu_w_terms", "beta_mu_h_terms"]


@pytest.fixture
def interpret_mode(monkeypatch):
    for name in KERNELS + BETA_KERNELS:
        monkeypatch.setattr(
            pm, name, functools.partial(getattr(pm, name), interpret=True)
        )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def kernel_problem(B, K, N=203, G=96, seed=0):
    """f32 inputs with two zero K-bucket columns in both factors; N is off
    the Pallas row tile, so the JAX kernels pad rows."""
    rng = np.random.RandomState(seed)
    X = rng.gamma(1, 1, (N, G)).astype(np.float32)
    X[rng.rand(N, G) < 0.2] = 0.0   # entries at or below eps drop out
    W = np.abs(rng.randn(B, N, K)).astype(np.float32)
    Ht = np.abs(rng.randn(B, G, K)).astype(np.float32)
    W[:, :, -2:] = 0.0
    Ht[:, :, -2:] = 0.0
    return X, W, Ht


@pytest.mark.parametrize("K", [8, 16])
@pytest.mark.parametrize("B", [3, 5])
@pytest.mark.parametrize("name", KERNELS)
def test_kl_kernel_plain_matches_pallas_interpret(interpret_mode, name, B, K):
    X, W, Ht = kernel_problem(B, K)
    ref = np.asarray(getattr(pm, name)(jnp.asarray(X), jnp.asarray(W),
                                       jnp.asarray(Ht)))
    out = getattr(mk, name)(_t(X), _t(W), _t(Ht)).numpy()
    assert out.shape == ref.shape
    if name == "kl_x_log_wh":
        np.testing.assert_array_less(np.abs(out - ref) / np.abs(ref),
                                     XLOGWH_REL)
    else:
        np.testing.assert_allclose(out, ref, rtol=NUM_RTOL)
        assert not out[:, :, -2:].any()


@pytest.mark.parametrize("K", [8, 16])
@pytest.mark.parametrize("B", [1, 3, 5])
@pytest.mark.parametrize("beta", [0.0, 0.5, 1.5, 3.0])
def test_beta_terms_plain_matches_pallas_interpret(interpret_mode, beta, B, K):
    """Both general-beta kernels, numerator and denominator; beta 0 is
    Itakura-Saito, 0.5 floors both exponents' bases, 1.5 the numerator's
    only, 3 neither. B=1 is the consensus refits' batch."""
    X, W, Ht = kernel_problem(B, K, seed=1)
    for name in BETA_KERNELS:
        ref = getattr(pm, name)(jnp.asarray(X), jnp.asarray(W),
                                jnp.asarray(Ht), beta)
        out = getattr(mk, name)(_t(X), _t(W), _t(Ht), beta)
        for a, b in zip(out, ref):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=BETA_RTOL)
            assert not a[:, :, -2:].any()


SMS, ROWS, CHUNK = 132, 128, 32   # an H100's SMs; one-row rows, split chunk
# blocks of each one-row kernel an H100 SM holds at once, by bucket, as its
# split build reports them (the general-beta terms at beta 0, and the KL
# divergence term)
PER_SM = {"beta_terms": {8: 7, 16: 4, 24: 3, 40: 2, 64: 2, 72: 2},
          "kl_x_log_wh": {8: 9, 16: 8, 24: 10, 40: 5, 64: 4, 72: 5}}
PLANNED = sorted(PER_SM)   # the kernels that split their contraction
REFITS = [(1, 2700, 2000), (1, 10000, 2700)]   # usage, spectra (B, M, C)


def _plan(kernel, B, M, C, K):
    """The plan on an H100; a wide K (> 64) cannot split (chunk 0)."""
    return mk.split_plan(B, M, C, SMS, ROWS, PER_SM[kernel][K],
                         0 if K > 64 else CHUNK)


def _waves(B, M, splits, sms=SMS):
    return B * -(-M // ROWS) * splits / sms


@pytest.mark.parametrize("K", [8, 16])
@pytest.mark.parametrize("B,M,C", REFITS)
@pytest.mark.parametrize("kernel", PLANNED)
def test_beta_terms_plan_splits_the_refits(kernel, B, M, C, K):
    """The B=1 refits' one-row grid (22 and 79 blocks) is split into 2-4
    waves of one block an SM."""
    splits, per_split = _plan(kernel, B, M, C, K)
    assert splits > 1
    assert 2 <= _waves(B, M, splits) <= 4


@pytest.mark.parametrize("K", [8, 16])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("kernel", PLANNED)
def test_beta_terms_plan_keeps_the_factorize_whole(kernel, transposed, K):
    """B=100 restarts of the PBMC-3k shape, either side: one slice."""
    N, G = 2700, 2000
    M, C = (G, N) if transposed else (N, G)
    assert _plan(kernel, 100, M, C, K) == (1, C)


@pytest.mark.parametrize("B,M,C,K", [
    (1, 2700, 2000, 16), (1, 10000, 2700, 16), (1, 2700, 2000, 8),
    (1, 2700, 2000, 40), (1, 2700, 2000, 64), (3, 300, 150, 8),
    (13, 522, 97, 8), (1, 257, 61, 16), (1, 5000, 65, 16),
    (7, 2700, 2000, 24), (1, 2700, 2000, 72)])
@pytest.mark.parametrize("kernel", PLANNED)
def test_beta_terms_plan_slices_cover_the_contraction(kernel, B, M, C, K):
    """Every slice but the last holds a whole number of 32-entry chunks, at
    least 2; the last takes the rest, at least one entry; the grid stays
    within the blocks an SM holds (and 4 waves). A wide K is never split."""
    splits, per_split = _plan(kernel, B, M, C, K)
    if K > 64 or splits == 1:
        assert (splits, per_split) == (1, C)
        return
    assert per_split % CHUNK == 0 and per_split >= 2 * CHUNK
    last = C - (splits - 1) * per_split
    assert 1 <= last <= per_split
    assert _waves(B, M, splits) <= min(4, PER_SM[kernel][K])


def _per_split(C, splits):
    """Entries a slice for ``splits`` slices of whole 32-entry chunks."""
    chunks = -(-C // CHUNK)
    per_split = -(-chunks // splits) * CHUNK
    assert -(-C // per_split) == splits
    return per_split


@pytest.mark.parametrize("splits", [1, 3, 7])
@pytest.mark.parametrize("beta", [0.0, 1.5])
@pytest.mark.parametrize("view", [False, True])
def test_split_order_plain_matches_pallas_interpret(interpret_mode, view,
                                                    beta, splits):
    """The split kernel's order in plain PyTorch (each slice's partial, then
    the slices in order) at B=1 with C = 217, off the 32-entry chunks: f32
    against the Pallas kernel in interpret mode, and f64 against the unsplit
    plain version; X row-major or a transposed view."""
    X, W, Ht = kernel_problem(1, 16, G=217, seed=4)
    per_split = _per_split(X.shape[1], splits)
    ref = pm.beta_mu_w_terms(jnp.asarray(X), jnp.asarray(W), jnp.asarray(Ht),
                             beta)

    def x_of(a):
        return _t(a.T).T if view else _t(a)

    out = mk.mu_w_terms_plain(x_of(X), _t(W), _t(Ht), beta,
                              per_split=per_split)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=BETA_RTOL)
        assert not a[:, :, -2:].any()
    X64, W64, Ht64 = (a.astype(np.float64) for a in (X, W, Ht))
    split = mk.mu_w_terms_plain(x_of(X64), _t(W64), _t(Ht64), beta,
                                per_split=per_split)
    whole = mk.mu_w_terms_plain(_t(X64), _t(W64), _t(Ht64), beta)
    for a, b in zip(split, whole):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=0)


@pytest.mark.parametrize("splits", [1, 3, 7])
@pytest.mark.parametrize("view", [False, True])
def test_x_log_wh_split_order_plain_matches_pallas_interpret(interpret_mode,
                                                             view, splits):
    """The divergence term's split order in plain PyTorch (each slice's sum,
    then the slices in order) at B=1 with C = 217, off the 32-entry chunks:
    f32 against the Pallas kernel in interpret mode, and f64 against the
    unsplit plain version; X row-major or a transposed view (the spectra
    refit's X)."""
    X, W, Ht = kernel_problem(1, 16, G=217, seed=5)
    per_split = _per_split(X.shape[1], splits)
    ref = np.asarray(pm.kl_x_log_wh(jnp.asarray(X), jnp.asarray(W),
                                    jnp.asarray(Ht)))

    def x_of(a):
        return _t(a.T).T if view else _t(a)

    out = mk.kl_x_log_wh_plain(x_of(X), _t(W), _t(Ht), per_split=per_split)
    assert out.shape == ref.shape == (1,)
    np.testing.assert_array_less(np.abs(out.numpy() - ref) / np.abs(ref),
                                 XLOGWH_REL)
    X64, W64, Ht64 = (a.astype(np.float64) for a in (X, W, Ht))
    split = mk.kl_x_log_wh_plain(x_of(X64), _t(W64), _t(Ht64),
                                 per_split=per_split)
    whole = mk.kl_x_log_wh_plain(_t(X64), _t(W64), _t(Ht64))
    torch.testing.assert_close(split, whole, rtol=1e-12, atol=0)


def test_beta_wrappers_refuse_kl_and_frobenius():
    X, W, Ht = (_t(a) for a in kernel_problem(3, 8))
    for name in BETA_KERNELS:
        for beta in (1.0, 2.0):
            with pytest.raises(ValueError, match="own path"):
                getattr(mk, name)(X, W, Ht, beta)


def test_plain_versions_are_chunk_invariant(monkeypatch):
    """The restart chunking only bounds memory: one chunk and chunks of 2
    give the same bits."""
    X, W, Ht = (_t(a).double() for a in kernel_problem(5, 8, seed=3))
    for plain in (mk.kl_mu_w_numerator_plain, mk.kl_mu_h_numerator_plain,
                  mk.kl_x_log_wh_plain,
                  functools.partial(mk.beta_mu_w_terms_plain, beta=0.0),
                  functools.partial(mk.beta_mu_h_terms_plain, beta=1.5)):
        one = plain(X, W, Ht)
        monkeypatch.setattr(mk, "CHUNK", 2)
        torch.testing.assert_close(plain(X, W, Ht), one, rtol=0, atol=0)
        monkeypatch.undo()


def test_cpu_tensors_launch_nothing(monkeypatch):
    """CPU tensors take the plain versions: nothing is built and no launch
    is counted."""
    import sys

    from cnmf_tpu_torch.ops.kernel_lib import load_library

    monkeypatch.setitem(sys.modules, "triton", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    for name in KERNELS + BETA_KERNELS:
        monkeypatch.setattr(getattr(mk, name), "launches", 0)
        monkeypatch.setattr(getattr(mk, name), "launches_b1", 0)
    X, W, Ht = (_t(a) for a in kernel_problem(3, 8))
    for name in KERNELS:
        getattr(mk, name)(X, W, Ht)
    for name in BETA_KERNELS:
        getattr(mk, name)(X, W, Ht, 0.0)
    assert [getattr(mk, name).launches for name in KERNELS + BETA_KERNELS] \
        == [0] * 5
    assert not any(fn.launches_b1 for fn in mk.WRAPPERS)
    assert load_library.cache_info().currsize == 0


def make_counts(n=60, g=40, k=4, seed=0):
    rng = np.random.RandomState(seed)
    W = rng.gamma(2.0, 1.0, (n, k))
    H = rng.gamma(2.0, 1.0, (k, g))
    return rng.poisson(W @ H).astype(np.float64) + 0.1


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / max(
        np.max(np.abs(np.asarray(b))), 1.0)


@pytest.mark.parametrize("regs", [(0.0, 0.0, 0.0, 0.0), (0.3, 0.1, 0.2, 0.4)])
@pytest.mark.parametrize("update_H", [True, False])
@pytest.mark.parametrize("beta", [1.0, 0.0, 2.0])
def test_mu_solver_matches_jax_f64(beta, update_H, regs):
    X = make_counts()
    W0, Ht0 = jax_init.random_init_batch(X, 5, [11, 12, 13], dtype=np.float64)
    l1w, l1h, l2w, l2h = regs
    kw = dict(beta=beta, tol=1e-4, max_iter=200, update_H=update_H,
              l1_reg_W=l1w, l1_reg_H=l1h, l2_reg_W=l2w, l2_reg_H=l2h)
    W_j, Ht_j, n_j = jax_nmf.nmf_multiplicative_update(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0), use_pallas=False,
        chunk=2, **kw)
    W_p, Ht_p, n_p = pt_nmf.nmf_multiplicative_update(_t(X), _t(W0), _t(Ht0),
                                                      **kw)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    assert n_p.dtype == torch.int32
    assert _rel(W_p.numpy(), W_j) < FACTOR_TOL
    assert _rel(Ht_p.numpy(), Ht_j) < FACTOR_TOL
    if not update_H:
        np.testing.assert_array_equal(Ht_p.numpy(), Ht0)


@pytest.mark.parametrize("beta", [1.0, 0.0, 0.5])
def test_beta_divergence_error_matches_jax_f64(beta):
    X = make_counts(seed=2)
    X[:5, :5] = 0.0
    W0, Ht0 = jax_init.random_init_batch(X, 4, [1, 2, 3], dtype=np.float64)
    err_j = jax_nmf.beta_divergence_error(jnp.asarray(X), jnp.asarray(W0),
                                          jnp.asarray(Ht0), beta, chunk=2)
    err_p = pt_nmf.beta_divergence_error(_t(X), _t(W0), _t(Ht0), beta)
    np.testing.assert_allclose(err_p.numpy(), np.asarray(err_j), rtol=1e-12)


def test_nnls_multiplicative_update_matches_jax():
    X = make_counts(seed=1)
    H = np.abs(np.random.RandomState(2).randn(6, X.shape[1]))
    W_j, n_j = jax_nmf.nnls_multiplicative_update(
        jnp.asarray(X), jnp.asarray(H), beta=1.0, tol=1e-4, max_iter=200,
        l1_reg_W=0.2, l2_reg_W=0.1)
    W_p, n_p = pt_nmf.nnls_multiplicative_update(
        _t(X), _t(H), beta=1.0, tol=1e-4, max_iter=200, l1_reg_W=0.2,
        l2_reg_W=0.1)
    assert n_p == n_j
    assert W_p.shape == (X.shape[0], 6)
    assert _rel(W_p.numpy(), W_j) < FACTOR_TOL


MU_KWARGS = dict(solver="mu", beta_loss="kullback-leibler", tol=1e-4,
                 max_iter=200, alpha_W=0.01, alpha_H="same", l1_ratio=0.5)


def test_mu_refit_usages_matches_jax():
    """k = 6 is off the bucket of 8: the MU init spreads the real k's value
    over the padded columns, whose usages go to 0 and are cut."""
    X = make_counts(seed=3)
    spectra = np.abs(np.random.RandomState(4).randn(6, X.shape[1]))
    rf_j = jax_solvers.refit_usages(X, spectra, MU_KWARGS, dtype=np.float64)
    rf_p = pt_solvers.refit_usages(_t(X), spectra, MU_KWARGS)
    assert rf_p.shape == rf_j.shape == (X.shape[0], 6)
    assert _rel(rf_p, rf_j) < FACTOR_TOL


def test_mu_refit_spectra_transposed_matches_jax():
    X = make_counts(seed=5)
    usages = np.abs(np.random.RandomState(6).randn(X.shape[0], 5))
    sp_j = jax_solvers.refit_spectra_transposed(X, usages, MU_KWARGS,
                                                dtype=np.float64)
    sp_p = pt_solvers.refit_spectra_transposed(_t(X), usages, MU_KWARGS)
    assert sp_p.shape == sp_j.shape == (X.shape[1], 5)
    assert _rel(sp_p, sp_j) < FACTOR_TOL


def test_solve_nmf_batch_mu_matches_jax():
    """The kwargs route: solver='mu' with a beta loss by name, the
    regularization scaled as sklearn scales it."""
    X = make_counts(seed=7)
    W0, Ht0 = jax_init.random_init_batch(X, 6, [5, 6], dtype=np.float64)
    pad = ((0, 0), (0, 0), (0, 2))
    W0, Ht0 = np.pad(W0, pad), np.pad(Ht0, pad)
    _, Ht_j, n_j = jax_solvers.solve_nmf_batch(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0), MU_KWARGS,
        allow_pallas=False)
    _, Ht_p, n_p = pt_solvers.solve_nmf_batch(_t(X), _t(W0), _t(Ht0),
                                              MU_KWARGS)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    assert _rel(Ht_p.numpy(), Ht_j) < FACTOR_TOL
    assert not Ht_p[:, :, 6:].any()
