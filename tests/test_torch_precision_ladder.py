"""The port's float32 product precision (``utils.precision``,
CNMF_TPU_MATMUL_PRECISION) and its MU precision ladder
(``ops.nmf.nmf_mu_precision_ladder``, CNMF_TPU_MU_PRECISION_LADDER) against
the JAX package on the CPU, and the plain twins of the ladder's TF32
kernels.

On the CPU every product precision is full precision in both packages (XLA's
CPU backend ignores the setting, the port takes its TF32 route on CUDA
only), so at f64 the port's ladder gives the JAX ladder's n_iter exactly and
its factors within 1e-10. The TF32 twins (``mu_kernels.*_tf32_plain``)
round F, Fo and the elementwise factor with ``tf32_round``, which is held
bit for bit to a numpy reference; each twin is held to the f32 plain terms
within TF32's first-order error bound. The kernels themselves are held to
the twins on a card (tests/test_torch_tf32_card.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnmf_tpu.ops import nmf as jax_nmf
from cnmf_tpu.ops.init import random_init_batch
from cnmf_tpu.pipeline import solvers as jax_solvers
from cnmf_tpu_torch.ops import mu_kernels as mk
from cnmf_tpu_torch.ops import nmf as pt_nmf
from cnmf_tpu_torch.pipeline import solvers
from cnmf_tpu_torch.utils import precision
from torch_handoff import one_torch_thread  # noqa: F401 (autouse)
from torch_knobs import host_draws_by_default  # noqa: F401 (autouse)

MAX_ITER = 200
FACTOR_REL = 1e-10
# TF32 keeps 10 mantissa bits: each rounding is within u = 2^-11 relative
TF32_U = 2.0 ** -11
BETAS = {"kullback-leibler": 1.0, "itakura-saito": 0.0}


def _problem(seed=4, n=60, g=45, k=4, b=6):
    rng = np.random.RandomState(seed)
    X = np.abs(rng.randn(n, g)) + 0.05
    seeds = rng.randint(1, 2**31 - 1, size=b)
    W0, Ht0 = random_init_batch(X, k, seeds, dtype=np.float64)
    return X, W0, Ht0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flags():
    return (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("name,mode,tf32", [
    (None, "highest", False), ("highest", "highest", False),
    ("high", "high", True), ("default", "medium", True)])
def test_matmul_precision_knob(monkeypatch, name, mode, tf32):
    """CNMF_TPU_MATMUL_PRECISION → torch's float32 mode, as the package
    sets it on import (unset: full float32, TF32 off)."""
    if name is None:
        monkeypatch.delenv("CNMF_TPU_MATMUL_PRECISION", raising=False)
    else:
        monkeypatch.setenv("CNMF_TPU_MATMUL_PRECISION", name)
    before = _flags()
    try:
        precision.set_mode(precision.knob_mode())
        assert _flags() == (mode, tf32, tf32)
    finally:
        precision.set_mode(before[0])
    assert _flags() == before
    monkeypatch.setenv("CNMF_TPU_MATMUL_PRECISION", "bf16")
    with pytest.raises(ValueError, match="CNMF_TPU_MATMUL_PRECISION"):
        precision.knob_mode()


@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_ladder_matches_jax_at_f64(beta):
    """The two phases, the carried stop rule and the summed sweeps: the JAX
    ladder's n_iter exactly, its factors within 1e-10 relative (KL: some
    restarts exhaust max_iter in the coarse phase, some stop before)."""
    X, W0, Ht0 = _problem()
    W, Ht, n = pt_nmf.nmf_mu_precision_ladder(
        _t(X), _t(W0), _t(Ht0), beta=beta, tol=1e-4, max_iter=MAX_ITER)
    Wj, Htj, nj = jax_nmf.nmf_mu_precision_ladder(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0), beta=beta,
        tol=1e-4, max_iter=MAX_ITER)
    np.testing.assert_array_equal(n.numpy(), np.asarray(nj))
    assert _rel(W, Wj) < FACTOR_REL and _rel(Ht, Htj) < FACTOR_REL


@pytest.mark.parametrize("beta_loss", list(BETAS))
def test_ladder_engages_via_solver_knob(monkeypatch, beta_loss):
    """CNMF_TPU_MU_PRECISION_LADDER=1 makes ``solve_nmf_batch`` run the
    ladder, as the JAX package's does; '0' gives the one-phase solve's
    bits. Torch's product precision stays full float32 either way."""
    X, W0, Ht0 = _problem()
    # every restart of either loss stops before max_iter at this tol, so
    # the finish runs a block for each
    kwargs = {"solver": "mu", "beta_loss": beta_loss, "tol": 1e-3,
              "max_iter": MAX_ITER}
    out = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("CNMF_TPU_MU_PRECISION_LADDER", mode)
        out[mode] = solvers.solve_nmf_batch(_t(X), _t(W0), _t(Ht0), kwargs)
        jax_out = jax_solvers.solve_nmf_batch(
            jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0), kwargs)
        np.testing.assert_array_equal(out[mode][2].numpy(),
                                      np.asarray(jax_out[2]))
        for ours, theirs in zip(out[mode][:2], jax_out[:2]):
            assert _rel(ours, theirs) < FACTOR_REL
        assert _flags() == ("highest", False, False)
    ref = pt_nmf.nmf_multiplicative_update(
        _t(X), _t(W0), _t(Ht0), beta=BETAS[beta_loss], tol=1e-3,
        max_iter=MAX_ITER)
    assert all(torch.equal(a, b) for a, b in zip(out["0"], ref))
    assert torch.equal(out["1"][2], ref[2] + 10)


def test_ladder_coarse_exhaustion_keeps_the_sweep_budget():
    """Restarts that run the coarse phase to max_iter enter the finish
    stopped (``done0``): their sweeps and factors are the coarse phase's,
    nothing past sklearn's budget, as in the JAX package."""
    X, W0, Ht0 = _problem()
    max_iter = 20
    W, Ht, n = pt_nmf.nmf_mu_precision_ladder(
        _t(X), _t(W0), _t(Ht0), beta=1.0, tol=1e-4, max_iter=max_iter)
    Wp, Htp, n_plain = pt_nmf.nmf_multiplicative_update(
        _t(X), _t(W0), _t(Ht0), beta=1.0, tol=1e-4, max_iter=max_iter)
    assert (n_plain == max_iter).all()
    assert torch.equal(n, n_plain)
    assert torch.equal(W, Wp) and torch.equal(Ht, Htp)
    _, _, nj = jax_nmf.nmf_mu_precision_ladder(
        jnp.asarray(X), jnp.asarray(W0), jnp.asarray(Ht0), beta=1.0,
        tol=1e-4, max_iter=max_iter)
    np.testing.assert_array_equal(n.numpy(), np.asarray(nj))


def _tf32_reference(x):
    """cvt.rna.tf32.f32 on the bits, in numpy: the magnitude's 13 low bits
    rounded to nearest, a tie away from zero; inf and nan kept."""
    bits = x.view(np.uint32)
    sign, mag = bits & np.uint32(0x80000000), bits & np.uint32(0x7FFFFFFF)
    up = (mag & np.uint32(0x1FFF)) >= np.uint32(0x1000)
    rounded = sign | (((mag >> np.uint32(13)) + up.astype(np.uint32))
                      << np.uint32(13))
    special = (bits & np.uint32(0x7F800000)) == np.uint32(0x7F800000)
    return np.where(special, bits, rounded).view(np.float32)


def test_tf32_round_matches_numpy_bits():
    """``tf32_round`` against the numpy reference bit for bit: random
    values of every scale and sign, exact ties (a tie rounds away from
    zero), one bit either side of them, subnormals, the largest finite
    values (they round to inf), zeros, inf and nan."""
    rng = np.random.RandomState(0)
    rand_bits = rng.randint(0, 2**32, size=20000, dtype=np.uint64)
    ties = (rng.randint(0, 2**19, size=400, dtype=np.uint64) << 13) | 0x1000
    ties = np.concatenate([ties, ties - 1, ties + 1, ties | (1 << 31)])
    specials = np.array([0, 1, 0x1000, 0x1FFF, 0x007FFFFF, 0x007FF000,
                         0x00800000, 0x7F7FFFFF, 0x7F7FF000, 0x7F7FEFFF,
                         0x7F800000, 0x7FC00000, 0x7F800001, 0x7FFFFFFF],
                        dtype=np.uint64)
    specials = np.concatenate([specials, specials | (1 << 31)])
    x = np.concatenate([rand_bits, ties, specials]).astype(np.uint32).view(
        np.float32)
    got = mk.tf32_round(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _tf32_reference(x).view(np.uint32))
    top = np.float32(np.finfo(np.float32).max)   # rounds to inf
    assert float(mk.tf32_round(torch.tensor([top, -top]))[1]) == -np.inf
    with pytest.raises(TypeError, match="float32"):
        mk.tf32_round(torch.zeros(3, dtype=torch.float64))


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _twin_problem(seed=5, B=3, N=37, G=29, K=8):
    """f32 counts-like X (a third zero) and positive factors with two zero K
    columns."""
    rng = np.random.RandomState(seed)
    X = (rng.gamma(1.0, 1.0, (N, G)) * (rng.rand(N, G) > 0.3)).astype(
        np.float32)
    W = np.abs(rng.randn(B, N, K)).astype(np.float32)
    Ht = np.abs(rng.randn(B, G, K)).astype(np.float32)
    W[:, :, -2:] = 0.0
    Ht[:, :, -2:] = 0.0
    return _t(X), _t(W), _t(Ht)


# (wrapper, f32 plain version, beta, the first-order bound in units of u):
# S's operands rounded (2u on S, all terms positive), the factor f(S)
# itself (KL x/S: 2u + u; IS x/S²: 4u + u, 1/S: 2u + u; beta 1.5 S^-0.5:
# u + u, S^0.5: u + u) and Fo in the second product (u)
TWINS = [("kl_mu_w_numerator_tf32", mk.kl_mu_w_numerator_plain, None, 4),
         ("kl_mu_h_numerator_tf32", mk.kl_mu_h_numerator_plain, None, 4),
         ("beta_mu_w_terms_tf32", mk.beta_mu_w_terms_plain, 0.0, 6),
         ("beta_mu_h_terms_tf32", mk.beta_mu_h_terms_plain, 0.0, 6),
         ("beta_mu_w_terms_tf32", mk.beta_mu_w_terms_plain, 1.5, 3)]


@pytest.mark.parametrize("name,plain,beta,units", TWINS)
def test_tf32_twin_within_the_tf32_bound(name, plain, beta, units):
    """On CPU tensors each TF32 wrapper is its twin: it moves the f32 terms
    (TF32 rounds) but by no more than TF32's first-order bound, entry by
    entry; the zero K columns stay zero; nothing launches."""
    X, W, Ht = _twin_problem()
    args = (X, W, Ht) if beta is None else (X, W, Ht, beta)
    fn = getattr(mk, name)
    before = fn.launches
    got, ref = _as_list(fn(*args)), _as_list(plain(*args))
    assert fn.launches == before
    for a, b in zip(got, ref):
        assert not torch.equal(a, b)
        torch.testing.assert_close(a, b, rtol=(units + 0.5) * TF32_U,
                                   atol=1e-6 * float(b.abs().max()))
        assert not a[:, :, -2:].any()


def test_tf32_x_log_wh_twin_within_the_tf32_bound():
    """The divergence term's twin: log(S) moves by at most about 2u where
    its operands are rounded, so each restart's sum by 2u · Σ X."""
    X, W, Ht = _twin_problem()
    got = mk.kl_x_log_wh_tf32(X, W, Ht)
    ref = mk.kl_x_log_wh_plain(X, W, Ht)
    assert not torch.equal(got, ref)
    bound = 2.5 * TF32_U * float(X[X > mk.EPSILON].sum())
    assert float((got - ref).abs().max()) <= bound


def test_coarse_precision_changes_nothing_on_the_cpu():
    """``precision=`` on the CPU: "default" gives the one-phase bits (f32
    here), an unknown precision raises, and torch's float32 flags stay
    full precision after a coarse solve and a ladder."""
    X, W, Ht = _twin_problem(B=2, N=40, G=30, K=8)
    X = X + 0.05
    ref = pt_nmf.nmf_multiplicative_update(X, W, Ht, beta=0.0, max_iter=30)
    got = pt_nmf.nmf_multiplicative_update(X, W, Ht, beta=0.0, max_iter=30,
                                           precision="default")
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    pt_nmf.nmf_mu_precision_ladder(X, W, Ht, beta=1.0, max_iter=30)
    assert _flags() == ("highest", False, False)
    with pytest.raises(ValueError, match="precision"):
        pt_nmf.nmf_multiplicative_update(X, W, Ht, beta=1.0, max_iter=10,
                                         precision="bf16")


@pytest.mark.parametrize("sharded", [False, True])
def test_tf32_route_runs_the_tf32_terms_in_the_coarse_phase(monkeypatch,
                                                            sharded):
    """With the TF32 route taken (as on a CUDA device; forced here, where
    the wrappers run their twins), the coarse phase calls the TF32 terms
    and the finish the f32 ones, on one X and per row shard of X. KL: the
    numerators and the divergence term; IS: the general-beta terms."""
    from cnmf_tpu_torch.parallel.mesh import Shards

    calls = []
    for name in ("kl_mu_w_numerator", "kl_mu_h_numerator", "kl_x_log_wh",
                 "beta_mu_w_terms", "beta_mu_h_terms"):
        for suffix in ("", "_tf32"):
            fn = getattr(pt_nmf, name + suffix)
            monkeypatch.setattr(
                pt_nmf, name + suffix,
                lambda *a, _n=name + suffix, _f=fn: calls.append(_n) or _f(*a))
    monkeypatch.setattr(pt_nmf, "_tf32_route",
                        lambda p, X: p == "default")
    Xn, W0n, Ht0n = _problem(b=3)
    X, W0, Ht0 = (_t(a).float() for a in (Xn, W0n, Ht0n))
    if sharded:
        X = Shards([X[:30], X[30:]], X.shape[0])
        W0 = Shards([W0[:, :30], W0[:, 30:]], W0.shape[1], axis=1)
    for beta, names in ((1.0, ("kl_mu_w_numerator", "kl_mu_h_numerator",
                                "kl_x_log_wh")),
                        (0.0, ("beta_mu_w_terms", "beta_mu_h_terms"))):
        calls.clear()
        W, Ht, n = pt_nmf.nmf_mu_precision_ladder(
            X, W0, Ht0, beta=beta, tol=1e-4, max_iter=MAX_ITER)
        first_f32 = min(i for i, c in enumerate(calls)
                        if not c.endswith("_tf32") and c != "kl_x_log_wh")
        coarse, finish = calls[:first_f32], calls[first_f32:]
        assert {c for c in coarse if c != "kl_x_log_wh"} == {
            f"{n_}_tf32" for n_ in names}
        assert not any(c.endswith("_tf32") for c in finish)
        assert set(finish) == set(names)
        assert (n <= MAX_ITER + 10).all() and torch.isfinite(Ht).all()
