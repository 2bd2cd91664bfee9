"""The port's CD half-sweeps (cnmf_tpu_torch.ops.cd_kernels) against the JAX
package's two references on the same numpy inputs: the Pallas kernels of
cnmf_tpu/ops/pallas_cd.py in interpret mode, and the XLA ``_cd_half_sweep``.

On the CPU the wrappers run their plain PyTorch versions. The CUDA kernels
are held against those plain versions on the card by ``chip_smoke.py``
(phase 3), which needs neither jax nor this test suite."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cnmf_tpu.ops.pallas_cd as pc
from cnmf_tpu.ops.nmf import (
    _cd_half_sweep as jax_sweep,
    _shared_x_dot as jax_x_dot,
    _shared_xt_dot as jax_xt_dot,
    nnls_cd_from_products as jax_nnls_from_products,
)
from cnmf_tpu_torch.ops import cd_kernels as ck
from cnmf_tpu_torch.ops.kernel_lib import load_library
from cnmf_tpu_torch.ops.nmf import nnls_cd_from_products
from torch_knobs import one_torch_thread  # noqa: F401 (autouse)

# the shapes of tests/test_pallas_kernels.py::test_cd_half_sweeps_match_xla
B, N, G, K = 3, 1100, 300, 8
# restart counts off the CUDA kernel's restart groups (1, 13, 17), cells and
# genes not multiples of 4 (X's row pitch), at the main path's K buckets
RAGGED = [(1, 301, 133, 16), (13, 257, 75, 8), (17, 150, 97, 16),
          (17, 123, 49, 8)]
F32_TOL = dict(rtol=2e-5, atol=1e-6)   # the existing Pallas-vs-XLA bound
F64_TOL = dict(rtol=1e-12, atol=1e-14)
REGS = [(0.1, 0.2), (0.0, 0.0)]


def make_problem(dtype, seed=4, shape=(B, N, G, K)):
    """X, W, Ht with two zero K-bucket columns in both factors, plus a
    column that is zero in only the other factor — its gram diagonal is 0,
    so the half-sweep must skip it and leave the factor's column as is."""
    B, N, G, K = shape
    rng = np.random.RandomState(seed)
    X = rng.gamma(1, 1, (N, G)).astype(dtype)
    W = np.abs(rng.randn(B, N, K)).astype(dtype)
    Ht = np.abs(rng.randn(B, G, K)).astype(dtype)
    W[:, :, -2:] = 0.0
    Ht[:, :, -2:] = 0.0
    Ht[:, :, 2] = 0.0   # W column 2 sees a zero hessian in the W half
    W[:, :, 3] = 0.0    # Ht column 3 sees a zero hessian in the H half
    return X, W, Ht


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_xla(X, W, Ht, half, l1, l2):
    X, W, Ht = jnp.asarray(X), jnp.asarray(W), jnp.asarray(Ht)
    if half == "w":
        return jax_sweep(W, jnp.einsum("bgk,bgl->bkl", Ht, Ht),
                         jax_x_dot(X, Ht), l1, l2)
    return jax_sweep(Ht, jnp.einsum("bnk,bnl->bkl", W, W),
                     jax_xt_dot(X, W), l1, l2)


def _jax_pallas(X, W, Ht, half, l1, l2):
    N, G = X.shape
    tile_n, tile_g, Np, Gp = pc.plan_tiles(N, G)
    Xp = jnp.asarray(np.pad(X, ((0, Np - N), (0, Gp - G))))
    Wp = jnp.asarray(np.pad(W, ((0, 0), (0, Np - N), (0, 0))))
    Htp = jnp.asarray(np.pad(Ht, ((0, 0), (0, Gp - G), (0, 0))))
    if half == "w":
        out, viol = pc.cd_w_half_sweep(Xp, Wp, Htp, tile_n=tile_n, l1_reg=l1,
                                       l2_reg=l2, interpret=True)
        return out[:, :N], viol
    out, viol = pc.cd_h_half_sweep(Xp, Wp, Htp, tile_g=tile_g, l1_reg=l1,
                                   l2_reg=l2, interpret=True)
    return out[:, :G], viol


def _port(X, W, Ht, half, l1, l2):
    fn = ck.cd_w_half_sweep if half == "w" else ck.cd_h_half_sweep
    out, viol = fn(_t(X), _t(W), _t(Ht), l1_reg=l1, l2_reg=l2)
    return out.numpy(), viol.numpy()


def _check_f32(reference, half, l1, l2, shape=(B, N, G, K)):
    X, W, Ht = make_problem(np.float32, shape=shape)
    ref = _jax_pallas if reference == "pallas_interpret" else _jax_xla
    out_ref, viol_ref = ref(X, W, Ht, half, l1, l2)
    out, viol = _port(X, W, Ht, half, l1, l2)
    np.testing.assert_allclose(out, np.asarray(out_ref), **F32_TOL)
    np.testing.assert_allclose(viol, np.asarray(viol_ref), rtol=2e-5)


def _check_f64(half, l1, l2, shape=(B, N, G, K)):
    X, W, Ht = make_problem(np.float64, shape=shape)
    out_ref, viol_ref = _jax_xla(X, W, Ht, half, l1, l2)
    out, viol = _port(X, W, Ht, half, l1, l2)
    np.testing.assert_allclose(out, np.asarray(out_ref), **F64_TOL)
    np.testing.assert_allclose(viol, np.asarray(viol_ref), rtol=1e-12)


@pytest.mark.parametrize("l1,l2", REGS)
@pytest.mark.parametrize("half", ["w", "h"])
@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_half_sweep_f32_matches_jax(reference, half, l1, l2):
    _check_f32(reference, half, l1, l2)


@pytest.mark.parametrize("l1,l2", REGS)
@pytest.mark.parametrize("half", ["w", "h"])
def test_half_sweep_f64_matches_xla(half, l1, l2):
    _check_f64(half, l1, l2)


# the f32 plain sweep's largest error against the exact (f64) sweep may be at
# most this multiple of the JAX package's f32 XLA sweep's
ACCURACY_FACTOR = 1.5


@pytest.mark.parametrize("l1,l2", REGS)
@pytest.mark.parametrize("half", ["w", "h"])
def test_half_sweep_f32_as_accurate_as_xla(half, l1, l2):
    """Held to the f64 sweep on the same (f32) inputs, the port's f32 plain
    sweep errs at most ACCURACY_FACTOR times as much as JAX's f32 XLA
    sweep: its product and gram are summed in f64 and rounded once."""
    X, W, Ht = make_problem(np.float32)
    exact, _ = _jax_xla(*(a.astype(np.float64) for a in (X, W, Ht)), half,
                        l1, l2)
    xla, _ = _jax_xla(X, W, Ht, half, l1, l2)
    ours, _ = _port(X, W, Ht, half, l1, l2)
    err = np.abs(ours - np.asarray(exact)).max()
    err_xla = np.abs(np.asarray(xla) - np.asarray(exact)).max()
    assert err <= ACCURACY_FACTOR * err_xla, (err, err_xla)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("batch", [3, 13, 17])
def test_restart_bits_do_not_follow_the_batch(batch, dtype):
    """A restart's CD solve on the CPU has the same bits alone and inside a
    batch of 3, 13 or 17 restarts, at its first, middle and last place: the
    restart axis of a mesh splits a batch into groups and must keep one
    device's bits."""
    from cnmf_tpu.ops.init import random_init_batch
    from cnmf_tpu_torch.ops.nmf import nmf_coordinate_descent

    rng = np.random.RandomState(0)
    X = (rng.gamma(1.0, 1.0, (40, 32)) * (rng.rand(40, 32) < 0.5)) + 0.06
    W0, Ht0 = random_init_batch(X, 4, np.arange(batch) + 1, dtype=dtype)
    W0, Ht0 = (np.pad(a, ((0, 0), (0, 0), (0, 4))) for a in (W0, Ht0))
    Xt = torch.as_tensor(X.astype(dtype))
    # one block of sweeps: a batch-dependent rounding shows at the first
    solve = dict(tol=1e-4, max_iter=10)
    W, Ht, n_iter = nmf_coordinate_descent(Xt, _t(W0), _t(Ht0), **solve)
    for b in sorted({0, batch // 2, batch - 1}):
        W1, Ht1, n1 = nmf_coordinate_descent(Xt, _t(W0[b:b + 1]),
                                             _t(Ht0[b:b + 1]), **solve)
        assert torch.equal(n1[0], n_iter[b])
        assert torch.equal(W1[0], W[b]) and torch.equal(Ht1[0], Ht[b]), b


def _shape_id(shape):
    return "B{}xN{}xG{}xK{}".format(*shape)


@pytest.mark.parametrize("shape", RAGGED, ids=_shape_id)
@pytest.mark.parametrize("l1,l2", REGS)
@pytest.mark.parametrize("half", ["w", "h"])
@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_half_sweep_f32_matches_jax_ragged(reference, half, l1, l2, shape):
    """test_half_sweep_f32_matches_jax at the ragged shapes."""
    _check_f32(reference, half, l1, l2, shape)


@pytest.mark.parametrize("shape", RAGGED, ids=_shape_id)
@pytest.mark.parametrize("l1,l2", REGS)
@pytest.mark.parametrize("half", ["w", "h"])
def test_half_sweep_f64_matches_xla_ragged(half, l1, l2, shape):
    """test_half_sweep_f64_matches_xla at the ragged shapes."""
    _check_f64(half, l1, l2, shape)


def test_zero_skipped_columns_untouched():
    """A column with a zero gram diagonal keeps its values; the zero K-bucket
    columns stay exactly zero."""
    X, W, Ht = make_problem(np.float64)
    W_new, _ = _port(X, W, Ht, "w", 0.0, 0.0)
    np.testing.assert_array_equal(W_new[:, :, 2], W[:, :, 2])
    assert not W_new[:, :, -2:].any()


@pytest.mark.parametrize("half", ["w", "h"])
def test_padding_stays_exactly_zero(half):
    """Zero rows of X and the factors (cells and genes) and zero K columns
    are exact no-ops: padded entries stay 0 and the real block matches the
    unpadded sweep."""
    X, W, Ht = make_problem(np.float64)
    pn, pg, pk = 13, 7, 8
    Xp = np.pad(X, ((0, pn), (0, pg)))
    Wp = np.pad(W, ((0, 0), (0, pn), (0, pk)))
    Htp = np.pad(Ht, ((0, 0), (0, pg), (0, pk)))
    out, viol = _port(X, W, Ht, half, 0.1, 0.2)
    outp, violp = _port(Xp, Wp, Htp, half, 0.1, 0.2)
    m = N if half == "w" else G
    assert not outp[:, m:].any()
    assert not outp[:, :, K:].any()
    np.testing.assert_allclose(outp[:, :m, :K], out, **F64_TOL)
    np.testing.assert_allclose(violp, viol, rtol=1e-12)


@pytest.mark.parametrize("M", [500, 1100])
@pytest.mark.parametrize("l1,l2", REGS)
def test_products_mode_matches_jax(l1, l2, M):
    """One products-given sweep equals the XLA sweep on the same products,
    its violation summed in the kernel's order (``violation_in_order``: at
    M = 1100 over 35 segments, two per lane for three lanes), and the full
    products refit loop matches nnls_cd_from_products (f64: identical sweep
    counts, factors to 1e-12)."""
    rng = np.random.RandomState(8)
    Kp = 16
    Hfix = np.abs(rng.randn(B, 90, Kp))
    Hfix[:, :, -3:] = 0.0
    gram = np.einsum("bgk,bgl->bkl", Hfix, Hfix)
    P = np.einsum("mg,bgk->bmk", rng.gamma(1, 1, (M, 90)), Hfix)
    F = np.abs(rng.randn(B, M, Kp))
    out, viol = ck.cd_sweep_from_products(_t(F), _t(gram), _t(P),
                                          l1_reg=l1, l2_reg=l2)
    out_ref, viol_ref = jax_sweep(jnp.asarray(F), jnp.asarray(gram),
                                  jnp.asarray(P), l1, l2)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), **F64_TOL)
    np.testing.assert_allclose(viol.numpy(), np.asarray(viol_ref), rtol=1e-12)

    W0 = np.zeros((B, M, Kp))
    W, n_iter = nnls_cd_from_products(_t(gram), _t(P), _t(W0), tol=1e-4,
                                      max_iter=150, l1_reg=l1, l2_reg=l2)
    W_ref, n_ref = jax_nnls_from_products(
        jnp.asarray(gram), jnp.asarray(P), jnp.asarray(W0), tol=1e-4,
        max_iter=150, l1_reg=l1, l2_reg=l2,
    )
    np.testing.assert_array_equal(n_iter.numpy(), np.asarray(n_ref))
    np.testing.assert_allclose(W.numpy(), np.asarray(W_ref), rtol=1e-12,
                               atol=1e-12)


def _shfl_down_sum(v):
    """Lane 0 of a warp's shuffle-down sum of v (32 float32 values),
    emulated lane by lane: a lane that reads past lane 31 keeps its own."""
    v = list(v)
    for o in (16, 8, 4, 2, 1):
        v = [v[i] + (v[i + o] if i + o < 32 else v[i]) for i in range(32)]
    return v[0]


@pytest.mark.parametrize("M", [1, 31, 33, 1100, 2085])
def test_products_violation_order(M):
    """``violation_in_order`` adds a restart's row violations as the
    products-given kernel does: each segment of 32 rows by a shuffle-down
    tree, lane l the segments l, l + 32, ... in order, then the lanes by the
    tree (emulated here lane by lane, f32, bit for bit); in f64 it is the
    plain sum within 1e-12."""
    rng = np.random.RandomState(M)
    rows = np.abs(rng.randn(2, M)).astype(np.float32)
    out = ck.violation_in_order(_t(rows))
    for b in range(2):
        padded = np.zeros(-(-M // 32) * 32, np.float32)
        padded[:M] = rows[b]
        lanes = [np.float32(0.0)] * 32
        for i in range(0, len(padded), 32):
            lanes[i // 32 % 32] += _shfl_down_sum(padded[i:i + 32])
        assert out[b].item() == _shfl_down_sum(lanes)
    f64 = ck.violation_in_order(_t(rows.astype(np.float64)))
    np.testing.assert_allclose(f64.numpy(), rows.astype(np.float64).sum(1),
                               rtol=1e-12)


def test_cpu_path_needs_no_compiler_and_launches_nothing(monkeypatch):
    """The module runs on CPU tensors with no triton and no nvcc reachable:
    nothing is built, and the launch counters stay at 0."""
    import sys

    monkeypatch.setitem(sys.modules, "triton", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    wrappers = (ck.cd_w_half_sweep, ck.cd_h_half_sweep,
                ck.cd_sweep_from_products)
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    X, W, Ht = make_problem(np.float32)
    ck.cd_w_half_sweep(_t(X), _t(W), _t(Ht))
    ck.cd_h_half_sweep(_t(X), _t(W), _t(Ht))
    gram = torch.eye(K).expand(B, K, K).contiguous()
    ck.cd_sweep_from_products(_t(W), gram, _t(W))
    assert [fn.launches for fn in wrappers] == [0, 0, 0]
    assert load_library.cache_info().currsize == 0


def test_factors_from_numpy_layout():
    X, W, Ht = make_problem(np.float64)
    Wt, Htt = ck.factors_from_numpy(W, Ht, device="cpu", dtype=np.float32)
    assert Wt.dtype == Htt.dtype == torch.float32
    assert Wt.shape == (B, N, K) and Htt.shape == (B, G, K)
    assert Wt.is_contiguous() and Htt.is_contiguous()
    np.testing.assert_array_equal(Wt.numpy(), W.astype(np.float32))


@pytest.mark.parametrize("cache_root", ["xdg", "home"])
@pytest.mark.parametrize("denied", ["makedirs", "access"])
def test_library_builds_in_user_cache_when_package_dir_read_only(
        monkeypatch, tmp_path, denied, cache_root):
    """Where the package's _build/ cannot be created (makedirs fails) or
    written (access denies it), the library's path moves to the user's cache
    directory ($XDG_CACHE_HOME, else ~/.cache) under cnmf_tpu_torch/, with the
    same hashed file name."""
    import os

    from cnmf_tpu_torch.ops import kernel_lib

    pkg_build = str(tmp_path / "pkg" / "_build")
    monkeypatch.setattr(kernel_lib, "_BUILD_DIR", pkg_build)
    if cache_root == "xdg":
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        cache = tmp_path / "xdg" / "cnmf_tpu_torch"
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
        cache = tmp_path / "home" / ".cache" / "cnmf_tpu_torch"
    in_package = kernel_lib.library_path()
    assert os.path.dirname(in_package) == pkg_build

    def denies(path):
        return os.path.abspath(path).startswith(pkg_build)

    if denied == "makedirs":
        os.rmdir(pkg_build)
        real_makedirs = os.makedirs

        def makedirs(path, *args, **kwargs):
            if denies(path):
                raise PermissionError(13, "Read-only file system", path)
            return real_makedirs(path, *args, **kwargs)

        monkeypatch.setattr(os, "makedirs", makedirs)
    else:
        real_access = os.access
        monkeypatch.setattr(os, "access", lambda path, mode, **kw: (
            False if denies(path) else real_access(path, mode, **kw)))
    in_cache = kernel_lib.library_path()
    assert os.path.dirname(in_cache) == str(cache) and cache.is_dir()
    assert os.path.basename(in_cache) == os.path.basename(in_package)
