"""The port's device mesh (cnmf_tpu_torch.parallel) against the JAX
package's, on the CPU.

JAX runs on its 8 virtual CPU devices (tests/conftest.py); the port's mesh
is a list of ``"cpu"`` devices, the same device repeated, through
``parallel.mesh.local_devices`` where a default list is needed. Inputs come
from seeded numpy, float64.

Tolerances: the restart axis is bit-equal to the port's single-device
solve (each restart's arithmetic does not depend on the batch it shares on
the CPU); against JAX's mesh solves rtol 1e-9, atol 1e-12 with equal
n_iter, on both axes; the cell axis against the port's single-device solve
the same (the shards' sums take another order), and so the row-sharded
refits; ``shard_products_rows`` at tests/test_sparse_products.py's own
1e-9 / 1e-12; ``factorize_k`` on a restart axis with the device ladder
bit-equal to the single device's ladder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_tpu.ops.init import random_init_batch
from cnmf_tpu.parallel import mesh as jax_mesh
from cnmf_tpu.pipeline.solvers import (
    solve_nmf_batch_sharded as jax_solve_sharded,
)
from cnmf_tpu_torch.ops.cd_kernels import factors_from_numpy
from cnmf_tpu_torch.parallel import collectives
from cnmf_tpu_torch.parallel import mesh as pm
from cnmf_tpu_torch.pipeline import solvers
from torch_knobs import (  # noqa: F401 (autouse)
    host_draws_by_default,
    one_torch_thread,
)

TOL = dict(rtol=1e-9, atol=1e-12)
CPU8 = ["cpu"] * 8
KWARGS = {
    "frobenius": {"solver": "cd", "beta_loss": "frobenius", "tol": 1e-4,
                  "max_iter": 150},
    "kullback-leibler": {"solver": "mu", "beta_loss": "kullback-leibler",
                         "tol": 1e-4, "max_iter": 100},
    "itakura-saito": {"solver": "mu", "beta_loss": "itakura-saito",
                      "tol": 1e-4, "max_iter": 60},
}


def make_problem(n=64, g=48, k=6, b=8, seed=0, shift=0.01):
    """tests/test_sharding.py:make_problem in float64."""
    rng = np.random.RandomState(seed)
    X = (rng.gamma(1.0, 1.0, (n, g)) * (rng.rand(n, g) < 0.5)) + shift
    W0, Ht0 = random_init_batch(X, k, np.arange(b) + 1, dtype=np.float64)
    return X, W0, Ht0


def single_device(X, W0, Ht0, kwargs):
    W0t, Ht0t = factors_from_numpy(W0, Ht0, device="cpu", dtype=np.float64)
    return solvers.solve_nmf_batch(torch.as_tensor(X), W0t, Ht0t, kwargs)


@pytest.mark.parametrize("cell_axis", [1, 2, 4])
def test_build_mesh_shapes_match_jax(cell_axis):
    ours = pm.build_mesh(CPU8, cell_axis=cell_axis)
    theirs = jax_mesh.build_mesh(jax.devices()[:8], cell_axis=cell_axis)
    assert ours.shape == dict(theirs.shape)
    assert ours.axis_names == theirs.axis_names
    assert len(ours.flat_devices()) == ours.size == 8


@pytest.mark.parametrize("raw, cell", [("2", 2), ("4", 4), ("two", 1),
                                       ("0", 1)])
def test_cell_axis_knob_matches_jax(monkeypatch, raw, cell):
    monkeypatch.setenv("CNMF_TPU_CELL_AXIS", raw)
    assert pm.build_mesh(CPU8).shape["cell"] == cell
    assert jax_mesh.build_mesh(jax.devices()[:8]).shape["cell"] == cell
    monkeypatch.setattr(pm, "local_devices", lambda: [torch.device("cpu")] * 8)
    assert pm.build_mesh().shape == {"restart": 8 // cell, "cell": cell}


def test_non_divisible_device_count_raises():
    with pytest.raises(ValueError, match="not divisible"):
        pm.build_mesh(["cpu"] * 6, cell_axis=4)
    with pytest.raises(ValueError, match="not divisible"):
        jax_mesh.build_mesh(jax.devices()[:6], cell_axis=4)


def test_mesh_over_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.build_mesh(["cuda:0", "cuda:1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.build_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.put_cells(np.zeros((4, 3)))


def test_pad_to_multiple_bit_equal_to_jax():
    arr = np.random.RandomState(3).standard_normal((10, 3, 2))
    for multiple in (1, 3, 8):
        ours, n = pm.pad_to_multiple(arr, multiple)
        theirs, m = jax_mesh.pad_to_multiple(arr, multiple)
        assert n == m == 10
        np.testing.assert_array_equal(ours, theirs)
    ours, _ = pm.pad_to_multiple(arr, 4, axis=1)
    np.testing.assert_array_equal(ours, jax_mesh.pad_to_multiple(arr, 4, 1)[0])


def test_put_cells_matches_jax_shards():
    """84 rows over 8 devices: the port's shards hold what each of the JAX
    array's addressable shards holds, zero padding included."""
    arr = np.random.RandomState(5).standard_normal((84, 7))
    ours = pm.put_cells(arr, CPU8)
    theirs = jax_mesh.put_cells(arr, jax.devices()[:8])
    assert ours.n_rows == 84 and ours.shape == (84, 7)
    assert ours.padded_rows == theirs.shape[0] == 88
    by_start = {s.index[0].start or 0: np.asarray(s.data)
                for s in theirs.addressable_shards}
    for i, part in enumerate(ours.parts):
        np.testing.assert_array_equal(part.numpy(), by_start[i * 11])
    np.testing.assert_array_equal(collectives.gather_shards(ours).numpy(), arr)
    one = pm.put_cells(arr, ["cpu"])
    assert isinstance(one, torch.Tensor) and one.shape == (84, 7)


@pytest.mark.parametrize("shape, restarts, k, n_dev, pays", [
    ((2700, 2000), 100, 13, 2, False),
    ((2700, 2000), 100, 13, 4, False),
    ((100_000, 2000), 30, 12, 2, True),
    ((100_000, 2000), 30, 12, 4, True),
])
def test_restart_axis_pays_where_measured(shape, restarts, k, n_dev, pays):
    """The gate of cNMF.factorize's restart axis at the shapes measured on
    four cards (solvers.RESTART_AXIS_WORK): the main path's factorize runs
    faster on one card, the atlas factorize on 2 and on 4; a mesh with a
    cell axis always takes it."""
    restart = pm.build_mesh(["cpu"] * n_dev, cell_axis=1)
    assert solvers.restart_axis_pays(restart, shape, restarts, k) is pays
    cell = pm.build_mesh(["cpu"] * n_dev, cell_axis=2)
    assert solvers.restart_axis_pays(cell, (63, 48), 8, 6)


def test_sum_shards_fixed_order():
    parts = [torch.as_tensor(np.random.RandomState(i).standard_normal(5))
             for i in range(4)]
    total = collectives.sum_shards(parts)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(total, want)
    assert all(torch.equal(t, want) for t in collectives.broadcast(
        total, [p.device for p in parts]))


@pytest.mark.parametrize("loss", ["frobenius", "kullback-leibler",
                                  "itakura-saito"])
def test_restart_axis_matches_single_device_and_jax(loss):
    """8 restarts over 8 restart shards (and 3 over 2: padding restarts):
    bit-equal to the port's single-device solve, and within TOL of JAX's
    solve_nmf_batch_sharded on its mesh."""
    X, W0, Ht0 = make_problem(n=40, g=32, k=4, b=8, shift=0.06)
    kwargs = KWARGS[loss]
    W1, Ht1, n1 = single_device(X, W0, Ht0, kwargs)
    W, Ht, n_iter = solvers.solve_nmf_batch_sharded(
        pm.build_mesh(CPU8, cell_axis=1), X, W0, Ht0, kwargs)
    assert torch.equal(n_iter, n1)
    assert torch.equal(Ht, Ht1) and torch.equal(W, W1)
    W3, Ht3, n3 = solvers.solve_nmf_batch_sharded(
        pm.build_mesh(["cpu"] * 2, cell_axis=1), X, W0[:3], Ht0[:3], kwargs)
    assert torch.equal(n3, n1[:3]) and torch.equal(Ht3, Ht1[:3])

    Wj, Htj, nj = jax_solve_sharded(
        jax_mesh.build_mesh(jax.devices()[:8], cell_axis=1), jnp.asarray(X),
        W0, Ht0, kwargs)
    np.testing.assert_array_equal(n_iter.numpy(), np.asarray(nj))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Htj), **TOL)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), **TOL)


@pytest.mark.parametrize("loss", ["frobenius", "kullback-leibler",
                                  "itakura-saito"])
def test_cell_axis_matches_jax_and_single_device(loss):
    """Restart 4 × cell 2 with N = 63 (one zero row pads the last shard):
    against JAX's GSPMD solve on its mesh (X zero-padded as its factorize
    pads it) and the port's single-device solve."""
    X, W0, Ht0 = make_problem(n=63)
    kwargs = KWARGS[loss]
    mesh = pm.build_mesh(CPU8, cell_axis=2)
    W, Ht, n_iter = solvers.solve_nmf_batch_sharded(mesh, X, W0, Ht0, kwargs)
    W1, Ht1, n1 = single_device(X, W0, Ht0, kwargs)
    assert W.shape == W1.shape
    assert torch.equal(n_iter, n1)
    np.testing.assert_allclose(Ht.numpy(), Ht1.numpy(), **TOL)
    np.testing.assert_allclose(W.numpy(), W1.numpy(), **TOL)

    jmesh = jax_mesh.build_mesh(jax.devices()[:8], cell_axis=2)
    Xp = np.pad(X, ((0, 1), (0, 0)))
    Wj, Htj, nj = jax_solve_sharded(jmesh, jnp.asarray(Xp), W0, Ht0, kwargs)
    np.testing.assert_array_equal(n_iter.numpy(), np.asarray(nj))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Htj), **TOL)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), **TOL)


@pytest.mark.parametrize("loss", ["frobenius", "kullback-leibler",
                                  "itakura-saito"])
def test_row_sharded_refits_match_single_device(loss):
    """The usage and spectra refits on a row-sharded X (84 rows over 8
    shards) against the same refits on one tensor; the MU spectra refit
    takes Xᵀ's column shards."""
    rng = np.random.RandomState(9)
    X = rng.gamma(1.0, 1.0, (84, 30)) * (rng.rand(84, 30) < 0.6) + 0.05
    spectra = rng.gamma(1.0, 1.0, (5, 30))
    usages = rng.gamma(1.0, 1.0, (84, 5))
    kwargs = KWARGS[loss]
    Xs = pm.put_cells(X, CPU8)
    Xt = torch.as_tensor(X)
    np.testing.assert_allclose(solvers.refit_usages(Xs, spectra, kwargs),
                               solvers.refit_usages(Xt, spectra, kwargs),
                               **TOL)
    np.testing.assert_allclose(
        solvers.refit_spectra_transposed(Xs, usages, kwargs),
        solvers.refit_spectra_transposed(Xt, usages, kwargs), **TOL)


def test_shard_products_rows_matches_single_device(monkeypatch):
    """tests/test_sparse_products.py::test_products_mesh_sharding_matches_
    single_device for the port: 131 × 95 × 5, the usage and the spectra
    refit of a sparse X with the products-given solve row-sharded over 8
    devices, against the solve on one; CNMF_TPU_MESH_PRODUCTS=0 is a no-op."""
    rng = np.random.RandomState(21)
    n, g, k = 131, 95, 5
    X = sp.random(n, g, density=0.3, format="csr", random_state=rng,
                  dtype=np.float64)
    spectra = np.abs(rng.standard_normal((k, g)))
    usages = np.abs(rng.standard_normal((n, k)))
    kwargs = {"solver": "cd", "beta_loss": "frobenius", "tol": 1e-4,
              "max_iter": 60}
    on = dict(device="cpu", dtype=np.float64)
    monkeypatch.setattr(pm, "local_devices", lambda: [torch.device("cpu")] * 8)

    gram = torch.eye(k + 3, dtype=torch.float64)[None]
    P = torch.ones((1, n, k + 3), dtype=torch.float64)
    g2, P2, W2, rows = solvers.shard_products_rows(gram, P, torch.zeros_like(P))
    assert rows == n and len(P2.parts) == 8 and P2.padded_rows == 136
    assert g2 is gram and W2.n_rows == n

    monkeypatch.setenv("CNMF_TPU_MESH_PRODUCTS", "1")
    ru_mesh = solvers.refit_usages(X, spectra, kwargs, **on)
    rs_mesh = solvers.refit_spectra_transposed(X, usages, kwargs, **on)
    monkeypatch.setenv("CNMF_TPU_MESH_PRODUCTS", "0")
    assert solvers.shard_products_rows(gram, P, P)[1] is P
    ru_one = solvers.refit_usages(X, spectra, kwargs, **on)
    rs_one = solvers.refit_spectra_transposed(X, usages, kwargs, **on)
    np.testing.assert_allclose(ru_mesh, ru_one, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(rs_mesh, rs_one, rtol=1e-9, atol=1e-12)
    monkeypatch.setattr(pm, "local_devices", lambda: [torch.device("cpu")])
    monkeypatch.setenv("CNMF_TPU_MESH_PRODUCTS", "1")
    assert solvers.shard_products_rows(gram, P, P)[1] is P


@pytest.mark.parametrize("loss", ["frobenius", "kullback-leibler"])
def test_factorize_k_restart_axis_ladder_matches_single_device(loss):
    """stages.factorize_k on a restart axis with the device ladder (the
    card's default, asked for here on the CPU): 7 restarts over 2 restart
    groups (one padding restart) give the single-device ladder's spectra,
    sweeps and executed restart-sweeps (the groups' rungs summed)."""
    from cnmf_tpu_torch.pipeline import stages

    X, _, _ = make_problem(n=40, g=32, shift=0.06)
    kwargs = KWARGS[loss]
    seeds = np.arange(7) + 3
    Xd = torch.as_tensor(X)
    one = stages.factorize_k(X, Xd, 4, seeds, kwargs, ladder=True)
    two = stages.factorize_k(X, Xd, 4, seeds, kwargs, ladder=True,
                             mesh=pm.build_mesh(["cpu"] * 2, cell_axis=1))
    np.testing.assert_array_equal(two[0], one[0])
    np.testing.assert_array_equal(two[1], one[1])
    groups = [np.concatenate([one[1][4:], one[1][:1]]), one[1][:4]]
    rungs = sum(8 * min(kwargs["max_iter"], -(-int(g.max()) // 10) * 10)
                for g in groups)
    assert two[2] == rungs
