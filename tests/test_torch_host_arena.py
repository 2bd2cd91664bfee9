"""The port's reused host arena (cnmf_tpu_torch.utils.arena, the JAX
package's tests/test_host_arena.py): a freed slot is reused, a held one —
through a numpy view or a tensor made by ``torch.from_numpy`` — never is;
the arena's users give the values of a fresh allocation; and the f64
pipeline with the arena forced on every buffer matches the JAX package's
with its own arena forced the same way. The port's arena is off unless
CNMF_TPU_HOST_ARENA=1 (the JAX package's is on by default); these tests
turn it on, but for the one that holds the default."""

import numpy as np
import pytest
import torch

from cnmf_tpu_torch.io.h5ad import read_h5ad
from cnmf_tpu_torch.ops.normalize import normalize_total, scale_unit_variance
from cnmf_tpu_torch.utils.arena import HostArena, host_arena
from torch_handoff import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread,
    assert_pipeline_matches_jax,
    make,
    write_counts,
    write_planted,
)
from torch_knobs import host_draws_by_default  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _arena_on(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_HOST_ARENA", "1")


def test_arena_off_by_default(monkeypatch):
    """Unset, the knob keeps no slot: each take is a fresh allocation."""
    monkeypatch.delenv("CNMF_TPU_HOST_ARENA")
    a = HostArena(min_bytes=1024)
    x = a.take((100, 40), np.float64)
    assert a._slots == [] and x.shape == (100, 40)
    del x
    monkeypatch.setenv("CNMF_TPU_HOST_ARENA", "1")
    a.take((100, 40), np.float64)
    assert len(a._slots) == 1


def test_refcount_guarded_reuse():
    a = HostArena(min_bytes=1024)
    x = a.take((100, 40), np.float64)
    assert x.shape == (100, 40) and x.dtype == np.float64
    del x
    y = a.take((100, 40), np.float64)
    assert len(a._slots) == 1, "freed slot not reused"
    z = a.take((100, 40), np.float64)
    assert len(a._slots) == 2, "held slot aliased"
    # a view of a handed-out buffer also holds the slot
    v = z[:10]
    del z
    w = a.take((100, 40), np.float64)
    assert len(a._slots) == 3, "slot aliased while a view is alive"
    del v, w, y
    # a smaller request takes the smallest adequate free slot
    s = a.take((50, 40), np.float64)
    assert len(a._slots) == 3
    del s


def test_tensor_from_numpy_holds_slot():
    """A tensor made by ``torch.from_numpy`` from a slot (or from a view of
    it) keeps the slot held after the arrays are gone; the slot is free
    again once the tensor is."""
    a = HostArena(min_bytes=1024)
    t = torch.from_numpy(a.take((64, 32), np.float32))
    assert len(a._slots) == 1
    a.take((64, 32), np.float32)
    assert len(a._slots) == 2, "slot aliased while a tensor holds it"
    v = torch.from_numpy(a.take((64, 32), np.float32)[1:])
    assert len(a._slots) == 2, "the freed second slot was not reused"
    a.take((64, 32), np.float32)
    assert len(a._slots) == 3, "slot aliased while a view's tensor holds it"
    del t, v
    a.take((64, 32), np.float32)
    a.take((64, 32), np.float32)
    assert len(a._slots) == 3


def test_small_requests_bypass():
    a = HostArena(min_bytes=1 << 20)
    x = a.take((10, 10), np.float64)
    assert a._slots == [] and x.shape == (10, 10)


def test_eviction_respects_cap():
    a = HostArena(min_bytes=1024, max_total_bytes=1 << 20)
    x = a.take((1 << 19,), np.uint8)
    y = a.take((1 << 19,), np.uint8)
    z = a.take((1 << 19,), np.uint8)  # over the cap, all held: no eviction
    assert len(a._slots) == 3
    del x, y, z
    a.take((1 << 19,), np.uint8)  # the next take prunes free slots
    assert sum(s.nbytes for s in a._slots) <= (1 << 20) + (1 << 19)


def test_normalize_scale_bit_identical(monkeypatch):
    rng = np.random.RandomState(3)
    X = rng.poisson(2.0, size=(300, 500)).astype(np.int64)
    monkeypatch.setenv("CNMF_TPU_HOST_ARENA", "0")
    t0 = np.asarray(normalize_total(X))
    monkeypatch.setenv("CNMF_TPU_HOST_ARENA", "1")
    monkeypatch.setattr(host_arena, "min_bytes", 0)
    t1 = np.asarray(normalize_total(X))
    np.testing.assert_array_equal(t0, t1)

    Xf = X.astype(np.float64)
    s0 = scale_unit_variance(Xf.copy(), ddof=1, zero_safe=False)
    buf = Xf.copy()
    s1 = scale_unit_variance(buf, ddof=1, zero_safe=False, inplace=True)
    assert s1 is buf
    np.testing.assert_array_equal(s0, s1)


def test_prepare_twice_reuses_and_matches(tmp_path, monkeypatch):
    """A second prepare (a fresh object, the first run's references
    dropped) takes arena slots and writes the artifacts of an arena-off
    run."""
    monkeypatch.setattr(host_arena, "min_bytes", 0)
    fn = write_planted(tmp_path / "counts.h5ad", seed=5, n_cells=120,
                       n_genes=180)
    cfg = dict(components=[4], n_iter=3, seed=2, num_highvar_genes=90)

    monkeypatch.setenv("CNMF_TPU_HOST_ARENA", "0")
    ref = make(tmp_path, "off")
    ref.prepare(counts_fn=fn, **cfg)
    tpm_off = read_h5ad(ref.paths["tpm"]).X.copy()
    norm_off = read_h5ad(ref.paths["normalized_counts"]).X.copy()
    del ref

    monkeypatch.setenv("CNMF_TPU_HOST_ARENA", "1")
    for name in ("on1", "on2"):
        before = host_arena.hits
        obj = make(tmp_path, name)
        obj.prepare(counts_fn=fn, **cfg)
        tpm_on = read_h5ad(obj.paths["tpm"]).X
        norm_on = read_h5ad(obj.paths["normalized_counts"]).X
        np.testing.assert_array_equal(np.asarray(tpm_on), tpm_off)
        np.testing.assert_array_equal(np.asarray(norm_on), norm_off)
        del obj, tpm_on, norm_on
        if name == "on2":
            assert host_arena.hits > before, (
                "the second prepare reused no arena slot")


def test_arena_pipeline_matches_jax(tmp_path, monkeypatch):
    """Every prepare temporary through both packages' arenas (min_bytes
    0), with the storage-dtype copy of CNMF_TPU_PREPARE_DTYPE=float32 in
    it: the f64 pipeline's artifacts match the JAX package's."""
    from cnmf_tpu.utils.arena import host_arena as jax_arena

    monkeypatch.setenv("CNMF_TPU_HOST_ARENA", "1")
    monkeypatch.setenv("CNMF_TPU_PREPARE_DTYPE", "float32")
    monkeypatch.setattr(host_arena, "min_bytes", 0)
    monkeypatch.setattr(jax_arena, "min_bytes", 0)
    before = host_arena.misses + host_arena.hits
    ours = assert_pipeline_matches_jax(tmp_path,
                                       write_counts(tmp_path / "c.h5ad", 5))
    assert host_arena.misses + host_arena.hits > before
    assert read_h5ad(ours.paths["normalized_counts"]).X.dtype == np.float32


@pytest.fixture(autouse=True)
def _drop_arena_slots():
    yield
    host_arena.clear()
