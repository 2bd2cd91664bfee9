"""The port's threefry stream (cnmf_tpu_torch.ops.prng) against jax.random
on the CPU, with jax_threefry_partitionable as the JAX package runs it.

Keys, splits, fold_in, the random bits and the uniforms must be equal to
JAX's; the normals (XLA's erf_inv polynomial over torch.log1p) within
NORMAL_ULPS of JAX's, counted in ulps of JAX's value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_tpu_torch.ops import prng
from torch_knobs import one_torch_thread  # noqa: F401 (autouse)

SEEDS = [0, 1, 14, 123456789, 2**31 - 1, 2**32 - 1]
NORMAL_ULPS = {np.float32: 4, np.float64: 32}
DTYPES = {np.float32: torch.float32, np.float64: torch.float64}


@pytest.fixture(autouse=True, scope="module")
def partitionable():
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", before)


def jkey(seed):
    return jax.random.PRNGKey(np.uint32(seed))


def as_words(a):
    return np.asarray(a).astype(np.int64)


def ulps(ours, theirs):
    theirs = np.asarray(theirs)
    return float(np.max(np.abs(ours - theirs)
                        / np.spacing(np.abs(theirs).astype(theirs.dtype))))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_and_bits_equal_jax(seed):
    key = prng.prng_key(seed)
    np.testing.assert_array_equal(key.numpy(), as_words(jkey(seed)))
    for num in (2, 5):
        np.testing.assert_array_equal(
            prng.split(key, num).numpy(),
            as_words(jax.random.split(jkey(seed), num)))
    for data in (0, 7, 2**32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(key, data).numpy(),
            as_words(jax.random.fold_in(jkey(seed), data)))
    for shape in ((), (33, 5)):
        np.testing.assert_array_equal(
            prng.random_bits(key, shape).numpy(),
            as_words(jax.random.bits(jkey(seed), shape, dtype=jnp.uint32)))
    wide = prng.random_bits(key, (4, 3), 64).numpy().astype(np.uint64)
    np.testing.assert_array_equal(
        (wide[..., 0] << np.uint64(32)) | wide[..., 1],
        np.asarray(jax.random.bits(jkey(seed), (4, 3), dtype=jnp.uint64)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_equals_jax(seed, dtype):
    lo = float(np.nextafter(np.array(-1.0, dtype), np.array(0.0, dtype)))
    for shape, lims in (((), (0.0, 1.0)), ((100, 7), (0.0, 1.0)),
                        ((1000,), (lo, 1.0))):
        ours = prng.uniform(prng.prng_key(seed), shape, DTYPES[dtype], *lims)
        theirs = jax.random.uniform(jkey(seed), shape, dtype, *lims)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_ulps_of_jax(seed, dtype):
    ours = prng.normal(prng.prng_key(seed), (3000, 16), DTYPES[dtype]).numpy()
    theirs = jax.random.normal(jkey(seed), (3000, 16), dtype)
    assert ours.dtype == dtype
    assert ulps(ours, theirs) <= NORMAL_ULPS[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_erf_inv_within_ulps_of_xla(dtype):
    """Over the whole open interval, both ends and the branch points of
    the polynomials included."""
    u = np.concatenate([np.linspace(-1, 1, 20001)[1:-1],
                        [-0.9999, 0.99999, 1e-30, -1e-30]]).astype(dtype)
    ours = prng.erf_inv(torch.as_tensor(u)).numpy()
    theirs = jax.scipy.special.erfinv(jnp.asarray(u))
    assert ulps(ours, theirs) <= NORMAL_ULPS[dtype]
    ends = prng.erf_inv(torch.as_tensor(np.array([-1.0, 1.0], dtype)))
    assert ends.tolist() == [-np.inf, np.inf]


def test_batched_keys_equal_one_key_each():
    """A batch of keys draws what each key draws alone (jax.vmap)."""
    keys = prng.prng_key(np.array([3, 9, 2**32 - 1]))
    batch = prng.normal(prng.split(keys)[:, 1], (20, 8), torch.float64)
    for i, seed in enumerate((3, 9, 2**32 - 1)):
        one = prng.normal(prng.split(prng.prng_key(seed))[1], (20, 8),
                          torch.float64)
        assert torch.equal(batch[i], one)
        theirs = jax.vmap(lambda k: jax.random.normal(
            jax.random.split(k)[1], (20, 8), jnp.float64))(
                jnp.asarray(keys.numpy().astype(np.uint32)))[i]
        assert ulps(batch[i].numpy(), theirs) <= NORMAL_ULPS[np.float64]
