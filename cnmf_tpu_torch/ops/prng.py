"""Threefry-2x32 keys and draws, bit for bit as ``jax.random`` makes them.

The JAX package draws its device restart inits (``ops/init.py``
``draw_init_batch``) and its device kmeans++ seeding
(``ops/consensus_fused.py`` ``_device_kmeanspp``) from ``jax.random`` with
the default threefry implementation and ``jax_threefry_partitionable`` on
(JAX's default since 0.5). This module is that stream in PyTorch, so the
port draws the same factors and the same kmeans++ candidates on any device:

* a key is two uint32 words, held here as an int64 tensor (..., 2) with
  values in [0, 2³²); every function is batched over the leading axes of
  its keys, as ``jax.vmap`` over keys is;
* ``threefry2x32`` is the 20-round hash (jax/_src/prng.py
  ``_threefry2x32_lowering``) on int64 tensors with 32-bit masks;
* ``split``, ``fold_in`` and ``random_bits`` follow the partitionable
  branches (``_threefry_split_foldlike``,
  ``_threefry_random_bits_partitionable``): element i of a draw of shape S
  hashes the 64-bit counter i split into (hi, lo) words;
* ``uniform`` builds floats from the top mantissa bits as ``_uniform``
  does; ``normal`` is ``sqrt(2)·erfinv(u)`` with u uniform on
  [nextafter(-1, 0), 1) (``_normal_real``).

The integer bits and the uniforms equal ``jax.random``'s exactly.
``erf_inv`` is XLA's polynomial over ``torch.log1p``, which rounds apart
from XLA's ``log1p`` on some inputs: the normals differ from JAX's by at
most 4 ulps in f32 and 32 in f64 on the CPU
(``tests/test_torch_prng.py`` holds them there; ``torch.erfinv`` itself is
up to 63 and 2770 ulps away).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash of the counter words (x1, x2) under the key
    words (k1, k2): int64 tensors of uint32 values, broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` of a 32-bit seed, or of a vector of
    them: the key words [seed >> 32, seed & 0xFFFFFFFF], shape (..., 2)."""
    s = torch.as_tensor(np.asarray(seed, dtype=np.int64), device=device)
    return torch.stack([(s >> 32) & _MASK, s & _MASK], dim=-1)


def _counters(shape, device):
    """The (hi, lo) words of the flat element index of a draw of ``shape``
    (prng.py ``iota_2x32_shape``)."""
    n = math.prod(shape)
    if n > 2 ** 62:
        raise NotImplementedError("a draw of more than 2**62 elements")
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def _hash_shape(key, shape):
    """threefry2x32 of every counter of ``shape`` under each key: two words
    of shape key.shape[:-1] + shape."""
    lead = key.shape[:-1]
    hi, lo = _counters(tuple(shape), key.device)
    view = lead + (1,) * len(shape)
    k1 = key[..., 0].reshape(view)
    k2 = key[..., 1].reshape(view)
    return threefry2x32(k1, k2, hi, lo)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: keys (..., num, 2)."""
    b1, b2 = _hash_shape(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data`` (an int, or
    a tensor broadcast against the keys' leading axes): the hash of the
    counter words [0, data]."""
    if isinstance(data, int):
        # a fill on the key's device, not a host-to-device copy
        d = torch.full((), data & _MASK, dtype=torch.int64, device=key.device)
    else:
        d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key, shape, bit_width: int = 32) -> torch.Tensor:
    """``jax.random.bits`` of width 32 or 64, as int64 holding the unsigned
    value for 32 bits (for 64 bits, the value's two words (hi, lo) are
    returned stacked on a last axis: int64 cannot hold them)."""
    b1, b2 = _hash_shape(key, shape)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return torch.stack([b1, b2], dim=-1)
    raise ValueError("bit_width is 32 or 64")


def _unit_floats(key, shape, dtype):
    """Floats in [1, 2) from the top mantissa bits, minus 1 (``_uniform``)."""
    if dtype == torch.float32:
        bits = random_bits(key, shape, 32)
        ones = (bits >> 9) | 0x3F800000
        return ones.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        words = random_bits(key, shape, 64)
        ones = (words[..., 0] << 20) | (words[..., 1] >> 12) | (0x3FF << 52)
        return ones.view(torch.float64) - 1.0
    raise TypeError(f"uniform draws float32 or float64, not {dtype}")


def uniform(key, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` per key:
    shape key.shape[:-1] + shape."""
    lo = torch.full((), minval, dtype=dtype, device=key.device)
    hi = torch.full((), maxval, dtype=dtype, device=key.device)
    floats = _unit_floats(key, tuple(shape), dtype)
    return torch.maximum(lo, floats * (hi - lo) + lo)


_F32_LT5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_F32_GT5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)
_F64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693, 1.6536545626831027356,
)
_F64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334, 3.0838856104922207635,
)
_F64_GT16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977, 4.8499064014085844221,
)


def _const(value, like):
    return torch.full((), value, dtype=like.dtype, device=like.device)


def erf_inv(x):
    """XLA's ``erf_inv`` (the chlo decomposition JAX lowers to): Giles'
    polynomials in w = -log1p(-x²), single precision for f32 (two
    branches) and double for f64 (three). Differs from XLA only where
    ``torch.log1p`` and XLA's ``log1p`` round apart."""
    w = -torch.log1p(x * -x)
    if x.dtype == torch.float32:
        lt = w < 5.0
        w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
        coef = [torch.where(lt, _const(a, x), _const(b, x))
                for a, b in zip(_F32_LT5, _F32_GT5)]
        p = coef[0]
        for c in coef[1:]:
            p = c + p * w
    else:
        lt625, lt16 = w < 6.25, w < 16.0
        root = torch.sqrt(w)
        w = torch.where(lt625, w - 3.125,
                        torch.where(lt16, root - 3.25, root - 5.0))

        def coef(i):
            c = _const(_F64_LT625[i], x)
            if i < len(_F64_LT16):
                c = torch.where(lt625, c, _const(_F64_LT16[i], x))
            if i < len(_F64_GT16):
                c = torch.where(lt16, c, _const(_F64_GT16[i], x))
            return c

        p = coef(0)
        for i in range(1, len(_F64_LT625)):
            step = coef(i) + p * w
            if i >= len(_F64_LT16):
                step = torch.where(lt625, step, p)
            elif i >= len(_F64_GT16):
                step = torch.where(lt16, step, p)
            p = step
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


def normal(key, shape=(), dtype=torch.float32):
    """``jax.random.normal(key, shape, dtype)`` per key, to within the ulps
    by which ``erf_inv`` here and XLA's differ."""
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    lo = float(np.nextafter(np.array(-1.0, np_dtype), np.array(0.0, np_dtype)))
    u = uniform(key, shape, dtype, lo, 1.0)
    return erf_inv(u) * torch.tensor(np.sqrt(2), dtype=dtype,
                                     device=key.device)
