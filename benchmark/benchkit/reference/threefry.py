"""The random restart inits and kmeans++ draws of the port, worked out again
in numpy from the seeds: threefry-2x32 keys and draws as ``jax.random``
defines them (partitionable counters), which the port documents as its
device draw.

* ``key(seed)``: the key words [seed >> 32, seed & 0xFFFFFFFF];
* ``split(key, num)``: the hash of counters 0..num-1 (hi word 0);
* ``fold_in(key, data)``: the hash of the counter words [0, data];
* ``bits(key, shape)``: the two words of each flat index's hash, xor-ed;
* ``uniform``: float32 from the top 23 bits, in [0, 1);
* ``normal``: sqrt(2) * erfinv(u) for u uniform on [nextafter(-1, 0), 1),
  evaluated in float64 and rounded to float32 (the port's float32
  polynomial lies within a few float32 ulps of it).
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfinv

MASK = np.uint64(0xFFFFFFFF)
PARITY = np.uint64(0x1BD11BDA)
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The 20-round threefry-2x32 hash of counters (x1, x2) under the key
    (k1, k2); uint64 arrays holding 32-bit words, broadcast together."""
    k1, k2, x1, x2 = (np.asarray(a, dtype=np.uint64) for a in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + np.uint64(i + 1)) & MASK
    return x1, x2


def key(seed) -> np.ndarray:
    s = np.asarray(seed, dtype=np.uint64)
    return np.stack([(s >> np.uint64(32)) & MASK, s & MASK], axis=-1)


def _hash(k, shape):
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    lead = k.shape[:-1]
    view = lead + (1,) * len(shape)
    return threefry2x32(k[..., 0].reshape(view), k[..., 1].reshape(view),
                        idx >> np.uint64(32), idx & MASK)


def split(k, num: int = 2) -> np.ndarray:
    b1, b2 = _hash(k, (num,))
    return np.stack([b1, b2], axis=-1)


def fold_in(k, data: int) -> np.ndarray:
    d = np.full(k.shape[:-1], int(data) & 0xFFFFFFFF, dtype=np.uint64)
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], np.zeros_like(d), d)
    return np.stack([b1, b2], axis=-1)


def uniform(k, shape) -> np.ndarray:
    """float32 uniforms in [0, 1): shape k.shape[:-1] + shape."""
    b1, b2 = _hash(k, tuple(shape))
    bits = ((b1 ^ b2) >> np.uint64(9)) | np.uint64(0x3F800000)
    return bits.astype(np.uint32).view(np.float32) - np.float32(1.0)


def normal(k, shape) -> np.ndarray:
    """float32 standard normals: shape k.shape[:-1] + shape."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, uniform(k, shape) * (np.float32(1.0) - lo) + lo)
    return (np.sqrt(2.0) * erfinv(u.astype(np.float64))).astype(np.float32)


def restart_init(seed: int, x_mean: float, k: int, n: int, g: int):
    """One restart's random init (W0 (n, k), Ht0 (g, k)), float32: the key
    of its seed split in two; Ht0 = |a * normal(first, (g, p))| and W0 =
    |a * normal(second, (n, p))| over p = k rounded up to a multiple of 8
    columns, of which the first k are kept; a = sqrt(x_mean / k) in
    float32."""
    p = -(-int(k) // 8) * 8
    halves = split(key(np.uint32(seed)))
    a = np.float32(np.sqrt(x_mean / k))
    Ht0 = np.abs(a * normal(halves[0], (g, p)))[:, :k]
    W0 = np.abs(a * normal(halves[1], (n, p)))[:, :k]
    return W0, Ht0
