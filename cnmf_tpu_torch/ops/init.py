"""NMF factor initialization on the host.

sklearn's init='random' (the reference passes it through to sklearn,
reference cnmf.py:627): ``avg·|N(0,1)|`` with ``avg = sqrt(X.mean()/K)``,
drawn from ``np.random.RandomState(seed)`` with H drawn before W. The draw
is the same numpy stream as ``cnmf_tpu.ops.init``'s host path, so both
packages start every restart from bit-identical factors. The batched variant
stacks per-seed factors along a leading restart axis in the solvers'
(B, N, K) / (B, G, K) layout.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import scipy.sparse as sp


def _x_mean(X) -> float:
    if sp.issparse(X):
        return float(X.sum()) / (X.shape[0] * X.shape[1])
    return float(np.mean(X))


def random_init(X, n_components: int, seed: int, dtype=np.float32):
    """sklearn init='random': H then W from RandomState(seed), |N(0,1)|·avg."""
    avg = np.sqrt(_x_mean(X) / n_components)
    rng = np.random.RandomState(seed)
    n_samples, n_features = X.shape
    H = avg * rng.standard_normal(size=(n_components, n_features))
    W = avg * rng.standard_normal(size=(n_samples, n_components))
    np.abs(H, out=H)
    np.abs(W, out=W)
    return W.astype(dtype, copy=False), H.astype(dtype, copy=False)


def random_init_batch(
    X, n_components: int, seeds: Sequence[int], dtype=np.float32
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack sklearn-compatible random inits: W0 (B,N,K), Ht0 (B,G,K)."""
    Ws, Hts = [], []
    for seed in seeds:
        W, H = random_init(X, n_components, int(seed), dtype=dtype)
        Ws.append(W)
        Hts.append(np.ascontiguousarray(H.T))
    return np.stack(Ws), np.stack(Hts)


def nnls_w_init(X, n_components: int, solver: str, dtype=np.float32) -> np.ndarray:
    """W init for fixed-H refits (sklearn _check_w_h, update_H=False):
    zeros for CD, sqrt(X.mean()/K) for MU."""
    n_samples = X.shape[0]
    if solver == "mu":
        avg = np.sqrt(_x_mean(X) / n_components)
        return np.full((n_samples, n_components), avg, dtype=dtype)
    return np.zeros((n_samples, n_components), dtype=dtype)
