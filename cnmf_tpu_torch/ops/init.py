"""NMF factor initialization.

sklearn's init='random' (the reference passes it through to sklearn,
reference cnmf.py:627): ``avg·|N(0,1)|`` with ``avg = sqrt(X.mean()/K)``,
drawn from ``np.random.RandomState(seed)`` with H drawn before W. The draw
is the same numpy stream as ``cnmf_tpu.ops.init``'s host path, so both
packages start every restart from bit-identical factors. The batched variant
stacks per-seed factors along a leading restart axis in the solvers'
(B, N, K) / (B, G, K) layout. The fixed-H refits' W init is made on X's
device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch


def _x_mean(X) -> float:
    if sp.issparse(X):
        return float(X.sum()) / (X.shape[0] * X.shape[1])
    return float(np.mean(X))


def _draw(avg: float, shape, n_components: int, seed: int, dtype):
    """H then W from RandomState(seed), |N(0,1)|·avg, X of ``shape``."""
    rng = np.random.RandomState(seed)
    n_samples, n_features = shape
    H = avg * rng.standard_normal(size=(n_components, n_features))
    W = avg * rng.standard_normal(size=(n_samples, n_components))
    np.abs(H, out=H)
    np.abs(W, out=W)
    return W.astype(dtype, copy=False), H.astype(dtype, copy=False)


def random_init(X, n_components: int, seed: int, dtype=np.float32):
    """sklearn init='random': H then W from RandomState(seed), |N(0,1)|·avg."""
    avg = np.sqrt(_x_mean(X) / n_components)
    return _draw(avg, X.shape, n_components, seed, dtype)


def random_init_batch(
    X, n_components: int, seeds: Sequence[int], dtype=np.float32
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack sklearn-compatible random inits: W0 (B,N,K), Ht0 (B,G,K). X's
    mean is taken once for the batch (the same value ``random_init`` takes
    per seed)."""
    avg = np.sqrt(_x_mean(X) / n_components)
    Ws, Hts = [], []
    for seed in seeds:
        W, H = _draw(avg, X.shape, n_components, int(seed), dtype)
        Ws.append(W)
        Hts.append(np.ascontiguousarray(H.T))
    return np.stack(Ws), np.stack(Hts)


def nnls_w_init(X: torch.Tensor, k: int, solver: str,
                pad_k: Optional[int] = None) -> torch.Tensor:
    """W init for fixed-H refits (sklearn _check_w_h, update_H=False), a
    (1, N, pad_k) tensor of X's device and dtype: zeros for CD; for MU
    sqrt(X.mean()/k) with the real k, over every column of the zero-padded
    bucket (cnmf_tpu/pipeline/solvers.py:1008-1023) — a padded column has
    zero spectra, so its W goes to 0 at the first update."""
    shape = (1, X.shape[0], k if pad_k is None else pad_k)
    if solver == "mu":
        return torch.sqrt(X.sum() / X.numel() / k).expand(shape).contiguous()
    return torch.zeros(shape, dtype=X.dtype, device=X.device)
