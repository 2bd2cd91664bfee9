"""NMF factor initialization.

sklearn's init schemes (the reference passes init='random' or 'nndsvd'
through to sklearn, reference cnmf.py:627,1252), on the host:

* 'random': ``avg·|N(0,1)|`` with ``avg = sqrt(X.mean()/K)``, drawn from
  ``np.random.RandomState(seed)`` with H drawn before W;
* 'nndsvd' / 'nndsvda' / 'nndsvdar': nonnegative double SVD (Boutsidis &
  Gallopoulos 2008) over a seeded randomized top-K SVD.

Both are the same numpy code as ``cnmf_tpu.ops.init``'s host path, so both
packages start every restart from bit-identical factors. The device draw
(``random_init_batch_device``, threefry-keyed per restart through
``ops.prng``) is the JAX package's accelerator default and the port's on a
CUDA card (``pipeline.solvers.device_init_enabled``). The batched
variants stack per-seed factors along a leading restart axis in the solvers'
(B, N, K) / (B, G, K) layout. The fixed-H refits' W init is made on X's
device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from cnmf_tpu_torch.ops import prng
from cnmf_tpu_torch.ops.cd_kernels import torch_dtype
from cnmf_tpu_torch.parallel.collectives import sum_shards
from cnmf_tpu_torch.parallel.mesh import Shards


def _x_mean(X) -> float:
    if sp.issparse(X):
        return float(X.sum()) / (X.shape[0] * X.shape[1])
    return float(np.mean(X))


def _seed(seed):
    """A replicate seed as a Python int; None (an unseeded draw) stays."""
    return None if seed is None else int(seed)


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
        W, H = _draw(avg, X.shape, n_components, _seed(seed), dtype)
        Ws.append(W)
        Hts.append(np.ascontiguousarray(H.T))
    return np.stack(Ws), np.stack(Hts)


def random_init_batch_device(
    x_mean: float, n_samples: int, n_features: int, n_components: int,
    seeds, pad_k: int = None, dtype=np.float32, device=None,
):
    """The batched random init drawn on ``device`` from a threefry key per
    restart (cnmf_tpu/ops/init.py ``random_init_batch_device``): only the
    seed vector is uploaded, and the noise is made where the solve runs.
    The draw is ``jax.random``'s (``ops.prng``), so both packages start a
    restart from the same factors to within the normals' few ulps; it is not
    the sklearn ``RandomState`` stream of ``random_init_batch``
    (``CNMF_TPU_DEVICE_INIT=0`` keeps that one).

    Returns W0 (B, N, pad_k), Ht0 (B, G, pad_k) tensors at ``dtype``, the
    components past ``n_components`` zero."""
    pad_k = pad_k or n_components
    dt = torch_dtype(dtype)
    avg = np.dtype(dtype).type(np.sqrt(x_mean / n_components))
    kmask = torch.as_tensor((np.arange(pad_k) < n_components).astype(dtype),
                            device=device)
    return draw_init_batch(seeds, torch.as_tensor(avg, device=device), kmask,
                           n=n_samples, g=n_features, pad_k=pad_k, dt=dt)


def draw_init_batch(seeds, avg, kmask, *, n: int, g: int, pad_k: int, dt):
    """Each restart's factors from its own seed (cnmf_tpu/ops/init.py
    ``draw_init_batch``): key = PRNGKey(seed), Ht = |avg·normal(k_h, (g,
    pad_k))| and W = |avg·normal(k_w, (n, pad_k))| from the two halves of
    its split, the pad columns zeroed by ``kmask``. A restart's draw is keyed
    by its seed alone, so any partition of the batch (chunks, restart
    groups, ladder rungs) reproduces the same factors. ``seeds``: ints or a
    tensor on the drawing device (``kmask``'s)."""
    if isinstance(seeds, torch.Tensor):
        seeds = seeds.cpu().numpy()
    keys = prng.split(prng.prng_key(np.asarray(seeds, dtype=np.uint32),
                                    device=kmask.device))
    avg = avg.to(dt)
    Ht = torch.abs(avg * prng.normal(keys[:, 0], (g, pad_k), dt))
    W = torch.abs(avg * prng.normal(keys[:, 1], (n, pad_k), dt))
    return W * kmask, Ht * kmask


def _randomized_topk_svd(X, k: int, seed):
    """Top-k SVD via the randomized range-finder recipe sklearn's NNDSVD
    init uses (Halko, Martinsson & Tropp 2011; reference cnmf.py:627 passes
    init='nndsvd' into sklearn, whose ``_initialize_nmf`` calls
    ``_randomized_svd`` with its defaults). Reproduced operation-for-
    operation — same oversampling (k+10), same power-iteration count
    (7 when k < 0.1·min(shape), else 4) and LU normalization, same
    transpose heuristic, same gesdd on the projected matrix, same svd_flip
    sign convention, same RandomState consumption — so for the same
    per-replicate seed the init is bit-identical to the reference's
    sklearn run. Works on dense or scipy-sparse X."""
    import scipy.linalg as sla

    rng = (seed if isinstance(seed, np.random.RandomState)
           else np.random.RandomState(seed))
    n_random = k + 10
    n_iter = 7 if k < 0.1 * min(X.shape) else 4
    transpose = X.shape[0] < X.shape[1]
    M = X.T if transpose else X
    Q = rng.normal(size=(M.shape[1], n_random))
    if M.dtype == np.float32:
        Q = Q.astype(np.float32, copy=False)
    if n_iter <= 2:
        def normalizer(x):
            return x, None
    else:
        def normalizer(x):
            return sla.lu(x, permute_l=True, check_finite=False)
    for _ in range(n_iter):
        Q, _ = normalizer(M @ Q)
        Q, _ = normalizer(M.T @ Q)
    Q, _ = sla.qr(M @ Q, mode="economic", check_finite=False)
    B = Q.T @ M
    if sp.issparse(B):
        B = np.asarray(B.todense())
    Uhat, s, Vt = sla.svd(np.asarray(B), full_matrices=False,
                          lapack_driver="gesdd")
    del B
    U = Q @ Uhat
    # svd_flip: u-based unless transposed (sklearn keeps sign(0) == 0)
    if not transpose:
        max_abs = np.argmax(np.abs(U), axis=0)
        signs = np.sign(U[max_abs, np.arange(U.shape[1])])
    else:
        max_abs = np.argmax(np.abs(Vt), axis=1)
        signs = np.sign(Vt[np.arange(Vt.shape[0]), max_abs])
    U = U * signs[None, :]
    Vt = Vt * signs[:, None]
    if transpose:
        return Vt[:k, :].T, s[:k], U[:, :k].T
    return U[:, :k], s[:k], Vt[:k, :]


def nndsvd_init(X, n_components: int, eps: float = 1e-6, dtype=np.float32,
                variant: str = "nndsvd", seed=None):
    """NNDSVD init (sklearn _initialize_nmf semantics, randomized top-K
    SVD seeded per replicate — so restarts differ exactly as the
    reference's sklearn runs do).

    variant: 'nndsvd' | 'nndsvda' (zeros → X.mean()) | 'nndsvdar'.
    """
    n = min(X.shape)
    if n_components > n:
        raise ValueError(
            f"nndsvd requires n_components <= min(X.shape) (= {n})"
        )
    U, S, V = _randomized_topk_svd(X, n_components, seed)

    W = np.zeros_like(U)
    H = np.zeros_like(V)
    W[:, 0] = np.sqrt(S[0]) * np.abs(U[:, 0])
    H[0, :] = np.sqrt(S[0]) * np.abs(V[0, :])

    for j in range(1, n_components):
        x, y = U[:, j], V[j, :]
        x_p, y_p = np.maximum(x, 0), np.maximum(y, 0)
        x_n, y_n = np.abs(np.minimum(x, 0)), np.abs(np.minimum(y, 0))
        x_p_nrm, y_p_nrm = np.linalg.norm(x_p), np.linalg.norm(y_p)
        x_n_nrm, y_n_nrm = np.linalg.norm(x_n), np.linalg.norm(y_n)
        m_p, m_n = x_p_nrm * y_p_nrm, x_n_nrm * y_n_nrm
        if m_p > m_n:
            u, v, sigma = x_p / x_p_nrm, y_p / y_p_nrm, m_p
        else:
            u, v, sigma = x_n / x_n_nrm, y_n / y_n_nrm, m_n
        lbd = np.sqrt(S[j] * sigma)
        W[:, j] = lbd * u
        H[j, :] = lbd * v

    W[W < eps] = 0
    H[H < eps] = 0

    if variant == "nndsvda":
        avg = _x_mean(X)
        W[W == 0] = avg
        H[H == 0] = avg
    elif variant == "nndsvdar":
        rng = np.random.RandomState(seed)
        avg = _x_mean(X)
        W[W == 0] = np.abs(avg * rng.standard_normal(size=(W == 0).sum()) / 100)
        H[H == 0] = np.abs(avg * rng.standard_normal(size=(H == 0).sum()) / 100)

    return W.astype(dtype, copy=False), H.astype(dtype, copy=False)


def nndsvd_init_batch(X, n_components: int, seeds: Sequence[int],
                      variant: str = "nndsvd", dtype=np.float32
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """One ``nndsvd_init`` per replicate seed (sklearn's nndsvd runs a seeded
    randomized SVD, so the restarts differ), stacked as W0 (B, N, K),
    Ht0 (B, G, K)."""
    inits = [nndsvd_init(X, n_components, dtype=dtype, variant=variant,
                         seed=_seed(s)) for s in seeds]
    return (np.stack([w for w, _ in inits]),
            np.stack([np.ascontiguousarray(h.T) for _, h in inits]))


def nnls_w_init(X, n_components: int, solver: str, dtype=None,
                pad_k: Optional[int] = None) -> torch.Tensor:
    """W init for fixed-H refits (sklearn _check_w_h, update_H=False), a
    (1, N, pad_k) tensor (pad_k defaults to n_components): zeros for CD; for
    MU sqrt(X.mean()/n_components) with the real k, over every column of the
    zero-padded bucket (cnmf_tpu/pipeline/solvers.py:1008-1023) — a padded
    column has zero spectra, so its W goes to 0 at the first update.

    X: a tensor (the init takes its device, and its dtype unless ``dtype``
    is given) or a host array or sparse matrix (a CPU tensor at ``dtype``,
    float32 by default, as the JAX package's ``nnls_w_init``, which returns
    the (N, K) host array this tensor holds in its first restart).

    For X's rows in ``Shards`` the init is (1, rows, pad_k) ``Shards`` of
    the same layout, padded rows 0, and the MU mean runs over the real
    elements; for X's columns in ``Shards`` it is one tensor on the first
    shard's device (cnmf_tpu/pipeline/solvers.py:1008-1023 on a mesh)."""
    shape = (1, X.shape[0], n_components if pad_k is None else pad_k)
    if isinstance(X, Shards):
        return _sharded_w_init(X, n_components, solver, dtype, shape)
    if not isinstance(X, torch.Tensor):
        tdtype = torch_dtype(np.float32 if dtype is None else dtype)
        if solver == "mu":
            avg = np.sqrt(_x_mean(X) / n_components)
            return torch.full(shape, avg, dtype=tdtype)
        return torch.zeros(shape, dtype=tdtype)
    tdtype = X.dtype if dtype is None else torch_dtype(dtype)
    if solver == "mu":
        avg = torch.sqrt(X.sum() / X.numel() / n_components)
        return avg.to(tdtype).expand(shape).contiguous()
    return torch.zeros(shape, dtype=tdtype, device=X.device)


def _sharded_w_init(X, n_components, solver, dtype, shape):
    """``nnls_w_init`` of a ``Shards`` X (see there)."""
    tdtype = X.dtype if dtype is None else torch_dtype(dtype)
    W = torch.zeros(shape, dtype=tdtype, device=X.device)
    if solver == "mu":
        total = sum_shards([x.sum() for x in X.parts])
        avg = torch.sqrt(total / (X.shape[0] * X.shape[1]) / n_components)
        W = W + avg.to(tdtype)
    if X.axis == 1:
        return W
    parts = []
    for i, x in enumerate(X.parts):
        part = torch.zeros((1, x.shape[0], shape[2]), dtype=tdtype,
                           device=x.device)
        part[:, :X.real_rows(i)] = W[:, :1].to(x.device)
        parts.append(part)
    return Shards(parts, X.n_rows, axis=1)
