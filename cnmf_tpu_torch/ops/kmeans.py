"""KMeans: kmeans++ seeding + batched Lloyd iterations in PyTorch.

Replaces sklearn's ``KMeans(k, n_init=10, random_state=1)`` (reference
cnmf.py:908-910), as ``cnmf_tpu.ops.kmeans`` does: the kmeans++ seeding is
the same numpy code (sklearn's greedy ``n_local_trials`` scheme on the
``RandomState(random_state)`` stream, so both packages draw the same
centres), and the ``n_init`` Lloyd runs are one batched computation. Each run
stops on its own once its centre shift is within sklearn's variance-scaled
tolerance; a stopped run stays frozen while the others continue, which gives
the results of running each alone. Empty clusters are relocated to the
points farthest from their centres (sklearn ``_relocate_empty_clusters``).

``seed_kmeanspp_batch`` is the same greedy scheme on the device, keyed by
threefry (``ops.prng``) as the JAX package's fused consensus seeds it
(cnmf_tpu/ops/consensus_fused.py:380-468): ``kmeans_fit(device_seeding=
True)`` takes it, and consensus does so where
``pipeline.solvers.device_kmeanspp_enabled``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cnmf_tpu_torch.ops import prng

# the padded-cluster sentinel of the JAX package's kmeans (far from any
# L2-normalized point, finite when squared in float32)
PAD_SENTINEL = 1e15


def _kmeans_plusplus(X: np.ndarray, n_clusters: int, rng: np.random.RandomState):
    """Greedy kmeans++ (sklearn _kmeans_plusplus semantics, uniform weights)."""
    n_samples = X.shape[0]
    n_local_trials = 2 + int(np.log(n_clusters))
    x_sq = np.einsum("ij,ij->i", X, X)

    centers = np.empty((n_clusters, X.shape[1]), dtype=X.dtype)
    center_id = rng.randint(n_samples)
    centers[0] = X[center_id]

    def sq_dist_to(points):
        # ||x - p||² via the gram trick, clipped at 0
        p_sq = np.einsum("ij,ij->i", points, points)
        d2 = x_sq[None, :] + p_sq[:, None] - 2.0 * points @ X.T
        return np.maximum(d2, 0.0)

    closest = sq_dist_to(centers[0:1])[0]
    current_pot = closest.sum()

    for c in range(1, n_clusters):
        rand_vals = rng.uniform(size=n_local_trials) * current_pot
        candidate_ids = np.searchsorted(np.cumsum(closest), rand_vals)
        np.clip(candidate_ids, None, n_samples - 1, out=candidate_ids)

        dist_to_cand = sq_dist_to(X[candidate_ids])
        np.minimum(closest[None, :], dist_to_cand, out=dist_to_cand)
        candidates_pot = dist_to_cand.sum(axis=1)

        best = int(np.argmin(candidates_pot))
        current_pot = candidates_pot[best]
        closest = dist_to_cand[best]
        centers[c] = X[candidate_ids[best]]

    return centers


def seed_kmeanspp_batch(Xp, w, n_points: int, n_clusters: int, key, *,
                        n_init: int, n_cluster_pad: int,
                        n_local_trials: int) -> torch.Tensor:
    """``n_init`` greedy kmeans++ seedings on Xp's device
    (cnmf_tpu/ops/consensus_fused.py ``_seed_kmeanspp_batch``): the key
    splits into one key per run, and each run splits its own into
    (k_first, k_loop). The first centre is the valid row at
    ⌊u·n_points⌋ for u uniform from k_first (f32); centre c draws
    ``n_local_trials`` f32 uniforms from fold_in(k_loop, c), scaled by the
    current potential, searches them on the cumulative potential of the
    valid rows, and keeps the trial that lowers the potential most.

    Xp (R, G): the points, the ``n_points`` valid rows first; w (R,): 1 for
    those, 0 after (zero potential mass); key: a threefry key (2,). Returns
    (n_init, n_cluster_pad, G) centres, PAD_SENTINEL rows past
    ``n_clusters``. The runs go as one batch."""
    R, G = Xp.shape
    dev, dtype = Xp.device, Xp.dtype
    x_sq = torch.sum(Xp * Xp, dim=1) * w
    keys = prng.split(torch.as_tensor(key, device=dev), n_init)
    k_first, k_loop = prng.split(keys).unbind(dim=1)
    runs = torch.arange(n_init, device=dev)
    last = max(int(n_points) - 1, 0)

    def sq_dist(points):
        # (I, T, G) → (I, T, R): ||x - p||² by the gram trick, clipped at 0,
        # invalid rows zero
        p_sq = torch.sum(points * points, dim=2)
        d2 = x_sq + p_sq[..., None] - 2.0 * torch.matmul(points, Xp.T)
        return d2.clamp(min=0.0) * w

    u0 = prng.uniform(k_first, (), torch.float32)
    first = torch.clamp((u0 * float(n_points)).to(torch.int64), max=last)
    centers = torch.full((n_init, n_cluster_pad, G), PAD_SENTINEL,
                         dtype=dtype, device=dev)
    centers[:, 0] = Xp[first]
    closest = sq_dist(Xp[first][:, None])[:, 0]
    pot = closest.sum(dim=1)
    for c in range(1, int(n_clusters)):
        trials = prng.uniform(prng.fold_in(k_loop, c), (n_local_trials,),
                              torch.float32).to(dtype) * pot[:, None]
        ids = torch.searchsorted(torch.cumsum(closest, dim=1), trials)
        cand = Xp[ids.clamp(0, last)]                       # (I, T, G)
        d2c = torch.minimum(closest[:, None], sq_dist(cand))
        pots = d2c.sum(dim=2)
        best = torch.argmin(pots, dim=1)
        centers[:, c] = cand[runs, best]
        closest = d2c[runs, best]
        pot = pots[runs, best]
    return centers


def _per_row_product(A, B):
    """A (I, k, D) against B (D, M) → (I, k, M), each row of A its own
    (1, D)·(D, M) product of one batched call: a row's bits depend on its
    values alone, not on its place in A. Runs whose centres are a
    permutation of each other then get the same distances and inertia, and
    the tie goes to the first run, as in the JAX package."""
    I, k, D = A.shape
    out = torch.bmm(A.reshape(I * k, 1, D), B.expand(I * k, *B.shape))
    return out.reshape(I, k, B.shape[1])


def _assign(X, x_sq, centers):
    """labels (I, R) and squared distances to them, for centres (I, k, D)."""
    c_sq = torch.sum(centers * centers, dim=2)
    dots = _per_row_product(centers, X.T).transpose(1, 2)
    d2 = x_sq[None, :, None] + c_sq[:, None, :] - 2.0 * dots
    d2 = d2.clamp(min=0.0)
    min_d2, labels = torch.min(d2, dim=2)
    return labels, min_d2


def _relocate_empty(X, labels, min_d2, sums, counts):
    """Move the farthest points into the empty clusters of one run, in
    cluster order, updating ``sums``/``counts`` in place: the point's weight
    moves, it is taken off its source cluster (a source emptied this way is
    refilled when the loop reaches it, as in the JAX package)."""
    order = torch.argsort(-min_d2, stable=True).tolist()
    n = counts.tolist()
    n_used = 0
    for i in range(len(n)):
        if n[i] != 0:
            continue
        far = order[n_used]
        src = int(labels[far])
        sums[src] -= X[far]
        sums[i] = X[far]
        n[src] -= 1.0
        n[i] = 1.0
        n_used += 1
    counts.copy_(torch.as_tensor(n, dtype=counts.dtype))


def _lloyd_batched(X: torch.Tensor, centers0: torch.Tensor, tol: float,
                   max_iter: int):
    """Lloyd iterations for a batch of inits. X (R, D); centers0 (I, k, D).
    Returns (labels (I, R), inertia (I,), centers (I, k, D))."""
    n_init, k, _ = centers0.shape
    x_sq = torch.sum(X * X, dim=1)
    centers = centers0
    done = torch.zeros(n_init, dtype=torch.bool, device=X.device)
    for _ in range(max_iter):
        labels, min_d2 = _assign(X, x_sq, centers)
        onehot = torch.nn.functional.one_hot(labels, k).to(X.dtype)  # (I, R, k)
        counts = onehot.sum(dim=1)
        sums = _per_row_product(onehot.transpose(1, 2), X)
        empty_runs = torch.nonzero((counts == 0).any(dim=1)).flatten()
        for i in empty_runs.tolist():
            _relocate_empty(X, labels[i], min_d2[i], sums[i], counts[i])
        new_centers = sums / torch.where(counts == 0, 1.0, counts)[:, :, None]
        shift = torch.sum((new_centers - centers) ** 2, dim=(1, 2))
        centers = torch.where(done[:, None, None], centers, new_centers)
        done = done | (shift <= tol)
        if bool(done.all()):
            break
    # labels of the last full assignment against the final centres
    labels, min_d2 = _assign(X, x_sq, centers)
    return labels, min_d2.sum(dim=1), centers


def kmeans_fit(
    X: torch.Tensor,
    n_clusters: int,
    n_init: int = 10,
    random_state: int = 1,
    max_iter: int = 300,
    tol: float = 1e-4,
    device_seeding: bool = False,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Full KMeans fit on the rows of X: returns (labels, centers, inertia)
    of the best init, as host values. ``device_seeding``: seed on X's device
    from the threefry key of ``random_state`` (``seed_kmeanspp_batch``)
    instead of the host's numpy stream."""
    X_host = X.cpu().numpy()
    R, _ = X_host.shape
    if R < n_clusters:
        raise ValueError(
            f"n_samples={R} should be >= n_clusters={n_clusters}"
        )
    if device_seeding:
        centers0 = seed_kmeanspp_batch(
            X, torch.ones(R, dtype=X.dtype, device=X.device), R, n_clusters,
            prng.prng_key(int(random_state)), n_init=n_init,
            n_cluster_pad=n_clusters,
            n_local_trials=2 + int(np.log(n_clusters)))
    else:
        rng = np.random.RandomState(random_state)
        centers0 = torch.as_tensor(np.stack(
            [_kmeans_plusplus(X_host, n_clusters, rng) for _ in range(n_init)]
        ), device=X.device)
    # sklearn scales tol by the mean per-feature variance of X
    scaled_tol = tol * float(np.mean(np.var(X_host, axis=0)))
    labels, inertia, centers = _lloyd_batched(X, centers0, scaled_tol,
                                              max_iter)
    best = int(torch.argmin(inertia))
    return (
        labels[best].cpu().numpy(),
        centers[best].cpu().numpy(),
        float(inertia[best]),
    )
