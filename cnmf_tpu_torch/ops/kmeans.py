"""KMeans: kmeans++ seeding + batched Lloyd iterations in PyTorch.

Replaces sklearn's ``KMeans(k, n_init=10, random_state=1)`` (reference
cnmf.py:908-910), as ``cnmf_tpu.ops.kmeans`` does: the kmeans++ seeding is
the same numpy code (sklearn's greedy ``n_local_trials`` scheme on the
``RandomState(random_state)`` stream, so both packages draw the same
centres), and the ``n_init`` Lloyd runs are one batched computation on
padded points and clusters (``_lloyd_batched``, the JAX package's
signature). Each run stops on its own once its centre shift is within
sklearn's variance-scaled tolerance; a stopped run stays frozen while the
others continue, which gives the results of running each alone. Empty
clusters are relocated on the device to the points farthest from their
centres (sklearn ``_relocate_empty_clusters``). The loop reads the host
once per block of ``ops.nmf.BLOCK`` iterations.

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
from cnmf_tpu_torch.ops.nmf import BLOCK

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


def _last_row(n_points):
    """max(n_points - 1, 0): an int, or a 0-d tensor for a count on the
    device (read nowhere on the host)."""
    if isinstance(n_points, torch.Tensor):
        return (n_points - 1).clamp(min=0)
    return max(int(n_points) - 1, 0)


def _clip(ids, last):
    """``ids`` clipped to [0, last] (``last`` an int or a 0-d tensor)."""
    if isinstance(last, torch.Tensor):
        return torch.minimum(ids.clamp(min=0), last)
    return ids.clamp(0, last)


def seed_kmeanspp_batch(Xp, w, n_points, n_clusters: int, key, *,
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

    Xp (R, G): the points, the ``n_points`` valid rows first (an int, or a
    0-d tensor on Xp's device: nothing is read back); w (R,): 1 for those,
    0 after (zero potential mass); key: a threefry key (2,). Returns
    (n_init, n_cluster_pad, G) centres, PAD_SENTINEL rows past
    ``n_clusters``. The runs go as one batch."""
    R, G = Xp.shape
    dev, dtype = Xp.device, Xp.dtype
    x_sq = torch.sum(Xp * Xp, dim=1) * w
    keys = prng.split(torch.as_tensor(key, device=dev), n_init)
    k_first, k_loop = prng.split(keys).unbind(dim=1)
    runs = torch.arange(n_init, device=dev)
    last = _last_row(n_points)

    def sq_dist(points):
        # (I, T, G) → (I, T, R): ||x - p||² by the gram trick, clipped at 0,
        # invalid rows zero
        p_sq = torch.sum(points * points, dim=2)
        d2 = x_sq + p_sq[..., None] - 2.0 * torch.matmul(points, Xp.T)
        return d2.clamp(min=0.0) * w

    u0 = prng.uniform(k_first, (), torch.float32)
    n_f32 = (n_points.to(torch.float32) if isinstance(n_points, torch.Tensor)
             else float(n_points))
    first = _clip((u0 * n_f32).to(torch.int64), last)
    centers = torch.full((n_init, n_cluster_pad, G), PAD_SENTINEL,
                         dtype=dtype, device=dev)
    centers[:, 0] = Xp[first]
    closest = sq_dist(Xp[first][:, None])[:, 0]
    pot = closest.sum(dim=1)
    for c in range(1, int(n_clusters)):
        trials = prng.uniform(prng.fold_in(k_loop, c), (n_local_trials,),
                              torch.float32).to(dtype) * pot[:, None]
        ids = torch.searchsorted(torch.cumsum(closest, dim=1), trials)
        cand = Xp[_clip(ids, last)]                         # (I, T, G)
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


def _assign(X, x_sq, centers, col_real, w):
    """labels (I, R) and the weighted squared distances to them, for
    centres (I, Kp, D): clusters past the real ones at +inf distance."""
    c_sq = torch.sum(centers * centers, dim=2)
    dots = _per_row_product(centers, X.T).transpose(1, 2)
    d2 = (x_sq[None, :, None] + c_sq[:, None, :] - 2.0 * dots).clamp(min=0.0)
    d2 = torch.where(col_real, d2, torch.inf)
    min_d2, labels = torch.min(d2, dim=2)
    return labels, min_d2 * w


def _update(X, labels, min_d2, centers, w, col_real, n_clusters: int,
            relocate: bool):
    """The new centres of every run (cnmf_tpu/ops/kmeans.py:89-121): the
    weighted means of their points; with ``relocate``, each empty real
    cluster, in cluster order, is given the farthest point not yet moved
    (sklearn ``_relocate_empty_clusters``: the point's weight moves, it is
    taken off its source cluster, and a source emptied this way is refilled
    when the loop reaches it). Padded points sort last and are never moved;
    padded clusters keep their sentinel. Returns (centres, (I,) bool: the
    run has an empty real cluster, where relocating would act)."""
    I, Kp, _ = centers.shape
    dtype = X.dtype
    onehot = torch.nn.functional.one_hot(labels, Kp).to(dtype) * w[:, None]
    counts = onehot.sum(dim=1)                              # (I, Kp)
    sums = _per_row_product(onehot.transpose(1, 2), X)      # (I, Kp, D)
    has_empty = ((counts == 0) & col_real).any(dim=1)
    if relocate:
        order = torch.argsort(torch.where(w > 0, -min_d2, torch.inf), dim=1,
                              stable=True)
        runs = torch.arange(I, device=X.device)
        n_used = torch.zeros((I, 1), dtype=torch.int64, device=X.device)
        for i in range(min(int(n_clusters), Kp)):
            far = order.gather(1, n_used)[:, 0]
            empty = (counts[:, i] == 0) & (w[far] > 0)
            src = labels.gather(1, far[:, None])[:, 0]      # never i
            moved = X[far] * empty[:, None]
            sums.index_put_((runs, src), -moved, accumulate=True)
            sums[:, i] = torch.where(empty[:, None], X[far], sums[:, i])
            counts.index_put_((runs, src), -empty.to(dtype), accumulate=True)
            counts[:, i] = torch.where(empty, 1.0, counts[:, i])
            n_used = n_used + empty[:, None]
    new = sums / torch.where(counts == 0, 1.0, counts)[:, :, None]
    return torch.where(col_real[None, :, None], new, centers), has_empty


def _lloyd_batched(X: torch.Tensor, centers0: torch.Tensor, tol, n_points,
                   n_clusters: int, max_iter: int):
    """Lloyd iterations for a batch of inits on padded inputs
    (cnmf_tpu/ops/kmeans.py:59-148), on X's device.

    X (Rp, D): zero rows past ``n_points`` (an int or a 0-d tensor), which
    carry zero weight; centers0 (I, Kp, D): sentinel rows past
    ``n_clusters``, masked to +inf distance; tol: the shift tolerance,
    already scaled by the mean variance (a float or a 0-d tensor). A run
    stops once its centre shift is within tol; a stopped run stays frozen
    while the others go on, which gives each run's own result.

    The iterations go in blocks of ``BLOCK``, each first without the
    empty-cluster relocation (its launches grow with k); the host reads
    once a block whether every run is done and whether a running run had an
    empty real cluster, and only then runs the block again from its start
    with the relocation. Either way the block gives what relocating every
    iteration gives, as the JAX loop does. Returns (labels (I, Rp), inertia
    (I,), centers (I, Kp, D)): the labels and inertia of a last assignment
    against the final centres."""
    Rp = X.shape[0]
    n_init, Kp, _ = centers0.shape
    dev = X.device
    x_sq = torch.sum(X * X, dim=1)
    w = (torch.arange(Rp, device=dev) < n_points).to(X.dtype)
    col_real = torch.arange(Kp, device=dev) < n_clusters

    def block(centers, done, steps, relocate):
        emptied = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(steps):
            labels, min_d2 = _assign(X, x_sq, centers, col_real, w)
            new, has_empty = _update(X, labels, min_d2, centers, w, col_real,
                                     n_clusters, relocate)
            emptied = emptied | (has_empty & ~done).any()
            shift = torch.sum(torch.where(col_real[None, :, None],
                                          (new - centers) ** 2, 0.0),
                              dim=(1, 2))
            centers = torch.where(done[:, None, None], centers, new)
            done = done | (shift <= tol)
        return centers, done, emptied

    centers = centers0
    done = torch.zeros(n_init, dtype=torch.bool, device=dev)
    for start in range(0, max_iter, BLOCK):
        steps = min(BLOCK, max_iter - start)
        new, new_done, emptied = block(centers, done, steps, False)
        all_done, relocate = torch.stack([new_done.all(), emptied]).tolist()
        if relocate:
            new, new_done, _ = block(centers, done, steps, True)
            all_done = bool(new_done.all())
        centers, done = new, new_done
        if all_done:
            break
    labels, min_d2 = _assign(X, x_sq, centers, col_real, w)
    return labels, min_d2.sum(dim=1), centers


def kmeans_fit(
    X: torch.Tensor,
    n_clusters: int,
    n_init: int = 10,
    random_state: int = 1,
    max_iter: int = 300,
    tol: float = 1e-4,
    device_seeding: bool = False,
    pad_points_to: int = 512,
    pad_clusters_to: int = 8,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Full KMeans fit on the rows of X: returns (labels, centers, inertia)
    of the best init, as host values. The rows are zero-padded to a multiple
    of ``pad_points_to`` and the clusters to one of ``pad_clusters_to``, the
    shapes of the JAX package's ``kmeans_fit`` and of the one-program
    consensus. ``device_seeding``: seed on X's device from the threefry key
    of ``random_state`` (``seed_kmeanspp_batch``) instead of the host's
    numpy stream."""
    X_host = X.cpu().numpy()
    R, D = X_host.shape
    if R < n_clusters:
        raise ValueError(
            f"n_samples={R} should be >= n_clusters={n_clusters}"
        )
    Rp = -(-R // pad_points_to) * pad_points_to
    Kp = -(-n_clusters // pad_clusters_to) * pad_clusters_to
    Xp = torch.nn.functional.pad(X, (0, 0, 0, Rp - R))
    if device_seeding:
        w = (torch.arange(Rp, device=X.device) < R).to(X.dtype)
        centers0 = seed_kmeanspp_batch(
            Xp, w, R, n_clusters, prng.prng_key(int(random_state)),
            n_init=n_init, n_cluster_pad=Kp,
            n_local_trials=2 + int(np.log(n_clusters)))
    else:
        rng = np.random.RandomState(random_state)
        c0 = np.full((n_init, Kp, D), PAD_SENTINEL, dtype=X_host.dtype)
        c0[:, :n_clusters] = np.stack(
            [_kmeans_plusplus(X_host, n_clusters, rng) for _ in range(n_init)])
        centers0 = torch.as_tensor(c0, device=X.device)
    # sklearn scales tol by the mean per-feature variance of X
    scaled_tol = tol * float(np.mean(np.var(X_host, axis=0)))
    labels, inertia, centers = _lloyd_batched(Xp, centers0, scaled_tol, R,
                                              n_clusters, max_iter)
    best = int(torch.argmin(inertia))
    return (
        labels[best, :R].cpu().numpy(),
        centers[best, :n_clusters].cpu().numpy(),
        float(inertia[best]),
    )
