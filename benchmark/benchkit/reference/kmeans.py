"""KMeans as cNMF runs it (sklearn ``KMeans(k, n_init=10, random_state=1)``),
with the seeding keyed by threefry as the port documents it, written out
op for op in the port's layout: the points zero-padded to a multiple of
512 rows and the clusters to a multiple of 8, the 10 runs as one batch.

At a K where two partitions lie close (more clusters than planted
programs), a float32 rounding apart in a kmeans++ potential or a distance
sends a run to the other partition; the same layout and the same
operations on the same card keep the reference's runs on the program's,
so that a difference in the k-selection rows is a difference of what
follows the labels.

* seeding (``seed``): the key of random_state splits into one key a run,
  each into (first, loop); the first centre is the valid row at
  floor(u * n) for u uniform from ``first``; centre c draws
  ``trials`` uniforms from fold_in(loop, c), scaled by the run's
  potential, searched on the running sum of its squared distances, and
  keeps the trial that lowers the potential most;
* Lloyd (``lloyd``): each run until its centres move by at most the
  tolerance (squared, summed), frozen after; an emptied cluster takes the
  farthest point not yet moved (sklearn's relocation); labels and inertia
  of a last assignment.
"""

from __future__ import annotations

import numpy as np
import torch

from benchkit.reference import threefry
from benchkit.reference.solvers import tf32_round

SENTINEL = 1e15     # a padded cluster's centre: far from every unit vector
PAD_ROWS, PAD_CLUSTERS = 512, 8
BLOCK = 10          # Lloyd iterations between host reads
# sklearn's KMeans as cNMF calls it
N_INIT, RANDOM_STATE, MAX_ITER = 10, 1, 300


def padded(X, n_rows: int):
    return torch.nn.functional.pad(X, (0, 0, 0, n_rows - X.shape[0]))


def _low(t, prec):
    """``t`` as a product's operand at ``prec`` (TF32: rounded)."""
    return tf32_round(t) if prec == "tf32" else t


def seed(Xp, w, n_points: int, k: int, random_state: int, n_init: int,
         k_pad: int, trials: int, prec: str = "f32"):
    """(n_init, k_pad, D) initial centres, SENTINEL rows past k."""
    R, D = Xp.shape
    dev, dtype = Xp.device, Xp.dtype
    x_sq = torch.sum(Xp * Xp, dim=1) * w
    runs_keys = threefry.split(threefry.key(random_state), n_init)
    halves = threefry.split(runs_keys)               # (n_init, 2, 2)
    k_first, k_loop = halves[:, 0], halves[:, 1]
    runs = torch.arange(n_init, device=dev)
    last = max(int(n_points) - 1, 0)

    def sq_dist(points):
        p_sq = torch.sum(points * points, dim=2)
        d2 = x_sq + p_sq[..., None] - 2.0 * torch.matmul(
            _low(points, prec), _low(Xp, prec).T)
        return d2.clamp(min=0.0) * w

    u0 = torch.as_tensor(threefry.uniform(k_first, ()), device=dev)
    first = (u0 * float(n_points)).to(torch.int64).clamp(0, last)
    centers = torch.full((n_init, k_pad, D), SENTINEL, dtype=dtype,
                         device=dev)
    centers[:, 0] = Xp[first]
    closest = sq_dist(Xp[first][:, None])[:, 0]
    pot = closest.sum(dim=1)
    for c in range(1, k):
        u = torch.as_tensor(threefry.uniform(threefry.fold_in(k_loop, c),
                                             (trials,)), device=dev)
        ids = torch.searchsorted(torch.cumsum(closest, dim=1),
                                 u.to(dtype) * pot[:, None])
        cand = Xp[ids.clamp(0, last)]
        d2c = torch.minimum(closest[:, None], sq_dist(cand))
        pots = d2c.sum(dim=2)
        best = torch.argmin(pots, dim=1)
        centers[:, c] = cand[runs, best]
        closest = d2c[runs, best]
        pot = pots[runs, best]
    return centers


def _rows_times(A, B, prec):
    """A (I, k, D) times B (D, M), each row of A its own product."""
    A, B = _low(A, prec), _low(B, prec)
    I, k, D = A.shape
    out = torch.bmm(A.reshape(I * k, 1, D), B.expand(I * k, *B.shape))
    return out.reshape(I, k, B.shape[1])


def _assign(X, x_sq, centers, col_real, w, prec):
    c_sq = torch.sum(centers * centers, dim=2)
    dots = _rows_times(centers, X.T, prec).transpose(1, 2)
    d2 = (x_sq[None, :, None] + c_sq[:, None, :] - 2.0 * dots).clamp(min=0.0)
    d2 = torch.where(col_real, d2, torch.inf)
    min_d2, labels = torch.min(d2, dim=2)
    return labels, min_d2 * w


def _update(X, labels, min_d2, centers, w, col_real, k: int, relocate: bool,
            prec):
    I, Kp, _ = centers.shape
    onehot = torch.nn.functional.one_hot(labels, Kp).to(X.dtype) * w[:, None]
    counts = onehot.sum(dim=1)
    sums = _rows_times(onehot.transpose(1, 2), X, prec)
    has_empty = ((counts == 0) & col_real).any(dim=1)
    if relocate:
        order = torch.argsort(torch.where(w > 0, -min_d2, torch.inf), dim=1,
                              stable=True)
        runs = torch.arange(I, device=X.device)
        used = torch.zeros((I, 1), dtype=torch.int64, device=X.device)
        for i in range(min(k, Kp)):
            far = order.gather(1, used)[:, 0]
            empty = (counts[:, i] == 0) & (w[far] > 0)
            src = labels.gather(1, far[:, None])[:, 0]
            sums.index_put_((runs, src), -(X[far] * empty[:, None]),
                            accumulate=True)
            sums[:, i] = torch.where(empty[:, None], X[far], sums[:, i])
            counts.index_put_((runs, src), -empty.to(X.dtype),
                              accumulate=True)
            counts[:, i] = torch.where(empty, 1.0, counts[:, i])
            used = used + empty[:, None]
    new = sums / torch.where(counts == 0, 1.0, counts)[:, :, None]
    return torch.where(col_real[None, :, None], new, centers), has_empty


def lloyd(X, centers, tol, n_points: int, k: int, prec: str = "f32"):
    """(labels (I, Rp), inertia (I,)) of every run."""
    Rp, dev = X.shape[0], X.device
    n_init, Kp, _ = centers.shape
    x_sq = torch.sum(X * X, dim=1)
    w = (torch.arange(Rp, device=dev) < n_points).to(X.dtype)
    col_real = torch.arange(Kp, device=dev) < k

    def block(centers, done, steps, relocate):
        emptied = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(steps):
            labels, min_d2 = _assign(X, x_sq, centers, col_real, w, prec)
            new, has_empty = _update(X, labels, min_d2, centers, w, col_real,
                                     k, relocate, prec)
            emptied = emptied | (has_empty & ~done).any()
            shift = torch.sum(torch.where(col_real[None, :, None],
                                          (new - centers) ** 2, 0.0),
                              dim=(1, 2))
            centers = torch.where(done[:, None, None], centers, new)
            done = done | (shift <= tol)
        return centers, done, emptied

    done = torch.zeros(n_init, dtype=torch.bool, device=dev)
    for start in range(0, MAX_ITER, BLOCK):
        steps = min(BLOCK, MAX_ITER - start)
        new, new_done, emptied = block(centers, done, steps, False)
        all_done, relocate = torch.stack([new_done.all(), emptied]).tolist()
        if relocate:
            new, new_done, _ = block(centers, done, steps, True)
            all_done = bool(new_done.all())
        centers, done = new, new_done
        if all_done:
            break
    labels, min_d2 = _assign(X, x_sq, centers, col_real, w, prec)
    return labels, min_d2.sum(dim=1)


def best_labels(Xp, n_points: int, k: int, tol, prec: str = "f32"):
    """Labels of the first ``n_points`` rows of the padded points ``Xp``
    under the run of least inertia (the first on a tie); ``tol`` already
    scaled by the points' mean variance; ``prec``: of the products."""
    k_pad = -(-k // PAD_CLUSTERS) * PAD_CLUSTERS
    w = (torch.arange(Xp.shape[0], device=Xp.device) < n_points).to(Xp.dtype)
    centers = seed(Xp, w, n_points, k, RANDOM_STATE, N_INIT, k_pad,
                   2 + int(np.log(k)), prec)
    labels, inertia = lloyd(Xp, centers, torch.as_tensor(tol, dtype=Xp.dtype,
                                                         device=Xp.device),
                            n_points, k, prec)
    return labels[int(torch.argmin(inertia))][:n_points]
