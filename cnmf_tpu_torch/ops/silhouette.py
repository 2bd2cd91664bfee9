"""Euclidean silhouette score in PyTorch.

Replaces sklearn's ``silhouette_score`` (reference cnmf.py:923) for the
K-selection stability metric, as ``cnmf_tpu.ops.silhouette`` does: from the
full pairwise distance matrix, a(i) = mean intra-cluster distance, b(i) =
min mean distance to another cluster, s(i) = (b-a)/max(a,b); singleton
clusters score 0. The padded forms give padded points zero weight and mask
padded (empty) cluster slots, so they return the unpadded score.
"""

from __future__ import annotations

import numpy as np
import torch

from cnmf_tpu_torch.ops.distance import pairwise_euclidean


def _weighted_silhouette(dist, labels, n_clusters: int, w):
    """Mean silhouette over the points of weight 1 (``w`` is 0 or 1 per
    point): points of weight 0 join no cluster and are left out of the
    mean; empty cluster slots are masked."""
    onehot = torch.nn.functional.one_hot(labels, n_clusters).to(dist.dtype)
    onehot = onehot * w[:, None]
    counts = onehot.sum(dim=0)
    dist_to_cluster = dist @ onehot          # (n, k) distance sums

    own_count = counts[labels]
    own_sum = torch.gather(dist_to_cluster, 1, labels[:, None])[:, 0]
    a = own_sum / (own_count - 1.0).clamp(min=1.0)

    mean_other = dist_to_cluster / counts[None, :].clamp(min=1.0)
    own_mask = torch.nn.functional.one_hot(labels, n_clusters).bool()
    empty_mask = (counts == 0)[None, :]
    mean_other = torch.where(own_mask | empty_mask, torch.inf, mean_other)
    b = mean_other.min(dim=1).values

    s = (b - a) / torch.maximum(a, b).clamp(min=torch.finfo(dist.dtype).tiny)
    s = torch.where(own_count <= 1, 0.0, s) * w
    return s.sum() / w.sum()


def silhouette_from_distances(dist: torch.Tensor, labels: torch.Tensor,
                              n_clusters: int) -> torch.Tensor:
    """Mean silhouette from an (n, n) distance matrix and labels in
    [0, n_clusters)."""
    w = torch.ones(dist.shape[0], dtype=dist.dtype, device=dist.device)
    return _weighted_silhouette(dist, labels, n_clusters, w)


def silhouette_score(X, labels, n_clusters: int) -> float:
    X = torch.as_tensor(X)
    dist = pairwise_euclidean(X)
    labels = torch.as_tensor(np.asarray(labels), device=X.device).long()
    return float(silhouette_from_distances(dist, labels, n_clusters))


def _silhouette_padded(Xp: torch.Tensor, labels_p: torch.Tensor, n_real: int,
                       n_cluster_pad: int) -> torch.Tensor:
    """Silhouette of the first ``n_real`` rows of Xp (the rest are padding
    of weight 0) over ``n_cluster_pad`` cluster slots."""
    w = (torch.arange(Xp.shape[0], device=Xp.device) < n_real).to(Xp.dtype)
    return _weighted_silhouette(pairwise_euclidean(Xp), labels_p,
                                n_cluster_pad, w)


def silhouette_score_padded(X, labels, n_clusters: int,
                            pad_points_to: int = 512,
                            pad_clusters_to: int = 8) -> float:
    """``silhouette_score`` on rows zero-padded to a multiple of
    ``pad_points_to`` and cluster slots to one of ``pad_clusters_to``: the
    JAX package's bucketed form, the same score."""
    X = np.asarray(X)
    R = X.shape[0]
    Rp = -(-R // pad_points_to) * pad_points_to
    Kp = -(-n_clusters // pad_clusters_to) * pad_clusters_to
    Xp = np.zeros((Rp, X.shape[1]), dtype=X.dtype)
    Xp[:R] = X
    lp = np.zeros(Rp, dtype=np.int64)
    lp[:R] = np.asarray(labels)
    return float(_silhouette_padded(torch.from_numpy(Xp),
                                    torch.from_numpy(lp), R, Kp))
