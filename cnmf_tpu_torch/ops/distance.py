"""Pairwise distances and the KNN local-density filter, in PyTorch.

Replaces sklearn's ``euclidean_distances`` + ``np.argpartition`` KNN density
estimate (reference cnmf.py:891-898), as ``cnmf_tpu.ops.distance`` does: the
R×R spectra distance matrix is one gram-trick matmul, and the density of a
spectrum is the mean distance to its ``n_neighbors`` nearest neighbours (the
self-distance 0 is one of the ``n_neighbors + 1`` smallest entries summed).
PyTorch runs eagerly, so the JAX package's row padding for compiled-program
reuse is not needed.
"""

from __future__ import annotations

import torch


def pairwise_euclidean(A: torch.Tensor) -> torch.Tensor:
    """Distances between the rows of A: sqrt(max(‖a‖² + ‖b‖² − 2a·b, 0)),
    sklearn euclidean_distances semantics, with the diagonal exactly 0."""
    a2 = torch.sum(A * A, dim=1)
    d2 = (a2[:, None] + a2[None, :] - 2.0 * (A @ A.T)).clamp(min=0.0)
    d2.fill_diagonal_(0.0)
    return torch.sqrt(d2)


def _knn_density_body(X: torch.Tensor, n_neighbors: int) -> torch.Tensor:
    """Mean distance of each row to its ``n_neighbors`` nearest other rows:
    the ``n_neighbors + 1`` smallest distances (self included, at 0),
    summed in ascending order, over ``n_neighbors``."""
    dist = pairwise_euclidean(X)
    smallest = torch.topk(dist, n_neighbors + 1, dim=1, largest=False).values
    total = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
    for i in range(n_neighbors + 1):
        total = total + smallest[:, i]
    return total / n_neighbors


def local_density_from_spectra(l2_spectra: torch.Tensor, n_neighbors: int):
    """Distance + KNN density for an L2-normalized spectra stack (R, G);
    returns a host (R,) array."""
    return _knn_density_body(l2_spectra, int(n_neighbors)).cpu().numpy()
