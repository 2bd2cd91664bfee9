"""Pairwise distances and the KNN local-density filter, in PyTorch.

Replaces sklearn's ``euclidean_distances`` + ``np.argpartition`` KNN density
estimate (reference cnmf.py:891-898), as ``cnmf_tpu.ops.distance`` does: the
R×R spectra distance matrix is one gram-trick matmul, and the density of a
spectrum is the mean distance to its ``n_neighbors`` nearest neighbours (the
self-distance 0 is one of the ``n_neighbors + 1`` smallest entries summed).
The rows are zero-padded to a multiple of 512 with the padded columns masked
out of every neighbourhood (``_knn_density_body``), the body the one-program
consensus (``ops.consensus_fused``) runs inline, so both compute on the same
shapes.
"""

from __future__ import annotations

import torch

# the row bucket of the density program (cnmf_tpu/ops/distance.py:81)
PAD_ROWS = 512


def pairwise_euclidean(A: torch.Tensor) -> torch.Tensor:
    """Distances between the rows of A: sqrt(max(‖a‖² + ‖b‖² − 2a·b, 0)),
    sklearn euclidean_distances semantics, with the diagonal exactly 0."""
    a2 = torch.sum(A * A, dim=1)
    d2 = (a2[:, None] + a2[None, :] - 2.0 * (A @ A.T)).clamp(min=0.0)
    d2.fill_diagonal_(0.0)
    return torch.sqrt(d2)


def _knn_density_body(Xp: torch.Tensor, n_real, n_neighbors: int):
    """Mean distance of each row of Xp to its ``n_neighbors`` nearest rows
    among the first ``n_real`` (an int or a 0-d tensor; the padded columns
    are +inf, cnmf_tpu/ops/distance.py:60-69): the ``n_neighbors + 1``
    smallest distances (self included, at 0), summed in ascending order, over
    ``n_neighbors``. Rows past ``n_real`` get values nobody reads."""
    dist = pairwise_euclidean(Xp)
    col_real = torch.arange(Xp.shape[0], device=Xp.device) < n_real
    dist = torch.where(col_real[None, :], dist, torch.inf)
    smallest = torch.topk(dist, n_neighbors + 1, dim=1, largest=False).values
    total = torch.zeros(Xp.shape[0], dtype=Xp.dtype, device=Xp.device)
    for i in range(n_neighbors + 1):
        total = total + smallest[:, i]
    return total / n_neighbors


def local_density_from_spectra(l2_spectra: torch.Tensor, n_neighbors: int):
    """Distance + KNN density for an L2-normalized spectra stack (R, G), its
    rows zero-padded to a multiple of ``PAD_ROWS``; returns a host (R,)
    array."""
    R = l2_spectra.shape[0]
    pad = (-R) % PAD_ROWS
    Xp = torch.nn.functional.pad(l2_spectra, (0, 0, 0, pad))
    return _knn_density_body(Xp, R, int(n_neighbors))[:R].cpu().numpy()
