"""K-selection statistics for one K, in PyTorch.

The reference's k_selection_plot re-runs the consensus stats path per K
(reference cnmf.py:1119-1135 → 823-936): KMeans over the L2-normalized
merged spectra, cluster-median consensus spectra, a fixed-spectra NNLS
usage refit, a silhouette score and a direct reconstruction error. This is
the host-seeded ``consensus_k_stats`` of ``cnmf_tpu.ops.kstats`` (the chain
of ``_k_stats_chain``): kmeans++ seeding on the host from
``RandomState(random_state)``, the ``n_init`` Lloyd runs batched on the
device, the medians, the refit through the solvers of ``ops.nmf`` (on CUDA:
the CD products kernel, or the MU kernels of the run's beta), silhouette
and SSE on the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cnmf_tpu_torch.ops.cd_kernels import pad_bucket
from cnmf_tpu_torch.ops.init import nnls_w_init
from cnmf_tpu_torch.ops.kmeans import _kmeans_plusplus, _lloyd_batched
from cnmf_tpu_torch.ops.nmf import (
    nmf_multiplicative_update,
    nnls_cd_fixed_spectra,
    reconstruction_sse,
)
from cnmf_tpu_torch.ops.silhouette import _silhouette_padded


def _cluster_medians(X: np.ndarray, labels: np.ndarray,
                     n_clusters: int) -> np.ndarray:
    """Per-cluster column medians of X's rows (pandas ``groupby().median()``
    semantics: the mean of the two central values for even counts); an
    empty cluster gives a zero row."""
    med = np.zeros((n_clusters, X.shape[1]), dtype=X.dtype)
    for c in range(n_clusters):
        rows = X[labels == c]
        if len(rows):
            med[c] = np.median(rows, axis=0)
    return med


def consensus_k_stats(
    Xnc: torch.Tensor,
    l2_spectra: np.ndarray,
    k: int,
    *,
    solver: str = "cd",
    beta: float = 2.0,
    refit_tol: float = 1e-4,
    refit_max_iter: int = 200,
    l1_reg_W: float = 0.0,
    l2_reg_W: float = 0.0,
    n_init: int = 10,
    random_state: int = 1,
    lloyd_max_iter: int = 300,
    lloyd_tol: float = 1e-4,
) -> Tuple[float, float]:
    """(silhouette, prediction_error) of one K.

    Xnc: (cells × HVGs) normalized counts on the solve's device, or row
    ``parallel.mesh.Shards`` (the refit's W rows follow them, padded rows
    stay 0, and the error sums over shards); l2_spectra:
    (R × HVGs) L2-normalized merged spectra at Xnc's dtype. The refit's
    spectra are zero-padded to the K the kernels take (an exact no-op: their
    usage columns stay 0), started at zeros for CD and at sqrt(mean(X) / k)
    for MU."""
    X = np.ascontiguousarray(l2_spectra)
    R = X.shape[0]
    if R < k:
        raise ValueError(f"n_samples={R} should be >= n_clusters={k}")
    dev, dtype = Xnc.device, Xnc.dtype
    rng = np.random.RandomState(random_state)
    centers0 = np.stack([_kmeans_plusplus(X, k, rng) for _ in range(n_init)])
    scaled_tol = lloyd_tol * float(np.mean(np.var(X, axis=0)))
    Xd = torch.as_tensor(X, device=dev)
    labels_all, inertia, _ = _lloyd_batched(
        Xd, torch.as_tensor(centers0, device=dev), scaled_tol, lloyd_max_iter)
    labels = labels_all[int(torch.argmin(inertia))]

    median = _cluster_medians(X, labels.cpu().numpy(), k)
    rowsum = median.sum(axis=1, keepdims=True)
    median = np.where(rowsum > 0, median / np.where(rowsum == 0, 1.0, rowsum),
                      0.0)
    k_pad = pad_bucket(k)
    H = torch.zeros((k_pad, X.shape[1]), dtype=dtype, device=dev)
    H[:k] = torch.as_tensor(median, device=dev).to(dtype)
    Ht0 = H.T.contiguous()[None]
    W0 = nnls_w_init(Xnc, k, solver, pad_k=k_pad)
    if solver == "cd":
        W, _ = nnls_cd_fixed_spectra(Xnc, Ht0, W0, tol=refit_tol,
                                     max_iter=refit_max_iter, l1_reg=l1_reg_W,
                                     l2_reg=l2_reg_W)
    else:
        W, _, _ = nmf_multiplicative_update(
            Xnc, W0, Ht0, beta=beta, tol=refit_tol, max_iter=refit_max_iter,
            update_H=False, l1_reg_W=l1_reg_W, l2_reg_W=l2_reg_W)

    silhouette = _silhouette_padded(Xd, labels, R, k)
    sse = reconstruction_sse(Xnc, W[0], H)
    return float(silhouette), float(sse)
