"""K-selection statistics for one K, in PyTorch.

The reference's k_selection_plot re-runs the consensus stats path per K
(reference cnmf.py:1119-1135 → 823-936): KMeans over the L2-normalized
merged spectra, cluster-median consensus spectra, a fixed-spectra NNLS
usage refit, a silhouette score and a direct reconstruction error. As in
``cnmf_tpu.ops.kstats``, everything after the kmeans++ seeding is one chain
on the device (``_k_stats_chain``: padded Lloyd → best-init labels →
per-cluster medians → row renorm → fixed-spectra NNLS → silhouette → SSE)
that returns two 0-d tensors; the host reads nothing in it but the Lloyd and
refit loops' block checks, so a K sweep queues every K before reading any
result. Shapes are bucketed like the JAX package's (points padded to 512s,
clusters to 8s). ``consensus_k_stats`` seeds on the host from
``RandomState(random_state)``; ``consensus_k_stats_device`` takes the raw
merged spectra as a device tensor and normalizes, pads, scales the Lloyd
tolerance and seeds (threefry kmeans++) on the device. The refit runs the
solvers of ``ops.nmf`` (on CUDA: the CD products kernel, or the MU kernels
of the run's beta).
"""

from __future__ import annotations

import numpy as np
import torch

from cnmf_tpu_torch.ops import prng
from cnmf_tpu_torch.ops.init import nnls_w_init
from cnmf_tpu_torch.ops.kmeans import (
    PAD_SENTINEL,
    _kmeans_plusplus,
    _lloyd_batched,
    seed_kmeanspp_batch,
)
from cnmf_tpu_torch.ops.nmf import (
    nmf_multiplicative_update,
    nnls_cd_fixed_spectra,
    reconstruction_sse,
)
from cnmf_tpu_torch.ops.silhouette import _silhouette_padded


def _cluster_medians(Xp: torch.Tensor, labels: torch.Tensor,
                     valid: torch.Tensor, n_clusters: int,
                     n_cluster_pad: int) -> torch.Tensor:
    """Per-cluster column medians of the valid rows of ``Xp`` on its device
    (cnmf_tpu/ops/kstats.py:37-58; pandas ``groupby().median()``
    semantics: the mean of the two central order statistics for even
    counts). One cluster slot at a time, so one (Rp, D) sort buffer is live;
    empty and padded slots give zero rows. Nothing is read on the host."""
    rows = []
    for c in range(n_cluster_pad):
        if c >= n_clusters:
            rows.append(torch.zeros_like(Xp[0]))
            continue
        in_c = valid & (labels == c)
        cnt = in_c.sum()
        svals = torch.sort(torch.where(in_c[:, None], Xp, torch.inf),
                           dim=0).values
        lo = ((cnt - 1) // 2).clamp(min=0).view(1)
        hi = (cnt // 2).clamp(min=0).view(1)
        m = 0.5 * (svals.index_select(0, lo)[0] + svals.index_select(0, hi)[0])
        rows.append(torch.where(cnt > 0, m, 0.0))
    return torch.stack(rows)


def _row_normalized(median):
    """Rows divided by their sums (zero rows stay 0)."""
    rowsum = median.sum(dim=1, keepdim=True)
    return torch.where(rowsum > 0,
                       median / torch.where(rowsum == 0, 1.0, rowsum), 0.0)


def _best_labels(labels_all, inertia):
    """The labels of the run of least inertia (the first on ties), picked on
    the device."""
    return labels_all.index_select(0, torch.argmin(inertia).view(1))[0]


def _k_stats_chain(
    Xnc,                 # (N, G) normalized counts, or row Shards
    Xp: torch.Tensor,    # (Rp, G) zero-padded L2-normalized spectra
    centers0: torch.Tensor,   # (n_init, Kp, G) sentinel-padded seeds
    lloyd_tol,           # float or 0-d tensor, scaled by the mean variance
    n_points,            # int or 0-d tensor: real spectra rows
    n_clusters: int,     # real k
    n_cells=None,        # real rows of Xnc (accepted; Shards carry theirs)
    *,
    n_cluster_pad: int,
    lloyd_max_iter: int,
    solver: str,
    beta: float,
    refit_tol: float,
    refit_max_iter: int,
    l1_reg_W: float,
    l2_reg_W: float,
    mu_chunk: int = 8,
    use_pallas: bool = False,
):
    """Everything after the kmeans++ seeding (cnmf_tpu/ops/kstats.py:61):
    returns (silhouette, sse) as 0-d tensors on Xp's device. Padded cluster
    slots have zero spectra, so their usage columns stay 0 and the SSE is
    the unpadded one; cell-padded row ``Shards`` keep their W rows at 0.
    ``mu_chunk`` and ``use_pallas`` are accepted for the JAX package's
    signature: the reconstructions go in the kernels' fixed chunks, and the
    kernels run wherever the tensors are on CUDA."""
    Rp = Xp.shape[0]
    labels_all, inertia, _ = _lloyd_batched(
        Xp, centers0, lloyd_tol, n_points, n_clusters, lloyd_max_iter)
    labels = _best_labels(labels_all, inertia)
    valid = torch.arange(Rp, device=Xp.device) < n_points
    median_n = _row_normalized(_cluster_medians(Xp, labels, valid,
                                                n_clusters, n_cluster_pad))

    H = median_n.to(Xnc.dtype)
    Ht0 = H.T.contiguous()[None].to(Xnc.device)
    W0 = nnls_w_init(Xnc, n_clusters, solver, pad_k=n_cluster_pad)
    if solver == "cd":
        W, _ = nnls_cd_fixed_spectra(Xnc, Ht0, W0, tol=refit_tol,
                                     max_iter=refit_max_iter, l1_reg=l1_reg_W,
                                     l2_reg=l2_reg_W)
    else:
        W, _, _ = nmf_multiplicative_update(
            Xnc, W0, Ht0, beta=beta, tol=refit_tol, max_iter=refit_max_iter,
            update_H=False, l1_reg_W=l1_reg_W, l2_reg_W=l2_reg_W)
    silhouette = _silhouette_padded(Xp, labels, n_points, n_cluster_pad)
    sse = reconstruction_sse(Xnc, W[0], H.to(Xnc.device))
    return silhouette, sse


def _pads(R: int, k: int, pad_points_to: int, pad_clusters_to: int):
    return (-(-R // pad_points_to) * pad_points_to,
            -(-k // pad_clusters_to) * pad_clusters_to)


def to_device(a, device, dtype=None) -> torch.Tensor:
    """A host array (or CPU tensor) on ``device``: on a CUDA card through
    pinned memory without a host synchronization, so a chain queued behind
    it is not drained."""
    t = torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray)
                        else a)
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def l2_normalize_pad(raw: torch.Tensor, r_pad: int) -> torch.Tensor:
    """L2 row normalization and zero padding to ``r_pad`` rows on the
    device (cnmf_tpu/ops/consensus_fused.py ``_l2_normalize_pad``): the
    host's ``values / sqrt((values**2).sum(1))`` for a raw spectra tensor;
    an all-zero row stays zero. Shared by the one-program consensus and the
    device-fed k-stats."""
    norms = torch.sqrt(torch.sum(raw * raw, dim=1, keepdim=True))
    l2n = raw / torch.where(norms > 0, norms, 1.0)
    return torch.nn.functional.pad(l2n, (0, 0, 0, r_pad - raw.shape[0]))


def _refit_kw(solver, beta, refit_tol, refit_max_iter, l1_reg_W, l2_reg_W,
              mu_chunk, use_pallas):
    return dict(solver=solver, beta=float(beta), refit_tol=float(refit_tol),
                refit_max_iter=int(refit_max_iter), l1_reg_W=float(l1_reg_W),
                l2_reg_W=float(l2_reg_W), mu_chunk=mu_chunk,
                use_pallas=use_pallas)


def _fused_k_stats_dev(Xnc, raw: torch.Tensor, key: torch.Tensor,
                       n_clusters: int, n_cells=None, *, r_pad: int,
                       n_cluster_pad: int, n_init: int, n_local_trials: int,
                       lloyd_max_iter: int, lloyd_tol: float, **refit):
    """K-stats fed by the raw merged spectra on the device
    (cnmf_tpu/ops/kstats.py:158-227): the L2 row normalization, the padding,
    the Lloyd tolerance scaling (lloyd_tol · mean per-feature variance of
    the real rows) and the threefry kmeans++ seeding run there, then
    ``_k_stats_chain``."""
    R = raw.shape[0]
    Xp = l2_normalize_pad(raw, r_pad)
    l2 = Xp[:R]
    mean = l2.mean(dim=0, keepdim=True)
    scaled_tol = lloyd_tol * torch.mean(torch.mean((l2 - mean) ** 2, dim=0))
    w = (torch.arange(r_pad, device=raw.device) < R).to(raw.dtype)
    centers0 = seed_kmeanspp_batch(
        Xp, w, R, n_clusters, key, n_init=n_init,
        n_cluster_pad=n_cluster_pad, n_local_trials=n_local_trials)
    return _k_stats_chain(Xnc, Xp, centers0, scaled_tol.to(raw.dtype), R,
                          n_clusters, n_cells, n_cluster_pad=n_cluster_pad,
                          lloyd_max_iter=lloyd_max_iter, **refit)


def consensus_k_stats_device(
    Xnc,
    raw_spectra: torch.Tensor,
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
    pad_points_to: int = 512,
    pad_clusters_to: int = 8,
    use_pallas: bool = False,
    n_cells: int = None,
):
    """``consensus_k_stats`` for the raw (not normalized) merged spectra
    (R × HVGs) as a tensor on Xnc's device: nothing but the key goes to the
    device, and the seeding is the threefry kmeans++
    (``ops.kmeans.seed_kmeanspp_batch``). Returns 0-d tensors (silhouette,
    prediction_error)."""
    R = raw_spectra.shape[0]
    if R < k:
        raise ValueError(f"n_samples={R} should be >= n_clusters={k}")
    Rp, Kp = _pads(R, k, pad_points_to, pad_clusters_to)
    key = to_device(prng.prng_key(int(random_state)), raw_spectra.device)
    return _fused_k_stats_dev(
        Xnc, raw_spectra, key, int(k), n_cells, r_pad=Rp, n_cluster_pad=Kp,
        n_init=int(n_init), n_local_trials=2 + int(np.log(k)),
        lloyd_max_iter=lloyd_max_iter, lloyd_tol=float(lloyd_tol),
        **_refit_kw(solver, beta, refit_tol, refit_max_iter, l1_reg_W,
                    l2_reg_W, 8, use_pallas))


def consensus_k_stats(
    Xnc,
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
    pad_points_to: int = 512,
    pad_clusters_to: int = 8,
    use_pallas: bool = False,
    n_cells: int = None,
):
    """(silhouette, prediction_error) of one K as 0-d tensors on Xnc's
    device (cnmf_tpu/ops/kstats.py:265-320): call ``float()`` on them to
    wait.

    Xnc: (cells × HVGs) normalized counts on the solve's device, or row
    ``parallel.mesh.Shards`` (the refit's W rows follow them, padded rows
    stay 0, and the error sums over shards); l2_spectra: (R × HVGs)
    L2-normalized merged spectra at Xnc's dtype. The host runs sklearn's
    greedy kmeans++ seeding (the stream of ``ops.kmeans.kmeans_fit``, so the
    labels match the step-by-step path) and scales the Lloyd tolerance; the
    points are zero-padded to a multiple of ``pad_points_to`` and the
    clusters to one of ``pad_clusters_to`` (sentinel centres), and the rest
    is ``_k_stats_chain``. The refit's spectra are started at zeros for CD
    and at sqrt(mean(X) / k) for MU."""
    X = np.ascontiguousarray(l2_spectra)
    R, D = X.shape
    if R < k:
        raise ValueError(f"n_samples={R} should be >= n_clusters={k}")
    rng = np.random.RandomState(random_state)
    centers0 = np.stack([_kmeans_plusplus(X, k, rng) for _ in range(n_init)])
    scaled_tol = lloyd_tol * float(np.mean(np.var(X, axis=0)))
    Rp, Kp = _pads(R, k, pad_points_to, pad_clusters_to)
    Xpad = np.zeros((Rp, D), dtype=X.dtype)
    Xpad[:R] = X
    c0 = np.full((n_init, Kp, D), PAD_SENTINEL, dtype=X.dtype)
    c0[:, :k] = centers0
    dev = Xnc.device
    return _k_stats_chain(
        Xnc, to_device(Xpad, dev), to_device(c0, dev),
        float(np.asarray(scaled_tol, dtype=X.dtype)), R, int(k), n_cells,
        n_cluster_pad=Kp, lloyd_max_iter=lloyd_max_iter,
        **_refit_kw(solver, beta, refit_tol, refit_max_iter, l1_reg_W,
                    l2_reg_W, 8, use_pallas))
