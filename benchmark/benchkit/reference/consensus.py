"""cNMF's consensus and k-selection statistics, plainly, in PyTorch.

Consensus at one K (cNMF ``consensus``): the merged spectra L2-normalized;
each one's local density, the mean distance to its ``n_neighbors`` nearest
others; those under the density threshold clustered by KMeans (10 greedy
kmeans++ seedings keyed by threefry from random_state 1, as the port
documents its seeding, then Lloyd to sklearn's variance-scaled tolerance,
the run of least inertia kept); the cluster medians scaled to sum 1; the
usages refit against them; the programs ordered by total normalized usage;
the TPM spectra refit against the normalized usages; the z-scored TPM
regressed on the usages (the score spectra); the usages refit once more on
the HVG TPM scaled to unit variance against the TPM spectra.

K-selection (cNMF ``k_selection_plot``), for each K: KMeans over all the
merged spectra, the silhouette of its labels and the squared error of the
normalized counts against the usages refit on the cluster medians.
"""

from __future__ import annotations

import numpy as np
import torch

from benchkit.reference import kmeans
from benchkit.reference.solvers import mm, refit


def l2_rows(M, n_rows: int):
    """Rows divided by their norms (a zero row stays 0), zero rows padded
    to ``n_rows``."""
    norms = torch.sqrt(torch.sum(M * M, dim=1, keepdim=True))
    return kmeans.padded(M / torch.where(norms > 0, norms, 1.0), n_rows)


def pad_rows(n: int) -> int:
    return -(-n // kmeans.PAD_ROWS) * kmeans.PAD_ROWS


def sq_distances(A, B, prec):
    """||a - b||^2 for the rows of A (I, D) against B (J, D), by the gram
    expansion, clipped at 0."""
    d2 = ((A * A).sum(dim=1)[:, None] + (B * B).sum(dim=1)[None, :]
          - 2.0 * mm(A, B.T, prec))
    return d2.clamp(min=0.0)


def local_density(l2p, n_real: int, n_neighbors: int, prec):
    """Mean distance of each row to its n_neighbors nearest other rows
    among the first ``n_real`` (the n_neighbors + 1 smallest distances,
    itself at 0 among them, summed in ascending order)."""
    d2 = sq_distances(l2p, l2p, prec)
    d2.fill_diagonal_(0.0)
    dist = torch.where(torch.arange(l2p.shape[0], device=l2p.device)[None, :]
                       < n_real, torch.sqrt(d2), torch.inf)
    near = torch.topk(dist, n_neighbors + 1, dim=1, largest=False).values
    total = torch.zeros(l2p.shape[0], dtype=l2p.dtype, device=l2p.device)
    for i in range(n_neighbors + 1):
        total = total + near[:, i]
    return total / n_neighbors


def medians(X, labels, k: int):
    """Per-cluster column medians (the mean of the two middle values for an
    even count), each row scaled to sum 1."""
    rows = []
    for c in range(k):
        vals = torch.sort(X[labels == c], dim=0).values
        m = vals.shape[0]
        rows.append(0.5 * (vals[(m - 1) // 2] + vals[m // 2]))
    med = torch.stack(rows)
    return med / med.sum(dim=1, keepdim=True)


def silhouette(X, labels, k: int, prec):
    """Mean silhouette over the rows, euclidean; a singleton scores 0."""
    dist = torch.sqrt(sq_distances(X, X, prec).fill_diagonal_(0.0))
    onehot = torch.nn.functional.one_hot(labels, k).to(X.dtype)
    counts = onehot.sum(dim=0)
    per = dist @ onehot
    own = counts[labels]
    a = per.gather(1, labels[:, None])[:, 0] / (own - 1).clamp(min=1)
    other = per / counts.clamp(min=1)[None]
    other = torch.where(torch.nn.functional.one_hot(labels, k).bool()
                        | (counts == 0)[None], torch.inf, other)
    b = other.min(dim=1).values
    s = torch.where(own <= 1, 0.0, (b - a) / torch.maximum(a, b))
    return float(s.mean())


def consensus(merged, k: int, norm, tpm, tpm_std, hvgs, *, solver, tol,
              max_iter, density_threshold, neighborhood, prec, zero_safe):
    """The consensus outputs at K: spectra (k, G), usages (N, k), TPM
    spectra (k, Gall), score spectra (k, Gall), as float64 numpy."""
    R = merged.shape[0]
    l2p = l2_rows(merged, pad_rows(R))
    density = local_density(l2p, R, int(neighborhood * R / k), prec)
    keep = (density < density_threshold) & (
        torch.arange(l2p.shape[0], device=l2p.device) < R)
    n_points = int(keep.sum())
    # the kept spectra first, in their order, the rest after them
    Xp = l2p[torch.argsort((~keep).to(torch.int8), stable=True)]
    w = (torch.arange(Xp.shape[0], device=Xp.device) < n_points).to(Xp.dtype)
    mean_c = torch.sum(Xp * w[:, None], dim=0) / n_points
    var_c = torch.sum((Xp - mean_c[None, :]) ** 2 * w[:, None], dim=0) / n_points
    lloyd_tol = float(np.float32(1e-4)) * torch.mean(var_c)
    kept = Xp[:n_points]
    med = medians(kept, kmeans.best_labels(Xp, n_points, k, lloyd_tol, prec),
                  k)
    fit = dict(solver=solver, tol=tol, max_iter=max_iter, prec=prec)
    usages = refit(norm, med, **fit)
    nu = usages / torch.where(usages.sum(dim=1, keepdim=True) == 0, 1.0,
                              usages.sum(dim=1, keepdim=True))
    order = torch.argsort(-nu.sum(dim=0), stable=True)
    usages, nu, med = usages[:, order], nu[:, order], med[order]
    spectra_tpm = refit(tpm.T, nu.T.contiguous(), **fit).T
    n = tpm.shape[0]
    mean = tpm.mean(dim=0)
    var = torch.cat([((tpm[:, s:s + 2048] - mean[s:s + 2048]) ** 2).sum(dim=0)
                     for s in range(0, tpm.shape[1], 2048)]) / n
    inv_std = 1.0 / torch.sqrt(var.clamp(min=1e-12))
    XtX = mm(usages.T, usages, prec)
    XtY = (mm(usages.T, tpm, prec) - usages.sum(dim=0)[:, None]
           * mean[None, :]) * inv_std[None, :]
    score = np.linalg.lstsq(XtX.double().cpu().numpy(),
                            XtY.double().cpu().numpy(), rcond=None)[0]
    hv = torch.as_tensor(np.asarray(hvgs), device=tpm.device)
    sub = tpm[:, hv]
    std = sub.std(dim=0, unbiased=True)
    if zero_safe:
        std = torch.where(std == 0, 1.0, std)
    spectra_rf = spectra_tpm[:, hv] / torch.as_tensor(
        np.asarray(tpm_std)[np.asarray(hvgs)], device=tpm.device,
        dtype=tpm.dtype)[None, :]
    final = refit(sub / std, spectra_rf, **fit)
    return {name: t.double().cpu().numpy() if isinstance(t, torch.Tensor)
            else t for name, t in (("spectra", med), ("usages", final),
                                   ("spectra_tpm", spectra_tpm),
                                   ("spectra_score", score))}


def k_stats(merged, k: int, norm, *, solver, tol, max_iter, prec):
    """(silhouette, prediction error) at K."""
    R = merged.shape[0]
    Xp = l2_rows(merged, pad_rows(R))
    l2 = Xp[:R]
    lloyd_tol = 1e-4 * torch.mean(torch.mean(
        (l2 - l2.mean(dim=0, keepdim=True)) ** 2, dim=0))
    labels = kmeans.best_labels(Xp, R, k, lloyd_tol, prec)
    med = medians(l2, labels, k)
    usages = refit(norm, med, solver=solver, tol=tol, max_iter=max_iter,
                   prec=prec)
    err = 0.0
    for s in range(0, norm.shape[0], 8192):
        diff = norm[s:s + 8192] - mm(usages[s:s + 8192], med, prec)
        err += float((diff.double() ** 2).sum())
    return silhouette(l2, labels, k, prec), err
