"""Harmony batch correction in PyTorch (Korsunsky et al. 2019).

The algorithm of ``cnmf_tpu.harmony``, which replaces the harmonypy
dependency the reference shells out to (reference preprocess.py:362-422):
soft k-means over the PCA embedding with a batch-diversity penalty
(R-updates in random cell blocks), alternated with a mixture-of-experts
ridge regression that subtracts batch-specific components. The converged
cluster responsibilities correct the **expression matrix** itself, not just
the PCs (``moe_correct_ridge_X``, reference preprocess.py:9-18, 416-420).

Everything runs on one device as plain tensor functions; only the kmeans++
seeding (``ops.kmeans``) and the block permutations are drawn on the host,
from the same ``RandomState`` streams as the JAX package. The blocks of a
round run in order (each reads the E and O the previous one left); the
convergence test of the clustering rounds reads one scalar back a round.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from cnmf_tpu_torch.ops.kmeans import kmeans_fit


def _one_hot_phi(meta_data: pd.DataFrame, vars_use: List[str]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked one-hot membership (levels × cells) + levels-per-variable."""
    dummies = [pd.get_dummies(meta_data[v]) for v in vars_use]
    phi = pd.concat(dummies, axis=1).T.to_numpy().astype(np.float32)
    phi_n = np.array([d.shape[1] for d in dummies])
    return phi, phi_n


def _per_level(values, phi_n, n_levels: int) -> np.ndarray:
    """A per-variable parameter (theta, lambda) repeated over each
    variable's levels; a scalar or a wrong-length vector gives every level
    its first value."""
    values = np.atleast_1d(values)
    if values.size == len(phi_n):
        return np.repeat(np.asarray(values, dtype=np.float64), phi_n)
    return np.repeat(float(values[0]), n_levels)


def _update_R_blocked(scale_dist, R, E, O, phi, Pr_b, theta, perm, L: int):
    """Diversity-penalized soft assignment updates over the cell blocks of
    one permutation, in order: block b is ``perm[b*L:(b+1)*L]`` (the last
    one shorter when L does not divide N). Updates R, E and O in place.

    scale_dist: (K, N) exp(-dist/sigma) (already max-subtracted)."""
    for start in range(0, perm.shape[0], L):
        idx = perm[start:start + L]
        Rb = R[:, idx]
        phib = phi[:, idx]
        E -= torch.outer(torch.sum(Rb, dim=1), Pr_b)
        O -= Rb @ phib.T
        penalty = torch.pow((E + 1.0) / (O + 1.0), theta[None, :]) @ phib
        R_new = scale_dist[:, idx] * penalty
        norm = torch.sum(torch.abs(R_new), dim=0, keepdim=True)
        R_new = R_new / torch.where(norm == 0, 1.0, norm)
        E += torch.outer(torch.sum(R_new, dim=1), Pr_b)
        O += R_new @ phib.T
        R[:, idx] = R_new


def _moe_correct_ridge(Z_orig, R, Phi_moe, lamb_diag):
    """Subtract per-cluster batch components: for each cluster k,
    W = (Φ_Rk Φ_moeᵀ + Λ)⁻¹ Φ_Rk Z_origᵀ with the intercept row zeroed,
    then Z_corr -= Wᵀ Φ_Rk (reference preprocess.py:9-18). The K ridge
    solves (all against Z_orig) run as one batched solve; the corrections
    are subtracted in cluster order."""
    Phi_R = Phi_moe[None, :, :] * R[:, None, :]             # (K, B+1, N)
    A = Phi_R @ Phi_moe.T + lamb_diag                       # (K, B+1, B+1)
    rhs = (Phi_R.reshape(-1, Phi_R.shape[2]) @ Z_orig.T).reshape(
        Phi_R.shape[0], Phi_R.shape[1], Z_orig.shape[0])    # (K, B+1, d)
    W = torch.linalg.solve(A, rhs)
    W[:, 0, :] = 0.0   # do not remove the intercept
    Z_corr = Z_orig.clone()
    for k in range(W.shape[0]):
        Z_corr.addmm_(W[k].T, Phi_R[k], alpha=-1.0)
    return Z_corr


def _cells(data_mat) -> Tuple[np.ndarray, np.ndarray]:
    """A cells × d embedding as (d, N) float32 and its L2-normalized cells,
    on the host, where the kmeans++ seeding reads them
    (cnmf_tpu/harmony.py:157-160)."""
    Z_orig = np.ascontiguousarray(data_mat.T, dtype=np.float32)
    return Z_orig, Z_orig / np.maximum(
        np.linalg.norm(Z_orig, ord=2, axis=0), 1e-12)


def _init_centroids(Z_cos: torch.Tensor, K: int, random_state
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Harmony's starting clusters over the normalized cells (d, N) on their
    device: kmeans++ (host) + Lloyd(25), 10 inits. Returns the cells' labels
    and the centroids as unit columns (d, K), on the host
    (cnmf_tpu/harmony.py:164-167)."""
    labels, centers, _ = kmeans_fit(Z_cos.T.contiguous(), n_clusters=K,
                                    n_init=10, random_state=random_state,
                                    max_iter=25)
    Y = centers.T
    return labels, Y / np.maximum(np.linalg.norm(Y, ord=2, axis=0), 1e-12)


def _safe_entropy(R):
    return torch.where(R > 0, R * torch.log(torch.clamp(R, min=1e-30)), 0.0)


def _l2_columns(Z):
    return Z / torch.clamp(torch.linalg.norm(Z, dim=0, keepdim=True),
                           min=1e-12)


class HarmonyResult:
    """Converged Harmony state (cells-as-rows layout), as host arrays, and
    the device it was computed on."""

    def __init__(self, Z_corr, R, Phi_moe, lamb_diag, K, objectives,
                 device="cuda", iterations=0, rounds=0):
        self.Z_corr = Z_corr          # (N, d) corrected embedding
        self.R = R                    # (K, N) responsibilities
        self.Phi_moe = Phi_moe        # (B+1, N) design with intercept
        self.lamb = lamb_diag         # (B+1, B+1) ridge penalty
        self.K = K
        self.objective_harmony = objectives
        self.device = torch.device(device)
        self.iterations = iterations  # Harmony iterations run
        self.rounds = rounds          # clustering rounds run, all iterations


def run_harmony(
    data_mat: np.ndarray,
    meta_data: pd.DataFrame,
    vars_use,
    theta=None,
    lamb=None,
    sigma: float = 0.1,
    nclust: Optional[int] = None,
    tau: float = 0,
    block_size: float = 0.05,
    max_iter_harmony: int = 10,
    max_iter_kmeans: int = 20,
    epsilon_cluster: float = 1e-5,
    epsilon_harmony: float = 1e-4,
    random_state: int = 0,
    verbose: bool = False,
    device="cuda",
) -> HarmonyResult:
    """Harmony on a cells × d embedding, in float32 on ``device``; returns
    the converged state."""
    if isinstance(vars_use, str):
        vars_use = [vars_use]
    dev = torch.device(device)
    N, d = data_mat.shape
    K = nclust if nclust is not None else int(min(np.round(N / 30.0), 100))
    K = max(K, 2)

    phi, phi_n = _one_hot_phi(meta_data, vars_use)
    n_levels = phi.shape[0]
    theta = _per_level(1.0 if theta is None else theta, phi_n, n_levels)
    lamb = _per_level(1.0 if lamb is None else lamb, phi_n, n_levels)

    N_b = phi.sum(axis=1)
    Pr_b = (N_b / N).astype(np.float32)
    if tau > 0:
        theta = theta * (1 - np.exp(-((N_b / (K * tau)) ** 2)))
    theta = theta.astype(np.float32)
    lamb_diag = np.diag(np.insert(lamb, 0, 0)).astype(np.float32)
    Phi_moe = np.vstack([np.ones(N, dtype=np.float32), phi])

    def on_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    Z_orig, Z_cos = (on_dev(a) for a in _cells(data_mat))
    Y = on_dev(_init_centroids(Z_cos, K, random_state)[1])
    phid, Prb, thetad = on_dev(phi), on_dev(Pr_b), on_dev(theta)
    lambd, Phi_moed = on_dev(lamb_diag), on_dev(Phi_moe)
    sig = torch.full((K, 1), np.float32(sigma), device=dev)

    def distance(Y, Z_cos):
        return 2.0 * (1.0 - Y.T @ Z_cos)

    dist = distance(Y, Z_cos)
    R = -dist / sig
    R = torch.exp(R - torch.max(R, dim=0, keepdim=True).values)
    R = R / torch.sum(R, dim=0, keepdim=True)
    E = torch.outer(torch.sum(R, dim=1), Prb)
    O = R @ phid.T

    def objective(R, dist, E, O):
        kmeans_error = torch.sum(R * dist)
        entropy = torch.sum(_safe_entropy(R) * sig)
        cross = torch.sum((R * sig) * (
            (thetad[None, :] * torch.log((O + 1.0) / (E + 1.0))) @ phid))
        return kmeans_error + entropy + cross

    # the cells reshuffle every R-update round (harmonypy reshuffles per
    # update_R call): a pool of max_iter_kmeans permutations drawn once,
    # indexed by the round count over all iterations
    rng = np.random.RandomState(random_state)
    pool = on_dev(np.stack([rng.permutation(N)
                            for _ in range(max_iter_kmeans)]))
    L = int(np.ceil(N / int(np.ceil(1.0 / block_size))))

    objectives, round_offset, it = [], 0, 0
    for it in range(max_iter_harmony):
        obj = float("inf")
        for kit in range(max_iter_kmeans):
            sd = -distance(Y, Z_cos) / sig
            sd = torch.exp(sd - torch.max(sd, dim=0, keepdim=True).values)
            _update_R_blocked(sd, R, E, O, phid, Prb, thetad,
                              pool[(round_offset + kit) % len(pool)], L)
            Y = _l2_columns(Z_cos @ R.T)
            new_obj = float(objective(R, distance(Y, Z_cos), E, O))
            done = kit > 2 and (abs(obj - new_obj) / max(abs(obj), 1e-12)
                                < epsilon_cluster)
            obj = new_obj
            if done:
                break
        round_offset += kit + 1
        Z_corr = _moe_correct_ridge(Z_orig, R, Phi_moed, lambd)
        Z_cos = _l2_columns(Z_corr)
        objectives.append(obj)
        if verbose:
            print(f"harmony iter {it}: objective {obj:.4f}")
        if it > 0:
            prev, cur = objectives[-2], objectives[-1]
            if abs(prev - cur) / max(abs(prev), 1e-12) < epsilon_harmony:
                break

    return HarmonyResult(
        Z_corr=Z_corr.T.cpu().numpy(),
        R=R.cpu().numpy(),
        Phi_moe=Phi_moe,
        lamb_diag=lamb_diag,
        K=K,
        objectives=objectives,
        device=dev,
        iterations=it + 1,
        rounds=round_offset,
    )


def moe_correct_ridge_X(X: np.ndarray, result: HarmonyResult,
                        chunk_genes: int = 4096) -> np.ndarray:
    """Apply the converged MOE ridge correction to an expression matrix
    (cells × genes) on the result's device, 4096 genes at a time, clipping
    negatives to 0 — the reference's correct-X-not-PCs semantics (reference
    preprocess.py:338,416-420). Returns a float32 host array."""
    dev = result.device

    def on_dev(a):
        # a copy: the arrays may be read-only views
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(dev)

    R, Phi_moe, lamb = on_dev(result.R), on_dev(result.Phi_moe), \
        on_dev(result.lamb)
    G = X.shape[1]
    out = np.empty(X.shape, dtype=np.float32)
    for start in range(0, G, chunk_genes):
        end = min(start + chunk_genes, G)
        Zc = _moe_correct_ridge(on_dev(X[:, start:end].T), R, Phi_moe, lamb)
        out[:, start:end] = torch.clamp(Zc.T, min=0.0).cpu().numpy()
    return out
