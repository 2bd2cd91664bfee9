"""PCA on the device through the smaller Gram matrix.

Replaces ``sc.pp.pca(zero_center=True)`` (reference preprocess.py:330) for
the Harmony embedding, as ``cnmf_tpu.ops.pca`` does, with sklearn's u-based
``svd_flip`` sign convention so components are deterministic: the (G, G) or
(N, N) product of the centred data, then ``torch.linalg.eigh`` of that small
square in float32 — the same top-``n_comps`` subspace as an SVD at PCA-level
accuracy (the embedding feeds Harmony's soft clustering).
"""

from __future__ import annotations

import numpy as np
import torch


def _flip_signs(U: torch.Tensor) -> torch.Tensor:
    """svd_flip (u_based): the sign that makes each column's largest-|u|
    entry positive; a null direction (a zero column) keeps +1."""
    max_idx = torch.argmax(torch.abs(U), dim=0)
    signs = torch.sign(U[max_idx, torch.arange(U.shape[1], device=U.device)])
    return torch.where(signs == 0, 1.0, signs)


def _descending_eigh(G: torch.Tensor):
    """Eigenvalues (clipped at 0) and eigenvectors of a symmetric matrix,
    largest first (``eigh`` returns them ascending)."""
    evals, V = torch.linalg.eigh(G)
    return torch.clamp(evals.flip(0), min=0.0), V.flip(1)


def _pca_gram_features(X: torch.Tensor, n_comps: int):
    """N >= G: eigh of the (G, G) feature Gram."""
    Xc = X - torch.mean(X, dim=0)
    evals, V = _descending_eigh(Xc.T @ Xc)
    Vk = V[:, :n_comps]
    US = Xc @ Vk   # = U * S, (N, k)
    signs = _flip_signs(US)
    explained_var = evals[:n_comps] / (X.shape[0] - 1)
    return US * signs[None, :], (Vk * signs[None, :]).T, explained_var


def _pca_gram_rows(X: torch.Tensor, n_comps: int):
    """N < G: eigh of the (N, N) row Gram (U lives there directly)."""
    Xc = X - torch.mean(X, dim=0)
    evals, U = _descending_eigh(Xc @ Xc.T)
    S = torch.sqrt(evals[:n_comps])
    Uk = U[:, :n_comps]
    Uk = Uk * _flip_signs(Uk)[None, :]
    components = Uk.T @ Xc
    # Vᵀ = S⁻¹UᵀXc has unit rows: renormalizing gives a null direction a
    # unit-norm row too, the feature-Gram branch's convention
    row_norms = torch.linalg.norm(components, dim=1, keepdim=True)
    components = components / torch.clamp(row_norms,
                                          min=torch.finfo(Xc.dtype).tiny)
    explained_var = evals[:n_comps] / (X.shape[0] - 1)
    return Uk * S[None, :], components, explained_var


def pca(X, n_comps: int = 50, *, device="cuda"):
    """Returns (cell_embeddings (N, n_comps), components (n_comps, G),
    explained_variance) as float32 host arrays, computed on ``device``.
    X: (N, G) array or tensor."""
    if isinstance(X, torch.Tensor):
        X = X.to(device=device, dtype=torch.float32)
    else:
        X = torch.as_tensor(np.asarray(X, dtype=np.float32), device=device)
    n_comps = min(n_comps, min(X.shape) - 1)
    fn = _pca_gram_features if X.shape[0] >= X.shape[1] else _pca_gram_rows
    return tuple(t.cpu().numpy() for t in fn(X, n_comps))
