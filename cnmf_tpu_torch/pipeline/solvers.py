"""Solver dispatch: sklearn-style NMF kwargs → the batched CD or MU solver.

A subset of ``cnmf_tpu.pipeline.solvers``. The pipeline persists one YAML
kwargs dict per run (same keys as the reference's sklearn kwargs,
cnmf.py:618-631) and every stage rebuilds its solver from it: ``solver="cd"``
(frobenius) or ``solver="mu"`` (any beta loss). Where a solve runs follows
its tensors: CUDA tensors go through the hand-written kernels of
``ops.cd_kernels`` and ``ops.mu_kernels``, CPU tensors through their plain
PyTorch versions. That replaces the JAX package's ``cd_pallas_eligible`` /
``mu_pallas_eligible`` gates. On CUDA every beta runs: MU at beta=2 runs
plain matmuls, at beta=1 the KL kernels, at any other beta (0 is
Itakura-Saito) the general-beta kernels.

On the card a factorize solve takes the device ladder
(``solve_nmf_batch_ladder``) unless ``CNMF_TPU_DEVICE_LADDER=0``
(``device_ladder_enabled``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from cnmf_tpu_torch.native import densify_csr
from cnmf_tpu_torch.ops import mu_kernels
from cnmf_tpu_torch.ops.cd_kernels import numpy_dtype, pad_bucket, torch_dtype
from cnmf_tpu_torch.ops.init import nnls_w_init
from cnmf_tpu_torch.ops.nmf import (
    _ladder,
    fixed_factor_gram,
    fixed_factor_product_transposed,
    nmf_cd_device_ladder,
    nmf_coordinate_descent,
    nmf_mu_device_ladder,
    nmf_multiplicative_update,
    nnls_cd_fixed_spectra,
    nnls_cd_from_products,
)

BETA_LOSS = {"frobenius": 2.0, "kullback-leibler": 1.0, "itakura-saito": 0.0}


def beta_loss_to_float(beta_loss) -> float:
    if isinstance(beta_loss, str):
        return BETA_LOSS[beta_loss]
    return float(beta_loss)


def compute_regularization(
    alpha_W: float, alpha_H, l1_ratio: float, shape
) -> Tuple[float, float, float, float]:
    """sklearn _compute_regularization scaling: W-regs scale with n_features,
    H-regs with n_samples."""
    n_samples, n_features = shape
    if alpha_H == "same" or alpha_H is None:
        alpha_H = alpha_W
    l1_reg_W = n_features * alpha_W * l1_ratio
    l1_reg_H = n_samples * alpha_H * l1_ratio
    l2_reg_W = n_features * alpha_W * (1.0 - l1_ratio)
    l2_reg_H = n_samples * alpha_H * (1.0 - l1_ratio)
    return float(l1_reg_W), float(l1_reg_H), float(l2_reg_W), float(l2_reg_H)


def _regularization(nmf_kwargs: dict, shape):
    return compute_regularization(
        float(nmf_kwargs.get("alpha_W", 0.0)),
        nmf_kwargs.get("alpha_H", "same"),
        float(nmf_kwargs.get("l1_ratio", 0.0)),
        shape,
    )


def _is_mu(nmf_kwargs: dict) -> bool:
    """True for the MU solver; the CD solver takes frobenius loss only."""
    if nmf_kwargs.get("solver", "cd") != "cd":
        return True
    if beta_loss_to_float(nmf_kwargs.get("beta_loss", "frobenius")) != 2.0:
        raise ValueError("CD solver supports frobenius loss only")
    return False


def solve_nmf_batch(
    X: torch.Tensor,
    W0: torch.Tensor,
    Ht0: torch.Tensor,
    nmf_kwargs: dict,
    update_H: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the batched solver described by sklearn-style kwargs.

    X: (N, G); W0: (B, N, K); Ht0: (B, G, K), all on one device. Returns
    (W, Ht, n_iter)."""
    tol = float(nmf_kwargs.get("tol", 1e-4))
    max_iter = int(nmf_kwargs.get("max_iter", 200))
    l1_reg_W, l1_reg_H, l2_reg_W, l2_reg_H = _regularization(nmf_kwargs, X.shape)
    if _is_mu(nmf_kwargs):
        # any beta, on either device (ops.nmf picks the kernels per beta)
        return nmf_multiplicative_update(
            X, W0, Ht0,
            beta=beta_loss_to_float(nmf_kwargs.get("beta_loss", "frobenius")),
            tol=tol, max_iter=max_iter, update_H=update_H,
            l1_reg_W=l1_reg_W, l1_reg_H=l1_reg_H,
            l2_reg_W=l2_reg_W, l2_reg_H=l2_reg_H,
        )
    if not update_H:
        # fixed-spectra refit → products-distilled half-sweep loop
        W, n_iter = nnls_cd_fixed_spectra(
            X, Ht0, W0, tol=tol, max_iter=max_iter,
            l1_reg=l1_reg_W, l2_reg=l2_reg_W,
        )
        return W, Ht0, n_iter
    return nmf_coordinate_descent(
        X, W0, Ht0, tol=tol, max_iter=max_iter, update_H=True,
        l1_reg_W=l1_reg_W, l1_reg_H=l1_reg_H,
        l2_reg_W=l2_reg_W, l2_reg_H=l2_reg_H,
    )


def device_ladder_enabled(X: torch.Tensor, ladder: Optional[bool] = None) -> bool:
    """Whether a factorize solve on X's device takes the device ladder:
    ``ladder`` as given, else the CNMF_TPU_DEVICE_LADDER knob ('1' on, '0'
    off), else on for CUDA tensors and off on the CPU, where the plain
    batched solver stays (cnmf_tpu/pipeline/solvers.py:531)."""
    if ladder is not None:
        return bool(ladder)
    env = os.environ.get("CNMF_TPU_DEVICE_LADDER", "")
    return env == "1" or (env != "0" and X.device.type == "cuda")


def ladder_rungs(X: torch.Tensor, B: int, K: int, nmf_kwargs: dict,
                 min_bucket: int = 16) -> tuple:
    """The batch sizes a factorize solve of B restarts at bucket K shrinks
    through: ``ops.nmf._ladder``'s, less, for MU on CUDA, every rung whose
    arithmetic would differ from the first rung's. At beta 2 that is every
    later rung: its products are cuBLAS GEMMs over the whole batch
    (``cd_kernels._shared_x_dot``), whose split of the contraction may follow
    the batch's width. At any other beta it is every rung whose kernels
    would split their contraction otherwise than the first rung's
    (``mu_kernels.split_plan`` splits a small grid).

    The ladder keeps the plain solver's n_iter and bits where every other
    launch of a step gives each restart the same bits at every rung's size
    and place in the batch: the kernels, ``cd_kernels._gram``'s ``bmm``, the
    kernels' partial sums, and the factor sums and divergences that
    ``mu_kernels.restart_sums`` and whole chunks give a fixed order.
    ``chip_smoke.py``'s ``[batch]`` line checks that at every bucket 8..64
    with the main path's X (2700 × 2000) on an H100; other shapes and cards
    are not checked."""
    ladder = _ladder(int(B), min_bucket)
    if not _is_mu(nmf_kwargs) or X.device.type != "cuda":
        return tuple(ladder)
    beta = beta_loss_to_float(nmf_kwargs.get("beta_loss", "frobenius"))
    if beta == 2:
        return tuple(ladder[:1])
    plan = mu_kernels.launch_splits(X, ladder[0], K, beta)
    return tuple(ladder[:1] + [s for s in ladder[1:] if
                               mu_kernels.launch_splits(X, s, K, beta) == plan])


def solve_nmf_batch_ladder(X, W0, Ht0, nmf_kwargs: dict, min_bucket: int = 16):
    """The factorize solve on a batch that shrinks as restarts finish
    (``ops.nmf.nmf_cd_device_ladder`` / ``nmf_mu_device_ladder``) through
    ``ladder_rungs``, CD or MU by the sklearn-style kwargs
    (cnmf_tpu/pipeline/solvers.py:540); update_H=True only. Returns
    (spectra (B, K, G), n_iter (B,), (ladder sizes, stage_sweeps))."""
    tol = float(nmf_kwargs.get("tol", 1e-4))
    max_iter = int(nmf_kwargs.get("max_iter", 200))
    l1_reg_W, l1_reg_H, l2_reg_W, l2_reg_H = _regularization(nmf_kwargs, X.shape)
    regs = dict(l1_reg_W=l1_reg_W, l1_reg_H=l1_reg_H, l2_reg_W=l2_reg_W,
                l2_reg_H=l2_reg_H)
    ladder = ladder_rungs(X, W0.shape[0], W0.shape[2], nmf_kwargs, min_bucket)
    if not _is_mu(nmf_kwargs):
        spec, n_iter, sweeps = nmf_cd_device_ladder(
            X, W0, Ht0, tol=tol, max_iter=max_iter, ladder=ladder, **regs)
        return spec, n_iter, (ladder, sweeps)
    beta = beta_loss_to_float(nmf_kwargs.get("beta_loss", "frobenius"))
    spec, n_iter, sweeps = nmf_mu_device_ladder(
        X, W0, Ht0, beta=beta, tol=tol, max_iter=max_iter, ladder=ladder,
        **regs)
    return spec, n_iter, (ladder, sweeps)


def _placement(X, device, dtype):
    """(device, numpy dtype) of a refit: a tensor X's own, or ``device`` and
    ``dtype`` (numpy or torch) for a host X."""
    if isinstance(X, torch.Tensor):
        device, dtype = X.device, X.dtype
    elif device is None or dtype is None:
        raise ValueError("a host X needs device= and dtype=")
    return torch.device(device), numpy_dtype(dtype)


def _dense_on(X, device, np_dtype) -> torch.Tensor:
    """A tensor X as it is; a host X densified (natively, when sparse) at
    ``np_dtype`` and put on ``device``."""
    if isinstance(X, torch.Tensor):
        return X
    return torch.as_tensor(
        np.ascontiguousarray(densify_csr(X, out_dtype=np_dtype)), device=device)


def _cd_from_products(gram, P, nmf_kwargs, l1_reg, l2_reg):
    """The products-given CD NNLS from zeros (sklearn's CD refit init)."""
    W0 = torch.zeros_like(P)
    W, _ = nnls_cd_from_products(
        gram, P, W0, tol=float(nmf_kwargs.get("tol", 1e-4)),
        max_iter=int(nmf_kwargs.get("max_iter", 200)),
        l1_reg=l1_reg, l2_reg=l2_reg,
    )
    return W


def refit_spectra_transposed(X, usages: np.ndarray, nmf_kwargs: dict, *,
                             device=None, dtype=None) -> np.ndarray:
    """Fixed-usage spectra refit via the transpose trick (reference
    cnmf.py:805-820, 948-955) without materializing Xᵀ: the CD refit needs
    only the usage gram and Xᵀ·U; the MU refit is the usage refit of Xᵀ, a
    transposed view that the kernels read through its strides.

    X: (cells × genes) tensor, or a host matrix with ``device`` and
    ``dtype`` given. A sparse host X (the atlas consensus) is the usage
    refit of its transpose, whose CD path takes Xᵀ·U by host SpMM, so it
    never goes dense anywhere; it is CD-only, as in the JAX package
    (cnmf_tpu/pipeline/solvers.py:806-879). usages: (cells × k). Returns
    spectra in X's units, transposed: (genes × k), as a host array."""
    dev, np_dtype = _placement(X, device, dtype)
    if sp.issparse(X):
        if _is_mu(nmf_kwargs):
            raise ValueError(
                "refit_spectra_transposed: sparse X is CD-only; the MU "
                "spectra refit of a host TPM goes in gene chunks "
                "(stages.consensus_arrays)")
        return refit_usages(X.T, np.ascontiguousarray(usages.T), nmf_kwargs,
                            device=dev, dtype=np_dtype)
    if _is_mu(nmf_kwargs):
        Xd = _dense_on(X, dev, np_dtype)
        return refit_usages(Xd.T, np.ascontiguousarray(usages.T), nmf_kwargs)
    k = usages.shape[1]
    pad_k = pad_bucket(k)
    U = np.pad(np.ascontiguousarray(usages, dtype=np_dtype),
               ((0, 0), (0, pad_k - k)))
    Ud = torch.as_tensor(U, device=dev)
    # the materialized-transpose solve's X is (genes × cells): n_features is
    # the cell count
    l1_reg_W, _, l2_reg_W, _ = _regularization(
        nmf_kwargs, (X.shape[1], X.shape[0])
    )
    P = fixed_factor_product_transposed(Ud, _dense_on(X, dev, np_dtype))
    W = _cd_from_products(fixed_factor_gram(Ud[None]), P, nmf_kwargs,
                          l1_reg_W, l2_reg_W)
    return W[0, :, :k].cpu().numpy()


def refit_usages(X, spectra: np.ndarray, nmf_kwargs: dict, *, device=None,
                 dtype=None) -> np.ndarray:
    """Fixed-spectra NNLS usage refit (sklearn update_H=False semantics;
    reference cnmf.py:776-802), W started by ``nnls_w_init``.

    X: (cells × genes) tensor, or a host matrix with ``device`` and
    ``dtype`` given. A sparse host X never goes dense on the CD path: the
    refit takes the spectra gram and P = X·Hᵀ by one host SpMM at the
    compute dtype, and the device runs the (cells × k) products-given loop
    from zeros (cnmf_tpu/pipeline/solvers.py:963-996). MU needs the
    reconstruction against X itself, so a sparse X is densified on the host
    (natively) and uploaded. spectra: (k × genes). Returns usages (cells ×
    k) as a host array."""
    dev, np_dtype = _placement(X, device, dtype)
    k = spectra.shape[0]
    pad_k = pad_bucket(k)
    Ht = np.pad(np.ascontiguousarray(np.asarray(spectra).T, dtype=np_dtype),
                ((0, 0), (0, pad_k - k)))
    Ht0 = torch.as_tensor(Ht, device=dev)[None]
    if sp.issparse(X) and not _is_mu(nmf_kwargs):
        l1_reg_W, _, l2_reg_W, _ = _regularization(nmf_kwargs, X.shape)
        P = torch.as_tensor(np.ascontiguousarray(X @ Ht, dtype=np_dtype),
                            device=dev)[None]
        W = _cd_from_products(fixed_factor_gram(Ht0), P, nmf_kwargs,
                              l1_reg_W, l2_reg_W)
        return W[0, :, :k].cpu().numpy()
    Xd = _dense_on(X, dev, np_dtype)
    W0 = nnls_w_init(Xd, k, "mu" if _is_mu(nmf_kwargs) else "cd", pad_k=pad_k)
    W, _, _ = solve_nmf_batch(Xd, W0, Ht0, nmf_kwargs, update_H=False)
    return W[0, :, :k].cpu().numpy()
