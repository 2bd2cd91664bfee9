"""OLS of (optionally z-scored) targets on usages, in PyTorch.

Replaces the reference's chunked-on-CPU ``efficient_ols_all_cols``
(reference cnmf.py:55-125) as ``cnmf_tpu.ops.ols`` does for a
device-resident Y: Beta = (UᵀU)⁻¹ Uᵀ Z where Z is the per-column z-scored
target matrix. UᵀZ is one matmul with the z-scoring folded in; the K×K solve
runs on the host with numpy's lstsq (LAPACK gelsd) to match the reference's
rcond=None semantics.
"""

from __future__ import annotations

import numpy as np
import torch


def _xty_zscored(U: torch.Tensor, Y: torch.Tensor, mean: torch.Tensor,
                 inv_std: torch.Tensor) -> torch.Tensor:
    """Uᵀ · ((Y - mean)·inv_std) without materializing the normalized Y:
    UᵀY·inv_std − (Uᵀ1)·(mean·inv_std)."""
    uty = U.T @ Y
    u_sum = torch.sum(U, dim=0)
    return (uty - u_sum[:, None] * mean[None, :]) * inv_std[None, :]


def _column_moments(Y: torch.Tensor):
    """Per-column mean and variance (ddof 0) as host float64 arrays, by the
    two-pass form E[(Y-mean)²]: the one-pass E[Y²]-mean² cancels badly in
    f32 for high-mean, low-variance columns. Column chunks bound the centered
    temporary at ~800 MB."""
    n = Y.shape[0]
    gchunk = max(1, int(8e8 // max(n * Y.element_size(), 1)))
    means, variances = [], []
    for s in range(0, Y.shape[1], gchunk):
        Ys = Y[:, s:s + gchunk]
        m = torch.sum(Ys, dim=0) / n
        means.append(m)
        variances.append(torch.sum((Ys - m[None, :]) ** 2, dim=0) / n)
    return (torch.cat(means).cpu().numpy().astype(np.float64),
            torch.cat(variances).cpu().numpy().astype(np.float64))


def efficient_ols_all_cols(
    U: np.ndarray,
    Y: torch.Tensor,
    normalize_y: bool = False,
) -> np.ndarray:
    """OLS coefficients (n_predictors × n_targets) of Y's columns on U.

    U: (N, K) host usages; Y: (N, G) tensor, whose dtype the products run
    in. With ``normalize_y``, Y's columns are z-scored (variance floored at
    1e-12, reference cnmf.py:89-95), folded into the matmul."""
    n = U.shape[0]
    if Y.shape[0] != n:
        raise ValueError("U and Y must have the same number of rows.")
    U = np.ascontiguousarray(U, dtype=torch.empty(0, dtype=Y.dtype).numpy().dtype)
    XtX = (U.T @ U).astype(np.float64)
    Ud = torch.as_tensor(U, device=Y.device)
    if normalize_y:
        mean_y, var_y = _column_moments(Y)
        var_y = np.maximum(var_y, 1e-12)
        inv_std = torch.as_tensor(1.0 / np.sqrt(var_y), device=Y.device)
        XtY = _xty_zscored(Ud, Y, torch.as_tensor(mean_y, device=Y.device)
                           .to(Y.dtype), inv_std.to(Y.dtype))
    else:
        XtY = Ud.T @ Y
    beta, *_ = np.linalg.lstsq(XtX, XtY.cpu().numpy().astype(np.float64),
                               rcond=None)
    return beta
