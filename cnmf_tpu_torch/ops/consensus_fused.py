"""The one-program consensus: everything from Lloyd to the final refit on the
device, read back in one drain.

The consensus stage (reference cnmf.py:823-1082) is a chain of device steps
— KMeans, cluster medians, an NNLS usage refit, a usage reordering, the
fixed-usage TPM spectra refit, the z-scored OLS grams and the final usage
refit — that the step-by-step path (``pipeline.stages.consensus_arrays``)
runs with host reads between the phases. Here, as in
``cnmf_tpu.ops.consensus_fused``, the chain is queued on the device with no
host read but the Lloyd and refit loops' block checks: ``fused_consensus``
seeds the KMeans on the host (sklearn's kmeans++ on ``RandomState``) before
it, ``fused_consensus_full`` also computes the KNN density (or takes cached
values), filters, packs the survivors and seeds with the threefry kmeans++
on the device. The host fetches every artifact in one drain and solves one
(k × k) least-squares problem after.

The normalized counts and the TPM may be row ``parallel.mesh.Shards``
(``put_cells``): padded rows are neutral (zero NNLS rows, masked moments),
the cell reductions sum over shards in order (``collectives.sum_shards``)
and the per-cell outputs are gathered before the drain. Padded cluster
slots (K bucketed to 8s) carry zero spectra, zero usages and zero grams and
sort after every real program in the usage reordering (stable argsort).
"""

from __future__ import annotations

import numpy as np
import torch

from cnmf_tpu_torch.ops import prng
from cnmf_tpu_torch.ops.cd_kernels import numpy_dtype
from cnmf_tpu_torch.ops.distance import _knn_density_body
from cnmf_tpu_torch.ops.init import nnls_w_init
from cnmf_tpu_torch.ops.kmeans import (
    PAD_SENTINEL,
    _kmeans_plusplus,
    _lloyd_batched,
    seed_kmeanspp_batch,
)
from cnmf_tpu_torch.ops.kstats import (
    _best_labels,
    _cluster_medians,
    _row_normalized,
    l2_normalize_pad,
    to_device,
)
from cnmf_tpu_torch.ops.nmf import (
    fixed_factor_gram,
    fixed_factor_product_transposed,
    nmf_multiplicative_update,
    nnls_cd_fixed_spectra,
    nnls_cd_from_products,
)
from cnmf_tpu_torch.parallel.collectives import (
    broadcast,
    gather_shards,
    sum_shards,
)
from cnmf_tpu_torch.parallel.mesh import Shards

# the JAX package's names for the shared helpers
_l2_normalize_pad = l2_normalize_pad
_seed_kmeanspp_batch = seed_kmeanspp_batch


def _parts(x):
    """The per-device parts of a tensor or of ``Shards``."""
    return x.parts if isinstance(x, Shards) else [x]


def _like(parts, like, axis=None):
    """``parts`` laid out as ``like``: ``Shards`` of them, or the one tensor."""
    if isinstance(like, Shards):
        return Shards(parts, like.n_rows, like.axis if axis is None else axis)
    return parts[0]


def _real_rows(x):
    """Per part, the bool mask of its real rows."""
    if not isinstance(x, Shards):
        return [torch.ones(x.shape[0], dtype=torch.bool, device=x.device)]
    return [torch.arange(p.shape[0], device=p.device) < x.real_rows(i)
            for i, p in enumerate(x.parts)]


def _nnls(X, Ht0, W0, *, solver, beta, tol, max_iter, l1_reg, l2_reg,
          mu_chunk=8, use_pallas=False):
    """Fixed-spectra NNLS usage refit (batch of 1): the CD products refit
    (``ops.nmf.nnls_cd_fixed_spectra``: the products once, then the
    products-given sweeps) or the MU solver with H fixed. X may be row
    ``Shards`` (W0 their row ``Shards``) or column ``Shards`` (MU; Ht0 their
    row ``Shards``). Returns W[0]."""
    if solver == "cd":
        W, _ = nnls_cd_fixed_spectra(X, Ht0, W0, tol=tol, max_iter=max_iter,
                                     l1_reg=l1_reg, l2_reg=l2_reg)
    else:
        W, _, _ = nmf_multiplicative_update(
            X, W0, Ht0, beta=beta, tol=tol, max_iter=max_iter,
            update_H=False, l1_reg_W=l1_reg, l2_reg_W=l2_reg)
    return W[0]


def _masked_col_sumsq_blocked(X, mean, rowmask, block: int = 2048):
    """Σ_rows (x − mean_col)² per column over the rows of ``rowmask``, in
    column blocks of ``block`` (cnmf_tpu/ops/consensus_fused.py:64-93): one
    (N, block) temporary at a time instead of a centered (N, G) copy, which
    at the atlas size would be 8 GB beside the resident TPM."""
    out = []
    for start in range(0, X.shape[1], block):
        c = torch.where(rowmask[:, None],
                        X[:, start:start + block] - mean[None, start:start + block],
                        0.0)
        out.append(torch.sum(c * c, dim=0))
    return torch.cat(out)


def _mu_w0(X, n_real_rows, n_real_cols, k_real, n_rows_total, pad_k, dtype):
    """sklearn's MU W init sqrt(mean(X)/k) over the real elements of a
    tensor X, in every column of the bucket, padded rows zero
    (cnmf_tpu/ops/consensus_fused.py:96-104). The chain itself inits
    through ``ops.init.nnls_w_init``, which does this for tensors and
    ``Shards`` alike."""
    avg = torch.sqrt(X.sum() / (n_real_rows * n_real_cols) / k_real).to(dtype)
    rows = torch.arange(n_rows_total, device=X.device) < n_real_rows
    W0 = avg.expand(1, n_rows_total, pad_k) * rows[None, :, None].to(dtype)
    return W0.contiguous()


def scaled_hvg_tpm(tpm, hvg_idx: torch.Tensor, zero_safe: bool):
    """The HVG columns of a device TPM (a tensor or row ``Shards``) scaled
    to unit variance (ddof 1) without centering, the final refit's X
    (reference cnmf.py:961-975); the moments over the real rows, the
    shards' sums in shard order; ``zero_safe`` maps a zero std to 1."""
    subs = [p.index_select(1, hvg_idx.to(p.device)) for p in _parts(tpm)]
    n = tpm.shape[0]
    mean = sum_shards([torch.sum(t, dim=0) for t in subs]) / n
    sq = sum_shards([torch.sum(t * t, dim=0) for t in subs]) / n
    std = torch.sqrt(((sq - mean * mean) * n / (n - 1)).clamp(min=0.0))
    if zero_safe:
        std = torch.where(std == 0, 1.0, std)
    stds = broadcast(std, [t.device for t in subs])
    return _like([t / s for t, s in zip(subs, stds)], tpm)


def _consensus_chain(
    Xnc,           # (N, G) normalized counts, or row Shards
    tpm,           # (N, Gall) full-gene TPM, laid out as Xnc
    Xp,            # (Rp, G) zero-padded, density-filtered L2 spectra
    centers0,      # (n_init, Kp, G) sentinel-padded kmeans++ seeds
    lloyd_tol,     # float or 0-d tensor
    n_points,      # int or 0-d tensor: real spectra rows
    n_clusters: int,
    tpm_std,       # (Gall,) tensor: prepare's per-gene TPM std
    hvg_idx,       # (H,) int64 tensor: the HVGs' columns of the TPM
    *,
    n_cluster_pad: int,
    lloyd_max_iter: int,
    solver: str,
    beta: float,
    tol: float,
    max_iter: int,
    mu_chunk: int = 8,
    use_pallas: bool = False,
    n_cells: int,
    n_hvgs: int,
    alpha_W: float,
    l1_ratio: float,
    refit_usage: bool,
    normalize_tpm: bool,
    zero_safe_std: bool,
):
    """The chain after the seeding (cnmf_tpu/ops/consensus_fused.py:107-273)
    on the device. Returns (labels (Rp,), median_n (Kp, G), rf (N, Kp),
    spectra_tpm (Kp, Gall), XtX (Kp, Kp), XtY (Kp, Gall), final_usages
    (N, Kp)), rf and final_usages laid out as Xnc."""
    dtype = Xnc.dtype
    dev = Xp.device
    Rp, G = Xp.shape[0], Xnc.shape[1]
    Gall = tpm.shape[1]
    Kp = n_cluster_pad
    refit = dict(solver=solver, beta=beta, tol=tol, max_iter=max_iter,
                 mu_chunk=mu_chunk, use_pallas=use_pallas)

    def w_regs(n_features):
        # sklearn's W-side regularization scaling; the H side never updates
        return (float(n_features) * alpha_W * l1_ratio,
                float(n_features) * alpha_W * (1.0 - l1_ratio))

    # KMeans labels (the best of n_init Lloyd runs) and cluster medians
    labels_all, inertia, _ = _lloyd_batched(Xp, centers0, lloyd_tol,
                                            n_points, n_clusters,
                                            lloyd_max_iter)
    labels = _best_labels(labels_all, inertia)
    valid = torch.arange(Rp, device=dev) < n_points
    median_n = _row_normalized(_cluster_medians(Xp, labels, valid,
                                                n_clusters, Kp)).to(dtype)

    # NNLS usage refit on the normalized counts (reference cnmf.py:918-920)
    l1, l2 = w_regs(G)
    rf = _nnls(Xnc, median_n.T.contiguous()[None],
               nnls_w_init(Xnc, n_clusters, solver, pad_k=Kp),
               l1_reg=l1, l2_reg=l2, **refit)

    # programs reordered by total normalized usage (cnmf.py:938-946)
    rf_parts = _parts(rf)
    nu_parts = []
    for r in rf_parts:
        usum = r.sum(dim=1, keepdim=True)
        nu_parts.append(r / torch.where(usum == 0, 1.0, usum))
    order = torch.argsort(-sum_shards([n.sum(dim=0) for n in nu_parts]),
                          stable=True)
    orders = broadcast(order, [r.device for r in rf_parts])
    rf_parts = [r.index_select(1, o) for r, o in zip(rf_parts, orders)]
    nu_parts = [n.index_select(1, o) for n, o in zip(nu_parts, orders)]
    median_n = median_n.index_select(0, order)

    # TPM-unit spectra: the fixed-usage NNLS over all genes (cnmf.py:948-955)
    tpm_parts = _parts(tpm)
    l1, l2 = w_regs(n_cells)
    if solver == "cd":
        # transpose-free: the usage gram and one Uᵀ·TPM product, summed
        # over the cell shards; no (Gall, N) copy of the TPM
        gram_u = sum_shards([fixed_factor_gram(n[None]) for n in nu_parts])
        P_t = sum_shards([fixed_factor_product_transposed(n, t)
                          for n, t in zip(nu_parts, tpm_parts)])
        W_t, _ = nnls_cd_from_products(
            gram_u, P_t, torch.zeros((1, Gall, Kp), dtype=dtype, device=dev),
            tol=tol, max_iter=max_iter, l1_reg=l1, l2_reg=l2)
        spectra_tpm = W_t[0]
    else:
        tpm_t = tpm.T
        # the usages as the fixed factor of Xᵀ, its rows on the TPM's shards
        usages_t = _like([n[None] for n in nu_parts], tpm, axis=1)
        spectra_tpm = _nnls(tpm_t, usages_t,
                            nnls_w_init(tpm_t, n_clusters, "mu", pad_k=Kp),
                            l1_reg=l1, l2_reg=l2, **refit)
    spectra_tpm = spectra_tpm.T                          # (Kp, Gall)
    if normalize_tpm:
        ssum = spectra_tpm.sum(dim=1, keepdim=True)
        spectra_tpm = torch.where(
            ssum > 0, spectra_tpm / torch.where(ssum == 0, 1.0, ssum) * 1e6,
            0.0)

    # z-score OLS grams (cnmf.py:55-125, 957-959): two-pass masked column
    # moments in column blocks; the (k × k) lstsq runs on the host
    mean = sum_shards([t.sum(dim=0) for t in tpm_parts]) / n_cells
    means = broadcast(mean, [t.device for t in tpm_parts])
    var = sum_shards([_masked_col_sumsq_blocked(t, m, mask) for t, m, mask
                      in zip(tpm_parts, means, _real_rows(tpm))]) / n_cells
    inv_std = 1.0 / torch.sqrt(var.clamp(min=1e-12))
    XtX = sum_shards([u.T @ u for u in rf_parts])
    uty = sum_shards([u.T @ t for u, t in zip(rf_parts, tpm_parts)])
    u_sum = sum_shards([u.sum(dim=0) for u in rf_parts])
    XtY = (uty - u_sum[:, None] * mean[None, :]) * inv_std[None, :]
    rf = _like(rf_parts, rf)

    # final usage refit on the std-scaled HVG TPM (cnmf.py:961-975)
    if refit_usage:
        norm_tpm = scaled_hvg_tpm(tpm, hvg_idx, zero_safe_std)
        spectra_rf = (spectra_tpm.index_select(1, hvg_idx)
                      / tpm_std.index_select(0, hvg_idx)[None, :])
        l1, l2 = w_regs(n_hvgs)
        final_usages = _nnls(norm_tpm, spectra_rf.T.contiguous()[None],
                             nnls_w_init(norm_tpm, n_clusters, solver,
                                         pad_k=Kp),
                             l1_reg=l1, l2_reg=l2, **refit)
    else:
        final_usages = rf
    return labels, median_n, rf, spectra_tpm, XtX, XtY, final_usages


def _drain(*tensors):
    """The tensors (or row ``Shards``, gathered first) as host arrays, read
    in ONE device-to-host copy: each is flattened and cast to the first
    floating tensor's dtype (integers here are labels and counts, exact in
    it), concatenated, fetched and split back to its shape and dtype."""
    ts = [gather_shards(t) if isinstance(t, Shards) else t for t in tensors]
    dtype = next(t.dtype for t in ts if t.is_floating_point())
    dev = ts[0].device
    flat = torch.cat([t.reshape(-1).to(dtype).to(dev) for t in ts]).cpu()
    out, at = [], 0
    for t in ts:
        n = t.numel()
        a = flat[at:at + n].reshape(t.shape).numpy()
        out.append(a if t.is_floating_point()
                   else a.astype(np.int64))
        at += n
    return out


def _common_args(tpm_std, hvg_idx, dev, dtype, n_cells, solver, beta, tol,
                 max_iter, alpha_W, l1_ratio, mu_chunk, use_pallas,
                 refit_usage, normalize_tpm, zero_safe_std):
    """(tpm_std, hvg_idx) on the device and the chain's keyword arguments."""
    return (to_device(np.asarray(tpm_std), dev, dtype),
            to_device(np.asarray(hvg_idx, dtype=np.int64), dev),
            dict(solver=solver, beta=float(beta), tol=float(tol),
                 max_iter=int(max_iter), mu_chunk=mu_chunk,
                 use_pallas=use_pallas, n_cells=int(n_cells),
                 n_hvgs=int(len(hvg_idx)), alpha_W=float(alpha_W),
                 l1_ratio=float(l1_ratio), refit_usage=bool(refit_usage),
                 normalize_tpm=bool(normalize_tpm),
                 zero_safe_std=bool(zero_safe_std)))


def _host_results(k, n_cells, median, rf, spectra_tpm, XtX, XtY, final):
    """The drained chain outputs cut to the real sizes, and the OLS
    coefficients from the (k × k) host solve (the step-by-step path's
    lstsq semantics)."""
    usage_coef, *_ = np.linalg.lstsq(
        np.asarray(XtX, dtype=np.float64)[:k, :k],
        np.asarray(XtY, dtype=np.float64)[:k], rcond=None)
    return (median[:k], rf[:n_cells, :k], final[:n_cells, :k],
            spectra_tpm[:k], usage_coef)


def fused_consensus(
    Xnc,
    tpm,
    l2_spectra: np.ndarray,
    k: int,
    tpm_std: np.ndarray,
    hvg_idx: np.ndarray,
    n_cells: int,
    *,
    solver: str = "cd",
    beta: float = 2.0,
    tol: float = 1e-4,
    max_iter: int = 200,
    alpha_W: float = 0.0,
    l1_ratio: float = 0.0,
    mu_chunk: int = 8,
    use_pallas: bool = False,
    refit_usage: bool = True,
    normalize_tpm: bool = False,
    zero_safe_std: bool = True,
    n_init: int = 10,
    random_state: int = 1,
    lloyd_max_iter: int = 300,
    lloyd_tol: float = 1e-4,
    pad_points_to: int = 512,
    pad_clusters_to: int = 8,
):
    """sklearn's greedy kmeans++ seeding on the host from
    ``RandomState(random_state)`` and the shape padding, then the whole
    chain on the device and one drain. Xnc: (cells × HVGs) tensor or row
    ``Shards``; tpm: the (cells × all genes) TPM laid out the same;
    l2_spectra: the density-filtered L2-normalized spectra (host, at Xnc's
    dtype). Returns host arrays cut to the real sizes:

    (labels (R,), median_spectra (k, G), rf_init (n_cells, k),
     rf_final (n_cells, k), spectra_tpm (k, Gall), usage_coef (k, Gall)).
    """
    X = np.ascontiguousarray(l2_spectra)
    R, D = X.shape
    if R < k:
        raise ValueError(f"n_samples={R} should be >= n_clusters={k}")
    rng = np.random.RandomState(random_state)
    centers0 = np.stack([_kmeans_plusplus(X, k, rng) for _ in range(n_init)])
    scaled_tol = lloyd_tol * float(np.mean(np.var(X, axis=0)))
    Rp = -(-R // pad_points_to) * pad_points_to
    Kp = -(-k // pad_clusters_to) * pad_clusters_to
    Xpad = np.zeros((Rp, D), dtype=X.dtype)
    Xpad[:R] = X
    c0 = np.full((n_init, Kp, D), PAD_SENTINEL, dtype=X.dtype)
    c0[:, :k] = centers0
    dev, dtype = Xnc.device, Xnc.dtype
    std_d, hvg_d, common = _common_args(
        tpm_std, hvg_idx, dev, dtype, n_cells, solver, beta, tol, max_iter,
        alpha_W, l1_ratio, mu_chunk, use_pallas, refit_usage, normalize_tpm,
        zero_safe_std)
    labels, median_n, rf, spectra_tpm, XtX, XtY, final = _consensus_chain(
        Xnc, tpm, to_device(Xpad, dev, dtype), to_device(c0, dev, dtype),
        float(np.asarray(scaled_tol, dtype=X.dtype)), R, int(k), std_d,
        hvg_d, n_cluster_pad=Kp, lloyd_max_iter=lloyd_max_iter, **common)
    labels, *rest = _drain(labels, median_n, rf, spectra_tpm, XtX, XtY,
                           final)
    median, rf_init, rf_final, spectra, coef = _host_results(k, n_cells,
                                                             *rest)
    return labels[:R], median, rf_init, rf_final, spectra, coef


def _knn_density_inline(Xp, n_real, n_neighbors):
    """The KNN local density of ``ops.distance`` on padded rows, the body
    the step-by-step path runs, so the two cannot diverge."""
    return _knn_density_body(Xp, n_real, n_neighbors)


def _fused_consensus_full(
    Xnc, tpm,
    l2p,           # (Rp, G) zero-padded L2 spectra, unfiltered — or, with
                   # normalize_rows, the (R, G) raw merged spectra
    density_in,    # (Rp,) cached density values, or None to compute them
    thresh: float,
    n_spectra: int,
    n_neighbors: int,
    key,           # threefry key (2,) on the device
    lloyd_tol: float,  # unscaled: scaled by the filtered rows' variance
    n_clusters: int,
    tpm_std, hvg_idx,
    *,
    n_cluster_pad: int,
    n_init: int,
    n_local_trials: int,
    lloyd_max_iter: int,
    normalize_rows: bool = False,
    r_pad: int = 0,
    **chain,
):
    """Density (or the cached values), filter, survivor pack, tolerance
    scaling and device kmeans++, then the chain
    (cnmf_tpu/ops/consensus_fused.py:471-586), all on the device. Returns
    (density, n_points, *the chain's outputs); n_points is a 0-d tensor."""
    dtype = l2p.dtype
    if normalize_rows:
        l2p = l2_normalize_pad(l2p, r_pad)
    Rp = l2p.shape[0]
    dev = l2p.device
    density = (density_in if density_in is not None else
               _knn_density_inline(l2p, n_spectra, n_neighbors))
    row_real = torch.arange(Rp, device=dev) < n_spectra
    keep = (density < thresh) & row_real
    n_points = keep.sum()
    # surviving rows packed to the front in their order (a stable sort of
    # the drop mask): the host's boolean filter gives the same order
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    Xp = l2p.index_select(0, order)
    w = (torch.arange(Rp, device=dev) < n_points).to(dtype)
    # sklearn scales tol by the mean per-feature variance of the filtered
    # spectra (two-pass, padded rows masked)
    n_safe = n_points.clamp(min=1).to(dtype)
    mean_c = torch.sum(Xp * w[:, None], dim=0) / n_safe
    var_c = torch.sum((Xp - mean_c[None, :]) ** 2 * w[:, None], dim=0) / n_safe
    scaled_tol = (lloyd_tol * torch.mean(var_c)).to(dtype)
    centers0 = seed_kmeanspp_batch(
        Xp, w, n_points, n_clusters, key, n_init=n_init,
        n_cluster_pad=n_cluster_pad, n_local_trials=n_local_trials)
    out = _consensus_chain(Xnc, tpm, Xp, centers0, scaled_tol, n_points,
                           n_clusters, tpm_std, hvg_idx,
                           n_cluster_pad=n_cluster_pad,
                           lloyd_max_iter=lloyd_max_iter, **chain)
    return (density, n_points, *out)


def _nudged_density(cached_density, R: int, np_dtype, density_threshold):
    """The cached f64 density at the compute dtype, with every value whose
    rounding would cross the (rounded) threshold nudged back to the host
    compare's side (cnmf_tpu/ops/consensus_fused.py:643-663): the caller's
    filter is the f64 ``density < threshold``, and the packed labels must
    line up with it. The nudged values are never saved."""
    vals64 = np.asarray(cached_density, dtype=np.float64).ravel()[:R]
    v = vals64.astype(np_dtype)
    if np_dtype != np.float64:
        t_lo = np_dtype.type(density_threshold)
        keep64 = vals64 < float(density_threshold)
        wrong = (v < t_lo) != keep64
        if wrong.any():
            v = v.copy()
            v[wrong & keep64] = np.nextafter(t_lo, np_dtype.type(-np.inf))
            v[wrong & ~keep64] = t_lo
    return v


def fused_consensus_full(
    Xnc,
    tpm,
    l2_spectra,
    k: int,
    tpm_std: np.ndarray,
    hvg_idx: np.ndarray,
    n_cells: int,
    *,
    density_threshold: float,
    n_neighbors: int,
    cached_density: np.ndarray = None,
    solver: str = "cd",
    beta: float = 2.0,
    tol: float = 1e-4,
    max_iter: int = 200,
    alpha_W: float = 0.0,
    l1_ratio: float = 0.0,
    mu_chunk: int = 8,
    use_pallas: bool = False,
    refit_usage: bool = True,
    normalize_tpm: bool = False,
    zero_safe_std: bool = True,
    n_init: int = 10,
    random_state: int = 1,
    lloyd_max_iter: int = 300,
    lloyd_tol: float = 1e-4,
    pad_points_to: int = 512,
    pad_clusters_to: int = 8,
):
    """The whole consensus on the device — density (or the cached values),
    filter, threefry kmeans++ seeding, Lloyd, medians, refits, OLS grams —
    and one drain. Raises the reference's zero-survivors and n_samples
    errors after the drain, from the survivor count. Returns

    ``(density (R,), labels (n_kept,), median_spectra (k, G),
       rf_init (n_cells, k), rf_final (n_cells, k), spectra_tpm (k, Gall),
       usage_coef (k, Gall))``

    where the caller recovers the filter mask as ``density < threshold``.
    ``l2_spectra``: the host L2-normalized spectra (R × HVGs), or the RAW
    merged spectra as a tensor on Xnc's device, normalized and padded on
    the device (no spectra bytes cross the bus)."""
    dev, dtype = Xnc.device, Xnc.dtype
    np_dtype = numpy_dtype(dtype)
    on_device = isinstance(l2_spectra, torch.Tensor)
    R = l2_spectra.shape[0]
    Rp = -(-R // pad_points_to) * pad_points_to
    Kp = -(-k // pad_clusters_to) * pad_clusters_to
    if on_device:
        l2p = l2_spectra.to(dev, dtype)
    else:
        X = np.zeros((Rp, l2_spectra.shape[1]), dtype=np_dtype)
        X[:R] = l2_spectra
        l2p = to_device(X, dev)
    dens_in = None
    if cached_density is not None:
        d = np.zeros(Rp, dtype=np_dtype)
        d[:R] = _nudged_density(cached_density, R, np_dtype,
                                density_threshold)
        dens_in = to_device(d, dev)
    std_d, hvg_d, common = _common_args(
        tpm_std, hvg_idx, dev, dtype, n_cells, solver, beta, tol, max_iter,
        alpha_W, l1_ratio, mu_chunk, use_pallas, refit_usage, normalize_tpm,
        zero_safe_std)
    out = _fused_consensus_full(
        Xnc, tpm, l2p, dens_in, float(np_dtype.type(density_threshold)), R,
        int(n_neighbors), to_device(prng.prng_key(int(random_state)), dev),
        float(np_dtype.type(lloyd_tol)), int(k), std_d, hvg_d,
        n_cluster_pad=Kp, n_init=int(n_init),
        n_local_trials=2 + int(np.log(k)), lloyd_max_iter=lloyd_max_iter,
        normalize_rows=on_device, r_pad=Rp if on_device else 0, **common)
    density, n_points, labels, *rest = _drain(*out)
    n_kept = int(n_points)
    if n_kept == 0:
        raise RuntimeError(
            "Zero components remain after density filtering. "
            "Consider increasing density threshold"
        )
    if n_kept < k:
        raise ValueError(f"n_samples={n_kept} should be >= n_clusters={k}")
    median, rf_init, rf_final, spectra, coef = _host_results(k, n_cells,
                                                             *rest)
    return (density.astype(np.float64)[:R], labels[:n_kept], median,
            rf_init, rf_final, spectra, coef)
