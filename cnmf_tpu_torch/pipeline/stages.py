"""The array work of each pipeline stage, on numpy arrays and tensors.

``cNMF`` (pipeline/cnmf.py) wraps these functions with the run directory's
files; they can also be driven directly on in-memory data:

* ``prepare_arrays``: TPM, Fano HVG selection and unit-variance scaling;
  ``replicate_seeds`` and ``nmf_run_params``: the replicate grid and the
  solver kwargs;
* ``factorize_k``: every restart of one K as one batched solve (CD or MU, as
  the kwargs say), on the device ladder on CUDA (compacted between segments
  under ``CNMF_TPU_COMPACT=1``); ``factorize_grid``: every K of a run,
  their spectra packed on the device and fetched in one copy, handed to a
  write callback per K (or, under ``CNMF_TPU_STAGED=1`` / ``CNMF_TPU_GRID=
  1``, the Ks solved together on a tail-compacted schedule);
* ``combine_arrays``: the per-restart spectra stacked into the merged matrix;
* ``consensus_arrays``: KNN density filter, KMeans, cluster medians, the
  fixed-factor refits and the z-score OLS, dispatched as
  ``cnmf_tpu.pipeline.cnmf.consensus`` dispatches them: with the TPM on the
  device, one chain there (``ops.consensus_fused``), else step by step;
* ``k_stats_dispatch`` / ``k_stats_arrays``: one K's k-stats chain queued
  on the device, and the K-selection table (silhouette and prediction error
  of every K, ``cnmf_tpu.pipeline.cnmf.k_selection_plot``), every K queued
  before any is read.

Numerics follow the JAX package's: on the CPU the restart inits and the
kmeans++ seeding come from host ``np.random.RandomState`` draws, so both
packages start from bit-identical inputs; on a CUDA card (as on the JAX
package's TPU) the random inits are drawn on the device from threefry keys
(``solvers.device_init_enabled``) and consensus seeds its KMeans there
(``solvers.device_kmeanspp_enabled``), the draws ``jax.random`` makes.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from cnmf_tpu_torch.native import densify_csr
from cnmf_tpu_torch.ops.cd_kernels import (
    factors_from_numpy,
    numpy_dtype,
    pad_bucket,
)
from cnmf_tpu_torch.ops.consensus_fused import (
    fused_consensus,
    fused_consensus_full,
    scaled_hvg_tpm,
)
from cnmf_tpu_torch.ops.distance import local_density_from_spectra
from cnmf_tpu_torch.ops.host_fetch import HostFetch
from cnmf_tpu_torch.ops.init import nndsvd_init_batch, random_init_batch
from cnmf_tpu_torch.ops.kmeans import kmeans_fit
from cnmf_tpu_torch.ops.kstats import (
    consensus_k_stats,
    consensus_k_stats_device,
)
from cnmf_tpu_torch.ops.nmf import BLOCK, pack_spectra_true_k
from cnmf_tpu_torch.ops.normalize import (
    csr_column_subset,
    normalize_total,
    scale_unit_variance,
)
from cnmf_tpu_torch.ops.ols import efficient_ols_all_cols
from cnmf_tpu_torch.ops.stats import fano_hvg_stats, mean_var
from cnmf_tpu_torch.parallel.mesh import Shards, pad_to_multiple
from cnmf_tpu_torch.pipeline.solvers import (
    _is_mu,
    _regularization,
    beta_loss_to_float,
    compact_enabled,
    device_init_enabled,
    device_kmeanspp_enabled,
    device_ladder_enabled,
    draw_restart_factors,
    fused_consensus_enabled,
    grid_enabled,
    refit_spectra_transposed,
    refit_usages,
    restart_axis_pays,
    solve_nmf_batch,
    solve_nmf_batch_ladder,
    solve_nmf_batch_sharded,
    solve_nmf_grid,
    solve_nmf_ladder_sharded,
    solve_nmf_staged,
    staged_enabled,
)
from cnmf_tpu_torch.utils.arena import host_arena
from cnmf_tpu_torch.utils.timing import stage_timer, sub_stage_marker

# the consensus / K-selection default density threshold (reference
# cnmf.py:823, 1127-1130)
DEFAULT_DENSITY_THRESHOLD = 0.5


# ----------------------------------------------------------------------
# prepare
# ----------------------------------------------------------------------

@dataclass
class Prepared:
    tpm: object              # (cells × TPM genes) TPM, dense or CSR like the counts
    tpm_mean: np.ndarray     # per-gene TPM mean
    tpm_std: np.ndarray      # per-gene TPM std (ddof 0)
    hvg_idx: np.ndarray      # HVG positions among the counts' columns
    norm: object             # (cells × HVGs) float64 counts scaled to unit variance


def normalize_hvgs(counts, hvg_idx, zero_safe: bool):
    """Counts of the HVG columns, cast to float64 and scaled to unit variance
    without centering (ddof 1). The reference guards zero-std genes only on
    its sparse path (scanpy pp.scale) and divides unguarded when dense
    (reference cnmf.py:537-544): ``zero_safe`` follows the TPM's kind."""
    if sp.issparse(counts):
        sub = csr_column_subset(sp.csr_matrix(counts), np.asarray(hvg_idx))
        norm = scale_unit_variance(sub.astype(np.float64), ddof=1,
                                   zero_safe=zero_safe)
    else:
        # the float64 cast lands in an arena buffer (reused under
        # CNMF_TPU_HOST_ARENA=1) and the scale
        # divides it in place (cnmf_tpu/pipeline/cnmf.py:1000-1011)
        sub = np.asarray(counts)[:, hvg_idx]
        casted = host_arena.take(sub.shape, np.float64)
        np.copyto(casted, sub)
        norm = scale_unit_variance(casted, ddof=1, zero_safe=zero_safe,
                                   inplace=True)
    values = norm.data if sp.issparse(norm) else norm
    if np.isnan(values).any():
        print("Warning NaNs in normalized counts matrix")
    return norm


def check_zero_cells(norm, cell_names: Optional[Sequence[str]] = None):
    """Raise when a cell has zero counts of every HVG (reference
    cnmf.py:548-556): NMF cannot place such a cell."""
    zero_cells = np.ravel(np.asarray(norm.sum(axis=1)) == 0)
    if zero_cells.any():
        names = (np.asarray(cell_names) if cell_names is not None
                 else np.arange(len(zero_cells)).astype(str))
        raise Exception(
            "Error: %d cells have zero counts of overdispersed genes. E.g. %s. "
            "Filter those cells and re-run or adjust the number of "
            "overdispersed genes. Quitting!"
            % (zero_cells.sum(), ", ".join(names[zero_cells][:4]))
        )


def prepare_arrays(counts, num_highvar_genes: int = 2000, *, tpm=None,
                   tpm_cols=None, hvg_idx=None, cell_names=None,
                   tpm_moments=None) -> Prepared:
    """prepare on in-memory counts (cells × genes, dense or CSR): TPM, the
    ``num_highvar_genes`` Fano-overdispersed genes, their scaled counts.

    tpm: a precomputed TPM (cells × its own genes) instead of the counts
    scaled to 1e6 per cell; tpm_cols: the counts' column of each TPM gene
    (-1 where absent), when the TPM's genes are not the counts'; hvg_idx: a
    given HVG list as positions among the counts' columns, kept in its order;
    cell_names: for the zero-HVG-cell error; tpm_moments: the TPM's per-gene
    (mean, variance) at ddof 0, when known, instead of a pass over it. The
    steps record their walls as the ``prepare.tpm``, ``prepare.tpm_stats``
    and ``prepare.norm_counts`` stages (``utils.timing``)."""
    if tpm is None:
        with stage_timer("prepare.tpm"):
            tpm = normalize_total(counts, target_sum=1e6)
    with stage_timer("prepare.tpm_stats"):
        mean, var = mean_var(tpm) if tpm_moments is None else tpm_moments
    with stage_timer("prepare.norm_counts"):
        if hvg_idx is None:
            hvg_stats, _ = fano_hvg_stats(mean, var,
                                          numgenes=num_highvar_genes)
            hvg_idx = np.flatnonzero(hvg_stats["high_var"])
            if tpm_cols is not None:
                hvg_idx = np.asarray(tpm_cols)[hvg_idx]
        hvg_idx = np.asarray(hvg_idx)
        if (hvg_idx < 0).any():
            raise KeyError(f"{int((hvg_idx < 0).sum())} HVGs are missing "
                           "from the counts' genes")
        norm = normalize_hvgs(counts, hvg_idx, zero_safe=sp.issparse(tpm))
        check_zero_cells(norm, cell_names)
    return Prepared(tpm, mean, var ** 0.5, hvg_idx, norm)


def replicate_seeds(ks, n_iter: int, random_state_seed):
    """The replicate grid [(k, iter)] in K-major/iter-minor order and one
    seed per grid row (reference cnmf.py:564-633): the master seed feeds the
    global numpy RNG, so serial and worker-sharded runs draw the same seeds.
    Quirk kept: the seed vector is sized from the PRE-dedup ks length, so
    duplicate ks draw (unused) extra seeds."""
    ks = [ks] if type(ks) is int else ks
    np.random.seed(seed=random_state_seed)
    seeds = np.random.randint(low=1, high=(2**31) - 1, size=len(ks) * n_iter)
    grid = [(k, r) for k in sorted(set(list(ks))) for r in range(n_iter)]
    return grid, seeds[: len(grid)]


def nmf_run_params(beta_loss="frobenius", alpha_usage=0.0, alpha_spectra=0.0,
                   init="random", max_iter=1000) -> dict:
    """The solver kwargs a run persists (reference cnmf.py:618-631)."""
    return dict(
        alpha_W=alpha_usage,
        alpha_H=alpha_spectra,
        l1_ratio=0.0,
        beta_loss=beta_loss,
        # CD is faster than MU but frobenius-only (reference cnmf.py:629-631)
        solver="cd" if beta_loss == "frobenius" else "mu",
        tol=1e-4,
        max_iter=max_iter,
        init=init,
    )


# ----------------------------------------------------------------------
# factorize and combine
# ----------------------------------------------------------------------

def restart_inits(X_host, k: int, seeds, init: str, dtype=None):
    """Per-restart initial factors W0 (B, N, k), Ht0 (B, G, k) on the host:
    one sklearn init per replicate seed (cnmf_tpu/pipeline/cnmf.py:2034-2062).
    X_host: (cells × HVGs) dense array or CSR matrix (the random init needs
    only its mean, nndsvd takes either), so a sparse input is never made
    dense on the host; ``dtype``: of the factors (default X_host's)."""
    dtype = X_host.dtype if dtype is None else dtype
    if init == "random":
        return random_init_batch(X_host, k, seeds, dtype=dtype)
    if init in ("nndsvd", "nndsvda", "nndsvdar"):
        return nndsvd_init_batch(X_host, k, seeds, variant=init, dtype=dtype)
    raise ValueError(f"unsupported init: {init}")


def x_mean_for_init(X_host, dtype) -> float:
    """X's mean, the scalar the device-drawn random init scales by
    (cnmf_tpu/pipeline/cnmf.py:2023-2032): a CSR's stored values cast to
    ``dtype`` and summed in float64 (the cast-then-accumulate order of the
    dense branch, whose X is already at ``dtype``), a dense X's float64
    mean."""
    if sp.issparse(X_host):
        return float(np.sum(X_host.data.astype(dtype), dtype=np.float64)) / (
            X_host.shape[0] * X_host.shape[1])
    return float(np.mean(X_host, dtype=np.float64))


def factorize_k(X_host, Xd: torch.Tensor, k: int, seeds,
                nmf_kwargs: dict, restart_chunk: Optional[int] = None,
                ladder: Optional[bool] = None,
                timings: Optional[dict] = None, mesh=None,
                device_init: Optional[bool] = None,
                x_mean: Optional[float] = None, fetch: bool = True):
    """All restarts of one K, one batched solve per restart chunk on Xd's
    device, K zero-padded to its bucket of 8 (the padded columns start at
    zero and stay there), dispatched as cnmf_tpu/pipeline/cnmf.py:2095-2170.
    Each chunk's inits come from ``restart_factors``:

    * ``device_init`` (None: ``solvers.device_init_enabled`` for Xd's
      device, on a card; random init only): the seeds go to the device and
      each restart's factors are drawn there from its own threefry key —
      no host draw, no padding or upload of the noise. A draw is keyed by
      its restart's seed alone, so any solver below (and any split of the
      restarts over a mesh) starts a restart from the same factors. A
      restart-axis mesh without the ladder keeps the host draw, as the JAX
      package does. ``x_mean``: X's mean for the draw's scale (default
      ``x_mean_for_init(X_host)``).
    * otherwise sklearn-RNG inits on the host (``init`` of the kwargs:
      random or nndsvd*), padded and uploaded.

    X_host: (cells × HVGs) dense array or CSR matrix (the host inits are
    made from it, at Xd's dtype); Xd: the same values as a dense tensor.
    ``ladder``: solve on the device ladder (None:
    ``solvers.device_ladder_enabled``, on for CUDA tensors).
    ``CNMF_TPU_COMPACT=1`` (``solvers.compact_enabled``; CD on one device)
    takes the between-segment compacted solve instead of the ladder or the
    plain solver (cnmf_tpu/pipeline/cnmf.py:2180-2190). ``timings``: a
    dict whose "init" entry gains the seconds the inits took until they lay
    on the device (host draw, padding and upload; or the device draw,
    synchronized) and whose "init_on" entry says where they were drawn
    ("device" or "host"). ``mesh``: a ``parallel.mesh.Mesh`` of more than
    one device: each chunk's restarts are split over its restart groups
    (``solvers.solve_nmf_ladder_sharded`` on a restart axis with the
    ladder, else ``solvers.solve_nmf_batch_sharded``). Returns (spectra
    (B, k, G), n_iter (B,)) as host arrays and the restart-sweeps the device
    executed: the ladder's Σ rung · sweeps at it, the plain solver's
    B · min(max_iter, its sweep blocks) for each batch that ran (a restart
    group's own on a mesh, padding restarts included). ``fetch=False``:
    the spectra stay on the device instead, a list of one (B, pad_k, G)
    tensor a chunk, rows past k zero, with a list of the chunks' n_iter
    tensors (``factorize_grid`` packs them for one copy)."""
    init = nmf_kwargs.get("init", "random")
    seeds = np.asarray(seeds)
    B = len(seeds)
    pad_k = pad_bucket(k)
    dtype = numpy_dtype(Xd.dtype)
    timings = {} if timings is None else timings
    timings.setdefault("init", 0.0)
    if restart_chunk is None:
        # keep the restart batch's solver working set (W, XHt, grads ≈
        # 4 × B×N×K buffers) within ~4 GB of device memory
        per_restart = Xd.shape[0] * pad_k * Xd.element_size() * 4
        restart_chunk = max(1, int(4e9 / max(per_restart, 1)))
    if mesh is not None and mesh.size == 1:
        mesh = None   # one device means no mesh
    compact = compact_enabled() and not _is_mu(nmf_kwargs) and mesh is None
    use_ladder = device_ladder_enabled(Xd, ladder) and not compact
    restart_axis = mesh is not None and mesh.shape["cell"] == 1
    if device_init is None:
        device_init = device_init_enabled(Xd.device)
    device_init = (device_init and init == "random"
                   and not (restart_axis and not use_ladder))
    if device_init and x_mean is None:
        x_mean = x_mean_for_init(X_host, dtype)
    timings["init_on"] = "device" if device_init else "host"
    max_iter = int(nmf_kwargs.get("max_iter", 200))
    laddered = use_ladder and (mesh is None or restart_axis)
    spectra, n_iters, executed = [], [], 0
    for start in range(0, B, restart_chunk):
        W0, Ht0 = restart_factors(X_host, Xd, k,
                                  seeds[start:start + restart_chunk], init,
                                  pad_k, timings, device_init, x_mean,
                                  mesh is None)
        if laddered:
            solve = (solve_nmf_batch_ladder if mesh is None else
                     functools.partial(solve_nmf_ladder_sharded, mesh))
            spec, n_iter, (rungs, sweeps) = solve(Xd, W0, Ht0, nmf_kwargs)
            executed += sum(r * s for r, s in zip(rungs, sweeps))
        elif compact:
            info = {}
            _, Ht, n_iter = solve_nmf_batch(Xd, W0, Ht0, nmf_kwargs,
                                            compact=True, info=info)
            spec = Ht.transpose(1, 2)
            executed += info["executed"]
        else:
            if mesh is None:
                _, Ht, n_iter = solve_nmf_batch(Xd, W0, Ht0, nmf_kwargs)
            else:
                _, Ht, n_iter = solve_nmf_batch_sharded(mesh, Xd, W0, Ht0,
                                                        nmf_kwargs)
            spec = Ht.transpose(1, 2)
            groups = 1 if mesh is None else mesh.shape["restart"]
            executed += _plain_executed(n_iter.cpu().numpy(), groups,
                                        max_iter)
        if not fetch:
            spectra.append(spec)
            n_iters.append(n_iter)
            continue
        spectra.append(spec[:, :k].cpu().numpy())
        n_iters.append(n_iter.cpu().numpy())
    if not fetch:
        return spectra, n_iters, executed
    return np.concatenate(spectra), np.concatenate(n_iters), executed


def restart_factors(X_host, Xd, k: int, seeds, init: str, pad_k: int,
                    timings: dict, device_init: bool = False,
                    x_mean: Optional[float] = None, upload: bool = True):
    """One chunk's initial factors W0 (B, N, pad_k), Ht0 (B, G, pad_k),
    columns past k zero: drawn on Xd's device (``device_init``, from
    ``x_mean``), or made on the host by ``restart_inits``, padded and, with
    ``upload``, put on Xd's device (else left on the host for a mesh to
    place). ``timings["init"]`` gains the seconds until they lie there."""
    if device_init:
        return draw_restart_factors(seeds, x_mean, k, pad_k, Xd.shape[0],
                                    Xd.shape[1], Xd.device, Xd.dtype,
                                    timings)
    t0 = time.perf_counter()
    W0, Ht0 = restart_inits(X_host, k, seeds, init, numpy_dtype(Xd.dtype))
    pad = ((0, 0), (0, 0), (0, pad_k - k))
    W0, Ht0 = np.pad(W0, pad), np.pad(Ht0, pad)
    if upload:
        W0, Ht0 = factors_from_numpy(W0, Ht0, device=Xd.device,
                                     dtype=Xd.dtype)
        if Xd.device.type == "cuda":
            torch.cuda.synchronize(Xd.device)
    timings["init"] += time.perf_counter() - t0
    return W0, Ht0


def _plain_executed(n_iter: np.ndarray, groups: int, max_iter: int) -> int:
    """Restart-sweeps the plain solver ran on ``n_iter``'s restarts split
    over ``groups`` batches (padded with copies of restart 0, as
    ``pad_to_multiple`` pads them): each batch runs whole blocks until its
    slowest restart stops."""
    if not len(n_iter):
        return 0
    per = pad_to_multiple(n_iter, groups)[0].reshape(groups, -1)
    blocks = -(-per.max(axis=1) // BLOCK)
    return int((per.shape[1] * np.minimum(max_iter, BLOCK * blocks)).sum())


def pipeline_all_fits(jobs, n_cells: int, itemsize: int) -> bool:
    """Whether every K's solve may stay on the device until the grid is done
    (cnmf_tpu/pipeline/cnmf.py:1472-1482): the factors of all K together,
    2 · Σ pad_k · B · cells · itemsize bytes, under 2e9. ``jobs``: [(k,
    seeds, iters)]. Else each K is fetched and written before the next."""
    total = sum(pad_bucket(int(k)) * len(seeds) for k, seeds, _ in jobs)
    return 2 * total * n_cells * itemsize < 2e9


def stream_barrier(t: torch.Tensor) -> None:
    """Wait for the work queued on the current stream of ``t``'s device (the
    solves), and nothing else: the phase split's barrier."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


def factorize_grid(X_host, Xd: torch.Tensor, jobs, nmf_kwargs: dict, write,
                   *, restart_chunk: Optional[int] = None, mesh=None,
                   device_init: Optional[bool] = None,
                   x_mean: Optional[float] = None, report=None,
                   phases: Optional[dict] = None, phases_lock=None,
                   twin: bool = False, defer=None) -> dict:
    """Every K of ``jobs`` ([(k, seeds, iters)], each K's restart seeds and
    iteration numbers), dispatched as cnmf_tpu/pipeline/cnmf.py:1463-2021:
    by default ``factorize_k`` on each K, in ascending K.

    Under ``CNMF_TPU_STAGED=1`` or ``CNMF_TPU_GRID=1`` (staged first), where
    the pack below may be made and the solver is CD, every K's inits are
    drawn first and the Ks solve together (``_factorize_merged``): the staged
    schedule (``solvers.solve_nmf_staged``: every K's own segment of 250
    sweeps, then one merged continuation) or the merged
    grid (``solvers.solve_nmf_grid``, one schedule per pad-K bucket); both
    are kept for parity with the JAX package, and on the card neither has
    beaten the per-K ladder on a measured workload (PERF.md). Their
    spectra arrive on the host, so there is no packed copy on the device and
    no twin (``write``'s ``dev`` is None): a same-process consensus and
    k-selection are then fed from the host, as in the JAX package, on the
    same device.

    Where every K's results may stay on the device (``pipeline_all_fits``)
    and neither ``restart_chunk`` nor ``mesh`` splits a solve, the spectra
    stay there until the last K is solved, and then every K's true-K rows
    are packed into one tensor (``ops.nmf.pack_spectra_true_k``), which
    crosses to the host in one copy (``HostFetch``) and is split back per K
    by reshapes. Otherwise each K is fetched as it finishes
    (``factorize_k``'s fetch).

    ``write(k, iters, batch, dev)`` receives each K's host spectra (B, k,
    G) in ``iters``' order, and ``dev`` = (packed tensor, first row, rows)
    locating them in the pack on the device where ``twin``, else None.
    ``defer(entries, packed, fetch)``: given, it takes over the pack
    instead of the drain here (entries [(k, iters, first row, B)]; the
    copy started, not yet waited for). ``mesh``: a ``parallel.mesh.Mesh``,
    taken for the K where ``solvers.restart_axis_pays``. ``report(k, B,
    seconds, timings, mesh_k, n_iter, executed)`` is called after each K's
    solve (the staged and grid schedules: after the schedule, ``seconds``
    its wall, the same for each of its Ks, and ``timings`` the K's own
    draws). ``phases``: a dict whose init_s,
    dispatch_s, solve_wait_s, result_fetch_s, write_s and result_bytes
    entries gain this grid's share (under ``phases_lock`` when given); the
    copy then starts after the barrier that ends solve_wait_s. Returns
    {k: (n_iter (B,), executed restart-sweeps)}."""
    lock = phases_lock or threading.Lock()

    def add(key, value):
        if phases is not None:
            with lock:
                phases[key] += value

    pack_ok = (pipeline_all_fits(jobs, X_host.shape[0], Xd.element_size())
               and restart_chunk is None and mesh is None)
    if pack_ok and not _is_mu(nmf_kwargs):
        schedule = ("staged" if staged_enabled() else
                    "grid" if grid_enabled() else None)
        if schedule is not None:
            return _factorize_merged(schedule, X_host, Xd, jobs, nmf_kwargs,
                                     write, device_init, x_mean, report, add)
    sweeps, solved = {}, []
    for k, seeds, iters in sorted(jobs, key=lambda job: int(job[0])):
        k, seeds, iters = int(k), np.asarray(seeds), np.asarray(iters)
        mesh_k = (mesh if mesh is not None and restart_axis_pays(
            mesh, Xd.shape, len(seeds), k) else None)
        timings = {}
        t0 = time.perf_counter()
        spec, n_iter, executed = factorize_k(
            X_host, Xd, k, seeds, nmf_kwargs,
            restart_chunk=restart_chunk, timings=timings, mesh=mesh_k,
            device_init=device_init, x_mean=x_mean, fetch=not pack_ok)
        seconds = time.perf_counter() - t0
        add("init_s", timings["init"])
        add("dispatch_s", seconds - timings["init"])
        if pack_ok:
            n_iter = torch.cat(n_iter).cpu().numpy()
            solved.append((k, iters, spec[0] if len(spec) == 1
                           else torch.cat(spec)))
        sweeps[k] = (n_iter, executed)
        if report is not None:
            report(k, len(seeds), seconds, timings, mesh_k, n_iter, executed)
        if not pack_ok:
            add("result_bytes", spec.nbytes)
            t0 = time.perf_counter()
            write(k, iters, spec, None)
            add("write_s", time.perf_counter() - t0)
    if not solved:
        return sweeps
    packed = pack_spectra_true_k(tuple(h for _, _, h in solved),
                                 ks=tuple(k for k, _, _ in solved))
    entries, off = [], 0
    for k, iters, h in solved:
        entries.append((k, iters, off, h.shape[0]))
        off += h.shape[0] * k
    if defer is not None:
        defer(entries, packed, HostFetch(packed))
        return sweeps
    t0 = time.perf_counter()
    if phases is not None:
        stream_barrier(packed)
    t1 = time.perf_counter()
    arr = HostFetch(packed).wait()
    t2 = time.perf_counter()
    add("solve_wait_s", t1 - t0)
    add("result_fetch_s", t2 - t1)
    add("result_bytes", arr.nbytes)
    G = arr.shape[1]
    for k, iters, off, B in entries:
        write(k, iters, arr[off:off + B * k].reshape(B, k, G),
              (packed, off, B * k) if twin else None)
    add("write_s", time.perf_counter() - t2)
    return sweeps


def _factorize_merged(schedule, X_host, Xd, jobs, nmf_kwargs, write,
                      device_init, x_mean, report, add) -> dict:
    """``factorize_grid`` on the staged or the merged-grid schedule
    (cnmf_tpu/pipeline/cnmf.py:1771-1918): each K's inits as
    ``factorize_k`` draws them (``restart_factors``), then one
    ``solve_nmf_staged`` over every K, or one ``solve_nmf_grid`` over each
    pad-K bucket's inits concatenated, sliced back per K. init_s gains the
    draws' seconds and solve_wait_s the schedules'; each K's spectra go to
    ``write`` with no twin."""
    init = nmf_kwargs.get("init", "random")
    dtype = numpy_dtype(Xd.dtype)
    if device_init is None:
        device_init = device_init_enabled(Xd.device)
    device_init = device_init and init == "random"
    if device_init and x_mean is None:
        x_mean = x_mean_for_init(X_host, dtype)
    jobs = [(int(k), np.asarray(seeds), np.asarray(iters))
            for k, seeds, iters in sorted(jobs, key=lambda job: int(job[0]))]
    if schedule == "staged":
        groups = [jobs]
    else:
        buckets = {}
        for job in jobs:
            buckets.setdefault(pad_bucket(job[0]), []).append(job)
        groups = [buckets[p] for p in sorted(buckets)]
    sweeps = {}
    for group in groups:
        # one timings dict a K: each K reports its own draws' seconds
        timings = [{"init": 0.0, "init_on": "device" if device_init else
                    "host"} for _ in group]
        t0 = time.perf_counter()
        inits = [restart_factors(X_host, Xd, k, seeds, init, pad_bucket(k),
                                 t, device_init, x_mean)
                 for (k, seeds, _), t in zip(group, timings)]
        t1 = time.perf_counter()
        if schedule == "staged":
            outs = solve_nmf_staged(Xd, inits, nmf_kwargs)
        else:
            spec, n_iter, executed = solve_nmf_grid(
                Xd, torch.cat([w for w, _ in inits]),
                torch.cat([h for _, h in inits]), nmf_kwargs)
            ends = np.cumsum([len(seeds) for _, seeds, _ in group])
            outs = [(spec[e - len(s):e], n_iter[e - len(s):e],
                     executed[e - len(s):e])
                    for (_, s, _), e in zip(group, ends)]
        del inits
        seconds = time.perf_counter() - t1
        add("init_s", t1 - t0)
        add("solve_wait_s", seconds)
        for (k, seeds, iters), (spec, n_iter, executed), t in zip(
                group, outs, timings):
            sweeps[k] = (n_iter, int(executed.sum()))
            if report is not None:
                report(k, len(seeds), seconds, t, None, n_iter, sweeps[k][1])
            batch = np.ascontiguousarray(spec[:, :k])
            add("result_bytes", batch.nbytes)
            t2 = time.perf_counter()
            write(k, iters, batch, None)
            add("write_s", time.perf_counter() - t2)
    return sweeps


def combine_arrays(spectra: Sequence[np.ndarray]) -> np.ndarray:
    """Per-restart (k × G) spectra stacked into the merged (n·k × G) matrix,
    rows ``iter{r}_topic{t}`` in restart order."""
    return np.concatenate([np.asarray(s) for s in spectra], axis=0)


# ----------------------------------------------------------------------
# consensus
# ----------------------------------------------------------------------

@dataclass
class Consensus:
    local_density: np.ndarray   # (R,) mean KNN distance of every spectrum
    density_filter: np.ndarray  # (R,) bool, spectra kept for clustering
    l2_kept: np.ndarray         # kept L2-normalized spectra
    labels: np.ndarray          # (R_kept,) 1-based KMeans cluster labels
    spectra: np.ndarray         # (k × G) median spectra, rows summing to 1
    usages: np.ndarray          # (cells × k) refit usages
    spectra_tpm: np.ndarray     # (k × all genes) TPM-unit spectra
    spectra_score: np.ndarray   # (k × all genes) z-score OLS coefficients


def l2_normalize(merged: np.ndarray) -> np.ndarray:
    norms = np.sqrt((merged ** 2).sum(axis=1))
    return merged / norms[:, None]


def spectra_local_density(merged: np.ndarray, k: int, device, dtype,
                          local_neighborhood_size: float = 0.30) -> np.ndarray:
    """(R,) f64 mean distance of every L2-normalized spectrum of ``merged``
    to its nearest neighbours: what the density filter compares with its
    threshold, computed at ``dtype`` on ``device``."""
    n_neighbors = int(local_neighborhood_size * merged.shape[0] / k)
    l2 = torch.as_tensor(np.ascontiguousarray(l2_normalize(merged)),
                         device=device).to(dtype)
    return local_density_from_spectra(l2, n_neighbors).astype(np.float64)


def tpm_device_limit(device, override=None) -> float:
    """Bytes (of the float32 cells × genes TPM) under which consensus keeps
    the full-gene TPM on ``device``: 0.25 of a CUDA card's memory (the
    resident TPM shares the card with the normalized counts, the densify
    temporaries and the refits' work), 4e9 elsewhere, as the JAX package
    off a TPU (cnmf_tpu/pipeline/cnmf.py:558-585). ``override``: the limit
    to use instead (``cNMF.tpm_device_bytes_limit``)."""
    if override is not None:
        return override
    device = torch.device(device)
    if device.type == "cuda":
        return 0.25 * torch.cuda.get_device_properties(device).total_memory
    return 4e9


def tpm_fits_device(shape, device, override=None) -> bool:
    """Whether a TPM of ``shape`` stays on the device for consensus."""
    return shape[0] * shape[1] * 4 < tpm_device_limit(device, override)


def consensus_arrays(
    merged,
    k: int,
    norm_counts: torch.Tensor,
    tpm,
    tpm_std: np.ndarray,
    hvg_idx: np.ndarray,
    nmf_kwargs: dict,
    density_threshold: float = 0.5,
    local_neighborhood_size: float = 0.30,
    local_density: Optional[np.ndarray] = None,
    refit_usage: bool = True,
    normalize_tpm_spectra: bool = False,
    zero_safe: bool = False,
    timings: Optional[dict] = None,
    device_kmeanspp: Optional[bool] = None,
    fused: Optional[bool] = None,
) -> Consensus:
    """Consensus spectra and usages for one K (reference cnmf.py:823-975).

    merged: (n_iter·k × HVGs) merged spectra, a host array or a tensor (the
    raw spectra on the device, which the one-program path normalizes
    there); norm_counts: (cells × HVGs) tensor, or row ``Shards`` over a
    mesh's devices (``parallel.mesh.put_cells``: the refits, the OLS and
    the final refit's moments then sum over shards, padded rows neutral);
    tpm: the (cells × all genes) TPM, either a tensor (or ``Shards`` of the
    same layout) at the same dtype and device (resident) or a host matrix,
    CSR or dense (over the device limit, ``tpm_fits_device``: the JAX
    package's atlas branches, cnmf_tpu/pipeline/cnmf.py:3288-3569).
    tpm_std: per-gene TPM std; hvg_idx: HVG columns of the TPM.
    ``local_density``: a cached ``spectra_local_density`` vector, used
    instead of computing it. ``zero_safe``: guard zero-std HVGs in the final
    refit (sparse inputs). ``timings``: a dict that gains the seconds of
    each sub-stage (``utils.timing.sub_stage_marker``), each ending in host
    values.

    The dispatch is the JAX package's (cnmf_tpu/pipeline/cnmf.py:
    3245-3316). With the TPM resident and ``fused`` (None:
    ``solvers.fused_consensus_enabled``), the chain runs on the device with
    no host read but its loops' block checks and one drain
    (``ops.consensus_fused``): ``fused_consensus_full`` (density, filter and
    the threefry kmeans++ seeding there too) where ``device_kmeanspp`` (None:
    ``solvers.device_kmeanspp_enabled`` for the device), else the host
    density filter and ``fused_consensus`` (host kmeans++ seeding). On CUDA
    its failure raises; nothing falls back. Otherwise the step-by-step path
    (``_consensus_steps``)."""
    dev = norm_counts.device
    resident = isinstance(tpm, (torch.Tensor, Shards))
    if device_kmeanspp is None:
        device_kmeanspp = device_kmeanspp_enabled(dev) and resident
    if fused is None:
        fused = fused_consensus_enabled()
    mark = sub_stage_marker(timings)
    args = (k, norm_counts, tpm, tpm_std, hvg_idx, nmf_kwargs,
            density_threshold, local_neighborhood_size, local_density,
            refit_usage, normalize_tpm_spectra, zero_safe, device_kmeanspp,
            mark)
    if fused and resident:
        return _consensus_fused(merged, *args)
    if isinstance(merged, torch.Tensor):
        merged = merged.cpu().numpy()
    return _consensus_steps(merged, *args)


def _host_density_filter(merged, k, dev, dtype, local_neighborhood_size,
                         local_density, density_threshold):
    """(local density, filter mask, kept L2 spectra) on the host; raises
    when no spectrum survives."""
    if local_density is None:
        local_density = spectra_local_density(merged, k, dev, dtype,
                                              local_neighborhood_size)
    density_filter = local_density < density_threshold
    l2_kept = l2_normalize(merged)[density_filter]
    if l2_kept.shape[0] == 0:
        raise RuntimeError(
            "Zero components remain after density filtering. "
            "Consider increasing density threshold"
        )
    return local_density, density_filter, l2_kept


def _consensus_fused(merged, k, norm_counts, tpm, tpm_std, hvg_idx,
                     nmf_kwargs, density_threshold, local_neighborhood_size,
                     local_density, refit_usage, normalize_tpm_spectra,
                     zero_safe, full, mark) -> Consensus:
    """The one-program consensus (``ops.consensus_fused``), its artifacts
    as the step-by-step path returns them."""
    dev, dtype = norm_counts.device, norm_counts.dtype
    np_dtype = numpy_dtype(dtype)
    host_merged = (merged.cpu().numpy() if isinstance(merged, torch.Tensor)
                   else np.asarray(merged))
    common = dict(
        solver=nmf_kwargs.get("solver", "cd"),
        beta=beta_loss_to_float(nmf_kwargs.get("beta_loss", "frobenius")),
        tol=float(nmf_kwargs.get("tol", 1e-4)),
        max_iter=int(nmf_kwargs.get("max_iter", 200)),
        alpha_W=float(nmf_kwargs.get("alpha_W", 0.0)),
        l1_ratio=float(nmf_kwargs.get("l1_ratio", 0.0)),
        refit_usage=refit_usage, normalize_tpm=normalize_tpm_spectra,
        zero_safe_std=zero_safe,
    )
    n_cells = norm_counts.shape[0]
    if full:
        spectra_in = (merged if isinstance(merged, torch.Tensor) else
                      np.ascontiguousarray(l2_normalize(host_merged),
                                           dtype=np_dtype))
        (density, labels, median, rf_init, rf_final, spectra_tpm,
         coef) = fused_consensus_full(
            norm_counts, tpm, spectra_in, k, tpm_std, hvg_idx, n_cells,
            density_threshold=density_threshold,
            n_neighbors=int(local_neighborhood_size * host_merged.shape[0]
                            / k),
            cached_density=local_density, **common)
        if local_density is None:
            local_density = density
        density_filter = local_density < density_threshold
        l2_kept = l2_normalize(host_merged)[density_filter]
    else:
        local_density, density_filter, l2_kept = _host_density_filter(
            host_merged, k, dev, dtype, local_neighborhood_size,
            local_density, density_threshold)
        mark("density")
        labels, median, rf_init, rf_final, spectra_tpm, coef = \
            fused_consensus(norm_counts, tpm,
                            np.ascontiguousarray(l2_kept, dtype=np_dtype), k,
                            tpm_std, hvg_idx, n_cells, **common)
    mark("fused_consensus")
    return Consensus(local_density, density_filter, l2_kept, labels + 1,
                     median, rf_final if refit_usage else rf_init,
                     spectra_tpm, coef)


def _consensus_steps(merged, k, norm_counts, tpm, tpm_std, hvg_idx,
                     nmf_kwargs, density_threshold, local_neighborhood_size,
                     local_density, refit_usage, normalize_tpm_spectra,
                     zero_safe, device_kmeanspp, mark) -> Consensus:
    """The step-by-step consensus, each phase ending in host values. A host
    CSR TPM never goes dense: with the CD solver the spectra refit and the
    final usage refit take host-SpMM products and the products-given kernel,
    and the OLS a host SpMM; the MU spectra refit, or any refit of a dense
    host TPM, goes in gene chunks of 2e9 / (cells · 4) genes.
    ``device_kmeanspp``: seed the KMeans on the device from the threefry
    key of random_state 1 (``ops.kmeans.seed_kmeanspp_batch``)."""
    dev, dtype = norm_counts.device, norm_counts.dtype
    np_dtype = numpy_dtype(dtype)
    resident = isinstance(tpm, (torch.Tensor, Shards))

    def to_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    local_density, density_filter, l2_kept = _host_density_filter(
        merged, k, dev, dtype, local_neighborhood_size, local_density,
        density_threshold)
    mark("density")

    labels, _, _ = kmeans_fit(to_dev(l2_kept), n_clusters=k, n_init=10,
                              random_state=1, device_seeding=device_kmeanspp)
    labels = labels + 1
    # per-cluster median spectra, renormalized to row-sum 1
    median = np.stack([np.median(l2_kept[labels == c], axis=0)
                       for c in np.unique(labels)])
    median = median / median.sum(axis=1, keepdims=True)
    mark("kmeans")

    usages = refit_usages(norm_counts, median, nmf_kwargs)
    # re-order programs by total contribution (reference cnmf.py:938-946)
    norm_usages = usages / usages.sum(axis=1, keepdims=True)
    order = np.argsort(-norm_usages.sum(axis=0), kind="stable")
    usages, norm_usages, median = usages[:, order], norm_usages[:, order], median[order]
    mark("refit_usages")

    on = dict(device=dev, dtype=dtype)
    if resident or (sp.issparse(tpm) and nmf_kwargs.get("solver", "cd") == "cd"):
        # the usage gram and one XᵀU product (device matmul or host SpMM)
        spectra_tpm = refit_spectra_transposed(tpm, norm_usages, nmf_kwargs,
                                               **on).T
    else:
        # the fixed-usage NNLS decomposes per gene: solve in gene chunks,
        # only a chunk × cells tile dense at a time. The relative stopping
        # tolerance applies per chunk, not to the joint solve; each chunk
        # converges to the same NNLS optimum
        usage_t = np.ascontiguousarray(norm_usages.T, dtype=np_dtype)
        gene_chunk = max(1, int(2e9 / max(tpm.shape[0] * 4, 1)))
        cols = tpm.tocsc() if sp.issparse(tpm) else np.asarray(tpm)
        parts = []
        for g0 in range(0, tpm.shape[1], gene_chunk):
            block_t = cols[:, g0:g0 + gene_chunk].T   # (genes × cells)
            parts.append(refit_usages(
                np.ascontiguousarray(densify_csr(block_t, out_dtype=np_dtype)),
                usage_t, nmf_kwargs, **on))
        spectra_tpm = np.concatenate(parts, axis=0).T
    if normalize_tpm_spectra:
        spectra_tpm = spectra_tpm / spectra_tpm.sum(axis=1, keepdims=True) * 1e6
    mark("refit_spectra_tpm")
    # z-score spectra: OLS of the z-scored TPM on the usages (cnmf.py:957-959)
    spectra_score = efficient_ols_all_cols(usages, tpm, normalize_y=True,
                                           **on)
    mark("ols")

    if refit_usage:
        # final usage refit on the std-scaled HVG TPM (reference cnmf.py:961-975)
        spectra_tpm_rf = spectra_tpm[:, hvg_idx] / tpm_std[hvg_idx][None, :]
        if resident:
            hvg = torch.as_tensor(np.asarray(hvg_idx, dtype=np.int64),
                                  device=dev)
            usages = refit_usages(scaled_hvg_tpm(tpm, hvg, zero_safe),
                                  spectra_tpm_rf, nmf_kwargs)
        else:
            tpm_hvg = (csr_column_subset(tpm.tocsr(), np.asarray(hvg_idx))
                       if sp.issparse(tpm) else np.asarray(tpm)[:, hvg_idx])
            if zero_safe:
                norm_tpm = scale_unit_variance(tpm_hvg, ddof=1, zero_safe=True)
            else:
                norm_tpm = scale_unit_variance(
                    densify_csr(tpm_hvg, out_dtype=np.float64), ddof=1,
                    zero_safe=False)
            # a sparse HVG TPM takes the products route (CD) or a native
            # densify (MU) inside the refit
            usages = refit_usages(norm_tpm, spectra_tpm_rf, nmf_kwargs, **on)
    mark("final_refit")

    return Consensus(local_density, density_filter, l2_kept, labels, median,
                     usages, spectra_tpm, spectra_score)


# ----------------------------------------------------------------------
# K selection
# ----------------------------------------------------------------------

def k_stats_dispatch(k: int, spectra, norm_counts, nmf_kwargs: dict):
    """Queue one K's k-stats chain (``ops.kstats``) with the run's solver,
    beta, tolerance, iteration limit and W regularization; returns the 0-d
    tensors (silhouette, prediction error), not yet read. spectra: the
    merged (n_iter·K × HVGs) spectra, a host array (L2-normalized and seeded
    on the host, ``consensus_k_stats``) or a tensor of the raw spectra
    (normalized and seeded on the device, ``consensus_k_stats_device``).
    norm_counts: (cells × HVGs) tensor on the solve's device, or row
    ``Shards`` (the refit and the error sum over shards)."""
    l1_reg_W, _, l2_reg_W, _ = _regularization(nmf_kwargs,
                                               tuple(norm_counts.shape))
    kw = dict(
        solver=nmf_kwargs.get("solver", "cd"),
        beta=beta_loss_to_float(nmf_kwargs.get("beta_loss", "frobenius")),
        refit_tol=float(nmf_kwargs.get("tol", 1e-4)),
        refit_max_iter=int(nmf_kwargs.get("max_iter", 200)),
        l1_reg_W=l1_reg_W, l2_reg_W=l2_reg_W,
    )
    if isinstance(spectra, torch.Tensor):
        return consensus_k_stats_device(
            norm_counts, spectra.to(norm_counts.device, norm_counts.dtype),
            int(k), **kw)
    l2 = np.ascontiguousarray(l2_normalize(np.asarray(spectra)),
                              dtype=numpy_dtype(norm_counts.dtype))
    return consensus_k_stats(norm_counts, l2, int(k), **kw)


def k_stats_arrays(merged_by_k: dict, norm_counts, nmf_kwargs: dict) -> list:
    """The K-selection table (reference cnmf.py:1119-1135): for each K of
    ``merged_by_k`` ({K: merged (n_iter·K × HVGs) spectra, host arrays or
    raw tensors}), in increasing order, the row (K, density threshold 0.5,
    silhouette, prediction error) of ``k_stats_dispatch``. Every K is
    queued before any result is read (cnmf_tpu/pipeline/cnmf.py:
    3732-3778)."""
    pending = [(int(k), *k_stats_dispatch(k, merged_by_k[k], norm_counts,
                                          nmf_kwargs))
               for k in sorted(merged_by_k)]
    return [(k, DEFAULT_DENSITY_THRESHOLD, float(sil), float(sse))
            for k, sil, sse in pending]
