"""The cNMF pipeline over a run directory, in PyTorch.

The five stages of ``cnmf_tpu.pipeline.cnmf.cNMF`` — prepare, factorize,
combine, consensus at one K and k_selection_plot — with the same on-disk
artifact contract
(pipeline/paths.py, reference cnmf.py:298-330): a run directory written by
either package is read by the other. The methods here are file wrappers;
the array work lives in ``pipeline.stages``.

Every solve runs on the ``device`` the object was created with, the CUDA
card unless the CPU is asked for. On CUDA the
HALS half-sweeps and the multiplicative-update terms go through the
hand-written kernels of ``ops.cd_kernels`` and ``ops.mu_kernels``, which take
float32 only: ``compute_dtype=np.float64`` is a CPU setting. There
factorize runs the device ladder (``CNMF_TPU_DEVICE_LADDER=0`` turns it
off; ``pipeline.solvers``).

Sparse (CSR) counts never get a dense host copy on the CD path: a matrix
goes to the device through ``ops.device_densify.to_device_dense`` (the CSR
components expanded on the card when that is eligible, else the native host
densify and one upload), the inits read the CSR, and consensus keeps the
full-gene TPM on the device only under ``stages.tpm_device_limit`` (or
``tpm_device_bytes_limit``); above it the refits and the OLS take host-SpMM
products (``stages.consensus_arrays``). The stages record their walls
(``utils.timing``: ``timings()``, ``CNMF_TPU_TIMINGS=1``,
``CNMF_TPU_PROFILE_DIR``).
Artifacts are written synchronously, so ``flush_writes`` has nothing to do.

With more than one local device of the object's type (``parallel.mesh.
local_devices``), factorize lays its cells (under ``CNMF_TPU_CELL_AXIS``)
over a mesh of them, or its restarts where that is faster than one device
(``solvers.restart_axis_pays``), and consensus and k-selection upload the
cell axis split over every device (``shard_cells``), as the JAX package
does over ``jax.devices()``.
"""

from __future__ import annotations

import datetime
import errno
import os
import shutil
import sys
import threading
import time
import uuid
import warnings
import weakref

import numpy as np
import pandas as pd
import scipy.sparse as sp
import torch
import yaml

from cnmf_tpu_torch.io.anndata_lite import AnnData
from cnmf_tpu_torch.io.dataframe import (
    check_dir_exists,
    load_df_from_npz,
    save_df_to_npz,
    save_df_to_text,
)
from cnmf_tpu_torch.io.h5ad import (
    read_h5ad,
    read_h5ad_shape,
    read_h5ad_x_is_sparse,
    write_h5ad,
)
from cnmf_tpu_torch.io.loaders import load_counts
from cnmf_tpu_torch.ops.cd_kernels import (
    factors_from_numpy,
    pad_bucket,
    torch_dtype,
)
from cnmf_tpu_torch.ops import device_tpm
from cnmf_tpu_torch.ops.device_densify import to_device_dense
from cnmf_tpu_torch.ops.distance import pairwise_euclidean
from cnmf_tpu_torch.parallel import mesh as parallel_mesh
from cnmf_tpu_torch.pipeline import solvers, stages
from cnmf_tpu_torch.pipeline.paths import build_paths
from cnmf_tpu_torch.utils.timing import stage_timer, timed, timings_verbose

DEFAULT_DENSITY_THRESHOLD = stages.DEFAULT_DENSITY_THRESHOLD

# row schema of the k_selection table (reference cnmf.py:932-934)
K_STATS_FIELDS = ["k", "local_density_threshold", "silhouette", "prediction_error"]

# the h5ad read cache is filled from the TPM prefetch thread too
_H5AD_LOCK = threading.Lock()


def worker_filter(iterable, worker_index, total_workers):
    """Round-robin shard: element i goes to worker i % total_workers
    (reference cnmf.py:52-53)."""
    return (p for i, p in enumerate(iterable)
            if (i - worker_index) % total_workers == 0)


class cNMF:
    """Consensus NMF over a restarts × K grid, batched on one device.

    Parameters
    ----------
    output_dir : str — analysis output root (default ".").
    name : str — run name, prefixed to every file; auto-generated
        ``YYYY_MM_DD_<6-hex>`` when None (reference cnmf.py:268-288).
    compute_dtype : numpy dtype of the solves (default float32). float64
        gives exact sklearn parity and runs on the CPU only: the CUDA
        kernels are float32.
    device : the torch device every solve runs on (default "cuda"). There
        is no fallback: without a CUDA device the first solve raises unless
        ``device="cpu"`` was asked for.

    ``tpm_device_bytes_limit``: set on the object to override
    ``stages.tpm_device_limit`` (bytes of the float32 TPM kept on the
    device in consensus; 1 forces the host-TPM branch).
    ``shard_cells``: with several local devices, consensus and k-selection
    upload the normalized counts and the TPM with the cell axis split over
    all of them (``_put_cells``); set it False on the object for one
    device's uploads.
    """

    tpm_device_bytes_limit = None
    shard_cells = True

    def __init__(self, output_dir=".", name=None, compute_dtype=np.float32,
                 *, device="cuda"):
        self.output_dir = output_dir
        if name is None:
            now = datetime.datetime.now()
            name = "%s_%s" % (now.strftime("%Y_%m_%d"), uuid.uuid4().hex[:6])
        self.name = name
        self.compute_dtype = np.dtype(compute_dtype)
        self.device = torch.device(device)
        self.paths = None
        self._initialize_dirs()

    def _initialize_dirs(self):
        if self.paths is None:
            check_dir_exists(self.output_dir)
            check_dir_exists(os.path.join(self.output_dir, self.name))
            check_dir_exists(os.path.join(self.output_dir, self.name, "cnmf_tmp"))
            self.paths = build_paths(self.output_dir, self.name)

    def _mesh_devices(self):
        """The local devices (``parallel.mesh.local_devices``) when there
        are several and they are of the object's device type, else None:
        one device means no mesh, as in the JAX package."""
        devices = parallel_mesh.local_devices()
        if len(devices) > 1 and all(torch.device(d).type == self.device.type
                                    for d in devices):
            return devices
        return None

    def _cell_devices(self):
        """The devices consensus splits the cell axis over, or None."""
        return self._mesh_devices() if self.shard_cells else None

    def _put_cells(self, X):
        """A (cells × features) host matrix, dense or CSR, as a dense tensor
        at the compute dtype, its cell axis split over every local device
        (``_cell_devices``; zero-padded to even shards, the layout of
        ``parallel.mesh.put_cells``, as ``parallel.mesh.Shards``): each
        shard's rows reach their own device by ``to_device_dense`` (a CSR
        input's components expanded on the card where
        ``device_densify_eligible``, else the native host densify and one
        upload, ops/device_densify.py). The consensus refits, the z-score OLS
        and the k-stats then sum their cell reductions over shards. With
        one device, or ``self.shard_cells = False``, one upload to
        ``device``."""
        devices = self._cell_devices()
        if devices is None:
            return to_device_dense(X, self.compute_dtype, self.device)
        n = X.shape[0]
        parts = []
        for (start, stop, rows), dev in zip(
                parallel_mesh.shard_bounds(n, len(devices)), devices):
            part = to_device_dense(X[start:stop], self.compute_dtype, dev)
            if stop - start < rows:
                part = torch.cat([part, part.new_zeros(
                    (rows - (stop - start), part.shape[1]))])
            parts.append(part)
        return parallel_mesh.Shards(parts, n)

    def _solve_inputs(self, X):
        """(the inits' host source, the dense device tensor) of a (cells ×
        features) matrix: a CSR input stays CSR on the host (the inits take
        either), a dense one is cast to the compute dtype once for both."""
        if sp.issparse(X):
            return X, to_device_dense(X, self.compute_dtype, self.device)
        X_host = np.ascontiguousarray(X, dtype=self.compute_dtype)
        return X_host, torch.as_tensor(X_host, device=self.device)

    def _device_cached(self, attr: str, key_obj, build):
        """Single-entry device-buffer cache keyed by a weakref to the host
        object it was built from (a weakref never aliases a recycled
        ``id()``); ``clear_device_caches`` drops it."""
        cached = getattr(self, attr, None)
        if cached is not None and cached[0]() is key_obj:
            return cached[1]
        value = build()
        setattr(self, attr, (weakref.ref(key_obj), value))
        return value

    def _read_h5ad_cached(self, path):
        """``read_h5ad`` behind a cache of one object per path, valid while
        the file's mtime is unchanged: prepare seeds it with the objects it
        writes (``_seed_h5ad``), so a same-process factorize and consensus
        read them back as those very objects, the keys of the compact-counts
        stashes and the device caches. Safe from the prefetch thread."""
        with _H5AD_LOCK:
            cache = self.__dict__.setdefault("_h5ad_cache", {})
            mtime = os.path.getmtime(path)
            hit = cache.get(path)
            if hit is not None and hit[0] == mtime:
                return hit[1]
        adata = read_h5ad(path)
        with _H5AD_LOCK:
            cache[path] = (mtime, adata)
        return adata

    def _seed_h5ad(self, path, adata):
        """Put the object just written to ``path`` in the read cache, as a
        read would return it (string indices), when its X is dense (a
        sparse X is read back with other index arrays); returns the cached
        object, or None."""
        if sp.issparse(adata.X):
            return None
        obs, var = adata.obs.copy(), adata.var.copy()
        obs.index, var.index = obs.index.astype(str), var.index.astype(str)
        seeded = AnnData(adata.X, obs=obs, var=var)
        with _H5AD_LOCK:
            self.__dict__.setdefault("_h5ad_cache", {})[path] = (
                os.path.getmtime(path), seeded)
        return seeded

    def clear_device_caches(self, host_caches: bool = False):
        """Drop the cached device buffers (the normalized counts, the TPM and
        the integer counts image) after joining a TPM prefetch in flight,
        then empty PyTorch's caching allocator on CUDA. ``host_caches``:
        drop the h5ad read cache too (kept by default: every hit is
        mtime-checked, and dropping it breaks the compact-counts stashes'
        object keys)."""
        self._join_tpm_prefetch()
        attrs = ["_norm_counts_dev_cache", "_tpm_dev_cache", "_ints_dev"]
        if host_caches:
            attrs.append("_h5ad_cache")
        for attr in attrs:
            self.__dict__.pop(attr, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # the compact integer TPM (ops/device_tpm.py)
    # ------------------------------------------------------------------

    def _stash_tpm_compact(self, tpm_adata, counts_X):
        """Keep a compact image of the TPM (the integer counts and the
        per-cell scale, ``ops.device_tpm``) for a same-process factorize to
        warm the consensus device TPM with a 2-4× smaller upload. Keyed by
        a weakref to the object the TPM path's ``_read_h5ad_cached``
        returns, so the device TPM is used only while nothing rewrote the
        file (cnmf_tpu/pipeline/cnmf.py:606-634). ``CNMF_TPU_DEVICE_TPM=0``
        disables it. The CSR components of the image are built here, off
        factorize's path, where ``csr_upload_enabled``."""
        if tpm_adata is None or not solvers.device_tpm_enabled():
            return
        ints = device_tpm.compact_integer_counts(counts_X)
        if ints is None:
            return
        scale = device_tpm.tpm_row_scale(counts_X).astype(self.compute_dtype)
        self._tpm_compact = (weakref.ref(tpm_adata), ints, scale)
        self._ints_csr = ((ints, device_tpm.int_image_csr(ints))
                          if device_tpm.csr_upload_enabled(self.device)
                          else None)

    def _stash_norm_compact(self, norm_adata, counts_var_index):
        """Keep (cols, std) so that factorize derives its input on the
        device from the integer counts of the TPM stash
        (``ops.device_tpm.norm_from_counts``), keyed like it to the
        normalized counts' read-back object (cnmf_tpu/pipeline/cnmf.py:
        636-657); degenerate genes keep the float upload."""
        tstash = getattr(self, "_tpm_compact", None)
        if tstash is None or norm_adata is None:
            return
        spec = device_tpm.norm_column_spec(
            counts_var_index, norm_adata.var.index, tstash[1],
            self.compute_dtype)
        if spec is not None:
            self._norm_compact = (weakref.ref(norm_adata), tstash[1], *spec)

    def _tpm_limit(self) -> float:
        return stages.tpm_device_limit(self.device,
                                       self.tpm_device_bytes_limit)

    def _compact_tpm_target(self):
        """(the TPM read-back object, integer image, scale) of a live TPM
        stash at the compute dtype whose derived TPM fits half the device
        limit (it lives beside factorize's working set), else None."""
        stash = getattr(self, "_tpm_compact", None)
        if stash is None:
            return None
        ref, ints, scale = stash
        target = ref()
        derived = ints.shape[0] * ints.shape[1] * self.compute_dtype.itemsize
        if (target is None or scale.dtype != self.compute_dtype
                or derived >= 0.5 * self._tpm_limit()):
            return None
        return target, ints, scale

    def _fused_tpm_derive_target(self):
        """(tpm read-back object, scale) when factorize should derive the
        consensus device TPM beside its own input from the one integer
        image (``device_tpm.derive_norm_and_tpm``), else (None, None):
        the prefetch on, a live stash (``_compact_tpm_target``), and one
        device (the cell-sharded layout takes the prefetch's sharded put)
        (cnmf_tpu/pipeline/cnmf.py:659-684)."""
        live = self._compact_tpm_target()
        if (not solvers.prefetch_tpm_enabled() or live is None
                or self._cell_devices() is not None):
            return None, None
        return live[0], live[2]

    def _prefetch_tpm_async(self):
        """Start the consensus TPM's upload while factorize runs
        (cnmf_tpu/pipeline/cnmf.py:686-857): on a side CUDA stream from a
        host thread (``device_tpm.SideStreamTask``), joined by consensus
        (``_join_tpm_prefetch``), which then finds it in its device cache.
        With prepare's compact stash, the integer image is uploaded (reusing
        factorize's copy when it derived its input from it, or laid over the
        cell devices) and expanded (``device_tpm.prefetch``); else the TPM
        file is read on the thread and uploaded when it fits half the device
        limit. ``CNMF_TPU_PREFETCH_TPM=0`` disables it."""
        if not solvers.prefetch_tpm_enabled():
            return
        pending = getattr(self, "_tpm_prefetch", None)
        if pending is not None and not pending[1].done():
            return
        live = self._compact_tpm_target()
        if live is not None:
            target, ints, scale = live
            cached = getattr(self, "_tpm_dev_cache", None)
            if cached is not None and cached[0]() is target:
                return     # factorize derived it already
            devices = self._cell_devices()
            held = getattr(self, "_ints_dev", None)
            stashed_csr = getattr(self, "_ints_csr", None)
            task = device_tpm.prefetch(
                ints, scale, self.device,
                csr=(stashed_csr[1] if stashed_csr is not None
                     and stashed_csr[0] is ints else device_tpm._COMPUTE_CSR),
                devices=devices,
                ints_dev=(held[1] if devices is None and held is not None
                          and held[0] is ints else None))
            self._tpm_prefetch = (weakref.ref(target), task)
            return
        tpm_path = self.paths["tpm"]
        if not os.path.isfile(tpm_path):
            return
        n, g = read_h5ad_shape(tpm_path)
        upload = n * g * self.compute_dtype.itemsize < 0.5 * self._tpm_limit()

        def read_and_put():
            tpm = self._read_h5ad_cached(tpm_path)
            return tpm, (self._put_cells(tpm.X) if upload else None)

        task = device_tpm.SideStreamTask(read_and_put, self.device)
        self._tpm_prefetch = (None, task)

    def _join_tpm_prefetch(self):
        """Wait for a TPM prefetch in flight and seed the consensus device
        TPM cache with its result; a failed prefetch raises here."""
        pending = self.__dict__.pop("_tpm_prefetch", None)
        if pending is None:
            return
        ref, task = pending
        result = task.join()
        if ref is None:
            target, tpm_dev = result
        else:
            target, (tpm_dev, _) = ref(), result
        if target is not None and tpm_dev is not None:
            self._tpm_dev_cache = (weakref.ref(target), tpm_dev)

    def warmup(self, components=None, verbose=True, parallel=4):
        """Build what the port compiles before its first solve, and time it:
        the native host library (``native``, g++) and, on a CUDA device, the
        kernel library (``ops.kernel_lib.load_library``: every ``csrc/``
        source compiled by its own ``nvcc`` at once, then linked), the
        port's cold start. Nothing executes. ``components`` and ``parallel``
        are accepted for the JAX package's API (cnmf_tpu/pipeline/cnmf.py:
        2274): one library serves every K, and its sources always compile
        together.

        When the run is prepared, ``verbose`` also prints, from the files'
        headers (no data read), the normalized counts' and the TPM's shapes
        and whether consensus will keep the TPM on the device.

        Returns ``{label: build seconds}`` (-1.0: the native library could
        not be built and the scipy/numpy fallbacks run)."""
        from cnmf_tpu_torch import native
        from cnmf_tpu_torch.ops.kernel_lib import load_library

        done = {}
        t0 = time.perf_counter()
        done["native_library"] = (round(time.perf_counter() - t0, 2)
                                  if native.library_loaded() else -1.0)
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            load_library()
            done["kernel_library"] = round(time.perf_counter() - t0, 2)
        if verbose:
            for label, sec in done.items():
                print(f"warmup: {label} " + (f"built in {sec:.2f}s" if sec >= 0
                                             else "unavailable (scipy fallback)"))
        norm_fn, tpm_fn = self.paths["normalized_counts"], self.paths["tpm"]
        if verbose and os.path.exists(norm_fn) and os.path.exists(tpm_fn):
            n_cells, n_hvgs = read_h5ad_shape(norm_fn)
            tpm_shape = read_h5ad_shape(tpm_fn)
            tpm_kind = "CSR" if read_h5ad_x_is_sparse(tpm_fn) else "dense"
            resident = stages.tpm_fits_device(tpm_shape, self.device,
                                              self.tpm_device_bytes_limit)
            print(f"warmup: normalized counts {n_cells} x {n_hvgs}; "
                  f"{tpm_kind} TPM {tpm_shape[0]} x {tpm_shape[1]} "
                  + ("kept on the device" if resident else
                     "kept on the host (over the device limit)")
                  + " in consensus")
        return done

    def _load_run_params(self) -> dict:
        with open(self.paths["nmf_run_parameters"]) as fh:
            return yaml.safe_load(fh)

    def flush_writes(self):
        """No-op: every artifact is written before its stage returns (kept
        for API compatibility with ``cnmf_tpu``)."""

    # ==================================================================
    # prepare
    # ==================================================================

    @timed("prepare")
    def prepare(
        self,
        counts_fn,
        components,
        n_iter=100,
        densify=False,
        tpm_fn=None,
        seed=None,
        beta_loss="frobenius",
        num_highvar_genes=2000,
        genes_file=None,
        alpha_usage=0.0,
        alpha_spectra=0.0,
        init="random",
        max_NMF_iter=1000,
    ):
        """Load counts, select/normalize HVGs, and lay out the replicate grid.

        Produces the same six artifacts as the reference (cnmf.py:333-459):
        tpm + tpm_stats, norm_counts, the HVG list, the replicate-parameter
        table and the YAML solver kwargs."""
        with stage_timer("prepare.load_counts"):
            input_counts = load_counts(counts_fn, densify=densify)
        # a prior run's compact stashes must never leak into this one
        self._tpm_compact = self._norm_compact = self._ints_csr = None
        tpm = None  # computed from the counts by stages.prepare_arrays
        if tpm_fn is not None and tpm_fn.endswith(".h5ad"):
            shutil.copy(tpm_fn, self.paths["tpm"])
            tpm = read_h5ad(self.paths["tpm"])
        elif tpm_fn is not None:
            tpm = load_counts(tpm_fn, densify=densify)
            with stage_timer("prepare.write_tpm"):
                write_h5ad(self.paths["tpm"], tpm)

        if genes_file is not None:
            with open(genes_file) as fh:
                highvargenes = fh.read().rstrip().split("\n")
        else:
            highvargenes = None

        prep, norm_counts = self._prepare(input_counts, tpm, highvargenes,
                                          num_highvar_genes)
        if tpm is None:
            tpm = AnnData(prep.tpm, obs=input_counts.obs.copy(),
                          var=input_counts.var.copy())
            with stage_timer("prepare.write_tpm"):
                write_h5ad(self.paths["tpm"], tpm)
            with stage_timer("prepare.stash_tpm"):
                self._stash_tpm_compact(self._seed_h5ad(self.paths["tpm"], tpm),
                                        input_counts.X)
        input_tpm_stats = pd.DataFrame(
            [prep.tpm_mean, prep.tpm_std],
            index=["__mean", "__std"],
            columns=tpm.var.index,
        ).T
        save_df_to_npz(input_tpm_stats, self.paths["tpm_stats"])
        with stage_timer("prepare.write_norm_counts"):
            self.save_norm_counts(norm_counts)
        with stage_timer("prepare.stash_norm"):
            self._stash_norm_compact(
                self._seed_h5ad(self.paths["normalized_counts"], norm_counts),
                input_counts.var.index)
        with stage_timer("prepare.iter_params"):
            replicate_params, run_params = self.get_nmf_iter_params(
                ks=components, n_iter=n_iter, random_state_seed=seed,
                beta_loss=beta_loss, alpha_usage=alpha_usage,
                alpha_spectra=alpha_spectra, init=init,
                max_iter=max_NMF_iter,
            )
            self.save_nmf_iter_params(replicate_params, run_params)

    def get_norm_counts(self, counts, tpm, high_variance_genes_filter=None,
                        num_highvar_genes=None, tpm_moments=None) -> AnnData:
        """Subset to HVGs and scale genes to unit variance without centering
        (reference cnmf.py:487-556: f64 cast, ddof=1 scaling, zero-std genes
        guarded only for sparse input, the HVG list file, and the zero-HVG-cell
        error). ``tpm_moments``: the per-gene (mean, variance) of ``tpm.X``
        at ddof 0, when known, so the Fano HVG selection skips its own pass
        over the TPM (cnmf_tpu/pipeline/cnmf.py:967-985)."""
        return self._prepare(counts, tpm, high_variance_genes_filter,
                             num_highvar_genes, tpm_moments)[1]

    def _prepare(self, counts, tpm, hvgs, num_highvar_genes,
                 tpm_moments=None):
        """``stages.prepare_arrays`` on AnnData, genes matched by name
        (``tpm`` None: the TPM of the counts); writes the HVG list. Returns
        (Prepared, the normalized counts as AnnData)."""
        genes = counts.var.index
        hvg_idx = None
        if hvgs is not None:
            hvg_idx = genes.get_indexer(pd.Index(hvgs))
            if (hvg_idx < 0).any():
                raise KeyError("HVGs missing from the counts' genes: "
                               f"{list(np.asarray(hvgs)[hvg_idx < 0][:5])}")
        same_genes = tpm is None or tpm.var.index.equals(genes)
        prep = stages.prepare_arrays(
            counts.X, num_highvar_genes,
            tpm=None if tpm is None else tpm.X,
            tpm_cols=None if same_genes else genes.get_indexer(tpm.var.index),
            hvg_idx=hvg_idx,
            cell_names=counts.obs.index,
            tpm_moments=tpm_moments,
        )
        with open(self.paths["nmf_genes_list"], "w") as fh:
            fh.write("\n".join(genes[prep.hvg_idx]))
        norm_counts = AnnData(prep.norm, obs=counts.obs.copy(),
                              var=counts.var.iloc[prep.hvg_idx].copy())
        return prep, norm_counts

    def save_norm_counts(self, norm_counts: AnnData):
        self._initialize_dirs()
        write_h5ad(self.paths["normalized_counts"], norm_counts)

    def get_nmf_iter_params(
        self, ks, n_iter=100, random_state_seed=None,
        beta_loss="kullback-leibler", alpha_usage=0.0, alpha_spectra=0.0,
        init="random", max_iter=1000,
    ):
        """Replicate-parameter grid with order-stable per-(K, iter) seeds
        (see ``stages.replicate_seeds``) and the solver kwargs."""
        grid, seeds = stages.replicate_seeds(ks, n_iter, random_state_seed)
        replicate_params = pd.DataFrame(
            {
                "n_components": [k for k, _ in grid],
                "iter": [r for _, r in grid],
                "nmf_seed": seeds,
                "completed": [
                    os.path.exists(self.paths["iter_spectra"] % kr) for kr in grid
                ],
            }
        )
        n_completed = replicate_params["completed"].sum()
        if n_completed > 0:
            warnings.warn(
                "{n} runs already appear completed. If this is unexpected, "
                "consider re-initializing the cnmf object with a different "
                "run name or output directory".format(n=n_completed),
                UserWarning,
            )
        run_params = stages.nmf_run_params(
            beta_loss=beta_loss, alpha_usage=alpha_usage,
            alpha_spectra=alpha_spectra, init=init, max_iter=max_iter,
        )
        return replicate_params, run_params

    def update_nmf_iter_params(self):
        """Re-scan disk for completed per-iteration spectra files and rewrite
        the replicate table — the resume hook (reference cnmf.py:636-651)."""
        run_params = self._load_run_params()
        table = load_df_from_npz(self.paths["nmf_replicate_parameters"])
        table["completed"] = [
            os.path.exists(self.paths["iter_spectra"] % (row.n_components, row.iter))
            for row in table.itertuples()
        ]
        print(
            "{n} NMF runs are currently incomplete".format(
                n=int((~table["completed"].astype(bool)).sum())
            )
        )
        self.save_nmf_iter_params(table, run_params)

    def save_nmf_iter_params(self, replicate_params, run_params):
        self._initialize_dirs()
        save_df_to_npz(replicate_params, self.paths["nmf_replicate_parameters"])
        with open(self.paths["nmf_run_parameters"], "w") as fh:
            yaml.dump(run_params, fh)

    # ==================================================================
    # factorize
    # ==================================================================

    @timed("factorize")
    def factorize(self, worker_i=0, total_workers=1, skip_completed_runs=False,
                  restart_chunk=None, use_mesh=True, verbose=True):
        """Run this worker's share of the replicate grid (round-robin, as the
        reference's workers split it, cnmf.py:692-745): all restarts of one K
        as one batched solve, K zero-padded to a bucket of 8. Spectra land in
        the per-(K, iter) npz files. Sparse normalized counts reach the
        device through ``to_device_dense`` and the inits read the CSR.
        Random inits are drawn on a CUDA device from the seeds
        (``solvers.device_init_enabled``; ``CNMF_TPU_DEVICE_INIT=0`` keeps
        sklearn's host draw there), on the host elsewhere.
        ``use_mesh``: with several local devices of the object's type, lay
        the restarts over ``parallel.mesh.build_mesh()``: the cell axis
        under ``CNMF_TPU_CELL_AXIS``, else the restart axis for each K where
        ``solvers.restart_axis_pays`` (the restart groups' loops are
        device-bound there; smaller K solves run faster on ``device``
        alone); with one device, or False, solve on ``device`` alone."""
        run_params = load_df_from_npz(self.paths["nmf_replicate_parameters"])
        # consensus's device buffers of an earlier stage would compete with
        # the solver for device memory
        self.clear_device_caches()
        norm_counts = self._read_h5ad_cached(self.paths["normalized_counts"])
        nmf_kwargs = self._load_run_params()
        if skip_completed_runs:
            rows = run_params.index[run_params["completed"] == False]  # noqa: E712
        else:
            rows = range(len(run_params))
        jobs = list(worker_filter(rows, worker_i, total_workers))
        if not jobs:
            return
        devices = self._mesh_devices() if use_mesh else None
        mesh = None if devices is None else parallel_mesh.build_mesh(devices)
        X_host, Xd = self._factorize_inputs(norm_counts)
        # the consensus TPM's upload rides behind the solves
        self._prefetch_tpm_async()
        gene_index = norm_counts.var.index
        # random inits drawn on the card from the seeds (threefry keys, the
        # JAX package's accelerator default), else sklearn's host draw
        device_init = (nmf_kwargs.get("init", "random") == "random"
                       and solvers.device_init_enabled(self.device))
        x_mean = (stages.x_mean_for_init(X_host, X_host.dtype)
                  if device_init else None)
        for k, group in run_params.iloc[jobs].groupby("n_components", sort=True):
            k = int(k)
            seeds = group["nmf_seed"].values
            mesh_k = (mesh if mesh is not None and solvers.restart_axis_pays(
                mesh, Xd.shape, len(seeds), k) else None)
            t0, timings = time.perf_counter(), {}
            spectra, n_iter, executed = stages.factorize_k(
                X_host, Xd, k, seeds, nmf_kwargs, restart_chunk=restart_chunk,
                timings=timings, mesh=mesh_k, device_init=device_init,
                x_mean=x_mean,
            )
            if verbose:
                print("[Worker %d] k=%d: %d restarts in %.3f s (inits %.3f s "
                      "on the %s) on %s, sweeps max %d mean %.1f, executed "
                      "restart-sweeps %d"
                      % (worker_i, k, len(seeds), time.perf_counter() - t0,
                         timings["init"], timings["init_on"],
                         "one device" if mesh_k is None
                         else "a mesh %s" % (mesh_k.shape,),
                         n_iter.max(), n_iter.mean(), executed))
            for i, it in enumerate(group["iter"].values):
                save_df_to_npz(
                    pd.DataFrame(spectra[i], index=np.arange(1, k + 1),
                                 columns=gene_index),
                    self.paths["iter_spectra"] % (k, it),
                )

    def _factorize_inputs(self, norm_counts):
        """(the inits' host source, the dense device tensor) of the
        normalized counts (``_solve_inputs``). The device tensor is derived
        on the device from the integer counts of prepare's stash
        (``device_tpm.norm_from_counts``, ≤ 2 ulp from the float upload)
        where ``solvers.device_norm_enabled`` and the stash is keyed to this
        read-back (cnmf_tpu/pipeline/cnmf.py:1355-1410); the image stays on
        the device for the TPM prefetch, and where that would expand it on
        one device anyway, factorize derives both in one pass
        (``derive_norm_and_tpm``) and seeds the consensus TPM cache. The
        device tensor also seeds the consensus cache of the normalized
        counts when it fits 2 GB and consensus keeps one device."""
        X = norm_counts.X
        X_host, Xd = None, None
        nstash = getattr(self, "_norm_compact", None)
        if (not sp.issparse(X) and nstash is not None
                and nstash[0]() is norm_counts
                and nstash[3].dtype == self.compute_dtype
                and solvers.device_norm_enabled(self.device)):
            _, ints, cols, std = nstash
            stashed_csr = getattr(self, "_ints_csr", None)
            ints_dev, _ = device_tpm.upload_int_image(
                ints, stashed_csr[1] if stashed_csr is not None
                and stashed_csr[0] is ints else device_tpm._COMPUTE_CSR,
                self.device)
            self._ints_dev = (ints, ints_dev)
            cols_d = torch.as_tensor(cols, device=self.device)
            std_d = torch.as_tensor(std, device=self.device)
            tpm_target, tpm_scale = self._fused_tpm_derive_target()
            if tpm_target is not None:
                Xd, tpm_dev = device_tpm.derive_norm_and_tpm(
                    ints_dev, cols_d, std_d,
                    torch.as_tensor(tpm_scale, device=self.device))
                self._tpm_dev_cache = (weakref.ref(tpm_target), tpm_dev)
            else:
                Xd = device_tpm.norm_from_counts(ints_dev, cols_d, std_d)
            X_host = np.ascontiguousarray(X, dtype=self.compute_dtype)
        else:
            X_host, Xd = self._solve_inputs(X)
        if (Xd.numel() * Xd.element_size() < 2e9
                and self._cell_devices() is None):
            self._norm_counts_dev_cache = (weakref.ref(norm_counts), Xd)
        return X_host, Xd

    def factorize_multi_process(self, total_workers=None):
        """Compat shim: the batched solve replaces the reference's
        multiprocessing pool (reference cnmf.py:677-689); one call does all
        the work."""
        if total_workers is not None and total_workers != 1:
            print(
                "factorize_multi_process: total_workers=%s ignored — the "
                "batched device program already runs every restart in one "
                "dispatch (no process pool needed)." % total_workers
            )
        self.factorize(worker_i=0, total_workers=1)

    def _nmf(self, X, nmf_kwargs):
        """Single NMF solve mirroring sklearn's return convention
        (spectra, usages) — kept for API compatibility (reference
        cnmf.py:661-674). ``nmf_kwargs`` holds the run's solver kwargs plus
        ``n_components`` and ``random_state``, or ``H`` with
        ``update_H=False`` for a fixed-spectra refit."""
        kwargs = dict(nmf_kwargs)
        H = kwargs.pop("H", None)
        update_H = kwargs.pop("update_H", True)
        if not update_H:
            return np.asarray(H), solvers.refit_usages(
                X, np.asarray(H), kwargs, device=self.device,
                dtype=self.compute_dtype)
        X, Xd = self._solve_inputs(X)
        k = int(kwargs.pop("n_components"))
        seed = kwargs.pop("random_state", None)
        W0, Ht0 = stages.restart_inits(X, k, [seed],
                                       kwargs.get("init", "random"),
                                       self.compute_dtype)
        pad = ((0, 0), (0, 0), (0, pad_bucket(k) - k))
        W0, Ht0 = factors_from_numpy(np.pad(W0, pad), np.pad(Ht0, pad),
                                     device=self.device, dtype=Xd.dtype)
        W, Ht, _ = solvers.solve_nmf_batch(Xd, W0, Ht0, kwargs)
        return (Ht[0, :, :k].T.cpu().numpy(), W[0, :, :k].cpu().numpy())

    # ==================================================================
    # combine
    # ==================================================================

    @timed("combine")
    def combine(self, components=None, skip_missing_files=False):
        run_params = load_df_from_npz(self.paths["nmf_replicate_parameters"])
        if type(components) is int:
            ks = [components]
        elif components is None:
            ks = sorted(set(run_params.n_components))
        else:
            ks = components
        for k in ks:
            self.combine_nmf(k, skip_missing_files=skip_missing_files)

    def combine_nmf(self, k, skip_missing_files=False,
                    remove_individual_iterations=False):
        """Concatenate per-iteration spectra into the merged (n_iter·K × G)
        stack with ``iter{r}_topic{t}`` row labels (reference cnmf.py:748-773).
        ``remove_individual_iterations`` deletes the per-iteration files."""
        run_params = load_df_from_npz(self.paths["nmf_replicate_parameters"])
        print("Combining factorizations for k=%d." % k)
        subset = run_params[run_params.n_components == k].sort_values("iter")
        files = []
        for _, p in subset.iterrows():
            path = self.paths["iter_spectra"] % (p["n_components"], p["iter"])
            if os.path.exists(path):
                files.append((int(p["iter"]), path))
                continue
            if not skip_missing_files:
                print("Missing file: %s, run with skip_missing=True to override"
                      % path)
                raise FileNotFoundError(errno.ENOENT, os.strerror(errno.ENOENT),
                                        path)
            print("Missing file: %s. Skipping." % path)
        if not files:
            print("No spectra found for k=%d" % k)
            return []
        frames = [load_df_from_npz(path) for _, path in files]
        combined = pd.DataFrame(
            stages.combine_arrays([f.values for f in frames]),
            index=["iter%d_topic%d" % (it, t + 1) for it, _ in files
                   for t in range(k)],
            columns=frames[0].columns,
        )
        save_df_to_npz(combined, self.paths["merged_spectra"] % k)
        if remove_individual_iterations:
            for _, path in files:
                os.remove(path)
        return combined

    # ==================================================================
    # refits
    # ==================================================================

    def refit_usage(self, X, spectra):
        """Fixed-spectra NNLS usage refit with the run's solver kwargs
        (reference cnmf.py:776-802). X: (cells × genes) DataFrame, array or
        sparse matrix (CD: host-SpMM products, never dense; MU: densified
        natively on the host); spectra: (k × genes). Returns (cells × k)
        usages, a DataFrame when X and spectra both are."""
        spectra_values = (spectra.values if isinstance(spectra, pd.DataFrame)
                          else spectra)
        X_values = X.values if isinstance(X, pd.DataFrame) else X
        usages = solvers.refit_usages(
            X_values, np.asarray(spectra_values), self._load_run_params(),
            device=self.device, dtype=self.compute_dtype)
        if isinstance(X, pd.DataFrame) and isinstance(spectra, pd.DataFrame):
            usages = pd.DataFrame(usages, index=X.index, columns=spectra.index)
        return usages

    def refit_spectra(self, X, usage):
        """Fixed-usage NNLS spectra refit, the usage refit of Xᵀ (reference
        cnmf.py:805-820). X: (cells × genes); a sparse X is the usage refit
        of its transpose (``refit_usage``'s routes), a dense X goes through
        ``solvers.refit_spectra_transposed`` (Xᵀ is never materialized);
        usage: (cells × k). Returns (k × genes) spectra, a DataFrame when X
        and usage both are."""
        usage_values = np.asarray(
            usage.values if isinstance(usage, pd.DataFrame) else usage)
        X_values = X.values if isinstance(X, pd.DataFrame) else X
        nmf_kwargs = self._load_run_params()
        on = dict(device=self.device, dtype=self.compute_dtype)
        if sp.issparse(X_values):
            spectra = solvers.refit_usages(
                X_values.T, np.ascontiguousarray(usage_values.T),
                nmf_kwargs, **on).T
        else:
            spectra = solvers.refit_spectra_transposed(
                X_values, usage_values, nmf_kwargs, **on).T
        if isinstance(X, pd.DataFrame) and isinstance(usage, pd.DataFrame):
            spectra = pd.DataFrame(spectra, index=usage.columns,
                                   columns=X.columns)
        return spectra

    # ==================================================================
    # consensus
    # ==================================================================

    @timed("consensus")
    def consensus(
        self,
        k,
        density_threshold=DEFAULT_DENSITY_THRESHOLD,
        local_neighborhood_size=0.30,
        show_clustering=True,
        build_ref=True,
        skip_density_and_return_after_stats=False,
        close_clustergram_fig=False,
        refit_usage=True,
        normalize_tpm_spectra=False,
        norm_counts=None,
    ):
        """Consensus spectra/usages via density filtering + KMeans + medians
        (reference cnmf.py:823-1082), dispatched as ``cnmf_tpu`` dispatches
        it (``stages.consensus_arrays``): with the TPM on the device, one
        chain there with one drain (``ops.consensus_fused``; the density,
        filter and threefry kmeans++ in it too where
        ``solvers.device_kmeanspp_enabled``, the CUDA default);
        ``CNMF_TPU_FUSED_CONSENSUS=0``, or the TPM over the device limit, the
        step-by-step path.

        ``skip_density_and_return_after_stats``: skip the density filter and
        return this K's K-selection row ``[k, density_threshold, silhouette,
        prediction_error]`` (a one-column frame indexed by
        ``K_STATS_FIELDS``) without writing anything. ``norm_counts``: the
        normalized counts (AnnData), read from the run directory when None.
        The local density is cached per K; where the host filters, before the
        filter applies, so a threshold that keeps nothing still leaves the
        cache for a rerun (the whole chain on the device caches it after its
        drain, as the JAX package does).

        The full-gene TPM goes to the device when its float32 bytes are under
        ``stages.tpm_device_limit`` (``tpm_device_bytes_limit`` overrides),
        from factorize's prefetch when one ran; above it consensus reads it
        on the host (``stages.consensus_arrays``' atlas branches). The
        normalized counts and the TPM stay on the device until
        ``clear_device_caches``. ``CNMF_TPU_TIMINGS=1`` prints the
        sub-stages' seconds."""
        merged = load_df_from_npz(self.paths["merged_spectra"] % k)
        if norm_counts is None:
            norm_counts = self._read_h5ad_cached(
                self.paths["normalized_counts"])
        nmf_kwargs = self._load_run_params()
        if skip_density_and_return_after_stats:
            silhouette, error = self._dispatch_k_stats(k, merged.values,
                                                       nmf_kwargs, norm_counts)
            return pd.DataFrame(
                [k, density_threshold, float(silhouette), float(error)],
                index=K_STATS_FIELDS, columns=["stats"])

        density_path = self.paths["local_density_cache"] % k
        local_density = (load_df_from_npz(density_path).values[:, 0]
                         if os.path.isfile(density_path) else None)
        # a TPM prefetch started by factorize fills the device cache
        self._join_tpm_prefetch()
        tpm = self._read_h5ad_cached(self.paths["tpm"])
        tpm_stats = load_df_from_npz(self.paths["tpm_stats"])
        dt_tag = str(density_threshold).replace(".", "_")
        with open(self.paths["nmf_genes_list"]) as fh:
            hvgs = fh.read().split("\n")
        hvg_idx = tpm.var.index.get_indexer(hvgs)
        if (hvg_idx < 0).any():
            missing = [h for h, i in zip(hvgs, hvg_idx) if i < 0][:5]
            raise KeyError(
                f"genes from {self.paths['nmf_genes_list']} missing from the "
                f"TPM var index (stale gene list / re-prepared TPM?): {missing}"
            )

        resident = stages.tpm_fits_device(tpm.X.shape, self.device,
                                          self.tpm_device_bytes_limit)
        # the whole consensus as one chain on the device computes the
        # density itself; every other path filters on the host first, the
        # density cached before the filter applies
        whole_chain = (resident and solvers.fused_consensus_enabled()
                       and solvers.device_kmeanspp_enabled(self.device))
        if local_density is None and not whole_chain:
            local_density = stages.spectra_local_density(
                merged.values, k, self.device,
                torch_dtype(self.compute_dtype), local_neighborhood_size)
            self._save_local_density(local_density, merged.index, k)
        norm_counts_dev = self._device_cached(
            "_norm_counts_dev_cache", norm_counts,
            lambda: self._put_cells(norm_counts.X))
        tpm_src = (self._device_cached("_tpm_dev_cache", tpm,
                                       lambda: self._put_cells(tpm.X))
                   if resident else tpm.X)
        sub_stages = {} if timings_verbose() else None
        result = stages.consensus_arrays(
            merged.values, k, norm_counts_dev, tpm_src,
            tpm_stats["__std"].values, hvg_idx, nmf_kwargs,
            density_threshold=density_threshold,
            local_neighborhood_size=local_neighborhood_size,
            local_density=local_density,
            refit_usage=refit_usage,
            normalize_tpm_spectra=normalize_tpm_spectra,
            # the reference guards zero stds on its sparse path only
            zero_safe=sp.issparse(tpm.X),
            timings=sub_stages,
        )
        if local_density is None:
            self._save_local_density(result.local_density, merged.index, k)
        if sub_stages is not None:
            print(f"[cnmf-tpu timing] consensus k={k}: " + " ".join(
                f"{label} {sec:.2f}s" for label, sec in sub_stages.items()),
                file=sys.stderr, flush=True)

        gep_ids = np.arange(1, result.spectra.shape[0] + 1)
        median_spectra = pd.DataFrame(result.spectra, index=gep_ids,
                                      columns=merged.columns)
        usages = pd.DataFrame(result.usages, index=norm_counts.obs.index,
                              columns=gep_ids)
        spectra_tpm = pd.DataFrame(result.spectra_tpm, index=gep_ids,
                                   columns=tpm.var.index)
        spectra_score = pd.DataFrame(result.spectra_score, index=gep_ids,
                                     columns=tpm.var.index)
        for frame, key in (
            (median_spectra, "consensus_spectra"),
            (usages, "consensus_usages"),
            (spectra_tpm, "gene_spectra_tpm"),
            (spectra_score, "gene_spectra_score"),
        ):
            save_df_to_npz(frame, self.paths[key] % (k, dt_tag))
            save_df_to_text(frame, self.paths[key + "__txt"] % (k, dt_tag))

        if show_clustering:
            from cnmf_tpu_torch.pipeline.plots import clustergram

            l2_kept = torch.as_tensor(result.l2_kept, device=self.device).to(
                torch_dtype(self.compute_dtype))
            clustergram(
                pairwise_euclidean(l2_kept).cpu().numpy(),
                result.labels,
                result.local_density,
                density_threshold,
                result.density_filter,
                self.paths["clustering_plot"] % (k, dt_tag),
                close_fig=close_clustergram_fig,
            )
        if build_ref:
            self.build_reference(k, density_threshold)

    def _save_local_density(self, local_density, index, k):
        save_df_to_npz(pd.DataFrame(local_density, columns=["local_density"],
                                    index=index),
                       self.paths["local_density_cache"] % k)

    # ==================================================================
    # K selection
    # ==================================================================

    def _dispatch_k_stats(self, k, spectra, nmf_kwargs, norm_counts):
        """Queue one K's k-stats chain on the normalized counts' cached
        device copy (``stages.k_stats_dispatch``); returns the 0-d tensors
        (silhouette, prediction error), not yet read, so a sweep queues
        every K first (cnmf_tpu/pipeline/cnmf.py:3681-3730). spectra: the
        merged spectra (host), or the raw spectra as a device tensor."""
        norm_counts_dev = self._device_cached(
            "_norm_counts_dev_cache", norm_counts,
            lambda: self._put_cells(norm_counts.X))
        return stages.k_stats_dispatch(k, spectra, norm_counts_dev,
                                       nmf_kwargs)

    @timed("k_selection_plot")
    def k_selection_plot(self, close_fig=False):
        """Stability (silhouette) vs reconstruction-error sweep over every K
        of the run (reference cnmf.py:1119-1158; Alexandrov et al. 2013):
        writes the ``k_selection_stats`` table and the ``k_selection_plot``
        figure and returns the table."""
        from cnmf_tpu_torch.pipeline.plots import k_selection_figure

        run_params = load_df_from_npz(self.paths["nmf_replicate_parameters"])
        norm_counts = self._read_h5ad_cached(self.paths["normalized_counts"])
        nmf_kwargs = self._load_run_params()
        pending = [
            (int(k), *self._dispatch_k_stats(
                k, load_df_from_npz(self.paths["merged_spectra"] % k).values,
                nmf_kwargs, norm_counts))
            for k in sorted(set(run_params.n_components))
        ]
        stats = pd.DataFrame(
            [[k, DEFAULT_DENSITY_THRESHOLD, float(sil), float(sse)]
             for k, sil, sse in pending],
            columns=K_STATS_FIELDS, dtype=np.float64)
        save_df_to_npz(stats, self.paths["k_selection_stats"])
        k_selection_figure(stats, self.paths["k_selection_plot"],
                           close_fig=close_fig)
        return stats

    # ==================================================================
    # starCAT reference and results
    # ==================================================================

    def build_reference(self, k, density_threshold=DEFAULT_DENSITY_THRESHOLD,
                        target_sum=1e6):
        """starCAT reference GEPs for (k, dt): rows renormalized to
        ``target_sum``, divided by the per-gene TPM std, subset to the HVGs,
        indexed ``GEP{i}``.

        Contract quirk kept (reference cnmf.py:1085-1116): the TPM spectra
        reload from the TEXT file, not the npz, so the float round-trip
        through the txt formatting is part of the output."""
        dt_tag = str(density_threshold).replace(".", "_")
        geps = pd.read_csv(
            self.paths["gene_spectra_tpm__txt"] % (k, dt_tag), index_col=0, sep="\t"
        )
        gene_std = load_df_from_npz(self.paths["tpm_stats"])["__std"].to_numpy()
        with open(self.paths["nmf_genes_list"]) as fh:
            hvgs = fh.read().split("\n")
        vals = geps.to_numpy(dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            # zero-std genes yield inf/nan; they are never HVGs
            vals = vals / vals.sum(axis=1, keepdims=True) * target_sum
            vals = vals / gene_std[None, :]
        cols = geps.columns.get_indexer(hvgs)
        if (cols < 0).any():
            raise KeyError([h for h, i in zip(hvgs, cols) if i < 0])
        ref_spectra = pd.DataFrame(
            vals[:, cols],
            index="GEP" + geps.index.astype("str"),
            columns=pd.Index(hvgs),
        )
        save_df_to_npz(ref_spectra, self.paths["starcat_spectra"] % (k, dt_tag))
        save_df_to_text(ref_spectra, self.paths["starcat_spectra__txt"] % (k, dt_tag))

    def load_results(self, K, density_threshold, n_top_genes=100, norm_usage=True):
        """Load the (K, dt) result set back from the user-facing TEXT files:
        usages (optionally row-normalized to sum 1), spectra z-scores and TPM
        spectra transposed to genes × GEPs, and the top ``n_top_genes``
        marker genes per GEP ranked by z-score (reference cnmf.py:1161-1210,
        including the int-cast-with-fallback on usage columns)."""
        dt_tag = str(density_threshold).replace(".", "_")

        def read_t(key):
            return pd.read_csv(self.paths[key] % (K, dt_tag), sep="\t",
                               index_col=0)

        spectra_scores = read_t("gene_spectra_score__txt").T
        spectra_tpm = read_t("gene_spectra_tpm__txt").T
        usage = read_t("consensus_usages__txt")
        if norm_usage:
            usage = usage.div(usage.sum(axis=1), axis=0)
        try:
            usage.columns = [int(x) for x in usage.columns]
        except ValueError:
            print("Usage matrix columns include non integer values")
        top_genes = pd.DataFrame(
            {
                gep: spectra_scores[gep].sort_values(ascending=False)
                     .index[:n_top_genes]
                for gep in spectra_scores.columns
            }
        )
        return usage, spectra_scores, spectra_tpm, top_genes
