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

One process hands each stage's results to the next without reading back
what it wrote (cnmf_tpu/pipeline/cnmf.py:266-556, 1094-1173): factorize
packs every K's true-K spectra on the device and fetches them in one copy
(``stages.factorize_grid``), writes the per-iteration files from a pool of
threads and keeps each K's restart batch in a stack memo, so combine takes
one reshape instead of reading the files; combine, consensus and prepare
keep what they wrote in an artifact memo, checked against each file's
(mtime, size). On CUDA (``CNMF_TPU_DEVICE_SPECTRA``) the packed tensor stays
on the card as the twin that consensus and k-selection take instead of
uploading the merged spectra again. ``CNMF_TPU_ASYNC_WRITES=1`` (the CLI
sets it) moves the writes to one background writer thread, FIFO, and on
CUDA defers factorize's drain itself to it (the copy starts at the pack;
the writer waits for it and writes the files): a stage's return then no
longer means its files are on disk,
and ``flush_writes()`` joins every queued write and raises the first
failure. A same-process read of a path joins its pending write first.

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
import threading
import time
import uuid
import warnings
import weakref
from concurrent.futures import ThreadPoolExecutor

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
from cnmf_tpu_torch.ops.device_densify import (
    device_densify_eligible,
    to_device_dense,
)
from cnmf_tpu_torch.ops.distance import pairwise_euclidean
from cnmf_tpu_torch.parallel import mesh as parallel_mesh
from cnmf_tpu_torch.pipeline import solvers, stages
from cnmf_tpu_torch.pipeline.paths import build_paths
from cnmf_tpu_torch.utils.arena import host_arena
from cnmf_tpu_torch.utils.timing import note as timing_note
from cnmf_tpu_torch.utils.timing import stage_timer, timed, timings_verbose

DEFAULT_DENSITY_THRESHOLD = stages.DEFAULT_DENSITY_THRESHOLD

# row schema of the k_selection table (reference cnmf.py:932-934)
K_STATS_FIELDS = ["k", "local_density_threshold", "silhouette", "prediction_error"]

# the h5ad read cache is filled from the TPM prefetch thread too; this lock
# also guards the pending writes and the deferred metas
_H5AD_LOCK = threading.Lock()

# guards every instance's artifact and spectra-stack memos and the twins
_MEMO_LOCK = threading.Lock()

# the background writer's thread name: a join from that thread itself would
# wait on its own queue
_WRITER = "cnmf-tpu-writer"


class _PendingBatch:
    """A K's (B, k, G) spectra whose device-to-host copy is still queued on
    the background writer (the deferred packed drain, CNMF_TPU_ASYNC_WRITES
    =1, cnmf_tpu/pipeline/cnmf.py:133-153): the writer sets ``value`` and
    then ``event``. A failed drain leaves ``value`` None, and readers go to
    the per-iteration files, whose reads join the writer's future and raise
    its error."""

    __slots__ = ("event", "value", "shape", "nbytes")

    def __init__(self, shape, nbytes):
        self.event = threading.Event()
        self.value = None
        self.shape = shape
        self.nbytes = nbytes

    def wait(self):
        self.event.wait()
        return self.value


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
        writes (``_write_prepare_h5ad``), so a same-process factorize and
        consensus read them back as those very objects, the keys of the
        compact-counts stashes and the device caches. A pending write of
        the path is joined first. Safe from the prefetch thread."""
        self._flush_pending_write(path)
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

    @staticmethod
    def _seed_object(adata):
        """The object a read of ``adata``'s file returns (string indices),
        sharing its X, when X is dense (a sparse X is read back with other
        index arrays); else None."""
        if sp.issparse(adata.X):
            return None
        obs, var = adata.obs.copy(), adata.var.copy()
        obs.index, var.index = obs.index.astype(str), var.index.astype(str)
        return AnnData(adata.X, obs=obs, var=var)

    def clear_device_caches(self, host_caches: bool = False):
        """Drop the cached device buffers (the normalized counts, the TPM and
        the integer counts image) after joining a TPM prefetch in flight,
        strip the spectra twins from the stack memo and the deferred merges
        (their host batches stay a valid combine fast path), then empty
        PyTorch's caching allocator on CUDA. ``host_caches``: drop the h5ad
        read cache too (kept by default: every hit is mtime-checked, and
        dropping it breaks the compact-counts stashes' object keys)."""
        self._join_tpm_prefetch()
        attrs = ["_norm_counts_dev_cache", "_tpm_dev_cache", "_ints_dev",
                 "_merged_dev"]
        if host_caches:
            attrs.append("_h5ad_cache")
        for attr in attrs:
            self.__dict__.pop(attr, None)
        with _MEMO_LOCK:
            memo = getattr(self, "_stack_memo", None) or {}
            for k_, entry in list(memo.items()):
                if entry[3] is not None:
                    memo[k_] = entry[:3] + (None,)
        with _H5AD_LOCK:
            metas = getattr(self, "_merged_meta", None) or {}
            for path_, meta in list(metas.items()):
                if meta[4] is not None:
                    metas[path_] = meta[:4] + (None,)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # the in-process memos (cnmf_tpu/pipeline/cnmf.py:266-556): the stages
    # still write every file of the run directory, but a same-process
    # stage downstream takes what this object wrote from memory. An entry
    # is valid while its file keeps the (mtime_ns, size) of that write, so
    # a rewrite by another process wins; _PENDING_STAT marks a write still
    # queued on the background writer, whose object is the file to be
    # ------------------------------------------------------------------

    _ARTIFACT_MEMO_BYTES = int(5e8)
    _STACK_MEMO_BYTES = int(5e8)
    _PENDING_STAT = (-1, -1)

    def _memo_artifact(self, path, obj, nbytes, stat=None):
        """Keep ``obj``, just written to ``path``, for ``_recall_artifact``.
        ``stat``: the (mtime_ns, size) that ``save_df_to_npz`` returned for
        the write (so that another process's rewrite in between is never
        paired with this object), else the file's now. Returns whether it
        was stored (the byte cap may decline: an async caller must then
        write before it returns)."""
        if stat is None:
            try:
                st = os.stat(path)
            except OSError:
                return False
            stat = (st.st_mtime_ns, st.st_size)
        with _MEMO_LOCK:
            memo = self.__dict__.setdefault("_artifact_memo", {})
            prev = memo.get(path)
            used = (getattr(self, "_artifact_memo_bytes", 0)
                    - (prev[3] if prev else 0))
            if used + nbytes > self._ARTIFACT_MEMO_BYTES:
                return False
            memo[path] = (stat[0], stat[1], obj, nbytes)
            self._artifact_memo_bytes = used + nbytes
            return True

    def _settle_artifact_stat(self, path, obj, stat):
        """Give a memo entry still marked pending the stat of its finished
        write, if the entry still holds ``obj``."""
        with _MEMO_LOCK:
            memo = getattr(self, "_artifact_memo", None) or {}
            entry = memo.get(path)
            if entry is not None and entry[2] is obj:
                memo[path] = (stat[0], stat[1], obj, entry[3])

    def _recall_artifact(self, path, copy=True):
        """The object this process last wrote to ``path`` while the file
        still holds that write (or the write is pending), else None (a
        stale entry is dropped). ``copy=False`` skips the defensive copy,
        for callers that only read it."""
        with _MEMO_LOCK:
            memo = getattr(self, "_artifact_memo", None)
            if not memo or path not in memo:
                return None
            mtime_ns, size, obj, nbytes = memo[path]
            if (mtime_ns, size) != self._PENDING_STAT:
                try:
                    st = os.stat(path)
                    stale = (st.st_mtime_ns, st.st_size) != (mtime_ns, size)
                except OSError:
                    stale = True
                if stale:
                    del memo[path]
                    self._artifact_memo_bytes -= nbytes
                    return None
        return obj.copy() if copy else obj

    def _memo_spectra_stack(self, k, file_stats, spectra_batch, gene_index,
                            dev=None):
        """Keep K's whole (B, k, G) restart batch (a host array or a
        ``_PendingBatch``) so that combine rebuilds the merged frame with
        one reshape. ``file_stats``: [(iter, path, stat)] in batch-row
        order, each file's write stat (or ``_PENDING_STAT``). ``dev``: (the
        packed device tensor, first row, rows) of this K's spectra, the
        twin. Returns whether it was stored (the byte cap may decline)."""
        nbytes = spectra_batch.nbytes
        with _MEMO_LOCK:
            memo = self.__dict__.setdefault("_stack_memo", {})
            prev = memo.get(k)
            used = (getattr(self, "_stack_memo_bytes", 0)
                    - (prev[2].nbytes if prev else 0))
            if used + nbytes > self._STACK_MEMO_BYTES:
                return False
            by_iter = {it: (path, stat, row)
                       for row, (it, path, stat) in enumerate(file_stats)}
            memo[k] = (by_iter, gene_index, spectra_batch, dev)
            self._stack_memo_bytes = used + nbytes
            return True

    def _settle_stack_stat(self, k, it, path, stat):
        """Give an (iter, path) of K's stack still marked pending the stat
        of its finished write (on the writer thread; a later factorize may
        have replaced the entry)."""
        with _MEMO_LOCK:
            entry = (getattr(self, "_stack_memo", None) or {}).get(k)
            if entry is None:
                return
            hit = entry[0].get(it)
            if (hit is not None and hit[0] == path
                    and hit[1] == self._PENDING_STAT):
                entry[0][it] = (path, stat, hit[2])

    def _recall_spectra_stack(self, k, files, join=True):
        """(values, columns, dev) of the merged stack at the batch's dtype
        when the stack memo covers exactly ``files`` ([(iter, path)]) and
        every file still has its write's stat (or is pending), else None.
        ``dev``, the twin, only for the whole batch in order, where the
        device rows are the merged rows. ``join=False``: a batch whose
        drain is still queued comes back as its ``_PendingBatch``,
        unjoined, for the whole batch in order; otherwise the drain is
        released and joined (a failed one gives None: the files then)."""
        with _MEMO_LOCK:
            entry = (getattr(self, "_stack_memo", None) or {}).get(k)
        if entry is None:
            return None
        by_iter, gene_index, batch, dev = entry
        if len(files) != len(by_iter):
            return None
        rows = []
        for it, path in files:
            hit = by_iter.get(it)
            if hit is None or hit[0] != path:
                return None
            if hit[1] != self._PENDING_STAT:
                try:
                    st = os.stat(path)
                except OSError:
                    return None
                if (st.st_mtime_ns, st.st_size) != hit[1]:
                    return None
            rows.append(hit[2])
        if isinstance(batch, _PendingBatch):
            if not join and rows == list(range(batch.shape[0])):
                return batch, gene_index, dev
            batch = batch.wait()
            if batch is None:
                return None
        if rows == list(range(batch.shape[0])):
            # a read-only view of the batch: the frame escapes to the
            # caller, who must not write through it into the memo
            values = batch.reshape(-1, batch.shape[2])
            values.flags.writeable = False
        else:
            values = batch[rows].reshape(-1, batch.shape[2])
            dev = None
        return values, gene_index, dev

    def _register_twin(self, merged_path, frame, dev_twin):
        """Tie the twin to the memoized merged frame (by weakref: it dies
        with the memo entry it describes)."""
        with _MEMO_LOCK:
            self.__dict__.setdefault("_merged_dev", {})[merged_path] = (
                weakref.ref(frame), dev_twin)

    def _device_spectra_twin(self, k, merged_frame):
        """The (R, G) raw merged spectra of ``k`` on the device, the rows of
        the pack a same-process factorize left there, when
        ``solvers.device_spectra_enabled`` and the registered twin describes
        exactly ``merged_frame`` (cnmf_tpu/pipeline/cnmf.py:408-433); else
        None (the host values then)."""
        if (merged_frame is None
                or not solvers.device_spectra_enabled(self.device)):
            return None
        with _MEMO_LOCK:
            entry = (getattr(self, "_merged_dev", None) or {}).get(
                self.paths["merged_spectra"] % k)
        if entry is None or entry[0]() is not merged_frame:
            return None
        packed, off, rows = entry[1]
        return packed[off:off + rows]

    def _defer_merged_write(self, k, pb, columns, files, dev_twin):
        """Queue K's merged build and write on the background writer behind
        the deferred drain that fills ``pb`` (cnmf_tpu/pipeline/cnmf.py:
        435-491), and register (index, columns, placeholder, twin) for a
        same-process consensus to run from without the host values, tied
        to the queued future. Returns None (combine's fan-out drops it)."""
        merged_path = self.paths["merged_spectra"] % k
        index = ["iter%d_topic%d" % (it, t + 1) for it, _ in files
                 for t in range(k)]

        def merge_and_write():
            batch = pb.wait()
            if batch is None:
                raise RuntimeError("the deferred spectra drain failed: the "
                                   "merged stack for k=%d was not built" % k)
            values = batch.reshape(-1, batch.shape[2])
            values.flags.writeable = False
            frame = pd.DataFrame(values, index=index, columns=columns,
                                 copy=False)
            st = save_df_to_npz(frame, merged_path)
            if (self._memo_artifact(merged_path, frame, values.nbytes,
                                    stat=st) and dev_twin is not None):
                self._register_twin(merged_path, frame, dev_twin)

        with _H5AD_LOCK:
            # a reader between here and the submit sees no meta rather than
            # an earlier run's
            (getattr(self, "_merged_meta", None) or {}).pop(merged_path,
                                                             None)
        fut = self._submit_pending_write(merged_path, merge_and_write)
        with _H5AD_LOCK:
            self.__dict__.setdefault("_merged_meta", {})[merged_path] = (
                fut, pd.Index(index), columns, pb, dev_twin)
        return None

    def _deferred_merged_meta(self, merged_path):
        """(index, columns, placeholder, twin) of a merged stack whose build
        is still queued, while the registered future is the path's pending
        write; else None (the memo or the file then)."""
        with _H5AD_LOCK:
            meta = (getattr(self, "_merged_meta", None) or {}).get(
                merged_path)
            if meta is None:
                return None
            current = (getattr(self, "_pending_writes", None) or {}).get(
                merged_path)
        fut, index, columns, pb, dev_twin = meta
        if current is not fut:
            return None
        return index, columns, pb, dev_twin

    # ------------------------------------------------------------------
    # the background writer (cnmf_tpu/pipeline/cnmf.py:1094-1173)
    # ------------------------------------------------------------------

    def _submit_pending_write(self, path, fn, extra_paths=()):
        """Queue ``fn`` on the object's one writer thread (FIFO) and register
        its future under ``path`` and ``extra_paths``, the paths it writes,
        for the readers' joins and ``flush_writes``. Returns the future."""
        with _H5AD_LOCK:
            pool = getattr(self, "_writer_pool", None)
            if pool is None:
                pool = self._writer_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=_WRITER)
            pending = self.__dict__.setdefault("_pending_writes", {})
            fut = pool.submit(fn)
            for p in (path, *extra_paths):
                pending[p] = fut
        return fut

    def _write_pending(self, path):
        """Whether a write of ``path`` is queued or running: where a file's
        existence decides (combine's scan), a pending write counts."""
        with _H5AD_LOCK:
            return path in (getattr(self, "_pending_writes", None) or {})

    def _flush_pending_write(self, path):
        """Join the pending write of ``path``, if any, and raise its error
        here. On the writer thread itself (FIFO) every earlier write is
        done, and a later one must not be waited for there."""
        if threading.current_thread().name.startswith(_WRITER):
            return
        with _H5AD_LOCK:
            fut = (getattr(self, "_pending_writes", None) or {}).get(path)
        if fut is None:
            return
        try:
            fut.result()
        finally:
            with _H5AD_LOCK:
                pending = self._pending_writes
                if pending.get(path) is fut:
                    del pending[path]

    def flush_writes(self):
        """Join every pending background write (CNMF_TPU_ASYNC_WRITES=1)
        and raise the first failure; call it before another process reads
        the run directory. Without the knob nothing is pending."""
        with _H5AD_LOCK:
            futs = list((getattr(self, "_pending_writes", None) or {}).items())
        error = None
        for _, fut in futs:
            try:
                fut.result()
            except BaseException as exc:   # raised below, after every join
                error = error or exc
        with _H5AD_LOCK:
            pending = getattr(self, "_pending_writes", None) or {}
            for path, fut in futs:
                if pending.get(path) is fut:
                    del pending[path]
        if error is not None:
            raise error

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
        # an async prepare's write of the TPM counts as the file: the
        # thread joins it
        if not (self._write_pending(tpm_path) or os.path.isfile(tpm_path)):
            return

        def read_and_put():
            self._flush_pending_write(tpm_path)
            n, g = read_h5ad_shape(tpm_path)
            tpm = self._read_h5ad_cached(tpm_path)
            fits = n * g * self.compute_dtype.itemsize < 0.5 * self._tpm_limit()
            return tpm, (self._put_cells(tpm.X) if fits else None)

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

    def _autowarm(self):
        """The cold start of factorize and k-selection
        (cnmf_tpu/pipeline/cnmf.py:2338, 2388): on a CUDA device, start the
        kernel library's build on a background thread
        (``ops.kernel_lib.start_build``, once per process), so that the
        first launch finds it built or building; the library is cached on
        disk for later processes. A no-op on the CPU or with
        ``CNMF_TPU_AUTOWARM=0``. A failed build is not hidden: the first
        launch raises its error."""
        from cnmf_tpu_torch.ops import kernel_lib

        if solvers.autowarm_enabled() and self.device.type == "cuda":
            kernel_lib.start_build()

    def _load_run_params(self) -> dict:
        with open(self.paths["nmf_run_parameters"]) as fh:
            return yaml.safe_load(fh)

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
        # an earlier prepare's pending writes land before this one's
        # overwrite them (the copy below bypasses the writer)
        self.flush_writes()
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
                self._write_prepare_h5ad(self.paths["tpm"], tpm)

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
                seeded = self._write_prepare_h5ad(self.paths["tpm"], tpm)
            with stage_timer("prepare.stash_tpm"):
                self._stash_tpm_compact(seeded, input_counts.X)
        input_tpm_stats = pd.DataFrame(
            [prep.tpm_mean, prep.tpm_std],
            index=["__mean", "__std"],
            columns=tpm.var.index,
        ).T
        save_df_to_npz(input_tpm_stats, self.paths["tpm_stats"])
        with stage_timer("prepare.write_norm_counts"):
            seeded_norm = self.save_norm_counts(norm_counts)
        with stage_timer("prepare.stash_norm"):
            self._stash_norm_compact(seeded_norm, input_counts.var.index)
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
        return self._write_prepare_h5ad(self.paths["normalized_counts"],
                                        norm_counts)

    def _write_prepare_h5ad(self, path, adata):
        """Write a prepare h5ad (cnmf_tpu/pipeline/cnmf.py:1033-1092) and
        seed the read cache with the object a read of it returns
        (``_seed_object``), which comes back (None for a sparse X): the key
        of the compact-counts stashes. ``CNMF_TPU_PREPARE_DTYPE`` (e.g.
        float32) stores X at that dtype, through an arena buffer when dense;
        the in-memory matrix keeps its own. ``CNMF_TPU_ASYNC_WRITES=1``
        writes on the background writer; a same-process read joins it."""
        dt = os.environ.get("CNMF_TPU_PREPARE_DTYPE", "")
        X = adata.X
        if dt and np.dtype(dt) != (X.data.dtype if sp.issparse(X)
                                   else np.asarray(X).dtype):
            if sp.issparse(X):
                Xc = X.copy()
                Xc.data = Xc.data.astype(np.dtype(dt))
            else:
                Xc = host_arena.take(np.shape(X), np.dtype(dt))
                np.copyto(Xc, np.asarray(X))
            adata = AnnData(Xc, obs=adata.obs, var=adata.var)
        seeded = self._seed_object(adata)

        def write_and_seed():
            write_h5ad(path, adata)
            if seeded is not None:
                with _H5AD_LOCK:
                    self.__dict__.setdefault("_h5ad_cache", {})[path] = (
                        os.path.getmtime(path), seeded)

        if solvers.async_writes_enabled():
            self._submit_pending_write(path, write_and_seed)
        else:
            write_and_seed()
        return seeded

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
        as one batched solve, K zero-padded to a bucket of 8, the grid
        through ``stages.factorize_grid`` (every K's true-K spectra packed
        on the device and fetched in one copy where they fit). Spectra land
        in the per-(K, iter) npz files, written from a pool of threads, and
        in the stack memo that a same-process combine reads. Sparse
        normalized counts reach the device through ``to_device_dense`` and
        the inits read the CSR. Random inits are drawn on a CUDA device from
        the seeds (``solvers.device_init_enabled``; ``CNMF_TPU_DEVICE_INIT=
        0`` keeps sklearn's host draw there), on the host elsewhere.
        ``use_mesh``: with several local devices of the object's type, lay
        the restarts over ``parallel.mesh.build_mesh()``: the cell axis
        under ``CNMF_TPU_CELL_AXIS``, else the restart axis for each K where
        ``solvers.restart_axis_pays`` (the restart groups' loops are
        device-bound there; smaller K solves run faster on ``device``
        alone); with one device, or False, solve on ``device`` alone.

        ``CNMF_TPU_ASYNC_WRITES=1``: the files are written on the
        background writer after factorize returns (``flush_writes``), and
        on CUDA (``CNMF_TPU_DEVICE_SPECTRA``) factorize returns before the
        packed copy has landed: the writer waits for it (the deferred
        drain). ``CNMF_TPU_PHASES=1``: the wall's
        split lands in ``self._factorize_phases`` (and, with ``verbose``, on
        a ``[Worker]`` line).

        On a CUDA device the kernel library's build starts first, on a
        background thread (``_autowarm``), and overlaps the counts' read,
        upload and restart draws. ``CNMF_TPU_STAGED=1`` or
        ``CNMF_TPU_GRID=1`` solve the Ks together on a tail-compacted
        schedule (``stages.factorize_grid``); their spectra arrive on the
        host, so consensus and k-selection are fed from there.
        ``CNMF_TPU_COMPACT=1`` compacts each K's restarts between segments
        (``stages.factorize_k``)."""
        run_params = load_df_from_npz(self.paths["nmf_replicate_parameters"])
        self._autowarm()
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
        phases = ({"upload_s": 0.0, "init_s": 0.0, "dispatch_s": 0.0,
                   "solve_wait_s": 0.0, "result_fetch_s": 0.0, "write_s": 0.0,
                   "upload_bytes": 0, "result_bytes": 0}
                  if solvers.phases_enabled() else None)
        self._factorize_phases = phases
        # the writer threads and the main thread add to phases
        self._phases_lock = threading.Lock()
        devices = self._mesh_devices() if use_mesh else None
        mesh = None if devices is None else parallel_mesh.build_mesh(devices)
        t_up = time.perf_counter()
        X_host, Xd, link_bytes = self._factorize_inputs(norm_counts)
        if phases is not None:
            stages.stream_barrier(Xd)
            phases["upload_s"] = time.perf_counter() - t_up
            phases["upload_bytes"] = int(link_bytes)
        # the consensus TPM's upload rides behind the solves
        self._prefetch_tpm_async()
        gene_index = norm_counts.var.index
        # random inits drawn on the card from the seeds (threefry keys, the
        # JAX package's accelerator default), else sklearn's host draw
        device_init = (nmf_kwargs.get("init", "random") == "random"
                       and solvers.device_init_enabled(self.device))
        x_mean = (stages.x_mean_for_init(X_host, X_host.dtype)
                  if device_init else None)
        grid = [(int(k), group["nmf_seed"].values, group["iter"].values)
                for k, group in run_params.iloc[jobs].groupby(
                    "n_components", sort=True)]
        pipeline_all = stages.pipeline_all_fits(grid, X_host.shape[0],
                                                Xd.element_size())
        async_writes = solvers.async_writes_enabled()
        defer_ok = async_writes and solvers.device_spectra_enabled(self.device)

        def add_phase(key, value):
            if phases is not None:
                with self._phases_lock:
                    phases[key] += value

        def report(k, B, seconds, timings, mesh_k, n_iter, executed):
            if verbose:
                print("[Worker %d] k=%d: %d restarts in %.3f s (inits %.3f s "
                      "on the %s) on %s, sweeps max %d mean %.1f, executed "
                      "restart-sweeps %d"
                      % (worker_i, k, B, seconds, timings["init"],
                         timings["init_on"], "one device" if mesh_k is None
                         else "a mesh %s" % (mesh_k.shape,),
                         n_iter.max(), n_iter.mean(), executed))

        deferred_writes = []   # (k, write futures, batch, twin)
        with ThreadPoolExecutor(max_workers=8) as pool:

            def settle_writes():
                # join the pool's writes and keep each K's stack with the
                # stats of its writes; on every exit path
                while deferred_writes:
                    k, futs, batch, dev = deferred_writes.pop(0)
                    t0 = time.perf_counter()
                    stats = [f.result() for f in futs]
                    self._memo_spectra_stack(k, stats, batch, gene_index,
                                             dev=dev)
                    add_phase("write_s", time.perf_counter() - t0)

            def write(k, iters, batch, dev):
                # cnmf_tpu/pipeline/cnmf.py:1542-1626. ``batch`` holds no
                # padded rows: a view of the pack (all of which is some
                # K's rows) or a K's own fetched array
                paths = [self.paths["iter_spectra"] % (k, int(it))
                         for it in iters]
                if pipeline_all and async_writes:
                    # the stack memo serves a same-process combine while the
                    # files wait on the writer; where the memo declines,
                    # combine reads the files, so they are written now
                    pending = [(int(it), path, self._PENDING_STAT)
                               for it, path in zip(iters, paths)]
                    if self._memo_spectra_stack(k, pending, batch, gene_index,
                                                dev=dev):
                        for i, (it, path) in enumerate(zip(iters, paths)):
                            def queued(i=i, it=int(it), path=path):
                                st = self._write_iter_spectra(
                                    k, it, batch[i], path, gene_index)[2]
                                self._settle_stack_stat(k, it, path, st)
                            self._submit_pending_write(path, queued)
                        return
                futs = [pool.submit(self._write_iter_spectra, k, it,
                                    batch[i], path, gene_index)
                        for i, (it, path) in enumerate(zip(iters, paths))]
                if pipeline_all:
                    # the writes ride the pool while the next K solves, and
                    # are settled before factorize returns
                    deferred_writes.append((k, futs, batch, dev))
                else:
                    self._memo_spectra_stack(k, [f.result() for f in futs],
                                             batch, gene_index, dev=dev)

            def defer(entries, packed, fetch):
                self._defer_packed(entries, packed, fetch, gene_index,
                                   add_phase)

            try:
                stages.factorize_grid(
                    X_host, Xd, grid, nmf_kwargs, write,
                    restart_chunk=restart_chunk, mesh=mesh,
                    device_init=device_init, x_mean=x_mean, report=report,
                    phases=phases, phases_lock=self._phases_lock,
                    twin=solvers.device_spectra_enabled(self.device),
                    defer=defer if defer_ok else None)
            finally:
                settle_writes()
        if verbose and phases is not None:
            print("[Worker %d] phases %s" % (worker_i, " ".join(
                "%s %s" % (key, ("%.3f" % v) if isinstance(v, float) else v)
                for key, v in phases.items())))

    def _write_iter_spectra(self, k, it, rows, path, gene_index):
        """One restart's (k × G) spectra to its per-iteration npz file, at
        the solver's dtype, its frame memoized with the write's stat;
        returns (iter, path, stat). The frame is made on the thread that
        writes it."""
        frame = pd.DataFrame(rows, index=np.arange(1, k + 1),
                             columns=gene_index)
        st = save_df_to_npz(frame, path)
        self._memo_artifact(path, frame, frame.values.nbytes, stat=st)
        return int(it), path, st

    def _defer_packed(self, entries, packed, fetch, gene_index, add_phase):
        """The deferred packed drain (cnmf_tpu/pipeline/cnmf.py:1671-1769):
        register each K's stack memo as a ``_PendingBatch`` with pending
        file stats and its twin in ``packed``, and queue one writer task for
        every per-iteration path, so that factorize returns before the copy
        (started at the pack) has landed. The task waits for the bytes
        (``fetch``), fills every placeholder before any file write, then
        writes the files and settles their stats. A failed
        copy drops the placeholders' memo entries and raises in the task,
        where readers of the files join it."""
        G = int(packed.shape[1])
        itemsize = packed.element_size()
        registered, paths_all = [], []
        for k, iters, off, B in entries:
            pb = _PendingBatch((B, k, G), B * k * G * itemsize)
            stats = [(int(it), self.paths["iter_spectra"] % (k, int(it)),
                      self._PENDING_STAT) for it in iters]
            ok = self._memo_spectra_stack(k, stats, pb, gene_index,
                                          dev=(packed, off, B * k))
            registered.append((k, [int(it) for it in iters], off, B,
                               pb if ok else None))
            paths_all.extend(path for _, path, _ in stats)
        add_phase("result_bytes",
                  sum(B * k for k, _, _, B in entries) * G * itemsize)
        def drain_task():
            try:
                arr = fetch.wait()
            except BaseException:
                with _MEMO_LOCK:
                    memo = getattr(self, "_stack_memo", None) or {}
                    for k, _, _, _, pb in registered:
                        if pb is not None and memo.get(k, (0, 0, None))[2] is pb:
                            del memo[k]
                            self._stack_memo_bytes -= pb.nbytes
                for *_, pb in registered:
                    if pb is not None:
                        pb.event.set()
                raise
            batches = [arr[off:off + B * k].reshape(B, k, G)
                       for k, _, off, B, _ in registered]
            # every placeholder first: a blocked reader goes on as soon as
            # the bytes are here
            for (k, _, _, _, pb), batch in zip(registered, batches):
                if pb is None:
                    continue
                pb.value = batch
                with _MEMO_LOCK:
                    memo = getattr(self, "_stack_memo", None) or {}
                    entry = memo.get(k)
                    if entry is not None and entry[2] is pb:
                        memo[k] = (entry[0], entry[1], batch, entry[3])
                pb.event.set()
            for (k, iters, _, _, _), batch in zip(registered, batches):
                for i, it in enumerate(iters):
                    path = self.paths["iter_spectra"] % (k, it)
                    st = self._write_iter_spectra(k, it, batch[i], path,
                                                  gene_index)[2]
                    self._settle_stack_stat(k, it, path, st)

        self._submit_pending_write(paths_all[0], drain_task,
                                   extra_paths=paths_all[1:])

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
        counts when it fits 2 GB and consensus keeps one device. Returns
        (the host source, the device tensor, the bytes that crossed to the
        device)."""
        X = norm_counts.X
        X_host, Xd = None, None
        nstash = getattr(self, "_norm_compact", None)
        if (not sp.issparse(X) and nstash is not None
                and nstash[0]() is norm_counts
                and nstash[3].dtype == self.compute_dtype
                and solvers.device_norm_enabled(self.device)):
            _, ints, cols, std = nstash
            stashed_csr = getattr(self, "_ints_csr", None)
            ints_dev, link_bytes = device_tpm.upload_int_image(
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
            link_bytes += cols.nbytes + std.nbytes
        else:
            X_host, Xd = self._solve_inputs(X)
            link_bytes = (X.data.nbytes + X.indices.nbytes + X.indptr.nbytes
                          if sp.issparse(X) and device_densify_eligible(
                              X, self.compute_dtype, self.device)
                          else Xd.numel() * Xd.element_size())
        if (Xd.numel() * Xd.element_size() < 2e9
                and self._cell_devices() is None):
            self._norm_counts_dev_cache = (weakref.ref(norm_counts), Xd)
        return X_host, Xd, link_bytes

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
        # the K are independent (disjoint files): memo recalls and npz IO,
        # which threads overlap; the fan-out drops each K's frame, so a
        # merge may wait on the writer behind a drain still queued
        with ThreadPoolExecutor(max_workers=min(8, max(len(ks), 1))) as pool:
            list(pool.map(lambda k: self.combine_nmf(
                k, skip_missing_files=skip_missing_files,
                _run_params=run_params, _defer=True), ks))

    def combine_nmf(self, k, skip_missing_files=False,
                    remove_individual_iterations=False, _run_params=None,
                    _defer=False):
        """Concatenate per-iteration spectra into the merged (n_iter·K × G)
        stack with ``iter{r}_topic{t}`` row labels (reference cnmf.py:748-773),
        from a same-process factorize's stack memo where it covers them (one
        reshape, no file read), else from the files, recalled from the
        artifact memo or read in a pool of threads. A pending write of this
        object counts as an existing file. ``remove_individual_iterations``
        deletes the per-iteration files (their pending writes joined first).
        ``_run_params``: the replicate table, loaded once by ``combine``.
        ``_defer`` (``combine``'s fan-out under CNMF_TPU_ASYNC_WRITES=1):
        where factorize's drain is still queued, queue the merge behind it
        on the writer and return None (cnmf_tpu/pipeline/cnmf.py:
        2935-3089)."""
        run_params = (_run_params if _run_params is not None else
                      load_df_from_npz(self.paths["nmf_replicate_parameters"]))
        print("Combining factorizations for k=%d." % k)
        subset = run_params[run_params.n_components == k].sort_values("iter")
        files = []
        for _, p in subset.iterrows():
            path = self.paths["iter_spectra"] % (p["n_components"], p["iter"])
            if os.path.exists(path) or self._write_pending(path):
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
        async_writes = solvers.async_writes_enabled()
        defer = _defer and not remove_individual_iterations and async_writes
        stack = self._recall_spectra_stack(k, files, join=not defer)
        timing_note(f"combine k={k}: stack memo "
                    f"{'hit' if stack is not None else 'MISS'}")
        if stack is not None:
            values, columns, dev_twin = stack
            if isinstance(values, _PendingBatch):
                return self._defer_merged_write(k, values, columns, files,
                                                dev_twin)
        else:
            dev_twin = None

            def read_one(f):
                hit = self._recall_artifact(f[1], copy=False)
                if hit is not None:
                    return hit
                self._flush_pending_write(f[1])
                return load_df_from_npz(f[1])

            with ThreadPoolExecutor(max_workers=8) as pool:
                frames = list(pool.map(read_one, files))
            values = stages.combine_arrays([f.values for f in frames])
            columns = frames[0].columns
        combined = pd.DataFrame(
            values, index=["iter%d_topic%d" % (it, t + 1) for it, _ in files
                           for t in range(k)],
            columns=columns, copy=False)
        merged_path = self.paths["merged_spectra"] % k
        # the memo keeps a copy-on-write slice: a caller that changes the
        # returned frame does not change what consensus recalls
        memo_frame = combined[:]
        if async_writes:
            stored = self._memo_artifact(merged_path, memo_frame,
                                         values.nbytes, stat=self._PENDING_STAT)
            if stored:
                def write_merged():
                    st = save_df_to_npz(combined, merged_path)
                    self._settle_artifact_stat(merged_path, memo_frame, st)

                self._submit_pending_write(merged_path, write_merged)
            else:
                # readers would go to the file: write it now
                save_df_to_npz(combined, merged_path)
        else:
            stored = self._memo_artifact(merged_path, memo_frame,
                                         values.nbytes,
                                         stat=save_df_to_npz(combined,
                                                             merged_path))
        if dev_twin is not None and stored:
            self._register_twin(merged_path, memo_frame, dev_twin)
        if remove_individual_iterations:
            for _, path in files:
                # a queued write would create the file again after the
                # delete
                self._flush_pending_write(path)
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
        sub-stages' seconds.

        The merged spectra come from the artifact memo of a same-process
        combine, else from a deferred merge's registration (the drain still
        queued: only its index, columns and twin), else from the file. The
        whole chain on the device takes the twin where
        ``solvers.device_spectra_enabled`` (cnmf_tpu/pipeline/cnmf.py:3373),
        so the merged spectra are not uploaded again; other paths take the
        host values, joining a queued merge. Under CNMF_TPU_ASYNC_WRITES=1
        the ten result files and the starCAT reference are written on the
        background writer. Consensus ends by releasing the held drains."""
        merged_path = self.paths["merged_spectra"] % k
        merged = self._recall_artifact(merged_path, copy=False)
        meta = None if merged is not None else self._deferred_merged_meta(
            merged_path)

        def host_merged():
            nonlocal merged
            if merged is None:
                self._flush_pending_write(merged_path)
                merged = self._recall_artifact(merged_path, copy=False)
                if merged is None:
                    merged = load_df_from_npz(merged_path)
            return merged

        if meta is None:
            host_merged()
        spectra_index = merged.index if merged is not None else meta[0]
        spectra_columns = merged.columns if merged is not None else meta[1]
        if norm_counts is None:
            norm_counts = self._read_h5ad_cached(
                self.paths["normalized_counts"])
        nmf_kwargs = self._load_run_params()
        if skip_density_and_return_after_stats:
            spectra_in, _ = self._k_stats_spectra_input(k)
            silhouette, error = self._dispatch_k_stats(k, spectra_in,
                                                       nmf_kwargs, norm_counts)
            row = pd.DataFrame(
                [k, density_threshold, float(silhouette), float(error)],
                index=K_STATS_FIELDS, columns=["stats"])
            return row

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
        spectra_in = None
        if whole_chain and solvers.device_spectra_enabled(self.device):
            if merged is None and meta[3] is not None:
                packed, off, rows = meta[3]
                spectra_in = packed[off:off + rows]
            else:
                spectra_in = self._device_spectra_twin(k, merged)
        if spectra_in is None:
            spectra_in = host_merged().values
        if local_density is None and not whole_chain:
            local_density = stages.spectra_local_density(
                spectra_in, k, self.device,
                torch_dtype(self.compute_dtype), local_neighborhood_size)
            self._save_local_density(local_density, spectra_index, k)
        norm_counts_dev = self._device_cached(
            "_norm_counts_dev_cache", norm_counts,
            lambda: self._put_cells(norm_counts.X))
        tpm_src = (self._device_cached("_tpm_dev_cache", tpm,
                                       lambda: self._put_cells(tpm.X))
                   if resident else tpm.X)
        sub_stages = {} if timings_verbose() else None
        result = stages.consensus_arrays(
            spectra_in, k, norm_counts_dev, tpm_src,
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
            self._save_local_density(result.local_density, spectra_index, k)
        if sub_stages is not None:
            timing_note(f"consensus k={k}: " + " ".join(
                f"{label} {sec:.2f}s" for label, sec in sub_stages.items()))

        gep_ids = np.arange(1, result.spectra.shape[0] + 1)
        frames = {
            "consensus_spectra": pd.DataFrame(result.spectra, index=gep_ids,
                                              columns=spectra_columns),
            "consensus_usages": pd.DataFrame(result.usages,
                                             index=norm_counts.obs.index,
                                             columns=gep_ids),
            "gene_spectra_tpm": pd.DataFrame(result.spectra_tpm,
                                             index=gep_ids,
                                             columns=tpm.var.index),
            "gene_spectra_score": pd.DataFrame(result.spectra_score,
                                               index=gep_ids,
                                               columns=tpm.var.index),
        }
        self._write_results(frames, (k, dt_tag))

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
        if build_ref and solvers.async_writes_enabled():
            # queued behind the result files on the one FIFO writer, so the
            # TPM spectra text it reads back is on disk when it runs
            self._submit_pending_write(
                self.paths["starcat_spectra"] % (k, dt_tag),
                lambda: self.build_reference(k, density_threshold),
                extra_paths=(self.paths["starcat_spectra__txt"]
                             % (k, dt_tag),))
        elif build_ref:
            self.build_reference(k, density_threshold)

    def _write_results(self, frames, key_args):
        """Each frame of ``frames`` ({path key: frame}) as npz and text
        (cnmf_tpu/pipeline/cnmf.py:3571-3627): on the background writer
        under CNMF_TPU_ASYNC_WRITES=1, each npz frame memoized as pending
        (one the memo declines is written now: readers would go to the
        file), else from a pool of threads before returning."""
        writes = [(save, frame, self.paths[key + suffix] % key_args)
                  for key, frame in frames.items()
                  for save, suffix in ((save_df_to_npz, ""),
                                       (save_df_to_text, "__txt"))]
        if not solvers.async_writes_enabled():
            with ThreadPoolExecutor(max_workers=8) as pool:
                list(pool.map(lambda w: w[0](w[1], w[2]), writes))
            return
        for save, frame, path in writes:
            if save is save_df_to_npz:
                if not self._memo_artifact(path, frame, frame.values.nbytes,
                                           stat=self._PENDING_STAT):
                    save(frame, path)
                    continue

                def write_npz(frame=frame, path=path):
                    self._settle_artifact_stat(
                        path, frame, save_df_to_npz(frame, path))

                self._submit_pending_write(path, write_npz)
            else:
                self._submit_pending_write(
                    path, lambda save=save, frame=frame, path=path:
                    save(frame, path))

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

    def _k_stats_spectra_input(self, k):
        """The spectra one K of the k-stats sweep takes, and the merged
        frame or None (cnmf_tpu/pipeline/cnmf.py:3780-3813): the raw twin
        on the device where a same-process factorize left one and both
        ``device_spectra_enabled`` and ``device_kmeanspp_enabled`` apply
        (the device chain seeds its KMeans there), from a deferred merge's
        registration when the drain is still queued; else the merged
        spectra's host values (joining a queued merge)."""
        merged_path = self.paths["merged_spectra"] % k
        merged = self._recall_artifact(merged_path, copy=False)
        if (solvers.device_spectra_enabled(self.device)
                and solvers.device_kmeanspp_enabled(self.device)):
            if merged is None:
                meta = self._deferred_merged_meta(merged_path)
                if meta is not None and meta[3] is not None:
                    packed, off, rows = meta[3]
                    return packed[off:off + rows], None
            else:
                twin = self._device_spectra_twin(k, merged)
                if twin is not None:
                    return twin, merged
        if merged is None:
            self._flush_pending_write(merged_path)
            merged = self._recall_artifact(merged_path, copy=False)
            if merged is None:
                merged = load_df_from_npz(merged_path)
        return merged.values, merged

    @timed("k_selection_plot")
    def k_selection_plot(self, close_fig=False):
        """Stability (silhouette) vs reconstruction-error sweep over every K
        of the run (reference cnmf.py:1119-1158; Alexandrov et al. 2013):
        writes the ``k_selection_stats`` table and the ``k_selection_plot``
        figure and returns the table. Every K is queued before any is read;
        the held drains are released once all are read."""
        from cnmf_tpu_torch.pipeline.plots import k_selection_figure

        run_params = load_df_from_npz(self.paths["nmf_replicate_parameters"])
        self._autowarm()
        norm_counts = self._read_h5ad_cached(self.paths["normalized_counts"])
        nmf_kwargs = self._load_run_params()
        pending = [
            (int(k), *self._dispatch_k_stats(
                k, self._k_stats_spectra_input(k)[0], nmf_kwargs,
                norm_counts))
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
        through the txt formatting is part of the output. A pending write of
        that text is joined first."""
        dt_tag = str(density_threshold).replace(".", "_")
        self._flush_pending_write(
            self.paths["gene_spectra_tpm__txt"] % (k, dt_tag))
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
            self._flush_pending_write(self.paths[key] % (K, dt_tag))
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
