"""Compact TPM upload: ship the integer counts, scale the rows on the device.

Consensus wants the full-gene TPM dense on the device (108 MB at PBMC-3k
scale in float32, GBs at atlas scale). The TPM is ``counts · (target_sum /
row_sum)``, and raw scRNA counts are small non-negative integers: when they
fit uint8 or int16, the integer matrix and a per-cell scale vector cross the
bus in 2-4× fewer bytes and the float expansion is one cast-and-multiply on
the device (``tpm_from_counts``), as in ``cnmf_tpu.ops.device_tpm``. The
factorize input (the unit-variance HVG counts) comes from the same image
(``norm_from_counts``, ``derive_norm_and_tpm``). Integers are exact in
float32, so the device value is ``f32(count) · f32(scale)`` against the
host's ``f32(f64 count · f64 scale)``: equal to ≤ 2 ulp, far inside the
pipeline's 1e-4 artifact tolerance. ``CNMF_TPU_DEVICE_TPM=0`` keeps the
float upload.

The image is mostly zeros on real counts, so it may also cross as CSR
components scattered into the dense image on the device
(``upload_int_image``; ``CNMF_TPU_CSR_UPLOAD``): a CSR has no duplicate
(row, col), so the scatter writes each position once and the image is
bit-identical to the dense upload.

``prefetch`` uploads and expands on a side CUDA stream from a host thread,
so the transfer overlaps the factorize that runs before consensus.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

# the host-side stash lives on the cNMF object between prepare and
# factorize (same-process pipelines only): keep it bounded
_MAX_STASH_BYTES = int(2.5e8)


def compact_integer_counts(X) -> np.ndarray | None:
    """Smallest-integer-dtype copy of a dense counts matrix, or None.

    Returns a uint8 (max ≤ 255) or int16 (max ≤ 32767) array whose values
    equal ``X`` exactly; None when X is not a dense ndarray of non-negative
    integral values in range, or when the compact copy would exceed the
    stash budget. An input already at the compact dtype is aliased as a
    read-only view (the stash's values must never change after prepare)."""
    if not isinstance(X, np.ndarray) or X.ndim != 2:
        return None
    if X.dtype.kind not in "fiu":
        return None
    mx = X.max() if X.size else 0
    mn = X.min() if X.size else 0
    if not (np.isfinite(mx) and np.isfinite(mn)) or mn < 0:
        return None
    if mx <= 255:
        dtype = np.uint8
    elif mx <= 32767:
        dtype = np.int16
    else:
        return None
    if X.size * np.dtype(dtype).itemsize > _MAX_STASH_BYTES:
        return None
    if X.dtype == np.dtype(dtype):
        ints = X.view()
        ints.setflags(write=False)
    else:
        ints = X.astype(dtype)
    if X.dtype.kind == "f" and not np.array_equal(ints, X):
        return None  # non-integral values
    return ints


def tpm_row_scale(X, target_sum: float = 1e6) -> np.ndarray:
    """Per-cell TPM scale ``target_sum / row_sum`` (float64), zero-sum rows
    through a safe denominator, as ``ops.normalize.normalize_total``'s dense
    branch, whose product this scale reproduces on the device."""
    totals = np.asarray(X).sum(axis=1, dtype=np.float64)
    safe = np.where(totals == 0, 1.0, totals)
    return target_sum / safe


def tpm_from_counts(ints, scale):
    """Dense TPM at ``scale.dtype`` from integer counts: one cast and
    broadcast multiply. ``ints`` and ``scale`` may be row ``Shards`` of the
    same layout (``parallel.mesh.put_int_image_cells``)."""
    from cnmf_tpu_torch.parallel.mesh import Shards

    if isinstance(ints, Shards):
        return Shards([tpm_from_counts(i, s)
                       for i, s in zip(ints.parts, scale.parts)],
                      ints.n_rows)
    return ints.to(scale.dtype) * scale[:, None]


def device_tpm_from_counts(ints: np.ndarray, scale: np.ndarray,
                           device="cuda"):
    """Upload the compact integer counts and the per-cell scale and expand
    to the dense TPM on ``device``; ``scale``'s dtype is the output's."""
    return tpm_from_counts(torch.as_tensor(ints, device=device),
                           torch.as_tensor(scale, device=device))


def norm_column_spec(counts_var_index, hvg_index, ints, dtype, std=None):
    """(cols int64, std) mapping the HVG subset into the integer counts for
    ``norm_from_counts``, or None when the gene names do not map uniquely or
    the per-gene std is degenerate.

    ``std`` is the dense branch of ``ops.normalize.scale_unit_variance``
    (ddof=1, no zero guard — reference cnmf.py:542 divides unguarded) over
    the float64 subset counts, the divisor prepare's norm_counts used (the
    integer image equals the counts bit for bit). A caller that holds that
    divisor passes it: a few sampled columns are recomputed from the image
    to check its column order."""
    if not counts_var_index.is_unique:
        return None
    cols = counts_var_index.get_indexer(hvg_index)
    if (cols < 0).any():
        return None
    cols = cols.astype(np.int64)
    if std is None:
        std = ints[:, cols].astype(np.float64).std(axis=0, ddof=1)
    else:
        std_arr = np.asarray(std, dtype=np.float64)
        if std_arr.shape == cols.shape and len(cols):
            probe = np.unique(
                np.linspace(0, len(cols) - 1, num=min(3, len(cols)), dtype=int)
            )
            ref = ints[:, cols[probe]].astype(np.float64).std(axis=0, ddof=1)
            if not np.allclose(ref, std_arr[probe], rtol=1e-9, atol=0.0):
                return None  # misaligned divisor: keep the float path
    std = np.asarray(std, dtype=np.float64)
    if std.shape != cols.shape or not np.isfinite(std).all() or (std == 0).any():
        return None  # degenerate genes: keep the float path
    return cols, std.astype(dtype)


# the nnz bucket of the JAX package's CSR upload: its byte gate below counts
# the padded components, so both packages take the same decision
_CSR_NNZ_BUCKET = 1 << 19


def int_image_csr(ints: np.ndarray):
    """CSR components ``(data, cols, indptr)`` of a dense integer image, the
    columns int16 where the gene axis fits, or None when they would not move
    under half the dense bytes (the JAX package's gate, cnmf_tpu/ops/
    device_tpm.py:167-198, nnz padded to its bucket)."""
    n, g = ints.shape
    nnz = int(np.count_nonzero(ints))
    col_dtype = np.int16 if g <= np.iinfo(np.int16).max else np.int32
    padded = nnz + ((-nnz) % _CSR_NNZ_BUCKET)
    csr_bytes = (
        padded * (ints.dtype.itemsize + np.dtype(col_dtype).itemsize)
        + (n + 1) * 4
    )
    if csr_bytes >= 0.5 * ints.nbytes:
        return None
    return csr_components(ints)


def csr_components(ints: np.ndarray):
    """``(data, cols, indptr)`` of a dense integer image in row-major
    order, without ``int_image_csr``'s byte gate."""
    g = ints.shape[1]
    col_dtype = np.int16 if g <= np.iinfo(np.int16).max else np.int32
    flat = np.flatnonzero(ints.ravel())
    data = ints.ravel()[flat]
    cols = (flat % g).astype(col_dtype)
    indptr = np.zeros(ints.shape[0] + 1, dtype=np.int32)
    indptr[1:] = np.cumsum(np.bincount(flat // g, minlength=ints.shape[0]))
    return data, cols, indptr


def _densify_int_csr(data, cols, indptr, n_rows: int, n_cols: int):
    """The dense integer image of CSR components on their device: each
    entry's row from the row lengths (int32), its flat position, one
    ``index_copy_`` (no accumulation: positions are unique, and the integer
    types need no atomic add)."""
    dev = data.device
    lengths = (indptr[1:] - indptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(n_rows, dtype=torch.int32, device=dev), lengths,
        output_size=data.shape[0])
    flat = rows.long() * n_cols + cols.long()
    dense = torch.zeros(n_rows * n_cols, dtype=data.dtype, device=dev)
    dense.index_copy_(0, flat, data)
    return dense.view(n_rows, n_cols)


def csr_upload_enabled(device=None) -> bool:
    """The CNMF_TPU_CSR_UPLOAD knob: '1' (default) on a CUDA card only (on
    the CPU there is no bus to save), 'force' anywhere, '0' off."""
    env = os.environ.get("CNMF_TPU_CSR_UPLOAD", "1")
    if env == "force":
        return True
    if device is None:
        return env == "1" and torch.cuda.is_available()
    return env == "1" and torch.device(device).type == "cuda"


# "no pre-built components: compute them here if enabled"; an explicit None
# means an earlier int_image_csr found no byte win
_COMPUTE_CSR = object()


def _put(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def upload_int_image(ints: np.ndarray, csr=_COMPUTE_CSR, device="cuda"):
    """A dense copy of ``ints`` on ``device``, through CSR components when
    that moves fewer bytes (``csr_upload_enabled``), else the dense
    transfer. Returns ``(tensor, bytes moved)``; the tensor equals
    ``torch.as_tensor(ints)`` bit for bit either way."""
    if csr is _COMPUTE_CSR:
        csr = int_image_csr(ints) if csr_upload_enabled(device) else None
    if csr is not None and csr_upload_enabled(device):
        data, cols, indptr = csr
        dense = _densify_int_csr(_put(data, device), _put(cols, device),
                                 _put(indptr, device), int(ints.shape[0]),
                                 int(ints.shape[1]))
        return dense, data.nbytes + cols.nbytes + indptr.nbytes
    return _put(ints, device), ints.nbytes


def norm_from_counts(ints, cols, std):
    """The factorize input (unit-variance HVG counts) from the integer
    counts on the device: the HVG columns, cast to ``std.dtype``, divided by
    the per-gene std; against the host's float64 pipeline, both round the
    true quotient to the compute dtype (≤ 2 ulp)."""
    return ints.index_select(1, cols).to(std.dtype) / std[None, :]


def derive_norm_and_tpm(ints, cols, std, scale):
    """The factorize input and the consensus TPM from the one integer image
    on the device, each the same ops as ``norm_from_counts`` and
    ``tpm_from_counts`` (so bit-identical to them)."""
    return norm_from_counts(ints, cols, std), tpm_from_counts(ints, scale)


class SideStreamTask:
    """``fn()`` run on a host thread, its device work queued on a side CUDA
    stream of ``device`` that starts after the work the caller's stream
    holds when the task is made. On the CPU ``fn`` runs at once in the
    caller's thread: there is no bus to overlap, and torch's CPU ops in a
    second thread contend with the caller's for the cores. ``join()`` waits
    for the thread, makes the caller's stream wait for the side stream's
    work and marks the result tensors as used on it (so the caching
    allocator keeps them), re-raises the thread's error, and returns fn's
    result."""

    def __init__(self, fn, device):
        self.device = torch.device(device)
        self._fn = fn
        self._result = self._error = self._event = None
        self._stream = self._start = self._thread = None
        if self.device.type != "cuda":
            self._run()
            return
        self._stream = torch.cuda.Stream(self.device)
        self._start = torch.cuda.Event()
        self._start.record(torch.cuda.current_stream(self.device))
        self._thread = threading.Thread(target=self._run,
                                        name="cnmf-tpu-side-stream")
        self._thread.start()

    def _run(self):
        try:
            if self._stream is None:
                self._result = self._fn()
                return
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._stream):
                self._stream.wait_event(self._start)
                self._result = self._fn()
                self._event = torch.cuda.Event()
                self._event.record(self._stream)
        except BaseException as exc:   # re-raised by join
            self._error = exc

    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def join(self):
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error
        if self._event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(self._event)
            for t in _tensors(self._result):
                if t.device.type == "cuda":
                    t.record_stream(current)
        return self._result


def _tensors(obj):
    """The tensors in a result: a tensor, ``Shards``, or tuples of them."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    parts = getattr(obj, "parts", None)
    return list(parts) if parts is not None else []


def prefetch(ints: np.ndarray, scale: np.ndarray, device="cuda",
             csr=_COMPUTE_CSR, devices=None, ints_dev=None) -> SideStreamTask:
    """Upload the integer image and the scale and expand the TPM on a side
    stream of ``device`` from a host thread (``SideStreamTask``):
    ``.join()`` returns ``(tpm, bytes moved)``. ``devices``: several
    devices to lay the cells over (``parallel.mesh.put_int_image_cells``:
    the TPM as row ``Shards``, its padded rows zero); ``ints_dev``: the
    image already on ``device`` (factorize uploaded it), which is then
    expanded with no bulk transfer; ``csr``: pre-built CSR components
    (``int_image_csr``) for the single-device upload."""

    def run():
        if devices is not None:
            from cnmf_tpu_torch.parallel.mesh import put_int_image_cells

            i_sh, s_sh = put_int_image_cells(ints, scale, devices)
            return tpm_from_counts(i_sh, s_sh), ints.nbytes + scale.nbytes
        if ints_dev is not None:
            if ints_dev.device.type == "cuda":
                ints_dev.record_stream(torch.cuda.current_stream())
            image, nbytes = ints_dev, 0
        else:
            image, nbytes = upload_int_image(ints, csr, device)
        return (tpm_from_counts(image, _put(scale, device)),
                nbytes + scale.nbytes)

    return SideStreamTask(run, device)
