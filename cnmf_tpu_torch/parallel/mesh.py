"""Device mesh and row-shard layout for the restarts × cells grid.

The counterpart of ``cnmf_tpu/parallel/mesh.py``, in one process over a list
of ``torch.device``s (the JAX package is single-controller too: one process
drives every local device). The grid has two axes:

* ``restart``: embarrassingly parallel NMF restarts. Each restart group
  solves its share of the batch on a replica of X; no sums cross groups.
* ``cell``: X's rows (and W's) are split over the group's devices. The
  H-side products (XᵀW, WᵀW) and the stop rule's violation become sums
  over shards (``parallel.collectives.sum_shards``).

A sharded matrix is a ``Shards``: one tensor of rows per device, zero rows
appended after the real ones so that every shard has the same row count
(the JAX package's even shards). A device may appear more than once in a
mesh: two shards on one card run the sharded code paths where only one
card exists, as the JAX tests' virtual devices do on one CPU.
"""

from __future__ import annotations

import os
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def local_devices() -> List[torch.device]:
    """Every visible CUDA card, ``cuda:0`` .. ``cuda:n-1`` (empty without
    one): the default device list of a mesh."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _checked(devices) -> List[torch.device]:
    """``devices`` as torch devices, raising for a CUDA device that cannot
    be reached."""
    out = [torch.device(d) for d in devices]
    if not out:
        raise RuntimeError("a mesh needs at least one device, and no CUDA "
                           "device is visible")
    for d in out:
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh device {d}: no CUDA device is "
                                   "available")
            if d.index is not None and d.index >= torch.cuda.device_count():
                raise RuntimeError(
                    f"mesh device {d}: only {torch.cuda.device_count()} CUDA "
                    "devices are visible")
    return out


class Mesh:
    """A (restart, cell) grid of torch devices: ``devices[r][c]``."""

    axis_names = ("restart", "cell")

    def __init__(self, devices: Sequence[Sequence]):
        self.devices = [list(row) for row in devices]
        self.shape = {"restart": len(self.devices),
                      "cell": len(self.devices[0])}
        self._placed = None

    @property
    def size(self) -> int:
        return self.shape["restart"] * self.shape["cell"]

    def flat_devices(self) -> List[torch.device]:
        return [d for row in self.devices for d in row]

    def place_data(self, X) -> list:
        """X for each restart group: a replica on the group's device
        (``cell`` 1) or ``Shards`` of its rows over the group's devices.
        The last placement is kept (keyed by X), so a K sweep places X
        once."""
        if self._placed is not None and self._placed[0]() is X:
            return self._placed[1]
        if self.shape["cell"] == 1:
            placed = [_as_tensor(X, row[0]) for row in self.devices]
        else:
            placed = [split_rows(X, row) for row in self.devices]
        try:
            self._placed = (weakref.ref(X), placed)
        except TypeError:   # a numpy array cannot be weakly referenced
            self._placed = None
        return placed

    def __repr__(self):
        return f"Mesh({self.shape}, {self.devices})"


def build_mesh(devices: Optional[Sequence] = None,
               cell_axis: Optional[int] = None) -> Mesh:
    """Mesh over every local device (or the given ones) with axes
    (restart, cell).

    ``cell_axis`` devices of each row shard the cell dimension; the rest
    shard restarts. Default: the ``CNMF_TPU_CELL_AXIS`` knob (1 when unset or
    malformed: restart-only, the right layout whenever X fits each device).
    Raises when the device count is not divisible by ``cell_axis`` or a CUDA
    device cannot be reached."""
    if cell_axis is None:
        raw = os.environ.get("CNMF_TPU_CELL_AXIS", "1")
        try:
            cell_axis = max(1, int(raw))
        except ValueError:
            cell_axis = 1
    devices = _checked(local_devices() if devices is None else devices)
    n = len(devices)
    if n % cell_axis != 0:
        raise ValueError(f"{n} devices not divisible by cell_axis={cell_axis}")
    return Mesh([devices[r * cell_axis:(r + 1) * cell_axis]
                 for r in range(n // cell_axis)])


class Shards:
    """One matrix split along ``axis`` over devices: ``parts[i]`` holds rows
    [i·r, (i+1)·r) on its own device, r the same for every part; the first
    ``n_rows`` rows are real and the rest zeros.

    ``shape`` is the real (unpadded) shape, what a regularization scaling or
    a mean divides by; ``padded_rows`` counts the padding too. For a factor
    (B, rows, K) the axis is 1, and ``W[b]`` gives restart b's (rows, K)
    shards. ``T`` is the transpose of a 2-D matrix: its columns in shards."""

    def __init__(self, parts: Sequence[torch.Tensor], n_rows: int,
                 axis: int = 0):
        self.parts = list(parts)
        self.n_rows = int(n_rows)
        self.axis = axis

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self.parts]

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def ndim(self) -> int:
        return self.parts[0].ndim

    @property
    def rows_per_part(self) -> int:
        return self.parts[0].shape[self.axis]

    @property
    def padded_rows(self) -> int:
        return self.rows_per_part * len(self.parts)

    @property
    def shape(self) -> Tuple[int, ...]:
        shape = list(self.parts[0].shape)
        shape[self.axis] = self.n_rows
        return tuple(shape)

    def element_size(self) -> int:
        return self.parts[0].element_size()

    def real_rows(self, i: int) -> int:
        """Real (non-padding) rows of part i."""
        r = self.rows_per_part
        return max(0, min(r, self.n_rows - i * r))

    def map(self, fn, axis: Optional[int] = None) -> "Shards":
        """``fn`` applied to every part, the layout kept (or the shard axis
        moved to ``axis``)."""
        return Shards([fn(p) for p in self.parts], self.n_rows,
                      self.axis if axis is None else axis)

    def __getitem__(self, b: int) -> "Shards":
        if self.axis == 0 or not isinstance(b, int):
            raise TypeError("Shards index the restart axis of a factor only")
        return self.map(lambda p: p[b], axis=self.axis - 1)

    @property
    def T(self) -> "Shards":
        if self.ndim != 2:
            raise ValueError("Shards.T: 2-D matrices only")
        return self.map(lambda p: p.T, axis=1 - self.axis)

    def __repr__(self):
        return (f"Shards({len(self.parts)} parts of {tuple(self.parts[0].shape)}"
                f", axis {self.axis}, {self.n_rows} real rows)")


def _as_tensor(arr, device) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    return torch.as_tensor(np.ascontiguousarray(arr), device=device)


def shard_bounds(n_rows: int, n_parts: int) -> List[Tuple[int, int, int]]:
    """(start, stop, rows a part) of each part's real rows when ``n_rows``
    are zero-padded to a multiple of ``n_parts`` and split evenly."""
    r = -(-n_rows // n_parts)
    return [(min(i * r, n_rows), min((i + 1) * r, n_rows), r)
            for i in range(n_parts)]


def split_rows(arr, devices: Sequence, axis: int = 0) -> Shards:
    """``arr`` (numpy or tensor) split along ``axis`` over ``devices``, zero
    rows appended to the last parts so that every part has the same count."""
    n = arr.shape[axis]
    parts = []
    for (start, stop, r), dev in zip(shard_bounds(n, len(devices)), devices):
        part = _as_tensor(_take(arr, start, stop, axis), dev)
        if stop - start < r:
            shape = list(part.shape)
            shape[axis] = r - (stop - start)
            part = torch.cat([part, part.new_zeros(shape)], dim=axis)
        parts.append(part)
    return Shards(parts, n, axis)


def _take(arr, start, stop, axis):
    index = [slice(None)] * arr.ndim
    index[axis] = slice(start, stop)
    return arr[tuple(index)]


def shard_like(arr, like: Shards, axis: int = 0) -> Shards:
    """``arr`` split along ``axis`` with the row layout of ``like`` (its
    devices, its real and padded row counts)."""
    if arr.shape[axis] != like.n_rows:
        raise ValueError(f"shard_like: {arr.shape[axis]} rows against "
                         f"{like.n_rows}")
    return split_rows(arr, like.devices, axis)


def cell_sharding(ndim: int = 2, devices: Optional[Sequence] = None):
    """The consensus-stage layout: a 1-D cell mesh over every device (dim 0,
    the cells, split over all of them), or None with fewer than two
    devices. ``ndim`` is accepted for the JAX package's API; the layout
    does not depend on it."""
    devices = local_devices() if devices is None else list(devices)
    if len(devices) < 2:
        return None
    return build_mesh(devices, cell_axis=len(devices))


def put_cells(arr, devices: Optional[Sequence] = None):
    """Upload with dim 0 split over every device, zero-padding dim 0 to the
    device-count multiple: returns ``Shards`` carrying the real row count.

    Zero rows are exactly neutral in every consensus-stage consumer: the
    NNLS refits keep the matching usage rows at 0, gram and OLS sums receive
    zero terms, and means and variances divide by the real row count.
    With a single device this is a plain upload, unpadded."""
    mesh = cell_sharding(np.ndim(arr), devices)
    if mesh is None:
        devices = _checked(local_devices() if devices is None else devices)
        return _as_tensor(arr, devices[0])
    return split_rows(arr, mesh.flat_devices())


def put_int_image_cells(ints: np.ndarray, scale: np.ndarray,
                        devices: Sequence) -> Tuple[Shards, Shards]:
    """The compact integer counts (cells × genes) and their per-cell TPM
    scale laid out as ``put_cells`` lays the TPM over ``devices`` (the JAX
    package's sharded prefetch, cnmf_tpu/pipeline/cnmf.py:749-775): zero
    rows pad the image and ones the scale, so the padded rows expand to
    zero TPM rows, which every consensus consumer treats as neutral.
    Returns (image ``Shards``, scale ``Shards``)."""
    n = ints.shape[0]
    images, scales = [], []
    for (start, stop, r), dev in zip(shard_bounds(n, len(devices)), devices):
        pad = r - (stop - start)
        images.append(_as_tensor(np.pad(ints[start:stop], ((0, pad), (0, 0))),
                                 dev))
        scales.append(_as_tensor(np.pad(scale[start:stop], (0, pad),
                                        constant_values=1), dev))
    return Shards(images, n), Shards(scales, n)


def pad_to_multiple(arr: np.ndarray, multiple: int,
                    axis: int = 0) -> Tuple[np.ndarray, int]:
    """Pad along ``axis`` (repeating the first slice) to a multiple; returns
    (padded, original_length)."""
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr, n
    first = np.take(arr, [0] * pad, axis=axis)
    return np.concatenate([arr, first], axis=axis), n


def shard_factorize_inputs(mesh: Mesh, X, W0, Ht0):
    """Place factorize inputs on the mesh, one entry per restart group: X
    replicated over restarts and split over cells (``Mesh.place_data``); W0
    (B, N, K) split over restarts and its rows over cells (zero rows for
    padded cells); Ht0 (B, G, K) split over restarts, on the group's first
    device. B must be a multiple of the restart axis (``pad_to_multiple``).
    Factors take X's dtype."""
    n_groups = mesh.shape["restart"]
    if W0.shape[0] % n_groups:
        raise ValueError(f"{W0.shape[0]} restarts over {n_groups} restart "
                         "shards: pad them first (pad_to_multiple)")
    Xs = mesh.place_data(X)
    dtype = Xs[0].dtype
    b = W0.shape[0] // n_groups
    W0s, Ht0s = [], []
    for r, row in enumerate(mesh.devices):
        W_r = W0[r * b:(r + 1) * b]
        Ht_r = _as_tensor(Ht0[r * b:(r + 1) * b], row[0]).to(dtype)
        if mesh.shape["cell"] == 1:
            W0s.append(_as_tensor(W_r, row[0]).to(dtype).contiguous())
        else:
            W0s.append(split_rows(W_r, row, axis=1).map(
                lambda p: p.to(dtype).contiguous()))
        Ht0s.append(Ht_r.contiguous())
    return Xs, W0s, Ht0s
