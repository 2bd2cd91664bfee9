"""Reused host buffers for prepare's large per-run temporaries, as
``cnmf_tpu.utils.arena``.

A second same-process prepare otherwise frees and re-faults its large
temporaries (the TPM's scale output, the float64 cast of the HVG counts,
the storage-dtype copy of an h5ad) as fresh pages, which a host faults far
slower than it rewrites warm ones. ``host_arena.take`` hands those passes a
reused buffer instead of a fresh allocation; the values are the same either
way.

Safety: a slot is reused only when nothing outside the arena references
it. Every numpy view holds a strong reference to its base buffer, and
``torch.from_numpy`` holds one to the array it wraps, so
``sys.getrefcount`` on the flat slot sees any outstanding consumer — the
h5ad read cache's AnnData, a writer thread's queued array, a tensor made
from it — and the arena allocates a fresh slot instead of aliasing. A
pageable ``torch.as_tensor(..., device="cuda")`` copies before it returns,
so a slot may be its source; a ``non_blocking`` upload may read after it
returns, so its source must stay referenced until the copy's event.
Thread-safe. Reuse is off unless ``CNMF_TPU_HOST_ARENA=1`` (the JAX
package's default is on): a process that prepares once gains nothing from
it and would keep up to ``_MAX_TOTAL_BYTES`` of host memory in the pool,
and no measured repeated prepare in one process shows the gain yet. A
free-threaded interpreter never reuses a slot.
"""

from __future__ import annotations

import os
import sys
import threading

import numpy as np

# below this, a fresh allocation is cheap and slot bookkeeping is noise
_MIN_BYTES = 16 << 20
# total resident cap across slots; beyond it the largest free slot is
# evicted (freeing it returns the pages to the allocator)
_MAX_TOTAL_BYTES = 6 << 30


def _enabled() -> bool:
    # a free-threaded interpreter defers refcounts, so a held slot could
    # measure free: no reuse there
    gil = getattr(sys, "_is_gil_enabled", lambda: True)()
    return gil and os.environ.get("CNMF_TPU_HOST_ARENA", "0") == "1"


class HostArena:
    """Refcount-guarded pool of flat byte buffers.

    ``take(shape, dtype)`` returns an uninitialized array of the requested
    shape backed by a reused slot when one is free, else by a fresh slot
    registered for reuse. The returned array is a view onto the slot; while
    any consumer holds it (or a view of it, or a tensor made from it), the
    slot's refcount is raised and the arena does not hand it out again.
    """

    def __init__(self, min_bytes: int = _MIN_BYTES,
                 max_total_bytes: int = _MAX_TOTAL_BYTES):
        self._slots: list[np.ndarray] = []
        self._lock = threading.Lock()
        self.min_bytes = int(min_bytes)
        self.max_total_bytes = int(max_total_bytes)
        self.hits = 0
        self.misses = 0

    # the refcount a free slot measures through _free's exact call shape
    # (list entry + loop binding + parameter + getrefcount's argument),
    # calibrated at import by _calibrate_free_refs(), so that a change of
    # the interpreter's refcount conventions moves the baseline with it
    _FREE_REFS = 0

    @staticmethod
    def _refs(slot: np.ndarray) -> int:
        return sys.getrefcount(slot)

    @staticmethod
    def _free(slot: np.ndarray) -> bool:
        # equality, not >=: a call site that binds differently measures
        # below the baseline and counts as held, the safe direction;
        # anything above it is an outstanding consumer
        return HostArena._refs(slot) == HostArena._FREE_REFS

    def take(self, shape, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        shape = tuple(int(s) for s in shape)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if nbytes < self.min_bytes or not _enabled():
            return np.empty(shape, dtype)
        with self._lock:
            # the smallest adequate free slot, so that a big slot is not
            # spent on a small request while a right-sized one sits idle
            best = None
            for slot in self._slots:
                if slot.nbytes >= nbytes and self._free(slot):
                    if best is None or slot.nbytes < best.nbytes:
                        best = slot
            if best is not None:
                self.hits += 1
                return best[:nbytes].view(dtype).reshape(shape)
            self.misses += 1
            slot = np.empty(nbytes, np.uint8)
            self._slots.append(slot)
            self._evict_over_cap()
            return slot.view(dtype).reshape(shape)

    def _evict_over_cap(self):
        total = sum(s.nbytes for s in self._slots)
        while total > self.max_total_bytes:
            free = [s for s in self._slots if self._free(s)]
            if not free:
                return
            victim = max(free, key=lambda s: s.nbytes)
            self._slots.remove(victim)
            total -= victim.nbytes

    def clear(self):
        """Drop every free slot (held ones stay until their consumers
        release them)."""
        with self._lock:
            self._slots = [s for s in self._slots if not self._free(s)]


def _calibrate_free_refs() -> int:
    """The refcount of a free slot measured through the call shape ``_free``
    uses: list entry + loop binding + one wrapper frame + ``_refs``'s
    parameter + getrefcount's argument."""
    def probe(slot: np.ndarray) -> int:
        return HostArena._refs(slot)

    slots = [np.empty(0, np.uint8)]
    for slot in slots:
        return probe(slot)
    raise AssertionError("unreachable")


HostArena._FREE_REFS = _calibrate_free_refs()

host_arena = HostArena()
