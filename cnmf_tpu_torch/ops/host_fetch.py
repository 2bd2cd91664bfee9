"""One device-to-host copy that the caller waits for only when it reads
the bytes: the hand-off of a solve's results (``pipeline/stages.py``) and
the host reads of the tail-compacting CD schedulers (``ops/nmf.py``)."""

from __future__ import annotations

import numpy as np
import torch


class HostFetch:
    """One device-to-host copy of ``src``, started at construction
    (cnmf_tpu/pipeline/cnmf.py:1627-1670, 1985, 2005). On a CUDA tensor: an
    event recorded on the current stream, the one the solves ran on, gates
    a copy on a side stream into pinned host memory (``non_blocking``).
    ``src`` is marked as used on the side stream and held by this object,
    so that the caching allocator cannot give its memory to a later solve
    while the copy reads it. ``wait()``, from any thread, waits for the
    copy's event and returns the host array, a numpy view that keeps the
    pinned buffer alive. On the CPU the host array is the tensor's own
    memory."""

    def __init__(self, src: torch.Tensor):
        self.src = src
        self._done = None
        if src.device.type != "cuda":
            self._host = src.contiguous().numpy()
            return
        with torch.cuda.device(src.device):
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(src.device))
            side = torch.cuda.Stream(src.device)
            side.wait_event(ready)
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            with torch.cuda.stream(side):
                host.copy_(src, non_blocking=True)
            src.record_stream(side)
            self._done = torch.cuda.Event()
            self._done.record(side)
        self._host = host.numpy()

    def wait(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host
