"""Per-stage timing and device profiling, as ``cnmf_tpu.utils.timing``.

Wall-clock stage timers collected into a process-wide registry (read with
``timings()``), printed to stderr when ``CNMF_TPU_TIMINGS=1``, and a
``torch.profiler`` trace of each stage under ``CNMF_TPU_PROFILE_DIR`` when
that is set. A stage whose device is CUDA ends with
``torch.cuda.synchronize()``, so its wall is the card's and not the time to
enqueue its work.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

_TIMINGS: Dict[str, List[float]] = defaultdict(list)


def timings_verbose() -> bool:
    """Whether stage walls are printed (``CNMF_TPU_TIMINGS=1``)."""
    return os.environ.get("CNMF_TPU_TIMINGS", "0") == "1"


def _synchronize(device) -> None:
    """Wait for a CUDA device's queued work (none is queued before CUDA is
    initialized: a host-only stage, or a machine without a card)."""
    if (device is not None and torch.device(device).type == "cuda"
            and torch.cuda.is_initialized()):
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage_timer(name: str, device=None):
    """Record the wall-clock of a pipeline stage on ``device`` (synchronized
    at the end when it is CUDA); print it when CNMF_TPU_TIMINGS=1."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _synchronize(device)
        dt = time.perf_counter() - t0
        _TIMINGS[name].append(dt)
        if timings_verbose():
            print(f"[cnmf-tpu timing] {name}: {dt:.3f}s", file=sys.stderr,
                  flush=True)


def sub_stage_marker(timings: Optional[dict]) -> Callable[[str], None]:
    """A ``mark(label)`` that records in ``timings`` (a dict; None records
    nothing) the seconds since the previous mark, or since the marker was
    made, under ``label``: consensus's sub-stages (``stages.
    consensus_arrays``). The step-by-step path marks density, kmeans,
    refit_usages, refit_spectra_tpm, ols and final_refit; the one-program
    path marks fused_consensus (after density, on the host, where its KMeans
    is seeded on the host), as cnmf_tpu/pipeline/cnmf.py:3427 does. Each
    mark follows host values, so no device work is left queued in it."""
    last = [time.perf_counter()]

    def mark(label: str) -> None:
        now = time.perf_counter()
        if timings is not None:
            timings[label] = now - last[0]
        last[0] = now

    return mark


def timings() -> Dict[str, List[float]]:
    """All recorded stage timings of this process (name → list of seconds)."""
    return dict(_TIMINGS)


def reset_timings() -> None:
    _TIMINGS.clear()


def timed(name: str):
    """Decorator: record the wrapped call as a stage (and profile it when
    CNMF_TPU_PROFILE_DIR is set). On a method, the stage's device is its
    object's ``device`` attribute."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            device = getattr(args[0], "device", None) if args else None
            if not isinstance(device, (str, torch.device)):
                device = None
            with stage_timer(name, device), profiler_trace(name, device):
                return fn(*args, **kwargs)

        return wrapper
    return deco


@contextlib.contextmanager
def profiler_trace(name: str = "trace", device=None):
    """A ``torch.profiler`` trace of the block (the CPU, and the card when
    ``device`` is CUDA), written as a Chrome trace under
    ``$CNMF_TPU_PROFILE_DIR/<name>/`` when that is set; a no-op otherwise."""
    profile_dir = os.environ.get("CNMF_TPU_PROFILE_DIR")
    if not profile_dir:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(
            os.path.join(profile_dir, name))):
        yield
        _synchronize(device)
