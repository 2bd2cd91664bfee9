"""The one shared library of the hand-written CUDA kernels, and the checks
every kernel wrapper makes before it launches.

``load_library`` builds every ``csrc/*.cu`` at first use with ``nvcc`` (one
compiler process per source, all started together, then one link) into
``_build/`` inside the package (or the user's cache directory where the
package's is not writable, ``build_dir``), keyed by a hash of the flags and
of every source and header, and loads it with ctypes. ``ops/cd_kernels.py`` and
``ops/mu_kernels.py`` call their own symbols of it through
``kernel_function`` and ``library_constant``, which bind each symbol and
read each constant once. Importing this module needs neither ``nvcc`` nor a
GPU, and nothing is built for CPU tensors. ``start_build`` starts the build
on a background thread (the autowarm of ``cNMF.factorize`` and
``k_selection_plot``), so that it overlaps host work before the first
launch; ``load_library`` then waits for that build and raises its error.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
import time
from concurrent.futures import Future

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

VP, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: nvcc is needed to build "
                           "the kernels of cnmf_tpu_torch/csrc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build(sources, so_path):
    """Compile each .cu to an object in parallel, then link the shared
    library. The compilers' output (``-Xptxas -v``: registers, shared
    memory and spills per kernel) goes to ``so_path + '.log'``."""
    import subprocess

    nvcc = _nvcc()
    tmp = f"{so_path}.{os.getpid()}"
    jobs = []
    for src in sources:
        if src.endswith(".cu"):
            obj = f"{tmp}.{os.path.basename(src)}.o"
            jobs.append((obj, subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
    log, failed = [], False
    for obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        failed |= proc.returncode != 0
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", f"{tmp}.so", *[o for o, _ in jobs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(link.stdout)
        failed = link.returncode != 0
    for obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(so_path + ".log", "w") as fh:
        fh.write("".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "".join(log))
    os.replace(f"{tmp}.so", so_path)


def _sources():
    return sorted(
        os.path.join(_CSRC_DIR, f) for f in os.listdir(_CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _writable_dir(path) -> bool:
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return False
    return os.access(path, os.W_OK | os.X_OK)


def build_dir() -> str:
    """Where the library is built: ``_build/`` inside the package, or, where
    that cannot be created or written (a read-only install), the user's
    cache directory (``$XDG_CACHE_HOME`` or ``~/.cache``) under
    ``cnmf_tpu_torch/``."""
    if _writable_dir(_BUILD_DIR):
        return _BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    path = os.path.join(cache, "cnmf_tpu_torch")
    os.makedirs(path, exist_ok=True)
    return path


def library_path() -> str:
    """The library's file, named by a hash of the flags and of every source
    and header of ``csrc/``."""
    import hashlib

    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in _sources():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(build_dir(),
                        f"libcnmf_kernels_{digest.hexdigest()[:16]}.so")


# a mesh's restart groups may reach their first launch at once, each on its
# own host thread: one of them builds
_LOAD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (once per source hash) and load the kernels of ``csrc/``.
    Never runs while a module is imported. Where ``start_build`` has started
    the build, wait for it: its library, or the very error it raised (an
    error is not cached, so every call raises it)."""
    build = _WARM.get("build")
    if build is not None:
        return build.result()
    return _load_library()


# the background build of ``start_build``: its future and its start and
# end (time.perf_counter)
_WARM = {}
_WARM_LOCK = threading.Lock()


def start_build() -> Future:
    """Start ``load_library``'s build on a background thread, once per
    process, and return its future (the one already started, on a later
    call). ``warm_times()`` then reads when it started and ended."""
    with _WARM_LOCK:
        build = _WARM.get("build")
        if build is None:
            build = _WARM["build"] = Future()
            _WARM["started"] = time.perf_counter()
            threading.Thread(target=_warm_build, args=(build,),
                             name="cnmf-kernel-build").start()
    return build


def _warm_build(build: Future):
    try:
        lib = _load_library()
    except BaseException as exc:   # raised again by every load_library()
        _WARM["ended"] = time.perf_counter()
        build.set_exception(exc)
        return
    _WARM["ended"] = time.perf_counter()
    build.set_result(lib)


def warm_times():
    """(started, ended) of ``start_build``'s build in ``time.perf_counter``
    seconds, None for what has not happened."""
    return _WARM.get("started"), _WARM.get("ended")


@functools.lru_cache(maxsize=None)
def _load_library():
    so_path = library_path()
    with _LOAD_LOCK:
        if not os.path.exists(so_path):
            _build(_sources(), so_path)
    lib = ctypes.CDLL(so_path)
    lib.so_path = so_path
    return lib


@functools.lru_cache(maxsize=None)
def kernel_function(name: str, argtypes: tuple):
    """The library's C function ``name``, bound once with its argument types
    declared and an int result (a CUDA error code or a constant)."""
    fn = getattr(load_library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = I32
    return fn


@functools.lru_cache(maxsize=None)
def library_constant(name: str, *args: int) -> int:
    """An int the library fixes at compile time (the rows one block owns),
    read once per argument."""
    return kernel_function(name, (I32,) * len(args))(*args)


# ----------------------------------------------------------------------
# the checks of every wrapper
# ----------------------------------------------------------------------

def device_kind(name, t) -> str:
    """'cpu' (the plain version runs) or 'cuda' (the kernel launches)."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return kind


def check_cuda(name, *tensors, strided=()):
    """All tensors on one device and float32; ``tensors`` contiguous and
    16-byte aligned (the kernels move rows as float4), ``strided`` with any
    positive strides (the kernels take X's strides as arguments)."""
    dev = tensors[0].device
    for t in (*tensors, *strided):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(
                f"{name}: the CUDA kernel takes float32, got {t.dtype} "
                "(compute_dtype=float64 runs on the CPU only)"
            )
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data must be 16-byte aligned")
    for t in strided:
        if min(t.stride()) < 1:
            raise ValueError(f"{name}: strides {t.stride()} must be positive")


def check_k(name, K: int):
    """K a positive multiple of 8 (the solvers zero-pad K to one): 8..64
    run the register kernels, any larger multiple their wide variants."""
    if K % 8 or K < 8:
        raise ValueError(
            f"{name}: K={K} has no kernel; K must be a positive multiple of 8 "
            "(the solvers zero-pad K to one)"
        )


def raise_on(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")


def stream_handle(device) -> int:
    """The raw handle of ``device``'s current CUDA stream, read with torch's
    own accessor and without building a ``torch.cuda.Stream``, which costs a
    refit's wrapper a few microseconds a call."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def launch(name, fn, t, *args):
    """``fn(*args, stream)`` into the current stream of ``t``'s device, with
    that device current (a kernel launches only into a stream of the
    current device, and a mesh's thread holds tensors of several cards);
    raises on a launch error."""
    stream = stream_handle(t.device)
    if t.device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(t.device):
            rc = fn(*args, stream)
    raise_on(name, rc)
