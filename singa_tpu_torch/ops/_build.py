"""Build and bind the hand-written CUDA kernels in `singa_tpu_torch/csrc`.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first
use by `nvcc` for `sm_90a` into a shared library under `.kernel_build/`
beside the package (the directory is git-ignored), then loaded with
`ctypes`. The library's file name carries a hash of the sources, so an
edited kernel is rebuilt and an unchanged one is loaded as it is.
`build_all()` starts one `nvcc` per source at once and waits for all.

Nothing here runs at import: the CPU tests import every module on a
machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), ".kernel_build")
SOURCES = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_decode", "paged_attention")
#: sources of diagnostics, built only by `lib()` when their tool runs
#: (`ops/wgmma_probe.py`), never by `build_all()`
DIAGNOSTICS = ("wgmma_probe",)
#: --split-compile=0 lets nvcc spread one source's kernels over the cores
#: (the decode sources instantiate six kernels each): 12.3 s against
#: 21.1 s for the slowest of three sources built together on the H100
#: host (nvcc 12.9)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

_lock = threading.Lock()
_libs: "dict[str, ctypes.CDLL]" = {}
#: per source: nvcc's ptxas report (registers, shared memory, spills)
BUILD_LOG: "dict[str, str]" = {}
#: per source built in this process: seconds from nvcc's start to its end
BUILD_SECONDS: "dict[str, float]" = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc (PATH or /usr/local/cuda)")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (path, tmp path, process or None, start time)."""
    path = _lib_path(name)
    if os.path.exists(path):
        return path, None, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return path, tmp, proc, t0


def _finish(name: str, path: str, tmp, proc, t0) -> ctypes.CDLL:
    if proc is not None:
        out, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, path)
    return ctypes.CDLL(path)


def build_all() -> None:
    """Build every kernel library, one nvcc per source, all in parallel."""
    with _lock:
        started = [(n, *_start(n)) for n in SOURCES if n not in _libs]
        if not started:
            return
        # one waiting thread per nvcc, so each source's time is its own
        with ThreadPoolExecutor(len(started)) as ex:
            built = list(ex.map(lambda a: _finish(*a), started))
        for (n, *_), so in zip(started, built):
            _libs[n] = so


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = _finish(name, *_start(name))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


__all__ = ["BUILD_DIR", "BUILD_LOG", "BUILD_SECONDS", "DIAGNOSTICS", "SOURCES",
           "build_all", "check", "lib"]
