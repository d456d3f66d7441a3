"""Build and bind the hand-written CUDA kernels in `singa_tpu_torch/csrc`.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first
use by `nvcc` for `sm_90a` into a shared library, then loaded with
`ctypes`. The library is named by a hash of the sources and the flags
(its fingerprint), so an edited kernel is rebuilt and an unchanged one is
loaded as it is. `build_all()` starts one `nvcc` per source at once and
waits for all.

Where the library lives depends on the warm store (`warmstart`):

- disabled (the default): under `.kernel_build/` beside the package (the
  directory is git-ignored), as `lib<name>-<fingerprint>.so`;
- enabled: in the store, key `kernel.<name>`. Each load first looks the
  entry up inside the span `introspect.warm_load`: a hit is verified
  (sha-256, torch and CUDA versions, the card's compute capability) and
  loaded where it lies; a miss, a stale or a corrupt entry runs `nvcc`
  into the store and exports the library with its meta. A bad entry is
  always rebuilt by `nvcc`, never replaced by a kernel's plain version.

Each nvcc build runs inside the span `introspect.build` (attribute
`kernel`: the source, or the sources of a parallel build), on the
calling thread: the watchdog taints a guard it opens in (a first build
takes tens of seconds inside the first step or decode call), and
goodput books it as `compile`. Each nvcc build, and each store hit,
registers an `introspect` build under the key `kernel.<source>`: its
compile phase is nvcc's wall time (a hit: the lookup's), its fingerprint
the source hash, its `warm` the lookup's result (None with the store
disabled). A library loaded from `.kernel_build/` without a build
registers nothing.

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

from .. import introspect, observe, warmstart

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


def _fingerprint(name: str) -> str:
    """16 hex of the hash of the flags, `<name>.cu` and every header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_fingerprint(name)}.so")


def _compile_cmd(name: str, out: str) -> list:
    """The compiler's command line that builds csrc/<name>.cu into
    `out`."""
    return [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", out,
            os.path.join(CSRC, f"{name}.cu")]


def _lookup(name: str):
    """With the store enabled: (the library of `name` loaded from its
    entry on a hit, registered with `warm: "hit"`, else None after the
    bad entry is deleted; the lookup's result)."""
    store = warmstart.get_store()
    key, fp = f"{warmstart.KERNEL_PREFIX}{name}", _fingerprint(name)
    t0 = time.perf_counter()
    so = None
    with observe.span("introspect.warm_load", kernel=name):
        path, result = store.check(key, fp)
        if path is not None:
            try:
                so = ctypes.CDLL(path)
            except OSError:
                store.discard(key, fp)
                result = warmstart.RESULT_CORRUPT
    seconds = time.perf_counter() - t0
    warmstart.note_lookup(key, fp, result, seconds)
    if so is not None:
        introspect.register_kernel_build(name, seconds, fp, warm=result)
    return so, result


class _Job:
    """One source's build: nvcc writing a temporary file, then moved to
    `.kernel_build/` (`warm` None) or into the store (`warm`: the
    lookup's result)."""

    __slots__ = ("name", "fp", "path", "tmp", "proc", "t0", "warm")

    def __init__(self, name, warm=None):
        self.name, self.fp, self.warm = name, _fingerprint(name), warm
        self.proc = self.tmp = self.t0 = None
        self.path = os.path.join(BUILD_DIR, f"lib{name}-{self.fp}.so")
        if warm is None:
            if os.path.exists(self.path):
                return
            os.makedirs(BUILD_DIR, exist_ok=True)
            self.tmp = f"{self.path}.{os.getpid()}.tmp"
        else:
            self.tmp = warmstart.get_store().scratch_path(
                f"{warmstart.KERNEL_PREFIX}{name}", self.fp)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(_compile_cmd(name, self.tmp),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def finish(self) -> ctypes.CDLL:
        if self.proc is not None:
            out, _ = self.proc.communicate()
            BUILD_SECONDS[self.name] = time.perf_counter() - self.t0
            BUILD_LOG[self.name] = out
            if self.proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{self.name}.cu "
                                   f"(exit {self.proc.returncode}):\n{out}")
            store = warmstart.get_store() if self.warm else None
            saved = store.save_file(f"{warmstart.KERNEL_PREFIX}{self.name}",
                                    self.fp, self.tmp) if store else None
            if saved is None:
                # no store, or one that refused the write
                os.makedirs(BUILD_DIR, exist_ok=True)
                os.replace(self.tmp, self.path)
            else:
                self.path = saved
        return ctypes.CDLL(self.path)

    def register(self):
        """Register an nvcc build with introspect (a library that was on
        disk registers nothing)."""
        if self.proc is not None:
            introspect.register_kernel_build(
                self.name, BUILD_SECONDS[self.name], self.fp, warm=self.warm)


def _look_up(names) -> "tuple[dict, list]":
    """({name: library} of the store's hits, [(name, lookup result)] of
    the sources to build): with the store enabled each source is looked
    up first; disabled, every result is None."""
    hits, todo = {}, []
    warm = warmstart.maybe_enable_from_env() is not None
    for n in names:
        result = None
        if warm:
            so, result = _lookup(n)
            if so is not None:
                hits[n] = so
                continue
        todo.append((n, result))
    return hits, todo


def build_all() -> None:
    """Build every kernel library, one nvcc per source, all in parallel
    (with the store enabled, only those the store does not hold)."""
    with _lock:
        hits, todo = _look_up([n for n in SOURCES if n not in _libs])
        _libs.update(hits)
        if not todo:
            return
        with observe.span("introspect.build",
                          kernel=",".join(n for n, _ in todo)):
            jobs = [_Job(n, result) for n, result in todo]
            # one waiting thread per nvcc, so each source's time is its own
            with ThreadPoolExecutor(len(jobs)) as ex:
                built = list(ex.map(_Job.finish, jobs))
            for j in jobs:
                j.register()
        for j, so in zip(jobs, built):
            _libs[j.name] = so


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _libs:
            hits, todo = _look_up([name])
            if hits:
                _libs[name] = hits[name]
            else:
                with observe.span("introspect.build", kernel=name):
                    j = _Job(*todo[0])
                    _libs[name] = j.finish()
                    j.register()
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


__all__ = ["BUILD_DIR", "BUILD_LOG", "BUILD_SECONDS", "DIAGNOSTICS", "SOURCES",
           "build_all", "check", "lib"]
