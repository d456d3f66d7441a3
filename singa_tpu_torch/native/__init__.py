"""Native (C++) host components of the port (counterpart of
singa_tpu/native): record IO and the snapshot binfile store.

Each component is one `.cc` in this directory, compiled on first use by
`g++` into a shared library under the git-ignored `.kernel_build/` at the
repo root (beside the CUDA kernels' libraries, never beside the source),
named by a hash of the source and flags so an edited source is rebuilt,
and bound with `ctypes`. A failed build raises with the compiler's
output: no caller falls back to Python silently (`io` and `snapshot`
take the pure-Python or npz path only when asked for by name).

Components:
- recordio.cc -> recordio():  length-framed, CRC-checked key/value
                              records, read ahead on a C++ thread
- snapshot.cc -> snapshot():  the binfile tensor store, written by a
                              background C++ thread
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)),
                         ".kernel_build")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: "dict[str, ctypes.CDLL]" = {}


def _cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler: the native components are "
                           "built with g++ (or $CXX)")
    return cxx


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(os.path.join(_DIR, f"{name}.cc"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _build(name: str) -> str:
    path = _lib_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_cxx(), *CXX_FLAGS, os.path.join(_DIR, f"{name}.cc"), "-o", tmp],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on native/{name}.cc (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load(name: str, annotate) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            lb = ctypes.CDLL(_build(name))
            annotate(lb)
            _libs[name] = lb
        return _libs[name]


def _annotate_recordio(lb):
    lb.rio_writer_open.restype = ctypes.c_void_p
    lb.rio_writer_open.argtypes = [ctypes.c_char_p]
    lb.rio_writer_write.restype = ctypes.c_int
    lb.rio_writer_write.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint64]
    lb.rio_writer_close.restype = ctypes.c_int
    lb.rio_writer_close.argtypes = [ctypes.c_void_p]
    lb.rio_reader_open.restype = ctypes.c_void_p
    lb.rio_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lb.rio_reader_next.restype = ctypes.c_int
    lb.rio_reader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64)]
    lb.rio_reader_close.restype = None
    lb.rio_reader_close.argtypes = [ctypes.c_void_p]


def _annotate_snapshot(lb):
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lb.snp_writer_open.restype = ctypes.c_void_p
    lb.snp_writer_open.argtypes = [ctypes.c_char_p]
    lb.snp_writer_write.restype = ctypes.c_int
    lb.snp_writer_write.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_uint8, u64p, ctypes.c_char_p, ctypes.c_uint64]
    lb.snp_writer_close.restype = ctypes.c_int
    lb.snp_writer_close.argtypes = [ctypes.c_void_p]
    lb.snp_reader_open.restype = ctypes.c_void_p
    lb.snp_reader_open.argtypes = [ctypes.c_char_p]
    lb.snp_reader_next.restype = ctypes.c_int
    lb.snp_reader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(u64p),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64)]
    lb.snp_reader_close.restype = None
    lb.snp_reader_close.argtypes = [ctypes.c_void_p]


def recordio() -> ctypes.CDLL:
    """The record-IO library, built on first use."""
    return _load("recordio", _annotate_recordio)


def snapshot() -> ctypes.CDLL:
    """The snapshot binfile library, built on first use."""
    return _load("snapshot", _annotate_snapshot)


# the JAX package's names (its versions return None without a C++
# toolchain; these raise with g++'s output, as `recordio`/`snapshot` do)
lib = recordio
snapshot_lib = snapshot

__all__ = ["BUILD_DIR", "lib", "recordio", "snapshot", "snapshot_lib"]
