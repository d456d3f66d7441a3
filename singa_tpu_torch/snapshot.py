"""Snapshot: a named-tensor store on disk (counterpart of
singa_tpu/snapshot.py), in the JAX package's formats, so either package
reads the other's files.

Two backends behind one API:
- native: `<prefix>.bin` in the CRC-framed binfile format of
  `native/snapshot.cc` (built with g++ on first use), drained to disk by
  a C++ thread holding no GIL;
- npz: `<prefix>.npz`, the plain version.

Both write a `<prefix>.meta` JSON manifest (names, shapes, dtypes). The
path picks the writer: `.npz` the npz backend, `.bin` or no extension the
native one, which raises if it cannot be built (no silent fallback).
Reads take what is on disk (`.bin` first). bfloat16 values travel as
their 16-bit patterns under the dtype name "bfloat16", read back through
torch's bfloat16 (the card host has no `ml_dtypes`).
"""

from __future__ import annotations

import ctypes
import json
import os

import numpy as np
import torch

from . import native
from .tensor import Tensor


def _to_numpy(val):
    """(host numpy array, dtype name) of a Tensor, tensor or array; a
    bfloat16 tensor as its uint16 bit patterns."""
    if isinstance(val, Tensor):
        val = val.data
    if torch.is_tensor(val):
        t = val.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), \
                "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(val)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype)))


class Snapshot:

    def __init__(self, fpath: str, mode_write: bool, buffer_size: int = 0):
        """mode_write=True opens for writing, else reads the snapshot at
        `fpath` now."""
        self.fpath = fpath
        self.mode_write = mode_write
        self._store = {}     # name -> host numpy array
        self._dtypes = {}    # name -> dtype name
        if not mode_write:
            self._load()

    def _prefix(self):
        root, ext = os.path.splitext(self.fpath)
        return root if ext in (".npz", ".bin") else self.fpath

    # -- write side ---------------------------------------------------------
    def write(self, param_name: str, param_val):
        """Stage a Tensor, torch tensor or numpy array under a name (a
        device tensor is copied to the host here)."""
        assert self.mode_write
        self._store[param_name], self._dtypes[param_name] = \
            _to_numpy(param_val)

    def flush(self):
        if not self.mode_write:
            return
        with torch.profiler.record_function("snapshot.flush"):
            if self.fpath.endswith(".npz"):
                np.savez(self._prefix() + ".npz", **self._store)
                stale = self._prefix() + ".bin"
            else:
                self._flush_native(native.snapshot())
                stale = self._prefix() + ".npz"
            # an earlier flush of the same extensionless prefix in the
            # other format would shadow this one on read
            if not self.fpath.endswith((".npz", ".bin")) \
                    and os.path.exists(stale):
                os.remove(stale)
            meta = {k: {"shape": list(v.shape), "dtype": self._dtypes[k]}
                    for k, v in self._store.items()}
            with open(self._prefix() + ".meta", "w") as f:
                json.dump(meta, f, indent=1)

    def _flush_native(self, lb):
        path = self._prefix() + ".bin"
        h = lb.snp_writer_open(path.encode())
        if not h:
            raise OSError(f"cannot open {path} for writing")
        try:
            for name, arr in self._store.items():
                shape = arr.shape  # before ascontiguousarray: 0-d -> 1-d
                arr = np.ascontiguousarray(arr)
                dims = (ctypes.c_uint64 * len(shape))(*shape)
                rc = lb.snp_writer_write(
                    h, name.encode(), self._dtypes[name].encode(),
                    len(shape), dims, arr.ctypes.data_as(ctypes.c_char_p),
                    arr.nbytes)
                if rc != 0:
                    raise OSError(f"snapshot write failed for {name}")
        finally:
            if lb.snp_writer_close(h) != 0:
                raise OSError(f"snapshot flush to {path} failed")

    # -- read side ------------------------------------------------------------
    def _load(self):
        with torch.profiler.record_function("snapshot.load"):
            prefix = self._prefix()
            bin_path = None if self.fpath.endswith(".npz") \
                else prefix + ".bin"
            npz_path = None if self.fpath.endswith(".bin") \
                else prefix + ".npz"
            meta = self._meta()
            if bin_path and os.path.exists(bin_path):
                self._load_native(native.snapshot(), bin_path, meta)
            elif npz_path and os.path.exists(npz_path):
                with np.load(npz_path) as z:
                    self._store = {k: z[k] for k in z.files}
                self._dtypes = {k: (meta.get(k) or {}).get(
                    "dtype", str(v.dtype)) for k, v in self._store.items()}
            else:
                raise FileNotFoundError(
                    f"no snapshot at {prefix}(.bin|.npz)")

    def _meta(self) -> dict:
        path = self._prefix() + ".meta"
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def _load_native(self, lb, path, meta):
        h = lb.snp_reader_open(path.encode())
        if not h:
            raise OSError(f"cannot open snapshot {path} (bad magic?)")
        try:
            key, dtype = ctypes.c_char_p(), ctypes.c_char_p()
            ndim = ctypes.c_uint8()
            dims = ctypes.POINTER(ctypes.c_uint64)()
            data, nbytes = ctypes.c_char_p(), ctypes.c_uint64()
            while True:
                rc = lb.snp_reader_next(
                    h, ctypes.byref(key), ctypes.byref(dtype),
                    ctypes.byref(ndim), ctypes.byref(dims),
                    ctypes.byref(data), ctypes.byref(nbytes))
                if rc == 0:
                    break
                if rc < 0:
                    raise OSError(f"corrupt snapshot record in {path}")
                name, dt = key.value.decode(), dtype.value.decode()
                shape = tuple(dims[i] for i in range(ndim.value))
                raw = ctypes.string_at(data, nbytes.value)
                npdt = np.uint16 if dt == "bfloat16" else np.dtype(dt)
                self._store[name] = np.frombuffer(raw, npdt).reshape(
                    shape).copy()
                self._dtypes[name] = dt
        finally:
            lb.snp_reader_close(h)
        # a file cut exactly at a record boundary reads as a clean end:
        # the .meta manifest, where there is one, names what must be there
        missing = set(meta) - set(self._store)
        if missing:
            raise OSError(f"truncated snapshot {path}: missing "
                          f"{sorted(missing)[:5]} (and possibly more) per "
                          "the .meta manifest")

    def read(self, param_name: str) -> Tensor:
        """The named value as a Tensor on the CPU."""
        assert not self.mode_write
        return Tensor(data=_to_tensor(self._store[param_name],
                                      self._dtypes[param_name]),
                      requires_grad=False)

    def names(self):
        return list(self._store)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()


__all__ = ["Snapshot"]
