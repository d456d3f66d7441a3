"""Record file IO (counterpart of singa_tpu/io.py): `RecordWriter` and
`RecordReader` over length-framed, CRC-checked key/value records, the
JAX package's file format, so either package reads the other's files.

    header:  8 bytes "STPURIO1"
    record:  u32 keylen | key | u64 vallen | value | u32 crc32(value)

The default backend is the native library (`native/recordio.cc`, built
with g++ on first use): the reader decodes records ahead of use on a C++
thread holding no GIL. `backend="python"` selects the pure-Python reader
and writer of the same format, the plain version; it is never taken
silently: a native library that fails to build raises.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

from . import native

_MAGIC = b"STPURIO1"
BACKENDS = ("native", "python")


def _check_backend(backend):
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; choose one of {BACKENDS}")


class RecordWriter:
    """Append (key, value) records to a new file at `path`."""

    def __init__(self, path: str, backend: str = "native"):
        _check_backend(backend)
        self.path = path
        self.backend = backend
        self._h = None
        self._f = None
        if backend == "native":
            self._lib = native.recordio()
            self._h = self._lib.rio_writer_open(path.encode())
            if not self._h:
                raise OSError(f"cannot open {path}")
        else:
            self._f = open(path, "wb")
            self._f.write(_MAGIC)

    def write(self, key, value):
        key = key.encode() if isinstance(key, str) else bytes(key)
        value = bytes(value)
        if self._h:
            rc = self._lib.rio_writer_write(self._h, key, len(key), value,
                                            len(value))
            if rc != 0:
                raise OSError(f"{self.path}: record write failed")
        elif self._f is not None:
            crc = zlib.crc32(value) & 0xFFFFFFFF
            self._f.write(struct.pack("<I", len(key)) + key
                          + struct.pack("<Q", len(value)) + value
                          + struct.pack("<I", crc))
        else:
            raise ValueError(f"{self.path}: writer is closed")

    def close(self):
        if self._h:
            rc = self._lib.rio_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError(f"{self.path}: flush on close failed")
        elif self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    """Iterate the (key: bytes, value: bytes) records of `path`; `depth`
    is the native reader's read-ahead queue. A record whose CRC does not
    match, or a truncated one, raises OSError."""

    def __init__(self, path: str, depth: int = 8, backend: str = "native"):
        _check_backend(backend)
        self.path = path
        self.backend = backend
        self._h = None
        self._f = None
        if backend == "native":
            self._lib = native.recordio()
            self._h = self._lib.rio_reader_open(path.encode(), int(depth))
            if not self._h:
                raise OSError(f"cannot open {path} (missing or bad magic)")
        else:
            self._f = open(path, "rb")
            self._size = os.fstat(self._f.fileno()).st_size
            if self._f.read(8) != _MAGIC:
                self._f.close()
                raise OSError(f"{path}: bad magic")

    def __iter__(self):
        return self

    def __next__(self):
        if self._h:
            key, klen = ctypes.c_char_p(), ctypes.c_uint32()
            val, vlen = ctypes.c_char_p(), ctypes.c_uint64()
            rc = self._lib.rio_reader_next(
                self._h, ctypes.byref(key), ctypes.byref(klen),
                ctypes.byref(val), ctypes.byref(vlen))
            if rc == 0:
                raise StopIteration
            if rc < 0:
                raise OSError(f"{self.path}: corrupt record")
            return (ctypes.string_at(key, klen.value),
                    ctypes.string_at(val, vlen.value))
        if self._f is None:
            raise StopIteration
        raw = self._f.read(4)
        if not raw:
            raise StopIteration
        if len(raw) < 4:
            raise OSError(f"{self.path}: truncated record")
        (klen,) = struct.unpack("<I", raw)
        k = self._read(klen)
        (vlen,) = struct.unpack("<Q", self._read(8))
        v = self._read(vlen)
        (crc,) = struct.unpack("<I", self._read(4))
        if (zlib.crc32(v) & 0xFFFFFFFF) != crc:
            raise OSError(f"{self.path}: corrupt record")
        return k, v

    def _read(self, n):
        # a length field is bounded by the bytes left: a corrupt one
        # raises instead of asking for an absurd read
        if n > self._size - self._f.tell():
            raise OSError(f"{self.path}: corrupt or truncated record")
        return self._f.read(n)

    def close(self):
        if self._h:
            self._lib.rio_reader_close(self._h)
            self._h = None
        elif self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["BACKENDS", "RecordReader", "RecordWriter"]
