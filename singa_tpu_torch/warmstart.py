"""Warm-start layer (counterpart of singa_tpu/warmstart.py): restarts that
build nothing that a store already holds.

A replica that restarts (the router replacing a killed one, the watchdog
restarting a process, resilience resuming after preemption) pays its
whole cold start again. On the card most of that is `nvcc`: each
`csrc/*.cu` is compiled at its first use (`ops/_build.py`). This module
keeps what a later process can reuse under one directory
(`SINGA_TPU_COMPILE_CACHE` or `enable(root)`).

The JAX package stores two layers: XLA's persistent compilation cache
(`<root>/xla`) and `jax.export`-serialized executables. A CUDA graph
cannot be serialized and PyTorch has no StableHLO to export, so the port
stores exactly two kinds of entry, both under `<root>/exec`:

1. **Kernel libraries**, key `kernel.<source>`: the `nvcc`-built shared
   library of `csrc/<source>.cu` (`ops/_build.py`), its fingerprint the
   source hash that names it. A hit is loaded with `ctypes` as it lies in
   the store; a miss runs `nvcc` into the store.
2. **Build records**, every other key (`step`, `eval`,
   `serving.engine_prefill`, ...): a build's counted cost, memory, op
   listing and signature (`introspect.export_executable`). A hit spares
   the build's counting pass (`introspect._Counter`); the function itself
   always runs, so a record cannot change what the model computes.

There is no `<root>/xla` layer: `snapshot()["xla_cache_dir"]` is None
and `warm_report` says why. With the store disabled (the default) every
build and every library is as before this module: the libraries go to
`.kernel_build/`, the build records carry `warm: None`.

Store layout (`<root>/exec/<safe_key>/`):

  <fingerprint>.bin    the library, or the build record as JSON
  <fingerprint>.json   {key, fingerprint, blob_sha256, torch_version,
                        size, ts} and, for a library, cuda_version and
                        compute_capability: integrity and staleness
  ../manifest.jsonl    append-only export log (what a spawned replica is
                       shipped)

Writes are atomic (tmp, fsync, os.replace), eviction keeps the last K
entries per key by mtime (`SINGA_TPU_COMPILE_CACHE_KEEP`, default 8), and
every lookup is classified into `CACHE_RESULTS`:

  hit      meta parsed and matching, sha-256 verified, and the blob
           usable (a record decodes to the call's signature, a library
           loads)
  miss     no entry for this (key, fingerprint)
  stale    an entry not made for THIS process: a meta fingerprint, a
           torch version or, for a library, a CUDA version or compute
           capability that differs (deleted and rebuilt)
  corrupt  an unreadable blob or meta, a sha-256 mismatch, a record that
           does not decode or whose signature differs, a library that
           `ctypes.CDLL` refuses (deleted and rebuilt)

A stale or corrupt library is always rebuilt by `nvcc`: nothing falls
back to a kernel's plain version. Every classification lands in
`singa_compile_cache_lookups_total{result=,key=}`; exports, evictions and
the store's occupancy have their own metrics, and /statusz has a
`== warm start ==` section (`warm_report`).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time

import torch

from . import observe

# ---- enums (the lint in tools/check_metrics_names.py greps these) ---------

#: Warm-store lookup classifications for
#: `singa_compile_cache_lookups_total{result=...}`.
CACHE_RESULTS = ("hit", "miss", "stale", "corrupt")
RESULT_HIT = "hit"
RESULT_MISS = "miss"
RESULT_STALE = "stale"
RESULT_CORRUPT = "corrupt"

ENV_CACHE_DIR = "SINGA_TPU_COMPILE_CACHE"
ENV_KEEP = "SINGA_TPU_COMPILE_CACHE_KEEP"
DEFAULT_KEEP = 8

MANIFEST_NAME = "manifest.jsonl"
MAX_LOOKUPS = 256
#: keys of kernel-library entries start with this
KERNEL_PREFIX = "kernel."
#: why the store has no XLA layer (warm_report's line)
NO_XLA = ("none: a CUDA graph cannot be serialized; the store holds the "
          "nvcc kernel libraries and the build records")

# ---- state -----------------------------------------------------------------

_store: "WarmStore | None" = None
_lookups: list = []   # ring of {key, fingerprint, result, seconds, ts}
_counts: dict = {}    # result -> count (lifetime of this enable)
_exports = 0
_env_checked = False


def _count_lookup(result: str, key: str):
    assert result in CACHE_RESULTS, result
    if observe.is_enabled():
        observe.counter(
            "singa_compile_cache_lookups_total",
            "warm-store lookups by classification (hit|miss|stale|corrupt)"
        ).inc(result=result, key=key)


def _count_eviction(key: str):
    if observe.is_enabled():
        observe.counter(
            "singa_compile_cache_evictions_total",
            "warm-store entries deleted by keep-last-K eviction"
        ).inc(key=key)


def _count_export(key: str):
    if observe.is_enabled():
        observe.counter(
            "singa_compile_cache_exports_total",
            "kernel libraries and build records written to the warm store"
        ).inc(key=key)


def _set_store_gauges():
    if _store is None or not observe.is_enabled():
        return
    n, nbytes = _store.occupancy()
    observe.gauge("singa_compile_cache_entries",
                  "entries (kernel libraries, build records) currently in "
                  "the warm store").set(float(n))
    observe.gauge("singa_compile_cache_store_bytes",
                  "total on-disk bytes of the warm store's blobs"
                  ).set(float(nbytes))


def note_lookup(key: str, fingerprint: str, result: str,
                seconds: float = 0.0):
    """Record one classified lookup (`introspect.load_executable` and
    `ops/_build.py` call this): the counter, the load histogram on a hit,
    and the in-memory ring `snapshot()` reads."""
    assert result in CACHE_RESULTS, result
    _counts[result] = _counts.get(result, 0) + 1
    _lookups.append({"key": key, "fingerprint": fingerprint,
                     "result": result, "seconds": round(seconds, 6),
                     "ts": round(time.time(), 6)})
    del _lookups[:-MAX_LOOKUPS]
    _count_lookup(result, key)
    if result == RESULT_HIT and observe.is_enabled():
        observe.histogram(
            "singa_compile_cache_load_seconds",
            "wall seconds to read, verify and load a warm-store entry"
        ).observe(seconds, key=key)


def note_export(key: str, fingerprint: str, nbytes: int):
    """Record one write (WarmStore.save calls this): the export counter
    and the occupancy gauges."""
    global _exports
    _exports += 1
    _count_export(key)
    _set_store_gauges()


# ---- what makes an entry this process's ------------------------------------

def _compute_capability() -> "str | None":
    """"9.0" for the current card, None without one."""
    if not torch.cuda.is_available():
        return None
    major, minor = torch.cuda.get_device_capability()
    return f"{major}.{minor}"


def _environment(key: str) -> dict:
    """The meta fields a lookup must match besides the fingerprint: the
    torch version, and for a kernel library the CUDA version and the
    card's compute capability."""
    env = {"torch_version": torch.__version__}
    if key.startswith(KERNEL_PREFIX):
        env["cuda_version"] = torch.version.cuda
        env["compute_capability"] = _compute_capability()
    return env


# ---- the on-disk store ------------------------------------------------------

def _safe_key(key: str) -> str:
    return "".join(c if (c.isalnum() or c in "-_") else "_"
                   for c in key) or "_"


def _fsync_replace(tmp: str, path: str):
    with open(tmp, "rb+") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write_tmp(path: str, data: bytes) -> str:
    """Write `data` to a new temporary file beside `path`, its name unique
    to this write (replicas sharing a store export the same keys at once),
    and return its name."""
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
    except OSError:
        _unlink(tmp)
        raise
    return tmp


def _unlink(path: str):
    try:
        os.unlink(path)
    except OSError:
        pass


class WarmStore:
    """The store under `<root>/exec`. All writes are atomic (tmp, fsync,
    os.replace): a crash mid-write leaves no half entry, and a blob is
    replaced by a new file, never rewritten in place (a library loaded
    from it stays mapped). Loads classify into CACHE_RESULTS and delete
    untrustworthy entries, so a bad blob is paid for at most once."""

    def __init__(self, root: str, keep: "int | None" = None):
        self.root = os.path.abspath(root)
        self.exec_dir = os.path.join(self.root, "exec")
        if keep is None:
            try:
                keep = int(os.environ.get(ENV_KEEP, DEFAULT_KEEP))
            except ValueError:
                keep = DEFAULT_KEEP
        self.keep = max(1, int(keep))
        os.makedirs(self.exec_dir, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def entry_paths(self, key: str, fingerprint: str):
        d = os.path.join(self.exec_dir, _safe_key(key))
        return (os.path.join(d, f"{fingerprint}.bin"),
                os.path.join(d, f"{fingerprint}.json"))

    def scratch_path(self, key: str, fingerprint: str) -> str:
        """A temporary path beside the entry, on the store's file system
        (nvcc writes a library there for `save_file`)."""
        bin_path, _ = self.entry_paths(key, fingerprint)
        os.makedirs(os.path.dirname(bin_path), exist_ok=True)
        return f"{bin_path}.{os.getpid()}.build"

    # -- write ---------------------------------------------------------------
    def save(self, key: str, fingerprint: str, blob: bytes) -> "str | None":
        """Write one entry atomically (blob first, meta second: a meta is
        only ever present next to a complete blob), append the manifest
        line, evict beyond keep-last-K. Returns the blob path, or None on
        any OSError (a read-only store must not break the build that
        tried to fill it)."""
        bin_path, _ = self.entry_paths(key, fingerprint)
        try:
            os.makedirs(os.path.dirname(bin_path), exist_ok=True)
            tmp = _write_tmp(bin_path, blob)
        except OSError:
            return None
        saved = self._commit(key, fingerprint, tmp,
                             hashlib.sha256(blob).hexdigest(), len(blob))
        if saved is None:
            _unlink(tmp)
        return saved

    def save_file(self, key: str, fingerprint: str,
                  src: str) -> "str | None":
        """`save` for a finished file (`scratch_path`, where nvcc wrote a
        library): moved into the entry, not copied."""
        try:
            h = hashlib.sha256()
            with open(src, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            size = os.path.getsize(src)
        except OSError:
            return None
        return self._commit(key, fingerprint, src, h.hexdigest(), size)

    def _commit(self, key, fingerprint, tmp, sha, size) -> "str | None":
        bin_path, meta_path = self.entry_paths(key, fingerprint)
        meta = {"key": key, "fingerprint": fingerprint, "blob_sha256": sha,
                "size": int(size), "ts": round(time.time(), 6),
                **_environment(key)}
        line = json.dumps(meta, sort_keys=True)
        meta_tmp = None
        try:
            _fsync_replace(tmp, bin_path)
            meta_tmp = _write_tmp(meta_path, line.encode())
            _fsync_replace(meta_tmp, meta_path)
            with open(os.path.join(self.exec_dir, MANIFEST_NAME), "a",
                      encoding="utf-8") as f:
                f.write(line + "\n")
        except OSError:
            if meta_tmp is not None:
                _unlink(meta_tmp)
            return None
        self._evict(key)
        note_export(key, fingerprint, int(size))
        return bin_path

    # -- read ----------------------------------------------------------------
    def check(self, key: str, fingerprint: str):
        """(blob path | None, result) without reading the blob into
        memory: `hit` only after the meta parses, its fingerprint and
        environment match, AND the blob's sha-256 verifies. Stale and
        corrupt entries are deleted here, so the caller's fresh build
        writes a clean replacement."""
        bin_path, meta_path = self.entry_paths(key, fingerprint)
        if not os.path.exists(bin_path) and not os.path.exists(meta_path):
            return None, RESULT_MISS
        try:
            with open(meta_path, encoding="utf-8") as f:
                meta = json.load(f)
            if not isinstance(meta, dict):
                raise ValueError("meta is not a dict")
        except (OSError, ValueError):
            self.discard(key, fingerprint)
            return None, RESULT_CORRUPT
        if meta.get("fingerprint") != fingerprint or any(
                meta.get(k) != v for k, v in _environment(key).items()):
            # an entry at this path not made for THIS (signature, torch,
            # CUDA, card): a copied store or an upgraded container
            self.discard(key, fingerprint)
            return None, RESULT_STALE
        try:
            h = hashlib.sha256()
            with open(bin_path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
        except OSError:
            self.discard(key, fingerprint)
            return None, RESULT_CORRUPT
        if h.hexdigest() != meta.get("blob_sha256"):
            self.discard(key, fingerprint)
            return None, RESULT_CORRUPT
        return bin_path, RESULT_HIT

    def load(self, key: str, fingerprint: str):
        """(blob bytes | None, result), classified as `check` does."""
        path, result = self.check(key, fingerprint)
        if path is None:
            return None, result
        try:
            with open(path, "rb") as f:
                return f.read(), result
        except OSError:
            self.discard(key, fingerprint)
            return None, RESULT_CORRUPT

    def discard(self, key: str, fingerprint: str):
        """Delete one entry (both files; missing files are fine)."""
        for p in self.entry_paths(key, fingerprint):
            _unlink(p)
        _set_store_gauges()

    # -- eviction / inventory ------------------------------------------------
    def _evict(self, key: str):
        d = os.path.join(self.exec_dir, _safe_key(key))
        try:
            blobs = sorted(
                (f for f in os.listdir(d) if f.endswith(".bin")),
                key=lambda f: os.path.getmtime(os.path.join(d, f)))
        except OSError:
            return
        for f in blobs[:-self.keep]:
            self.discard(key, f[:-len(".bin")])
            _count_eviction(key)

    def entries(self) -> list:
        """Every complete entry on disk: [{key, fingerprint, size}]."""
        out = []
        try:
            key_dirs = sorted(os.listdir(self.exec_dir))
        except OSError:
            return out
        for kd in key_dirs:
            d = os.path.join(self.exec_dir, kd)
            if not os.path.isdir(d):
                continue
            for f in sorted(os.listdir(d)):
                if not f.endswith(".json"):
                    continue
                try:
                    with open(os.path.join(d, f), encoding="utf-8") as fh:
                        meta = json.load(fh)
                    bin_path = os.path.join(d, f[:-len(".json")] + ".bin")
                    out.append({"key": meta.get("key", kd),
                                "fingerprint": meta.get("fingerprint"),
                                "size": os.path.getsize(bin_path)})
                except (OSError, ValueError, AttributeError):
                    continue
        return out

    def occupancy(self):
        """(entry count, total blob bytes) of the store."""
        es = self.entries()
        return len(es), sum(int(e.get("size") or 0) for e in es)

    def manifest(self) -> list:
        """The append-only export log: what `spawn_replica` ships a child
        so it knows which entries to expect warm."""
        path = os.path.join(self.exec_dir, MANIFEST_NAME)
        out = []
        try:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            pass
        return out


# ---- lifecycle --------------------------------------------------------------

def enable(root: "str | None" = None, *,
           keep: "int | None" = None) -> "WarmStore | None":
    """Enable the warm-start layer rooted at `root` (default: the
    SINGA_TPU_COMPILE_CACHE env var; None/unset -> stay disabled).
    Idempotent per root. Returns the store (or None when disabled)."""
    global _store
    if root is None:
        root = os.environ.get(ENV_CACHE_DIR) or None
    if not root:
        return None
    root = os.path.abspath(root)
    if _store is not None and _store.root == root:
        return _store
    _store = WarmStore(root, keep=keep)
    _set_store_gauges()
    return _store


def maybe_enable_from_env() -> "WarmStore | None":
    """One-shot env probe (every build calls this): enable from
    SINGA_TPU_COMPILE_CACHE the first time, then free until `reset()`."""
    global _env_checked
    if _store is not None:
        return _store
    if _env_checked:
        return None
    _env_checked = True
    return enable()


def get_store() -> "WarmStore | None":
    return _store


def is_enabled() -> bool:
    return _store is not None


def reset():
    """Disable the layer and clear all module state: the store handle and
    the lookup ring and counts, so one test's store can never feed
    another test a hit. Libraries already loaded stay loaded."""
    global _store, _exports, _env_checked
    _store = None
    _exports = 0
    _env_checked = False
    _counts.clear()
    del _lookups[:]


# ---- reporting --------------------------------------------------------------

def lookup_history() -> list:
    """Chronological classified lookups ({key, fingerprint, result,
    seconds, ts}) since enable: the warm A/B reads this."""
    return [dict(r) for r in _lookups]


def snapshot() -> dict:
    """One dict for ready lines, /statusz and WARM rows: enabled flag,
    root, per-result lookup counts, hit rate, exports, and the store's
    occupancy. `xla_cache_dir` is always None (no XLA layer)."""
    counts = {r: int(_counts.get(r, 0)) for r in CACHE_RESULTS}
    total = sum(counts.values())
    snap = {"enabled": _store is not None,
            "root": _store.root if _store is not None else None,
            "xla_cache_dir": None,
            "lookups": counts,
            "hit_rate": (counts[RESULT_HIT] / total) if total else None,
            "exports": int(_exports)}
    if _store is not None:
        n, nbytes = _store.occupancy()
        snap["entries"] = n
        snap["store_bytes"] = nbytes
        snap["keep"] = _store.keep
    return snap


def warm_report() -> str:
    """The `== warm start ==` /statusz section."""
    snap = snapshot()
    if not snap["enabled"]:
        return ("== warm start ==\nwarm store not enabled (set "
                f"{ENV_CACHE_DIR} or warmstart.enable(root))")
    c = snap["lookups"]
    hr = snap["hit_rate"]
    lines = [
        "== warm start ==",
        f"store: {snap['root']}  entries {snap.get('entries', 0)}  "
        f"{(snap.get('store_bytes') or 0) / 1e6:.2f} MB  "
        f"keep-last-{snap.get('keep')}",
        f"xla persistent cache: {NO_XLA}",
        "lookups: " + "  ".join(f"{r} {c[r]}" for r in CACHE_RESULTS)
        + (f"  (hit rate {hr * 100.0:.1f}%)" if hr is not None else ""),
        f"exports: {snap['exports']}",
    ]
    for r in lookup_history()[-6:]:
        lines.append(f"  [{r['key']}@{r['fingerprint']}] {r['result']} "
                     f"{r['seconds'] * 1e3:.1f} ms")
    return "\n".join(lines)


__all__ = [
    "CACHE_RESULTS", "RESULT_HIT", "RESULT_MISS", "RESULT_STALE",
    "RESULT_CORRUPT", "ENV_CACHE_DIR", "ENV_KEEP",
    "WarmStore", "enable", "maybe_enable_from_env", "get_store",
    "is_enabled", "reset",
    "note_lookup", "note_export", "lookup_history", "snapshot",
    "warm_report",
]
