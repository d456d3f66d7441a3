"""Runtime metrics and spans (counterpart of singa_tpu/observe.py): the
live-telemetry layer, with the JAX package's public names, metric names,
types, help strings, label sets and `DEFAULT_BUCKETS`.

  - `MetricsRegistry` with `Counter` / `Gauge` / `Histogram` (fixed
    log-scale buckets, stdlib only: no prometheus_client dependency),
  - `span(name, **attrs)`: a nesting context manager that records wall
    time into the `singa_span_seconds` histogram and opens a
    `torch.profiler.record_function` range named `singa.span/<path>`,
    so the same spans appear in a torch.profiler trace beside the
    device's kernels: one name correlates the live histogram with the
    device timeline. The profiler sees the range only while a profile is
    active; the histogram and the listeners fire whether or not one is,
  - exporters: `to_prometheus_text()` (pull-style scrape body), `dump()`
    and a rotating JSONL `EventLog` for step/serving records.

Metric-name contract (enforced at registration and by
tools/check_metrics_names.py): names match ^singa_[a-z0-9_]+$ and a name
is registered with exactly one type.

When the hooks fire. The JAX package's in-step helpers run at trace time,
so under jit they fire once per compilation. The port has no trace: a
graph-mode step (`Model.compile(use_graph=True)`) runs its Python body on
the host at its warm-up call and at its CUDA-graph capture, and a replay
runs no Python at all. On the CPU, graph mode runs every step eagerly
(`graph_backend == "eager"`). So the port's rule is:

  - host-side hooks (the `model.step` span, `record_step` with
    `singa_steps_total` and `singa_step_seconds`, `record_step_build`,
    `record_compile`, `record_step_fenced`) fire once per call in every
    mode, around the eager run or the replay, and count what the JAX
    package counts;
  - in-step hooks (the `opt.apply_updates` span, `record_opt_update`)
    fire once per host execution of the step body: every step eagerly
    and on the CPU, twice per signature on the card (warm-up and
    capture), never at a replay.

Nothing here allocates on the device, synchronizes or reads a device
value: a hook inside a capture only records host-side numbers.
`record_hbm` reads the caching allocator's counters
(`torch.cuda.memory_stats`), which is allowed during a capture.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque

_NAME_RE = re.compile(r"^singa_[a-z0-9_]+$")

#: the collective vocabulary (parallel.communicator's call sites). The
#: `op=` label is contractually low-cardinality (lint rule 5): values
#: recorded by record_comm/record_comm_host are proven members of this
#: tuple, with unknown callers coerced to the trailing "other" bucket
#: rather than minting unbounded label values.
COMM_OPS = ("all_reduce", "all_reduce_half", "all_gather", "broadcast",
            "reduce_scatter", "all_reduce_max", "agree_any",
            "sparse_all_reduce_topk", "sparse_all_reduce_threshold",
            "other")

# Log-scale bucket boundaries (seconds): 1e-6 .. 1e3, ratio sqrt(10).
# Wide enough for a 2us collective and a 15-minute XLA compile alike.
DEFAULT_BUCKETS = tuple(10.0 ** (e / 2.0) for e in range(-12, 7))


def _label_key(labels: dict):
    return tuple(sorted(labels.items()))


def _esc(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_labels(key) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in key) + "}"


def _fmt_num(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"     # canonical Prometheus spellings: a health gauge
    if f == float("inf"):
        return "+Inf"    # legitimately holds NaN/Inf on an anomaly step
    if f == float("-inf"):
        return "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return format(f, "g")


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} must match {_NAME_RE.pattern}")
        self.name = name
        self.help = help
        # mutations are read-modify-write; serving threads update the
        # same series concurrently, so each metric carries its own lock
        # (uncontended acquire is ~100ns — noise on the step path)
        self._mlock = threading.Lock()


class Counter(_Metric):
    """Monotonic counter; `inc` with optional labels."""

    kind = "counter"

    def __init__(self, name, help=""):
        super().__init__(name, help)
        self._values = {}

    def inc(self, n: float = 1.0, **labels):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        k = _label_key(labels)
        with self._mlock:
            self._values[k] = self._values.get(k, 0.0) + n

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def samples(self):
        for k, v in sorted(self._values.items()):
            yield self.name, k, v

    def snapshot(self):
        return [{"labels": dict(k), "value": v}
                for k, v in sorted(self._values.items())]


class Gauge(_Metric):
    """Point-in-time value; `set`/`inc`/`dec` with optional labels."""

    kind = "gauge"

    def __init__(self, name, help=""):
        super().__init__(name, help)
        self._values = {}

    def set(self, v: float, **labels):
        with self._mlock:
            self._values[_label_key(labels)] = float(v)

    def inc(self, n: float = 1.0, **labels):
        k = _label_key(labels)
        with self._mlock:
            self._values[k] = self._values.get(k, 0.0) + n

    def dec(self, n: float = 1.0, **labels):
        self.inc(-n, **labels)

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def samples(self):
        for k, v in sorted(self._values.items()):
            yield self.name, k, v

    def snapshot(self):
        return [{"labels": dict(k), "value": v}
                for k, v in sorted(self._values.items())]


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative-le on export, like Prometheus).

    Buckets are static log-scale upper bounds; `observe` is O(#buckets)
    worst case (linear scan — ~19 comparisons, cheap enough for the step
    path) and tracks per-label-set count/sum alongside.
    """

    kind = "histogram"

    def __init__(self, name, help="", buckets=None):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._series = {}  # label key -> [counts list, count, sum]

    def _row(self, labels):
        k = _label_key(labels)
        row = self._series.get(k)
        if row is None:
            row = self._series[k] = [[0] * (len(self.buckets) + 1), 0, 0.0]
        return row

    def observe(self, v: float, **labels):
        i = len(self.buckets)  # overflow (+Inf) slot
        for j, ub in enumerate(self.buckets):
            if v <= ub:
                i = j
                break
        with self._mlock:
            row = self._row(labels)
            row[0][i] += 1
            row[1] += 1
            row[2] += float(v)

    def count(self, **labels) -> int:
        return self._series.get(_label_key(labels), [None, 0, 0.0])[1]

    def sum(self, **labels) -> float:
        return self._series.get(_label_key(labels), [None, 0, 0.0])[2]

    def bucket_counts(self, **labels):
        """Cumulative counts per upper bound (+Inf last)."""
        row = self._series.get(_label_key(labels))
        if row is None:
            return [0] * (len(self.buckets) + 1)
        out, acc = [], 0
        for c in row[0]:
            acc += c
            out.append(acc)
        return out

    def snapshot(self):
        out = []
        for k, (counts, n, s) in sorted(self._series.items()):
            cum, acc = {}, 0
            for ub, c in zip(self.buckets, counts):
                acc += c
                cum[_fmt_num(ub)] = acc
            cum["+Inf"] = n
            out.append({"labels": dict(k), "count": n, "sum": s,
                        "buckets": cum})
        return out


class EventLog:
    """Rotating JSONL sink for step/serving/bench records.

    `write(record)` appends one compact JSON line (a `ts` epoch field is
    stamped if absent). When the file would exceed `max_bytes` it rotates
    shift-style: path -> path.1 -> ... -> path.<backups> (oldest dropped).
    """

    def __init__(self, path: str, max_bytes: int = 10_000_000,
                 backups: int = 3, fsync: bool = False):
        self.path = str(path)
        self.max_bytes = int(max_bytes)
        self.backups = int(backups)
        # fsync=True makes every write durable against POWER LOSS, not
        # just process death (write() already flush()es to the kernel,
        # which survives a SIGKILL'd worker) — the kill-resume path's
        # post-mortem log must not end before its last logged step
        self.fsync = bool(fsync)
        self._lock = threading.Lock()
        self._fh = None

    def _open(self):
        if self._fh is None or self._fh.closed:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        return self._fh

    def _rotate(self):
        if self._fh is not None and not self._fh.closed:
            self._fh.close()
        self._fh = None
        if self.backups <= 0:
            # no backups: truncate in place so max_bytes still holds
            if os.path.exists(self.path):
                os.remove(self.path)
            return
        for i in range(self.backups - 1, 0, -1):
            src, dst = f"{self.path}.{i}", f"{self.path}.{i + 1}"
            if os.path.exists(src):
                os.replace(src, dst)
        if os.path.exists(self.path):
            os.replace(self.path, f"{self.path}.1")

    def write(self, record: dict):
        if "ts" not in record:
            record = {"ts": round(time.time(), 6), **record}
        line = json.dumps(record, separators=(",", ":"), default=str) + "\n"
        with self._lock:
            fh = self._open()
            if fh.tell() + len(line) > self.max_bytes and fh.tell() > 0:
                self._rotate()
                fh = self._open()
            fh.write(line)
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())

    def flush(self, fsync: "bool | None" = None):
        """Push buffered lines to the OS (and with `fsync` — defaulting
        to the log's own mode — to stable storage). write() already
        flushes per line, so this exists for callers that need an
        explicit durability point (a worker about to be killed)."""
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.flush()
                if self.fsync if fsync is None else fsync:
                    os.fsync(self._fh.fileno())

    def close(self):
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.close()
            self._fh = None

    @staticmethod
    def read(path: str):
        """Parse one JSONL file back into a list of dicts (skips
        torn/partial trailing lines rather than raising — a crash
        mid-write must not make the whole log unreadable)."""
        out = []
        if not os.path.exists(path):
            return out
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
        return out


class MetricsRegistry:
    """Process-wide metric store: get-or-create by (name, type), one type
    per name (re-registering under a different type raises — the same
    contract tools/check_metrics_names.py lints statically)."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()
        self.event_log: EventLog | None = None
        self.recent = deque(maxlen=512)  # last emitted records, in memory

    def _register(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"cannot re-register as {cls.kind}")
                return m
            m = self._metrics[name] = cls(name, help, **kw)
            return m

    def counter(self, name, help="") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name, help="") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name, help="", buckets=None) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def get(self, name):
        return self._metrics.get(name)

    def names(self):
        return sorted(self._metrics)

    def reset(self):
        with self._lock:
            self._metrics.clear()
            self.recent.clear()

    def emit(self, record: dict):
        """Route a structured record to the in-memory ring and, when one
        is attached, the JSONL EventLog."""
        if "ts" not in record:
            record = {"ts": round(time.time(), 6), **record}
        self.recent.append(record)
        log = self.event_log
        if log is not None:
            log.write(record)

    # ---- exporters -------------------------------------------------------
    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format (0.0.4): per metric a
        `# HELP` / `# TYPE` header then its samples; histograms expand to
        cumulative `_bucket{le=...}` + `_sum` + `_count`."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {_esc(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for k, (counts, n, s) in sorted(m._series.items()):
                    acc = 0
                    for ub, c in zip(m.buckets, counts):
                        acc += c
                        lk = _fmt_labels(k + (("le", _fmt_num(ub)),))
                        lines.append(f"{name}_bucket{lk} {acc}")
                    lk = _fmt_labels(k + (("le", "+Inf"),))
                    lines.append(f"{name}_bucket{lk} {n}")
                    lines.append(f"{name}_sum{_fmt_labels(k)} {repr(s)}")
                    lines.append(f"{name}_count{_fmt_labels(k)} {n}")
            else:
                for _nm, k, v in m.samples():
                    lines.append(f"{name}{_fmt_labels(k)} {_fmt_num(v)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        return {name: {"type": m.kind, "help": m.help,
                       "samples": m.snapshot()}
                for name, m in sorted(self._metrics.items())}


# ---- process-wide default registry ----------------------------------------

_default = MetricsRegistry()
_enabled = True
_tls = threading.local()
_step_cb = None
_span_listeners: list = []  # (exit_cb, enter_cb | None) pairs
_step_listeners: list = []  # post-step callbacks (memory ledger)


def add_span_listener(cb, on_enter=None):
    """Register `cb(path, seconds, attrs)` to be called when any
    `span()` region exits (path is the slash-joined span path, seconds
    its wall time), and optionally `on_enter(path)` when one opens.
    Listeners fire in registration order, children before parents
    (spans exit LIFO), and exceptions are swallowed — a broken listener
    must never break the instrumented code path. The goodput module uses
    this to classify run wall time into goodput/badput buckets without
    re-instrumenting the span sites (the enter hook lets it reserve
    in-flight spans so a mid-span scrape doesn't misbook them)."""
    _span_listeners.append((cb, on_enter))
    return cb


def remove_span_listener(cb):
    """Unregister a span listener added with add_span_listener (no-op
    if it was never registered). Equality, not identity: bound methods
    compare equal across attribute accesses but are distinct objects."""
    _span_listeners[:] = [p for p in _span_listeners if p[0] != cb]


def add_step_listener(cb):
    """Register `cb(seconds)` to run at the END of record_step — i.e.
    after the model committed the step's new state buffers, unlike the
    model.step SPAN exit, which fires while the donated pre-step
    buffers are already freed but the new ones not yet assigned. The
    memory ledger snapshots from here so params attribute to live
    arrays. Exceptions are swallowed; unlike `set_step_callback`
    (single slot, introspect's MFU hook), this is a listener list."""
    _step_listeners.append(cb)
    return cb


def remove_step_listener(cb):
    """Unregister a step listener (equality match, like spans)."""
    _step_listeners[:] = [c for c in _step_listeners if c != cb]


def start_diag_server(port=None, **kwargs):
    """Start the live diagnostics HTTP server (`diag`): /metrics,
    /healthz, /statusz, /flightz, ... on an ephemeral port by default
    (port=0), or `SINGA_TPU_DIAG_PORT` when `port` is None. Returns the
    running DiagServer. Imported at the call: observe stays
    import-light."""
    from . import diag
    return diag.start_diag_server(port=port, **kwargs)


def set_step_callback(cb):
    """Register (or clear with None) a hook fed each record_step's
    wall seconds. The introspect module uses it to derive the
    `singa_mfu_pct` gauge from the step build's counted flops without
    adding any work to the step path when no step has been built."""
    global _step_cb
    _step_cb = cb


def get_registry() -> MetricsRegistry:
    return _default


def enable(flag: bool = True):
    """Master switch for the built-in instrumentation hooks (the
    record_* helpers become no-ops; explicit metric objects still work)."""
    global _enabled
    _enabled = bool(flag)


def is_enabled() -> bool:
    return _enabled


def counter(name, help="") -> Counter:
    return _default.counter(name, help)


def gauge(name, help="") -> Gauge:
    return _default.gauge(name, help)


def histogram(name, help="", buckets=None) -> Histogram:
    return _default.histogram(name, help, buckets=buckets)


def set_event_log(log: "EventLog | str | None"):
    """Attach a JSONL EventLog (or a path, or None to detach) that every
    emitted step/serving/bench record is appended to."""
    if isinstance(log, str):
        log = EventLog(log)
    _default.event_log = log
    return log


def get_event_log():
    return _default.event_log


def to_prometheus_text() -> str:
    return _default.to_prometheus_text()


def dump(path: str | None = None) -> dict:
    """One JSON-able snapshot of every registered metric (and the recent
    in-memory event records). With `path`, also written to disk — the
    pull-less analog of a Prometheus scrape for batch jobs."""
    data = {"ts": round(time.time(), 6),
            "metrics": _default.snapshot(),
            "recent_events": list(_default.recent)}
    if path:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=1, default=str)
    return data


# ---- spans -----------------------------------------------------------------

SPAN_TRACE_PREFIX = "singa.span/"
_profiler = None


def _profiler_range(path):
    """A torch.profiler.record_function range for `path` while a profile
    is active, else None (a range nobody records costs ~10 us a span).
    torch is imported at the first span: this module stays
    import-light."""
    global _profiler
    if _profiler is None:
        import torch.autograd.profiler
        _profiler = torch.autograd.profiler
    if not getattr(_profiler, "_is_profiler_enabled", True):
        return None
    return _profiler.record_function(SPAN_TRACE_PREFIX + path)

# Span-record ring: bounded deque of finished span/collective regions as
# {"name", "t0" (perf_counter at enter), "dur", "tid", "kind"} dicts —
# the raw material the fleet module serializes into per-worker telemetry
# shards and the merged Perfetto trace. Off (None) by default: the ring
# costs one dict per span exit, which only a fleet shard writer needs.
_span_records: "deque | None" = None


def enable_span_records(capacity: int = 4096) -> None:
    """Start buffering finished spans (and collective host stamps) into
    a bounded in-memory ring of `capacity` records. Idempotent; a second
    call resizes the ring, keeping the newest records."""
    global _span_records
    old = _span_records
    ring = deque(old or (), maxlen=int(capacity))
    _span_records = ring


def disable_span_records() -> None:
    """Drop the ring and stop buffering (fleet teardown)."""
    global _span_records
    _span_records = None


def span_records_enabled() -> bool:
    return _span_records is not None


def span_records() -> list:
    """A snapshot (copy) of the current ring, oldest first."""
    ring = _span_records
    return list(ring) if ring is not None else []


def _record_span_entry(name, t0, dur, kind="span"):
    ring = _span_records
    if ring is not None:
        ring.append({"name": name, "t0": round(float(t0), 7),
                     "dur": round(float(dur), 7),
                     "tid": threading.get_ident(), "kind": kind})


def note_span(name, t0, dur, kind="span", tid=None):
    """Append one SYNTHETIC finished-span record to the span ring — a
    region measured by other means (wall stamps across a process
    startup, a reconstructed phase) that should ride the same
    shard -> merged-trace pipeline as `span()` regions. `t0` is a
    perf_counter stamp (the clock the fleet handshake aligns); `tid`
    places the slice on a chosen track (default: the calling thread).
    No-op while the ring is off, like every span exit."""
    ring = _span_records
    if ring is not None:
        ring.append({"name": str(name), "t0": round(float(t0), 7),
                     "dur": round(max(0.0, float(dur)), 7),
                     "tid": int(tid) if tid is not None
                     else threading.get_ident(),
                     "kind": str(kind)})


def current_span() -> "str | None":
    stack = getattr(_tls, "span_stack", None)
    return stack[-1] if stack else None


class suppress_spans:
    """Context manager: `span()` regions entered on THIS thread while
    active are no-ops (no histogram, no trace annotation, no listener
    callbacks). For background worker threads whose internal waits must
    not be attributed as run wall time — the overlap prefetcher runs
    its source iterator under this, so a wrapped NumpyBatchIter's own
    data.wait spans don't book overlapped producer time into the
    goodput `data_wait` bucket the prefetch exists to drain. Reentrant
    (a depth counter, not a flag)."""

    def __enter__(self):
        _tls.suppress = getattr(_tls, "suppress", 0) + 1
        return self

    def __exit__(self, exc_type, exc, tb):
        _tls.suppress = max(0, getattr(_tls, "suppress", 1) - 1)
        return False


def spans_suppressed() -> bool:
    """True while `suppress_spans` is active on the calling thread —
    for metric sites that should also stay quiet on suppressed worker
    threads (data.py's consumer-blocked histogram: a background
    prefetch producer is not the training loop)."""
    return bool(getattr(_tls, "suppress", 0))


class span:
    """`with span("serving.prefill", tokens=4096): ...`

    Nests: the recorded label is the slash-joined path of enclosing spans
    ("model.step/opt.apply_updates"), so one histogram
    (`singa_span_seconds{span=...}`) holds the whole hierarchy. The same
    path, prefixed `singa.span/`, names a `torch.profiler.record_function`
    range, so an active torch.profiler carries these spans beside the
    device's kernels. Host-side only: inside a CUDA-graph capture the
    span times the capture, not a step.
    """

    __slots__ = ("name", "attrs", "path", "_t0", "_ann", "_off")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.path = None
        self._ann = None
        self._off = False

    def __enter__(self):
        if getattr(_tls, "suppress", 0):
            self._off = True  # suppress_spans active on this thread
            return self
        stack = getattr(_tls, "span_stack", None)
        if stack is None:
            stack = _tls.span_stack = []
        self.path = f"{stack[-1]}/{self.name}" if stack else self.name
        stack.append(self.path)
        try:
            self._ann = _profiler_range(self.path)
            if self._ann is not None:
                self._ann.__enter__()
        except Exception:
            self._ann = None  # no profiler: hist-only span
        for _cb, enter_cb in tuple(_span_listeners):
            if enter_cb is not None:
                try:
                    enter_cb(self.path)
                except Exception:
                    pass
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._off:
            return False
        dt = time.perf_counter() - self._t0
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:
                pass
        stack = getattr(_tls, "span_stack", None)
        if stack and stack[-1] == self.path:
            stack.pop()
        if _enabled:
            _default.histogram(
                "singa_span_seconds",
                "wall seconds per span() region (label: slash-joined "
                "span path)").observe(dt, span=self.path)
        _record_span_entry(self.path, self._t0, dt)
        for cb, _enter_cb in tuple(_span_listeners):
            try:
                cb(self.path, dt, self.attrs)
            except Exception:
                pass  # a listener must never break the spanned code
        return False


# ---- framework instrumentation hooks ---------------------------------------
# Called from the hot paths (model/opt/serving/communicator/bench). Each is
# a no-op when disabled; none of them may raise into the training loop.

def record_step_build(seconds: float):
    """Wall time of a new step signature's first call (the eager warm-up
    of a graph-mode step, or on the CPU its first eager run)."""
    if not _enabled:
        return
    histogram("singa_step_build_seconds",
              "Model._build_step wall seconds").observe(seconds)


def record_compile(batch_class, recompile: bool = False,
                   donated_bytes: int | None = None):
    """A new compiled step variant: first-ever -> compile, later
    batch-size classes / step tags -> recompile. `batch_class` is the
    leading batch dim (a new one is a new CUDA graph)."""
    if not _enabled:
        return
    bc = str(batch_class)
    if recompile:
        counter("singa_model_recompile_total",
                "step retraces beyond the first compile, per batch-size "
                "class").inc(batch_class=bc)
    counter("singa_model_compile_total",
            "compiled step variants, per batch-size class"
            ).inc(batch_class=bc)
    if donated_bytes is not None:
        gauge("singa_step_donated_bytes",
              "bytes of state+opt buffers donated into the compiled "
              "step").set(float(donated_bytes))


def record_hbm(device):
    """Per-step device-memory gauges from the caching allocator
    (`torch.cuda.memory_stats`): `singa_hbm_bytes_in_use` is
    `allocated_bytes.all.current`, `singa_hbm_peak_bytes_in_use`
    `reserved_bytes.all.peak`, `singa_hbm_bytes_limit` the card's total
    memory. On the CPU, where no allocator keeps counters, the in-use
    gauge falls back to the memory ledger's live total
    (`memory.hbm_fallback_bytes`: the installed CPU ledger's latest
    snapshot, else a throttled enumeration), so `singa_hbm_bytes_in_use`
    always exists after a step, as in the JAX package."""
    if not _enabled:
        return
    import torch
    td = torch.device(getattr(device, "torch_device", device))
    if td.type != "cuda":
        from . import memory
        try:
            total = memory.hbm_fallback_bytes()
        except Exception:
            return  # a telemetry hook must never break the step
        gauge("singa_hbm_bytes_in_use",
              "device bytes in use").set(float(total))
        return
    try:
        stats = torch.cuda.memory_stats(td)
        limit = torch.cuda.get_device_properties(td).total_memory
    except Exception:
        return
    gauge("singa_hbm_bytes_in_use", "device bytes in use").set(
        float(stats.get("allocated_bytes.all.current", 0)))
    gauge("singa_hbm_bytes_limit", "device bytes limit").set(float(limit))
    gauge("singa_hbm_peak_bytes_in_use", "peak device bytes in use").set(
        float(stats.get("reserved_bytes.all.peak", 0)))


def record_step(seconds: float, batch=None, tag=0, device=None):
    """One Model train step (un-fenced dispatch wall time: on an async
    backend this is submit latency; fenced latency is the verbosity>0
    `dev.step_times` path / `singa_step_fenced_seconds`)."""
    if not _enabled:
        return
    histogram("singa_step_seconds",
              "train step dispatch wall seconds").observe(seconds)
    c = counter("singa_steps_total", "train steps invoked")
    c.inc()
    if device is not None:
        record_hbm(device)
    if _step_cb is not None:
        try:
            _step_cb(seconds)
        except Exception:
            pass  # a derived-metric hook must never break the step
    for listener in tuple(_step_listeners):
        try:
            listener(seconds)
        except Exception:
            pass  # a listener must never break the step
    _default.emit({"kind": "step", "step": int(c.value()),
                   "seconds": round(seconds, 9),
                   "batch": batch, "tag": tag})


def record_step_fenced(seconds: float):
    """Fenced (synchronized) step latency — recorded by the
    verbosity>0 profiling path alongside dev.step_times."""
    if not _enabled:
        return
    histogram("singa_step_fenced_seconds",
              "train step fenced wall seconds").observe(seconds)
    if _step_cb is not None:
        # fenced latency is the honest MFU denominator; feed it too (the
        # callback drops physically impossible un-fenced samples itself)
        try:
            _step_cb(seconds)
        except Exception:
            pass


def record_opt_update(n_params: int, seconds: float, strategy: str):
    """Optimizer apply-updates pass: fires each time the update body runs
    on the host (every eager step; under a CUDA graph at the warm-up and
    the capture, not at a replay; see the module docstring)."""
    if not _enabled:
        return
    counter("singa_opt_updates_total",
            "parameter updates applied (per trace under jit)"
            ).inc(n_params, strategy=strategy)
    histogram("singa_opt_apply_seconds",
              "apply-updates wall seconds (trace cost under jit)"
              ).observe(seconds, strategy=strategy)


def record_comm(op: str, nbytes: int, world_size: int = 1):
    """One collective call, by op and payload bytes: every verb of
    `parallel.Communicator` books one where it runs on the host (each
    eager step; a CUDA-graph step's warm-up and capture)."""
    if not _enabled:
        return
    if op not in COMM_OPS:
        op = COMM_OPS[-1]  # "other": never mint unbounded op= values
    counter("singa_comm_calls_total",
            "collectives in traced/eager programs").inc(op=op)
    if world_size > 1:
        counter("singa_comm_bytes_total",
                "payload bytes per traced collective"
                ).inc(float(nbytes), op=op)


def record_comm_host(op: str, start: float, seconds: float):
    """Host-side entry/exit stamp of one collective call site: its wall
    time, and a record in the span ring (kind "comm") when one is
    enabled."""
    if not _enabled:
        return
    label = op if op in COMM_OPS else COMM_OPS[-1]
    histogram("singa_comm_host_seconds",
              "host wall seconds per collective call site (trace cost "
              "under jit, per-call on the eager path)"
              ).observe(seconds, op=label)
    _record_span_entry(f"comm.{op}", start, seconds, kind="comm")


def record_decode(kind: str, seconds: float, new_tokens: int, batch: int,
                  ttft: float | None = None, prompt_tokens: int = 0):
    """One serving decode call (end-to-end, fenced)."""
    if not _enabled:
        return
    histogram("singa_serving_decode_seconds",
              "end-to-end decode seconds").observe(seconds, kind=kind)
    if ttft is not None:
        histogram("singa_serving_ttft_seconds",
                  "time to first token (prefill + first sample)"
                  ).observe(ttft, kind=kind)
    counter("singa_serving_tokens_total",
            "generated tokens").inc(float(new_tokens), kind=kind)
    counter("singa_serving_requests_total",
            "decode calls").inc(kind=kind)
    tps = new_tokens / seconds if seconds > 0 else 0.0
    gauge("singa_serving_tokens_per_sec",
          "last decode call's generation rate").set(tps, kind=kind)
    gauge("singa_serving_batch_occupancy",
          "sequences in the last decode batch").set(float(batch), kind=kind)
    _default.emit({"kind": "serving", "decode": kind,
                   "seconds": round(seconds, 6),
                   "ttft_seconds": round(ttft, 6) if ttft is not None
                   else None,
                   "new_tokens": new_tokens, "batch": batch,
                   "prompt_tokens": prompt_tokens,
                   "tokens_per_sec": round(tps, 3)})


def record_prefetch(depth: "int | None" = None,
                    blocked_s: "float | None" = None,
                    produced: bool = False):
    """DevicePrefetcher telemetry (the overlap module): ring occupancy,
    consumer blocked-time on an empty ring (the wall time its data.wait
    span also feeds into the goodput `data_wait` bucket), and batches
    the producer moved to the device."""
    if not _enabled:
        return
    if depth is not None:
        gauge("singa_prefetch_ring_depth",
              "on-device batches ready in the prefetch ring"
              ).set(float(depth))
    if blocked_s is not None:
        histogram("singa_prefetch_blocked_seconds",
                  "wall seconds the consumer blocked on an empty "
                  "prefetch ring").observe(blocked_s)
    if produced:
        counter("singa_prefetch_batches_total",
                "batches the prefetcher moved to the device").inc()


def record_ckpt_async(pending: int, blocking_s: "float | None" = None):
    """Async-checkpoint telemetry (the overlap module): in-flight save
    count, and — when a save just started — how long it blocked the
    caller before handing the write to the background thread."""
    if not _enabled:
        return
    gauge("singa_checkpoint_async_pending",
          "async checkpoint saves started but not yet durable"
          ).set(float(pending))
    if blocking_s is not None:
        histogram("singa_checkpoint_async_blocking_seconds",
                  "wall seconds save_checkpoint blocked before returning "
                  "(async path)").observe(blocking_s)
        counter("singa_checkpoint_async_total",
                "async checkpoint saves started").inc()


def record_checkpoint_bytes(nbytes: int):
    """Bytes of the checkpoint/snapshot flush that just completed
    (Model.save_states, Model.save_checkpoint's host copy,
    Snapshot.flush's store)."""
    if not _enabled:
        return
    gauge("singa_checkpoint_bytes_written",
          "bytes in the last checkpoint/snapshot flush").set(float(nbytes))


def record_scaler_decision(rec: dict):
    """Mirror one shadow-scaler decision record (the capacity module's
    ledger line) into the in-memory event ring and any attached
    EventLog, so scaling decisions interleave with the step/serving/
    bench records they were made from. Counters/gauges stay in
    capacity._metrics — this is only the event-stream copy."""
    if not _enabled:
        return
    # kind last: the ledger line carries its own kind ("decision")
    _default.emit({**rec, "kind": "scaler_decision"})


def record_regress_verdict(rec: dict):
    """Mirror one regression conviction (the regress module's verdict
    record) into the in-memory event ring and any attached EventLog, so
    convictions interleave with the step/serving records that produced
    them. Counters/gauges stay in regress._metrics — this is only the
    event-stream copy."""
    if not _enabled:
        return
    _default.emit({**rec, "kind": "regress_verdict"})


def record_bench(rec: dict):
    """Mirror a bench.py result record into the registry (gauges named
    singa_bench_<field>) and the EventLog, so BENCH_*.json artifacts and
    runtime telemetry share one schema."""
    if not _enabled:
        return
    for k, v in rec.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        name = "singa_bench_" + re.sub(r"[^a-z0-9_]", "_", str(k).lower())
        gauge(name, "bench.py result field"
              ).set(float(v), metric=str(rec.get("metric", "")))
    _default.emit({"kind": "bench", **rec})


__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "EventLog",
    "span", "suppress_spans", "spans_suppressed", "current_span",
    "get_registry", "enable", "is_enabled", "COMM_OPS",
    "counter", "gauge", "histogram", "set_event_log", "get_event_log",
    "to_prometheus_text", "dump", "DEFAULT_BUCKETS", "SPAN_TRACE_PREFIX",
    "set_step_callback", "add_span_listener", "remove_span_listener",
    "add_step_listener", "remove_step_listener",
    "start_diag_server",
    "enable_span_records", "disable_span_records", "span_records",
    "span_records_enabled", "note_span",
    "record_step", "record_step_build", "record_step_fenced",
    "record_compile", "record_hbm", "record_opt_update", "record_comm",
    "record_comm_host",
    "record_decode", "record_bench", "record_scaler_decision",
    "record_regress_verdict", "record_checkpoint_bytes",
    "record_prefetch", "record_ckpt_async",
]
