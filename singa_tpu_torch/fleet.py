"""Fleet observability (counterpart of singa_tpu/fleet.py): cross-process
telemetry, merged into one surface.

Every worker process has its own registry, diag server and flight
recorder; this module is the layer across them, keyed by
`distributed.host_label()`:

  - **ShardWriter** (every worker): serializes the process's telemetry
    (metrics snapshot, goodput buckets, health verdict, memory regions,
    the watchdog's hang verdict, the serving snapshot and the recent
    span-record ring, `observe.enable_span_records`) to a shared spool
    directory as `fleet_dir/worker_<pid>.shard.jsonl`. Each publish
    rewrites the whole file via tmp + atomic `os.replace` with a
    monotonic `seq`, under the watchdog's `fleet_publish` guard and the
    fault point "fleet.publish". The header carries a paired
    `(time.time(), time.perf_counter())` clock sample, the handshake
    that aligns every worker's span stamps onto one wall clock. The
    format is the JAX package's (`SHARD_VERSION` 1, the same line kinds
    in the same order): a shard written by either package is read by
    the other's `read_shard` and `FleetAggregator`. The `fleet_capacity`
    line carries `capacity.fleet_capacity_snapshot()` and `fleet_audit`
    `audit.fleet_audit_snapshot()`; `fleet_regress` carries null until
    `regress` is ported (ROADMAP.md Queue 1 item 7), which is what the
    JAX package writes when no detector is installed.

  - **FleetAggregator** (the coordinator): scans the spool, merges shards
    into fleet rollups (counters summed, histograms bucket-wise, gauges
    per host with min/max/mean), tracks staleness, scores stragglers as
    `(host - median) / median` over each worker's step spans and
    collective stamps (`singa_comm_host_seconds`, kind "comm" records
    from `parallel.Communicator`'s `_comm_stamp`), sustains verdicts into
    the active `health.HealthMonitor` (`note_external`), escalates a
    peer's abort-stage hang verdict (`take_peer_hang`), majority-votes the
    `fleet_audit` fingerprints (a dissenter goes to the audit
    observatory, or to the health monitor without one) and exports the
    merged Chrome/Perfetto trace, one track per host, with the router's
    own track when one is installed.

  - `check_straggler_halt()` is `resilience.TrainController`'s per-step
    hook; the diag server serves `/fleetz` and `/fleetz/trace`.

CLI: `python -m singa_tpu_torch.fleet --ab [--device cpu] --out
FLEET_torch.json` runs the subprocess straggler A/B: N workers (each one
process on `--device`, the card by default), one with a FaultPlan delay on
its collectives (`fault_point("comm.collective")`), and a coordinator
that must detect the straggler within K steps from /fleetz and export a
schema-valid merged trace showing the injected gap. A worker trains
`resilience._worker_build`'s MLP (or, with `--synthetic`, runs a
model-free span and collective loop); it is one process, so its mesh is
one device (`--mesh-devices 1`).
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import tempfile
import threading
import time

import torch

from . import distributed, health, observe, slo

SHARD_VERSION = 1
SHARD_SUFFIX = ".shard.jsonl"

#: span-record leaf names the straggler detector treats as one train step
STEP_SPAN_LEAF = "model.step"

#: how many of a worker's most recent step/collective samples feed its
#: straggler signal (older samples describe a previous regime)
_SIGNAL_WINDOW = 32

#: per-worker cap on span records retained for the merged trace
_TRACE_SPANS_PER_WORKER = 20_000


class FleetStragglerError(health.HealthError):
    """Raised by `check_straggler_halt` once a sustained straggler
    verdict lands under the halt policy. A HealthError on purpose:
    `resilience.TrainController` already routes HealthError through its
    save-then-stop path (final checkpoint, manifest status "halt") and
    attaches the run report — this adds `.hosts`, the slow host(s) an
    elastic restart should exclude."""

    def __init__(self, msg, hosts=(), score=None):
        super().__init__(msg)
        self.hosts = tuple(hosts)
        self.score = score


# ---- metrics ---------------------------------------------------------------

def _writer_metrics():
    # observe.counter/gauge spelled out so the static lint sees them
    return {
        "publishes": observe.counter(
            "singa_fleet_shard_publish_total",
            "telemetry shard publishes by this worker"),
        "errors": observe.counter(
            "singa_fleet_shard_publish_errors_total",
            "telemetry shard publishes that failed"),
        "seq": observe.gauge(
            "singa_fleet_shard_seq_last",
            "sequence number of this worker's last published shard"),
    }


def _agg_metrics():
    return {
        "polls": observe.counter(
            "singa_fleet_polls_total",
            "aggregator spool scans"),
        "workers": observe.gauge(
            "singa_fleet_workers",
            "worker shards the aggregator currently tracks"),
        "stale": observe.gauge(
            "singa_fleet_workers_stale",
            "tracked workers whose shard stopped aging forward"),
        "score": observe.gauge(
            "singa_fleet_straggler_score",
            "per-host deviation from the fleet-median step/collective "
            "time ((host - median)/median, floored at 0)"),
        "age": observe.gauge(
            "singa_fleet_shard_age_seconds",
            "seconds since each worker's last shard publish"),
        "seq": observe.gauge(
            "singa_fleet_shard_seq",
            "per-host sequence number of the last shard seen"),
        "rate": observe.gauge(
            "singa_fleet_step_rate",
            "per-host train steps per second (between shard publishes)"),
        "goodput": observe.gauge(
            "singa_fleet_goodput_ratio",
            "per-host productive share of wall time, from each "
            "worker's goodput snapshot"),
        "mem": observe.gauge(
            "singa_fleet_mem_bytes",
            "per-host total live device bytes, from each worker's "
            "memory-ledger region snapshot"),
        "sustained": observe.counter(
            "singa_fleet_straggler_sustained_total",
            "sustained-straggler verdicts by host"),
        "serve_rps": observe.gauge(
            "singa_fleet_serve_rps",
            "per-host serving-engine terminal requests per second, "
            "from each worker's fleet_serve snapshot"),
        "slo_att": observe.gauge(
            "singa_fleet_slo_attainment_pct",
            "per-host worst-objective SLO attainment percent, from "
            "each worker's fleet_serve snapshot"),
    }


# ---- shard writing ---------------------------------------------------------

class ShardWriter:
    """Publishes this process's telemetry to `fleet_dir` as an atomic
    JSONL shard with a monotonic `seq`.

    `interval_s > 0` starts a daemon publisher thread
    (`singa-fleet-shard-<pid>`); `interval_s = 0` means manual-only
    (`publish()`), which tests use. `fleet_dir=None` creates a temp
    spool dir (owned by this module; `fleet.uninstall()` removes it).
    Enables the observe span-record ring so recent spans and collective
    stamps ride along in every shard.
    """

    def __init__(self, fleet_dir: "str | None" = None,
                 interval_s: float = 0.5, host: "str | None" = None,
                 name: "str | None" = None, span_capacity: int = 4096):
        if fleet_dir is None:
            fleet_dir = tempfile.mkdtemp(prefix="singa_fleet_")
            _owned_dirs.append(fleet_dir)
        self.fleet_dir = os.path.abspath(fleet_dir)
        os.makedirs(self.fleet_dir, exist_ok=True)
        self.host = host or distributed.host_label()
        self.pid = os.getpid()
        self.interval_s = float(interval_s)
        base = name or f"worker_{self.pid}"
        self.path = os.path.join(self.fleet_dir, base + SHARD_SUFFIX)
        self.seq = 0
        self.started_ts = time.time()
        self._plock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        observe.enable_span_records(span_capacity)
        _writers.append(self)
        if self.interval_s > 0:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"singa-fleet-shard-{self.pid}")
            self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.publish()
            except Exception:
                # a broken publish must never kill the publisher (the
                # next tick retries); it is counted, not raised
                try:
                    _writer_metrics()["errors"].inc()
                except Exception:
                    pass

    def _snapshot_lines(self):
        header = {
            "kind": "fleet_shard_header", "version": SHARD_VERSION,
            "seq": self.seq, "host": self.host, "pid": self.pid,
            # the clock handshake: one paired (epoch, monotonic) sample
            # per publish — the aggregator maps this worker's span
            # stamps onto the shared wall clock via ts - perf
            "ts": round(time.time(), 6),
            "perf": round(time.perf_counter(), 7),
            "started_ts": round(self.started_ts, 6),
            "steps": self._steps(),
        }
        lines = [header,
                 {"kind": "fleet_metrics",
                  "metrics": observe.get_registry().snapshot()}]
        gp = None
        try:
            from . import goodput
            tracker = goodput.get_tracker()
            if tracker is not None:
                gp = tracker.snapshot()
        except Exception:
            gp = None
        lines.append({"kind": "fleet_goodput", "goodput": gp})
        mon = health.active_monitor()
        lines.append({"kind": "fleet_health",
                      "verdict": mon.verdict() if mon is not None
                      else None})
        mem = None
        try:
            from . import memory
            led = memory.get_ledger()
            if led is not None:
                mem = led.region_bytes()  # per-host region snapshot
        except Exception:
            mem = None
        lines.append({"kind": "fleet_mem", "mem": mem})
        hang = None
        try:
            # the watchdog's hang verdict rides every shard: this is
            # how a WEDGED worker (one that cannot step, let alone be
            # merely slow) becomes visible to the rest of the fleet —
            # the aggregator escalates a peer's abort-stage verdict
            # fleet-wide (check_straggler_halt)
            from . import watchdog
            hang = watchdog.hang_report()
        except Exception:
            hang = None
        lines.append({"kind": "fleet_hang", "hang": hang})
        serve = None
        try:
            # the serving view (slo): live engine occupancy/
            # queue/RPS/TTFT + SLO attainment, plus the recent request
            # timelines and decode-sync records the merged trace needs
            # to show requests flowing through this replica
            serve = slo.fleet_serve_snapshot()
        except Exception:
            serve = None
        lines.append({"kind": "fleet_serve", "serve": serve})
        # this replica's own headroom row (capacity): derived from the
        # SAME serve signals the line above publishes, so the
        # coordinator's headroom column reconciles against the shard by
        # construction, plus the local shadow scaler's last decision
        from . import audit, capacity
        lines.append({"kind": "fleet_capacity",
                      "capacity": capacity.fleet_capacity_snapshot()})
        # this replica's param fingerprint (audit): the aggregator
        # majority-votes these across replicas serving the same model
        lines.append({"kind": "fleet_audit",
                      "audit": audit.fleet_audit_snapshot()})
        # the regression rollup: null until regress is ported (ROADMAP.md
        # Queue 1 item 7), as the JAX package writes it with none
        # installed
        lines.append({"kind": "fleet_regress", "regress": None})
        for rec in observe.span_records():
            lines.append({"kind": "fleet_span", "name": rec["name"],
                          "t0": rec["t0"], "dur": rec["dur"],
                          "tid": rec["tid"],
                          "span_kind": rec.get("kind", "span")})
        return lines

    @staticmethod
    def _steps() -> int:
        c = observe.get_registry().get("singa_steps_total")
        return int(c.value()) if c is not None else 0

    def publish(self) -> int:
        """Serialize one shard and atomically replace the previous one.
        Returns the published sequence number. The watchdog arms its
        `fleet_publish` deadline over the write (a wedged spool — dead
        NFS, full disk blocking forever — must not silently turn this
        worker invisible to the fleet); `fleet.publish` is the
        deterministic FaultPlan hook."""
        from . import resilience, watchdog
        with self._plock, watchdog.guard("fleet_publish"):
            resilience.fault_point("fleet.publish")
            self.seq += 1
            lines = self._snapshot_lines()
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                for rec in lines:
                    f.write(json.dumps(rec, separators=(",", ":"),
                                       default=str) + "\n")
                f.flush()
            os.replace(tmp, self.path)
            m = _writer_metrics()
            m["publishes"].inc()
            m["seq"].set(float(self.seq))
            return self.seq

    def close(self, final_publish: bool = True):
        """Stop the publisher thread (joined) and optionally publish one
        last shard so the spool holds this worker's final state."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_publish:
            try:
                self.publish()
            except Exception:
                pass
        if self in _writers:
            _writers.remove(self)


def read_shard(path: str) -> "dict | None":
    """Parse one shard file back into {"header", "metrics", "goodput",
    "health", "spans"} — None when the file is missing or carries no
    valid header (an interrupted worker start; atomic replace means a
    PUBLISHED shard is never torn)."""
    rows = observe.EventLog.read(path)
    header = next((r for r in rows
                   if r.get("kind") == "fleet_shard_header"), None)
    if header is None or not isinstance(header.get("seq"), int):
        return None
    return {
        "header": header,
        "metrics": next((r.get("metrics") for r in rows
                         if r.get("kind") == "fleet_metrics"), None) or {},
        "goodput": next((r.get("goodput") for r in rows
                         if r.get("kind") == "fleet_goodput"), None),
        "health": next((r.get("verdict") for r in rows
                        if r.get("kind") == "fleet_health"), None),
        "mem": next((r.get("mem") for r in rows
                     if r.get("kind") == "fleet_mem"), None),
        "hang": next((r.get("hang") for r in rows
                      if r.get("kind") == "fleet_hang"), None),
        "serve": next((r.get("serve") for r in rows
                       if r.get("kind") == "fleet_serve"), None),
        "capacity": next((r.get("capacity") for r in rows
                          if r.get("kind") == "fleet_capacity"), None),
        "audit": next((r.get("audit") for r in rows
                       if r.get("kind") == "fleet_audit"), None),
        "regress": next((r.get("regress") for r in rows
                         if r.get("kind") == "fleet_regress"), None),
        "spans": [r for r in rows if r.get("kind") == "fleet_span"],
    }


# ---- merging ---------------------------------------------------------------

def merge_metric_snapshots(snaps: dict) -> dict:
    """Merge per-host registry snapshots ({host: snapshot}) into fleet
    rollups: counters and histograms are SUMMED across hosts (bucket-wise
    for histograms — cumulative counts sum to cumulative counts), gauges
    are kept per-host and summarized as min/max/mean. Label sets within
    a metric merge by their label key."""
    merged = {}
    for hostname, snap in sorted(snaps.items()):
        for name, m in (snap or {}).items():
            kind = m.get("type")
            out = merged.setdefault(name, {"type": kind, "series": {}})
            if out["type"] != kind:
                continue  # conflicting types across hosts: first wins
            for s in m.get("samples", []):
                key = tuple(sorted((s.get("labels") or {}).items()))
                row = out["series"].setdefault(
                    key, {"labels": dict(key)})
                if kind == "histogram":
                    row["count"] = row.get("count", 0) + s.get("count", 0)
                    row["sum"] = row.get("sum", 0.0) + s.get("sum", 0.0)
                    buckets = row.setdefault("buckets", {})
                    for ub, c in (s.get("buckets") or {}).items():
                        buckets[ub] = buckets.get(ub, 0) + c
                elif kind == "counter":
                    row["value"] = row.get("value", 0.0) + s.get("value",
                                                                 0.0)
                else:  # gauge (and anything unknown): per-host detail
                    per = row.setdefault("per_host", {})
                    per[hostname] = s.get("value", 0.0)
                    vals = list(per.values())
                    row["min"] = min(vals)
                    row["max"] = max(vals)
                    row["mean"] = sum(vals) / len(vals)
    return merged


# ---- the aggregator --------------------------------------------------------

class _WorkerState:
    __slots__ = ("path", "host", "pid", "seq", "ts", "perf", "steps",
                 "started_ts", "metrics", "goodput", "health", "mem",
                 "hang", "serve", "capacity", "audit", "regress",
                 "spans",
                 "prev_ts", "prev_steps", "step_rate", "over_since")

    def __init__(self, path):
        self.path = path
        self.host = None
        self.pid = None
        self.seq = -1
        self.ts = 0.0
        self.perf = 0.0
        self.steps = 0
        self.started_ts = 0.0
        self.metrics = {}
        self.goodput = None
        self.health = None
        self.mem = None   # per-host memory-ledger region snapshot
        self.hang = None  # per-host watchdog hang verdict (sticky)
        self.serve = None  # per-host serving snapshot (slo.fleet_serve)
        self.capacity = None  # per-host headroom row (fleet_capacity)
        self.audit = None  # per-host param fingerprint (fleet_audit)
        self.regress = None  # per-host detector rollup (fleet_regress)
        self.spans = {}   # (tid, t0, name) -> span rec, insertion-ordered
        self.prev_ts = None
        self.prev_steps = 0
        self.step_rate = 0.0
        self.over_since = 0  # consecutive polls above the threshold

    @property
    def clock_offset(self) -> float:
        """epoch seconds corresponding to this worker's perf_counter 0 —
        the handshake: ts and perf were sampled together at publish."""
        return self.ts - self.perf


class FleetAggregator:
    """Coordinator-side merge of the spool directory's worker shards.

    `poll()` re-scans the spool, updates per-worker state, recomputes
    straggler scores and exports the `singa_fleet_*` gauges; `rollup()`
    returns the last poll's fleet-level view. `policy` overrides the
    active HealthMonitor's policy for the sustained-straggler verdict
    (None = inherit the monitor's, default "warn"); under "halt" the
    verdict is held sticky for `check_straggler_halt()` to raise from
    the training loop.
    """

    def __init__(self, fleet_dir: str, stale_after_s: float = 5.0,
                 threshold: float = 0.5, sustain: int = 3,
                 policy: "str | None" = None,
                 poll_interval_s: float = 0.5,
                 background_poll: bool = False):
        self.fleet_dir = os.path.abspath(fleet_dir)
        self.stale_after_s = float(stale_after_s)
        self.threshold = float(threshold)
        self.sustain = int(sustain)
        if policy is not None and policy not in health.POLICIES:
            raise ValueError(
                f"policy {policy!r} not in {health.POLICIES}")
        self.policy = policy
        self.poll_interval_s = float(poll_interval_s)
        self._lock = threading.Lock()
        self._workers: "dict[str, _WorkerState]" = {}
        self._scores: "dict[str, float]" = {}
        self._stale: "dict[str, float]" = {}  # host -> age seconds
        self._halt: "dict | None" = None
        self._sustained: "set[str]" = set()
        # hang escalation: a peer's abort-stage watchdog verdict, held
        # sticky until the training loop consumes it (take_peer_hang).
        # `_hang_seen` de-duplicates by (host, verdict id) so one hang
        # episode triggers exactly ONE coordinated abort-and-restore.
        self._peer_hang: "dict | None" = None
        self._hang_seen: "set[tuple]" = set()
        # fingerprint vote: host -> dissent info while the host's
        # param fingerprint disagrees with the fleet majority;
        # `_audit_seen` de-duplicates the once-per-episode emit by
        # (host, fingerprint) so a persisting corruption logs once but
        # keeps feeding the observatory's streak every poll
        self._audit_dissent: "dict[str, dict]" = {}
        self._audit_seen: "set[tuple]" = set()
        self._last_poll = 0.0
        self.started_mono = time.monotonic()
        self._poll_stop = threading.Event()
        self._poll_thread = None
        if background_poll:
            self.start_polling()

    # -- polling -----------------------------------------------------------
    def _scan(self):
        try:
            names = os.listdir(self.fleet_dir)
        except OSError:
            names = []
        paths = [os.path.join(self.fleet_dir, n) for n in sorted(names)
                 if n.endswith(SHARD_SUFFIX)]
        # a worker whose shard file was removed (spool GC, relaunch
        # cleanup) is forgotten — otherwise ghost incarnations inflate
        # worker counts and keep feeding frozen signals forever
        live = set(paths)
        for path in list(self._workers):
            if path not in live:
                del self._workers[path]
        for path in paths:
            shard = read_shard(path)
            if shard is None:
                continue
            h = shard["header"]
            w = self._workers.get(path)
            if w is None:
                w = self._workers[path] = _WorkerState(path)
            if h["seq"] < w.seq:
                # a restarted worker reusing the shard path starts seq
                # over: RESET the state and accept the new incarnation
                # (skipping it would drop the restart's telemetry until
                # its seq caught up with the dead one's)
                w = self._workers[path] = _WorkerState(path)
            fresh = h["seq"] > w.seq
            if fresh:
                w.prev_ts, w.prev_steps = w.ts or None, w.steps
            w.seq = h["seq"]
            w.host = h.get("host") or f"pid{h.get('pid')}"
            w.pid = int(h.get("pid") or 0)
            w.ts = float(h.get("ts") or 0.0)
            w.perf = float(h.get("perf") or 0.0)
            w.steps = int(h.get("steps") or 0)
            w.started_ts = float(h.get("started_ts") or 0.0)
            w.metrics = shard["metrics"]
            w.goodput = shard["goodput"]
            w.health = shard["health"]
            w.mem = shard.get("mem")
            w.hang = shard.get("hang")
            w.serve = shard.get("serve")
            w.capacity = shard.get("capacity")
            w.audit = shard.get("audit")
            w.regress = shard.get("regress")
            if fresh and w.prev_ts and w.ts > w.prev_ts:
                w.step_rate = max(
                    0.0, (w.steps - w.prev_steps) / (w.ts - w.prev_ts))
            for rec in shard["spans"]:
                key = (rec.get("tid"), rec.get("t0"), rec.get("name"))
                w.spans[key] = rec
            if len(w.spans) > _TRACE_SPANS_PER_WORKER:
                drop = len(w.spans) - _TRACE_SPANS_PER_WORKER
                for key in list(w.spans)[:drop]:
                    del w.spans[key]

    @staticmethod
    def _signal(w: "_WorkerState", want_comm: bool) -> "float | None":
        """Mean duration of this worker's recent step or collective
        records, or None when it has published none yet."""
        durs = []
        for rec in reversed(list(w.spans.values())):
            if want_comm:
                hit = rec.get("span_kind") == "comm"
            else:
                name = rec.get("name") or ""
                hit = name.rsplit("/", 1)[-1] == STEP_SPAN_LEAF
            if hit:
                durs.append(float(rec.get("dur") or 0.0))
                if len(durs) >= _SIGNAL_WINDOW:
                    break
        return (sum(durs) / len(durs)) if durs else None

    def _score_locked(self):
        """(host -> straggler score): per signal (step time, collective
        time), deviation from the fleet median across hosts that have
        the signal; a host's score is the worst of its signals."""
        scores = {}
        for want_comm in (False, True):
            vals = {}
            freshest = {}
            for w in self._workers.values():
                if w.host is None:
                    continue
                v = self._signal(w, want_comm)
                if v is None:
                    continue
                # two shard files can carry the same host label (a dead
                # incarnation's file next to its relaunch): the NEWEST
                # publish owns the host's signal, regardless of scan
                # order
                if w.host not in freshest or w.ts > freshest[w.host]:
                    freshest[w.host] = w.ts
                    vals[w.host] = v
            if len(vals) < 2:
                continue  # a fleet of one has no median to deviate from
            med = statistics.median(vals.values())
            for hostname, v in vals.items():
                s = max(0.0, (v - med) / max(med, 1e-9))
                scores[hostname] = max(scores.get(hostname, 0.0), s)
        # hosts with no signal at all still appear (score 0) so /fleetz
        # lists every tracked worker
        for w in self._workers.values():
            if w.host is not None:
                scores.setdefault(w.host, 0.0)
        return scores

    def _resolved_policy(self) -> str:
        if self.policy is not None:
            return self.policy
        mon = health.active_monitor()
        if mon is not None and mon.policy == "halt":
            return "halt"
        return "warn"

    def _export_locked(self, now_epoch: float):
        """Export the singa_fleet_* gauges. Every host= label value here
        originates from distributed.host_label() on the worker that
        published the shard; the coordinator's own label (host_label())
        marks the local row in rollup()/fleet_report."""
        local = distributed.host_label()
        m = _agg_metrics()
        m["workers"].set(float(len(self._workers)))
        m["stale"].set(float(len(self._stale)))
        # oldest-first so a host label shared by a dead incarnation and
        # its relaunch gets the FRESHEST shard's values in the gauges
        for w in sorted(self._workers.values(), key=lambda w: w.ts):
            if w.host is None:
                continue
            m["age"].set(max(0.0, now_epoch - w.ts), host=w.host)
            m["seq"].set(float(w.seq), host=w.host)
            m["rate"].set(w.step_rate, host=w.host)
            if isinstance(w.goodput, dict):
                m["goodput"].set(
                    float(w.goodput.get("goodput_ratio") or 0.0),
                    host=w.host)
            if isinstance(w.mem, dict):
                m["mem"].set(float(w.mem.get("total_bytes") or 0.0),
                             host=w.host)
            if isinstance(w.serve, dict):
                m["serve_rps"].set(float(w.serve.get("rps") or 0.0),
                                   host=w.host)
                att = slo.serve_attainment_pct(w.serve)
                if att is not None:
                    m["slo_att"].set(att, host=w.host)
        for hostname, score in self._scores.items():
            m["score"].set(score, host=hostname)
        return local

    def _verdicts_locked(self):
        """Advance per-host sustained-straggler state; fire policy
        actions on the poll that crosses `sustain`."""
        fired = []
        for w in self._workers.values():
            if w.host is None:
                continue
            if self._scores.get(w.host, 0.0) > self.threshold:
                w.over_since += 1
            else:
                w.over_since = 0
                self._sustained.discard(w.host)
            if w.over_since >= self.sustain \
                    and w.host not in self._sustained:
                self._sustained.add(w.host)
                fired.append((w.host, self._scores.get(w.host, 0.0)))
        return fired

    def _apply_policy(self, fired):
        """Outside the lock: metric/emit/monitor plumbing for each new
        sustained verdict (host values originate from host_label() on
        the workers; see _export_locked)."""
        if not fired:
            return
        policy = self._resolved_policy()
        mon = health.active_monitor()
        # every hostname below was minted by distributed.host_label()
        # on the worker that published it; the coordinator's own label
        # tags the verdict's origin
        local = distributed.host_label()
        for hostname, score in fired:
            _agg_metrics()["sustained"].inc(host=hostname)
            observe.get_registry().emit(
                {"kind": "fleet", "event": "straggler_sustained",
                 "host": hostname, "coordinator": local,
                 "score": round(score, 4), "policy": policy})
            if mon is not None:
                try:
                    # pass the RESOLVED action: the aggregator's policy
                    # may override the monitor's, and /healthz must not
                    # claim a halt that never happened (or vice versa)
                    mon.note_external(
                        health.KIND_STRAGGLER,
                        detail={"host": hostname,
                                "score": round(score, 4)},
                        action="halt" if policy == "halt" else "warn")
                except Exception:
                    pass  # the monitor must not break the aggregator
            if policy == "halt" and self._halt is None:
                self._halt = {"host": hostname,
                              "score": round(score, 4),
                              "ts": round(time.time(), 6)}

    def _audit_vote_locked(self):
        """Majority-vote the param-integrity fingerprints (the
        fleet_audit shard line; a JAX worker's `audit`) across hosts serving
        the same model. A host whose fingerprint disagrees with a
        STRICT majority (> half of >= 3 voters — two replicas cannot
        outvote each other, and without a majority nobody is convicted)
        is a dissenter: silent data corruption, flagged with the first
        diverging layer-group named. Returns the dissent list for
        _apply_audit (outside the lock)."""
        fps = {}
        freshest = {}
        for w in self._workers.values():
            a = w.audit
            if w.host is None or not isinstance(a, dict):
                continue
            fp = a.get("fingerprint")
            if not fp:
                continue
            # newest publish owns a host's vote (dead incarnation's
            # file next to its relaunch — same rule as _score_locked)
            if w.host not in freshest or w.ts > freshest[w.host]:
                freshest[w.host] = w.ts
                try:
                    fps[w.host] = tuple(
                        (str(g), int(v)) for g, v in fp)
                except (TypeError, ValueError):
                    continue
        self._audit_dissent = {}
        if len(fps) < 3:
            return []
        counts = {}
        for fp in fps.values():
            counts[fp] = counts.get(fp, 0) + 1
        majority_fp, n = max(counts.items(), key=lambda kv: kv[1])
        if n <= len(fps) // 2:
            return []
        fired = []
        for hostname, fp in sorted(fps.items()):
            if fp == majority_fp:
                continue
            first = next(
                (g for (g, v), (_, mv) in zip(fp, majority_fp)
                 if v != mv), None)
            info = {"first_group": first, "voters": len(fps),
                    "majority": n}
            self._audit_dissent[hostname] = info
            fired.append((hostname, fp, info))
        return fired

    def _apply_audit(self, fired):
        """Outside the lock: feed each fingerprint dissenter into the
        audit observatory (which owns sustain + quarantine) — EVERY
        poll while the dissent persists, so the observatory's streak
        builds at poll cadence; the EventLog record and the
        no-observatory health-note fallback fire once per (host,
        fingerprint) episode."""
        if not fired:
            return
        from . import audit as audit_mod
        obs = audit_mod.get_observatory()
        local = distributed.host_label()
        mon = health.active_monitor()
        for hostname, fp, info in fired:
            key = (hostname, fp)
            new = key not in self._audit_seen
            if new:
                self._audit_seen.add(key)
                if observe.is_enabled():
                    observe.get_registry().emit(
                        {"kind": "audit",
                         "event": "fingerprint_dissent",
                         "host": hostname, "coordinator": local,
                         **info})
            detail = (f"fingerprint dissent: first diverging group "
                      f"{info['first_group']} "
                      f"({info['majority']}/{info['voters']} voters "
                      f"agree)")
            if obs is not None:
                obs.note(hostname, audit_mod.LEG_FINGERPRINT,
                         audit_mod.VERDICT_MISMATCH, detail=detail)
            elif new and mon is not None:
                try:
                    # a verdict is health state, not telemetry: even
                    # without an observatory the dissent must reach
                    # /healthz
                    mon.note_external(
                        health.KIND_DIVERGENCE,
                        detail={"host": hostname, **info},
                        action="warn")
                except Exception:
                    pass  # the monitor must not break the aggregator

    def audit_dissent(self) -> dict:
        """host -> dissent info for hosts currently outvoted on their
        param fingerprint (empty when the fleet agrees)."""
        with self._lock:
            return {k: dict(v) for k, v in self._audit_dissent.items()}

    def _hangs_locked(self):
        """Advance peer-hang state: a worker whose shard carries an
        abort-stage watchdog verdict is WEDGED (it could not step at
        all — a different failure class from a straggler, which is
        merely slow). A peer's verdict (host != this process's label)
        is held for the training loop, which raises it as a HangError
        so every worker aborts-and-restores together — the only
        recovery that works when a collective is missing a
        participant. Each (host, id) escalates exactly once."""
        local = distributed.host_label()
        for w in self._workers.values():
            h = w.hang
            if not isinstance(h, dict) or h.get("stage") != "abort":
                continue
            key = (w.host, h.get("id"))
            if w.host == local or key in self._hang_seen:
                continue
            self._hang_seen.add(key)
            if self._peer_hang is None:
                self._peer_hang = {"host": w.host, **h}

    def peer_hang(self) -> "dict | None":
        """The pending (unconsumed) peer-hang verdict, or None."""
        return self._peer_hang

    def take_peer_hang(self) -> "dict | None":
        """Consume the pending peer-hang verdict (one coordinated
        abort per hang episode)."""
        with self._lock:
            h = self._peer_hang
            self._peer_hang = None
            return h

    def poll(self) -> dict:
        """Re-scan the spool and return the fresh rollup."""
        now_epoch = time.time()
        with self._lock:
            self._scan()
            self._hangs_locked()
            self._scores = self._score_locked()
            self._stale = {
                w.host: round(now_epoch - w.ts, 3)
                for w in self._workers.values()
                if w.host is not None
                and now_epoch - w.ts > self.stale_after_s}
            fired = self._verdicts_locked()
            audit_fired = self._audit_vote_locked()
            self._export_locked(now_epoch)
            self._last_poll = time.monotonic()
        _agg_metrics()["polls"].inc()
        self._apply_policy(fired)
        self._apply_audit(audit_fired)
        return self.rollup()

    def poll_if_due(self):
        if self._poll_thread is not None:
            return  # the background thread owns the cadence
        if time.monotonic() - self._last_poll >= self.poll_interval_s:
            self.poll()

    # -- background polling ------------------------------------------------
    def start_polling(self):
        """Run poll() on a daemon thread (`singa-fleet-agg`) instead of
        the caller's cadence — for big fleets, where a synchronous spool
        rescan (every shard read + parsed) inside the training loop's
        `check_straggler_halt` would steal step time. The training hook
        then only reads the sticky halt verdict. Idempotent;
        `stop_polling` / `uninstall_aggregator` join the thread."""
        if self._poll_thread is not None and self._poll_thread.is_alive():
            return
        self._poll_stop.clear()

        def _loop():
            while not self._poll_stop.wait(
                    max(self.poll_interval_s, 0.05)):
                try:
                    self.poll()
                except Exception:
                    pass  # a bad shard scan must not kill the cadence

        self._poll_thread = threading.Thread(
            target=_loop, daemon=True, name="singa-fleet-agg")
        self._poll_thread.start()

    def stop_polling(self):
        self._poll_stop.set()
        t = self._poll_thread
        self._poll_thread = None
        if t is not None:
            t.join(timeout=5.0)

    # -- reading -----------------------------------------------------------
    def workers(self) -> list:
        with self._lock:
            return sorted((w for w in self._workers.values()
                           if w.host is not None),
                          key=lambda w: (w.host, w.pid))

    def straggler_scores(self) -> dict:
        with self._lock:
            return dict(self._scores)

    def halt_verdict(self) -> "dict | None":
        return self._halt

    def clear_halt(self):
        self._halt = None

    def rollup(self) -> dict:
        """The fleet-level view of the last poll: per-host rows plus the
        merged metric rollups."""
        now_epoch = time.time()
        with self._lock:
            rows = []
            for w in sorted(self._workers.values(),
                            key=lambda w: (w.host or "", w.pid or 0)):
                if w.host is None:
                    continue
                rows.append({
                    "host": w.host, "pid": w.pid, "seq": w.seq,
                    "age_s": round(max(0.0, now_epoch - w.ts), 3),
                    "stale": w.host in self._stale,
                    "steps": w.steps,
                    "step_rate": round(w.step_rate, 3),
                    "goodput_ratio":
                        round(float(w.goodput.get("goodput_ratio")), 4)
                        if isinstance(w.goodput, dict) else None,
                    "straggler_score":
                        round(self._scores.get(w.host, 0.0), 4),
                    "sustained": w.host in self._sustained,
                    "health": (w.health or {}).get("status")
                        if isinstance(w.health, dict) else None,
                    "hang": dict(w.hang)
                        if isinstance(w.hang, dict) else None,
                    "mem_bytes": int(w.mem.get("total_bytes") or 0)
                        if isinstance(w.mem, dict) else None,
                    "mem_regions": dict(w.mem.get("regions") or {})
                        if isinstance(w.mem, dict) else None,
                    # the per-replica serving columns:
                    # RPS, queue, occupancy, page util, TTFT, kv-cache
                    # bytes from the memory ledger, SLO attainment
                    "serve": {
                        "rps": w.serve.get("rps"),
                        "queue_depth": w.serve.get("queue_depth"),
                        "occupancy": w.serve.get("occupancy"),
                        "slots": w.serve.get("slots"),
                        "page_util": w.serve.get("page_util"),
                        "kv_cache_bytes": w.serve.get("kv_cache_bytes"),
                        "decode_tok_s": w.serve.get("decode_tok_s"),
                        "ttft_p50_s": w.serve.get("ttft_p50_s"),
                        "ttft_p99_s": w.serve.get("ttft_p99_s"),
                        "finished": w.serve.get("finished"),
                        "slo_attainment_pct":
                            slo.serve_attainment_pct(w.serve),
                        "slo_breaching":
                            ((w.serve.get("slo") or {})
                             .get("breaching") or []),
                        # graceful-drain visibility:
                        # the router shows a replica as draining the
                        # moment its engine stops admitting
                        "draining": bool(w.serve.get("draining")),
                    } if isinstance(w.serve, dict) else None,
                    # the replica's own headroom row (fleet_capacity
                    # shard line): binding wall + headroom for the
                    # /fleetz column, last shadow decision when the
                    # worker runs a scaler
                    "capacity": dict(w.capacity)
                    if isinstance(w.capacity, dict) else None,
                    # param-integrity audit (fleet_audit shard line):
                    # the fingerprint itself plus this poll's vote
                    # outcome for the /fleetz integrity column
                    "audit": {
                        "fingerprint": list(
                            w.audit.get("fingerprint") or []),
                        "count": w.audit.get("count"),
                        "dissent": dict(
                            self._audit_dissent.get(w.host) or {})
                        or None,
                    } if isinstance(w.audit, dict) else None,
                    # regression observatory (fleet_regress shard
                    # line): active-episode count + last verdict for
                    # the /fleetz regression column and the
                    # localization vote
                    "regress": dict(w.regress)
                    if isinstance(w.regress, dict) else None,
                })
            # worst-HBM host: max live bytes across workers that
            # published a memory snapshot (freshest shard per host
            # already won above)
            with_mem = [r for r in rows if r["mem_bytes"] is not None]
            worst = max(with_mem, key=lambda r: r["mem_bytes"]) \
                if with_mem else None
            merged = merge_metric_snapshots(
                {w.host: w.metrics for w in self._workers.values()
                 if w.host is not None})
            return {
                "fleet_dir": self.fleet_dir,
                "n_workers": len(rows),
                "n_stale": len(self._stale),
                "threshold": self.threshold,
                "sustain": self.sustain,
                "policy": self._resolved_policy(),
                "workers": rows,
                "stragglers": sorted(self._sustained),
                "wedged": sorted(r["host"] for r in rows
                                 if r["hang"] is not None
                                 and r["hang"].get("stage") == "abort"),
                "halt": self._halt,
                "peer_hang": self._peer_hang,
                "audit_dissent": {k: dict(v) for k, v
                                  in self._audit_dissent.items()},
                "worst_mem_host": worst["host"] if worst else None,
                "worst_mem_bytes": worst["mem_bytes"] if worst else None,
                "metrics": merged,
            }

    # -- merged trace ------------------------------------------------------
    def trace_events(self) -> dict:
        """The merged Chrome Trace Event Format object: one process
        (track) per worker, span + collective slices on it, clocks
        aligned onto the shared wall timeline via each worker's
        (epoch, perf_counter) handshake."""
        events = []
        with self._lock:
            workers = [w for w in self._workers.values()
                       if w.host is not None]
            workers.sort(key=lambda w: (w.host, w.pid))
            for i, w in enumerate(workers):
                events.append({"ph": "M", "name": "process_name",
                               "pid": w.pid, "tid": 0,
                               "args": {"name": f"{w.host} "
                                                f"(pid {w.pid})"}})
                events.append({"ph": "M", "name": "process_sort_index",
                               "pid": w.pid, "tid": 0,
                               "args": {"sort_index": i}})
                off = w.clock_offset
                startup_tids = set()
                for rec in w.spans.values():
                    t0 = rec.get("t0")
                    dur = rec.get("dur")
                    if t0 is None or dur is None:
                        continue
                    if (rec.get("span_kind") or "span") == "startup":
                        # the replica cold-start observatory's phase
                        # slices ride the span ring on a synthetic tid
                        # — name the track once below
                        startup_tids.add(int(rec.get("tid") or 0))
                    events.append({
                        "name": (rec.get("name") or "?"
                                 ).rsplit("/", 1)[-1],
                        "cat": rec.get("span_kind") or "span",
                        "ph": "X",
                        "ts": round((float(t0) + off) * 1e6, 3),
                        "dur": round(float(dur) * 1e6, 3),
                        "pid": w.pid,
                        "tid": int(rec.get("tid") or 0),
                        "args": {"path": rec.get("name"),
                                 "host": w.host},
                    })
                for tid in sorted(startup_tids):
                    events.append({"ph": "M", "name": "thread_name",
                                   "pid": w.pid, "tid": tid,
                                   "args": {"name": "startup"}})
                if isinstance(w.serve, dict):
                    # the request-level serving view: per-request
                    # queued/prefill/decode spans + decode-step slices
                    # + the flow events linking them, aligned onto the
                    # shared wall clock via the SAME handshake offset —
                    # a multi-replica trace shows requests flowing
                    # through workers. When the worker's span ring
                    # already published serving.engine_step slices
                    # (span records on, the normal case), the sync ring
                    # must not overlay near-identical duplicates on the
                    # same tid — the flows bind inside the real ones.
                    have_step_spans = any(
                        (rec.get("name") or "").rsplit("/", 1)[-1]
                        == "serving.engine_step"
                        for rec in w.spans.values())
                    # finished timelines PLUS the in-flight ones the
                    # shard carried at publish: a replica SIGKILLed
                    # mid-request leaves its partial work (the victim
                    # track of a failover trace) in `active`
                    timelines = list(w.serve.get("timelines") or [])
                    timelines.extend(w.serve.get("active") or [])
                    syncs = w.serve.get("syncs") or []
                    events.extend(slo._track_metadata(
                        timelines, syncs, w.pid))
                    events.extend(slo.request_trace_events(
                        timelines, syncs, w.pid, offset=off,
                        emit_sync_slices=not have_step_spans))
        # the router's own track (queue + dispatch hops + the
        # cross-process trace_ctx flow ends), when this process IS the
        # routing coordinator — replicas join the flow by trace id
        try:
            from . import router as router_mod
            if router_mod.get_router() is not None:
                events.extend(router_mod.router_trace_events())
        except Exception:
            pass
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_trace(self, path: str) -> str:
        """Write the merged trace JSON to `path` (open it in Perfetto /
        chrome://tracing) and return the path."""
        trace = self.trace_events()
        with open(path, "w", encoding="utf-8") as f:
            json.dump(trace, f, separators=(",", ":"))
        return path


# ---- module singletons -----------------------------------------------------

_writers: "list[ShardWriter]" = []
_owned_dirs: "list[str]" = []
_shard_writer: "ShardWriter | None" = None
_aggregator: "FleetAggregator | None" = None
_lock = threading.Lock()


def start_shard_writer(fleet_dir: "str | None" = None,
                       **kwargs) -> ShardWriter:
    """Start (or return) the process shard writer. A second call with a
    DIFFERENT fleet_dir replaces the old writer (closed first)."""
    global _shard_writer
    with _lock:
        w = _shard_writer
        if w is not None:
            if fleet_dir is None \
                    or os.path.abspath(fleet_dir) == w.fleet_dir:
                return w
            w.close()
        _shard_writer = ShardWriter(fleet_dir, **kwargs)
        return _shard_writer


def stop_shard_writer():
    """Close the process shard writer (idempotent)."""
    global _shard_writer
    with _lock:
        if _shard_writer is not None:
            _shard_writer.close()
            _shard_writer = None


def get_shard_writer() -> "ShardWriter | None":
    return _shard_writer


def install_aggregator(fleet_dir: "str | None" = None,
                       **kwargs) -> FleetAggregator:
    """Install (or return) the process FleetAggregator — the object
    /fleetz, check_straggler_halt and export_trace answer from. May be
    passed a ready FleetAggregator via `fleet_dir=None, aggregator=`."""
    global _aggregator
    agg = kwargs.pop("aggregator", None)
    with _lock:
        if agg is not None:
            if _aggregator is not None and _aggregator is not agg:
                _aggregator.stop_polling()  # don't leak the old cadence
            _aggregator = agg
            return agg
        if _aggregator is not None:
            return _aggregator
        if fleet_dir is None:
            raise ValueError("install_aggregator needs a fleet_dir "
                             "(or aggregator=)")
        _aggregator = FleetAggregator(fleet_dir, **kwargs)
        return _aggregator


def uninstall_aggregator():
    global _aggregator
    with _lock:
        agg = _aggregator
        _aggregator = None
    if agg is not None:
        agg.stop_polling()


def get_aggregator() -> "FleetAggregator | None":
    return _aggregator


def uninstall():
    """Full fleet teardown (the conftest contract): every shard writer
    closed (threads joined), the aggregator dropped, the span-record
    ring disabled, and spool temp dirs this module created removed."""
    stop_shard_writer()
    for w in list(_writers):
        w.close(final_publish=False)
    uninstall_aggregator()
    observe.disable_span_records()
    for d in list(_owned_dirs):
        shutil.rmtree(d, ignore_errors=True)
        _owned_dirs.remove(d)


def export_trace(path: str) -> str:
    """Poll the installed aggregator and write the merged trace JSON."""
    agg = _aggregator
    if agg is None:
        raise RuntimeError("no FleetAggregator installed "
                           "(fleet.install_aggregator(fleet_dir))")
    agg.poll()
    return agg.export_trace(path)


def check_straggler_halt(step: "int | None" = None):
    """Training-loop hook (resilience.TrainController calls it every
    step): no-op without an aggregator; otherwise polls on the
    aggregator's cadence and raises FleetStragglerError once a sustained
    straggler verdict landed under the halt policy — or, when a PEER
    published an abort-stage watchdog hang verdict, raises
    `watchdog.HangError` so this worker aborts-and-restores in lockstep
    with the wedged one (the coordinated recovery a missing-participant
    collective requires; consumed once per hang episode). Raising from
    the LOOP (not the aggregator's caller) is the point — the
    controller's HealthError path saves a final checkpoint and attaches
    the report, and its HangError path restores-and-restarts."""
    agg = _aggregator
    if agg is None:
        return
    agg.poll_if_due()
    h = agg.halt_verdict()
    if h is not None:
        raise FleetStragglerError(
            f"sustained straggler {h['host']} "
            f"(score {h['score']:.2f} > {agg.threshold:.2f} for "
            f"{agg.sustain} polls); elastic restart should exclude it"
            + (f" [step {step}]" if step is not None else ""),
            hosts=(h["host"],), score=h["score"])
    ph = agg.take_peer_hang()
    if ph is not None:
        from . import watchdog
        observe.get_registry().emit(
            {"kind": "fleet", "event": "peer_hang",
             "host": ph.get("host"), "op": ph.get("op"),
             "seconds": ph.get("seconds"), "step": step})
        raise watchdog.HangError(
            f"peer {ph.get('host')} wedged in {ph.get('op')!r} "
            f"({ph.get('seconds')}s past its deadline): coordinated "
            "abort-and-restore"
            + (f" [step {step}]" if step is not None else ""),
            op=ph.get("op"), seconds=ph.get("seconds"),
            hosts=(ph.get("host"),))


def fleet_report() -> str:
    """Text block for /fleetz: one row per worker plus fleet rollups."""
    agg = _aggregator
    if agg is None:
        return ("no FleetAggregator installed "
                "(singa_tpu_torch.fleet.install_aggregator(fleet_dir))")
    roll = agg.poll()
    local = distributed.host_label()
    lines = [
        f"== fleet ==  coordinator pid {os.getpid()}  "
        f"spool {roll['fleet_dir']}",
        f"workers: {roll['n_workers']} ({roll['n_stale']} stale)   "
        f"policy: {roll['policy']}   "
        f"straggler threshold: {roll['threshold']:.2f} "
        f"(sustain {roll['sustain']} polls)",
        f"{'host':<12} {'pid':>7} {'seq':>5} {'age_s':>7} {'steps':>7} "
        f"{'step/s':>8} {'goodput':>8} {'mem_mb':>8} {'straggler':>10} "
        f"state",
    ]
    for r in roll["workers"]:
        # wedged outranks everything: a worker with an abort-stage hang
        # verdict could not step AT ALL (vs. a straggler, merely slow)
        state = "WEDGED" if (r.get("hang") or {}).get("stage") \
            == "abort" else (
            "STALE" if r["stale"] else (
                "STRAGGLER" if r["sustained"] else (r["health"] or "ok")))
        mark = "*" if r["host"] == local else " "
        gp = f"{r['goodput_ratio']:.2f}" \
            if r["goodput_ratio"] is not None else "-"
        mem = f"{r['mem_bytes'] / 1e6:.1f}" \
            if r.get("mem_bytes") is not None else "-"
        lines.append(
            f"{r['host']:<11}{mark} {r['pid']:>7} {r['seq']:>5} "
            f"{r['age_s']:>7.2f} {r['steps']:>7} "
            f"{r['step_rate']:>8.2f} {gp:>8} {mem:>8} "
            f"{r['straggler_score']:>10.3f} {state}")
    serving = [r for r in roll["workers"] if r.get("serve")]
    if serving:
        lines.append("== fleet serving ==")
        lines.append(
            f"{'host':<12} {'rps':>7} {'queue':>6} {'occ':>7} "
            f"{'pages':>7} {'ttft_p50_ms':>12} {'ttft_p99_ms':>12} "
            f"{'kv_mb':>8} {'slo_pct':>8} {'headroom':>9} breaching")
        for r in serving:
            s = r["serve"]
            cap = r.get("capacity") or {}
            head = f"{100.0 * cap['headroom_frac']:.0f}%" \
                   f"({cap.get('wall') or '-'})" \
                if cap.get("headroom_frac") is not None else "-"
            occ = f"{s['occupancy']}/{s['slots']}" \
                if s.get("slots") is not None else "-"
            pu = f"{100.0 * s['page_util']:.0f}%" \
                if s.get("page_util") is not None else "-"
            p50 = f"{s['ttft_p50_s'] * 1e3:.1f}" \
                if s.get("ttft_p50_s") is not None else "-"
            p99 = f"{s['ttft_p99_s'] * 1e3:.1f}" \
                if s.get("ttft_p99_s") is not None else "-"
            kv = f"{s['kv_cache_bytes'] / 1e6:.2f}" \
                if s.get("kv_cache_bytes") is not None else "-"
            att = f"{s['slo_attainment_pct']:.1f}" \
                if s.get("slo_attainment_pct") is not None else "-"
            lines.append(
                f"{r['host']:<12} {s.get('rps') or 0.0:>7.2f} "
                f"{s.get('queue_depth') or 0:>6} {occ:>7} {pu:>7} "
                f"{p50:>12} {p99:>12} {kv:>8} {att:>8} {head:>9} "
                f"{','.join(s.get('slo_breaching') or []) or 'none'}"
                + (" [draining]" if s.get("draining") else ""))
    audited = [r for r in roll["workers"] if r.get("audit")]
    if audited:
        # the correctness columns: each replica's fingerprint (folded
        # to one word for the table; /auditz has the per-group view)
        # and the vote outcome — a dissenter names its first diverging
        # layer group right here
        lines.append("== fleet integrity ==")
        lines.append(f"{'host':<12} {'fingerprint':>12} {'checks':>7} "
                     f"vote")
        for r in audited:
            a = r["audit"]
            folded = 0
            for _, v in (a.get("fingerprint") or []):
                folded = (folded * 16777619) ^ int(v)
                folded &= 0xFFFFFFFF
            d = a.get("dissent")
            vote = (f"DISSENT (first diverging group: "
                    f"{d.get('first_group')}, "
                    f"{d.get('majority')}/{d.get('voters')} against)"
                    if d else "agree")
            lines.append(f"{r['host']:<12} {folded:>#12x} "
                         f"{a.get('count') or 0:>7} {vote}")
    # the serving control plane, when one is installed in this process
    # (the router coordinator is usually also the fleet coordinator)
    try:
        from . import router as _router_mod
        lines.extend(_router_mod.fleetz_lines())
    except Exception:
        pass
    # the correctness observatory's canary/replay verdict columns, when
    # one is installed in this process (the regress observatory's join
    # here with ROADMAP.md Queue 1 item 7)
    from . import audit as _audit_mod
    lines.extend(_audit_mod.fleetz_lines())
    steps_total = 0
    for s in (roll["metrics"].get("singa_steps_total") or
              {}).get("series", {}).values():
        steps_total += int(s.get("value", 0.0))
    worst = roll.get("worst_mem_host")
    lines.append(f"fleet steps: {steps_total}   "
                 f"sustained stragglers: "
                 f"{','.join(roll['stragglers']) or 'none'}   "
                 f"wedged: {','.join(roll['wedged']) or 'none'}   "
                 f"halt: {roll['halt'] or 'none'}   "
                 f"worst-HBM host: "
                 + (f"{worst} ({roll['worst_mem_bytes'] / 1e6:.1f} MB)"
                    if worst else "none (no memory shards)"))
    return "\n".join(lines)


# ---- CLI: the multi-process straggler A/B ----------------------------------
# `--worker` runs one telemetry-publishing training leg (the resilience
# harness's MLP, or --synthetic for a model-free span/collective loop) on
# `--device`; `--ab` spawns N workers, injects a FaultPlan delay into ONE
# worker's collectives (`fault_point("comm.collective")`), and asserts from
# the COORDINATOR side, via /fleetz and the exported merged trace, that the
# slow host is detected within K steps and visibly slow on its trace track.
# Writes FLEET_torch.json (the JAX package's FLEET_r01.json is its own).

def _require_device(device: str):
    """The card, unless the caller asked for the CPU: no CUDA device and
    `device` "cuda" raises (no fall-back to the CPU)."""
    if torch.device(device).type == "cuda":
        from .device import best_device
        best_device()  # RuntimeError naming device="cpu" when absent


def _worker_main(args) -> int:
    if args.host:
        os.environ["SINGA_FLEET_HOST"] = args.host
    _require_device(args.device)
    if args.mesh_devices != 1:
        raise ValueError(
            "a fleet worker is one process on one device: --mesh-devices "
            f"must be 1, got {args.mesh_devices} (a data mesh of N is N "
            "ranks, `python -m singa_tpu_torch.resilience --worker`)")
    if args.delay_collectives > 0:
        from . import resilience
        plan = resilience.FaultPlan()
        plan.delay("comm.collective", args.delay_collectives,
                   times=10 ** 9)
        resilience.install_fault_plan(plan)
    model = tx = ty = None
    if not args.synthetic:
        from .resilience import _worker_build
        model, tx, ty = _worker_build(args.mesh_devices, args.batch,
                                      args.seed, args.device)
        # the step's build (its warm-up call and, on the card, the
        # CUDA-graph capture at the second) before the span ring starts
        # and the counters restart: the straggler signal then reads
        # steady-state steps only, not each worker's build time, and the
        # shards count the run's own steps
        for _ in range(2):
            model(tx, ty)
        observe.get_registry().reset()
    writer = start_shard_writer(args.fleet_dir,
                                interval_s=args.publish_interval)
    from .parallel.communicator import Communicator
    comm = Communicator()  # world 1: the eager per-step host collective
    tick = torch.ones((), device=args.device)
    if args.start_barrier > 1:
        _start_barrier(writer, args.start_barrier, args.timeout)
    for _ in range(args.steps):
        t0 = time.perf_counter()
        if args.synthetic:
            with observe.span(STEP_SPAN_LEAF):
                if args.step_sleep:
                    time.sleep(args.step_sleep)
                comm.all_reduce(tick)
            observe.record_step(time.perf_counter() - t0)
        else:
            model(tx, ty)  # spans model.step + records the step itself
            comm.all_reduce(tick)
            if args.step_sleep:
                time.sleep(args.step_sleep)
        writer.publish()
    stop_shard_writer()
    print(json.dumps({"host": distributed.host_label(),
                      "steps": args.steps, "device": args.device,
                      "mode": "synthetic" if args.synthetic else "model"}))
    return 0


def _start_barrier(writer, n: int, timeout_s: float):
    """Publish this worker's first shard, then wait (at most `timeout_s`)
    until `n` shards are in the spool: every worker then steps from the
    same moment. A worker process takes seconds to import torch and reach
    its device, more than a whole run of steps takes, so without it the
    first worker up can finish before the last one starts."""
    writer.publish()
    deadline = time.monotonic() + float(timeout_s)
    while time.monotonic() < deadline:
        try:
            names = os.listdir(writer.fleet_dir)
        except OSError:
            names = []
        if sum(n_.endswith(SHARD_SUFFIX) for n_ in names) >= n:
            return
        time.sleep(0.01)


def _spawn_fleet_worker(py, root, args, idx, delay):
    import subprocess
    import sys
    env = dict(os.environ, SINGA_FLEET_HOST=f"host{idx}")
    env.pop("SINGA_TPU_DIAG_PORT", None)
    cmd = [py, "-m", "singa_tpu_torch.fleet", "--worker",
           "--fleet-dir", args.fleet_dir,
           "--steps", str(args.steps),
           "--step-sleep", str(args.step_sleep),
           "--publish-interval", str(args.publish_interval),
           "--mesh-devices", str(args.mesh_devices),
           "--batch", str(args.batch), "--seed", str(args.seed),
           "--delay-collectives", str(delay), "--device", args.device,
           "--start-barrier", str(args.workers),
           "--timeout", str(args.timeout)]
    if args.synthetic:
        cmd.append("--synthetic")
    return subprocess.Popen(cmd, cwd=root, env=env,
                            stdout=sys.stderr, stderr=sys.stderr)


def _http_get(url: str) -> bytes:
    from urllib.request import urlopen
    with urlopen(url, timeout=30) as r:
        return r.read()


def _ab_main(args) -> int:
    import sys
    _require_device(args.device)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    work = tempfile.mkdtemp(prefix="singa_fleet_ab_")
    args.fleet_dir = os.path.join(work, "spool")
    os.makedirs(args.fleet_dir, exist_ok=True)
    slow_idx = args.workers - 1
    slow_host = f"host{slow_idx}"
    rec = {"workers": args.workers, "steps": args.steps,
           "delay_s": args.delay, "threshold": args.threshold,
           "detect_steps": args.detect_steps, "slow_host": slow_host,
           "mode": "synthetic" if args.synthetic else "model",
           "device": args.device, "ok": False}
    agg = install_aggregator(args.fleet_dir, threshold=args.threshold,
                             stale_after_s=30.0,
                             poll_interval_s=0.05)
    from . import diag
    srv = diag.start_diag_server(port=0)
    procs = [_spawn_fleet_worker(sys.executable, root, args, i,
                                 args.delay if i == slow_idx else 0.0)
             for i in range(args.workers)]
    detected = False
    detect_steps = None
    detect_scores = None
    deadline = time.monotonic() + args.timeout
    try:
        while time.monotonic() < deadline:
            agg.poll()
            scores = agg.straggler_scores()
            if len(scores) == args.workers and not detected:
                slow = scores.get(slow_host, 0.0)
                others = [v for h, v in scores.items() if h != slow_host]
                if slow > args.threshold \
                        and all(v <= args.threshold for v in others):
                    detected = True
                    detect_scores = {h: round(v, 3)
                                     for h, v in scores.items()}
                    detect_steps = max(
                        (w.steps for w in agg.workers()
                         if w.host == slow_host), default=None)
            if all(p.poll() is not None for p in procs):
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        rec["worker_rcs"] = [p.returncode for p in procs]
        agg.poll()
        # the acceptance surface is the COORDINATOR's HTTP endpoints
        fleetz = _http_get(srv.url + "/fleetz").decode("utf-8")
        rec["fleetz_lists_all_hosts"] = all(
            f"host{i}" in fleetz for i in range(args.workers))
        rec["detected"] = detected
        rec["steps_at_detection"] = detect_steps
        rec["scores_at_detection"] = detect_scores
        rec["final_scores"] = {h: round(v, 3) for h, v
                               in agg.straggler_scores().items()}
        trace_bytes = _http_get(srv.url + "/fleetz/trace")
        trace = json.loads(trace_bytes)
        events = trace.get("traceEvents", [])
        tracks = {e["pid"] for e in events
                  if e.get("ph") == "M"
                  and e.get("name") == "process_name"}
        slow_pids = {e["pid"] for e in events
                     if e.get("ph") == "M"
                     and e.get("name") == "process_name"
                     and slow_host in str(e.get("args", {}).get("name"))}
        gap_us = max((e.get("dur", 0.0) for e in events
                      if e.get("ph") == "X" and e.get("cat") == "comm"
                      and e.get("pid") in slow_pids), default=0.0)
        schema_ok = (isinstance(events, list) and events
                     and all(isinstance(e.get("name"), str)
                             and "ph" in e and "pid" in e
                             for e in events)
                     and all("ts" in e and "dur" in e and "tid" in e
                             for e in events if e.get("ph") == "X"))
        rec["trace_schema_ok"] = bool(schema_ok)
        rec["trace_tracks"] = len(tracks)
        rec["trace_events"] = len(events)
        rec["slow_gap_ms"] = round(gap_us / 1000.0, 3)
        out_trace = os.path.abspath(args.trace_out) \
            if args.trace_out else None
        if out_trace:
            with open(out_trace, "wb") as f:
                f.write(trace_bytes)  # the body already fetched above
            rec["trace_path"] = out_trace
        rec["ok"] = bool(
            all(rc == 0 for rc in rec["worker_rcs"])
            and detected
            and (detect_steps is not None
                 and detect_steps <= args.detect_steps)
            and rec["fleetz_lists_all_hosts"]
            and schema_ok
            and len(tracks) == args.workers
            and gap_us >= args.delay * 1e6 * 0.8)
    finally:
        diag.stop_diag_server()
        uninstall()
        shutil.rmtree(work, ignore_errors=True)
    out = os.path.abspath(args.out)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps(rec, indent=1))
    return 0 if rec["ok"] else 1


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m singa_tpu_torch.fleet",
        description="fleet observability harness (worker + straggler A/B)")
    p.add_argument("--worker", action="store_true",
                   help="run one shard-publishing training leg")
    p.add_argument("--ab", action="store_true",
                   help="run the multi-process straggler A/B")
    p.add_argument("--fleet-dir", default=None)
    p.add_argument("--workers", type=int, default=3)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--step-sleep", type=float, default=0.03)
    p.add_argument("--publish-interval", type=float, default=0.1)
    p.add_argument("--mesh-devices", type=int, default=1,
                   help="devices of a worker's mesh: 1 (a worker is one "
                        "process)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--host", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="no model: span + eager-collective loop only")
    p.add_argument("--delay-collectives", type=float, default=0.0,
                   help="FaultPlan delay injected at comm.collective")
    p.add_argument("--start-barrier", type=int, default=0,
                   help="worker: publish once, then wait until this many "
                        "shards are in the spool before the first step "
                        "(the A/B passes --workers)")
    p.add_argument("--delay", type=float, default=0.05,
                   help="A/B: collective delay on the slow worker")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--detect-steps", type=int, default=5)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--trace-out", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where every worker runs")
    p.add_argument("--out", default="FLEET_torch.json")
    args = p.parse_args(argv)
    if args.worker:
        if not args.fleet_dir:
            p.error("--worker requires --fleet-dir")
        return _worker_main(args)
    if args.ab:
        return _ab_main(args)
    p.error("pass --worker or --ab")
    return 2


__all__ = [
    "ShardWriter", "FleetAggregator", "FleetStragglerError",
    "read_shard", "merge_metric_snapshots",
    "start_shard_writer", "stop_shard_writer", "get_shard_writer",
    "install_aggregator", "uninstall_aggregator", "get_aggregator",
    "uninstall", "export_trace", "check_straggler_halt", "fleet_report",
    "SHARD_VERSION", "SHARD_SUFFIX", "STEP_SPAN_LEAF",
]

if __name__ == "__main__":
    import sys
    # run under the CANONICAL module, not this __main__ alias: the CLI
    # installs module singletons (the aggregator, the shard writer) that
    # the diag server's handlers reach via `import singa_tpu_torch.fleet`;
    # under runpy those are two different module objects otherwise
    from singa_tpu_torch.fleet import main as _main
    sys.exit(_main())
