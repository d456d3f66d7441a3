"""Serving control plane (counterpart of singa_tpu/router.py): the
multi-replica router.

One `ServingEngine` is a single point of loss: its death takes every
in-flight and queued request with it. This module fronts N serving
REPLICAS (each a process running its own engine on the card, a diag
server and a fleet `ShardWriter`) behind one `Router` that owns each
request's fate end to end:

  - **Load balancing**: each dispatch picks the live replica with the
    lowest load score: the router's own in-flight count per replica plus
    the occupancy and queue-depth columns of that replica's fleet shard
    (the `fleet_serve` line of `slo.fleet_serve_snapshot`) when an
    aggregator over the shared spool is available.
  - **Admission control**: the router queue is bounded (`queue_limit`);
    a submit over it is shed at once as outcome "rejected", reason
    "shed".
  - **Request failover**: the router keeps every routed request's prompt
    and `max_new` until a terminal outcome. A replica that misses its
    calibrated liveness deadline over its shard publish intervals
    (`watchdog.calibrated_deadline`), confirmed by a failed `/healthz`
    probe, or whose process exited, is marked DEAD, and its requests are
    resubmitted to the survivors with bounded decorrelated-jitter
    retries. Greedy decode is deterministic and every replica builds the
    same model from a fixed seed (`_build_replica_model`), so a retried
    request returns the same tokens, up to the card's GEMM choice for
    another batch (ROADMAP.md, known differences).
  - **Graceful drain**: `drain_replica()` stops routing to a replica,
    asks it to `ServingEngine.stop(drain=True)` (in-flight requests
    finish, queued ones are handed back) and re-routes the handed-back
    requests to the survivors: no request is lost or "evicted".

Outcomes are exactly `ROUTE_OUTCOMES`, replica states `REPLICA_STATES`
and the shed/failover/retry reasons `ROUTE_REASONS`: the enums
tools/check_metrics_names.py rule 5 proves the `singa_route_*` label
values against. With a `retry_seed`, each request's retry delays are
`random.Random(retry_seed * 1_000_003 + id)`'s, as in the JAX package.

CLI: `python -m singa_tpu_torch.router --replica` runs one replica process
on `--device` (the card by default: the head width dim / 4 must then be
64 or 128, the flash kernel's); `--ab` is the kill-and-replace harness:
N replicas under `serving.poisson_workload`, SIGKILL one mid-traffic, a
pre-warmed standby joins, and the record (SERVE_torch.json) holds zero
lost requests, token-identical failover outputs, the p99 TTFT of both
arms, the tail attribution of a fault arm and each replica's cold-start
phases. Every replica installs `audit`'s param fingerprint (its
`--corrupt-after N` flips one layer at the Nth tick: the audit A/B's
injected corruption). The cold-vs-warm A/B (`--warm-ab`) comes with
`warmstart` (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from . import observe

#: terminal outcomes a routed request can reach — "completed" with
#: tokens, or "rejected" with a reason; there is no third state, which
#: is the zero-loss contract (a lost request would be outcome None
#: forever, and the --ab harness fails on exactly that)
ROUTE_OUTCOMES = ("completed", "rejected")
OUTCOME_COMPLETED = "completed"
OUTCOME_REJECTED = "rejected"

#: why the router shed, failed over, or gave up — the low-cardinality
#: `reason=` label set on singa_route_* counters (lint rule 5; the
#: aliases below are literal re-statements, the form the lint's
#: constant-resolution proves membership from)
ROUTE_REASONS = ("shed", "replica_dead", "drain", "retry_exhausted")
REASON_SHED = "shed"
REASON_REPLICA_DEAD = "replica_dead"
REASON_DRAIN = "drain"
REASON_RETRY_EXHAUSTED = "retry_exhausted"

#: replica lifecycle at the router: live (routable), draining (finishing
#: in-flight, not routable), dead (failed or retired; never revived —
#: a replacement JOINS instead)
REPLICA_STATES = ("live", "draining", "dead")
STATE_LIVE = "live"
STATE_DRAINING = "draining"
STATE_DEAD = "dead"

#: engine-side rejection details that are worth retrying on another
#: replica (transient/local conditions); anything else (over-length
#: prompt, page budget) would fail identically everywhere and is
#: passed through to the caller as a terminal rejection
RETRYABLE_DETAILS = ("queue full", "not running", "draining")

#: the replica cold-start phases, in lifecycle order — the `phase=`
#: label on singa_replica_startup_seconds (lint rule 5). spawn =
#: fork-to-process-entry (the interpreter, torch and the package's core,
#: which `-m singa_tpu_torch.router` imports first), import = the
#: serving modules (engine, diag, fleet, slo, ...), build = model
#: construction + engine start MINUS the build phases (trace/lower/
#: compile: introspect's compile-phase telemetry, the kernels' builds and
#: loads among them, diffed across the window),
#: warm = bucket warmup minus ITS build share, ready = post-warm wiring
#: (tracker/shard writer/diag/control surface) up to the ready
#: announcement
STARTUP_PHASES = ("spawn", "import", "build", "trace", "lower",
                  "compile", "warm", "ready")

#: synthetic tid for the startup-phase slices in the merged trace —
#: same far-above-real-idents convention as slo.QUEUE_TID
STARTUP_TID = 800_000

#: synthetic tids for the router's own trace track
ROUTER_QUEUE_TID = 910_000
ROUTER_DISPATCH_TID = 910_001


def _observe_startup(phase: str, seconds: float):
    """One cold-start phase duration into the startup histogram (the
    observatory's metric surface; the span ring carries the trace
    slices separately)."""
    assert phase in STARTUP_PHASES, phase
    observe.histogram(
        "singa_replica_startup_seconds",
        "replica cold-start wall seconds per startup phase "
        "(spawn/import/build/trace/lower/compile/warm/ready)").observe(
        max(0.0, float(seconds)), phase=phase)

_metrics_cache = None


def _metrics():
    # same memoize-with-revalidation shape as engine._metrics: cheap on
    # the per-request hot path, rebuilt after a registry reset
    global _metrics_cache
    c = _metrics_cache
    if c is not None and observe.get_registry().get(
            "singa_route_requests_total") is c["requests"]:
        return c
    _metrics_cache = c = {
        "requests": observe.counter(
            "singa_route_requests_total",
            "routed requests finished, by terminal outcome"),
        "rejects": observe.counter(
            "singa_route_rejects_total",
            "router-minted rejections by reason (shed at admission, "
            "retry budget exhausted, router drain)"),
        "failover": observe.counter(
            "singa_route_failover_total",
            "requests resubmitted away from a replica, by cause "
            "(replica death or graceful drain)"),
        "retries": observe.counter(
            "singa_route_retries_total",
            "re-dispatch attempts after the first, all causes"),
        "queue_depth": observe.gauge(
            "singa_route_queue_depth",
            "requests waiting in the router admission queue"),
        "replicas_live": observe.gauge(
            "singa_route_replicas_live",
            "replicas currently in the live state"),
        "replica_inflight": observe.gauge(
            "singa_route_replica_inflight",
            "requests dispatched to one replica and not yet terminal"),
        "request_s": observe.histogram(
            "singa_route_request_seconds",
            "router submit-to-terminal wall seconds per request"),
    }
    return c


def _http_json(url: str, payload=None, timeout: float = 10.0) -> dict:
    """One JSON round-trip (GET without payload, POST with)."""
    import urllib.request
    if payload is None:
        req = urllib.request.Request(url)
    else:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode("utf-8"))


# ---- the routed request -----------------------------------------------------

class RouterRequest:
    """One request's router-side record: the prompt + sampling config
    are KEPT here until a terminal outcome, which is what makes
    failover possible at all — a dead replica takes nothing with it
    that the router cannot resubmit."""

    __slots__ = ("id", "prompt", "max_new", "submitted", "finished_ts",
                 "outcome", "reason", "detail", "tokens", "replica",
                 "attempts", "ttft_s", "events", "trace",
                 "replica_attr", "attr", "synthetic", "_done")

    def __init__(self, rid: int, prompt, max_new: int):
        self.id = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new = int(max_new)
        # perf_counter, NOT monotonic: these stamps feed the merged
        # trace, and perf_counter is the clock the fleet (epoch, perf)
        # handshake aligns across processes
        self.submitted = time.perf_counter()
        self.finished_ts = None
        self.outcome = None     # member of ROUTE_OUTCOMES when terminal
        self.reason = None      # member of ROUTE_REASONS when router-minted
        self.detail = None
        self.tokens: "list[int]" = []
        self.replica = None     # name of the replica that completed it
        self.attempts = 0
        self.ttft_s = None      # router-side: submit -> first token
        self.events: "list[tuple]" = []
        self.trace = None        # fleet-unique trace-context id
        self.replica_attr = None  # winning replica's LATENCY_ATTR split
        self.attr = None          # full route decomposition at terminal
        self.synthetic = False    # a probe: excluded from RPS stamps
        self._done = threading.Event()

    def mark(self, event: str, **info):
        self.events.append((event, round(time.perf_counter(), 7), info))

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout=None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout=None) -> "list[int]":
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} not terminal")
        if self.outcome != OUTCOME_COMPLETED:
            raise RuntimeError(
                f"request {self.id} {self.outcome}: {self.detail}")
        return list(self.tokens)


class Replica:
    """Router-side record of one serving replica. `proc` is the
    subprocess when the router (or harness) spawned it — `None` for an
    externally managed or in-process (test stub) replica."""

    def __init__(self, name: str, ctl_url: str, *, host=None,
                 diag_url=None, proc=None):
        self.name = name
        self.ctl_url = ctl_url.rstrip("/")
        self.host = host or name
        self.diag_url = diag_url
        self.proc = proc
        self.state = STATE_LIVE
        self.state_detail = None
        self.inflight: "set[int]" = set()
        self.dispatched = 0
        self.completed = 0
        # dispatch/reject stamp rings — the /routerz admitted-RPS and
        # shed-rate columns (and the capacity model's demand signals)
        self.admit_times: "deque[float]" = deque(maxlen=1024)
        self.shed_times: "deque[float]" = deque(maxlen=1024)
        self.joined_ts = time.monotonic()
        # liveness calibration over shard publish intervals
        self.last_seq = None
        self.last_seq_change = None
        self.publish_intervals: "deque[float]" = deque(maxlen=256)
        self.liveness_deadline_s = None


# ---- the router -------------------------------------------------------------

class Router:
    """The control plane over N replicas (module docstring has the
    contract). All router threads are named `singa-route-*` (the
    test suites' leak checks key on the prefix)."""

    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(self, fleet_dir=None, *, queue_limit=64,
                 max_attempts=6, retry_base_s=0.05, retry_max_s=2.0,
                 retry_total_s=120.0, retry_seed=None,
                 poll_wait_s=2.0, health_interval_s=0.1,
                 liveness_multiplier=10.0, liveness_floor_s=1.0,
                 liveness_ceiling_s=30.0, liveness_min_samples=5,
                 probe_timeout_s=2.0):
        from . import fleet
        self.fleet_dir = fleet_dir
        self.queue_limit = int(queue_limit)
        self.max_attempts = int(max_attempts)
        self.retry_base_s = float(retry_base_s)
        self.retry_max_s = float(retry_max_s)
        self.retry_total_s = float(retry_total_s)
        self.retry_seed = retry_seed
        self.poll_wait_s = float(poll_wait_s)
        self.health_interval_s = float(health_interval_s)
        self.liveness_multiplier = float(liveness_multiplier)
        self.liveness_floor_s = float(liveness_floor_s)
        self.liveness_ceiling_s = float(liveness_ceiling_s)
        self.liveness_min_samples = int(liveness_min_samples)
        self.probe_timeout_s = float(probe_timeout_s)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: "deque[RouterRequest]" = deque()
        self._pending: "dict[int, RouterRequest]" = {}
        self._replicas: "dict[str, Replica]" = {}
        self._rid = 0
        self._rr = 0
        self._stop_evt = threading.Event()
        self._stopping = False
        self._threads: "list[threading.Thread]" = []
        self._senders: "list[threading.Thread]" = []
        self._terminal = {o: 0 for o in ROUTE_OUTCOMES}
        self._reasons = {r: 0 for r in ROUTE_REASONS}
        self._failovers = {REASON_REPLICA_DEAD: 0, REASON_DRAIN: 0}
        self._retries = 0
        # front-door stamp rings: accepted submits and queue-full
        # sheds — the router-level admitted-RPS / shed-rate the
        # capacity forecaster feeds on
        self._admit_times: "deque[float]" = deque(maxlen=4096)
        self._shed_times: "deque[float]" = deque(maxlen=4096)
        # finished routed-request timelines (trace id, hop events,
        # LATENCY_ATTR decomposition) — the /routerz?json=1 surface
        self._timelines: "deque[dict]" = deque(maxlen=256)
        # terminal-request listeners: (RouterRequest, timeline dict)
        # per terminal (audit's shadow replayer samples real completed
        # requests here; mirror of engine's listener list)
        self._request_listeners: "list" = []
        # balance on the installed aggregator when there is one (the
        # --ab coordinator installs it so /fleetz works too); otherwise
        # a private one over fleet_dir, polled from the health loop
        self._own_agg = None
        if fleet_dir is not None and fleet.get_aggregator() is None:
            self._own_agg = fleet.FleetAggregator(
                fleet_dir, stale_after_s=max(5.0, liveness_ceiling_s),
                poll_interval_s=min(0.25, health_interval_s))

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Router":
        with Router._seq_lock:
            Router._seq += 1
            n = Router._seq
        for target, name in ((self._dispatch_loop, "dispatch"),
                             (self._health_loop, "health")):
            t = threading.Thread(target=target,
                                 name=f"singa-route-{name}-{n}",
                                 daemon=True)
            self._threads.append(t)
            t.start()
        install_router(self)
        self._export_gauges()
        return self

    def stop(self, timeout_s: float = 30.0):
        """Tear the router down: loops joined, every queued and pending
        request finished with a TERMINAL outcome (rejected, reason
        "drain" — never silence), replica subprocesses killed and
        reaped. Idempotent."""
        with self._lock:
            if self._stopping and not self._threads:
                return
            self._stopping = True
            self._stop_evt.set()
            self._cond.notify_all()
            leftover = list(self._queue)
            self._queue.clear()
        for req in leftover:
            self._finish(req, OUTCOME_REJECTED, reason=REASON_DRAIN,
                         detail="router stopped")
        deadline = time.monotonic() + float(timeout_s)
        for t in self._threads + self._senders:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        self._threads = []
        self._senders = []
        # any request a sender could not terminate in time still gets a
        # terminal outcome — zero-loss holds through shutdown too
        with self._lock:
            pending = list(self._pending.values())
        for req in pending:
            self._finish(req, OUTCOME_REJECTED, reason=REASON_DRAIN,
                         detail="router stopped")
        for rep in self.replicas():
            if rep.proc is not None and rep.proc.poll() is None:
                rep.proc.kill()
            if rep.proc is not None:
                try:
                    rep.proc.wait(timeout=10.0)
                except Exception:
                    pass
        if self._own_agg is not None:
            self._own_agg.stop_polling()
        if observe.is_enabled():
            m = _metrics()
            m["queue_depth"].set(0.0)
            m["replicas_live"].set(0.0)

    # -- replica registry --------------------------------------------------
    def add_replica(self, name: str, ctl_url: str, *, host=None,
                    diag_url=None, proc=None) -> Replica:
        rep = Replica(name, ctl_url, host=host, diag_url=diag_url,
                      proc=proc)
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"replica {name!r} already registered")
            self._replicas[name] = rep
            self._cond.notify_all()
        self._export_gauges()
        return rep

    def replicas(self) -> "list[Replica]":
        with self._lock:
            return list(self._replicas.values())

    def get_replica(self, name: str) -> "Replica | None":
        with self._lock:
            return self._replicas.get(name)

    def mark_dead(self, rep: Replica, detail: str):
        """Flip a replica to DEAD (idempotent): no further dispatches
        go to it, waiting senders re-pick, and its process (if any) is
        killed and reaped so nothing leaks."""
        with self._lock:
            if rep.state == STATE_DEAD:
                return
            rep.state = STATE_DEAD
            rep.state_detail = detail
            self._cond.notify_all()
        if rep.proc is not None:
            if rep.proc.poll() is None:
                rep.proc.kill()
            try:
                rep.proc.wait(timeout=10.0)
            except Exception:
                pass
        if observe.is_enabled():
            observe.get_registry().emit({
                "kind": "route", "event": "replica_dead",
                "replica": rep.name, "detail": detail})
        self._export_gauges()

    def drain_replica(self, name: str, *, timeout_s: float = 120.0,
                      shutdown: bool = True) -> dict:
        """Graceful rolling-restart step for one replica: stop routing
        to it, ask its engine to finish in-flight work and hand queued
        requests back (`ServingEngine.stop(drain=True)`), wait for the
        router-side in-flight set to clear (the handed-back requests
        re-route themselves to surviving replicas), then optionally
        shut the replica process down. Returns the replica's drain
        response (handed_back ids etc.).

        Idempotent/re-entrant: a second call while the replica is
        already draining — or after it is dead — is a NO-OP returning
        {"noop": True, "state": ...}. A caller that re-fires the same
        verdict until its episode clears (audit's quarantine loop, item
        7) may ask twice."""
        rep = self.get_replica(name)
        if rep is None:
            raise ValueError(f"no replica {name!r}")
        with self._lock:
            if rep.state != STATE_LIVE:
                return {"noop": True, "replica": rep.name,
                        "state": rep.state}
            rep.state = STATE_DRAINING
            rep.state_detail = "drain requested"
        self._export_gauges()
        out = _http_json(rep.ctl_url + "/drain",
                         {"timeout_s": timeout_s},
                         timeout=timeout_s + 10.0)
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            with self._lock:
                if not rep.inflight:
                    break
            time.sleep(0.02)
        if shutdown:
            try:
                _http_json(rep.ctl_url + "/shutdown", {}, timeout=10.0)
            except Exception:
                pass
            if rep.proc is not None:
                try:
                    rep.proc.wait(timeout=30.0)
                except Exception:
                    rep.proc.kill()
                    rep.proc.wait(timeout=10.0)
            self.mark_dead(rep, "drained and retired")
        return out

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new: int, *,
               synthetic: bool = False) -> RouterRequest:
        """Route one greedy request. Returns the handle immediately; a
        full router queue (or a stopped router) REJECTS it on the spot
        — reason "shed" / "drain" — instead of queueing unboundedly.
        `synthetic` marks an audit canary/replay probe: it rides the
        identical dispatch path (that is the point — a canary that
        skips the front door proves nothing) but never stamps the
        admit/shed RPS windows, so `/routerz` admitted-RPS and the
        capacity forecaster's arrival signal see only real demand."""
        with self._lock:
            self._rid += 1
            req = RouterRequest(self._rid, prompt, max_new)
            req.synthetic = bool(synthetic)
            # the fleet-unique trace context, minted at the front door:
            # pid-scoped so two routers (tests, a restart) never
            # collide, carried through every dispatch into the winning
            # replica's engine timeline
            req.trace = f"t{os.getpid():x}-{req.id}"
            if self._stopping:
                shed_reason, detail = REASON_DRAIN, "router stopped"
            elif len(self._queue) >= self.queue_limit:
                shed_reason = REASON_SHED
                detail = f"router queue full ({self.queue_limit})"
                if not req.synthetic:
                    self._shed_times.append(time.monotonic())
            else:
                shed_reason = None
                if not req.synthetic:
                    self._admit_times.append(time.monotonic())
                self._pending[req.id] = req
                self._queue.append(req)
                req.mark("queued", depth=len(self._queue))
                self._cond.notify_all()
                qd = len(self._queue)
        if shed_reason is not None:
            self._finish(req, OUTCOME_REJECTED, reason=shed_reason,
                         detail=detail)
        elif observe.is_enabled():
            _metrics()["queue_depth"].set(float(qd))
        return req

    # -- terminal bookkeeping ----------------------------------------------
    def _finish(self, req: RouterRequest, outcome: str, *, tokens=None,
                reason=None, detail=None, replica=None):
        assert outcome in ROUTE_OUTCOMES, outcome
        assert reason is None or reason in ROUTE_REASONS, reason
        from . import slo
        with self._lock:
            if req.outcome is not None:
                return
            req.outcome = outcome
            req.reason = reason
            req.detail = detail
            req.replica = replica
            if tokens is not None:
                req.tokens = [int(t) for t in tokens]
            req.finished_ts = time.perf_counter()
            req.mark("terminal", outcome=outcome, reason=reason)
            self._terminal[outcome] += 1
            if reason is not None:
                self._reasons[reason] += 1
            self._pending.pop(req.id, None)
        # the tail-latency decomposition: pure math over the hop marks
        # (+ the winning replica's own engine-side split), summing to
        # the request's total wall time — computed OUTSIDE the lock
        # (the request is terminal, its events are stable)
        req.attr = slo.attribute_route(
            req.submitted, req.finished_ts, list(req.events),
            replica_attr=req.replica_attr)
        total_s = round(req.finished_ts - req.submitted, 6)
        tlrec = {
            "id": req.id, "trace": req.trace, "outcome": outcome,
            "synthetic": bool(req.synthetic),
            "reason": reason, "detail": detail, "replica": replica,
            "attempts": req.attempts, "ttft_s": req.ttft_s,
            "submitted": round(req.submitted, 7),
            "finished": round(req.finished_ts, 7),
            "total_s": total_s, "attr": req.attr,
            "events": [(e, round(float(t), 7), i)
                       for e, t, i in list(req.events)],
        }
        with self._lock:
            self._timelines.append(tlrec)
        slo.note_attribution({"id": req.id, "outcome": outcome,
                              "trace": req.trace, "total_s": total_s,
                              "attr": req.attr})
        if observe.is_enabled():
            m = _metrics()
            m["requests"].inc(outcome=outcome)
            if reason is not None:
                m["rejects"].inc(reason=reason)
            m["request_s"].observe(req.finished_ts - req.submitted)
            observe.get_registry().emit({
                "kind": "route", "event": "terminal", "id": req.id,
                "outcome": outcome, "reason": reason,
                "replica": replica, "attempts": req.attempts,
                "detail": detail})
        for cb in tuple(self._request_listeners):
            try:
                cb(req, tlrec)
            except Exception:
                pass  # a listener must never break the routing path
        req._done.set()

    def add_request_listener(self, cb):
        """Register `cb(RouterRequest, timeline_dict)` called on every
        terminal routed request (after the timeline is booked, before
        the waiter wakes). Exceptions are swallowed."""
        if cb not in self._request_listeners:
            self._request_listeners.append(cb)

    def remove_request_listener(self, cb):
        if cb in self._request_listeners:
            self._request_listeners.remove(cb)

    # -- dispatch ----------------------------------------------------------
    def _dispatch_loop(self):
        while True:
            with self._lock:
                while not self._queue and not self._stopping:
                    self._cond.wait(timeout=0.1)
                if self._stopping:
                    return
                req = self._queue.popleft()
                qd = len(self._queue)
            if observe.is_enabled():
                _metrics()["queue_depth"].set(float(qd))
            t = threading.Thread(target=self._run_request, args=(req,),
                                 name=f"singa-route-req-{req.id}",
                                 daemon=True)
            with self._lock:
                self._senders.append(t)
                # reap finished sender threads so the list stays bounded
                self._senders = [s for s in self._senders if s.is_alive()
                                 or s is t]
            t.start()

    def _load_rows(self) -> dict:
        """host -> fleet rollup row, best effort (empty without an
        aggregator — balancing then rides the in-flight counts)."""
        from . import fleet
        agg = fleet.get_aggregator() or self._own_agg
        if agg is None:
            return {}
        try:
            agg.poll_if_due()
            roll = agg.rollup()
            return {r["host"]: r for r in roll["workers"]}
        except Exception:
            return {}

    def _score(self, rep: Replica, rows: dict) -> float:
        score = float(len(rep.inflight))
        row = rows.get(rep.host)
        serve = (row or {}).get("serve")
        if isinstance(serve, dict) and not (row or {}).get("stale"):
            score += float(serve.get("queue_depth") or 0)
            score += float(serve.get("occupancy") or 0)
        return score

    def _pick_replica(self, exclude=(), wait_until=None):
        """Lowest-load LIVE replica, preferring ones not in `exclude`
        (the replica that just failed). Blocks until `wait_until` for
        one to appear — a replacement may be joining — and returns None
        only when the wait budget is spent."""
        rows = self._load_rows()
        while True:
            with self._lock:
                live = [r for r in self._replicas.values()
                        if r.state == STATE_LIVE]
                cands = [r for r in live if r not in exclude] or live
                if cands:
                    self._rr += 1
                    lo = min(self._score(r, rows) for r in cands)
                    best = [r for r in cands
                            if self._score(r, rows) <= lo]
                    return best[self._rr % len(best)]
                if self._stopping or (
                        wait_until is not None
                        and time.monotonic() >= wait_until):
                    return None
                self._cond.wait(timeout=0.1)

    def _probe(self, rep: Replica) -> bool:
        try:
            out = _http_json(rep.ctl_url + "/healthz",
                             timeout=self.probe_timeout_s)
            return bool(out.get("ok"))
        except Exception:
            return False

    def _dispatch(self, rep: Replica, req: RouterRequest) -> dict:
        """Drive one attempt on one replica to a classifiable result:
        submit, then bounded /poll rounds until terminal. Every return
        is a dict with "outcome" plus "cause" for retryable failures
        ("transport", "requeued", "retryable_reject")."""
        payload = {"rid": req.id,
                   "prompt": [int(t) for t in req.prompt],
                   "max_new": req.max_new, "wait_s": self.poll_wait_s,
                   "trace": req.trace}
        if req.synthetic:
            payload["synthetic"] = True
        path = "/submit"
        # once a poll round returned "pending" the replica had ACCEPTED
        # the work (an engine request exists, tokens may be flowing) —
        # a later failure is a REPLAY of accepted work, not a dispatch
        # that never started; the tail attribution books the two
        # differently (failover_replay vs dispatch_retry)
        accepted = False
        while True:
            if self._stop_evt.is_set():
                return {"outcome": "error", "cause": "transport",
                        "detail": "router stopping",
                        "pending": accepted}
            if rep.state == STATE_DEAD:
                return {"outcome": "error", "cause": "transport",
                        "detail": "replica marked dead",
                        "pending": accepted}
            try:
                out = _http_json(rep.ctl_url + path, payload,
                                 timeout=self.poll_wait_s + 10.0)
            except Exception as e:
                return {"outcome": "error", "cause": "transport",
                        "detail": f"{type(e).__name__}: {e}",
                        "pending": accepted}
            st = out.get("outcome")
            if st == "pending":
                # bounded poll rounds keep every sender interruptible:
                # no thread ever blocks longer than one wait_s window
                path = "/submit"
                payload["resume"] = True
                accepted = True
                continue
            if st in ("requeued", "unknown"):
                return {"outcome": "error", "cause": "requeued",
                        "detail": "handed back by drain"
                        if st == "requeued"
                        else "replica lost request state",
                        "pending": accepted}
            if st == "rejected" and out.get("retryable"):
                return {"outcome": "error",
                        "cause": "retryable_reject",
                        "detail": out.get("detail"),
                        "pending": accepted}
            if st == "evicted":
                # the replica engine's crash path drained it — the
                # request is safe to resubmit (greedy determinism)
                return {"outcome": "error", "cause": "transport",
                        "detail": out.get("detail") or "evicted",
                        "pending": accepted}
            if st == "timeout":
                return {"outcome": "rejected", "retryable": False,
                        "detail": out.get("detail")
                        or "request deadline exceeded"}
            return out

    def _run_request(self, req: RouterRequest):
        rng = random.Random(
            None if self.retry_seed is None
            else (int(self.retry_seed) * 1_000_003 + req.id))
        t0 = time.monotonic()
        wait_until = t0 + self.retry_total_s
        prev_delay = self.retry_base_s
        last_rep = None
        while not self._stop_evt.is_set():
            elapsed = time.monotonic() - t0
            if req.attempts >= self.max_attempts \
                    or elapsed >= self.retry_total_s:
                return self._finish(
                    req, OUTCOME_REJECTED,
                    reason=REASON_RETRY_EXHAUSTED,
                    detail=f"{req.attempts} attempts over "
                           f"{elapsed:.1f}s")
            rep = self._pick_replica(
                exclude=(last_rep,) if last_rep is not None else (),
                wait_until=wait_until)
            if rep is None:
                if self._stop_evt.is_set():
                    break
                return self._finish(
                    req, OUTCOME_REJECTED,
                    reason=REASON_RETRY_EXHAUSTED,
                    detail="no live replica")
            req.attempts += 1
            if req.attempts > 1:
                self._retries += 1
                if observe.is_enabled():
                    _metrics()["retries"].inc()
            dispatch_ts = time.perf_counter()
            req.mark("dispatch", replica=rep.name,
                     attempt=req.attempts)
            with self._lock:
                rep.inflight.add(req.id)
                rep.dispatched += 1
                if not req.synthetic:
                    rep.admit_times.append(time.monotonic())
            self._export_gauges()
            try:
                out = self._dispatch(rep, req)
            finally:
                with self._lock:
                    rep.inflight.discard(req.id)
                self._export_gauges()
            st = out.get("outcome")
            if st == OUTCOME_COMPLETED:
                with self._lock:
                    rep.completed += 1
                if out.get("ttft_s") is not None:
                    # router-side TTFT: queue + failed attempts + the
                    # final replica's own submit->first-token time
                    req.ttft_s = (dispatch_ts - req.submitted
                                  + float(out["ttft_s"]))
                req.replica_attr = out.get("attr")
                return self._finish(req, OUTCOME_COMPLETED,
                                    tokens=out.get("tokens") or [],
                                    replica=rep.name)
            if st == OUTCOME_REJECTED and not out.get("retryable"):
                return self._finish(req, OUTCOME_REJECTED,
                                    detail=out.get("detail"),
                                    replica=rep.name)
            cause = out.get("cause")
            probe_s = 0.0
            if cause == "transport":
                # SIGKILL shows up here first (connection reset long
                # before the shard goes stale): confirm with a probe so
                # failover is prompt, not a liveness-deadline later
                if rep.state == STATE_LIVE:
                    p0 = time.perf_counter()
                    alive = self._probe(rep)
                    probe_s = time.perf_counter() - p0
                    if not alive:
                        self.mark_dead(
                            rep,
                            f"dispatch failed ({out.get('detail')}) "
                            "and /healthz probe failed")
            if cause == "retryable_reject":
                # the replica turned the request away at ITS front
                # door (queue full / draining): that is the per-
                # replica shed signal the capacity table surfaces
                if not req.synthetic:
                    with self._lock:
                        rep.shed_times.append(time.monotonic())
            req.mark("failover", replica=rep.name, cause=cause,
                     detail=out.get("detail"),
                     probe_s=round(probe_s, 7),
                     pending=bool(out.get("pending")))
            if cause == "transport":
                if rep.state == STATE_DEAD:
                    with self._lock:
                        self._failovers[REASON_REPLICA_DEAD] += 1
                    if observe.is_enabled():
                        _metrics()["failover"].inc(
                            reason=REASON_REPLICA_DEAD)
            elif cause == "requeued":
                fo = REASON_DRAIN if rep.state == STATE_DRAINING \
                    else REASON_REPLICA_DEAD
                with self._lock:
                    self._failovers[fo] += 1
                if observe.is_enabled():
                    if fo == REASON_DRAIN:
                        _metrics()["failover"].inc(reason=REASON_DRAIN)
                    else:
                        _metrics()["failover"].inc(
                            reason=REASON_REPLICA_DEAD)
            last_rep = rep
            delay = min(rng.uniform(self.retry_base_s,
                                    max(self.retry_base_s,
                                        prev_delay * 3.0)),
                        self.retry_max_s)
            prev_delay = delay
            self._stop_evt.wait(delay)
        self._finish(req, OUTCOME_REJECTED, reason=REASON_DRAIN,
                     detail="router stopped")

    # -- health ------------------------------------------------------------
    def _health_loop(self):
        from . import watchdog
        while not self._stop_evt.wait(self.health_interval_s):
            rows = self._load_rows()
            now = time.monotonic()
            for rep in self.replicas():
                if rep.state == STATE_DEAD:
                    continue
                if rep.proc is not None and rep.proc.poll() is not None:
                    self.mark_dead(
                        rep, "process exited "
                             f"rc={rep.proc.returncode}")
                    continue
                row = rows.get(rep.host)
                if row is None:
                    continue
                seq = row.get("seq")
                if seq != rep.last_seq:
                    if rep.last_seq is not None \
                            and rep.last_seq_change is not None:
                        rep.publish_intervals.append(
                            now - rep.last_seq_change)
                    rep.last_seq = seq
                    rep.last_seq_change = now
                    continue
                # watchdog-style calibrated liveness: armed only after
                # enough publish intervals establish "normal", then a
                # shard older than clamp(p99 x multiplier, floor,
                # ceiling) makes the replica a SUSPECT — confirmed dead
                # only when the /healthz probe fails too (a slow
                # publisher with a live control surface keeps serving)
                dl = watchdog.calibrated_deadline(
                    rep.publish_intervals,
                    multiplier=self.liveness_multiplier,
                    floor_s=self.liveness_floor_s,
                    ceiling_s=self.liveness_ceiling_s,
                    min_samples=self.liveness_min_samples)
                rep.liveness_deadline_s = dl
                if dl is not None and rep.last_seq_change is not None \
                        and now - rep.last_seq_change > dl \
                        and not self._probe(rep):
                    self.mark_dead(
                        rep, f"shard age "
                             f"{now - rep.last_seq_change:.2f}s > "
                             f"liveness deadline {dl:.2f}s and "
                             "/healthz probe failed")

    # -- introspection -----------------------------------------------------
    def _export_gauges(self):
        if not observe.is_enabled():
            return
        m = _metrics()
        with self._lock:
            reps = list(self._replicas.values())
            qd = len(self._queue)
        live = 0
        for rep in reps:
            assert rep.state in REPLICA_STATES, rep.state
            if rep.state == STATE_LIVE:
                live += 1
            m["replica_inflight"].set(float(len(rep.inflight)),
                                      replica=rep.name)
        m["replicas_live"].set(float(live))
        m["queue_depth"].set(float(qd))

    def request_timelines(self) -> "list[dict]":
        """Locked copy of the bounded terminal-request timeline ring
        (newest last). Diag threads read this while the dispatch loop
        appends — the copy-under-lock keeps them from racing."""
        with self._lock:
            return [dict(t) for t in self._timelines]

    @staticmethod
    def _rate(stamps: "deque[float]", window_s: float) -> float:
        """Events/second over the trailing window of a monotonic stamp
        ring, with the engine.rps short-span correction (a full ring
        younger than the window covers less than `window_s`)."""
        now = time.monotonic()
        n = sum(1 for t in stamps if now - t <= window_s)
        span = window_s
        if stamps and len(stamps) == stamps.maxlen \
                and now - stamps[0] < window_s:
            span = max(now - stamps[0], 1e-6)
        return n / span

    def admit_rate(self, window_s: float = 10.0) -> float:
        """Requests/second accepted at the front door over the
        trailing window — the demand forecaster's arrival signal."""
        with self._lock:
            return self._rate(self._admit_times, window_s)

    def shed_rate(self, window_s: float = 10.0) -> float:
        """Requests/second shed at the front door (queue full) over
        the trailing window."""
        with self._lock:
            return self._rate(self._shed_times, window_s)

    def snapshot(self) -> dict:
        with self._lock:
            reps = []
            for rep in self._replicas.values():
                reps.append({
                    "name": rep.name, "state": rep.state,
                    "state_detail": rep.state_detail,
                    "host": rep.host,
                    "inflight": len(rep.inflight),
                    "dispatched": rep.dispatched,
                    "completed": rep.completed,
                    "admitted_rps": round(
                        self._rate(rep.admit_times, 10.0), 3),
                    "shed_rate": round(
                        self._rate(rep.shed_times, 10.0), 3),
                    "liveness_deadline_s": rep.liveness_deadline_s,
                })
            return {
                "queue_depth": len(self._queue),
                "queue_limit": self.queue_limit,
                "pending": len(self._pending),
                "terminal": dict(self._terminal),
                "reasons": dict(self._reasons),
                "failovers": dict(self._failovers),
                "retries": self._retries,
                "admitted_rps": round(
                    self._rate(self._admit_times, 10.0), 3),
                "shed_rate": round(
                    self._rate(self._shed_times, 10.0), 3),
                "replicas": reps,
            }


# ---- module singleton -------------------------------------------------------

_router: "Router | None" = None
_registry_lock = threading.Lock()


def install_router(router: Router) -> Router:
    global _router
    with _registry_lock:
        _router = router
    return router


def get_router() -> "Router | None":
    return _router


def reset():
    """Stop and drop the process router (router threads joined, replica
    subprocesses reaped, pending requests drained with a terminal
    outcome)."""
    global _router
    with _registry_lock:
        r = _router
        _router = None
    if r is not None:
        r.stop()


# ---- report surfaces --------------------------------------------------------

def serving_lines() -> "list[str]":
    """Router rows for /statusz's `== serving ==` section (empty
    without an installed router)."""
    r = get_router()
    if r is None:
        return []
    s = r.snapshot()
    by_state = {st: 0 for st in REPLICA_STATES}
    for rep in s["replicas"]:
        by_state[rep["state"]] += 1
    t, reasons = s["terminal"], s["reasons"]
    lines = [
        f"router: replicas {by_state['live']} live / "
        f"{by_state['draining']} draining / {by_state['dead']} dead, "
        f"queue {s['queue_depth']}/{s['queue_limit']} "
        f"(pending {s['pending']})",
        f"  routed: completed {t['completed']}, rejected "
        f"{t['rejected']} (shed {reasons['shed']}, retry_exhausted "
        f"{reasons['retry_exhausted']}, drain {reasons['drain']}), "
        f"retries {s['retries']}, failover replica_dead "
        f"{s['failovers']['replica_dead']} / drain "
        f"{s['failovers']['drain']}",
    ]
    for rep in s["replicas"]:
        dl = rep["liveness_deadline_s"]
        lines.append(
            f"  replica {rep['name']}: {rep['state']}, inflight "
            f"{rep['inflight']}, dispatched {rep['dispatched']}, "
            f"completed {rep['completed']}, liveness deadline "
            + (f"{dl:.2f}s" if dl is not None else "uncalibrated")
            + (f" ({rep['state_detail']})"
               if rep["state_detail"] else ""))
    return lines


def fleetz_lines() -> "list[str]":
    """Router section for /fleetz (empty without an installed
    router): per-replica state plus the shed/failover/retry counters —
    the control-plane view next to the data-plane serving table."""
    r = get_router()
    if r is None:
        return []
    s = r.snapshot()
    t, reasons = s["terminal"], s["reasons"]
    lines = [
        "== router ==",
        f"queue {s['queue_depth']}/{s['queue_limit']}   completed "
        f"{t['completed']}   rejected {t['rejected']}   shed "
        f"{reasons['shed']}   failover(replica_dead) "
        f"{s['failovers']['replica_dead']}   failover(drain) "
        f"{s['failovers']['drain']}   retry_exhausted "
        f"{reasons['retry_exhausted']}   retries {s['retries']}   "
        f"admitted {s['admitted_rps']:.2f}/s   shed "
        f"{s['shed_rate']:.2f}/s",
        f"{'replica':<12} {'state':>9} {'inflight':>9} "
        f"{'dispatched':>11} {'completed':>10} {'admit/s':>8} "
        f"{'shed/s':>7} deadline",
    ]
    for rep in s["replicas"]:
        dl = rep["liveness_deadline_s"]
        lines.append(
            f"{rep['name']:<12} {rep['state']:>9} "
            f"{rep['inflight']:>9} {rep['dispatched']:>11} "
            f"{rep['completed']:>10} {rep['admitted_rps']:>8.2f} "
            f"{rep['shed_rate']:>7.2f} "
            + (f"{dl:.2f}s" if dl is not None else "uncalibrated"))
    return lines


def router_report() -> str:
    """Text block for /routerz: the fleetz table plus a bounded tail
    of recent terminal requests (id / outcome / hops / wall / top
    latency bucket) read via the locked timeline copy."""
    lines = fleetz_lines()
    if not lines:
        return ("no Router installed "
                "(singa_tpu_torch.router.Router(...).start())")
    r = get_router()
    recent = r.request_timelines()[-8:] if r is not None else []
    if recent:
        lines.append("recent requests:")
        for tl in recent:
            attr = tl.get("attr") or {}
            top = max(attr.items(), key=lambda kv: kv[1],
                      default=(None, 0.0))
            where = tl.get("replica") or tl.get("reason") or "-"
            lines.append(
                f"  req {tl['id']} [{tl.get('trace')}] "
                f"{tl['outcome']} via {where}, "
                f"{tl['attempts']} attempt(s), "
                f"{tl['total_s']:.4f}s"
                + (f", top {top[0]} {top[1]:.4f}s"
                   if top[0] is not None else ""))
    return "\n".join(lines)


def router_json() -> dict:
    """JSON body for /routerz?json=1: the snapshot plus a bounded tail
    of terminal request timelines (trace id, hop marks, attribution)."""
    r = get_router()
    if r is None:
        return {"installed": False}
    return {"installed": True, "snapshot": r.snapshot(),
            "requests": r.request_timelines()[-64:]}


def router_trace_events() -> "list[dict]":
    """Chrome-trace events for the router's own track in the merged
    fleet trace: a synthetic "router" process (sorted above the
    replicas) with a queue thread and a dispatch thread, one X slice
    per request's queue wait, one per dispatch hop, and the trace_ctx
    flow "s"/"f" endpoints that stitch each request to the winning
    replica's engine slices. Perf-counter stamps map to wall time via
    this process's own clock offset — the same pairing the replica
    shard headers use, so the tracks align."""
    r = get_router()
    if r is None:
        return []
    from .slo import TRACE_CTX_CAT
    pid = os.getpid()
    off = time.time() - time.perf_counter()

    def us(t_perf):
        return (float(t_perf) + off) * 1e6

    events: "list[dict]" = [
        {"ph": "M", "name": "process_name", "pid": pid,
         "args": {"name": f"router (pid {pid})"}},
        {"ph": "M", "name": "process_sort_index", "pid": pid,
         "args": {"sort_index": -1}},
        {"ph": "M", "name": "thread_name", "pid": pid,
         "tid": ROUTER_QUEUE_TID, "args": {"name": "router queue"}},
        {"ph": "M", "name": "thread_name", "pid": pid,
         "tid": ROUTER_DISPATCH_TID,
         "args": {"name": "router dispatch"}},
    ]
    for tl in r.request_timelines():
        rid = tl["id"]
        sub = float(tl["submitted"])
        fin = float(tl["finished"])
        evs = [(e, float(t), i) for e, t, i in tl.get("events") or []]
        dispatches = [(t, i) for e, t, i in evs if e == "dispatch"]
        failovers = [(t, i) for e, t, i in evs if e == "failover"]
        q_end = dispatches[0][0] if dispatches else fin
        events.append({
            "ph": "X", "cat": "route", "name": f"req {rid} queued",
            "ts": us(sub), "dur": max(0.0, (q_end - sub) * 1e6),
            "pid": pid, "tid": ROUTER_QUEUE_TID,
            "args": {"trace": tl.get("trace"),
                     "outcome": tl["outcome"],
                     "reason": tl.get("reason")}})
        for k, (t_d, info) in enumerate(dispatches):
            end = dispatches[k + 1][0] if k + 1 < len(dispatches) \
                else fin
            args = {"trace": tl.get("trace"),
                    "replica": info.get("replica"),
                    "attempt": info.get("attempt")}
            if k < len(failovers):
                args["cause"] = failovers[k][1].get("cause")
            else:
                args["outcome"] = tl["outcome"]
                args["reason"] = tl.get("reason")
            events.append({
                "ph": "X", "cat": "route",
                "name": f"req {rid} hop {k + 1} -> "
                        f"{info.get('replica')}",
                "ts": us(t_d), "dur": max(0.0, (end - t_d) * 1e6),
                "pid": pid, "tid": ROUTER_DISPATCH_TID, "args": args})
        if dispatches and tl.get("trace") and fin > q_end:
            # flow start just inside the first hop slice, finish just
            # inside the last hop slice: the winning replica's binding
            # step (admitted AFTER dispatch, bound BEFORE the router
            # saw the terminal outcome) lands strictly between them
            eps = min(1e-6, (fin - q_end) / 4.0)
            events.append({
                "ph": "s", "cat": TRACE_CTX_CAT, "name": "trace",
                "id": str(tl["trace"]), "ts": us(q_end + eps),
                "pid": pid, "tid": ROUTER_DISPATCH_TID})
            events.append({
                "ph": "f", "cat": TRACE_CTX_CAT, "name": "trace",
                "id": str(tl["trace"]), "bp": "e",
                "ts": us(fin - eps),
                "pid": pid, "tid": ROUTER_DISPATCH_TID})
    return events


# ---- the replica process ----------------------------------------------------

class ReplicaControl:
    """The HTTP control surface a replica exposes to the router (and to
    in-process test stubs): /submit with bounded waits, /healthz,
    /drain (graceful engine stop, handed-back ids reported), and
    /shutdown. Threads are daemonized and the server thread is named
    `singa-route-ctl-<port>` so the suites' leak checks cover it."""

    def __init__(self, eng, host="127.0.0.1", port=0):
        self.eng = eng
        self.draining = False
        self._reqs: "dict[int, object]" = {}  # rid -> EngineRequest
        self._handed: "set[int]" = set()
        self._lock = threading.Lock()
        self.shutdown_evt = threading.Event()
        ctl = self

        class _CtlHandler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A002
                pass

            def _reply(self, obj, status=200):
                body = json.dumps(obj).encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path.rstrip("/") == "/healthz":
                    self._reply({"ok": True, "pid": os.getpid(),
                                 "draining": ctl.draining})
                else:
                    self._reply({"error": f"no endpoint {self.path}"},
                                status=404)

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._reply({"error": "bad json"}, status=400)
                    return
                path = self.path.rstrip("/")
                try:
                    if path == "/submit":
                        self._reply(ctl.handle_submit(body))
                    elif path == "/drain":
                        self._reply(ctl.handle_drain(body))
                    elif path == "/shutdown":
                        ctl.shutdown_evt.set()
                        self._reply({"ok": True})
                    else:
                        self._reply(
                            {"error": f"no endpoint {self.path}"},
                            status=404)
                except Exception as e:  # surface, don't kill the thread
                    self._reply({"error":
                                 f"{type(e).__name__}: {e}"},
                                status=500)

        self.httpd = ThreadingHTTPServer((host, int(port)), _CtlHandler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name=f"singa-route-ctl-{self.port}", daemon=True)
        self._thread.start()

    # -- handlers ----------------------------------------------------------
    def handle_submit(self, body: dict) -> dict:
        rid = int(body["rid"])
        wait_s = float(body.get("wait_s", 2.0))
        with self._lock:
            req = self._reqs.get(rid)
        if req is None:
            if self.draining:
                return {"outcome": "rejected", "retryable": True,
                        "detail": "replica draining"}
            try:
                req = self.eng.submit(
                    np.asarray(body["prompt"], np.int32),
                    int(body["max_new"]),
                    trace_ctx=body.get("trace"),
                    synthetic=bool(body.get("synthetic")))
            except TypeError:
                # test stubs model a 2-arg submit; the trace id and
                # synthetic tag are merely lost, not load-bearing
                req = self.eng.submit(
                    np.asarray(body["prompt"], np.int32),
                    int(body["max_new"]))
            with self._lock:
                self._reqs[rid] = req
            # push the in-flight timeline to disk NOW: if the router
            # SIGKILLs this replica mid-request, the merged trace still
            # shows the victim's partial track (shard files outlive
            # the process)
            try:
                from . import fleet
                w = fleet.get_shard_writer()
                if w is not None:
                    w.publish()
            except Exception:
                pass
        deadline = time.monotonic() + wait_s
        while req.outcome is None and time.monotonic() < deadline:
            with self._lock:
                if rid in self._handed:
                    # drained out of the queue before admission: hand
                    # it back to the router (it re-routes; the rid is
                    # forgotten so a forced same-replica resubmit makes
                    # a FRESH engine request)
                    self._handed.discard(rid)
                    self._reqs.pop(rid, None)
                    return {"outcome": "requeued"}
            req.wait(timeout=0.05)
        if req.outcome is None:
            return {"outcome": "pending"}
        with self._lock:
            self._reqs.pop(rid, None)
            self._handed.discard(rid)
        out = {"outcome": req.outcome, "detail": req.detail}
        if req.outcome == "completed":
            out["tokens"] = [int(t) for t in req.tokens]
            out["ttft_s"] = req.ttft_s
            try:
                from . import slo
                evs = list(getattr(req, "events", []) or [])
                if evs:
                    out["attr"] = slo.attribute_timeline(
                        {"events": evs})
            except Exception:
                pass
        elif req.outcome == "rejected":
            out["retryable"] = any(
                s in (req.detail or "") for s in RETRYABLE_DETAILS)
        return out

    def handle_drain(self, body: dict) -> dict:
        self.draining = True
        handed = self.eng.stop(
            drain=True,
            drain_timeout_s=float(body.get("timeout_s", 120.0)))
        handed_ids = {id(r) for r in handed}
        with self._lock:
            ids = [rid for rid, r in self._reqs.items()
                   if id(r) in handed_ids]
            self._handed.update(ids)
        return {"ok": True, "handed_back": sorted(ids),
                "drained": len(handed)}

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5.0)


#: the seed every replica builds its model from (the JAX package's
#: default key(0)): the same weights in every replica on one device
REPLICA_SEED = 0


def _refuse_item7(args):
    """The replica option that needs warmstart (ROADMAP.md Queue 1 item
    7) raises, naming the item."""
    if getattr(args, "warm_dir", None):
        raise NotImplementedError(
            "--warm-dir needs singa_tpu_torch.warmstart (ROADMAP.md "
            "Queue 1 item 7)")


def _build_replica_model(vocab: int, dim: int, layers: int,
                         max_seq: int, device: str = "cuda"):
    """Deterministic serving model: every replica builds THIS (same
    architecture, 4 heads, weights from REPLICA_SEED on `device`), so
    greedy decode gives the same tokens on every replica and a failover
    resubmission is invisible to the caller. On the card the head width
    dim / 4 must be one the flash kernel takes (64 or 128): anything
    else raises here, never falls back to the plain version."""
    from . import models
    from .fleet import _require_device
    _require_device(device)
    heads = 4
    if torch.device(device).type == "cuda" \
            and (dim % heads or dim // heads not in (64, 128)):
        raise ValueError(
            f"replica model dim {dim} gives head width {dim / heads:g}: "
            "the flash-attention kernel on the card takes 64 or 128 "
            "(--dim 256 or 512)")
    m = models.create_model("gpt", vocab_size=vocab, max_seq=max_seq,
                            dim=dim, num_heads=heads, num_layers=layers,
                            device=device, seed=REPLICA_SEED)
    m.eval()
    return m


def _replica_main(args) -> int:
    """One serving replica: engine + fleet shard writer + diag server +
    the control surface, announced on stdout as a JSON "ready" line.

    The cold-start observatory stamps every startup phase
    (STARTUP_PHASES: spawn -> import -> build -> trace -> lower ->
    compile -> warm -> ready) into `singa_replica_startup_seconds`,
    notes a span per phase on the STARTUP_TID track (the merged fleet
    trace renders them as a "startup" thread), and reports the
    breakdown, plus spawn-to-first-token, in the ready line. The
    trace/lower/compile splits come from diffing introspect's
    `compile_phase_totals()` around the build and warm windows (on the
    card the kernels' builds or loads land there), so build/warm report
    the rest of their wall time."""
    t_entry = time.time()
    _refuse_item7(args)
    t0 = time.time()
    from . import diag, engine, fleet, introspect, resilience, slo
    startup = {"import": time.time() - t0}
    fleet._require_device(args.device)
    spawned_at = getattr(args, "spawned_at", None)
    if spawned_at is not None:
        startup["spawn"] = max(0.0, t_entry - float(spawned_at))
    observe.enable(True)
    observe.enable_span_records()
    T = args.prompt_hi + args.new_hi
    c0 = introspect.compile_phase_totals()
    t0 = time.time()
    m = _build_replica_model(args.vocab, args.dim, args.layers, T,
                             args.device)
    eng = engine.ServingEngine(
        m, max_slots=args.slots, page_size=args.page_size, max_ctx=T,
        queue_limit=max(128, 8 * args.slots),
        steps_per_sync=2).start()
    build_wall = time.time() - t0
    c1 = introspect.compile_phase_totals()
    # warm every prompt bucket the workload can hit (plus the decode
    # step) BEFORE announcing ready: the router's p99 TTFT must
    # measure serving, not kernel builds and first allocations
    t0 = time.time()
    _, first_token_wall = eng.prewarm((args.prompt_lo, args.prompt_hi))
    warm_wall = time.time() - t0
    c2 = introspect.compile_phase_totals()
    build_xla = sum(max(0.0, c1[p] - c0[p])
                    for p in introspect.COMPILE_PHASES)
    warm_xla = sum(max(0.0, c2[p] - c1[p])
                   for p in introspect.COMPILE_PHASES)
    for p in introspect.COMPILE_PHASES:
        startup[p] = max(0.0, c2[p] - c0[p])
    startup["build"] = max(0.0, build_wall - build_xla)
    startup["warm"] = max(0.0, warm_wall - warm_xla)
    t0 = time.time()
    tracker = slo.SLOTracker(slo.SLOConfig(), capacity=8192).install()
    assert tracker is not None
    slo.install_tail()
    plan = None
    if getattr(args, "fault_delay", 0.0):
        # the --ab fault arm: a fixed per-engine-step stall makes
        # decode the provably dominant tail bucket on /tailz
        plan = resilience.FaultPlan().delay(
            "serving.engine_step", float(args.fault_delay),
            times=10 ** 9)
    if getattr(args, "corrupt_after", 0):
        # the audit --ab corrupt arm: the Nth fingerprint tick's
        # fault_point("audit.corrupt_params") flips one layer of THIS
        # replica's parameters (audit.ParamFingerprinter._corrupt), the
        # silent-data-corruption stand-in the observatory must catch
        # from the outside
        plan = (plan or resilience.FaultPlan()).fail(
            "audit.corrupt_params", nth=int(args.corrupt_after))
    if plan is not None:
        resilience.install_fault_plan(plan)
    # the correctness observatory's replica half: the startup
    # fingerprint plus the low-rate recompute timer whose snapshot
    # rides the fleet_audit shard line (started before the shard
    # writer so the first publish already carries a fingerprint)
    from . import audit
    audit.install_fingerprint(
        m, eng, interval_s=float(getattr(args, "audit_interval", 0.25)))
    fleet.start_shard_writer(args.fleet_dir,
                             interval_s=args.publish_interval)
    dsrv = diag.start_diag_server(port=0)
    ctl = ReplicaControl(eng)
    startup["ready"] = time.time() - t0
    for p in STARTUP_PHASES:
        if p in startup:
            _observe_startup(p, startup[p])
    # the startup track: phases laid out back-to-back from the spawn
    # stamp on a dedicated tid (real wall placement would overlap —
    # build time is interleaved with build/warm — so the track reads
    # as a clean waterfall whose slices sum to the startup wall)
    off = time.time() - time.perf_counter()
    cursor = (float(spawned_at) if spawned_at is not None
              else t_entry - startup["import"]) - off
    for p in STARTUP_PHASES:
        dur = startup.get(p)
        if not dur:
            continue
        observe.note_span(f"startup.{p}", cursor, dur,
                          kind="startup", tid=STARTUP_TID)
        cursor += dur
    ready = {
        "event": "ready", "name": args.name, "pid": os.getpid(),
        "ctl_port": ctl.port, "diag_port": dsrv.port,
        "device": str(m.device),
        "startup": {p: round(startup[p], 6) for p in STARTUP_PHASES
                    if p in startup}}
    if spawned_at is not None and first_token_wall is not None:
        ready["spawn_to_first_token_s"] = round(
            first_token_wall - float(spawned_at), 6)
    print(json.dumps(ready), flush=True)
    try:
        while not ctl.shutdown_evt.wait(0.2):
            pass
    except KeyboardInterrupt:
        pass
    ctl.stop()
    eng.stop()
    audit.reset()
    fleet.uninstall()
    diag.stop_diag_server()
    resilience.clear_fault_plan()
    slo.reset()
    print(json.dumps({"event": "exit", "name": args.name, "ok": True}),
          flush=True)
    return 0


# ---- spawn + handshake ------------------------------------------------------

def spawn_replica(name: str, fleet_dir: str, args, *,
                  ready_timeout_s: float = 900.0):
    """Spawn `python -m singa_tpu_torch.router --replica` on
    `args.device` (the card unless it is "cpu"; without a card a "cuda"
    replica raises here) and wait for its "ready" line. Returns (proc,
    ready_dict). The child's stdout keeps flowing to OUR stderr
    afterwards via a daemon reader thread (named singa-route-io-*; it
    exits on child EOF)."""
    from .fleet import _require_device
    device = getattr(args, "device", "cuda")
    _require_device(device)
    _refuse_item7(args)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, SINGA_FLEET_HOST=name)
    env.pop("SINGA_TPU_DIAG_PORT", None)
    cmd = [sys.executable, "-m", "singa_tpu_torch.router", "--replica",
           "--name", name, "--fleet-dir", fleet_dir,
           "--vocab", str(args.vocab), "--dim", str(args.dim),
           "--layers", str(args.layers),
           "--prompt-lo", str(args.prompt_lo),
           "--prompt-hi", str(args.prompt_hi),
           "--new-hi", str(args.new_hi),
           "--slots", str(args.slots),
           "--page-size", str(args.page_size),
           "--publish-interval", str(args.publish_interval),
           "--device", str(device),
           "--spawned-at", f"{time.time():.6f}"]
    if getattr(args, "fault_delay", 0.0):
        cmd += ["--fault-delay", str(args.fault_delay)]
    if getattr(args, "audit_interval", None) is not None:
        cmd += ["--audit-interval", str(args.audit_interval)]
    if getattr(args, "corrupt_after", 0):
        cmd += ["--corrupt-after", str(args.corrupt_after)]
    proc = subprocess.Popen(cmd, cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=sys.stderr,
                            text=True)
    ready_box = {}
    ready_evt = threading.Event()

    def _read():
        for line in proc.stdout:
            line = line.strip()
            if not ready_evt.is_set() and line.startswith("{"):
                try:
                    obj = json.loads(line)
                except ValueError:
                    obj = None
                if isinstance(obj, dict) \
                        and obj.get("event") == "ready":
                    ready_box.update(obj)
                    ready_evt.set()
                    continue
            if line:
                print(f"[{name}] {line}", file=sys.stderr)
        proc.stdout.close()

    t = threading.Thread(target=_read, name=f"singa-route-io-{name}",
                         daemon=True)
    t.start()
    deadline = time.monotonic() + ready_timeout_s
    while not ready_evt.wait(0.2):
        if proc.poll() is not None:
            raise RuntimeError(
                f"replica {name} exited rc={proc.returncode} before "
                "ready")
        if time.monotonic() > deadline:
            proc.kill()
            raise RuntimeError(f"replica {name} not ready after "
                               f"{ready_timeout_s}s")
    return proc, dict(ready_box)


# ---- the kill-and-replace A/B harness ---------------------------------------

def _ab_arm(args, workdir: str, *, kill: bool,
            fault_delay: float = 0.0) -> dict:
    """One harness arm: N replicas under the seeded Poisson workload.
    With `kill`, SIGKILL one replica mid-traffic and join a (pre-warmed)
    standby in its place; with `fault_delay`, every replica stalls each
    engine step by that much (the tail-attribution probe). Returns
    per-request outcomes/tokens, the router's counters, the tail
    summary + per-request attribution sums, each replica's cold-start
    breakdown, and (kill arm) the merged-trace flow checks — the
    caller does the cross-arm asserts."""
    from types import SimpleNamespace

    from . import diag, fleet, serving, slo
    fleet_dir = os.path.join(workdir, "spool")
    os.makedirs(fleet_dir, exist_ok=True)
    agg = fleet.install_aggregator(fleet_dir, stale_after_s=60.0,
                                   poll_interval_s=0.05)
    diag.start_diag_server(port=0)
    spawn_args = SimpleNamespace(**vars(args))
    spawn_args.fault_delay = fault_delay
    r = Router(fleet_dir=fleet_dir,
               queue_limit=max(64, 4 * args.requests),
               max_attempts=8, retry_base_s=0.05, retry_max_s=1.0,
               retry_total_s=args.timeout, retry_seed=args.seed,
               health_interval_s=0.05, liveness_floor_s=1.0,
               liveness_ceiling_s=15.0).start()
    arm = {"kill": kill}
    try:
        names = [f"r{i}" for i in range(args.replicas)]
        spawn_names = names + ([f"r{args.replicas}"] if kill else [])
        spawned = {}
        threads = []
        errs = {}

        def _spawn_one(n):
            try:
                spawned[n] = spawn_replica(n, fleet_dir, spawn_args)
            except Exception as e:  # surfaced after the join below
                errs[n] = e

        for n in spawn_names:
            t = threading.Thread(target=_spawn_one, args=(n,),
                                 name=f"singa-route-spawn-{n}",
                                 daemon=True)
            threads.append(t)
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise RuntimeError(f"replica spawn failed: {errs}")
        for n in names:
            proc, ready = spawned[n]
            r.add_replica(
                n, f"http://127.0.0.1:{ready['ctl_port']}", host=n,
                diag_url=f"http://127.0.0.1:{ready['diag_port']}",
                proc=proc)
        standby = spawned.get(f"r{args.replicas}")

        wl = serving.poisson_workload(
            args.seed, args.requests, args.rps, args.vocab,
            (args.prompt_lo, args.prompt_hi), (4, args.new_hi))
        kill_at = max(1, int(args.kill_frac * args.requests))
        victim = names[1 % len(names)]
        handles = []
        t0 = time.perf_counter()
        killed_ts = None
        kill_traces: "set[str]" = set()
        for i in range(args.requests):
            dt = t0 + wl["arrivals"][i] - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
            handles.append(r.submit(wl["prompts"][i],
                                    int(wl["new_lens"][i])))
            if kill and killed_ts is None and i >= kill_at:
                # SIGKILL, not terminate: the replica gets no chance to
                # drain — this is the crash the failover path exists
                # for. Prefer the moment the victim has a request IN
                # FLIGHT (spin briefly after the submit; at low rps the
                # request would otherwise finish between arrivals), so
                # the run provably exercises mid-request failover, and
                # force the kill within a few arrivals regardless.
                vrep = r.get_replica(victim)
                spin = time.perf_counter() + 0.25
                while time.perf_counter() < spin \
                        and not vrep.inflight:
                    time.sleep(0.001)
                # ...and hold the trigger until the victim's ACCEPTED
                # work has provably reached its shard file (the
                # handle_submit force-publish): the merged trace's
                # victim track only exists if the in-flight timeline
                # hit disk before the SIGKILL. Bounded — a request
                # that completes first just means a later arrival
                # re-arms the trigger.
                published = False
                spin = time.perf_counter() \
                    + 6.0 * args.publish_interval
                while time.perf_counter() < spin and vrep.inflight:
                    agg.poll()
                    if any(w.host == victim
                           and isinstance(w.serve, dict)
                           and w.serve.get("active")
                           for w in agg._workers.values()):
                        published = True
                        break
                    time.sleep(0.005)
                # on the card a short request can end between any check
                # and the SIGKILL: kill only a frozen victim that still
                # holds a request it accepted
                kill_traces = (_freeze_holding(r, vrep, victim, agg,
                                               handles)
                               if published else set())
                if not kill_traces and i < kill_at + 8 \
                        and i < args.requests - 1:
                    continue
                vrep.proc.kill()
                killed_ts = time.perf_counter() - t0
                sproc, sready = standby
                r.add_replica(
                    f"r{args.replicas}",
                    f"http://127.0.0.1:{sready['ctl_port']}",
                    host=f"r{args.replicas}",
                    diag_url=f"http://127.0.0.1:{sready['diag_port']}",
                    proc=sproc)
        stuck = [h.id for h in handles if not h.wait(args.timeout)]
        snap = r.snapshot()
        fleetz = fleet.fleet_report()
        arm["tail"] = slo.tail_summary()
        # the wall-sum property, per terminal request: the LATENCY_ATTR
        # buckets must reconstruct the request's total wall time
        arm["attr_checks"] = [
            {"id": h.id, "outcome": h.outcome,
             "total_s": round(h.finished_ts - h.submitted, 6),
             "attr_sum": round(sum((h.attr or {}).values()), 6)}
            for h in handles if h.outcome is not None
            and h.finished_ts is not None]
        arm["startup"] = {n: ready.get("startup")
                          for n, (_, ready) in spawned.items()}
        arm["spawn_to_first_token_s"] = {
            n: ready.get("spawn_to_first_token_s")
            for n, (_, ready) in spawned.items()}
        if kill:
            # merged-trace flow check on a request that provably
            # failed over FROM the victim and completed elsewhere:
            # its trace_ctx flow must step through the router track
            # AND both replica tracks (the victim's partial work
            # survives in its last published shard)
            time.sleep(3.0 * args.publish_interval)
            agg.poll()
            # (first one the victim held at the kill, if any)
            picks = [h for h in handles
                     if h.outcome == OUTCOME_COMPLETED
                     and victim in {i.get("replica")
                                    for e, _, i in h.events
                                    if e == "failover"}]
            picks.sort(key=lambda h: h.trace not in kill_traces)
            pick = picks[0] if picks else None
            arm["trace_checks"] = (
                _check_merged_trace(agg.trace_events(), pick.trace,
                                    os.getpid())
                if pick is not None else None)
        arm.update({
            "stuck": stuck,
            "outcomes": {h.id: h.outcome for h in handles},
            "tokens": {h.id: list(h.tokens) for h in handles
                       if h.outcome == OUTCOME_COMPLETED},
            "served_by": sorted({h.replica for h in handles
                                 if h.replica is not None}),
            "ttfts": [h.ttft_s for h in handles
                      if h.ttft_s is not None],
            "attempts_max": max((h.attempts for h in handles),
                                default=0),
            "failovers": snap["failovers"]["replica_dead"]
            + snap["failovers"]["drain"],
            "retries": snap["retries"],
            "reasons": snap["reasons"],
            "replica_states": {rep["name"]: rep["state"]
                               for rep in snap["replicas"]},
            "killed_at_s": killed_ts,
            "victim": victim if kill else None,
            "fleetz_has_router": "== router ==" in fleetz,
        })
        if kill and standby is not None \
                and f"r{args.replicas}" not in {
                    rep["name"] for rep in snap["replicas"]}:
            # kill_at was never reached (tiny workloads): retire the
            # unused standby so nothing leaks
            standby[0].kill()
            standby[0].wait(timeout=10.0)
        return arm
    finally:
        r.stop()
        reset()
        fleet.uninstall()
        diag.stop_diag_server()
        slo.tail_reset()  # each arm's /tailz view stands alone


def _freeze_holding(router, rep, host: str, agg, handles,
                    settle_s: float = 0.05) -> "set[str]":
    """The kill trigger's last check. SIGSTOP the replica's process (it
    can send no answer and write no shard), let the senders take in any
    answer already on the wire, and return the trace ids of the
    requests it still holds unanswered that its final shard shows it
    had accepted. When there are none, SIGCONT it and return an empty
    set."""
    os.kill(rep.proc.pid, signal.SIGSTOP)
    time.sleep(settle_s)
    agg.poll()
    on_disk = {tl.get("trace") for w in agg._workers.values()
               if w.host == host and isinstance(w.serve, dict)
               for tl in w.serve.get("active") or []}
    with router._lock:
        held = {h.trace for h in handles
                if h.id in rep.inflight and h.trace is not None
                and h.trace in on_disk}
    if not held:
        os.kill(rep.proc.pid, signal.SIGCONT)
    return held


def _check_merged_trace(trace: dict, trace_id, router_pid) -> dict:
    """Schema + flow checks over a merged fleet trace for ONE routed
    request's trace-context id: exactly one process_name per pid,
    every per-replica req_flow id scoped to its own pid (no
    cross-linked requests), and the trace_ctx flow for `trace_id`
    stepping s (router) -> t (each replica that touched it) -> f
    (router) in timestamp order across at least two replica pids."""
    events = trace.get("traceEvents") or []
    pname: "dict[int, int]" = {}
    bad_scope = 0
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pname[e["pid"]] = pname.get(e["pid"], 0) + 1
        if e.get("cat") == "req_flow" \
                and e.get("ph") in ("s", "t", "f") \
                and not str(e.get("id", "")).startswith(
                    f"{e.get('pid')}:"):
            bad_scope += 1
    from .slo import TRACE_CTX_CAT
    steps = [e for e in events
             if e.get("cat") == TRACE_CTX_CAT
             and str(e.get("id")) == str(trace_id)]
    s_ev = [e for e in steps if e.get("ph") == "s"]
    t_ev = [e for e in steps if e.get("ph") == "t"]
    f_ev = [e for e in steps if e.get("ph") == "f"]
    rep_pids = sorted({e["pid"] for e in t_ev
                       if e["pid"] != router_pid})
    ordered = bool(
        len(s_ev) == 1 and len(f_ev) == 1 and t_ev
        and all(s_ev[0]["ts"] < e["ts"] < f_ev[0]["ts"]
                for e in t_ev))
    out = {
        "one_name_per_pid": bool(pname) and all(
            v == 1 for v in pname.values()),
        "req_flow_ids_pid_scoped": bad_scope == 0,
        "router_anchors": len(s_ev) == 1 and len(f_ev) == 1
        and all(e["pid"] == router_pid for e in s_ev + f_ev),
        "replica_pids": rep_pids,
        "spans_two_replicas": len(rep_pids) >= 2,
        "flow_ordered": ordered,
    }
    out["ok"] = bool(
        out["one_name_per_pid"] and out["req_flow_ids_pid_scoped"]
        and out["router_anchors"] and out["spans_two_replicas"]
        and out["flow_ordered"])
    return out


def _ab_main(args) -> int:
    from types import SimpleNamespace

    from . import engine
    base = tempfile.mkdtemp(prefix="singa_router_ab_")
    rec = {"replicas": args.replicas, "requests": args.requests,
           "rps": args.rps, "seed": args.seed, "device": args.device,
           "ok": False}
    # the fault arm is a small third run: every replica stalls each
    # engine step by --fault-delay, so /tailz must rank decode as the
    # top p99 contributor — the attribution pipeline proven end to end
    fault_args = SimpleNamespace(**vars(args))
    fault_args.replicas = min(2, args.replicas)
    fault_args.requests = min(8, args.requests)
    try:
        clean = _ab_arm(args, os.path.join(base, "clean"), kill=False)
        kill = _ab_arm(args, os.path.join(base, "kill"), kill=True)
        fault = _ab_arm(fault_args, os.path.join(base, "fault"),
                        kill=False,
                        fault_delay=args.fault_delay or 0.05)
    finally:
        import shutil
        shutil.rmtree(base, ignore_errors=True)
    n = args.requests
    clean_done = sum(1 for o in clean["outcomes"].values()
                     if o == OUTCOME_COMPLETED)
    kill_done = sum(1 for o in kill["outcomes"].values()
                    if o == OUTCOME_COMPLETED)
    # zero loss: every submit terminal, and through the kill every one
    # COMPLETED (the retry budget is sized so nothing exhausts)
    lost = len(kill["stuck"]) + sum(
        1 for o in kill["outcomes"].values() if o is None)
    matched = all(kill["tokens"].get(rid) == toks
                  for rid, toks in clean["tokens"].items())
    # where the arms part, the request's prompt and both token lists: a
    # failed-over request ran in another batch on another replica, and
    # the card's GEMMs may then round a near-tie the other way (a caller
    # recomputes the clean arm's top-2 gap there to tell a tie from a
    # fault)
    from . import serving
    wl = serving.poisson_workload(
        args.seed, args.requests, args.rps, args.vocab,
        (args.prompt_lo, args.prompt_hi), (4, args.new_hi))
    mismatches = [
        {"id": rid, "prompt": [int(t) for t in wl["prompts"][rid - 1]],
         "clean": toks, "kill": kill["tokens"].get(rid)}
        for rid, toks in sorted(clean["tokens"].items())
        if kill["tokens"].get(rid) != toks]
    victim_dead = kill["replica_states"].get(kill["victim"]) \
        == STATE_DEAD
    standby_served = f"r{args.replicas}" in kill["served_by"]
    p99_clean = engine.pctile(clean["ttfts"], 0.99)
    p99_kill = engine.pctile(kill["ttfts"], 0.99)
    # per-request attribution must reconstruct each wall time within
    # 10% (plus a small absolute floor for sub-ms rejects)
    attr_ok = all(
        abs(c["attr_sum"] - c["total_s"])
        <= max(0.10 * c["total_s"], 0.005)
        for arm in (clean, kill, fault)
        for c in arm["attr_checks"])
    attr_n = sum(len(arm["attr_checks"])
                 for arm in (clean, kill, fault))
    trace_checks = kill.get("trace_checks")
    fault_top = (fault.get("tail") or {}).get("top")
    decode_p99 = (((fault.get("tail") or {}).get("buckets") or {})
                  .get("decode") or {}).get("p99_s")
    cold_vals = [v for v in
                 clean["spawn_to_first_token_s"].values()
                 if v is not None]
    cold_p50 = engine.pctile(cold_vals, 0.5)
    warm_p50 = engine.pctile(clean["ttfts"], 0.5)
    startup0 = clean["startup"].get("r0") or {}
    rec.update({
        "clean_completed": clean_done, "kill_completed": kill_done,
        "lost_requests": lost,
        "kill_outcomes": {o: sum(1 for v in kill["outcomes"].values()
                                 if v == o) for o in ROUTE_OUTCOMES},
        "failovers": kill["failovers"], "retries": kill["retries"],
        "tokens_match_clean_arm": matched,
        "token_mismatches": mismatches,
        "victim_marked_dead": victim_dead,
        "standby_served": standby_served,
        "killed_at_s": kill["killed_at_s"],
        "fleetz_has_router_rows": bool(clean["fleetz_has_router"]
                                       and kill["fleetz_has_router"]),
        "ttft_p99_clean_s": p99_clean, "ttft_p99_kill_s": p99_kill,
        "ttft_p99_delta_s": (round(p99_kill - p99_clean, 6)
                             if p99_clean is not None
                             and p99_kill is not None else None),
        "attr_sum_ok": attr_ok, "attr_checked_requests": attr_n,
        "trace": trace_checks,
        "fault_top_bucket": fault_top,
        "fault_completed": sum(
            1 for o in fault["outcomes"].values()
            if o == OUTCOME_COMPLETED),
        "startup_phases": startup0,
        "cold_spawn_first_token_s": cold_p50,
        "cold_warm_first_token_delta_s": (
            round(cold_p50 - warm_p50, 6)
            if cold_p50 is not None and warm_p50 is not None
            else None),
    })
    rec["ok"] = bool(
        clean_done == n and kill_done == n and lost == 0 and matched
        and victim_dead and standby_served
        and kill["failovers"] >= 1
        and rec["fleetz_has_router_rows"]
        and p99_clean is not None and p99_kill is not None
        and attr_ok and attr_n >= 2 * n
        and trace_checks is not None and trace_checks["ok"]
        and fault_top == "decode"
        and set(startup0) == set(STARTUP_PHASES)
        and cold_p50 is not None and warm_p50 is not None
        and cold_p50 > warm_p50)
    lines = [
        {"metric": "router_lost_requests", "value": float(lost),
         "unit": "count"},
        {"metric": "router_failover_requests",
         "value": float(kill["failovers"]), "unit": "count"},
        {"metric": "router_ttft_p99_clean_s",
         "value": float(p99_clean or 0.0), "unit": "s"},
        {"metric": "router_ttft_p99_kill_s",
         "value": float(p99_kill or 0.0), "unit": "s"},
        {"metric": "router_cold_spawn_first_token_s",
         "value": float(cold_p50 or 0.0), "unit": "s"},
        {"metric": "router_cold_warm_first_token_delta_s",
         "value": float(rec["cold_warm_first_token_delta_s"] or 0.0),
         "unit": "s"},
        {"metric": "replica_startup_total_s",
         "value": float(round(sum(startup0.values()), 6)
                        if startup0 else 0.0), "unit": "s"},
        {"metric": "router_tailz_decode_p99_contrib_s",
         "value": float(decode_p99 or 0.0), "unit": "s"},
        rec,
    ]
    with open(args.out, "w", encoding="utf-8") as f:
        for obj in lines:
            f.write(json.dumps(obj, sort_keys=True) + "\n")
    print(json.dumps(rec, indent=2, sort_keys=True))
    return 0 if rec["ok"] else 1


# ---- the cold-vs-warm spawn A/B ---------------------------------------------

def _warm_probe(ctl_port: int, args, rid: int = 1) -> "list[int]":
    """The warm A/B's seeded probe: it compares a replica that loaded its
    builds from the warm store with one that built them, which needs
    `warmstart` (ROADMAP.md Queue 1 item 7)."""
    raise NotImplementedError(
        "the warm A/B probe needs singa_tpu_torch.warmstart (ROADMAP.md "
        "Queue 1 item 7)")


def _warm_ab_main(args) -> int:
    """The zero-compile-restart A/B (`--warm-ab`): a cold replica against
    an empty warm store, then a warm one against the same store. Needs
    `warmstart` (ROADMAP.md Queue 1 item 7)."""
    raise NotImplementedError(
        "--warm-ab needs singa_tpu_torch.warmstart (ROADMAP.md Queue 1 "
        "item 7)")


# ---- CLI --------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m singa_tpu_torch.router",
        description="serving control plane: --replica runs one serving "
                    "replica; --ab runs the kill-and-replace harness "
                    "(--warm-ab, the cold-vs-warm spawn A/B, comes with "
                    "ROADMAP.md Queue 1 item 7)")
    p.add_argument("--replica", action="store_true")
    p.add_argument("--ab", action="store_true")
    p.add_argument("--warm-ab", action="store_true",
                   help="the cold-vs-warm spawn A/B: needs warmstart "
                        "(ROADMAP.md Queue 1 item 7), raises until then")
    p.add_argument("--name", default="r0")
    p.add_argument("--fleet-dir", default=None)
    p.add_argument("--replicas", type=int, default=3)
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--rps", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--kill-frac", type=float, default=0.35,
                   help="kill the victim after this fraction of "
                        "submits (kill arm)")
    p.add_argument("--vocab", type=int, default=211)
    p.add_argument("--dim", type=int, default=64,
                   help="model width (4 heads); on the card 256 or 512, "
                        "the flash kernel's head widths 64 and 128")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--prompt-lo", type=int, default=4)
    p.add_argument("--prompt-hi", type=int, default=12)
    p.add_argument("--new-hi", type=int, default=24)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--page-size", type=int, default=8)
    p.add_argument("--publish-interval", type=float, default=0.1)
    p.add_argument("--spawned-at", type=float, default=None,
                   help="replica mode: the parent's time.time() at "
                        "spawn — anchors the cold-start observatory's "
                        "spawn phase and spawn-to-first-token")
    p.add_argument("--fault-delay", type=float, default=0.0,
                   help="replica mode: install a FaultPlan delay of "
                        "this many seconds on every serving.engine_step "
                        "(the --ab fault arm's tail-attribution probe)")
    p.add_argument("--audit-interval", type=float, default=0.25,
                   help="replica mode: param-fingerprint recompute "
                        "period (singa-audit-fp timer)")
    p.add_argument("--corrupt-after", type=int, default=0,
                   help="replica mode: flip one parameter layer at the "
                        "Nth fingerprint tick (FaultPlan fail at "
                        "'audit.corrupt_params'), the audit --ab corrupt "
                        "arm's injected corruption")
    p.add_argument("--warm-dir", default=None,
                   help="warm-store root: needs warmstart (ROADMAP.md "
                        "Queue 1 item 7), raises until then")
    p.add_argument("--warm-compile-frac", type=float, default=0.10,
                   help="--warm-ab: warm arm's compile seconds must be "
                        "<= this fraction of the cold arm's")
    p.add_argument("--warm-speedup", type=float, default=3.0,
                   help="--warm-ab: warm spawn-to-first-token must "
                        "beat cold by at least this factor")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where every replica runs")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.out is None:
        args.out = "WARM_torch.json" if args.warm_ab \
            else "SERVE_torch.json"
    if args.replica:
        if not args.fleet_dir:
            p.error("--replica needs --fleet-dir")
        return _replica_main(args)
    if args.warm_ab:
        return _warm_ab_main(args)
    if args.ab:
        return _ab_main(args)
    p.error("pick a mode: --replica, --ab, or --warm-ab")
    return 2


__all__ = [
    "ROUTE_OUTCOMES", "ROUTE_REASONS", "REPLICA_STATES",
    "STARTUP_PHASES",
    "Router", "RouterRequest", "Replica", "ReplicaControl",
    "install_router", "get_router", "reset",
    "serving_lines", "fleetz_lines", "router_report",
    "router_json", "router_trace_events",
    "spawn_replica",
]

if __name__ == "__main__":
    # run under the CANONICAL module (not the runpy __main__ alias): the
    # CLI installs module singletons the diag/fleet layers reach via
    # `import singa_tpu_torch.router`
    from singa_tpu_torch.router import main as _main
    sys.exit(_main())
