"""Request-level serving observability (counterpart of singa_tpu/slo.py):
timelines, SLOs, burn rates, tail attribution and the request trace.

  - **Per-request timelines**: every `engine.EngineRequest` records
    phase-stamped events from `REQUEST_PHASES` (submit -> queue -> admit
    -> prefill -> first_token -> one decode per sync with the tokens so
    far -> terminal), ring-buffered per engine
    (`ServingEngine.timelines()`, a locked copy).
    `engine_trace_events()` exports them as Trace Event JSON (Perfetto):
    one track per decode slot plus a queue track, with flow events
    linking each request's decode span to the `serving.engine_step`
    slices it rode (the engine's sync ring records each sync's window,
    which lies inside that sync's span).

  - **SLO tracker**: `SLOConfig` declares targets (p99 TTFT, p99 request
    latency, availability, a tokens/sec floor); `SLOTracker` subscribes
    to the engine's terminal-request stream
    (`engine.add_request_listener`), evaluates attainment over sliding
    windows and the multi-window error-budget burn rate. A breach (both
    windows over `burn_threshold` for `sustain` consecutive evaluations)
    goes to the active `health.HealthMonitor.note_external(KIND_SLO)`.
    Exports `singa_slo_*` metrics. The dense, speculative and beam
    decode paths feed it through `note_decode`.

  - **Tail attribution**: every terminal request's wall time decomposes
    into the `LATENCY_ATTR` buckets (`attribute_timeline`,
    `attribute_route`), summed into `singa_tail_seconds_total` and the
    tail store (`TailCollector`, `tail_summary`).

Clocks: events are stamped with `time.perf_counter()`, the clock of the
observe span ring, and the tracker's windows run on the same stamps.

`fleet_serve_snapshot` reads the memory ledger's kv_cache region as the
KV-cache bytes when a ledger is installed (the target's and the draft's
pools), else the engines' `pool_bytes` (the targets'). The `--ab` command
line (`main`, `_ab_main`, `_ab_leg`) publishes through `fleet`'s shard
writer and aggregator and comes with ROADMAP.md Queue 1 item 6b;
`chip_smoke.py` phase 13a runs the same A/B on one engine.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from . import health, memory, observe

#: every lifecycle phase a request's timeline can record (the `phase=`
#: label on singa_slo_phase_seconds is proven against this tuple by
#: tools/check_metrics_names.py rule 5).
REQUEST_PHASES = ("submit", "queue", "admit", "prefill", "first_token",
                  "decode", "terminal")
PHASE_SUBMIT = "submit"
PHASE_QUEUE = "queue"
PHASE_ADMIT = "admit"
PHASE_PREFILL = "prefill"
PHASE_FIRST_TOKEN = "first_token"
PHASE_DECODE = "decode"
PHASE_TERMINAL = "terminal"

#: every declarable serving objective (the `objective=` label on the
#: singa_slo_* metrics is proven against this tuple by rule 5).
SLO_OBJECTIVES = ("ttft_p99", "latency_p99", "availability",
                  "tokens_per_sec")

#: every latency-attribution bucket a terminal request's wall time can
#: decompose into (the `attr=` label on singa_tail_seconds_total is
#: proven against this tuple by rule 5). The decomposition is pure
#: math over the phase-stamped timelines and MUST sum to the request's
#: total latency — the same wall-sum discipline as the goodput
#: buckets, test-enforced.
LATENCY_ATTR = ("router_queue", "probe", "dispatch_retry",
                "replica_queue", "prefill", "decode", "decode_stall",
                "failover_replay", "other")
ATTR_ROUTER_QUEUE = "router_queue"
ATTR_PROBE = "probe"
ATTR_DISPATCH_RETRY = "dispatch_retry"
ATTR_REPLICA_QUEUE = "replica_queue"
ATTR_PREFILL = "prefill"
ATTR_DECODE = "decode"
ATTR_DECODE_STALL = "decode_stall"
ATTR_FAILOVER_REPLAY = "failover_replay"
ATTR_OTHER = "other"


_metrics_cache: "dict | None" = None


def _metrics():
    # observe.counter/gauge/histogram spelled out so the static lint
    # sees every registration; objective=/phase= label values are
    # members of SLO_OBJECTIVES / REQUEST_PHASES (enum-guarded at the
    # record sites). Memoized behind one sentinel lookup (the engine's
    # pattern): this runs per terminal request and per evaluation on
    # the serving path, and 9 locked registry lookups per call is
    # repeated work — revalidated so a conftest registry reset rebuilds
    # instead of feeding orphaned metric objects.
    global _metrics_cache
    c = _metrics_cache
    if c is not None and observe.get_registry().get(
            "singa_slo_attainment_pct") is c["attainment"]:
        return c
    _metrics_cache = c = {
        "attainment": observe.gauge(
            "singa_slo_attainment_pct",
            "per-objective SLO attainment over the sliding window "
            "(percent of applicable requests meeting the target)"),
        "burn_fast": observe.gauge(
            "singa_slo_burn_rate_fast",
            "error-budget burn rate over the FAST window "
            "(violation fraction / error budget)"),
        "burn_slow": observe.gauge(
            "singa_slo_burn_rate_slow",
            "error-budget burn rate over the SLOW window"),
        "budget": observe.gauge(
            "singa_slo_error_budget_remaining",
            "1 - slow-window burn rate: the share of the error budget "
            "left at the current violation rate"),
        "window_requests": observe.gauge(
            "singa_slo_window_requests",
            "terminal requests inside the attainment window"),
        "evals": observe.counter(
            "singa_slo_evaluations_total",
            "SLO tracker evaluation passes"),
        "violations": observe.counter(
            "singa_slo_violations_total",
            "requests that violated an objective, by objective"),
        "breaches": observe.counter(
            "singa_slo_breach_total",
            "sustained burn-rate breach verdicts, by objective"),
        "phase": observe.histogram(
            "singa_slo_phase_seconds",
            "wall seconds a request spent in each lifecycle phase"),
        "tail": observe.counter(
            "singa_tail_seconds_total",
            "terminal-request wall seconds attributed to each "
            "latency bucket (LATENCY_ATTR decomposition)"),
    }
    return c


# ---- configuration ---------------------------------------------------------

class SLOConfig:
    """Declared serving objectives. An objective is ENABLED iff its
    target is not None:

      ttft_p99_s          p99 submit-to-first-token (percentile target:
                          `percentile` of requests must meet it)
      latency_p99_s       p99 submit-to-terminal latency, judged on
                          completed requests
      availability        fraction of requests that must finish
                          neither "timeout" nor "evicted"
      min_tokens_per_sec  per-request generation-rate floor, judged on
                          completed requests

    Window geometry: `window_s` is the attainment window the gauges
    report over; `fast_window_s` / `slow_window_s` are the two
    burn-rate windows (the classic 5m/1h pair, scaled down for tests);
    a breach needs BOTH over `burn_threshold` for `sustain`
    consecutive evaluations, at least `min_requests` requests in the
    slow window, and `eval_interval_s` throttles request-driven
    evaluation."""

    def __init__(self, ttft_p99_s=None, latency_p99_s=None,
                 availability=None, min_tokens_per_sec=None,
                 percentile=0.99, window_s=60.0, fast_window_s=5.0,
                 slow_window_s=30.0, burn_threshold=2.0, sustain=2,
                 min_requests=5, eval_interval_s=0.5):
        self.ttft_p99_s = ttft_p99_s
        self.latency_p99_s = latency_p99_s
        self.availability = availability
        self.min_tokens_per_sec = min_tokens_per_sec
        self.percentile = float(percentile)
        self.window_s = float(window_s)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.sustain = int(sustain)
        self.min_requests = int(min_requests)
        self.eval_interval_s = float(eval_interval_s)

    def enabled(self):
        """The objectives this config declares, in enum order."""
        on = []
        for obj in SLO_OBJECTIVES:
            if self._target_value(obj) is not None:
                on.append(obj)
        return on

    def _target_value(self, objective):
        return {"ttft_p99": self.ttft_p99_s,
                "latency_p99": self.latency_p99_s,
                "availability": self.availability,
                "tokens_per_sec": self.min_tokens_per_sec}[objective]

    def target_fraction(self, objective) -> float:
        """The good-fraction the objective demands: `percentile` for
        the percentile/rate objectives, the availability itself for
        availability. Error budget = 1 - target_fraction."""
        if objective == "availability":
            return float(self.availability)
        return self.percentile

    def snapshot(self) -> dict:
        return {
            "ttft_p99_s": self.ttft_p99_s,
            "latency_p99_s": self.latency_p99_s,
            "availability": self.availability,
            "min_tokens_per_sec": self.min_tokens_per_sec,
            "percentile": self.percentile,
            "window_s": self.window_s,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "burn_threshold": self.burn_threshold,
            "sustain": self.sustain,
            "min_requests": self.min_requests,
        }


# ---- the pure math ---------------------------------------------------------
# Free functions over plain record dicts, so bench_decode's static arm
# (which has no engine, only measured latencies) and the tests' synthetic
# violation sequences evaluate with EXACTLY the tracker's arithmetic.

def objective_good(objective, rec, cfg) -> "bool | None":
    """Whether one terminal-request record meets `objective` (None =
    the objective does not apply to this record). Records are the
    tracker's shape: {"outcome", "ttft_s", "total_s",
    "tokens_per_sec"}. Rejected requests are deliberate admission-
    control shed: they are excluded from the latency-shaped objectives
    and count as AVAILABLE (the declared availability objective is the
    non-timeout/evicted fraction)."""
    assert objective in SLO_OBJECTIVES, objective
    outcome = rec.get("outcome")
    if objective == "availability":
        return outcome not in ("timeout", "evicted")
    if outcome == "rejected":
        return None
    if objective == "ttft_p99":
        ttft = rec.get("ttft_s")
        if ttft is None:
            # a queue-expired timeout never reached a first token —
            # that IS a TTFT violation; a path that simply doesn't
            # measure TTFT (the fused beam program has no prefill
            # seam) is not applicable, not failing
            return False if outcome == "timeout" else None
        return float(ttft) <= float(cfg.ttft_p99_s)
    if outcome != "completed":
        return None  # latency/rate are judged on successes only
    if objective == "latency_p99":
        total = rec.get("total_s")
        if total is None:
            return None  # missing sample = N/A, like ttft/rate
        return float(total) <= float(cfg.latency_p99_s)
    rate = rec.get("tokens_per_sec")
    if rate is None:
        return None
    return float(rate) >= float(cfg.min_tokens_per_sec)


def attainment(records, cfg, now=None, window_s=None) -> dict:
    """{objective: {"attainment", "good", "total"}} over the records
    inside the window (all records when `now` is None). `attainment`
    is None when no record was applicable."""
    if now is not None:
        w = cfg.window_s if window_s is None else window_s
        records = [r for r in records if now - r["ts"] <= w]
    out = {}
    for obj in cfg.enabled():
        good = total = 0
        for r in records:
            g = objective_good(obj, r, cfg)
            if g is None:
                continue
            total += 1
            good += 1 if g else 0
        out[obj] = {"good": good, "total": total,
                    "attainment": (good / total) if total else None}
    return out


def burn_rate(att: "float | None", target: float) -> "float | None":
    """Error-budget burn: observed violation fraction / budget. 1.0
    spends the budget exactly at the window's pace; None when the
    window held no applicable request. The budget is floored so a
    target of 1.0 (zero budget) yields a huge-but-finite burn instead
    of dividing by zero."""
    if att is None:
        return None
    budget = max(1.0 - float(target), 1e-6)
    return (1.0 - float(att)) / budget


# ---- the tracker -----------------------------------------------------------

def request_latency_sample(req, timeline: dict) -> "dict | None":
    """Reduce one terminal (req, timeline) listener callback to the
    latency sample the regression detector feeds on: {"ttft_s",
    "itl_s", "tokens"}. None for anything that should not calibrate or
    convict a latency baseline — synthetic audit probes (same door as
    note_timeline), non-completed outcomes (an eviction's short total
    is not a latency), and requests that never produced a first token.
    itl_s is the mean inter-token latency (decode span over tokens
    after the first); None when only one token was produced."""
    if not timeline or timeline.get("synthetic"):
        return None
    if timeline.get("outcome") != "completed":
        return None
    ttft = timeline.get("ttft_s")
    if ttft is None:
        return None
    tokens = int(timeline.get("new_tokens") or 0)
    itl = None
    total = timeline.get("total_s")
    if total is not None and tokens > 1:
        itl = max(0.0, (float(total) - float(ttft)) / (tokens - 1))
    return {"ttft_s": float(ttft), "itl_s": itl, "tokens": tokens}


class SLOTracker:
    """Evaluates an `SLOConfig` over the engine's terminal-request
    stream. `install()` subscribes it to `engine.add_request_listener`
    (and registers it module-wide so /slo, the fleet shard writer and
    the conftest teardown find it); every terminal request lands in a
    bounded record window, throttle-evaluated. `policy` resolves the
    breach action like the fleet aggregator's: None inherits the
    active HealthMonitor's ("halt" stays halt, anything else warns)."""

    def __init__(self, config: "SLOConfig | None" = None, policy=None,
                 capacity=4096, clock=time.perf_counter):
        if policy is not None and policy not in ("warn", "halt"):
            raise ValueError(
                f"policy {policy!r} not in ('warn', 'halt')")
        self.config = config or SLOConfig()
        self.policy = policy
        self.clock = clock
        self._lock = threading.Lock()
        self._records: "deque[dict]" = deque(maxlen=int(capacity))
        self._violations: "deque[dict]" = deque(maxlen=32)
        self._over = {}        # objective -> consecutive burning evals
        self._breached = set()  # objectives inside a breach episode
        self._last_eval = 0.0
        self._last_verdict = None
        self._evals = 0
        self._health = health

    # -- feeding -----------------------------------------------------------
    def _on_request(self, req, timeline):
        """engine request listener: (EngineRequest, timeline dict)."""
        self.note_timeline(timeline)

    def note_timeline(self, timeline: dict):
        """Feed one finished request timeline (the engine's ring
        shape). Derives the tracker record, books per-phase durations,
        tracks violations for the /slo display, and throttle-runs an
        evaluation pass. Synthetic (audit canary/replay) timelines are
        dropped at the door: a probe storm must never move SLO
        attainment or burn the error budget — correctness probing is
        the audit module's verdict, not demand-facing load."""
        if timeline.get("synthetic"):
            return
        events = timeline.get("events") or []
        ts = events[-1][1] if events else self.clock()
        rec = {
            "ts": float(ts),
            "id": timeline.get("id"),
            "outcome": timeline.get("outcome"),
            "ttft_s": timeline.get("ttft_s"),
            "total_s": timeline.get("total_s"),
            "tokens_per_sec": timeline.get("tokens_per_sec"),
        }
        self.note_record(rec, timeline=timeline)

    def note_record(self, rec: dict, timeline: "dict | None" = None):
        """Feed one plain terminal record ({"ts", "outcome", "ttft_s",
        "total_s", "tokens_per_sec"}) — the no-engine path tests and
        bench arms use."""
        cfg = self.config
        violated = [obj for obj in cfg.enabled()
                    if objective_good(obj, rec, cfg) is False]
        with self._lock:
            self._records.append(dict(rec))
            if violated:
                self._violations.append({
                    "id": rec.get("id"), "ts": rec.get("ts"),
                    "outcome": rec.get("outcome"),
                    "objectives": violated,
                    "ttft_s": rec.get("ttft_s"),
                    "total_s": rec.get("total_s"),
                    "timeline": timeline,
                    # where the violating request's wall time WENT —
                    # the /slo display answers "which bucket" without
                    # a trip to /tailz
                    "attr": attribute_timeline(timeline)
                    if timeline is not None else None,
                })
        if observe.is_enabled():
            m = _metrics()
            for obj in violated:
                assert obj in SLO_OBJECTIVES
                m["violations"].inc(objective=obj)
            if timeline is not None:
                for phase, dur in phase_durations(timeline):
                    if phase in REQUEST_PHASES:
                        m["phase"].observe(dur, phase=phase)
        self.maybe_evaluate()

    # -- evaluation ----------------------------------------------------------
    def maybe_evaluate(self):
        now = self.clock()
        with self._lock:
            # claim the evaluation slot UNDER the lock: the engine
            # listener, diag handlers and the fleet writer all arrive
            # here concurrently, and an unlocked check-then-act would
            # let two of them evaluate inside one interval — double-
            # advancing the sustain counter on poll timing, which the
            # state machine's contract forbids
            if now - self._last_eval < self.config.eval_interval_s:
                return
            self._last_eval = now
        self.evaluate(now=now)

    def evaluate(self, now=None) -> dict:
        """One evaluation pass: window attainment, fast/slow burn per
        objective, sustained-breach bookkeeping (feeding
        `HealthMonitor.note_external(KIND_SLO)` once per episode), and
        the singa_slo_* gauge exports. Returns the verdict dict. The
        breach state machine advances UNDER the tracker lock — this is
        reachable concurrently from the engine's terminal-request
        listener, diag handler threads and the fleet shard writer, and
        a lost sustain increment (or a doubled episode fire) must not
        depend on poll timing. objective_good runs ONCE per (record,
        objective); the three windows tally from the same pass."""
        cfg = self.config
        now = self.clock() if now is None else now
        objectives = {}
        fired = []
        with self._lock:
            records = list(self._records)
            ages = [now - r["ts"] for r in records]
            n_window = sum(1 for a in ages if a <= cfg.window_s)
            for obj in cfg.enabled():
                target = cfg.target_fraction(obj)
                gw = tw = gf = tf = gs = ts_ = 0
                for r, age in zip(records, ages):
                    if age > cfg.window_s \
                            and age > cfg.fast_window_s \
                            and age > cfg.slow_window_s:
                        continue
                    g = objective_good(obj, r, cfg)
                    if g is None:
                        continue
                    if age <= cfg.window_s:
                        tw += 1
                        gw += g
                    if age <= cfg.fast_window_s:
                        tf += 1
                        gf += g
                    if age <= cfg.slow_window_s:
                        ts_ += 1
                        gs += g
                att_w = (gw / tw) if tw else None
                fast = burn_rate((gf / tf) if tf else None, target)
                slow = burn_rate((gs / ts_) if ts_ else None, target)
                burning = (
                    fast is not None and slow is not None
                    and fast > cfg.burn_threshold
                    and slow > cfg.burn_threshold
                    and ts_ >= cfg.min_requests)
                self._over[obj] = self._over.get(obj, 0) + 1 \
                    if burning else 0
                breach = False
                if self._over[obj] >= cfg.sustain:
                    breach = True
                    if obj not in self._breached:
                        self._breached.add(obj)
                        fired.append((obj, fast, slow, att_w))
                elif not burning:
                    self._breached.discard(obj)  # episode over: re-arm
                objectives[obj] = {
                    "target": cfg._target_value(obj),
                    "target_fraction": target,
                    "attainment": att_w,
                    "good": gw,
                    "total": tw,
                    "burn_fast": fast,
                    "burn_slow": slow,
                    "burning": burning,
                    "breach": breach,
                }
            self._evals += 1
            self._last_eval = now
            verdict = {
                "ts": round(now, 6),
                "window_requests": n_window,
                "objectives": objectives,
                "breaching": sorted(self._breached),
                "evaluations": self._evals,
            }
            self._last_verdict = verdict
        if observe.is_enabled():
            m = _metrics()
            m["evals"].inc()
            m["window_requests"].set(float(n_window))
            for obj in SLO_OBJECTIVES:
                o = objectives.get(obj)
                if o is None:
                    continue
                if o["attainment"] is not None:
                    m["attainment"].set(100.0 * o["attainment"],
                                        objective=obj)
                if o["burn_fast"] is not None:
                    m["burn_fast"].set(o["burn_fast"], objective=obj)
                if o["burn_slow"] is not None:
                    m["burn_slow"].set(o["burn_slow"], objective=obj)
                    m["budget"].set(1.0 - o["burn_slow"],
                                    objective=obj)
        self._fire(fired)
        return verdict

    def _resolved_policy(self) -> str:
        if self.policy is not None:
            return self.policy
        mon = self._health.active_monitor()
        if mon is not None and mon.policy == "halt":
            return "halt"
        return "warn"

    def _fire(self, fired):
        """New sustained-breach verdicts: counted, event-logged, fed to
        the active HealthMonitor with the RESOLVED action (the tracker's
        policy may override the monitor's — /healthz must not disagree
        with /slo about whether a halt happened)."""
        if not fired:
            return
        policy = self._resolved_policy()
        mon = self._health.active_monitor()
        for obj, fast, slow, att in fired:
            assert obj in SLO_OBJECTIVES
            detail = {"objective": obj,
                      "burn_fast": round(fast, 3)
                      if fast is not None else None,
                      "burn_slow": round(slow, 3)
                      if slow is not None else None,
                      "attainment": round(att, 4)
                      if att is not None else None}
            if observe.is_enabled():
                # metric/event plumbing honors the master switch like
                # every other record site; the monitor note below does
                # NOT — the breach verdict is health state, not
                # telemetry
                _metrics()["breaches"].inc(objective=obj)
                observe.get_registry().emit(
                    {"kind": "slo", "event": "burn_breach", **detail,
                     "policy": policy})
            if mon is not None:
                try:
                    mon.note_external(
                        self._health.KIND_SLO, detail=detail,
                        action="halt" if policy == "halt" else "warn")
                except Exception:
                    pass  # the monitor must not break the tracker

    # -- reading -------------------------------------------------------------
    def last_verdict(self) -> "dict | None":
        return self._last_verdict

    def current_verdict(self) -> dict:
        """The read-only surfaces' verdict (/slo, /statusz, fleet
        shard publishes): evaluates only when the eval cadence allows,
        so poll frequency cannot advance the 'sustain consecutive
        evaluations' breach state machine faster than the configured
        interval — a scrape must observe, not convict."""
        self.maybe_evaluate()
        v = self._last_verdict
        return v if v is not None else self.evaluate()

    def breaching(self) -> list:
        with self._lock:
            return sorted(self._breached)

    def violations(self) -> list:
        """Locked copy of the recent violating requests (newest last),
        each with the objectives it violated and — when it came off an
        engine — its full timeline."""
        with self._lock:
            return list(self._violations)

    def window_records(self, now=None, window_s=None) -> list:
        cfg = self.config
        now = self.clock() if now is None else now
        w = cfg.window_s if window_s is None else window_s
        with self._lock:
            return [dict(r) for r in self._records
                    if now - r["ts"] <= w]

    # -- lifecycle -----------------------------------------------------------
    def install(self) -> "SLOTracker":
        """Register module-wide and subscribe to the engine's terminal
        stream. A second install replaces the previous tracker (its
        listener detached)."""
        return install(self)

    def uninstall(self):
        if get_tracker() is self:
            uninstall()


# ---- module singleton (the conftest teardown contract) ---------------------

_tracker: "SLOTracker | None" = None
_lock = threading.Lock()


def install(tracker: "SLOTracker") -> "SLOTracker":
    """Install `tracker` as the process SLO tracker: /slo, the fleet
    shard writer and the serving wiring all answer from it. Replaces
    (and detaches) any previous tracker."""
    global _tracker
    from . import engine
    with _lock:
        old = _tracker
        if old is not None:
            engine.remove_request_listener(old._on_request)
        _tracker = tracker
        engine.add_request_listener(tracker._on_request)
    return tracker


def uninstall():
    """Remove the installed tracker and detach its engine listener."""
    global _tracker
    from . import engine
    with _lock:
        t = _tracker
        _tracker = None
        if t is not None:
            engine.remove_request_listener(t._on_request)


def get_tracker() -> "SLOTracker | None":
    return _tracker


def reset():
    """Full teardown (the conftest contract): the tracker uninstalled
    and its engine request listener detached — no evaluation state,
    listeners or records leak between tests. The tail-attribution
    collector and its store reset on the same contract."""
    uninstall()
    tail_reset()


def note_decode(kind: str, seconds: float, new_tokens: int,
                ttft: "float | None" = None, batch: int = 1):
    """serving.py wiring: one STATIC-batch decode call fed to the
    installed tracker, so a deployment still on the dense path gets
    /slo attainment (latency + tokens/sec; TTFT when the greedy path
    fenced one) without the engine. The call carries `batch` requests:
    each is recorded as its OWN sample with its PER-REQUEST rate
    (new_tokens/batch over the call wall) — min_tokens_per_sec is a
    per-request floor everywhere else, and a batch must not weigh as
    one request against the engine's per-request stream. No-op without
    a tracker."""
    t = get_tracker()
    if t is None:
        return
    batch = max(1, int(batch))
    rec = {
        "ts": t.clock(), "id": None, "outcome": "completed",
        "kind": kind, "ttft_s": ttft, "total_s": float(seconds),
        "tokens_per_sec": (new_tokens / batch / seconds)
        if seconds > 0 else None,
    }
    # the static path has no phase-stamped timeline, but the call wall
    # still decomposes: the fenced TTFT is the prefill share, the rest
    # is decode — so a dense deployment's /tailz is populated too
    attr = None
    if seconds > 0:
        if ttft is not None and 0.0 < float(ttft) <= float(seconds):
            attr = {ATTR_PREFILL: float(ttft),
                    ATTR_DECODE: float(seconds) - float(ttft)}
        else:
            attr = {ATTR_DECODE: float(seconds)}
    for _ in range(batch):
        t.note_record(dict(rec))
        if attr is not None:
            note_attribution({"id": None, "outcome": "completed",
                              "trace": None,
                              "total_s": float(seconds),
                              "attr": dict(attr)})


# ---- per-phase durations ---------------------------------------------------

def phase_durations(timeline: dict):
    """[(phase, seconds)] from one timeline's phase-stamped events:
    each interval between consecutive events is attributed to the
    EARLIER event's phase (repeated per-sync `decode` marks all book
    under decode). The terminal event closes the last interval and has
    no duration of its own."""
    events = timeline.get("events") or []
    out = []
    for (phase, t, _info), (_p2, t2, _i2) in zip(events, events[1:]):
        out.append((phase, max(0.0, float(t2) - float(t))))
    return out


# ---- tail-latency attribution ----------------------------------------------
# Pure math over the phase-stamped timelines: every terminal request's
# wall time decomposes into the closed LATENCY_ATTR buckets, and the
# buckets MUST sum to the request's total latency — the same wall-sum
# discipline as the goodput buckets, test-enforced. Two decomposers:
# one for an ENGINE timeline (inside a replica), one for a ROUTER
# request (across dispatch/failover hops, adopting the winning
# replica's engine-side buckets for the final hop).

def attribute_timeline(timeline: dict) -> dict:
    """{bucket: seconds} for one engine timeline, summing exactly to
    last-event - first-event. submit/queue intervals book as
    `replica_queue`, admit/prefill as `prefill`; the inter-sync decode
    gaps split into steady `decode` plus `decode_stall` — any gap's
    excess beyond 2x the median gap (an injected delay, a preempting
    tenant, a straggling sync) with >= 3 gaps to estimate the median
    from. Anything unclassifiable books as `other`. Empty dict for a
    timeline with fewer than two events (nothing to attribute)."""
    events = timeline.get("events") or []
    out = {}
    gaps = []
    for (phase, t, _i), (_p2, t2, _i2) in zip(events, events[1:]):
        d = max(0.0, float(t2) - float(t))
        if phase in (PHASE_SUBMIT, PHASE_QUEUE):
            k = ATTR_REPLICA_QUEUE
        elif phase in (PHASE_ADMIT, PHASE_PREFILL):
            k = ATTR_PREFILL
        elif phase in (PHASE_FIRST_TOKEN, PHASE_DECODE):
            gaps.append(d)
            continue
        else:
            k = ATTR_OTHER
        out[k] = out.get(k, 0.0) + d
    if gaps:
        total = sum(gaps)
        stall = 0.0
        if len(gaps) >= 3:
            med = sorted(gaps)[len(gaps) // 2]
            stall = min(sum(max(0.0, g - 2.0 * med) for g in gaps),
                        total)
        out[ATTR_DECODE] = total - stall
        if stall > 0.0:
            out[ATTR_DECODE_STALL] = stall
    return {k: round(v, 7) for k, v in out.items()}


def attribute_route(submitted, finished, events,
                    replica_attr: "dict | None" = None) -> dict:
    """{bucket: seconds} for one ROUTER request's wall time (submit ->
    terminal), from its mark() events, summing exactly to finished -
    submitted. `router_queue` runs up to the first dispatch; each hop
    that failed over books its dead-replica probe under `probe` and
    the rest under `failover_replay` (the replica had ACCEPTED the
    work — the retry replays tokens already generated) or
    `dispatch_retry` (it never started; includes the backoff); the
    final hop adopts the winning replica's own engine-side buckets
    (`replica_attr`) clipped to the hop wall, any remainder —
    transport, HTTP framing, poll granularity — under `other`."""
    out = {}
    dispatches = [(float(t), i or {}) for (n, t, i) in events or ()
                  if n == "dispatch"]
    failovers = [(float(t), i or {}) for (n, t, i) in events or ()
                 if n == "failover"]

    def add(k, v):
        if v > 0.0:
            out[k] = out.get(k, 0.0) + v

    if not dispatches:
        # never dispatched: shed / drained / queue-expired in the
        # router — the whole wall is router queue time
        add(ATTR_ROUTER_QUEUE,
            max(0.0, float(finished) - float(submitted)))
        return {k: round(v, 7) for k, v in out.items()}
    add(ATTR_ROUTER_QUEUE,
        max(0.0, dispatches[0][0] - float(submitted)))
    for k, (t, _info) in enumerate(dispatches):
        end = dispatches[k + 1][0] if k + 1 < len(dispatches) \
            else float(finished)
        wall = max(0.0, end - t)
        if k < len(failovers):
            f_info = failovers[k][1]
            probe = min(max(0.0, float(f_info.get("probe_s") or 0.0)),
                        wall)
            add(ATTR_PROBE, probe)
            add(ATTR_FAILOVER_REPLAY if f_info.get("pending")
                else ATTR_DISPATCH_RETRY, wall - probe)
        elif replica_attr:
            known = 0.0
            for rk in LATENCY_ATTR:
                rv = min(max(0.0, float(replica_attr.get(rk) or 0.0)),
                         wall - known)
                add(rk, rv)
                known += rv
            add(ATTR_OTHER, wall - known)
        else:
            add(ATTR_OTHER, wall)
    return {k: round(v, 7) for k, v in out.items()}


# -- the tail store (what /tailz aggregates) ---------------------------------

_tail_lock = threading.Lock()
_tail: "deque[dict]" = deque(maxlen=4096)
_tail_collector: "TailCollector | None" = None


def note_attribution(rec: dict):
    """Feed one terminal request's decomposition into the tail store
    ({"id", "outcome", "trace", "total_s", "attr"}) and the
    singa_tail_seconds_total counter. Buckets outside the enum fold
    into `other` — the counter's label set must stay closed."""
    attr = {}
    for k, v in (rec.get("attr") or {}).items():
        k = k if k in LATENCY_ATTR else ATTR_OTHER
        attr[k] = attr.get(k, 0.0) + float(v)
    rec = dict(rec)
    rec["attr"] = attr
    with _tail_lock:
        _tail.append(rec)
    if observe.is_enabled():
        m = _metrics()
        for k, v in attr.items():
            assert k in LATENCY_ATTR, k
            if v > 0.0:
                m["tail"].inc(float(v), attr=k)


def tail_records() -> list:
    """Locked copy of the attributed-request records (newest last)."""
    with _tail_lock:
        return [dict(r) for r in _tail]


def tail_summary() -> dict:
    """The aggregate /tailz view: request count, total-latency
    percentiles, and per-bucket totals with each bucket's p99
    CONTRIBUTION — the p99 of that bucket's per-request seconds
    (zeros included, so a bucket touching one request in a thousand
    ranks by what it does to the fleet tail, not to its own). `top`
    names the bucket with the largest p99 contribution: the one-word
    answer to "where did the tail go"."""
    from . import engine as engine_mod
    recs = tail_records()
    totals = [float(r.get("total_s") or 0.0) for r in recs]
    wall = sum(totals)
    buckets = {}
    for k in LATENCY_ATTR:
        vals = [float((r.get("attr") or {}).get(k) or 0.0)
                for r in recs]
        nz = [v for v in vals if v > 0.0]
        if not nz:
            continue
        buckets[k] = {
            "sum_s": round(sum(nz), 6),
            "share": round(sum(nz) / wall, 4) if wall > 0 else None,
            "p99_s": engine_mod.pctile(vals, 0.99),
            "requests": len(nz),
        }
    top = max(buckets, key=lambda k: buckets[k]["p99_s"] or 0.0) \
        if buckets else None
    return {"requests": len(recs),
            "total_p50_s": engine_mod.pctile(totals, 0.5),
            "total_p99_s": engine_mod.pctile(totals, 0.99),
            "buckets": buckets,
            "top": top}


def tail_report() -> str:
    """The /tailz text block: per-bucket p99 contribution ranking."""
    lines = ["== tailz =="]
    s = tail_summary()
    if not s["requests"]:
        lines.append("no attributed requests yet (terminal requests "
                     "decompose into LATENCY_ATTR buckets here)")
        return "\n".join(lines)
    lines.append(
        f"requests: {s['requests']}   "
        f"total p50 {s['total_p50_s']:.4f}s "
        f"p99 {s['total_p99_s']:.4f}s   "
        f"top p99 contributor: {s['top']}")
    ranked = sorted(s["buckets"].items(),
                    key=lambda kv: kv[1]["p99_s"] or 0.0, reverse=True)
    for k, b in ranked:
        share = f"{100.0 * b['share']:.1f}%" \
            if b["share"] is not None else "-"
        lines.append(
            f"  {k:<16} p99 {b['p99_s']:.4f}s  sum {b['sum_s']:.3f}s "
            f"({share} of wall)  {b['requests']} req")
    return "\n".join(lines)


def tail_json() -> dict:
    """The /tailz?json=1 body: summary + a bounded record tail."""
    s = tail_summary()
    return {"installed": s["requests"] > 0 or get_tail() is not None,
            "summary": s, "records": tail_records()[-64:]}


class TailCollector:
    """Engine request listener feeding the tail store: every terminal
    request's timeline decomposes through `attribute_timeline`.
    Installed NEXT TO (not instead of) the SLOTracker — one listener
    judges objectives, the other attributes the wall time."""

    def _on_request(self, req, timeline):
        attr = attribute_timeline(timeline)
        if not attr:
            return
        total = timeline.get("total_s")
        note_attribution({
            "id": timeline.get("id"),
            "outcome": timeline.get("outcome"),
            "trace": timeline.get("trace"),
            "total_s": total if total is not None
            else round(sum(attr.values()), 7),
            "attr": attr,
        })


def install_tail(collector: "TailCollector | None" = None) \
        -> "TailCollector":
    """Install (or replace) the process tail collector and subscribe
    it to the engine's terminal-request stream."""
    global _tail_collector
    from . import engine
    c = collector or TailCollector()
    with _lock:
        old = _tail_collector
        if old is not None:
            engine.remove_request_listener(old._on_request)
        _tail_collector = c
        engine.add_request_listener(c._on_request)
    return c


def get_tail() -> "TailCollector | None":
    return _tail_collector


def tail_reset():
    """Detach the tail collector's engine listener and clear the
    store (the conftest teardown contract, like the tracker's)."""
    global _tail_collector
    from . import engine
    with _lock:
        c = _tail_collector
        _tail_collector = None
        if c is not None:
            engine.remove_request_listener(c._on_request)
    with _tail_lock:
        _tail.clear()


# ---- trace export ----------------------------------------------------------

#: synthetic track (tid) layout for request slices — far above real OS
#: thread idents stay impossible, so the request tracks are simply
#: distinct, stable and sorted together in Perfetto
QUEUE_TID = 900_000
SLOT_TID_BASE = 900_100

_FLOW_CAT = "req_flow"
#: the CROSS-PROCESS flow category: one flow per router-minted trace
#: id, stepping router queue -> each dispatch hop -> every replica the
#: request touched. Unlike `req_flow` (pid-scoped by construction),
#: linking ACROSS pids is the point — the id is the fleet-unique trace
#: string itself.
TRACE_CTX_CAT = "trace_ctx"


def request_trace_events(timelines, syncs, pid, offset=0.0,
                         emit_sync_slices=True) -> list:
    """Trace Event Format slices for finished request timelines plus
    the engine decode-step slices they rode, with flow events linking
    each request's decode span to those slices. `offset` maps the
    perf_counter stamps onto a shared wall clock (a fleet worker's
    clock-handshake offset; 0.0 for a local export).

    Tracks: one "serve queue" track (queued spans), one "serve slot N"
    track per decode slot (prefill + decode spans), and the
    `serving.engine_step` slices on the decode thread's own tid — the
    same tid the observe span ring publishes. Pass
    `emit_sync_slices=False` when the caller's trace already carries
    the engine_step slices from the span ring (the fleet merge does):
    the sync intervals COVER the span slices on the same tid, so the
    flow events bind inside the real ones and a duplicate overlay
    would only clutter the track."""
    def us(t):
        return round((float(t) + offset) * 1e6, 3)

    events = []
    sync_by_id = {}
    for s in syncs or ():
        sync_by_id[s["sync"]] = s
        if not emit_sync_slices:
            continue
        events.append({
            "name": "serving.engine_step", "cat": "serve", "ph": "X",
            "ts": us(s["t0"]), "dur": round(float(s["dur"]) * 1e6, 3),
            "pid": pid, "tid": int(s.get("tid") or 0),
            "args": {"sync": s["sync"], "slots": s.get("slots"),
                     "steps": s.get("steps"),
                     "tokens": s.get("tokens")},
        })
    for tl in timelines or ():
        rid = tl.get("id")
        evs = tl.get("events") or []
        stamps = {}
        for phase, t, _info in evs:
            stamps.setdefault(phase, float(t))
        t_submit = stamps.get(PHASE_SUBMIT) or stamps.get(PHASE_QUEUE)
        if t_submit is None:
            continue
        t_end = stamps.get(PHASE_TERMINAL)
        in_flight = t_end is None
        if in_flight:
            # an IN-FLIGHT timeline (the replica died mid-request, or
            # the snapshot raced the decode loop): render what exists,
            # up to the last stamp — the victim's partial work is
            # exactly what the merged failover trace must show
            t_end = float(evs[-1][1])
        t_admit = stamps.get(PHASE_ADMIT)
        t_first = stamps.get(PHASE_FIRST_TOKEN)
        args = {"id": rid, "outcome": tl.get("outcome"),
                "prompt_tokens": tl.get("prompt_tokens"),
                "new_tokens": tl.get("new_tokens")}
        q_end = t_admit if t_admit is not None else t_end
        events.append({
            "name": f"req {rid} queued", "cat": "request", "ph": "X",
            "ts": us(t_submit),
            "dur": round(max(0.0, q_end - t_submit) * 1e6, 3),
            "pid": pid, "tid": QUEUE_TID, "args": args,
        })
        trace = tl.get("trace")
        if trace:
            # cross-process flow STEP on this replica: bound inside the
            # request's first slice here (prefill when it reached a
            # slot, else the queued span) — the router's track holds
            # the flow's s/f ends
            bind_t0 = t_admit if t_admit is not None else t_submit
            bind_t1 = ((t_first if t_first is not None else t_end)
                       if t_admit is not None else q_end)
            events.append({
                "ph": "t", "cat": TRACE_CTX_CAT, "name": "trace",
                "id": str(trace),
                "ts": us(bind_t0 + max(0.0, bind_t1 - bind_t0) / 2.0),
                "pid": pid,
                "tid": (SLOT_TID_BASE + int(tl.get("slot") or 0))
                if t_admit is not None else QUEUE_TID,
            })
        if t_admit is None:
            continue  # never reached a slot (rejected / queue timeout)
        slot_tid = SLOT_TID_BASE + int(tl.get("slot") or 0)
        pf_end = t_first if t_first is not None else t_end
        events.append({
            "name": f"req {rid} prefill", "cat": "request", "ph": "X",
            "ts": us(t_admit),
            "dur": round(max(0.0, pf_end - t_admit) * 1e6, 3),
            "pid": pid, "tid": slot_tid, "args": args,
        })
        if t_first is None:
            continue
        events.append({
            "name": f"req {rid} decode", "cat": "request", "ph": "X",
            "ts": us(t_first),
            "dur": round(max(0.0, t_end - t_first) * 1e6, 3),
            "pid": pid, "tid": slot_tid, "args": args,
        })
        rode = [sync_by_id[s] for s in tl.get("syncs") or ()
                if s in sync_by_id]
        if not rode:
            continue
        # the flow: starts inside the request's decode span, steps
        # through every decode-step slice the request rode, finishes
        # in the last one — each ts lands MID-slice so the event binds
        # to the enclosing slice on (pid, tid). Flow events bind
        # globally by (cat, id), so the id carries the pid: two fleet
        # workers both serving a "request 3" must not cross-link.
        flow_id = flow_event_id(pid, rid)
        events.append({
            "ph": "s", "cat": _FLOW_CAT, "name": "req",
            "id": flow_id, "ts": us(t_first + 1e-6),
            "pid": pid, "tid": slot_tid,
        })
        for j, s in enumerate(rode):
            events.append({
                "ph": "f" if j == len(rode) - 1 else "t",
                "cat": _FLOW_CAT, "name": "req", "id": flow_id,
                "ts": us(float(s["t0"]) + float(s["dur"]) / 2.0),
                "pid": pid, "tid": int(s.get("tid") or 0),
                **({"bp": "e"} if j == len(rode) - 1 else {}),
            })
    return events


def flow_event_id(pid, rid) -> str:
    """The flow id for one request's trace arrows: pid-scoped, because
    Trace Event flow events join on (cat, id) ACROSS processes and
    per-process request ids collide in a merged fleet trace."""
    return f"{int(pid)}:{int(rid)}"


def _track_metadata(timelines, syncs, pid, label=None) -> list:
    """Track-naming metadata for one worker's request/sync events.
    `label` names the process track (omit when the caller — the fleet
    trace merge — already emitted its own process_name)."""
    events = []
    if label is not None:
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": label}})
    if timelines:
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": QUEUE_TID,
                       "args": {"name": "serve queue"}})
    slots = sorted({int(tl.get("slot") or 0) for tl in timelines or ()
                    if tl.get("slot") is not None})
    for s in slots:
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": SLOT_TID_BASE + s,
                       "args": {"name": f"serve slot {s}"}})
    for tid in sorted({int(s.get("tid") or 0) for s in syncs or ()}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": "decode steps"}})
    return events


def engine_trace_events(eng=None) -> dict:
    """The local (single-process) request trace: every live engine's
    timeline ring + sync ring as one Trace Event JSON object. For the
    multi-replica view use `fleet.export_trace` — the shards carry the
    same timelines and the aggregator merges them with this module's
    builder, clock-aligned."""
    from . import engine as engine_mod
    engines = [eng] if eng is not None else engine_mod.get_engines()
    pid = os.getpid()
    events = []
    for i, e in enumerate(engines):
        timelines = e.timelines()
        syncs = e.sync_records()
        events.extend(_track_metadata(
            timelines, syncs, pid,
            f"serving engine {i} (pid {pid})"))
        events.extend(request_trace_events(timelines, syncs, pid))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_trace(path: str, eng=None) -> str:
    """Write the local request trace JSON to `path` (open in Perfetto /
    chrome://tracing) and return the path."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(engine_trace_events(eng), f, separators=(",", ":"))
    return path


# ---- the fleet serving view ------------------------------------------------

#: per-shard cap on timelines/syncs riding a fleet publish — the shard
#: is rewritten whole every interval, so the serve line must stay small
_SHARD_TIMELINES = 64
_SHARD_SYNCS = 128


def fleet_serve_snapshot(max_timelines: int = _SHARD_TIMELINES,
                         max_syncs: int = _SHARD_SYNCS) -> "dict | None":
    """The `fleet_serve` shard line: this replica's live serving state
    (engine occupancy/queue/pages/RPS/TTFT percentiles, kv-cache bytes
    as the engines' page-pool bytes, SLO attainment + burn) plus the recent
    request timelines and decode-step records the merged trace needs.
    None when no engine is running and no tracker is installed."""
    from . import engine as engine_mod
    engines = engine_mod.get_engines()
    tracker = get_tracker()
    if not engines and tracker is None:
        return None
    rps = 0.0
    queue_depth = occupancy = slots = 0
    pages_in_use = pages_total = 0
    pool_bytes = 0
    tok_s_parts = []
    ttfts = []
    finished = {}
    timelines = []
    active = []
    syncs = []
    for e in engines:
        r = e.report()
        rps += r.get("rps") or 0.0
        queue_depth += r["queue_depth"]
        occupancy += r["active"]
        slots += r["slots"]
        pages_in_use += r["pages_in_use"]
        pages_total += r["pages_total"]
        pool_bytes += r["pool_bytes"]
        for o, n in (r.get("finished") or {}).items():
            finished[o] = finished.get(o, 0) + n
        if r.get("decode_tok_s") is not None:
            tok_s_parts.append(r["decode_tok_s"])
        ttfts.extend(e.recent_ttfts())
        timelines.extend(e.timelines()[-max_timelines:])
        # IN-FLIGHT request timelines ride the shard too: when a
        # replica dies mid-request, its last published shard is the
        # only record of the work the victim had done — the merged
        # failover trace renders it as an open-ended track
        act = getattr(e, "active_timelines", None)
        if act is not None:
            active.extend(act()[-max_timelines:])
        syncs.extend(e.sync_records()[-max_syncs:])
    # the memory ledger's kv_cache region (target and draft pools) when
    # one is installed and has a snapshot, else the targets' page pools
    kv_bytes = pool_bytes
    led = memory.get_ledger()
    rb = led.region_bytes() if led is not None else None
    if rb is not None:
        kv_bytes = int(rb["regions"][memory.REGION_KV_CACHE])
    slo_part = None
    if tracker is not None:
        v = tracker.current_verdict()
        slo_part = {
            "objectives": {
                obj: {"attainment": o["attainment"],
                      "burn_fast": o["burn_fast"],
                      "burn_slow": o["burn_slow"],
                      "breach": o["breach"]}
                for obj, o in v["objectives"].items()},
            "breaching": v["breaching"],
            "window_requests": v["window_requests"],
        }
    return {
        "engines": len(engines),
        # graceful drain in flight: the engine has stopped admitting
        # but is finishing its slots — the router/fleet view shows the
        # replica as draining rather than merely quiet
        "draining": any(getattr(e, "_draining", False)
                        for e in engines),
        "rps": round(rps, 3),
        "queue_depth": queue_depth,
        "occupancy": occupancy,
        "slots": slots,
        "pages_in_use": pages_in_use,
        "pages_total": pages_total,
        "page_util": round(pages_in_use / pages_total, 4)
        if pages_total else None,
        "kv_cache_bytes": kv_bytes,
        # measured decode rate, for the capacity model's bandwidth
        # wall (held against the roofline's bytes-per-token floor)
        "decode_tok_s": round(sum(tok_s_parts), 3)
        if tok_s_parts else None,
        "ttft_p50_s": engine_mod.pctile(ttfts, 0.5),
        "ttft_p99_s": engine_mod.pctile(ttfts, 0.99),
        "finished": finished,
        "slo": slo_part,
        "timelines": timelines[-max_timelines:],
        "active": active[-max_timelines:],
        "syncs": syncs[-max_syncs:],
    }


def serve_attainment_pct(serve: "dict | None") -> "float | None":
    """One per-replica SLO number for the fleet table: the WORST
    enabled objective's window attainment, percent. None without a
    tracker (or before any applicable request)."""
    slo_part = (serve or {}).get("slo")
    if not isinstance(slo_part, dict):
        return None
    atts = [o.get("attainment")
            for o in (slo_part.get("objectives") or {}).values()
            if o.get("attainment") is not None]
    return round(100.0 * min(atts), 2) if atts else None


# ---- reports ---------------------------------------------------------------

def _fmt_timeline(tl: dict) -> str:
    """One compact line per timeline: phase deltas from submit, with
    per-sync decode progress folded into a tokens trajectory."""
    events = tl.get("events") or []
    if not events:
        return f"req {tl.get('id')}: (no events)"
    t0 = float(events[0][1])
    parts = []
    decode_marks = 0
    for phase, t, info in events:
        if phase == PHASE_DECODE:
            decode_marks += 1
            continue
        tag = phase
        if phase == PHASE_TERMINAL and info:
            tag = f"{info.get('outcome', phase)}"
        parts.append(f"{tag}+{float(t) - t0:.3f}s")
    mid = f" [{decode_marks} decode syncs, " \
          f"{tl.get('new_tokens')} tok]" if decode_marks else ""
    return (f"req {tl.get('id')} ({tl.get('outcome')}): "
            + " -> ".join(parts) + mid)


def slo_report() -> str:
    """The /slo (and /statusz `== slo ==`) text block: config, per-
    objective attainment + burn, breach state, and the recent
    violating request ids with their timelines."""
    lines = ["== slo =="]
    tracker = get_tracker()
    if tracker is None:
        lines.append("no SLOTracker installed "
                     "(singa_tpu_torch.slo.SLOTracker(SLOConfig(...))"
                     ".install())")
        return "\n".join(lines)
    cfg = tracker.config
    v = tracker.current_verdict()
    lines.append(
        f"objectives: {', '.join(cfg.enabled()) or 'none declared'}   "
        f"window {cfg.window_s:g}s   burn windows "
        f"{cfg.fast_window_s:g}s/{cfg.slow_window_s:g}s   "
        f"threshold {cfg.burn_threshold:g}x   "
        f"sustain {cfg.sustain}")
    lines.append(f"window requests: {v['window_requests']}   "
                 f"evaluations: {v['evaluations']}   breaching: "
                 f"{', '.join(v['breaching']) or 'none'}")
    for obj, o in v["objectives"].items():
        att = f"{100.0 * o['attainment']:.2f}%" \
            if o["attainment"] is not None else "no data"
        bf = f"{o['burn_fast']:.2f}x" \
            if o["burn_fast"] is not None else "-"
        bs = f"{o['burn_slow']:.2f}x" \
            if o["burn_slow"] is not None else "-"
        state = "BREACH" if o["breach"] else (
            "burning" if o["burning"] else "ok")
        lines.append(
            f"  {obj:<16} target {o['target']:g} "
            f"(frac {o['target_fraction']:g})  attainment {att} "
            f"({o['good']}/{o['total']})  burn {bf}/{bs}  {state}")
    viol = tracker.violations()
    if viol:
        lines.append(f"recent violations ({len(viol)}):")
        for rec in viol[-8:]:
            objs = ",".join(rec["objectives"])
            lines.append(f"  req {rec['id']} [{objs}] "
                         f"ttft={rec['ttft_s']} total={rec['total_s']}")
            tl = rec.get("timeline")
            if tl:
                lines.append("    " + _fmt_timeline(tl))
            attr = rec.get("attr")
            if attr:
                ranked = sorted(attr.items(), key=lambda kv: -kv[1])
                lines.append("    attr: " + " ".join(
                    f"{k}={v:.4f}s" for k, v in ranked))
    else:
        lines.append("recent violations: none")
    return "\n".join(lines)


def slo_json() -> dict:
    """The /slo?json=1 body: config + fresh verdict + violations (with
    timelines)."""
    tracker = get_tracker()
    if tracker is None:
        return {"installed": False}
    return {
        "installed": True,
        "config": tracker.config.snapshot(),
        "verdict": tracker.current_verdict(),
        "violations": tracker.violations(),
    }


def _check_flow_trace(trace: dict, eng) -> dict:
    """Schema + flow-link validation of a merged trace: X slices carry
    ts/dur/tid, and a chosen request's flow events (s -> t* -> f) land
    inside decode-step slices on the same pid."""
    events = trace.get("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X"]
    schema_ok = (isinstance(events, list) and bool(events)
                 and all(isinstance(e.get("name"), str)
                         and "ph" in e and "pid" in e for e in events)
                 and all("ts" in e and "dur" in e and "tid" in e
                         for e in xs))
    # a request that rode at least one decode sync
    chosen = next((tl for tl in eng.timelines()
                   if tl.get("syncs") and tl.get("outcome")
                   == "completed"), None)
    flow_ok = False
    flow_id = None
    if chosen is not None:
        flow_id = flow_event_id(os.getpid(), chosen["id"])
        flows = [e for e in events if e.get("cat") == _FLOW_CAT
                 and e.get("id") == flow_id]
        steps = [e for e in flows if e.get("ph") in ("t", "f")]
        step_slices = [e for e in xs
                       if e.get("name") == "serving.engine_step"]

        def inside(ev):
            return any(s["pid"] == ev["pid"] and s["tid"] == ev["tid"]
                       and s["ts"] <= ev["ts"] <= s["ts"] + s["dur"]
                       for s in step_slices)

        flow_ok = (any(e.get("ph") == "s" for e in flows)
                   and bool(steps) and all(inside(e) for e in steps))
    return {"schema_ok": bool(schema_ok), "events": len(events),
            "flow_request_id": flow_id, "flow_ok": bool(flow_ok)}


__all__ = [
    "REQUEST_PHASES", "SLO_OBJECTIVES", "LATENCY_ATTR",
    "SLOConfig", "SLOTracker", "request_latency_sample",
    "objective_good", "attainment", "burn_rate", "phase_durations",
    "attribute_timeline", "attribute_route", "note_attribution",
    "tail_records", "tail_summary", "tail_report", "tail_json",
    "TailCollector", "install_tail", "get_tail", "tail_reset",
    "install", "uninstall", "get_tracker", "reset", "note_decode",
    "request_trace_events", "engine_trace_events", "export_trace",
    "flow_event_id",
    "fleet_serve_snapshot", "serve_attainment_pct",
    "slo_report", "slo_json",
]
