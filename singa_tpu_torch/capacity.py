"""Capacity observatory and shadow autoscaler (counterpart of
singa_tpu/capacity.py).

The measure-first half of an autoscaling loop over the router's replicas,
in three pieces:

  1. `CapacityModel`: per-replica headroom from the serving signals each
     fleet shard's `fleet_serve` line carries (slot occupancy, page-pool
     utilization, queue depth, TTFT p99 against the declared SLO, decode
     tokens/s against a registered bandwidth floor, `note_decode_floor`).
     Each signal is a utilization in [0, 1]; the BINDING WALL is the max,
     named in every report row, and measured RPS extrapolates through it
     into "sustainable RPS", floored at the replica's remembered peak.
  2. `DemandForecaster`: a dual-EWMA (fast/slow) arrival-rate estimate
     over router admissions (synthetic audit traffic excluded), with
     burst detection and a time-to-saturation estimate.
  3. `ShadowScaler`: a polled scale_up/scale_down/hold evaluator over
     headroom, forecast and SLO burn, with reason codes from
     `DECISION_REASONS` and hysteresis (cooldown, direction-change
     damping), recorded to a JSONL ledger and a ring and never actuated.
     Each decision is scored counterfactually once its horizon passes.

Surfaces: `/capacityz` and `== capacity ==` on /statusz (diag), the
`fleet_capacity` shard line and the /fleetz headroom column (fleet),
`singa_capacity_*` gauges and `singa_scaler_decisions_total`.

CLI: `python -m singa_tpu_torch.capacity --ab [--device cpu]` drives a
load-ramp Poisson workload through the real router over in-process
engines on `--device` (the card by default, where the head width dim / 4
must be 64 or 128, the flash kernel's: `--dim 256` or `512`). The shadow
scaler must recommend scale-up within 5 polls of sustained burn on the
ramp leg and scale-down on the cooldown leg, without flapping; the
record goes to CAPACITY_torch.json and the decision ledger to
CAPACITY_torch_ledger.jsonl beside it.

Threads are named `singa-capacity-*`; `reset()` is the teardown contract
(scaler uninstalled, ledger closed, poll thread joined).
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
import time
from collections import deque

from . import observe

#: the capacity walls, in report order — every per-replica utilization
#: the model computes is one of these, and the binding wall (the max)
#: is named in every surface (no opaque saturation score)
CAPACITY_WALLS = ("slots", "pages", "queue", "ttft", "bandwidth")

#: shadow-scaler decisions — the `decision=` label on
#: singa_scaler_decisions_total (lint rule 5)
SCALE_DECISIONS = ("scale_up", "scale_down", "hold")

#: decision reason codes — the `reason=` label on
#: singa_scaler_decisions_total (lint rule 5). scale_up carries
#: burn_sustained / headroom_deficit / burst_arrival; scale_down
#: carries headroom_surplus; hold carries cooldown (inside the
#: post-decision cooldown), damped (direction-change damping
#: suppressed a flip), steady (no signal), or insufficient_data (no
#: workers / no samples yet)
DECISION_REASONS = ("burn_sustained", "headroom_deficit",
                    "burst_arrival", "headroom_surplus", "cooldown",
                    "damped", "steady", "insufficient_data")

#: counterfactual verdicts a scored decision can land on: the decision
#: PREDICTS a burn episode (scale_up) or its absence (hold/scale_down),
#: the horizon decides what actually happened
SHADOW_OUTCOMES = ("tp", "fp", "fn", "tn")


_metrics_cache = None


def _metrics():
    # same memoize-with-revalidation shape as engine._metrics: cheap on
    # the poll path, rebuilt after a conftest registry reset instead of
    # feeding orphaned metric objects
    global _metrics_cache
    c = _metrics_cache
    if c is not None and observe.get_registry().get(
            "singa_capacity_headroom_frac") is c["headroom"]:
        return c
    _metrics_cache = c = {
        "headroom": observe.gauge(
            "singa_capacity_headroom_frac",
            "fleet headroom fraction: 1 - the worst replica's binding-"
            "wall utilization (1 = idle, 0 = saturated)"),
        "sustainable": observe.gauge(
            "singa_capacity_sustainable_rps",
            "estimated sustainable request rate at the current fleet "
            "size (measured RPS extrapolated through the binding "
            "wall, summed over live replicas)"),
        "demand": observe.gauge(
            "singa_capacity_demand_rps",
            "forecast arrival rate (the dual-EWMA fast estimate over "
            "router admissions)"),
        "tts": observe.gauge(
            "singa_capacity_time_to_saturation_s",
            "forecast seconds until demand crosses sustainable "
            "capacity (0 = already saturated; absent when demand is "
            "not growing)"),
        "polls": observe.counter(
            "singa_capacity_polls_total",
            "shadow-scaler evaluation passes"),
        "decisions": observe.counter(
            "singa_scaler_decisions_total",
            "shadow-scaler decisions, by decision and reason code"),
        "direction_changes": observe.counter(
            "singa_scaler_direction_changes_total",
            "emitted scale decisions that reversed the previous "
            "direction (the flap counter hysteresis bounds)"),
        "precision": observe.gauge(
            "singa_capacity_shadow_precision",
            "counterfactually scored decision precision: of the "
            "scale_up calls old enough to judge, the fraction whose "
            "predicted burn episode materialized within the horizon"),
        "recall": observe.gauge(
            "singa_capacity_shadow_recall",
            "counterfactually scored decision recall: of the burn "
            "episodes that materialized within a horizon, the "
            "fraction a scale_up call predicted"),
    }
    return c


# ---- the measured bandwidth floor ------------------------------------------
# A decode benchmark's weight-streaming roofline (per-step device-memory
# traffic over peak bandwidth) registers the implied decode token-rate
# ceiling here, so the capacity model can hold measured decode tokens/s
# against it without re-deriving the model geometry.

_decode_floor_tok_s: "float | None" = None


def note_decode_floor(tokens_per_s) -> None:
    """Register the roofline decode ceiling (tokens/s at the bandwidth
    floor) for the bandwidth wall. Non-positive/None clears it."""
    global _decode_floor_tok_s
    try:
        v = float(tokens_per_s)
    except (TypeError, ValueError):
        v = 0.0
    _decode_floor_tok_s = v if v > 0.0 else None


def get_decode_floor() -> "float | None":
    return _decode_floor_tok_s


# ---- piece 1: the capacity model -------------------------------------------

class CapacityModel:
    """Per-replica headroom from the measured serving signals on one
    fleet-shard `serve` dict (slo.fleet_serve_snapshot's shape). Every
    signal is reduced to a utilization fraction in [0, 1]:

      slots      occupancy / slots
      pages      page_util (the paged-KV pool)
      queue      queue_depth / (queue_factor * slots), capped at 1 —
                 a queue as deep as the slot count is saturation
      ttft       ttft_p99_s / ttft_slo_s (only with a declared TTFT
                 objective: past the target IS the wall)
      bandwidth  decode_tok_s / the roofline ceiling
                 (`note_decode_floor`; absent without one)

    headroom = 1 - max(utils); the argmax is the BINDING WALL, named
    in every report row. sustainable RPS = measured rps / wall
    utilization (linear extrapolation through the wall), FLOORED at
    the remembered per-replica peak — at idle the extrapolation is
    noise, and on the cooldown side of a burst the lifetime TTFT
    percentiles lag the live load, so the model never reports less
    than the rate a replica has already proven sustaining (row
    "source" says measured vs peak)."""

    def __init__(self, *, ttft_slo_s=None, decode_floor_tok_s=None,
                 queue_factor=1.0, min_util=0.05):
        self.ttft_slo_s = ttft_slo_s
        self.decode_floor_tok_s = decode_floor_tok_s
        self.queue_factor = float(queue_factor)
        self.min_util = float(min_util)
        self._peak: "dict[str, float]" = {}

    def _ttft_target(self) -> "float | None":
        if self.ttft_slo_s is not None:
            return float(self.ttft_slo_s)
        from . import slo
        tr = slo.get_tracker()
        t = tr.config.ttft_p99_s if tr is not None else None
        return float(t) if t is not None else None

    def _floor(self) -> "float | None":
        return self.decode_floor_tok_s \
            if self.decode_floor_tok_s is not None else get_decode_floor()

    def assess_replica(self, serve: dict, host: str = "local") -> dict:
        """One replica's headroom row from its `serve` shard dict."""
        utils: "dict[str, float | None]" = {}
        slots = serve.get("slots") or 0
        occ = serve.get("occupancy") or 0
        utils["slots"] = min(1.0, occ / slots) if slots else None
        pu = serve.get("page_util")
        utils["pages"] = min(1.0, float(pu)) if pu is not None else None
        qd = serve.get("queue_depth") or 0
        utils["queue"] = min(
            1.0, qd / max(1.0, self.queue_factor * slots)) \
            if slots else (1.0 if qd else None)
        target = self._ttft_target()
        p99 = serve.get("ttft_p99_s")
        utils["ttft"] = min(1.0, float(p99) / target) \
            if target and p99 is not None else None
        floor = self._floor()
        tok_s = serve.get("decode_tok_s")
        utils["bandwidth"] = min(1.0, float(tok_s) / floor) \
            if floor and tok_s is not None else None
        known = [(w, utils[w]) for w in CAPACITY_WALLS
                 if utils.get(w) is not None]
        wall, wall_util = max(known, key=lambda kv: kv[1]) \
            if known else (None, None)
        headroom = max(0.0, 1.0 - wall_util) \
            if wall_util is not None else None
        rps = float(serve.get("rps") or 0.0)
        sustainable, source = None, None
        if wall_util is not None and wall_util > self.min_util \
                and rps > 0.0:
            sustainable, source = rps / wall_util, "measured"
            prev = self._peak.get(host)
            if prev is None or sustainable > prev:
                self._peak[host] = sustainable
        peak = self._peak.get(host)
        if peak is not None and (sustainable is None
                                 or peak > sustainable):
            # the extrapolation is noise at idle (and pessimistic on
            # the cooldown side of a burst, where lifetime TTFT
            # percentiles lag the live load): never report LESS than
            # the rate this replica has already proven sustaining
            sustainable, source = peak, "peak"
        return {
            "host": host,
            "rps": round(rps, 3),
            "utils": {w: (round(u, 4) if u is not None else None)
                      for w, u in utils.items()},
            "wall": wall,
            "wall_util": round(wall_util, 4)
            if wall_util is not None else None,
            "headroom_frac": round(headroom, 4)
            if headroom is not None else None,
            "sustainable_rps": round(sustainable, 3)
            if sustainable is not None else None,
            "source": source,
        }

    def assess(self, workers: "list[dict]") -> dict:
        """Fleet rollup over worker rows ({"host", "serve", "stale"}):
        per-replica headroom rows, sustainable RPS summed over FRESH
        replicas with an estimate, and the fleet headroom = the worst
        fresh replica's (the binding replica's)."""
        rows = []
        for w in workers or []:
            serve = w.get("serve")
            if not isinstance(serve, dict):
                continue
            row = self.assess_replica(serve,
                                      host=w.get("host") or "local")
            row["stale"] = bool(w.get("stale"))
            rows.append(row)
        fresh = [r for r in rows if not r["stale"]]
        sus = [r["sustainable_rps"] for r in fresh
               if r["sustainable_rps"] is not None]
        heads = [r["headroom_frac"] for r in fresh
                 if r["headroom_frac"] is not None]
        return {
            "replicas": rows,
            "n_replicas": len(fresh),
            "sustainable_rps": round(sum(sus), 3) if sus else None,
            "headroom_frac": round(min(heads), 4) if heads else None,
            "rps": round(sum(r["rps"] for r in fresh), 3),
        }


# ---- piece 2: the demand forecaster ----------------------------------------

class DemandForecaster:
    """Dual-EWMA arrival-rate estimate over router admissions. `update`
    feeds one measured admission-rate sample; the fast and slow
    estimates decay with their own time constants (irregular sample
    spacing handled via alpha = 1 - exp(-dt/tau)). A BURST is the fast
    estimate pulling `burst_ratio`x away from the slow one above a
    floor rate. `time_to_saturation` linearizes the fast-slow gap into
    a growth slope and runs it forward to the capacity line.

    The admission-rate samples come from the router's admit stamps,
    which EXCLUDE synthetic traffic (audit canary probes and shadow
    replays never stamp admit_times — the audit module's exclusion
    contract): the forecast tracks real demand only, so a probe storm
    can never look like a burst or trigger a scale-up."""

    def __init__(self, *, fast_tau_s=2.0, slow_tau_s=10.0,
                 burst_ratio=1.5, min_rate=0.1):
        self.fast_tau_s = float(fast_tau_s)
        self.slow_tau_s = float(slow_tau_s)
        self.burst_ratio = float(burst_ratio)
        self.min_rate = float(min_rate)
        self.fast: "float | None" = None
        self.slow: "float | None" = None
        self._last_t: "float | None" = None
        self.samples = 0

    def update(self, rate: float, now: float) -> None:
        rate = max(0.0, float(rate))
        if self.fast is None or self._last_t is None:
            self.fast = self.slow = rate
        else:
            dt = max(1e-6, now - self._last_t)
            af = 1.0 - math.exp(-dt / self.fast_tau_s)
            a_s = 1.0 - math.exp(-dt / self.slow_tau_s)
            self.fast += af * (rate - self.fast)
            self.slow += a_s * (rate - self.slow)
        self._last_t = now
        self.samples += 1

    def burst(self) -> bool:
        return (self.fast is not None and self.slow is not None
                and self.fast > self.min_rate
                and self.fast > self.burst_ratio
                * max(self.slow, self.min_rate))

    def demand_rps(self) -> "float | None":
        """The forecast the scaler holds against capacity: the FAST
        estimate (responsive; the scaler's hysteresis absorbs its
        jitter)."""
        return self.fast

    def time_to_saturation(self, sustainable_rps) -> "float | None":
        """Seconds until the forecast crosses `sustainable_rps` at the
        current growth slope ((fast - slow) / slow_tau per second): 0
        when already past it, None when capacity is unknown or demand
        is not growing (never, at this trend)."""
        if sustainable_rps is None or self.fast is None \
                or self.slow is None:
            return None
        if self.fast >= float(sustainable_rps):
            return 0.0
        slope = (self.fast - self.slow) / self.slow_tau_s
        if slope <= 0.0:
            return None
        return (float(sustainable_rps) - self.fast) / slope

    def snapshot(self) -> dict:
        return {
            "fast_rps": round(self.fast, 3)
            if self.fast is not None else None,
            "slow_rps": round(self.slow, 3)
            if self.slow is not None else None,
            "burst": self.burst(),
            "samples": self.samples,
        }


# ---- the default signal sample ---------------------------------------------

def default_sample() -> dict:
    """One poll's raw measured signals, from whatever this process has
    installed: worker rows from the fleet aggregator (or a local row from
    the live engines when there is no spool), the router's admitted-RPS
    and shed rate, and the SLO tracker's burn rates (falling back to the
    worst burn any worker shard published)."""
    from . import fleet, slo
    from . import router as router_mod
    workers: "list[dict]" = []
    agg = fleet.get_aggregator()
    if agg is not None:
        agg.poll_if_due()
        for r in agg.rollup()["workers"]:
            workers.append({"host": r["host"], "serve": r.get("serve"),
                            "stale": bool(r.get("stale"))})
    if not workers:
        serve = slo.fleet_serve_snapshot(max_timelines=0, max_syncs=0)
        if serve is not None:
            workers.append({"host": "local", "serve": serve,
                            "stale": False})
    admitted = shed = None
    r = router_mod.get_router()
    if r is not None:
        # short window: the EWMA pair does the smoothing — a long
        # trailing average here would lag the forecast by the window
        # length on both edges of a burst
        admitted = r.admit_rate(2.0)
        shed = r.shed_rate(2.0)
    if admitted is None:
        admitted = sum(float((w.get("serve") or {}).get("rps") or 0.0)
                       for w in workers if not w.get("stale"))
    burn_fast = burn_slow = None
    breaching: "list[str]" = []
    tr = slo.get_tracker()
    if tr is not None:
        v = tr.current_verdict()
        breaching = list(v.get("breaching") or [])
        for o in (v.get("objectives") or {}).values():
            if o.get("burn_fast") is not None:
                burn_fast = max(burn_fast or 0.0, o["burn_fast"])
            if o.get("burn_slow") is not None:
                burn_slow = max(burn_slow or 0.0, o["burn_slow"])
    if burn_fast is None:
        # coordinator without a local tracker: the replicas' own
        # verdicts ride their shards — take the fleet's worst
        for w in workers:
            part = ((w.get("serve") or {}).get("slo") or {})
            for o in (part.get("objectives") or {}).values():
                if o.get("burn_fast") is not None:
                    burn_fast = max(burn_fast or 0.0, o["burn_fast"])
                if o.get("burn_slow") is not None:
                    burn_slow = max(burn_slow or 0.0, o["burn_slow"])
            breaching.extend(part.get("breaching") or [])
    return {"workers": workers, "admitted_rps": admitted,
            "shed_rate": shed, "burn_fast": burn_fast,
            "burn_slow": burn_slow,
            "breaching": sorted(set(breaching))}


# ---- piece 3: the shadow scaler --------------------------------------------

class ShadowScaler:
    """Polled scale_up/scale_down/hold evaluator over the capacity
    model + demand forecast + SLO burn — SHADOW MODE: every decision
    lands in the ring, the JSONL ledger, and the metrics, and nothing
    is ever actuated. The policy, in priority order:

      scale_up    burn_sustained: fast AND slow burn over
                  `burn_threshold` for `burn_sustain` consecutive
                  polls (slo.burn_rate's arithmetic, via the verdict);
                  headroom_deficit: forecast demand over sustainable
                  capacity; burst_arrival: a detected burst whose
                  time-to-saturation is inside the horizon
      scale_down  headroom_surplus: demand under `down_frac` x
                  sustainable for `down_sustain` consecutive polls
                  with burn quiet
      hold        otherwise (reason steady / insufficient_data)

    Hysteresis: after any emitted scale decision the next
    `cooldown_polls` polls emit hold/cooldown; a wanted decision
    OPPOSITE to the last emitted direction is damped for `damp_polls`
    consecutive wanting polls (hold/damped) before it may emit — the
    two together bound direction changes under bursty arrivals.

    Counterfactual scoring: each decision predicts whether a burn
    episode (fast burn over threshold) occurs within `horizon_s`;
    once the horizon passes, the observed burn samples grade it
    tp/fp/fn/tn and a "score" line lands in the ledger, so the ledger
    carries the policy's precision/recall before an actuator
    trusts it."""

    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(self, model: "CapacityModel | None" = None,
                 forecaster: "DemandForecaster | None" = None, *,
                 interval_s=0.5, ledger_path=None,
                 burn_threshold=2.0, burn_sustain=2, up_margin=0.0,
                 down_frac=0.4, down_sustain=3, cooldown_polls=4,
                 damp_polls=2, horizon_s=5.0, ring=256,
                 sample=None, clock=time.monotonic):
        self.model = model or CapacityModel()
        self.forecaster = forecaster or DemandForecaster()
        self.interval_s = float(interval_s)
        self.ledger_path = ledger_path
        self.burn_threshold = float(burn_threshold)
        self.burn_sustain = int(burn_sustain)
        self.up_margin = float(up_margin)
        self.down_frac = float(down_frac)
        self.down_sustain = int(down_sustain)
        self.cooldown_polls = int(cooldown_polls)
        self.damp_polls = int(damp_polls)
        self.horizon_s = float(horizon_s)
        self.sample = sample or default_sample
        self.clock = clock
        self._lock = threading.Lock()
        self._ledger = None
        self._polls = 0
        self._burn_streak = 0
        self._down_streak = 0
        self._damp_streak = 0
        self._last_direction = None       # last EMITTED scale decision
        self._cooldown_left = 0
        self._direction_changes = 0
        self._decisions: "deque[dict]" = deque(maxlen=int(ring))
        self._burn_hist: "deque[tuple]" = deque(maxlen=4096)
        self._scores = {o: 0 for o in SHADOW_OUTCOMES}
        self._last = None                 # last evaluate() output
        self._thread = None
        self._stop_evt = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def install(self, *, poll=None) -> "ShadowScaler":
        """Register as the process scaler (module singleton — /capacityz,
        the fleet shard line and the conftest teardown find it) and
        open the ledger. `poll=True` (default when `interval_s` > 0)
        starts the `singa-capacity-poll-*` evaluation thread; tests
        pass poll=False and drive `evaluate()` on their own cadence."""
        if self.ledger_path is not None and self._ledger is None:
            self._ledger = open(self.ledger_path, "a",
                                encoding="utf-8")
        install(self)
        if poll is None:
            poll = self.interval_s > 0
        if poll and self._thread is None:
            with ShadowScaler._seq_lock:
                ShadowScaler._seq += 1
                n = ShadowScaler._seq
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._poll_loop,
                name=f"singa-capacity-poll-{n}", daemon=True)
            self._thread.start()
        return self

    def _poll_loop(self):
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception:
                pass  # a scraped signal must never kill the observer

    def uninstall(self):
        """Stop the poll thread (joined), close the ledger, drop the
        module registration if it points here. Idempotent."""
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None
        led = self._ledger
        self._ledger = None
        if led is not None:
            try:
                led.close()
            except Exception:
                pass
        global _scaler
        with _registry_lock:
            if _scaler is self:
                _scaler = None

    # -- the ledger --------------------------------------------------------
    def _ledger_write(self, rec: dict):
        led = self._ledger
        if led is None:
            return
        try:
            led.write(json.dumps(rec, sort_keys=True) + "\n")
            led.flush()
        except Exception:
            pass

    # -- the policy --------------------------------------------------------
    def _want(self, assess, demand, tts, burst) -> "tuple[str, str]":
        """The UNDAMPED desire this poll: (decision, reason)."""
        sus = assess.get("sustainable_rps")
        if assess.get("n_replicas", 0) == 0 \
                or self.forecaster.samples == 0:
            return DECISION_HOLD, REASON_INSUFFICIENT_DATA
        if self._burn_streak >= self.burn_sustain:
            return DECISION_UP, REASON_BURN_SUSTAINED
        if sus is not None and demand is not None \
                and demand > sus * (1.0 + self.up_margin):
            return DECISION_UP, REASON_HEADROOM_DEFICIT
        if burst and tts is not None and tts < self.horizon_s:
            return DECISION_UP, REASON_BURST_ARRIVAL
        if self._down_streak >= self.down_sustain:
            return DECISION_DOWN, REASON_HEADROOM_SURPLUS
        return DECISION_HOLD, REASON_STEADY

    def evaluate(self, now=None) -> dict:
        """One shadow poll: sample -> model/forecast -> decide (with
        hysteresis) -> ledger/ring/metrics -> score ripe decisions.
        Returns the decision record. Thread-safe; the poll thread and
        a test driving its own cadence use the same entry point."""
        with self._lock:
            return self._evaluate_locked(
                self.clock() if now is None else float(now))

    def _evaluate_locked(self, now: float) -> dict:
        s = self.sample() or {}
        assess = self.model.assess(s.get("workers") or [])
        if s.get("admitted_rps") is not None:
            self.forecaster.update(float(s["admitted_rps"]), now)
        demand = self.forecaster.demand_rps()
        sus = assess.get("sustainable_rps")
        tts = self.forecaster.time_to_saturation(sus)
        burst = self.forecaster.burst()
        bf, bs = s.get("burn_fast"), s.get("burn_slow")
        self._burn_hist.append((now, bf if bf is not None else 0.0))
        burning = (bf is not None and bf > self.burn_threshold
                   and bs is not None and bs > self.burn_threshold)
        self._burn_streak = self._burn_streak + 1 if burning else 0
        quiet = bf is None or bf <= 1.0
        surplus = (sus is not None and demand is not None and quiet
                   and demand < sus * self.down_frac)
        self._down_streak = self._down_streak + 1 if surplus else 0
        want, reason = self._want(assess, demand, tts, burst)
        decision = want
        if want != DECISION_HOLD:
            if self._cooldown_left > 0:
                decision, reason = DECISION_HOLD, REASON_COOLDOWN
            elif self._last_direction is not None \
                    and want != self._last_direction \
                    and self._damp_streak < self.damp_polls:
                self._damp_streak += 1
                decision, reason = DECISION_HOLD, REASON_DAMPED
        else:
            self._damp_streak = 0
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
        if decision != DECISION_HOLD:
            if self._last_direction is not None \
                    and decision != self._last_direction:
                self._direction_changes += 1
                if observe.is_enabled():
                    _metrics()["direction_changes"].inc()
            self._last_direction = decision
            self._cooldown_left = self.cooldown_polls
            self._damp_streak = 0
        self._polls += 1
        rec = {
            "kind": "decision", "ts": round(now, 4),
            "poll": self._polls, "decision": decision,
            "reason": reason,
            "demand_rps": round(demand, 3)
            if demand is not None else None,
            "sustainable_rps": sus,
            "headroom_frac": assess.get("headroom_frac"),
            "wall": max(
                (r for r in assess["replicas"]
                 if r.get("wall_util") is not None),
                key=lambda r: r["wall_util"], default={}).get("wall"),
            "burn_fast": bf, "burn_slow": bs,
            "burn_streak": self._burn_streak,
            "burst": burst,
            "time_to_saturation_s": round(tts, 3)
            if tts is not None else None,
            "replicas": assess.get("n_replicas"),
            "breaching": s.get("breaching") or [],
            "shed_rate": s.get("shed_rate"),
        }
        self._decisions.append(rec)
        self._ledger_write(rec)
        observe.record_scaler_decision(rec)
        self._last = {"assessment": assess,
                      "forecast": self.forecaster.snapshot(),
                      "decision": rec}
        if observe.is_enabled():
            self._export(rec, assess, demand, tts)
        self._score(now)
        return rec

    def _export(self, rec, assess, demand, tts):
        assert rec["decision"] in SCALE_DECISIONS, rec["decision"]
        assert rec["reason"] in DECISION_REASONS, rec["reason"]
        m = _metrics()
        m["polls"].inc()
        m["decisions"].inc(decision=rec["decision"],
                           reason=rec["reason"])
        if assess.get("headroom_frac") is not None:
            m["headroom"].set(float(assess["headroom_frac"]))
        if assess.get("sustainable_rps") is not None:
            m["sustainable"].set(float(assess["sustainable_rps"]))
        if demand is not None:
            m["demand"].set(float(demand))
        if tts is not None:
            m["tts"].set(float(tts))

    # -- counterfactual scoring --------------------------------------------
    def _score(self, now: float):
        """Grade every decision whose horizon has passed: predicted
        burn (scale_up) vs the burn samples actually observed inside
        (ts, ts + horizon]. Appends a "score" ledger line per graded
        decision and refreshes the precision/recall gauges."""
        changed = False
        for rec in self._decisions:
            if "outcome" in rec \
                    or now - rec["ts"] < self.horizon_s:
                continue
            t0, t1 = rec["ts"], rec["ts"] + self.horizon_s
            seen = [b for t, b in self._burn_hist if t0 < t <= t1]
            actual = bool(seen) and max(seen) > self.burn_threshold
            predicted = rec["decision"] == DECISION_UP
            outcome = ("tp" if actual else "fp") if predicted \
                else ("fn" if actual else "tn")
            assert outcome in SHADOW_OUTCOMES, outcome
            rec["outcome"] = outcome
            rec["actual_burn"] = round(max(seen), 3) if seen else None
            self._scores[outcome] += 1
            self._ledger_write({
                "kind": "score", "poll": rec["poll"],
                "decision": rec["decision"], "outcome": outcome,
                "actual_burn": rec["actual_burn"]})
            changed = True
        if changed and observe.is_enabled():
            acc = self.accuracy()
            m = _metrics()
            if acc["precision"] is not None:
                m["precision"].set(acc["precision"])
            if acc["recall"] is not None:
                m["recall"].set(acc["recall"])

    def accuracy(self) -> dict:
        """The shadow policy's counterfactual scorecard."""
        sc = dict(self._scores)
        scored = sum(sc.values())
        prec = sc["tp"] / (sc["tp"] + sc["fp"]) \
            if sc["tp"] + sc["fp"] else None
        rec = sc["tp"] / (sc["tp"] + sc["fn"]) \
            if sc["tp"] + sc["fn"] else None
        return {"scored": scored, **sc,
                "precision": round(prec, 4)
                if prec is not None else None,
                "recall": round(rec, 4) if rec is not None else None}

    # -- introspection -----------------------------------------------------
    def decisions(self) -> "list[dict]":
        with self._lock:
            return [dict(r) for r in self._decisions]

    def direction_changes(self) -> int:
        return self._direction_changes

    def snapshot(self) -> dict:
        with self._lock:
            last = self._last
            return {
                "polls": self._polls,
                "interval_s": self.interval_s,
                "ledger_path": self.ledger_path,
                "direction_changes": self._direction_changes,
                "cooldown_left": self._cooldown_left,
                "last_direction": self._last_direction,
                "assessment": (last or {}).get("assessment"),
                "forecast": (last or {}).get("forecast"),
                "decision": (last or {}).get("decision"),
                "accuracy": self.accuracy(),
                "config": {
                    "burn_threshold": self.burn_threshold,
                    "burn_sustain": self.burn_sustain,
                    "up_margin": self.up_margin,
                    "down_frac": self.down_frac,
                    "down_sustain": self.down_sustain,
                    "cooldown_polls": self.cooldown_polls,
                    "damp_polls": self.damp_polls,
                    "horizon_s": self.horizon_s,
                },
            }


# decision/reason constants (module-level, so record sites use NAMEs
# the lint can resolve against the enum tuples)
DECISION_UP = "scale_up"
DECISION_DOWN = "scale_down"
DECISION_HOLD = "hold"
REASON_BURN_SUSTAINED = "burn_sustained"
REASON_HEADROOM_DEFICIT = "headroom_deficit"
REASON_BURST_ARRIVAL = "burst_arrival"
REASON_HEADROOM_SURPLUS = "headroom_surplus"
REASON_COOLDOWN = "cooldown"
REASON_DAMPED = "damped"
REASON_STEADY = "steady"
REASON_INSUFFICIENT_DATA = "insufficient_data"


def read_ledger(path: str) -> "list[dict]":
    """Parse a JSONL decision ledger back (decision + score lines, in
    write order); unreadable lines are skipped, a missing file is
    an empty ledger."""
    out = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


# ---- module singleton (the conftest teardown contract) ---------------------

_scaler: "ShadowScaler | None" = None
_registry_lock = threading.Lock()


def install(scaler: ShadowScaler) -> ShadowScaler:
    global _scaler
    with _registry_lock:
        prev = _scaler
        _scaler = scaler
    if prev is not None and prev is not scaler:
        prev.uninstall()
    return scaler


def get_scaler() -> "ShadowScaler | None":
    return _scaler


def uninstall():
    global _scaler
    with _registry_lock:
        s = _scaler
        _scaler = None
    if s is not None:
        s.uninstall()


def reset():
    """Test-teardown contract: scaler uninstalled (poll thread joined,
    ledger closed), the measured decode floor dropped."""
    uninstall()
    note_decode_floor(None)


# ---- the fleet shard line ---------------------------------------------------

def fleet_capacity_snapshot() -> "dict | None":
    """The `fleet_capacity` shard line: this replica's own headroom
    row, derived from the SAME serving signals its `fleet_serve` line
    publishes (so the coordinator's /fleetz headroom column reconciles
    against the shard by construction), plus the local shadow scaler's
    last decision when one is installed. None when there is nothing
    serving here."""
    from . import slo
    serve = slo.fleet_serve_snapshot(max_timelines=0, max_syncs=0)
    scaler = get_scaler()
    if serve is None and scaler is None:
        return None
    out: dict = {}
    if serve is not None:
        model = scaler.model if scaler is not None else CapacityModel()
        row = model.assess_replica(serve)
        out.update({
            "headroom_frac": row["headroom_frac"],
            "wall": row["wall"],
            "wall_util": row["wall_util"],
            "sustainable_rps": row["sustainable_rps"],
            "source": row["source"],
            "utils": row["utils"],
            "rps": row["rps"],
        })
    if scaler is not None:
        snap = scaler.snapshot()
        dec = snap.get("decision") or {}
        out.update({
            "polls": snap["polls"],
            "decision": dec.get("decision"),
            "reason": dec.get("reason"),
            "demand_rps": dec.get("demand_rps"),
            "accuracy": snap["accuracy"],
        })
    return out


# ---- reports ----------------------------------------------------------------

def _fmt_util(u) -> str:
    return f"{100.0 * u:.0f}%" if u is not None else "-"


def capacity_report() -> str:
    """The /capacityz (and /statusz `== capacity ==`) text block:
    fleet headroom + forecast, the per-replica headroom table naming
    each replica's binding wall, the decision tail, and the shadow
    accuracy scorecard."""
    lines = ["== capacity =="]
    scaler = get_scaler()
    if scaler is None:
        lines.append("no ShadowScaler installed "
                     "(singa_tpu_torch.capacity.ShadowScaler(...)"
                     ".install())")
        return "\n".join(lines)
    snap = scaler.snapshot()
    assess = snap.get("assessment")
    fc = snap.get("forecast") or {}
    dec = snap.get("decision") or {}
    if assess is None:
        lines.append(f"polls: {snap['polls']} (no assessment yet)")
        return "\n".join(lines)
    sus = assess.get("sustainable_rps")
    head = assess.get("headroom_frac")
    tts = dec.get("time_to_saturation_s")
    lines.append(
        f"fleet: {assess['n_replicas']} replica(s)   measured "
        f"{assess['rps']:.2f} rps   sustainable "
        + (f"{sus:.2f} rps" if sus is not None else "unknown")
        + "   headroom "
        + (f"{100.0 * head:.0f}%" if head is not None else "-"))
    lines.append(
        f"demand: fast {fc.get('fast_rps')} rps / slow "
        f"{fc.get('slow_rps')} rps"
        + ("   BURST" if fc.get("burst") else "")
        + "   time-to-saturation "
        + (f"{tts:.1f}s" if tts is not None else "-"))
    lines.append(
        f"{'replica':<12} {'rps':>7} {'slots':>6} {'pages':>6} "
        f"{'queue':>6} {'ttft':>6} {'bw':>5} {'wall':<10} "
        f"{'headroom':>9} {'sust_rps':>9} src")
    for r in assess.get("replicas") or []:
        u = r["utils"]
        lines.append(
            f"{r['host']:<12} {r['rps']:>7.2f} "
            f"{_fmt_util(u.get('slots')):>6} "
            f"{_fmt_util(u.get('pages')):>6} "
            f"{_fmt_util(u.get('queue')):>6} "
            f"{_fmt_util(u.get('ttft')):>6} "
            f"{_fmt_util(u.get('bandwidth')):>5} "
            f"{r['wall'] or '-':<10} "
            f"{_fmt_util(r['headroom_frac']):>9} "
            + (f"{r['sustainable_rps']:>9.2f}"
               if r["sustainable_rps"] is not None else f"{'-':>9}")
            + f" {r['source'] or '-'}"
            + (" [stale]" if r.get("stale") else ""))
    tail = scaler.decisions()[-8:]
    if tail:
        lines.append(f"decisions ({snap['polls']} polls, "
                     f"{snap['direction_changes']} direction "
                     "change(s)):")
        for rec in tail:
            burn = f"burn {rec['burn_fast']:.2f}x/" \
                   f"{rec['burn_slow']:.2f}x" \
                if rec["burn_fast"] is not None \
                and rec["burn_slow"] is not None else "burn -"
            lines.append(
                f"  poll {rec['poll']}: {rec['decision']} "
                f"[{rec['reason']}]  demand "
                f"{rec['demand_rps']} rps vs "
                f"{rec['sustainable_rps']} rps  {burn}"
                + (f"  -> {rec['outcome']}"
                   if rec.get("outcome") else ""))
    acc = snap["accuracy"]
    lines.append(
        f"shadow accuracy: {acc['scored']} scored  "
        f"tp {acc['tp']} fp {acc['fp']} fn {acc['fn']} tn {acc['tn']}"
        f"  precision "
        + (f"{acc['precision']:.2f}"
           if acc["precision"] is not None else "-")
        + "  recall "
        + (f"{acc['recall']:.2f}"
           if acc["recall"] is not None else "-"))
    return "\n".join(lines)


def capacity_json() -> dict:
    """The /capacityz?json=1 body: the scaler snapshot plus the full
    decision ring."""
    scaler = get_scaler()
    if scaler is None:
        return {"installed": False}
    return {"installed": True, "snapshot": scaler.snapshot(),
            "decisions": scaler.decisions()}


# ---- CLI: the load-ramp shadow A/B -----------------------------------------
# `--ab` drives one seeded Poisson workload through the REAL router
# (in-process engines behind real ReplicaControl HTTP surfaces) in two
# legs — an overload ramp and a cooldown — polling the shadow scaler on
# a fixed cadence. The gates: scale_up within 5 polls of sustained
# burn on the ramp, scale_down on the cooldown leg, at most one
# direction change per leg, every decision reason-coded from
# DECISION_REASONS, and the counterfactual scorecard populated.

def _ab_build(args):
    from . import engine as engine_mod
    from . import router as router_mod
    T = args.prompt_hi + args.new_hi + 4
    # one shared seeded model behind N in-process engines (the
    # test_router idiom): the load is real continuous batching, the
    # model cost is paid once
    m = router_mod._build_replica_model(args.vocab, args.dim,
                                        args.layers, T, args.device)
    engines = [engine_mod.ServingEngine(
        m, max_slots=args.slots, page_size=args.page_size,
        max_ctx=T, queue_limit=512).start()
        for _ in range(args.replicas)]
    ctls = [router_mod.ReplicaControl(e) for e in engines]
    r = router_mod.Router(
        queue_limit=4 * (args.ramp_requests + args.cool_requests),
        max_attempts=4, retry_total_s=args.timeout,
        retry_seed=args.seed, poll_wait_s=0.5).start()
    for i, ctl in enumerate(ctls):
        r.add_replica(f"r{i}", ctl.url, host=f"r{i}")
    return engines, ctls, r


def _ab_submit_thread(r, wl, n, deadline_s, done_evt, handles=None):
    """Paced submission of arrivals [0, n) on the workload clock; each
    handle goes into `handles` when one is given."""
    def run():
        t0 = time.perf_counter()
        for i in range(n):
            dt = t0 + wl["arrivals"][i] - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
            try:
                h = r.submit(wl["prompts"][i], int(wl["new_lens"][i]))
            except Exception:
                continue
            if handles is not None:
                handles.append(h)
        done_evt.set()
    t = threading.Thread(target=run, name="singa-capacity-ab-load",
                         daemon=True)
    t.start()
    return t


def _ab_main(args) -> int:
    from . import diag, resilience, serving, slo
    rec = {"replicas": args.replicas, "seed": args.seed,
           "device": args.device, "ok": False}
    ledger_path = os.path.join(
        os.path.dirname(os.path.abspath(args.out)),
        "CAPACITY_torch_ledger.jsonl")
    if os.path.exists(ledger_path):
        os.remove(ledger_path)
    engines, ctls, r = _ab_build(args)
    # a fixed per-engine-step stall makes per-request service time a
    # CONTROLLED quantity, so the overload point is predictable across
    # host speeds (the router --ab's fault-arm technique)
    resilience.install_fault_plan(resilience.FaultPlan().delay(
        "serving.engine_step", args.step_delay, times=10 ** 9))
    tracker = None
    scaler = None
    try:
        # warmup: measure the UNLOADED first-token wall so the TTFT
        # objective sits well above it (and well below queued-up TTFT)
        import numpy as np
        rng = np.random.RandomState(args.seed)
        warm_ttfts = []
        for _ in range(6):
            h = r.submit(rng.randint(0, args.vocab,
                                     args.prompt_lo).astype(np.int32),
                         4)
            h.wait(args.timeout)
            if h.ttft_s is not None:
                warm_ttfts.append(h.ttft_s)
        # the FIRST warm requests pay the kernel builds and first
        # allocations: take the median of the back half so the TTFT
        # objective reflects the steady-state first-token wall
        tail = warm_ttfts[len(warm_ttfts) // 2:]
        warm_p50 = sorted(tail)[len(tail) // 2] if tail else 0.05
        slo_ttft = min(1.2, max(0.3, 4.0 * warm_p50))
        # the engine advances every active slot steps_per_sync tokens
        # per delayed sync, so the fleet service rate is
        # slots * steps_per_sync / (mean_new_tokens * step_delay):
        # ramp overdrives it, cooldown underdrives it
        mean_new = (4 + args.new_hi) / 2.0
        cap_est = (args.replicas * args.slots * 4) \
            / (mean_new * args.step_delay)
        rps_hi = args.overdrive * cap_est
        rps_lo = 0.15 * cap_est
        rec.update({"warm_ttft_p50_s": round(warm_p50, 4),
                    "slo_ttft_s": round(slo_ttft, 4),
                    "capacity_est_rps": round(cap_est, 2),
                    "rps_ramp": round(rps_hi, 2),
                    "rps_cooldown": round(rps_lo, 2)})
        tracker = slo.SLOTracker(slo.SLOConfig(
            ttft_p99_s=slo_ttft, availability=0.99,
            window_s=3.0, fast_window_s=1.0, slow_window_s=3.0,
            burn_threshold=2.0, sustain=2, min_requests=5,
            eval_interval_s=1e9)).install()
        scaler = ShadowScaler(
            CapacityModel(ttft_slo_s=slo_ttft),
            DemandForecaster(fast_tau_s=0.6, slow_tau_s=3.0),
            interval_s=args.poll_s, ledger_path=ledger_path,
            burn_threshold=2.0, burn_sustain=2,
            down_frac=0.4, down_sustain=4, cooldown_polls=4,
            damp_polls=2, horizon_s=args.horizon_s,
        ).install(poll=False)  # polled manually: countable cadence
        diag.start_diag_server(port=0)

        def run_leg(name, wl, n, polls, drain=False):
            done = threading.Event()
            handles: list = []
            t = _ab_submit_thread(r, wl, n, args.timeout, done, handles)
            recs = []

            def poll():
                time.sleep(args.poll_s)
                tracker.evaluate()
                recs.append(scaler.evaluate())

            for _ in range(polls):
                poll()
            t.join(timeout=args.timeout)
            # `drain`: the leg polls on until its backlog is served, so
            # the next leg starts on an idle fleet whatever the host's
            # speed (a loaded CPU serves the ramp's requests in twice
            # the polls an idle one takes)
            deadline = time.perf_counter() + args.timeout
            while drain and time.perf_counter() < deadline \
                    and any(h.outcome is None for h in handles):
                poll()
            return recs

        ramp_wl = serving.poisson_workload(
            args.seed, args.ramp_requests, rps_hi, args.vocab,
            (args.prompt_lo, args.prompt_hi), (4, args.new_hi))
        ramp = run_leg("ramp", ramp_wl, args.ramp_requests,
                       args.ramp_polls, drain=True)
        cool_wl = serving.poisson_workload(
            args.seed + 1, args.cool_requests, rps_lo, args.vocab,
            (args.prompt_lo, args.prompt_hi), (4, args.new_hi))
        cool = run_leg("cooldown", cool_wl, args.cool_requests,
                       args.cool_polls)
        # let the horizon pass so every decision gets scored
        time.sleep(args.horizon_s + 2 * args.poll_s)
        tracker.evaluate()
        final = scaler.evaluate()
        capz = capacity_report()
        acc = scaler.accuracy()

        def direction_changes(recs):
            dirs = [x["decision"] for x in recs
                    if x["decision"] != DECISION_HOLD]
            return sum(1 for a, b in zip(dirs, dirs[1:]) if a != b)

        first_sustained = next(
            (x["poll"] for x in ramp
             if x["burn_streak"] >= scaler.burn_sustain), None)
        ups = [x["poll"] for x in ramp
               if x["decision"] == DECISION_UP]
        first_up = ups[0] if ups else None
        # "within 5 polls of sustained burn": the first scale_up AT or
        # AFTER the sustain threshold; a scale_up that already fired
        # earlier (burst/deficit caught it before the burn even
        # sustained) counts as delay 0
        up_delay = None
        if first_sustained is not None and ups:
            after = next((p for p in ups if p >= first_sustained),
                         None)
            up_delay = (after - first_sustained) \
                if after is not None else 0
        cool_down = next((x["poll"] for x in cool
                          if x["decision"] == DECISION_DOWN), None)
        all_recs = ramp + cool + [final]
        reasons_ok = all(x["reason"] in DECISION_REASONS
                         and x["decision"] in SCALE_DECISIONS
                         for x in all_recs)
        ledger = read_ledger(ledger_path)
        ledger_decisions = [x for x in ledger
                            if x.get("kind") == "decision"]
        ledger_scores = [x for x in ledger if x.get("kind") == "score"]
        rec.update({
            "ramp_polls": len(ramp), "cool_polls": len(cool),
            "first_sustained_burn_poll": first_sustained,
            "first_scale_up_poll": first_up,
            "scale_up_delay_polls": up_delay,
            "first_scale_down_poll": cool_down,
            "ramp_direction_changes": direction_changes(ramp),
            "cool_direction_changes": direction_changes(cool),
            "total_direction_changes": scaler.direction_changes(),
            "reasons_all_enum": reasons_ok,
            "ledger_decisions": len(ledger_decisions),
            "ledger_scores": len(ledger_scores),
            "final_headroom_frac": final.get("headroom_frac"),
            "accuracy": acc,
            "capacityz_has_table": "wall" in capz
            and "shadow accuracy" in capz,
            "decision_tail": [
                {k: x.get(k) for k in ("poll", "decision", "reason",
                                       "burn_fast", "demand_rps",
                                       "sustainable_rps")}
                for x in all_recs[-10:]],
        })
        rec["ok"] = bool(
            first_sustained is not None and first_up is not None
            and up_delay is not None and up_delay <= 5
            and cool_down is not None
            and rec["ramp_direction_changes"] <= 1
            and rec["cool_direction_changes"] <= 1
            and reasons_ok
            and len(ledger_decisions) == len(all_recs)
            and len(ledger_scores) > 0
            and acc["scored"] > 0 and acc["tp"] >= 1
            and acc["precision"] is not None
            and rec["capacityz_has_table"])
    finally:
        from . import diag, engine as engine_mod
        from . import router as router_mod
        r.stop()
        router_mod.reset()
        if scaler is not None:
            uninstall()
        for ctl in ctls:
            ctl.stop()
        engine_mod.reset()
        if tracker is not None:
            slo.reset()
        resilience.clear_fault_plan()
        diag.stop_diag_server()
    lines = [
        {"metric": "capacity_scale_up_delay_polls",
         "value": float(rec.get("scale_up_delay_polls") or 0.0),
         "unit": "polls"},
        {"metric": "capacity_decision_flaps",
         "value": float(rec.get("total_direction_changes") or 0.0),
         "unit": "count"},
        {"metric": "capacity_cooldown_headroom_frac",
         "value": float(rec.get("final_headroom_frac") or 0.0),
         "unit": "frac"},
        {"metric": "capacity_shadow_precision",
         "value": float((rec.get("accuracy") or {}).get("precision")
                        or 0.0), "unit": "frac"},
        rec,
    ]
    with open(args.out, "w", encoding="utf-8") as f:
        for obj in lines:
            f.write(json.dumps(obj, sort_keys=True) + "\n")
    print(json.dumps(rec, indent=2, sort_keys=True))
    return 0 if rec["ok"] else 1


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m singa_tpu_torch.capacity",
        description="capacity observatory: --ab runs the load-ramp "
                    "shadow-autoscaler harness")
    p.add_argument("--ab", action="store_true")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--vocab", type=int, default=211)
    p.add_argument("--dim", type=int, default=64,
                   help="model width (4 heads); on the card 256 or 512, "
                        "the flash kernel's head widths 64 and 128")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--page-size", type=int, default=8)
    p.add_argument("--prompt-lo", type=int, default=4)
    p.add_argument("--prompt-hi", type=int, default=12)
    p.add_argument("--new-hi", type=int, default=12)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--step-delay", type=float, default=0.15,
                   help="per-SYNC stall that fixes the service rate "
                        "(fault_point fires once per steps_per_sync "
                        "tokens, so fleet capacity is roughly "
                        "replicas*slots*4/(mean_new*delay) rps — this "
                        "default lands it near 13 rps so the overdrive "
                        "ramp genuinely overloads it)")
    p.add_argument("--overdrive", type=float, default=3.0,
                   help="ramp arrival rate as a multiple of the "
                        "estimated fleet capacity")
    p.add_argument("--ramp-requests", type=int, default=80)
    p.add_argument("--cool-requests", type=int, default=12)
    p.add_argument("--ramp-polls", type=int, default=20,
                   help="the ramp leg's polls; it polls on until its "
                        "backlog is served")
    p.add_argument("--cool-polls", type=int, default=24)
    p.add_argument("--poll-s", type=float, default=0.3)
    p.add_argument("--horizon-s", type=float, default=3.0)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where the engines run")
    p.add_argument("--out", default="CAPACITY_torch.json")
    args = p.parse_args(argv)
    if args.ab:
        return _ab_main(args)
    p.error("pick a mode: --ab")
    return 2


__all__ = [
    "CAPACITY_WALLS", "SCALE_DECISIONS", "DECISION_REASONS",
    "SHADOW_OUTCOMES",
    "CapacityModel", "DemandForecaster", "ShadowScaler",
    "default_sample", "read_ledger",
    "install", "get_scaler", "uninstall", "reset",
    "note_decode_floor", "get_decode_floor",
    "fleet_capacity_snapshot", "capacity_report", "capacity_json",
]

if __name__ == "__main__":
    # run under the CANONICAL module (not the runpy __main__ alias): the
    # CLI installs the module singleton the diag/fleet layers reach via
    # `import singa_tpu_torch.capacity`
    from singa_tpu_torch.capacity import main as _main
    sys.exit(_main())
