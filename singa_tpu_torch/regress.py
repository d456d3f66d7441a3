"""Performance regression observatory (counterpart of
singa_tpu/regress.py): persistent latency baselines, online change-point
detection, cause attribution, and auto-captured evidence bundles.

The JAX package's detector, on the port's fenced signals. Three
cooperating pieces:

  1. `BaselineStore` — robust per-signal latency baselines (median/MAD
     over a warmup window) annotated with introspect's build
     fingerprint, persisted as JSONL so a restarted process compares its
     builds against the PREVIOUS incarnation's baselines. The fingerprint
     is deterministic (sha256 of key + abstract signature), so the same
     model at the same shapes hashes identically across restarts — a
     fingerprint-matched baseline that froze `restart_factor`x slower
     than its predecessor is a cross-restart regression, convicted at
     freeze time. In-session detection compares against the FROZEN
     baseline regardless of the current fingerprint.

  2. `RegressionDetector` — online change-point detection over the
     fenced signals that already exist, fed by listeners: `model.step`
     span durations, engine decode-sync (`serving.engine_step`) and
     per-bucket prefill spans, and request TTFT / inter-token latency
     from the engine's terminal-request stream
     (`slo.request_latency_sample`; synthetic audit probes are excluded
     at the door). Per signal, a windowed CUSUM: z = (window_median -
     baseline_median) / sigma with sigma = max(MAD * 1.4826, rel_floor *
     median), z capped, S = max(0, S + z - k), and a conviction only
     after S > h for `sustain` consecutive windows. An episode recovers
     when z falls back under `recover_z` for `recover_sustain` windows.
     A build nested in a sample's span taints that sample: JAX's
     `introspect.build` and `model.jit_fallback`, and the port's
     `model.build` (a graph-mode step's warm-up and CUDA-graph capture
     run inside its `model.step` span).

  3. Cause attribution, in order, from `REGRESS_CAUSES`: compile (a
     recompile blame for the signal's build key since the freeze, or a
     moved fingerprint), host (the fleet's `fleet_regress` vote names
     exactly one host of >= 3), workload_shift (the prefill-bucket,
     occupancy or output-length mix drifted), contention (the admission
     queue rose, or the goodput ratio fell / data_wait rose), unknown.

Each conviction writes an evidence bundle `flight_regress_<n>.jsonl` in
the FlightRecorder line format (both packages' `health.load_flight_bundle`
read it). With `profile=True` a `singa-regress-profile-*` thread captures
a trace through `Device.StartTrace` (the card's when there is one, else
the CPU's) and appends `xprof.top_ops` and a `diff_op_tables` diff
against the capture taken at the first freeze; a busy profiler means no
capture.

Surfaces: `/regressz` (+`?json=1`), `== regress ==` on /statusz, the
`fleet_regress` shard line and the /fleetz block, `singa_regress_*`
metrics with enum-checked `cause=` labels, the health note
KIND_REGRESSION (it survives observe.enable(False)), and
`python -m singa_tpu_torch.regress --ab [--device cpu]`: a contention
serving leg and a compile training leg, gated on detection within 5
windows and zero clean-arm false positives -> REGRESS_torch.json (the
JAX package's record is REGRESS_r01.json). On the card the serving leg's
model is the router replica's, whose head width dim / 4 must be 64 or
128: run it at `--dim 256` or `--dim 512`. The training leg's widths and
batches default by device (`_TRAIN_LEG`: JAX's on the CPU, a
device-bound 4096-wide MLP on the card).

Threads are named `singa-regress-*`; `reset()` is the test-teardown
contract (detector uninstalled, listeners detached, baseline store
closed).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque

from . import introspect, observe

#: the leaves of a build span: a sample whose span encloses one is tainted
_BUILD_SPANS = ("model.jit_fallback", "introspect.build", "model.build")

#: the cause enum — the `cause=` label on singa_regress_verdicts_total
#: (lint rule 5)
REGRESS_CAUSES = ("compile", "workload_shift", "contention", "host",
                  "unknown")

CAUSE_COMPILE = "compile"
CAUSE_WORKLOAD_SHIFT = "workload_shift"
CAUSE_CONTENTION = "contention"
CAUSE_HOST = "host"
CAUSE_UNKNOWN = "unknown"


_metrics_cache = None


def _metrics():
    # memoize-with-revalidation (engine._metrics's shape): cheap on the
    # span-listener path, rebuilt after a conftest registry reset
    global _metrics_cache
    c = _metrics_cache
    if c is not None and observe.get_registry().get(
            "singa_regress_windows_total") is c["windows"]:
        return c
    _metrics_cache = c = {
        "windows": observe.counter(
            "singa_regress_windows_total",
            "closed change-point detection windows across all "
            "regression signals"),
        "verdicts": observe.counter(
            "singa_regress_verdicts_total",
            "sustained regression convictions, by attributed cause"),
        "recoveries": observe.counter(
            "singa_regress_recoveries_total",
            "regression episodes that recovered (window latency back "
            "under the baseline band for recover_sustain windows)"),
        "bundles": observe.counter(
            "singa_regress_bundles_total",
            "flight_regress_<n>.jsonl evidence bundles written"),
        "baselines": observe.gauge(
            "singa_regress_baselines",
            "signals with a frozen latency baseline"),
        "active": observe.gauge(
            "singa_regress_active_episodes",
            "signals currently inside an unrecovered regression "
            "episode"),
        "score": observe.gauge(
            "singa_regress_score",
            "current CUSUM score per signal (S = max(0, S + z - k); a "
            "conviction needs S > h for sustain consecutive windows)"),
    }
    return c


# ---- robust statistics ------------------------------------------------------

def _median(xs):
    s = sorted(xs)
    n = len(s)
    if not n:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _mad(xs, med):
    return _median([abs(x - med) for x in xs])


# ---- signal <-> executable mapping ------------------------------------------

def _introspect_keys(signal: str) -> tuple:
    """The introspect AOT key(s) whose HLO fingerprint anchors a
    signal's baseline. Request-level signals have no executable of
    their own; they inherit the serving executables (a prefill or
    decode recompile moves TTFT/ITL)."""
    if signal.startswith("model.step"):
        return ("step",)
    if signal == "engine.step":
        return ("serving.engine_step", "serving.engine_spec_step")
    if signal.startswith("engine.prefill"):
        return ("serving.engine_prefill", "serving.engine_spec_prefill")
    if signal.startswith("request."):
        return ("serving.engine_step", "serving.engine_prefill",
                "serving.engine_spec_step", "serving.engine_spec_prefill")
    return ()


def _fingerprint_of(signal: str) -> "str | None":
    for k in _introspect_keys(signal):
        fp = introspect.latest_fingerprint(k)
        if fp:
            return fp
    return None


# ---- piece 1: the baseline store --------------------------------------------

class BaselineStore:
    """Per-signal robust latency baselines with JSONL persistence.

    Keys are SIGNAL NAMES; each frozen entry carries the signal's
    newest HLO fingerprint as metadata. `path` (optional) is read at
    construction — the last persisted entry per signal becomes the
    PRIOR-incarnation baseline — then opened for append, so every
    freeze this process performs lands on disk for the NEXT
    incarnation. `restart_regression` compares a just-frozen entry
    against the prior one: a verdict only when the fingerprints MATCH
    (same executable — a changed fingerprint is a different program,
    not a regression of this one) and the fresh median exceeds
    `restart_factor` x the old."""

    def __init__(self, path=None, *, restart_factor=1.5):
        self.path = path
        self.restart_factor = float(restart_factor)
        self._lock = threading.Lock()
        self._entries: "dict[str, dict]" = {}
        self._prior: "dict[str, dict]" = {}
        self._fh = None
        if path:
            self._prior = self._load(path)
            try:
                self._fh = open(path, "a", encoding="utf-8")
            except OSError:
                self._fh = None

    @staticmethod
    def _load(path) -> dict:
        prior = {}
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
                    if isinstance(rec, dict) \
                            and rec.get("kind") == "baseline" \
                            and rec.get("signal"):
                        prior[rec["signal"]] = rec  # last line wins
        except OSError:
            pass
        return prior

    def freeze(self, signal: str, samples, fingerprint=None) -> dict:
        """Freeze one signal's baseline from its warmup samples and
        persist it. Returns the entry."""
        med = _median(samples)
        entry = {
            "kind": "baseline", "signal": signal,
            "median_s": round(med, 9),
            "mad_s": round(_mad(samples, med), 9),
            "n": len(samples), "fingerprint": fingerprint,
            "pid": os.getpid(), "ts": round(time.time(), 6),
        }
        with self._lock:
            self._entries[signal] = entry
            if self._fh is not None:
                try:
                    self._fh.write(
                        json.dumps(entry, sort_keys=True) + "\n")
                    self._fh.flush()
                except OSError:
                    pass
        return dict(entry)

    def get(self, signal: str) -> "dict | None":
        with self._lock:
            e = self._entries.get(signal)
            return dict(e) if e else None

    def prior(self, signal: str) -> "dict | None":
        e = self._prior.get(signal)
        return dict(e) if e else None

    def restart_regression(self, entry: dict) -> "dict | None":
        """Cross-restart check for a just-frozen entry: the previous
        incarnation's persisted baseline for the same signal AND the
        same fingerprint, when this incarnation froze restart_factor x
        slower. Returns {"prior", "ratio"} or None."""
        p = self.prior(entry.get("signal") or "")
        if not p:
            return None
        fp_old, fp_new = p.get("fingerprint"), entry.get("fingerprint")
        if not fp_old or not fp_new or fp_old != fp_new:
            return None  # different executable: not comparable
        old = float(p.get("median_s") or 0.0)
        new = float(entry.get("median_s") or 0.0)
        if old <= 0.0 or new <= self.restart_factor * old:
            return None
        return {"prior": p, "ratio": round(new / old, 4)}

    def baselines(self) -> "list[dict]":
        with self._lock:
            return [dict(e) for e in self._entries.values()]

    def close(self):
        fh = self._fh
        self._fh = None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass


# ---- per-signal detection state ---------------------------------------------

class _Signal:
    __slots__ = ("name", "warm", "window", "recent", "baseline",
                 "cusum", "z", "streak", "recover_streak", "windows",
                 "samples", "tainted", "episode", "verdicts", "env0",
                 "mix0", "last_window_median")

    def __init__(self, name):
        self.name = name
        self.warm = []
        self.window = []
        self.recent = deque(maxlen=128)  # raw samples for the bundle
        self.baseline = None
        self.cusum = 0.0
        self.z = None
        self.streak = 0
        self.recover_streak = 0
        self.windows = 0
        self.samples = 0
        self.tainted = 0
        self.episode = None
        self.verdicts = 0
        self.env0 = None
        self.mix0 = None
        self.last_window_median = None


# ---- piece 2+3: the detector ------------------------------------------------

class RegressionDetector:
    """Online change-point detection over the runtime's fenced latency
    signals, with cause attribution and evidence-bundle capture. See
    the module docstring for the math; the knobs:

    warmup_samples  raw samples frozen into the baseline (median/MAD)
    window          samples per detection window (the CUSUM consumes
                    window MEDIANS, so a single straggler sample
                    cannot advance the score)
    k / h           CUSUM drift allowance and decision threshold
    sustain         consecutive S > h windows before a conviction
    z_cap           per-window z ceiling (bounds S growth per window,
                    so detection latency is readable: a total outage
                    still takes `sustain` windows, not one)
    rel_floor       sigma floor as a fraction of the baseline median
                    (MAD of a quiet warmup can be ~0; a 5% floor keeps
                    z finite and calibrated to relative change)
    recover_z /     episode recovery: z at or under recover_z for
    recover_sustain recover_sustain consecutive windows
    profile         capture trace op tables (baseline at freeze,
                    regressed at conviction) on async
                    `singa-regress-profile-*` threads and append the
                    diff_op_tables diff to the bundle
    """

    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(self, store: "BaselineStore | None" = None, *,
                 warmup_samples=24, window=8, k=0.5, h=4.0, sustain=2,
                 z_cap=8.0, rel_floor=0.05, min_sigma_s=2e-5,
                 recover_z=1.0, recover_sustain=2, mix_drift=0.3,
                 out_len_ratio=1.3, out_dir=".", bundle_events=64,
                 max_signals=64, profile=False, profile_s=0.4):
        self.store = store or BaselineStore()
        self.warmup_samples = int(warmup_samples)
        self.window = int(window)
        self.k = float(k)
        self.h = float(h)
        self.sustain = int(sustain)
        self.z_cap = float(z_cap)
        self.rel_floor = float(rel_floor)
        self.min_sigma_s = float(min_sigma_s)
        self.recover_z = float(recover_z)
        self.recover_sustain = int(recover_sustain)
        self.mix_drift = float(mix_drift)
        self.out_len_ratio = float(out_len_ratio)
        self.out_dir = str(out_dir)
        self.bundle_events = int(bundle_events)
        self.max_signals = int(max_signals)
        self.profile = bool(profile)
        self.profile_s = float(profile_s)
        self._lock = threading.Lock()
        self._signals: "dict[str, _Signal]" = {}
        self._verdicts: "deque[dict]" = deque(maxlen=64)
        self._bundle_seq = 0
        self._bundles: "list[str]" = []
        self._threads: "list[threading.Thread]" = []
        self._baseline_ops = None  # op table captured at first freeze
        # cumulative workload-mix counters (the drift comparisons use
        # pre-freeze vs post-freeze deltas, so cumulative is enough)
        self._mix_buckets: "dict[int, int]" = {}
        self._mix_out_tokens = 0
        self._mix_out_n = 0
        self._mix_slots_sum = 0.0
        self._mix_slots_n = 0
        self._recent_queue: "deque[float]" = deque(maxlen=32)
        self._installed = False

    # -- lifecycle ---------------------------------------------------------
    def install(self) -> "RegressionDetector":
        """Register as the process detector (module singleton — the
        diag/fleet surfaces and the conftest teardown find it) and
        attach the span + engine request listeners."""
        from . import engine
        install(self)
        if not self._installed:
            observe.add_span_listener(self._on_span)
            engine.add_request_listener(self._on_request)
            self._installed = True
        return self

    def uninstall(self):
        """Detach the listeners, join any profile threads, close the
        baseline store, drop the module registration if it points
        here. Idempotent."""
        if self._installed:
            from . import engine
            observe.remove_span_listener(self._on_span)
            engine.remove_request_listener(self._on_request)
            self._installed = False
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads = []
        self.store.close()
        global _detector
        with _registry_lock:
            if _detector is self:
                _detector = None

    # -- feeding -----------------------------------------------------------
    def _on_span(self, path, seconds, attrs):
        """observe span listener. Children exit before parents, so a
        nested build taints the enclosing step sample BEFORE that sample
        arrives — first-compile time neither convicts nor calibrates."""
        leaf = path.rsplit("/", 1)[-1]
        if leaf in _BUILD_SPANS and "/" in path:
            parent = path.rsplit("/", 2)[-2]
            sig = self._signal_of(parent, {})
            if sig is not None:
                with self._lock:
                    st = self._signals.get(sig)
                    if st is not None:
                        st.tainted += 1
            return
        signal = self._signal_of(leaf, attrs or {})
        if signal is None:
            return
        if leaf == "serving.engine_step":
            q = (attrs or {}).get("queue")
            if q is not None:
                self._recent_queue.append(float(q))
            s = (attrs or {}).get("slots")
            if s:
                self._mix_slots_sum += float(s)
                self._mix_slots_n += 1
        elif leaf == "serving.engine_prefill":
            b = (attrs or {}).get("bucket")
            if b is not None:
                self._mix_buckets[int(b)] = \
                    self._mix_buckets.get(int(b), 0) + 1
        self.feed(signal, seconds)

    @staticmethod
    def _signal_of(leaf, attrs) -> "str | None":
        if leaf == "model.step":
            tag = attrs.get("tag")
            return "model.step" if not tag else f"model.step.t{tag}"
        if leaf == "serving.engine_step":
            return "engine.step"
        if leaf == "serving.engine_prefill":
            b = attrs.get("bucket")
            return f"engine.prefill.{b}" if b is not None \
                else "engine.prefill"
        return None

    def _on_request(self, req, timeline):
        """engine request listener: TTFT + mean inter-token latency per
        COMPLETED real request (synthetic audit probes excluded inside
        slo.request_latency_sample)."""
        from . import slo
        sample = slo.request_latency_sample(req, timeline)
        if sample is None:
            return
        toks = sample.get("tokens") or 0
        if toks:
            self._mix_out_tokens += int(toks)
            self._mix_out_n += 1
        if sample.get("ttft_s") is not None:
            self.feed("request.ttft", float(sample["ttft_s"]))
        if sample.get("itl_s") is not None:
            self.feed("request.itl", float(sample["itl_s"]))

    def feed(self, signal: str, seconds: float):
        """One raw latency sample for `signal` — the listener entry
        point, also driven directly by tests and bench.py --regress."""
        with self._lock:
            sig = self._signals.get(signal)
            if sig is None:
                if len(self._signals) >= self.max_signals:
                    return
                sig = self._signals[signal] = _Signal(signal)
            if sig.tainted > 0:
                sig.tainted -= 1
                return
            sig.samples += 1
            sig.recent.append(round(float(seconds), 9))
            if sig.baseline is None:
                sig.warm.append(float(seconds))
                if len(sig.warm) >= self.warmup_samples:
                    self._freeze_locked(sig)
                return
            sig.window.append(float(seconds))
            if len(sig.window) < self.window:
                return
            self._close_window_locked(sig)

    def _freeze_locked(self, sig: _Signal):
        fp = _fingerprint_of(sig.name)
        entry = self.store.freeze(sig.name, sig.warm, fingerprint=fp)
        sig.baseline = entry
        sig.warm = []
        sig.env0 = self._env_snapshot()
        sig.mix0 = self._mix_snapshot()
        if observe.is_enabled():
            _metrics()["baselines"].set(float(sum(
                1 for s in self._signals.values()
                if s.baseline is not None)))
        if self.profile and self._baseline_ops is None:
            self._baseline_ops = ()  # claimed: one capture per process
            self._spawn_profile("baseline", None)
        # cross-restart check: the PREVIOUS incarnation persisted a
        # baseline for this signal at this fingerprint — freezing
        # restart_factor x slower is a slow deploy, convicted now
        rr = self.store.restart_regression(entry)
        if rr is not None:
            self._convict_locked(sig, float(entry["median_s"]),
                                 restart=rr)

    def _close_window_locked(self, sig: _Signal):
        med = _median(sig.window)
        sig.window = []
        sig.windows += 1
        sig.last_window_median = med
        base = sig.baseline
        sigma = max(float(base["mad_s"]) * 1.4826,
                    self.rel_floor * float(base["median_s"]),
                    self.min_sigma_s)
        z = (med - float(base["median_s"])) / sigma
        sig.z = round(min(z, self.z_cap), 4)
        sig.cusum = max(0.0, sig.cusum + sig.z - self.k)
        if observe.is_enabled():
            m = _metrics()
            m["windows"].inc()
            m["score"].set(round(sig.cusum, 4), signal=sig.name)
        if sig.episode is None:
            sig.streak = sig.streak + 1 if sig.cusum > self.h else 0
            if sig.streak >= self.sustain:
                self._convict_locked(sig, med)
        else:
            if z <= self.recover_z:
                sig.recover_streak += 1
                if sig.recover_streak >= self.recover_sustain:
                    self._recover_locked(sig, med)
            else:
                sig.recover_streak = 0

    # -- conviction / recovery ---------------------------------------------
    def _convict_locked(self, sig: _Signal, window_median: float,
                        restart: "dict | None" = None):
        now_env = self._env_snapshot()
        cause, evidence = self._attribute_locked(sig, now_env)
        base = restart["prior"] if restart is not None else sig.baseline
        base_med = float(base.get("median_s") or 0.0)
        rec = {
            "kind": "regress_verdict", "ts": round(time.time(), 6),
            "signal": sig.name, "cause": cause,
            "restart": restart is not None,
            "baseline_median_s": base_med,
            "window_median_s": round(window_median, 9),
            "ratio": round(window_median / max(base_med, 1e-12), 4),
            "z": sig.z, "cusum": round(sig.cusum, 4),
            "window": sig.windows, "samples": sig.samples,
            "fingerprint": _fingerprint_of(sig.name),
            "baseline_fingerprint": sig.baseline.get("fingerprint"),
            "evidence": evidence,
        }
        sig.episode = {"signal": sig.name, "cause": cause,
                       "ts": rec["ts"], "window": sig.windows}
        sig.verdicts += 1
        sig.streak = 0
        sig.recover_streak = 0
        try:
            rec["bundle"] = self._capture_bundle_locked(rec, sig,
                                                        now_env)
        except OSError:
            rec["bundle"] = None  # forensics must not break detection
        self._record_verdict(rec)
        if self.profile:
            self._spawn_profile("regressed", rec["bundle"])

    def _recover_locked(self, sig: _Signal, window_median: float):
        episode = sig.episode
        sig.episode = None
        sig.cusum = 0.0
        sig.streak = 0
        sig.recover_streak = 0
        if observe.is_enabled():
            m = _metrics()
            m["recoveries"].inc()
            m["active"].set(float(sum(
                1 for s in self._signals.values()
                if s.episode is not None)))
            m["score"].set(0.0, signal=sig.name)
            observe.get_registry().emit({
                "kind": "regress_recovery", "signal": sig.name,
                "cause": (episode or {}).get("cause"),
                "window_median_s": round(window_median, 9),
                "window": sig.windows})

    def _record_verdict(self, rec: dict):
        assert rec["cause"] in REGRESS_CAUSES, rec["cause"]
        self._verdicts.append(rec)
        # the event-stream mirror is telemetry (honors
        # observe.enable(False)); the ring above is detector state
        observe.record_regress_verdict(rec)
        if observe.is_enabled():
            m = _metrics()
            m["verdicts"].inc(cause=rec["cause"])
            m["active"].set(float(sum(
                1 for s in self._signals.values()
                if s.episode is not None)))
        # the health note is NOT telemetry: it survives
        # observe.enable(False) so /healthz cannot claim a healthy
        # process the detector just convicted (the audit precedent)
        try:
            from . import health
            mon = health.active_monitor()
            if mon is not None:
                mon.note_external(
                    health.KIND_REGRESSION,
                    detail={"signal": rec["signal"],
                            "cause": rec["cause"],
                            "ratio": rec["ratio"],
                            "restart": rec["restart"]},
                    action="warn")
        except Exception:
            pass  # the monitor must not break the detection path

    # -- cause attribution --------------------------------------------------
    def _attribute_locked(self, sig: _Signal, now_env: dict):
        """(cause, evidence) for a conviction, checked in precedence
        order: compile -> host -> workload_shift -> contention ->
        unknown."""
        ev: dict = {}
        # compile: a recompile blame for this signal's build key since
        # the baseline froze, or a fingerprint that drifted from it
        keys = _introspect_keys(sig.name)
        frozen_ts = float((sig.baseline or {}).get("ts") or 0.0)
        blames = [b for b in introspect.blame_history()
                  if float(b.get("ts") or 0.0) >= frozen_ts
                  and (not keys or b.get("key") in keys)]
        fp_now = _fingerprint_of(sig.name)
        base_fp = (sig.baseline or {}).get("fingerprint")
        fp_changed = bool(base_fp and fp_now and fp_now != base_fp)
        if blames or fp_changed:
            ev["blames"] = [
                {k: b.get(k) for k in ("key", "reason", "detail",
                                       "fingerprint")}
                for b in blames[-4:]]
            ev["fingerprint_changed"] = fp_changed
            return CAUSE_COMPILE, ev
        # host: the coordinator's shard vote localizes the regression
        vote = fleet_regress_vote()
        if vote is not None:
            ev["fleet_vote"] = vote
            if vote.get("verdict") == "host":
                return CAUSE_HOST, ev
        # workload shift: serving-side mix drift vs the warmup window
        shift = self._mix_shift(sig)
        if shift is not None:
            ev["mix"] = shift
            if shift.get("shifted"):
                return CAUSE_WORKLOAD_SHIFT, ev
        # contention: the environment got worse at fixed work
        ev["env"] = {"frozen": sig.env0, "now": now_env}
        if self._contended(sig.env0 or {}, now_env or {}):
            return CAUSE_CONTENTION, ev
        return CAUSE_UNKNOWN, ev

    def _mix_snapshot(self) -> dict:
        return {"buckets": dict(self._mix_buckets),
                "out_tokens": self._mix_out_tokens,
                "out_n": self._mix_out_n,
                "slots_sum": self._mix_slots_sum,
                "slots_n": self._mix_slots_n}

    def _mix_shift(self, sig: _Signal) -> "dict | None":
        """Workload-mix drift since the freeze, for serving signals:
        total-variation distance between the pre-freeze and
        post-freeze prefill-bucket distributions, plus output-length
        and occupancy ratios. None for signals with no workload mix
        (model.step) or before enough mass on both sides."""
        if not (sig.name.startswith("engine.")
                or sig.name.startswith("request.")):
            return None
        f = sig.mix0
        if f is None:
            return None
        cur = self._mix_snapshot()
        pre_b = f.get("buckets") or {}
        post_b = {b: cur["buckets"].get(b, 0) - pre_b.get(b, 0)
                  for b in set(cur["buckets"]) | set(pre_b)}
        n_pre, n_post = sum(pre_b.values()), sum(post_b.values())
        drift = None
        if n_pre >= 8 and n_post >= 8:
            drift = round(0.5 * sum(
                abs(pre_b.get(b, 0) / n_pre - post_b.get(b, 0) / n_post)
                for b in set(pre_b) | set(post_b)), 4)
        out_ratio = None
        d_n = cur["out_n"] - f["out_n"]
        if f["out_n"] >= 4 and d_n >= 4:
            pre = f["out_tokens"] / f["out_n"]
            post = (cur["out_tokens"] - f["out_tokens"]) / d_n
            out_ratio = round(post / max(pre, 1e-9), 4)
        occ_ratio = None
        d_s = cur["slots_n"] - f["slots_n"]
        if f["slots_n"] >= 4 and d_s >= 4:
            pre = f["slots_sum"] / f["slots_n"]
            post = (cur["slots_sum"] - f["slots_sum"]) / d_s
            occ_ratio = round(post / max(pre, 1e-9), 4)
        r = self.out_len_ratio
        shifted = bool(
            (drift is not None and drift > self.mix_drift)
            or (out_ratio is not None
                and not (1.0 / r <= out_ratio <= r))
            or (occ_ratio is not None
                and not (1.0 / r <= occ_ratio <= r)))
        return {"bucket_drift": drift, "out_len_ratio": out_ratio,
                "occupancy_ratio": occ_ratio, "shifted": shifted}

    def _env_snapshot(self) -> dict:
        from . import goodput
        from . import slo as slo_mod
        env = {"queue_depth": None, "slots": None, "span_queue": None,
               "goodput_ratio": None, "data_wait_frac": None}
        s = slo_mod.fleet_serve_snapshot(max_timelines=0, max_syncs=0)
        if s is not None:
            env["queue_depth"] = s.get("queue_depth")
            env["slots"] = s.get("slots")
        tr = goodput.get_tracker()
        if tr is not None:
            gs = tr.snapshot()
            env["goodput_ratio"] = round(
                float(gs.get("window_goodput_ratio")
                      or gs.get("goodput_ratio") or 0.0), 4)
            wall = float(gs.get("wall_s") or 0.0)
            if wall > 0:
                env["data_wait_frac"] = round(float(
                    (gs.get("buckets") or {}).get("data_wait", 0.0)
                ) / wall, 4)
        if self._recent_queue:
            env["span_queue"] = round(
                _median(list(self._recent_queue)), 2)
        return env

    def _contended(self, frozen: dict, now: dict) -> bool:
        # in-band queue from the engine_step span attrs first, then
        # the polled snapshot; then the training-side goodput signals
        for key in ("span_queue", "queue_depth"):
            q0, q1 = frozen.get(key), now.get(key)
            if q1 is not None and float(q1) >= max(
                    2.0, 2.0 * float(q0 or 0.0),
                    float(q0 or 0.0) + float(now.get("slots") or 2.0)):
                return True
        g0, g1 = frozen.get("goodput_ratio"), now.get("goodput_ratio")
        if g0 is not None and g1 is not None \
                and float(g0) - float(g1) > 0.15:
            return True
        d0, d1 = frozen.get("data_wait_frac"), now.get("data_wait_frac")
        if d1 is not None and float(d1) - float(d0 or 0.0) > 0.10:
            return True
        return False

    # -- the evidence bundle -------------------------------------------------
    def _capture_bundle_locked(self, rec: dict, sig: _Signal,
                               now_env: dict) -> str:
        """Write flight_regress_<n>.jsonl in the FlightRecorder line
        format (flight_header / flight_step / flight_event) so
        /flightz indexes it and health.load_flight_bundle round-trips
        it."""
        os.makedirs(self.out_dir, exist_ok=True)
        self._bundle_seq += 1
        path = os.path.join(self.out_dir,
                            f"flight_regress_{self._bundle_seq}.jsonl")
        from . import goodput, memory
        tail = list(observe.get_registry().recent)[-self.bundle_events:]
        execs = introspect.executable_manifest()[-8:] or None
        blames = introspect.blame_history()[-8:] or None
        tr = goodput.get_tracker()
        gp = tr.snapshot() if tr is not None else None
        led = memory.get_ledger()
        mem = led.region_bytes() if led is not None else None
        header = {
            "kind": "flight_header", "ts": rec["ts"],
            "reason": "regression", "step": sig.windows,
            "signal": sig.name, "cause": rec["cause"],
            "verdict": {k: rec[k] for k in
                        ("signal", "cause", "restart",
                         "baseline_median_s", "window_median_s",
                         "ratio", "z", "cusum", "window",
                         "fingerprint", "baseline_fingerprint")},
            "n_steps": len(sig.recent), "n_events": len(tail),
            "batch_snapshot": None,
            "executables": execs, "blames": blames,
            "baseline": sig.baseline, "goodput": gp, "memory": mem,
            "env": {"frozen": sig.env0, "now": now_env},
        }
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps(header, separators=(",", ":"),
                               default=str) + "\n")
            for i, s in enumerate(sig.recent):
                f.write(json.dumps(
                    {"kind": "flight_step", "i": i,
                     "signal": sig.name, "seconds": s},
                    separators=(",", ":")) + "\n")
            for ev in tail:
                # nested, not splatted: the event's own "kind" must
                # not clobber the line marker (FlightRecorder's rule)
                f.write(json.dumps({"kind": "flight_event",
                                    "event": ev},
                                   separators=(",", ":"),
                                   default=str) + "\n")
        self._bundles.append(path)
        if observe.is_enabled():
            _metrics()["bundles"].inc()
        return path

    # -- optional trace capture ----------------------------------------------
    def _spawn_profile(self, tag: str, bundle_path: "str | None"):
        with RegressionDetector._seq_lock:
            RegressionDetector._seq += 1
            n = RegressionDetector._seq
        t = threading.Thread(
            target=self._profile_main, args=(tag, bundle_path),
            name=f"singa-regress-profile-{n}", daemon=True)
        self._threads.append(t)
        t.start()

    def _profile_main(self, tag: str, bundle_path: "str | None"):
        table = self._profile_capture()
        if table is None:
            return
        if tag == "baseline":
            self._baseline_ops = table
            return
        # regressed capture: append the top-ops diff to the bundle as
        # one more flight_event line (the JSONL format appends cleanly;
        # load_flight_bundle picks it up on the next read)
        from . import xprof
        base = self._baseline_ops or []
        event = {"kind": "regress_profile", "tag": tag,
                 "top_ops": xprof.top_ops(table, 10),
                 "op_diff": xprof.diff_op_tables(base, table)[:10]
                 if base else None}
        if bundle_path:
            with open(bundle_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(
                    {"kind": "flight_event", "event": event},
                    separators=(",", ":"), default=str) + "\n")

    def _profile_capture(self) -> "list | None":
        """One bounded on-demand trace capture -> op_table rows, or None
        when the process-global profiler is busy (/profilez's guard).
        The trace is the card's when the process has one, else the
        CPU's: the detector watches whatever this process runs."""
        import shutil
        import tempfile

        import torch

        from . import device, xprof
        dev = device.best_device() if torch.cuda.is_available() \
            else device.create_cpu_device()
        out = tempfile.mkdtemp(prefix="singa_regress_prof_")
        try:
            try:
                dev.StartTrace(out)
            except RuntimeError:  # another capture owns the profiler
                return None
            try:
                time.sleep(self.profile_s)
            finally:
                dev.StopTrace()
            return xprof.op_table(out)
        finally:
            shutil.rmtree(out, ignore_errors=True)

    # -- introspection -------------------------------------------------------
    def verdicts(self) -> "list[dict]":
        with self._lock:
            return [dict(r) for r in self._verdicts]

    def bundles(self) -> "list[str]":
        with self._lock:
            return list(self._bundles)

    def signal_state(self, signal: str) -> "dict | None":
        with self._lock:
            sig = self._signals.get(signal)
            return self._row_locked(sig) if sig is not None else None

    @staticmethod
    def _row_locked(sig: _Signal) -> dict:
        base = sig.baseline or {}
        return {
            "signal": sig.name, "samples": sig.samples,
            "windows": sig.windows,
            "baseline_median_s": base.get("median_s"),
            "baseline_mad_s": base.get("mad_s"),
            "fingerprint": base.get("fingerprint"),
            "window_median_s": sig.last_window_median,
            "z": sig.z, "cusum": round(sig.cusum, 4),
            "streak": sig.streak, "verdicts": sig.verdicts,
            "state": ("warmup" if sig.baseline is None
                      else "REGRESSED" if sig.episode is not None
                      else "ok"),
        }

    def snapshot(self) -> dict:
        with self._lock:
            rows = [self._row_locked(s)
                    for s in self._signals.values()]
            return {
                "signals": rows,
                "n_signals": len(rows),
                "baselines": sum(1 for r in rows
                                 if r["baseline_median_s"] is not None),
                "active": [r["signal"] for r in rows
                           if r["state"] == "REGRESSED"],
                "windows": sum(r["windows"] for r in rows),
                "verdicts": len(self._verdicts),
                "last_verdict": dict(self._verdicts[-1])
                if self._verdicts else None,
                "bundles": list(self._bundles),
                "store_path": self.store.path,
                "config": {
                    "warmup_samples": self.warmup_samples,
                    "window": self.window, "k": self.k, "h": self.h,
                    "sustain": self.sustain, "z_cap": self.z_cap,
                    "rel_floor": self.rel_floor,
                    "recover_z": self.recover_z,
                    "recover_sustain": self.recover_sustain,
                    "restart_factor": self.store.restart_factor,
                },
            }


# ---- module singleton (the conftest teardown contract) ---------------------

_detector: "RegressionDetector | None" = None
_registry_lock = threading.Lock()


def install(det: RegressionDetector) -> RegressionDetector:
    global _detector
    with _registry_lock:
        prev = _detector
        _detector = det
    if prev is not None and prev is not det:
        prev.uninstall()
    return det


def get_detector() -> "RegressionDetector | None":
    return _detector


def uninstall():
    global _detector
    with _registry_lock:
        d = _detector
        _detector = None
    if d is not None:
        d.uninstall()


def reset():
    """Test-teardown contract: detector uninstalled (listeners
    detached, profile threads joined, baseline store closed)."""
    uninstall()


# ---- the fleet shard line / vote --------------------------------------------

def fleet_regress_snapshot() -> "dict | None":
    """The `fleet_regress` shard line: this replica's detector rollup —
    baseline/episode counts and the last verdict — compact enough to
    ride every shard write. None without a detector."""
    det = get_detector()
    if det is None:
        return None
    snap = det.snapshot()
    last = snap.get("last_verdict") or None
    return {
        "signals": snap["n_signals"],
        "baselines": snap["baselines"],
        "active": len(snap["active"]),
        "active_signals": snap["active"][:4],
        "verdicts": snap["verdicts"],
        "windows": snap["windows"],
        "last": {k: last.get(k) for k in ("signal", "cause", "ratio",
                                          "restart", "ts")}
        if last else None,
    }


def fleet_regress_vote() -> "dict | None":
    """The coordinator's localization vote over the workers'
    `fleet_regress` shard lines: with >= 3 fresh voters, exactly ONE
    worker inside an active episode is a host-localized regression
    (hardware suspect); a strict majority regressed is fleet-wide
    (software). None without an aggregator, under 3 voters, or no
    clear verdict."""
    from . import fleet
    agg = fleet.get_aggregator()
    if agg is None:
        return None
    rows = agg.rollup()["workers"]
    voters = [r for r in rows
              if isinstance(r.get("regress"), dict)
              and not r.get("stale")]
    if len(voters) < 3:
        return None
    regressed = sorted(r["host"] for r in voters
                       if (r["regress"].get("active") or 0) > 0)
    verdict = None
    if len(regressed) == 1:
        verdict = "host"
    elif len(regressed) > len(voters) // 2:
        verdict = "software"
    if verdict is None:
        return None
    return {"verdict": verdict, "voters": len(voters),
            "regressed": regressed}


def fleetz_lines() -> "list[str]":
    """The coordinator-side `== fleet regress ==` block for /fleetz:
    one row per worker shard that published a `fleet_regress` line,
    plus the localization vote. [] when there is nothing to show."""
    from . import fleet
    agg = fleet.get_aggregator()
    if agg is None:
        return []
    rows = [r for r in agg.rollup()["workers"]
            if isinstance(r.get("regress"), dict)]
    if not rows:
        return []
    lines = ["== fleet regress ==",
             f"{'host':<16} {'baselines':>9} {'active':>6} "
             f"{'verdicts':>8} last"]
    for r in rows:
        g = r["regress"]
        last = g.get("last") or {}
        last_s = (f"{last.get('signal')} [{last.get('cause')}] "
                  f"x{last.get('ratio')}"
                  + (" restart" if last.get("restart") else "")) \
            if last else "-"
        lines.append(
            f"{r['host']:<16} {g.get('baselines', 0):>9} "
            f"{g.get('active', 0):>6} {g.get('verdicts', 0):>8} "
            f"{last_s}"
            + (" [stale]" if r.get("stale") else ""))
    vote = fleet_regress_vote()
    if vote is not None:
        lines.append(
            f"vote: {vote['verdict']} ({len(vote['regressed'])}/"
            f"{vote['voters']} regressed: "
            + (", ".join(vote["regressed"]) or "-") + ")")
    return lines


# ---- reports ----------------------------------------------------------------

def _fmt_ms(s) -> str:
    return f"{1e3 * s:.3f}" if s is not None else "-"


def regress_report() -> str:
    """The /regressz (and /statusz `== regress ==`) text block: the
    per-signal baseline/CUSUM table, the verdict tail, and the
    evidence-bundle index."""
    lines = ["== regress =="]
    det = get_detector()
    if det is None:
        lines.append("no RegressionDetector installed "
                     "(singa_tpu_torch.regress.RegressionDetector(...)"
                     ".install())")
        return "\n".join(lines)
    snap = det.snapshot()
    cfg = snap["config"]
    lines.append(
        f"signals: {snap['n_signals']}  baselines "
        f"{snap['baselines']}  windows {snap['windows']}  verdicts "
        f"{snap['verdicts']}  active {len(snap['active'])}"
        f"  (window {cfg['window']}  k {cfg['k']}  h {cfg['h']}  "
        f"sustain {cfg['sustain']})")
    if snap["signals"]:
        lines.append(
            f"{'signal':<22} {'n':>6} {'base ms':>9} {'win ms':>9} "
            f"{'z':>6} {'cusum':>7} {'fp':<10} state")
        for r in sorted(snap["signals"], key=lambda r: r["signal"]):
            z = f"{r['z']:.2f}" if r["z"] is not None else "-"
            lines.append(
                f"{r['signal']:<22} {r['samples']:>6} "
                f"{_fmt_ms(r['baseline_median_s']):>9} "
                f"{_fmt_ms(r['window_median_s']):>9} "
                f"{z:>6} {r['cusum']:>7.2f} "
                f"{(r['fingerprint'] or '-')[:10]:<10} {r['state']}")
    verdicts = det.verdicts()[-6:]
    if verdicts:
        lines.append("verdicts:")
        for v in verdicts:
            lines.append(
                f"  {v['signal']}: {v['cause']}  "
                f"x{v['ratio']} (base {_fmt_ms(v['baseline_median_s'])}"
                f" -> {_fmt_ms(v['window_median_s'])} ms)  window "
                f"{v['window']}"
                + (" [restart]" if v.get("restart") else "")
                + (f"  bundle {os.path.basename(v['bundle'])}"
                   if v.get("bundle") else ""))
    if snap["bundles"]:
        lines.append("bundles: "
                     + ", ".join(os.path.basename(b)
                                 for b in snap["bundles"][-4:]))
    fl = fleetz_lines()
    if fl:
        lines.extend(fl)
    return "\n".join(lines)


def regress_json() -> dict:
    """The /regressz?json=1 body: the detector snapshot plus the full
    verdict ring."""
    det = get_detector()
    if det is None:
        return {"installed": False}
    return {"installed": True, "snapshot": det.snapshot(),
            "verdicts": det.verdicts()}


# ---- CLI: the injected-regression A/B ---------------------------------------
# `--ab` proves the whole loop end to end on one process, twice:
#
#   leg 1 (serving / contention): a tiny ServingEngine under a paced
#   request stream freezes the engine.step baseline over a clean
#   window (zero verdicts = the clean arm), then a FaultPlan delay on
#   the `serving.engine_step` fault point — which sits INSIDE the
#   decode-sync span — makes every sync slower while a burst deepens
#   the admission queue. Gate: conviction within 5 windows of the
#   injection, cause=contention.
#
#   leg 2 (training / compile): a tiny Linear net trains at batch 8
#   until model.step freezes (clean windows counted), then the batch
#   switches to 64: introspect fires a recompile blame, the manifest
#   fingerprint moves, and the bigger executable is genuinely slower
#   per step. Gate: conviction within 5 windows, cause=compile.
#
# Both verdicts' evidence bundles must round-trip through
# health.load_flight_bundle. Artifact: REGRESS_torch.json (+ the
# persisted REGRESS_torch_baselines.jsonl beside it). Both legs run on
# `--device`: the card by default; without one a `cuda` run raises.

def _ab_wait(det, signal, pred, timeout_s, tick):
    """Poll the detector until pred(state) or timeout; `tick()` drives
    the workload one beat. Returns the final state."""
    t0 = time.monotonic()
    st = det.signal_state(signal)
    while time.monotonic() - t0 < timeout_s:
        if st is not None and pred(st):
            return st
        tick()
        st = det.signal_state(signal)
    return st


def _ab_serving_leg(args, out_dir, store_path) -> dict:
    from . import engine as engine_mod
    from . import resilience
    from . import router as router_mod
    import numpy as np

    leg = {"name": "contention"}
    T = args.prompt_hi + args.new_tokens + 8
    m = router_mod._build_replica_model(args.vocab, args.dim,
                                        args.layers, T, args.device)
    eng = engine_mod.ServingEngine(
        m, max_slots=args.slots, page_size=8, max_ctx=T,
        queue_limit=1024).start()
    det = RegressionDetector(
        BaselineStore(store_path),
        warmup_samples=args.warmup, window=args.window, sustain=2,
        out_dir=out_dir).install()
    rng = np.random.RandomState(args.seed)

    def submit(n):
        hs = []
        for _ in range(n):
            p = rng.randint(0, args.vocab,
                            rng.randint(args.prompt_lo,
                                        args.prompt_hi)).astype(np.int32)
            hs.append(eng.submit(p, args.new_tokens))
        return hs

    def drain(hs):
        for h in hs:
            h.wait(args.timeout)

    try:
        # clean arm: keep the engine busy until the baseline freezes
        # and a few clean windows close — every verdict here is a
        # false positive
        def busy():
            drain(submit(args.slots))

        st = _ab_wait(
            det, "engine.step",
            lambda s: s["state"] != "warmup"
            and s["windows"] >= args.clean_windows,
            args.timeout, busy)
        leg["frozen"] = st is not None and st["state"] != "warmup"
        leg["clean_windows"] = (st or {}).get("windows", 0)
        leg["false_positives"] = len(det.verdicts())
        w0 = (st or {}).get("windows", 0)
        # inject: a sustained per-sync stall inside the engine_step
        # span, plus a burst that deepens the queue past its freeze
        # level — slower at the same work, with contention evidence
        resilience.install_fault_plan(
            resilience.FaultPlan().delay("serving.engine_step",
                                         args.step_delay,
                                         times=10 ** 9))
        burst = submit(args.burst)

        def refill():
            time.sleep(0.05)
            if eng.report()["queue_depth"] < args.slots:
                burst.extend(submit(args.slots * 2))

        st = _ab_wait(det, "engine.step",
                      lambda s: s["verdicts"] > leg["false_positives"],
                      args.timeout, refill)
        resilience.clear_fault_plan()
        drain(burst)
        v = next((x for x in det.verdicts()
                  if x["signal"] == "engine.step"), None)
        leg["detected"] = v is not None
        leg["detect_windows"] = (v["window"] - w0) if v else None
        leg["cause"] = v["cause"] if v else None
        leg["ratio"] = v["ratio"] if v else None
        leg["bundle"] = v.get("bundle") if v else None
        leg["verdicts"] = len(det.verdicts())
        leg["report_has_table"] = "base ms" in regress_report()
    finally:
        resilience.clear_fault_plan()
        uninstall()
        eng.stop()
        engine_mod.reset()
    return leg


def _ab_training_leg(args, out_dir, store_path) -> dict:
    from . import device, layer, model as model_mod, opt, tensor
    import numpy as np

    leg = {"name": "compile"}
    dev = device.of(device.resolve(args.device))
    # On the card the model.step span covers dispatch only unless
    # something fences inside it; verbosity>0 synchronizes within the
    # span, so the detector's samples measure the step's real wall time
    # and the rebuilt batch_hi variant's extra cost is visible to the
    # CUSUM.
    dev.SetVerbosity(1)
    dev.SetSkipIteration(0)

    class Net(model_mod.Model):
        def __init__(self):
            super().__init__()
            self.fc1 = layer.Linear(args.hidden)
            self.relu = layer.ReLU()
            self.fc2 = layer.Linear(8)
            self.sce = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc2(self.relu(self.fc1(x)))

        def train_one_batch(self, x, y):
            loss = self.sce(self.forward(x), y)
            self.optimizer(loss)
            return loss

    rng = np.random.RandomState(args.seed)

    def batch(n):
        x = rng.standard_normal((n, args.features)).astype(np.float32)
        y = rng.randint(0, 8, n).astype(np.int32)
        return (tensor.from_numpy(x, dev), tensor.from_numpy(y, dev))

    net = Net()
    net.set_optimizer(opt.SGD(lr=0.05))
    tx8, ty8 = batch(args.batch_lo)
    net.compile([tx8], is_train=True, use_graph=True)
    det = RegressionDetector(
        BaselineStore(store_path),
        warmup_samples=args.warmup, window=args.window, sustain=2,
        out_dir=out_dir).install()
    try:
        def step8():
            net.train_one_batch(tx8, ty8)

        st = _ab_wait(
            det, "model.step",
            lambda s: s["state"] != "warmup"
            and s["windows"] >= args.clean_windows,
            args.timeout, step8)
        leg["frozen"] = st is not None and st["state"] != "warmup"
        leg["clean_windows"] = (st or {}).get("windows", 0)
        leg["false_positives"] = len(det.verdicts())
        w0 = (st or {}).get("windows", 0)
        # inject: a batch-size switch forces a rebuild — introspect
        # fires a recompile blame and the manifest fingerprint moves —
        # and the batch_hi step is genuinely slower
        tx64, ty64 = batch(args.batch_hi)

        def step64():
            net.train_one_batch(tx64, ty64)

        st = _ab_wait(det, "model.step",
                      lambda s: s["verdicts"] > leg["false_positives"],
                      args.timeout, step64)
        v = next((x for x in det.verdicts()
                  if x["signal"] == "model.step"), None)
        leg["detected"] = v is not None
        leg["detect_windows"] = (v["window"] - w0) if v else None
        leg["cause"] = v["cause"] if v else None
        leg["ratio"] = v["ratio"] if v else None
        leg["bundle"] = v.get("bundle") if v else None
        leg["verdicts"] = len(det.verdicts())
    finally:
        uninstall()
    return leg


def _ab_main(args) -> int:
    from . import diag
    from . import health as health_mod
    from .fleet import _require_device
    _require_device(args.device)
    rec = {"seed": args.seed, "device": args.device, "ok": False}
    out_dir = os.path.dirname(os.path.abspath(args.out)) or "."
    store_path = os.path.join(out_dir, "REGRESS_torch_baselines.jsonl")
    if os.path.exists(store_path):
        os.remove(store_path)
    # On the CPU both legs run one intra-op thread: at these widths (a
    # dim-64 engine, a 512-wide MLP) torch's OpenMP team jitters a step's
    # host time, and a clean arm convicted in 3 of 6 runs at 8 threads on
    # an 8-core host (0 of 6 at one). One window whose median is ~1.25x
    # the baseline is enough, in JAX's detector as in this one: z 5 at
    # the 5% sigma floor takes the CUSUM past h, it decays by only k a
    # window, and the next window completes `sustain`. On the card the
    # device does the work: nothing is set.
    import torch
    threads = torch.get_num_threads()
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)
    diag.start_diag_server(port=0)
    try:
        # each leg gets its own bundle directory so the two detectors'
        # flight_regress_<n>.jsonl sequences cannot collide
        serving = _ab_serving_leg(
            args, os.path.join(out_dir, "REGRESS_torch_bundles",
                               "serving"), store_path)
        training = _ab_training_leg(
            args, os.path.join(out_dir, "REGRESS_torch_bundles",
                               "compile"), store_path)
        rec["serving"] = serving
        rec["training"] = training
        # the bundle contract: every conviction's bundle round-trips
        # through load_flight_bundle with the verdict in the header
        bundle_ok = False
        bpath = serving.get("bundle") or training.get("bundle")
        if bpath and os.path.isfile(bpath):
            b = health_mod.load_flight_bundle(bpath)
            bundle_ok = (
                b["header"].get("kind") == "flight_header"
                and b["header"].get("reason") == "regression"
                and isinstance(b["header"].get("verdict"), dict)
                and len(b["steps"]) > 0)
        rec["bundle_roundtrip"] = bundle_ok
        fps = (serving.get("false_positives", 0)
               + training.get("false_positives", 0))
        rec["false_positives"] = fps
        rec["baselines_persisted"] = os.path.isfile(store_path)
        rec["ok"] = bool(
            serving.get("detected")
            and serving.get("cause") == CAUSE_CONTENTION
            and serving.get("detect_windows") is not None
            and serving["detect_windows"] <= 5
            and training.get("detected")
            and training.get("cause") == CAUSE_COMPILE
            and training.get("detect_windows") is not None
            and training["detect_windows"] <= 5
            and fps == 0
            and bundle_ok
            and serving.get("report_has_table")
            and rec["baselines_persisted"])
    finally:
        reset()
        diag.stop_diag_server()
        torch.set_num_threads(threads)
    lines = [
        {"metric": "regress_contention_detect_windows",
         "value": float(rec.get("serving", {}).get("detect_windows")
                        or 99.0), "unit": "windows"},
        {"metric": "regress_compile_detect_windows",
         "value": float(rec.get("training", {}).get("detect_windows")
                        or 99.0), "unit": "windows"},
        {"metric": "regress_false_positives",
         "value": float(rec.get("false_positives") or 0.0),
         "unit": "count"},
        {"metric": "regress_bundle_roundtrip",
         "value": 1.0 if rec.get("bundle_roundtrip") else 0.0,
         "unit": "bool"},
        rec,
    ]
    with open(args.out, "w", encoding="utf-8") as f:
        for obj in lines:
            f.write(json.dumps(obj, sort_keys=True, default=str) + "\n")
    print(json.dumps(rec, indent=2, sort_keys=True, default=str))
    return 0 if rec["ok"] else 1


#: the --ab training leg's defaults by device: (features, hidden,
#: batch_lo, batch_hi). The CPU's are JAX's. On the card a 512-wide MLP's
#: batch-8 step is host-bound, and its batch-512 step came within
#: 1.17-1.62x of it (one run convicted only after 20 windows, x1.1693):
#: the card's leg is a 4096-wide MLP at batch 1024 then 8192, both
#: device-bound.
_TRAIN_LEG = {"cpu": (512, 512, 8, 512), "cuda": (4096, 4096, 1024, 8192)}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m singa_tpu_torch.regress",
        description="performance regression observatory: --ab runs "
                    "the injected-regression harness (contention + "
                    "compile legs, clean arms gated on zero false "
                    "positives)")
    p.add_argument("--ab", action="store_true")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--warmup", type=int, default=16)
    p.add_argument("--window", type=int, default=4)
    p.add_argument("--clean-windows", type=int, default=3)
    # serving leg
    p.add_argument("--vocab", type=int, default=211)
    p.add_argument("--dim", type=int, default=64,
                   help="model width (4 heads); on the card 256 or 512, "
                        "the flash kernel's head widths 64 and 128")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--prompt-lo", type=int, default=4)
    p.add_argument("--prompt-hi", type=int, default=12)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--step-delay", type=float, default=0.05,
                   help="per-decode-sync stall injected at the "
                        "serving.engine_step fault point (inside the "
                        "span the detector watches)")
    p.add_argument("--burst", type=int, default=32,
                   help="requests submitted at the injection edge so "
                        "the admission queue deepens past its "
                        "baseline level (the contention evidence)")
    # training leg (unset: _TRAIN_LEG's row for the device)
    p.add_argument("--features", type=int)
    p.add_argument("--hidden", type=int)
    p.add_argument("--batch-lo", type=int)
    p.add_argument("--batch-hi", type=int)
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where both legs run")
    p.add_argument("--out", default="REGRESS_torch.json")
    args = p.parse_args(argv)
    import torch
    for k, v in zip(("features", "hidden", "batch_lo", "batch_hi"),
                    _TRAIN_LEG[torch.device(args.device).type]):
        if getattr(args, k) is None:
            setattr(args, k, v)
    if args.ab:
        return _ab_main(args)
    p.error("pick a mode: --ab")
    return 2


__all__ = [
    "REGRESS_CAUSES",
    "BaselineStore", "RegressionDetector",
    "install", "get_detector", "uninstall", "reset",
    "fleet_regress_snapshot", "fleet_regress_vote", "fleetz_lines",
    "regress_report", "regress_json",
]

if __name__ == "__main__":
    # run under the CANONICAL module (not the runpy __main__ alias): the
    # CLI installs the module singleton the diag/fleet layers reach via
    # `import singa_tpu_torch.regress`
    from singa_tpu_torch.regress import main as _main
    sys.exit(_main())
