"""Goodput accounting (counterpart of singa_tpu/goodput.py): where did
the wall-clock go?

`GoodputTracker` classifies run wall time into a FIXED bucket enum
(`GOODPUT_BUCKETS`, the declared tuple tools/check_metrics_names.py
lints the `bucket=` label against):

  step        productive train-step execution (serving decode counts
              here too: in a serving job, decoding IS the goodput)
  compile     a new step signature's warm-up and CUDA-graph capture
              (`model.build`) and the kernel libraries' nvcc builds
              (`introspect.build`, around each build in `ops._build`)
  data_wait   host blocked fetching the next batch (`Model.fit`'s fetch
              span, the prefetch ring's wait, the data iterators' waits)
  checkpoint  save/load of states and checkpoints, the async-save barrier
  eval        graph-mode eval forwards (`model.eval`)
  health_skip steps whose update the health layer discarded: the step
              ran, but produced nothing
  other       wall time nothing above claims (flushed as the residual
              against the run clock at snapshot time)

It is fed by `observe.add_span_listener`: the spans already in model.py,
ops/_build.py, data.py, overlap.py and serving.py / engine.py attribute
time with no re-instrumentation. Attribution is NET of nested mapped
spans: a `model.build` inside `model.step` charges `compile`, and the
step span charges only its remainder, so bucket sums track wall time
instead of double-counting. A finished `model.step` span is held PENDING
until the next step span so the health layer can reclassify a discarded
update into `health_skip` (`mark_step_skipped`, called by the graph-mode
step after the monitor's verdict "skip"); a concurrent scrape cannot
steal the hold, and in-flight mapped spans are reserved at snapshot time
so a mid-build scrape books nothing twice. `introspect.warm_load` (a
warm-store lookup, `warmstart`) books `compile` too; `model.jit_fallback`
keeps its JAX mapping and has no site in the port.

Two measurement boundaries, stated rather than hidden: (1) the card runs
asynchronously, so the step span is honest when something fences it:
the health monitor's packed-stats read or the verbosity profiling's
synchronize, both inside the span; with neither, only dispatch time is
attributable and the device time surfaces in `other` at the caller's
own sync point. (2) concurrent threads (training + serving) each
attribute their own wall time, so bucket sums can exceed one run
clock; the snapshot reports that as `overlap_s` instead of clamping it
away.

Exports: `singa_time_seconds_total{bucket=...}` (one series per enum
bucket from install time, so a scrape always shows the full breakdown),
a rolling-window `singa_goodput_ratio` gauge, and `goodput_report()`,
the text block a status page serves.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from . import observe

#: The fixed wall-time classification. `bucket=` label values are
#: lint-checked against this tuple (tools/check_metrics_names.py rule 5).
GOODPUT_BUCKETS = ("step", "compile", "data_wait", "checkpoint", "eval",
                   "health_skip", "other")
BUCKET_STEP = "step"
BUCKET_COMPILE = "compile"
BUCKET_DATA_WAIT = "data_wait"
BUCKET_CHECKPOINT = "checkpoint"
BUCKET_EVAL = "eval"
BUCKET_HEALTH_SKIP = "health_skip"
BUCKET_OTHER = "other"

#: same-bucket commits landing within one tick merge into a single
#: rolling-window entry; with the hard cap below this bounds the
#: window's memory on high-rate span streams (kHz serving decodes)
_WINDOW_TICK_S = 0.25
_WINDOW_MAX_ENTRIES = 200_000

#: span LEAF name -> bucket (the JAX package's table). The listener sees
#: the slash-joined path;
#: classification keys on the last component, and nested mapped spans
#: are netted out of their nearest mapped ancestor.
SPAN_BUCKETS = {
    "model.step": BUCKET_STEP,
    "serving.decode": BUCKET_STEP,
    "serving.prefill": BUCKET_STEP,
    "serving.decode_scan": BUCKET_STEP,
    "serving.beam_decode": BUCKET_STEP,
    "model.build": BUCKET_COMPILE,
    "introspect.build": BUCKET_COMPILE,
    # a warm restart's read of stored builds and kernel libraries is
    # still compile-bucket time (there is just little of it)
    "introspect.warm_load": BUCKET_COMPILE,
    "model.jit_fallback": BUCKET_COMPILE,
    "data.wait": BUCKET_DATA_WAIT,
    "snapshot.flush": BUCKET_CHECKPOINT,
    "snapshot.load": BUCKET_CHECKPOINT,
    "checkpoint.save": BUCKET_CHECKPOINT,
    "checkpoint.load": BUCKET_CHECKPOINT,
    # async-ckpt barrier (overlap.wait_for_checkpoints): the only other
    # blocking portion of an async save — the overlapped background
    # write itself is deliberately unspanned (it is the reclaimed time)
    "checkpoint.wait": BUCKET_CHECKPOINT,
    "model.eval": BUCKET_EVAL,
}


def _time_counter():
    return observe.counter(
        "singa_time_seconds_total",
        "run wall seconds classified by goodput bucket")


class GoodputTracker:
    """Classifies wall time since `start` into GOODPUT_BUCKETS.

    Thread-safe; the span feed is per-thread (span stacks are
    thread-local) but commits land under one lock. Metric objects are
    re-resolved on every commit so a registry reset (tests) cannot leave
    the tracker writing to orphaned series.
    """

    def __init__(self, window_s: float = 300.0,
                 pending_grace_s: float = 30.0):
        self.window_s = float(window_s)
        # how long a verdict-awaiting step may stay held before a
        # snapshot commits it anyway — the verdict window is at most
        # one step's host sync, so past this the run simply stopped
        # stepping and the counter must not under-report forever
        self.pending_grace_s = float(pending_grace_s)
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._totals = {b: 0.0 for b in GOODPUT_BUCKETS}
        self._window = deque()   # (monotonic ts, bucket, seconds)
        self._wstep_sum = 0.0    # running step-seconds inside _window
        # thread id -> (net seconds, exit ts) of that thread's last
        # model.step span, held until its health verdict (only the
        # training thread's own next step, mark_step_skipped, or a
        # post-grace snapshot resolves it — a serving thread's
        # step-bucket commit cannot steal the hold)
        self._pending = {}
        self._open = {}  # (thread id, span path) -> enter monotonic ts
        # (thread id, OPEN ancestor path) -> seconds its exited children
        # already committed: that time sits in _totals AND inside the
        # ancestor's in-flight reservation, so snapshot must not count
        # it twice when flushing the `other` residual
        self._open_charged = {}
        # wall clock up to which snapshot() has fully accounted the run
        # (its residual flush covers [t0, now] cumulatively); a span
        # whose ENTER predates install commits only its tail past this
        self._accounted_until = self._t0
        self._tls = threading.local()
        if observe.is_enabled():
            c = _time_counter()
            for b in GOODPUT_BUCKETS:
                c.inc(0.0, bucket=b)  # every enum bucket scrapes from t0

    # -- feeding -----------------------------------------------------------
    def add(self, bucket: str, seconds: float):
        """Attribute `seconds` of wall time to `bucket` (enum-checked)."""
        if bucket not in GOODPUT_BUCKETS:
            raise ValueError(
                f"bucket {bucket!r} not in GOODPUT_BUCKETS {GOODPUT_BUCKETS}")
        with self._lock:
            self._commit_locked(bucket, float(seconds))

    def on_span_enter(self, path: str):
        """observe span ENTER listener: reserve in-flight mapped spans
        so a snapshot taken mid-span (a /metrics scrape during a long
        compile) books their elapsed time neither to `other` now nor
        twice when the span exits."""
        if SPAN_BUCKETS.get(path.rsplit("/", 1)[-1]) is None:
            return
        with self._lock:
            self._open[(threading.get_ident(), path)] = time.monotonic()

    def on_span(self, path: str, seconds: float, attrs: dict):
        """observe span exit listener: classify one finished span by its
        leaf name, net of any nested mapped spans (children exit first,
        so each mapped child has already charged its gross time against
        this path)."""
        parts = path.split("/")
        bucket = SPAN_BUCKETS.get(parts[-1])
        if bucket is None:
            # unmapped spans hold no tracker state — _open only ever
            # holds mapped paths (on_span_enter filters) and charged
            # keys always have mapped leaves — so skip the global lock:
            # per-epoch/user spans must not contend with a snapshot()
            # scrape holding it
            charged = getattr(self._tls, "charged", None)
            if charged is not None:
                charged.pop(path, None)
            return
        seconds = float(seconds)
        tid = threading.get_ident()
        charged = getattr(self._tls, "charged", None)
        if charged is None:
            charged = self._tls.charged = {}
        # ONE lock acquisition from reservation-pop to commit: a scrape
        # landing between them would see the span in neither _open nor
        # _totals and double-book it (residual to `other` + this commit)
        with self._lock:
            entered_at = self._open.pop((tid, path), None)
            if entered_at is None:
                # a span already open when the tracker was installed
                # mid-run (its enter was never seen): everything up to
                # the last residual flush is already accounted — and a
                # scrape couldn't reserve it — so commit only the
                # unaccounted tail, not the pre-install/pre-flush time
                seconds = min(seconds,
                              max(0.0, time.monotonic()
                                  - self._accounted_until))
            net = seconds - charged.pop(path, 0.0)
            # charge this span's GROSS time to its nearest mapped
            # ancestor so the ancestor commits only its own remainder
            anc = None
            for i in range(len(parts) - 1, 0, -1):
                if SPAN_BUCKETS.get(parts[i - 1]) is not None:
                    anc = "/".join(parts[:i])
                    charged[anc] = charged.get(anc, 0.0) + seconds
                    break
            self._open_charged.pop((tid, path), None)
            if anc is not None and (tid, anc) in self._open \
                    and parts[-1] != "model.step":
                # the ancestor is still in flight: mirror the charge so
                # a mid-span snapshot reserves only its unattributed
                # remainder (the committed child is in _totals already).
                # A held model.step is excluded — its time sits in
                # _pending, which snapshot already subtracts
                self._open_charged[(tid, anc)] = \
                    self._open_charged.get((tid, anc), 0.0) + seconds
            if net <= 0.0:
                return
            if parts[-1] == "model.step":
                # hold: the health verdict for this step lands right
                # after the span exits and may reclassify it. Only THIS
                # thread's next step (verdict already delivered) commits
                # the previous hold — a concurrent scrape or another
                # thread's step-bucket span cannot steal it.
                prev = self._pending.pop(tid, None)
                if prev is not None:
                    self._commit_locked(BUCKET_STEP, prev[0])
                self._pending[tid] = (net, time.monotonic())
            else:
                # serving.* spans are bucket `step` too but never get a
                # verdict: commit directly
                self._commit_locked(bucket, net)

    def mark_step_skipped(self):
        """Reclassify the calling thread's pending step as health_skip —
        called by Model (from the training thread, right after the step)
        once the HealthMonitor's verdict is 'skip'."""
        with self._lock:
            held = self._pending.pop(threading.get_ident(), None)
            if held is not None:
                self._commit_locked(BUCKET_HEALTH_SKIP, held[0])

    # -- internals (lock held) ---------------------------------------------
    def _commit_locked(self, bucket, seconds):
        assert bucket in GOODPUT_BUCKETS
        now = time.monotonic()
        self._totals[bucket] += seconds
        if observe.is_enabled():
            _time_counter().inc(seconds, bucket=bucket)
        w = self._window
        if w and w[-1][1] == bucket and now - w[-1][0] < _WINDOW_TICK_S:
            # coalesce bursts (a serving job streaming short decodes
            # commits step entries at kHz): same bucket within one tick
            # merges, bounding the deque at ~window/tick entries per
            # alternation instead of one tuple per commit
            ts, b, s = w[-1]
            w[-1] = (ts, b, s + seconds)
        else:
            w.append((now, bucket, seconds))
            if len(w) > _WINDOW_MAX_ENTRIES:
                # hard backstop for pathological alternation: shed the
                # oldest entry (coarsens the rolling ratio, never the
                # cumulative totals/counters)
                _ts, b0, s0 = w.popleft()
                if b0 == BUCKET_STEP:
                    self._wstep_sum -= s0
        if bucket == BUCKET_STEP:
            self._wstep_sum += seconds
        self._update_ratio_locked(now)

    def _prune_window_locked(self, now) -> float:
        """Drop window entries older than the horizon, keeping the
        running step-seconds accumulator in sync (O(expired), not
        O(window) — this runs on every commit)."""
        horizon = now - self.window_s
        w = self._window
        while w and w[0][0] < horizon:
            _ts, b, s = w.popleft()
            if b == BUCKET_STEP:
                self._wstep_sum -= s
        return horizon

    def _update_ratio_locked(self, now):
        horizon = self._prune_window_locked(now)
        span = now - max(self._t0, horizon)
        if span <= 0.0:
            return
        ratio = min(1.0, max(0.0, self._wstep_sum) / span)
        if observe.is_enabled():
            observe.gauge(
                "singa_goodput_ratio",
                "productive (step) share of wall time over the rolling "
                "window").set(ratio)

    def _sync_counters_locked(self):
        """Catch the exported counters up to _totals. Commits during an
        observe.enable(False) window update _totals but skip the inc
        (disabled means no metric writes), and a test-style registry
        reset zeroes the series — either way the next enabled scrape
        must restore the invariant that counter sums track the clock."""
        if not observe.is_enabled():
            return
        c = _time_counter()
        for b in GOODPUT_BUCKETS:
            delta = self._totals[b] - c.value(bucket=b)
            # inc even when the delta is 0: a registry reset dropped the
            # __init__ seeding, and every enum bucket must stay present
            # in /metrics
            c.inc(max(delta, 0.0), bucket=b)

    def _reserved_locked(self, now) -> float:
        """Elapsed seconds of in-flight mapped spans (outermost per
        nesting chain — the interior splits among buckets but sums to
        the outermost gross), which their exits will attribute later."""
        items = list(self._open.items())
        r = 0.0
        for (tid, path), t0 in items:
            if any(t2 == tid and path.startswith(p2 + "/")
                   for (t2, p2), _ in items if p2 != path):
                continue  # an open mapped ancestor already covers it
            r += max(0.0, now - t0)
        # exited children of still-open spans already committed their
        # time to _totals; it also lies inside the reservation interval
        # above — subtract so the residual flush books it exactly once
        r -= sum(self._open_charged.values())
        return max(0.0, r)

    # -- reading -----------------------------------------------------------
    def snapshot(self, final: bool = False) -> dict:
        """Totals per bucket + the run clock. Flushes the unattributed
        residual into `other` — wall time minus committed buckets minus
        the pending step minus in-flight mapped spans — so bucket sums
        track elapsed wall time without double-booking time a later
        span exit (or step commit) will attribute. The reported `step`
        includes the pending (verdict-awaiting) step; the counter picks
        it up when the next step commits it."""
        with self._lock:
            now = time.monotonic()
            wall = now - self._t0
            # a hold past the grace — or any hold on a `final` snapshot
            # (end of run: no verdict is coming) — commits so the
            # counters stop under-reporting the last step
            for tid, (net, ts) in list(self._pending.items()):
                if final or now - ts > self.pending_grace_s:
                    del self._pending[tid]
                    self._commit_locked(BUCKET_STEP, net)
            pending = sum(net for net, _ts in self._pending.values())
            gap = wall - sum(self._totals.values()) - pending \
                - self._reserved_locked(now)
            if gap > 0.0:
                self._commit_locked(BUCKET_OTHER, gap)
            # the run clock is now fully accounted up to here (flushed,
            # pending-held, or reserved) — pre-install spans exiting
            # later commit only their tail past this point
            self._accounted_until = now
            self._sync_counters_locked()
            # concurrent threads (train + serve) each attribute their
            # own wall time, so sums CAN exceed one run clock; surface
            # the overlap instead of hiding it behind the clamp
            overlap = max(0.0, -gap)
            buckets = dict(self._totals)
            buckets[BUCKET_STEP] += pending
            ratio = buckets[BUCKET_STEP] / wall if wall > 0 else 0.0
            # prune here too: a long in-flight span can suppress commits
            # (the usual prune site) for a whole window, and stale step
            # entries would overstate the live ratio during the stall
            horizon = self._prune_window_locked(now)
            wspan = now - max(self._t0, horizon)
            wstep = pending + max(0.0, self._wstep_sum)
        return {
            "wall_s": wall,
            "buckets": buckets,
            "goodput_ratio": min(1.0, ratio),
            "overlap_s": overlap,
            "window_s": self.window_s,
            "window_goodput_ratio": min(1.0, wstep / wspan)
            if wspan > 0 else 0.0,
        }

    def report(self) -> str:
        """The human-readable breakdown /statusz serves."""
        snap = self.snapshot()
        wall = snap["wall_s"]
        lines = [
            "== goodput ==",
            f"wall: {wall:.3f} s   goodput(step): "
            f"{snap['goodput_ratio'] * 100:.1f}%   "
            f"window({snap['window_s']:.0f}s): "
            f"{snap['window_goodput_ratio'] * 100:.1f}%",
        ]
        for b in GOODPUT_BUCKETS:
            s = snap["buckets"][b]
            pct = (s / wall * 100.0) if wall > 0 else 0.0
            lines.append(f"  {b:<12} {s:>10.3f} s  {pct:>5.1f}%")
        if snap["overlap_s"] > 0.05:
            lines.append(
                f"  (concurrent-thread overlap: {snap['overlap_s']:.3f} s"
                " — train + serve threads attribute wall time "
                "independently)")
        return "\n".join(lines)


# ---- module singleton ------------------------------------------------------

_tracker: "GoodputTracker | None" = None
# install/uninstall are check-then-act on the global: without a lock,
# a training thread's install() racing the diag server's would leave
# the loser's listener subscribed forever (every span double-booked)
_install_lock = threading.Lock()


def install(window_s: "float | None" = None,
            pending_grace_s: "float | None" = None) -> GoodputTracker:
    """Create (or return) the process tracker and subscribe it to span
    exits. Idempotent and thread-safe. An explicitly passed window/grace
    is applied to an already-installed tracker too (a later default-args
    install never stomps them)."""
    global _tracker
    with _install_lock:
        return _install_locked(window_s, pending_grace_s)


def _install_locked(window_s, pending_grace_s):
    global _tracker
    if _tracker is None:
        _tracker = GoodputTracker(
            window_s=300.0 if window_s is None else window_s,
            pending_grace_s=30.0 if pending_grace_s is None
            else pending_grace_s)
        observe.add_span_listener(_tracker.on_span,
                                  on_enter=_tracker.on_span_enter)
    else:
        if window_s is not None:
            _tracker.window_s = float(window_s)
        if pending_grace_s is not None:
            _tracker.pending_grace_s = float(pending_grace_s)
    return _tracker


def uninstall():
    """Drop the tracker and its span subscription (test teardown)."""
    global _tracker
    with _install_lock:
        if _tracker is not None:
            observe.remove_span_listener(_tracker.on_span)
            _tracker = None


def get_tracker() -> "GoodputTracker | None":
    return _tracker


def mark_step_skipped():
    """Forward to the installed tracker (no-op when tracking is off)."""
    if _tracker is not None:
        _tracker.mark_step_skipped()


def goodput_report() -> str:
    """Text breakdown, or a how-to-enable hint when tracking is off."""
    if _tracker is None:
        return ("goodput tracking not installed "
                "(singa_tpu_torch.goodput.install())")
    return _tracker.report()


__all__ = [
    "GOODPUT_BUCKETS", "SPAN_BUCKETS", "GoodputTracker",
    "BUCKET_STEP", "BUCKET_COMPILE", "BUCKET_DATA_WAIT",
    "BUCKET_CHECKPOINT", "BUCKET_EVAL", "BUCKET_HEALTH_SKIP",
    "BUCKET_OTHER",
    "install", "uninstall", "get_tracker", "mark_step_skipped",
    "goodput_report",
]
