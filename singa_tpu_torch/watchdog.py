"""Operation deadlines, hang forensics and abort (counterpart of
singa_tpu/watchdog.py).

Crash recovery sees what raises or signals; nothing sees an operation
that never returns: a data producer stuck on a dead queue, an async
checkpoint barrier waiting on a write that will never land, a step whose
fence never completes, a serving sync wedged in its decode. This module
gives every blocking operation a deadline and walks an escalation ladder
when one is missed:

  - **DEADLINE_OPS / guard(op)**: each blocking operation class gets an
    armed/disarmed guard at the existing span sites: the train step
    (`Model._train_step`, around the buffered step and the health
    monitor's stats read, which is the step's fence on the card), the
    fetch in `Model.fit`, the prefetch ring's wait and the async
    checkpoint barrier (`overlap`), the data iterators' waits (`data`),
    the blocking device-to-host part of `Model.save_checkpoint`, and
    serving decode (`serving`'s decode calls, the engine's prefill and
    sync). Deadlines are warmup-calibrated from the operation's own
    observed durations, clamp(p99 x multiplier, floor, ceiling), with
    build time excluded: a guard that sees a `model.build` (a new step
    signature's warm-up or CUDA-graph capture) or `introspect.build`
    (an nvcc build and load of a kernel library, `ops._build`) span open
    inside it is *tainted*: it neither feeds calibration nor breaches.
    Static per-op overrides via `deadlines={op: seconds}`.

  - **The `singa-watchdog-<pid>` daemon thread** polls the armed table
    and, when an operation is past its deadline, walks the ESCALATION
    ladder (capped by `action=`):
      1. "warn"  -> `singa_watchdog_breach_total{op=}` + an event record
      2. "dump"  -> a HANG BUNDLE, `flight_hang_<op>_<n>.jsonl`: every
                    thread's Python stack (`sys._current_frames`, with a
                    `faulthandler` sidecar), the memory ledger's region
                    breakdown and the goodput snapshot, so the
                    post-mortem NAMES the wedged frame
      3. "abort" -> `HealthMonitor.note_external(KIND_HANG)` and a
                    `HangError(HealthError, op=, seconds=)` delivered to
                    the wedged thread: cooperatively at guard exit (the
                    moment the stuck call returns), with a hard fallback
                    past `hard_at` (an async exception injected into the
                    thread, or a real signal).

An async exception lands at the thread's next bytecode: it cannot
interrupt a running CUDA kernel or a C call that released the GIL (a
device-to-host copy, `torch.cuda.synchronize()`), so it arrives when that
call returns, as the guard exit's cooperative raise does. A hard abort is
never injected into a thread inside a CUDA-graph capture: a capture runs
under `model.build`, which taints the guard first, and the checker skips
tainted entries before it looks at their deadline.

Every breach path is driven deterministically by `resilience.FaultPlan`
delays at the existing fault points ("serving.engine_step",
"serving.decode", "data.next", "ckpt.wait", and the controller's "step"
and "ckpt.save"). The hang bundle's `executables` are the last eight
builds of `introspect`'s manifest. The `collective` guard arms around
every verb of `parallel.Communicator` (its `_comm_stamp`, with the fault
point "comm.collective"). The `fleet_publish` guard arms around every
`fleet.ShardWriter.publish`, and a hang bundle written while a
`fleet.FleetAggregator` is installed carries its rollup (`hang_fleet`).
CLI: `python -m singa_tpu_torch.watchdog --ab [--device cpu]` is the
multi-process hang A/B: three `--worker` processes on `--device` (the card
by default) train a small MLP under a TrainController with the
`collective` guard armed over a per-step `Communicator().all_reduce`; one
worker's collective is wedged by a FaultPlan delay and must abort and
restore, the others learn of the hang through the fleet spool and restore
in lockstep, and the coordinator checks detection and the coordinated
recovery from its own /fleetz and /stackz (HANG_torch.json).
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys
import threading
import time
import traceback
from collections import deque

from . import goodput, health, introspect, memory, observe

#: every blocking operation class that can carry a deadline. The `op=`
#: label on every singa_watchdog_* metric is proven against this tuple
#: (tools/check_metrics_names.py rule 5).
DEADLINE_OPS = ("step", "collective", "data_wait", "ckpt_save",
                "ckpt_wait", "decode", "fleet_publish")

#: the escalation ladder, in order; `action=` caps how far a breach
#: climbs (action="warn" never dumps, "dump" never aborts)
ESCALATION = ("warn", "dump", "abort")

#: span leaf names whose presence inside an armed guard marks it as
#: containing build time: the sample is excluded from calibration and
#: the entry from breach checks. A first call's nvcc build, warm-up and
#: CUDA-graph capture legitimately take tens of seconds, and booking
#: them as a hang would abort healthy runs (`model.jit_fallback` is the
#: JAX package's leaf and has no site in the port)
_BUILD_SPAN_LEAVES = ("model.build", "introspect.build",
                      "model.jit_fallback")

_BUNDLE_PREFIX = "flight_hang"  # beside the flight_step* bundles


class HangError(health.HealthError):
    """An operation exceeded its watchdog deadline and was aborted.

    A HealthError subclass so it rides the existing supervision plumbing
    (Model.fit attaches partial progress); a hang says nothing about the
    numerics, only that a dependency wedged. `op`/`seconds` name the
    breached operation; `hosts` names peers when the hang is a PEER's
    (`fleet.check_straggler_halt` fills it from the aggregator's
    peer-hang verdict)."""

    def __init__(self, msg="operation exceeded its watchdog deadline",
                 op=None, seconds=None, bundle_path=None, hosts=()):
        super().__init__(msg, bundle_path=bundle_path)
        self.op = op
        self.seconds = seconds
        self.hosts = tuple(hosts)


# ---- metrics ---------------------------------------------------------------

def _metrics():
    # observe.counter/gauge spelled out so the static lint sees every
    # registration; every op= value recorded below is a member of
    # DEADLINE_OPS (validated in _check_op)
    return {
        "breach": observe.counter(
            "singa_watchdog_breach_total",
            "operation-deadline breaches by op (the warn stage)"),
        "dump": observe.counter(
            "singa_watchdog_dump_total",
            "hang bundles written by op (the dump stage)"),
        "abort": observe.counter(
            "singa_watchdog_abort_total",
            "hang aborts delivered by op (the abort stage)"),
        "hard": observe.counter(
            "singa_watchdog_hard_abort_total",
            "hard abort fallbacks (async exception / signal) by op"),
        "armed": observe.gauge(
            "singa_watchdog_armed",
            "operations currently armed with a deadline"),
        "deadline": observe.gauge(
            "singa_watchdog_deadline_seconds",
            "current (calibrated or static) deadline per op"),
    }


def _check_op(op: str) -> str:
    if op not in DEADLINE_OPS:
        raise ValueError(f"op {op!r} not in DEADLINE_OPS {DEADLINE_OPS}")
    return op


# ---- all-thread stack capture (the hang bundle's threads) ------------------

def thread_stacks() -> list:
    """One dict per live thread: {"name", "ident", "daemon", "current",
    "frames": [{"file", "line", "func", "code"}, ...]} — from
    `sys._current_frames()` joined against `threading.enumerate()`, the
    capture the hang bundle embeds. Outermost frame first."""
    frames = sys._current_frames()
    by_id = {t.ident: t for t in threading.enumerate()}
    me = threading.get_ident()
    out = []
    for tid, frame in frames.items():
        t = by_id.get(tid)
        stack = traceback.extract_stack(frame)
        out.append({
            "name": t.name if t is not None else f"tid-{tid}",
            "ident": int(tid),
            "daemon": bool(t.daemon) if t is not None else None,
            "current": tid == me,
            "frames": [{"file": f.filename, "line": int(f.lineno or 0),
                        "func": f.name, "code": f.line}
                       for f in stack],
        })
    out.sort(key=lambda d: (not d["current"], d["name"], d["ident"]))
    return out


def format_stacks(stacks=None) -> str:
    """Text rendering of `thread_stacks()`: one header line per thread,
    then its frames innermost-last."""
    if stacks is None:
        stacks = thread_stacks()
    lines = [f"== threads ==  {len(stacks)} live, pid {os.getpid()}"]
    for s in stacks:
        flags = []
        if s["daemon"]:
            flags.append("daemon")
        if s["current"]:
            flags.append("current")
        lines.append(f"--- {s['name']} (ident {s['ident']}"
                     + (f", {' '.join(flags)}" if flags else "") + ")")
        for f in s["frames"]:
            lines.append(f"  {f['file']}:{f['line']} in {f['func']}")
            if f.get("code"):
                lines.append(f"    {f['code']}")
    return "\n".join(lines)


# ---- per-op deadline state -------------------------------------------------

def calibrated_deadline(samples, *, multiplier=10.0, floor_s=1.0,
                        ceiling_s=600.0, min_samples=8):
    """The watchdog's calibration rule as a reusable function:
    clamp(p99(samples) x multiplier, floor_s, ceiling_s), or None while
    there are fewer than `min_samples` observations (DISARMED — a
    breach verdict needs evidence of what "normal" looks like). Used by
    OpDeadline below."""
    s = sorted(float(x) for x in samples)
    if len(s) < int(min_samples):
        return None
    p99 = s[min(len(s) - 1, int(0.99 * len(s)))]
    return min(max(p99 * float(multiplier), float(floor_s)),
               float(ceiling_s))


class OpDeadline:
    """Deadline state for one DEADLINE_OPS member.

    With `static`, the deadline is fixed. Otherwise it is warmup-
    calibrated: after `min_samples` observed durations, deadline =
    clamp(p99 x multiplier, floor, ceiling), recomputed per sample over
    a bounded window. Until calibrated the op is DISARMED (deadline
    None): a breach verdict needs evidence of what "normal" looks like.
    Breached or build-tainted guard durations never feed calibration
    (a hang teaching the watchdog that hangs are normal would defeat
    it)."""

    def __init__(self, op, static=None, multiplier=10.0, floor_s=1.0,
                 ceiling_s=600.0, min_samples=8, window=256):
        self.op = _check_op(op)
        self.static = float(static) if static is not None else None
        self.multiplier = float(multiplier)
        self.floor_s = float(floor_s)
        self.ceiling_s = float(ceiling_s)
        self.min_samples = int(min_samples)
        self.samples = deque(maxlen=int(window))
        self.breaches = 0
        self._cached = self.static
        self._exported = None  # last gauge-exported deadline value

    def add_sample(self, seconds: float):
        if self.static is not None:
            return
        self.samples.append(float(seconds))
        d = calibrated_deadline(
            self.samples, multiplier=self.multiplier,
            floor_s=self.floor_s, ceiling_s=self.ceiling_s,
            min_samples=self.min_samples)
        if d is not None:
            self._cached = d

    def deadline(self) -> "float | None":
        """Armed deadline in seconds, or None while uncalibrated."""
        return self._cached


class _Armed:
    """One armed operation: the guard's live entry in the watchdog
    table. `stage` is the escalation index already taken (0 = none),
    `tainted` marks compile time seen inside, `abort_s` carries the
    overdue seconds once the abort stage fired (the guard exit's
    cooperative raise reads it)."""

    __slots__ = ("op", "tid", "tname", "t0", "t0_wall", "deadline",
                 "stage", "tainted", "abort_s", "hard_done", "done",
                 "ctx")

    def __init__(self, op, deadline, ctx):
        self.op = op
        self.tid = threading.get_ident()
        self.tname = threading.current_thread().name
        self.t0 = time.monotonic()
        self.t0_wall = time.time()
        self.deadline = deadline
        self.stage = 0
        self.tainted = False
        self.abort_s = None
        self.hard_done = False
        self.done = False   # disarmed: the checker must stop escalating
        self.ctx = ctx


# ---- the watchdog ----------------------------------------------------------

class Watchdog:
    """Deadline table + the `singa-watchdog-<pid>` checker thread.

    multiplier/floor_s/ceiling_s/min_samples/window: calibration knobs
    (see OpDeadline). `deadlines`: static per-op overrides. `action`:
    the highest ESCALATION stage a breach may climb to. `dump_at` /
    `abort_at` / `hard_at`: stage thresholds as multiples of the op's
    deadline (warn always fires at 1x). `out_dir`: hang-bundle
    directory; None follows the active HealthMonitor's flight-recorder
    dir, else the CWD. `hard_abort`: inject an async
    HangError into a thread that stayed wedged past `hard_at` (it lands
    when the interpreter next runs bytecode there); `hard_signal`: send
    a REAL signal to the process instead — the preemption path
    (checkpoint + clean exit) for an interpreter too wedged even for
    that. `enabled` gates the guards without tearing the thread down
    (bench A/B toggling)."""

    def __init__(self, multiplier=10.0, floor_s=1.0, ceiling_s=600.0,
                 min_samples=8, window=256, deadlines=None,
                 action="abort", dump_at=2.0, abort_at=3.0, hard_at=6.0,
                 poll_interval_s=0.05, out_dir=None, hard_abort=True,
                 hard_signal=None):
        if action not in ESCALATION:
            raise ValueError(f"action {action!r} not in {ESCALATION}")
        deadlines = dict(deadlines or {})
        for op in deadlines:
            _check_op(op)
        self.action = action
        self.max_stage = ESCALATION.index(action) + 1
        self.dump_at = float(dump_at)
        self.abort_at = float(abort_at)
        self.hard_at = float(hard_at)
        self.poll_interval_s = float(poll_interval_s)
        self.out_dir = out_dir
        self.hard_abort = bool(hard_abort)
        self.hard_signal = hard_signal
        self.enabled = True
        self._lock = threading.Lock()
        self._ops = {op: OpDeadline(op, static=deadlines.get(op),
                                    multiplier=multiplier,
                                    floor_s=floor_s, ceiling_s=ceiling_s,
                                    min_samples=min_samples,
                                    window=window)
                     for op in DEADLINE_OPS}
        self._armed: "dict[int, _Armed]" = {}
        self._nesting: "dict[tuple, int]" = {}  # (tid, op) -> depth
        self._hang_id = 0
        self.last_breach: "dict | None" = None
        self._hang_retired = False  # recovery retired the fleet verdict
        self.last_bundle: "str | None" = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"singa-watchdog-{os.getpid()}")
        self._thread.start()

    # -- arming ------------------------------------------------------------
    def _arm(self, op: str, ctx: dict) -> "_Armed | None":
        """Register one armed operation; None when the same (thread, op)
        is already armed (nested guards — the controller's step guard
        encloses the model's — count once, at the outermost site)."""
        st = self._ops.get(op)
        if st is None:
            _check_op(op)  # unreachable; keeps the contract loud
        key = (threading.get_ident(), op)
        with self._lock:
            depth = self._nesting.get(key, 0)
            self._nesting[key] = depth + 1
            if depth:
                return None
            entry = _Armed(op, st.deadline(), ctx)
            self._armed[id(entry)] = entry
            return entry

    def _disarm(self, entry: "_Armed | None", op: str, ok: bool):
        key = (threading.get_ident(), op)
        with self._lock:
            depth = self._nesting.get(key, 1) - 1
            if depth <= 0:
                self._nesting.pop(key, None)
            else:
                self._nesting[key] = depth
            if entry is None:
                return
            entry.done = True   # the checker's in-flight due list may
            self._armed.pop(id(entry), None)  # still hold this entry
            dur = time.monotonic() - entry.t0
            st = self._ops[op]
            if ok and not entry.tainted and entry.stage == 0:
                st.add_sample(dur)
        dl = st.deadline()
        # export only on CHANGE (one gauge resolve, not the full
        # _metrics() dict, and only when recalibration moved it): the
        # disarm path runs per step and must stay out of the profile
        if dl is not None and dl != st._exported \
                and observe.is_enabled() \
                and op in DEADLINE_OPS:  # proven member: op= bounded
            st._exported = dl
            observe.gauge(
                "singa_watchdog_deadline_seconds",
                "current (calibrated or static) deadline per op"
            ).set(dl, op=op)

    def taint_current_thread(self):
        """Mark every operation armed on the calling thread as
        containing compile time (the span-enter listener calls this when
        a build span opens): excluded from calibration and breaches."""
        tid = threading.get_ident()
        with self._lock:
            for e in self._armed.values():
                if e.tid == tid:
                    e.tainted = True

    # -- the checker thread ------------------------------------------------
    def _loop(self):
        m = _metrics()
        while not self._stop.wait(self.poll_interval_s):
            if not self.enabled:
                continue
            now = time.monotonic()
            due = []
            with self._lock:
                m["armed"].set(float(len(self._armed)))
                for e in self._armed.values():
                    if e.tainted or e.deadline is None:
                        continue
                    over = now - e.t0
                    if over >= e.deadline:
                        due.append((e, over))
            for e, over in due:
                try:
                    self._escalate(e, over)
                except Exception:
                    # forensics must never kill the checker: the next
                    # poll retries the stage that failed
                    pass

    def _escalate(self, e: "_Armed", over: float):
        # `over` is recomputed per stage: the dump stage does file I/O
        # (and first-use imports), so by the time it returns the abort
        # threshold may already be past — the ladder must not lag one
        # poll behind per stage on a genuinely wedged op. Each stage
        # re-checks `e.done`: the guard may exit while this entry sits
        # in the checker's in-flight due list, and a completed op must
        # not be escalated (worst: an async exception injected into a
        # thread already running RECOVERY code).
        dl = e.deadline
        if e.done:
            return
        if e.stage < 1 <= self.max_stage:
            e.stage = 1
            self._breach(e, over, "warn")
        if e.stage < 2 <= self.max_stage and over >= dl * self.dump_at \
                and not e.done:
            # stage advances only AFTER the bundle lands: a transient
            # dump failure (full disk, flaky forensic source) raises
            # out to _loop's per-entry catch and the next poll RETRIES
            # the dump instead of silently skipping the post-mortem
            self._dump(e, over)
            e.stage = 2
            self._breach(e, over, "dump")
            over = time.monotonic() - e.t0
        if e.stage < 3 <= self.max_stage and over >= dl * self.abort_at \
                and not e.done:
            e.stage = 3
            self._breach(e, over, "abort")
            self._abort(e, over)
        if e.stage >= 3 and not e.hard_done \
                and over >= dl * self.hard_at:
            e.hard_done = True
            with self._lock:
                # final armed re-check right before injection: the
                # cooperative exit may have just delivered the abort —
                # a second, async HangError landing mid-restore would
                # corrupt the very recovery it triggered
                live = id(e) in self._armed and not e.done
            if live:
                self._hard_abort(e, over)

    def _breach(self, e: "_Armed", over: float, stage: str):
        op = e.op
        if op not in DEADLINE_OPS:  # op= label provably bounded
            raise ValueError(f"op {op!r} not in {DEADLINE_OPS}")
        st = self._ops[op]
        st.breaches += 1
        if stage == "warn":
            _metrics()["breach"].inc(op=op)
        rec = {"id": self._hang_id, "op": op, "stage": stage,
               "seconds": round(over, 4),
               "deadline": round(e.deadline, 4),
               "thread": e.tname, "tid": e.tid,
               "ts": round(time.time(), 6),
               "bundle": self.last_bundle if stage != "warn" else None,
               "ctx": {k: v for k, v in e.ctx.items()
                       if isinstance(v, (str, int, float, bool))}}
        self.last_breach = rec
        self._hang_retired = False  # a fresh episode re-arms the verdict
        observe.get_registry().emit(
            {"kind": "watchdog", "event": "breach", **rec})

    # -- dump stage --------------------------------------------------------
    def _bundle_dir(self) -> str:
        if self.out_dir is not None:
            return self.out_dir
        mon = health.active_monitor()
        if mon is not None:
            return mon.recorder.out_dir
        return "."

    def dump_hang_bundle(self, op: str, seconds: float,
                         entry: "_Armed | None" = None) -> str:
        """Write the hang bundle, `flight_hang_<op>_<n>.jsonl` (beside
        the flight recorder's bundles): header, one line per live
        thread's Python stack, the memory ledger's region breakdown (with
        a ledger installed), the goodput snapshot (with a tracker
        installed) and the recent EventLog tail; plus a `faulthandler`
        sidecar (`<bundle>.stacks.txt`) written by the C-level dumper,
        which survives interpreter states the Python capture cannot. The
        header's `executables` are introspect's last eight builds (or
        None); with a `fleet.FleetAggregator` installed, a `hang_fleet`
        line carries its rollup (workers, stragglers). Returns the
        bundle path."""
        op = _check_op(op)
        d = self._bundle_dir()
        os.makedirs(d, exist_ok=True)
        n = 0
        while True:
            n += 1
            path = os.path.join(d, f"{_BUNDLE_PREFIX}_{op}_{n}.jsonl")
            if not os.path.exists(path):
                break
        stacks = thread_stacks()
        wedged_tid = entry.tid if entry is not None else None
        header = {"kind": "hang_header", "ts": round(time.time(), 6),
                  "op": op, "seconds": round(seconds, 4),
                  "deadline": round(entry.deadline, 4)
                  if entry is not None and entry.deadline else None,
                  "thread": entry.tname if entry is not None else None,
                  "tid": wedged_tid, "n_threads": len(stacks),
                  "executables": introspect.executable_manifest()[-8:]
                  or None}
        led = memory.get_ledger()
        mem = led.region_bytes() if led is not None else None
        tracker = goodput.get_tracker()
        gp = tracker.snapshot() if tracker is not None else None
        fl = None
        try:
            from . import fleet
            agg = fleet.get_aggregator()
            if agg is not None:
                roll = agg.rollup()
                fl = {"n_workers": roll["n_workers"],
                      "stragglers": roll["stragglers"],
                      "workers": roll["workers"]}
        except Exception:
            pass  # the bundle must land even if the rollup fails
        tail = list(observe.get_registry().recent)[-64:]
        with open(path, "w", encoding="utf-8") as f:
            def line(rec):
                f.write(json.dumps(rec, separators=(",", ":"),
                                   default=str) + "\n")
            line(header)
            for s in stacks:
                line({"kind": "hang_thread",
                      "wedged": s["ident"] == wedged_tid, **s})
            if mem is not None:
                line({"kind": "hang_memory", **mem})
            if gp is not None:
                line({"kind": "hang_goodput",
                      "buckets": gp.get("buckets"),
                      "goodput_ratio": gp.get("goodput_ratio")})
            if fl is not None:
                line({"kind": "hang_fleet", **fl})
            for ev in tail:
                line({"kind": "hang_event", "event": ev})
        try:
            with open(path + ".stacks.txt", "w") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
        except Exception:
            pass  # the sidecar is best-effort; the JSONL already landed
        self.last_bundle = path
        return path

    def _dump(self, e: "_Armed", over: float):
        if e.op not in DEADLINE_OPS:  # op= label provably bounded
            raise ValueError(f"op {e.op!r} not in {DEADLINE_OPS}")
        path = self.dump_hang_bundle(e.op, over, entry=e)
        _metrics()["dump"].inc(op=e.op)
        if self.last_breach is not None:
            self.last_breach["bundle"] = path
        observe.get_registry().emit(
            {"kind": "watchdog", "event": "hang_bundle", "op": e.op,
             "bundle": path, "thread": e.tname})

    # -- abort stage -------------------------------------------------------
    def _abort(self, e: "_Armed", over: float):
        op = e.op
        if op not in DEADLINE_OPS:  # op= label provably bounded
            raise ValueError(f"op {op!r} not in {DEADLINE_OPS}")
        e.abort_s = over
        with self._lock:
            self._hang_id += 1
            hid = self._hang_id
        self.last_breach = dict(self.last_breach or {}, id=hid,
                                stage="abort",
                                seconds=round(over, 4))
        _metrics()["abort"].inc(op=op)
        mon = health.active_monitor()
        if mon is not None:
            try:
                mon.note_external(
                    health.KIND_HANG,
                    detail={"op": op, "seconds": round(over, 4),
                            "thread": e.tname,
                            "bundle": self.last_bundle})
            except Exception:
                pass  # the monitor must not break the watchdog
        observe.get_registry().emit(
            {"kind": "watchdog", "event": "abort", "op": op,
             "seconds": round(over, 4), "thread": e.tname,
             "hang_id": hid})

    def _hard_abort(self, e: "_Armed", over: float):
        """The wedged thread never reached its guard exit: force the
        issue. With `hard_signal`, deliver a REAL signal to the process
        (Python runs handlers on the main thread — under a
        TrainController this is the preemption path: finish, checkpoint,
        clean exit). Otherwise inject an async HangError into the
        thread via the C API — it lands at the next bytecode boundary,
        i.e. the moment the wedged C call finally returns, and covers
        code that never re-enters a guard."""
        op = e.op
        if op not in DEADLINE_OPS:  # op= label provably bounded
            raise ValueError(f"op {op!r} not in {DEADLINE_OPS}")
        _metrics()["hard"].inc(op=op)
        observe.get_registry().emit(
            {"kind": "watchdog", "event": "hard_abort", "op": op,
             "seconds": round(over, 4), "thread": e.tname,
             "mechanism": "signal" if self.hard_signal else "async_exc"})
        if self.hard_signal:
            try:
                os.kill(os.getpid(), int(self.hard_signal))
            except OSError:
                pass
            return
        if self.hard_abort:
            _async_raise(e.tid)

    def take_abort(self, entry: "_Armed") -> "float | None":
        """Consume a pending abort for `entry` (guard exit calls this):
        the overdue seconds, or None.

        The check is DETERMINISTIC, not daemon-timed: even when the
        checker thread is behind (mid-dump on a slow disk), a guard
        whose duration crossed the abort threshold aborts at exit —
        recording the abort stage itself if the daemon had not reached
        it. Tests (and production) get the same verdict for the same
        wedge regardless of poll scheduling."""
        s = entry.abort_s
        entry.abort_s = None
        if s is not None:
            return s
        if entry.deadline is None or entry.tainted \
                or self.max_stage < 3:
            return None
        dur = time.monotonic() - entry.t0
        if entry.stage >= 3:
            # the checker is MID-abort (stage set, abort_s not yet):
            # the verdict is decided and about to reach the fleet —
            # this thread must abort too, or peers restore while it
            # steps on and the fleet diverges
            return dur
        if dur >= entry.deadline * self.abort_at:
            entry.stage = 3
            self._breach(entry, dur, "abort")
            self._abort(entry, dur)
            entry.abort_s = None
            return dur
        return None

    # -- reading -----------------------------------------------------------
    def armed(self) -> list:
        with self._lock:
            return [{"op": e.op, "thread": e.tname,
                     "seconds": round(time.monotonic() - e.t0, 4),
                     "deadline": e.deadline, "stage": e.stage,
                     "tainted": e.tainted}
                    for e in self._armed.values()]

    def op_state(self, op: str) -> "OpDeadline":
        return self._ops[_check_op(op)]

    def hang_report(self) -> "dict | None":
        """The FLEET-FACING hang verdict (rides every telemetry shard):
        the last breach record — `id` increments per abort so the
        peer-hang escalation de-duplicates episodes — or None once a
        successful recovery retired it via `clear_hang()`. The forensic
        record itself (`last_breach`, /statusz, worker reports) stays
        sticky; only the fleet stops being told this worker is
        wedged."""
        return None if self._hang_retired else self.last_breach

    def clear_hang(self):
        """Retire the fleet-facing verdict (TrainController calls this
        after a hang restart restores successfully): the shard stops
        advertising WEDGED and a later-installed aggregator cannot
        re-escalate a finished episode. A new breach un-retires."""
        self._hang_retired = True

    def close(self):
        """Stop and join the checker thread (conftest contract: no
        singa-watchdog-* thread survives a test)."""
        self._stop.set()
        self._thread.join(timeout=5.0)


def _async_raise(tid: int) -> bool:
    """Inject a HangError into thread `tid` at its next bytecode
    boundary (CPython C API). Returns True when exactly one thread state
    accepted it."""
    import ctypes
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(tid), ctypes.py_object(HangError))
    if res > 1:  # should not happen; undo rather than corrupt
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(tid), None)
        return False
    return res == 1


# ---- the guard (the only hot-path surface) ---------------------------------

_wd: "Watchdog | None" = None


class guard:
    """`with watchdog.guard("step"): ...` — arm a deadline around one
    blocking operation. Near-free when no watchdog is installed (one
    module-global read); nested same-op guards on one thread count once,
    at the outermost site (the TrainController's step guard encloses the
    model's). On exit the duration feeds the op's calibration, and a
    pending abort for this entry raises HangError — the cooperative
    delivery path: the moment the wedged call finally returns, the
    training thread learns it was given up on."""

    __slots__ = ("op", "ctx", "_entry", "_wdref")

    def __init__(self, op: str, **ctx):
        self.op = op
        self.ctx = ctx
        self._entry = None
        self._wdref = None

    def __enter__(self):
        wd = _wd
        if wd is not None and wd.enabled:
            self._wdref = wd
            self._entry = wd._arm(self.op, self.ctx)
        return self

    def __exit__(self, exc_type, exc, tb):
        wd = self._wdref
        if wd is None:
            return False
        self._wdref = None
        entry = self._entry
        self._entry = None
        wd._disarm(entry, self.op, ok=exc_type is None)
        if entry is not None:
            over = wd.take_abort(entry)
            if over is not None and exc_type is None:
                # the operation's own error (if any) outranks the
                # watchdog's verdict; otherwise deliver the abort here
                raise HangError(
                    f"{self.op} exceeded its watchdog deadline "
                    f"({over:.2f}s > {entry.deadline:.2f}s) and was "
                    f"aborted (bundle: {wd.last_bundle})",
                    op=self.op, seconds=over,
                    bundle_path=wd.last_bundle)
        return False


# ---- install / uninstall ---------------------------------------------------

def _on_span_enter(path: str):
    wd = _wd
    if wd is None:
        return
    if path.rsplit("/", 1)[-1] in _BUILD_SPAN_LEAVES:
        wd.taint_current_thread()


def _on_span_exit(path, seconds, attrs):
    pass  # calibration feeds from guards, not spans; enter-hook only


def install_watchdog(**kwargs) -> Watchdog:
    """Install (or return) the process watchdog. Registers the span
    listener that excludes compile time from calibration. Idempotent:
    a second call returns the installed instance unchanged (uninstall
    first to reconfigure)."""
    global _wd
    if _wd is not None:
        return _wd
    _wd = Watchdog(**kwargs)
    observe.add_span_listener(_on_span_exit, on_enter=_on_span_enter)
    return _wd


def uninstall_watchdog():
    """Stop the checker thread (joined) and drop the watchdog + its
    span listener. Idempotent; the test conftest calls this per test."""
    global _wd
    wd = _wd
    _wd = None
    observe.remove_span_listener(_on_span_exit)
    if wd is not None:
        wd.close()


def get_watchdog() -> "Watchdog | None":
    return _wd


def hang_report() -> "dict | None":
    """The installed watchdog's last breach record, or None — the line
    the fleet shard writer publishes per worker."""
    wd = _wd
    return wd.hang_report() if wd is not None else None


# ---- bundle round-trip -----------------------------------------------------

def load_hang_bundle(path: str) -> dict:
    """Round-trip a hang bundle: {"header", "threads", "memory",
    "goodput", "fleet", "events"}."""
    rows = observe.EventLog.read(path)
    header = next((r for r in rows if r.get("kind") == "hang_header"), {})
    return {
        "header": header,
        "threads": [r for r in rows if r.get("kind") == "hang_thread"],
        "memory": next((r for r in rows
                        if r.get("kind") == "hang_memory"), None),
        "goodput": next((r for r in rows
                         if r.get("kind") == "hang_goodput"), None),
        "fleet": next((r for r in rows
                       if r.get("kind") == "hang_fleet"), None),
        "events": [r["event"] for r in rows
                   if r.get("kind") == "hang_event" and "event" in r],
    }


# ---- /statusz section ------------------------------------------------------

def watchdog_report() -> str:
    """Text block for /statusz: per-op deadline table + armed ops +
    last breach."""
    lines = ["== watchdog =="]
    wd = _wd
    if wd is None:
        lines.append("watchdog: not installed "
                     "(singa_tpu_torch.watchdog.install_watchdog)")
        return "\n".join(lines)
    lines.append(f"watchdog: action={wd.action} "
                 f"poll={wd.poll_interval_s}s enabled={wd.enabled}")
    lines.append(f"{'op':<14} {'deadline_s':>11} {'samples':>8} "
                 f"{'breaches':>9}")
    for op in DEADLINE_OPS:
        st = wd.op_state(op)
        dl = st.deadline()
        mode = "static" if st.static is not None else (
            "cal" if dl is not None else "warming")
        lines.append(
            f"{op:<14} "
            f"{(f'{dl:.3f}({mode})' if dl is not None else f'-({mode})'):>11} "
            f"{len(st.samples):>8} {st.breaches:>9}")
    armed = wd.armed()
    lines.append("armed: " + (", ".join(
        f"{a['op']}@{a['seconds']:.2f}s" for a in armed) or "none"))
    lb = wd.last_breach
    lines.append("last breach: " + (json.dumps(lb, default=str)
                                    if lb else "none"))
    return "\n".join(lines)


# ---- CLI: the hang A/B -----------------------------------------------------
# `--worker` trains a small deterministic MLP under a TrainController
# with a watchdog armed over an eager per-step collective; one worker
# gets a FaultPlan-wedged collective and must abort-and-restore, while
# the others learn of the hang through the fleet spool and restore in
# lockstep. `--ab` orchestrates the fleet + a baseline leg and asserts
# detection + coordinated recovery from the coordinator's HTTP surface.

def _worker_main(args) -> int:
    if args.host:
        os.environ["SINGA_FLEET_HOST"] = args.host
    import torch

    from . import distributed, fleet, resilience
    from .parallel.communicator import Communicator
    fleet._require_device(args.device)

    if args.wedge > 0:
        plan = resilience.FaultPlan()
        plan.delay("comm.collective", args.wedge, nth=args.wedge_nth)
        resilience.install_fault_plan(plan)
    wd = install_watchdog(
        deadlines={"collective": args.deadline},
        action="abort", dump_at=1.5, abort_at=2.0,
        poll_interval_s=0.01, out_dir=args.ckpt_dir)
    writer = fleet.start_shard_writer(args.fleet_dir, interval_s=0.05)
    fleet.install_aggregator(args.fleet_dir, policy="warn",
                             stale_after_s=120.0, poll_interval_s=0.05)
    # resilience's deterministic MLP, a graph-mode step on the device;
    # at one device its optimizer is a PLAIN SGD (a DistOpt step stamps
    # one collective per parameter, which would spend the wedge's
    # nth-arrival budget before the data source's own collective fires)
    m, tx, ty = resilience._worker_build(1, args.batch, args.seed,
                                         args.device)
    comm = Communicator()  # world 1: the eager per-step host collective
    tick = torch.ones((), device=args.device)
    if args.start_barrier > 1:
        # a worker takes seconds to import torch and reach its device,
        # about as long as a whole run of steps: without the barrier the
        # first worker up can finish before the wedged one hangs, and
        # the recovery could not be coordinated
        fleet._start_barrier(writer, args.start_barrier, args.timeout)
    steps, sleep_s = args.steps, args.step_sleep

    class _CollectiveSrc:
        """One eager collective per batch — the wedgeable dependency."""

        def __iter__(self):
            for _ in range(steps):
                if sleep_s:
                    time.sleep(sleep_s)
                comm.all_reduce(tick)
                yield (tx, ty)

    ctrl = resilience.TrainController(
        m, args.ckpt_dir, save_every_steps=args.save_every,
        max_restarts=3, handle_signals=False, verbose=1)
    t0 = time.monotonic()
    report = ctrl.fit(_CollectiveSrc(), epochs=1)
    report["wall_s"] = round(time.monotonic() - t0, 3)
    report["host"] = distributed.host_label()
    # the sticky forensic record, NOT hang_report(): a successful
    # recovery retires the fleet-facing verdict before this point
    report["watchdog"] = wd.last_breach
    fleet.stop_shard_writer()
    fleet.uninstall_aggregator()
    uninstall_watchdog()
    from . import overlap
    overlap.wait_for_checkpoints()
    if args.report_out:
        with open(args.report_out, "w", encoding="utf-8") as f:
            json.dump(report, f, default=str)
    print(json.dumps(report, default=str))
    return 0 if report["status"] == "completed" else 1


def _spawn_hang_worker(py, root, args, idx, wedge):
    import subprocess
    env = dict(os.environ, SINGA_FLEET_HOST=f"host{idx}")
    env.pop("SINGA_TPU_DIAG_PORT", None)
    work = args.work
    cmd = [py, "-m", "singa_tpu_torch.watchdog", "--worker",
           "--fleet-dir", args.fleet_dir,
           "--ckpt-dir", os.path.join(work, f"ck_{idx}"),
           "--steps", str(args.steps),
           "--save-every", str(args.save_every),
           "--step-sleep", str(args.step_sleep),
           "--deadline", str(args.deadline),
           "--wedge", str(wedge), "--wedge-nth", str(args.wedge_nth),
           "--seed", str(args.seed), "--batch", str(args.batch),
           "--device", args.device,
           "--start-barrier", str(args.workers),
           "--timeout", str(args.timeout),
           "--report-out", os.path.join(work, f"report_{idx}.json")]
    return subprocess.Popen(cmd, cwd=root, env=env,
                            stdout=sys.stderr, stderr=sys.stderr)


def _ab_main(args) -> int:
    import shutil
    import subprocess
    import tempfile
    from urllib.request import urlopen

    from .fleet import _require_device
    _require_device(args.device)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    work = tempfile.mkdtemp(prefix="singa_hang_ab_")
    args.work = work
    args.fleet_dir = os.path.join(work, "spool")
    os.makedirs(args.fleet_dir, exist_ok=True)
    py = sys.executable
    wedged_idx = args.workers - 1
    rec = {"workers": args.workers, "steps": args.steps,
           "wedge_s": args.wedge, "deadline_s": args.deadline,
           "wedged_host": f"host{wedged_idx}", "device": args.device,
           "ok": False}
    from . import diag, fleet
    agg = fleet.install_aggregator(args.fleet_dir, policy="warn",
                                   stale_after_s=120.0,
                                   poll_interval_s=0.05)
    srv = diag.start_diag_server(port=0)
    t_start = time.monotonic()
    procs = [_spawn_hang_worker(py, root, args, i,
                                args.wedge if i == wedged_idx else 0.0)
             for i in range(args.workers)]
    seen_hang = None
    fleetz_mid = ""
    deadline_t = time.monotonic() + args.timeout
    try:
        while time.monotonic() < deadline_t:
            agg.poll()
            for w in agg.workers():
                h = getattr(w, "hang", None)
                if not (isinstance(h, dict) and h.get("op")):
                    continue
                if seen_hang is None:
                    seen_hang = {"host": w.host, **h}
                    rec["detected_wall_s"] = round(
                        time.monotonic() - t_start, 3)
                if not fleetz_mid and h.get("stage") == "abort":
                    # sample /fleetz NOW, while the worker is wedged
                    # at abort stage: a successful recovery retires
                    # the verdict, so the end-of-run page no longer
                    # shows it — correctly
                    with urlopen(srv.url + "/fleetz", timeout=30) as r:
                        fleetz_mid = r.read().decode("utf-8")
            if all(p.poll() is not None for p in procs):
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        rec["worker_rcs"] = [p.returncode for p in procs]
        # acceptance surface: the coordinator's own HTTP endpoints
        with urlopen(srv.url + "/fleetz", timeout=30) as r:
            fleetz = r.read().decode("utf-8")
        with urlopen(srv.url + "/stackz", timeout=30) as r:
            stackz = r.read().decode("utf-8")
        rec["fleetz_lists_all_hosts"] = all(
            f"host{i}" in fleetz for i in range(args.workers))
        rec["fleetz_marks_wedged"] = "WEDGED" in fleetz_mid
        # ... and the recovered worker is NOT wedged at the end
        rec["fleetz_wedged_cleared"] = "WEDGED" not in fleetz
        rec["stackz_ok"] = "MainThread" in stackz
        rec["hang_seen"] = seen_hang
        reports = {}
        for i in range(args.workers):
            try:
                with open(os.path.join(work, f"report_{i}.json"),
                          encoding="utf-8") as f:
                    reports[i] = json.load(f)
            except (OSError, ValueError):
                reports[i] = {}
        wrep = reports.get(wedged_idx, {})
        wwd = wrep.get("watchdog") or {}
        rec["wedged_status"] = wrep.get("status")
        rec["wedged_restarts"] = wrep.get("restarts")
        rec["wedged_resumed_step"] = wrep.get("resumed_step")
        rec["hang_op"] = wwd.get("op")
        # detection latency ~= the armed deadline: the warn stage fires
        # the first poll past it; the worker's sticky record carries the
        # overdue seconds at the final (abort) stage
        rec["abort_after_s"] = wwd.get("seconds")
        peer_restarts = [reports[i].get("restarts") or 0
                         for i in range(args.workers)
                         if i != wedged_idx]
        rec["peer_restarts"] = peer_restarts
        rec["coordinated"] = all(r >= 1 for r in peer_restarts)
        # steps lost to the hang = the step the wedge landed on minus
        # the checkpoint step the restore rewound to
        hist = {int(k): float(v)
                for k, v in (wrep.get("history") or [])}
        rec["steps_lost"] = (
            max(0, (args.wedge_nth - 1)
                - int(wrep.get("resumed_step") or 0)))
        # the post-resume loss curve must match an uninterrupted peer's
        # (same seed, same data): the resume delta IS the curve check
        base = {}
        for i in range(args.workers):
            if i != wedged_idx and reports[i].get("history"):
                base = {int(k): float(v)
                        for k, v in reports[i]["history"]}
                break
        deltas = [abs(base[k] - hist[k]) for k in hist if k in base]
        rec["compared_steps"] = len(deltas)
        rec["max_abs_loss_delta"] = round(max(deltas), 8) \
            if deltas else None
        rec["ok"] = bool(
            all(rc == 0 for rc in rec["worker_rcs"])
            and rec["wedged_status"] == "completed"
            and (rec["wedged_restarts"] or 0) >= 1
            and rec["coordinated"]
            and rec["hang_op"] == "collective"
            and rec["fleetz_lists_all_hosts"]
            and rec["fleetz_marks_wedged"]
            and rec["fleetz_wedged_cleared"]
            and rec["stackz_ok"]
            and deltas and max(deltas) < args.tolerance)
    finally:
        diag.stop_diag_server()
        fleet.uninstall()
        shutil.rmtree(work, ignore_errors=True)
    out = os.path.abspath(args.out)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(rec, f, indent=1, default=str)
        f.write("\n")
    print(json.dumps(rec, indent=1, default=str))
    return 0 if rec["ok"] else 1


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m singa_tpu_torch.watchdog",
        description="hang-detection harness (worker + hang A/B)")
    p.add_argument("--worker", action="store_true",
                   help="run one watchdog-guarded training leg")
    p.add_argument("--ab", action="store_true",
                   help="run the multi-process hang A/B")
    p.add_argument("--fleet-dir", default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--workers", type=int, default=3)
    # 24 steps at ~0.1s each keep the unwedged peers RUNNING while the
    # wedge (at the 6th collective), the abort (2x the 0.3s deadline)
    # and the shard publish land — a shorter run would let a peer
    # finish before the verdict reaches it, and "coordinated" means
    # every worker restores, not just the wedged one
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--save-every", type=int, default=3)
    p.add_argument("--step-sleep", type=float, default=0.1)
    p.add_argument("--deadline", type=float, default=0.3,
                   help="static collective deadline (seconds)")
    p.add_argument("--wedge", type=float, default=1.5,
                   help="FaultPlan delay injected into ONE collective")
    p.add_argument("--wedge-nth", type=int, default=6)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--host", default=None)
    p.add_argument("--report-out", default=None)
    p.add_argument("--tolerance", type=float, default=1e-4)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where every worker trains")
    p.add_argument("--start-barrier", type=int, default=0,
                   help="worker mode: wait until this many workers' shards "
                        "are in the spool before stepping")
    p.add_argument("--out", default="HANG_torch.json")
    args = p.parse_args(argv)
    if args.worker:
        if not args.fleet_dir or not args.ckpt_dir:
            p.error("--worker requires --fleet-dir and --ckpt-dir")
        return _worker_main(args)
    if args.ab:
        return _ab_main(args)
    p.error("pass --worker or --ab")
    return 2


__all__ = [
    "DEADLINE_OPS", "ESCALATION", "HangError", "OpDeadline", "Watchdog",
    "calibrated_deadline",
    "guard", "install_watchdog", "uninstall_watchdog", "get_watchdog",
    "hang_report", "thread_stacks", "format_stacks", "load_hang_bundle",
    "watchdog_report",
]

if __name__ == "__main__":
    # run under the CANONICAL module (not the runpy __main__ alias): the
    # CLI installs module singletons the diag/fleet layers reach via
    # `import singa_tpu_torch.watchdog`
    from singa_tpu_torch.watchdog import main as _main
    sys.exit(_main())
