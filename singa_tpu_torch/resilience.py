"""Deterministic fault injection (counterpart of the fault-injection part
of singa_tpu/resilience.py): `FaultPlan`, `install_fault_plan`,
`clear_fault_plan`, `fault_point`, and the `singa_resilience_*` metrics.

Instrumented sites call `fault_point("name", **ctx)`; with no plan
installed that is a no-op. A plan's rules match by arrival count and/or
context (e.g. step=K), so every recovery path is driven
deterministically. The points wired in the port:

  - "serving.decode"       the dense and speculative decode calls
                           (`serving.build_decode`, `build_spec_decode`)
  - "serving.engine_step"  `engine.ServingEngine`'s decode loop, inside
                           the `serving.engine_step` span, before each
                           sync's decode
  - "data.next"            `Model.fit`, `overlap.DevicePrefetcher` and
                           the data iterators, before the next-batch
                           fetch
  - "ckpt.wait"            `overlap.wait_for_checkpoints` (ctx: path),
                           before each pending async write is awaited

The rest of the JAX module (the train controller, checkpoint manifests,
`fit_resilient`) comes with a later slice (ROADMAP.md Queue 1 item 3).
Only `singa_resilience_faults_injected_total` is incremented here; the
other eight metrics are registered with the JAX names for that slice.
"""

from __future__ import annotations

import os
import threading
import time

from . import observe


class FaultPlan:
    """A deterministic set of fault rules, matched at named fault points.

    A `delay(...)` is the deterministic stand-in for a wedged operation;
    a `fail(...)` raises (the rule's `exc`, or a RuntimeError); a
    `send_signal(...)` delivers a real signal to this process. `fired`
    logs (point, arrival, kind) of every rule that fired."""

    def __init__(self):
        self._rules = []
        self._counts = {}
        self._lock = threading.Lock()
        self.fired = []

    def _add(self, kind, point, nth=None, step=None, times=1, **kw):
        self._rules.append({"kind": kind, "point": point, "nth": nth,
                            "step": step, "remaining": int(times), **kw})
        return self

    def fail(self, point, nth=None, step=None, times=1, exc=None):
        """Raise at `point`: on the `nth` arrival, at ctx step=`step`, or
        on the next `times` arrivals when neither is given."""
        return self._add("fail", point, nth, step, times, exc=exc)

    def delay(self, point, seconds, nth=None, step=None, times=1):
        """Sleep `seconds` at `point`."""
        return self._add("delay", point, nth, step, times,
                         seconds=float(seconds))

    def send_signal(self, point, signum, nth=None, step=None, times=1):
        """Deliver a real signal to this process at `point`."""
        return self._add("signal", point, nth, step, times,
                         signum=int(signum))

    def count(self, point) -> int:
        """Arrivals at `point` so far, fired or not."""
        with self._lock:
            return self._counts.get(point, 0)

    def fire(self, point, **ctx):
        """Count one arrival at `point` and run the first rule that
        matches it."""
        with self._lock:
            n = self._counts[point] = self._counts.get(point, 0) + 1
            rule = None
            for r in self._rules:
                if r["point"] != point or r["remaining"] <= 0:
                    continue
                if r["nth"] is not None and n != r["nth"]:
                    continue
                if r["step"] is not None and ctx.get("step") != r["step"]:
                    continue
                r["remaining"] -= 1
                rule = r
                break
            if rule is not None:
                self.fired.append((point, n, rule["kind"]))
        if rule is None:
            return
        _metrics()["faults"].inc(kind=rule["kind"])
        observe.get_registry().emit(
            {"kind": "resilience", "event": "fault_injected",
             "point": point, "arrival": n, "fault": rule["kind"], **ctx})
        if rule["kind"] == "delay":
            time.sleep(rule["seconds"])
        elif rule["kind"] == "signal":
            os.kill(os.getpid(), rule["signum"])
        else:
            exc = rule.get("exc")
            raise exc if exc is not None else RuntimeError(
                f"injected fault at {point!r} (arrival {n})")


_fault_plan: "FaultPlan | None" = None


def install_fault_plan(plan: "FaultPlan | None") -> "FaultPlan | None":
    """Install (or clear, with None) the process fault plan."""
    global _fault_plan
    _fault_plan = plan
    return plan


def clear_fault_plan():
    install_fault_plan(None)


def fault_point(point: str, **ctx):
    """Consult the installed FaultPlan at a named site; a no-op without
    one."""
    plan = _fault_plan
    if plan is not None:
        plan.fire(point, **ctx)


def _metrics():
    # observe.counter/gauge spelled out so the static lint
    # (tools/check_metrics_names.py) sees every registration
    return {
        "restarts": observe.counter(
            "singa_resilience_restarts_total",
            "in-process training restarts after a step failure"),
        "retries": observe.counter(
            "singa_resilience_retries_total",
            "retried transient checkpoint save/restore failures"),
        "saves": observe.counter(
            "singa_resilience_saves_total",
            "checkpoints written by the train controller"),
        "corrupt": observe.counter(
            "singa_resilience_corrupt_skipped_total",
            "checkpoints skipped at resume as half-written or invalid"),
        "preempt": observe.counter(
            "singa_resilience_preempt_total",
            "preemption signals honored with a final checkpoint"),
        "faults": observe.counter(
            "singa_resilience_faults_injected_total",
            "faults fired by the installed FaultPlan"),
        "retry_s": observe.counter(
            "singa_resilience_retry_seconds_total",
            "wall seconds spent sleeping in retry backoff"),
        "resumed_step": observe.gauge(
            "singa_resilience_resumed_step",
            "step the controller auto-resumed from (0 = fresh start)"),
        "save_age": observe.gauge(
            "singa_resilience_last_save_age_seconds",
            "seconds since the controller last wrote a checkpoint"),
    }


__all__ = ["FaultPlan", "install_fault_plan", "clear_fault_plan",
           "fault_point"]
