"""Resilience layer (counterpart of singa_tpu/resilience.py): elastic
fault-tolerant training with auto-resume, composed from the port's async
checkpoints with a durability barrier (`overlap`), the health halt
(`health`), the watchdog's hang abort (`watchdog`) and goodput's pricing
of every checkpoint second (`goodput`, through the `checkpoint.*`
spans).

  - `TrainController` / `fit_resilient(model, data, ...)`: a supervised
    training loop with periodic async saves on a step/seconds cadence,
    keep-last-K retention, auto-resume from the latest VALID checkpoint
    (half-written or corrupt `step_N` dirs are skipped), retry with
    decorrelated-jitter backoff around transient save/restore failures,
    an in-process restart path (a mid-epoch exception, or a watchdog
    `HangError`, restores the latest checkpoint and replays), a
    preemption path (SIGTERM/SIGINT, main thread only: the in-flight
    step finishes, a final checkpoint is proven durable, clean return)
    and a `HealthError` halt flowing into the same save-then-stop path.
    Losses stay on the device until a save or the report, then come to
    the host in one transfer.

  - Checkpoint **manifests**: every controller save writes
    `step_N.manifest.json` next to the `step_N` directory (step, the
    process topology, the model's parameter signature with numpy dtype
    names, the last eight build fingerprints from `introspect`)
    atomically, and only after the async write is proven durable.
    Manifest presence is the completeness marker: discovery
    (`latest_checkpoint`) trusts only manifested checkpoints, and
    `Model.save_checkpoint` sets a manifest-less existing `step_N` aside
    as an interrupted write. A manifest written by either package passes
    the other's `read_manifest` and `validate_manifest` for the same
    model. `Model.load_checkpoint(path, validate=True)` checks the
    parameter signature before restoring anything.

  - Deterministic **fault injection** (`FaultPlan`).

Data parallelism (`opt.DistOpt` over a process group, one process per
rank): the manifest's mesh `axes` is the DistOpt's mesh shape (None for a
local optimizer) and its topology `distributed.topology()`. Every rank
runs the controller; rank 0 alone writes the checkpoint files, the
manifests (after a barrier: every rank has finished the save), the
retention and the dead timeline's clean-up, and every rank resumes from
the same manifest, onto the same or another world size (the replicated
states restore on any size; a DistOpt's per-rank sparse residuals only
on the size that saved them). A preemption signal is agreed across the
ranks at each step boundary, so all of them stop after the same step.

Not yet here: `warm_store` is None and resume does not re-join a warm
store until `warmstart` (ROADMAP.md Queue 1 item 7); the fleet straggler
hook of the JAX loop comes with `fleet` (item 6).

Fault points wired in the port (`FaultPlan`'s rules match by arrival
count and/or context, e.g. step=K):

  - "step"                 `TrainController`, inside the step guard,
                           before the model call (ctx: step)
  - "ckpt.save"            `TrainController`'s save, inside the
                           `ckpt_save` guard, before the write (ctx: step)
  - "serving.decode"       the dense and speculative decode calls
                           (`serving.build_decode`, `build_spec_decode`)
  - "serving.engine_step"  `engine.ServingEngine`'s decode loop, inside
                           the `serving.engine_step` span, before each
                           sync's decode
  - "data.next"            `Model.fit`, the controller, the prefetcher
                           and the data iterators, before the next-batch
                           fetch
  - "ckpt.wait"            `overlap.wait_for_checkpoints` (ctx: path),
                           before each pending async write is awaited

CLI: `python -m singa_tpu_torch.resilience --ab --devices-a 4
--devices-b 2 --device cpu --out OUT.json` runs the kill-and-resume A/B
as real subprocesses (train, SIGTERM mid-run, resume, compare the loss
curves); a leg of N > 1 devices is N worker processes joined over gloo
(`--device cpu`) or NCCL (the card, at most the cards the host has),
training under DistOpt. The defaults are one device a leg.
"""

from __future__ import annotations

import json
import os
import random
import re
import shutil
import signal as _signal
import threading
import time

import torch

from . import distributed, health, introspect, observe, watchdog

MANIFEST_VERSION = 1
MANIFEST_SUFFIX = ".manifest.json"
_STEP_DIR_RE = re.compile(r"^step_(\d+)$")

#: terminal states a controller run (and its final manifest) can record
RUN_STATUSES = ("ok", "preempt", "halt")


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


# ---- checkpoint manifests --------------------------------------------------

def manifest_path(step_dir: str) -> str:
    """`.../step_N` -> `.../step_N.manifest.json` (a sibling, so it
    survives a rewrite of the directory)."""
    return os.path.abspath(step_dir).rstrip(os.sep) + MANIFEST_SUFFIX


def param_signature(model) -> dict:
    """{param name: {"shape": [...], "dtype": "..."}} (numpy's dtype
    names): the structural identity a checkpoint must match to be
    restorable into `model`. Shapes are global: a tensor-parallel shard
    counts at its whole array's shape, as the checkpoint holds it."""
    shape = getattr(model, "_global_shape", lambda t: t.shape)
    return {k: {"shape": [int(s) for s in shape(t)],
                "dtype": introspect._dtype_name(t.dtype)}
            for k, t in model._raw_params().items()}


def build_manifest(model, step: int, status: str = "ok",
                   extra: "dict | None" = None) -> dict:
    """Assemble the manifest dict for a checkpoint of `model` at `step`."""
    assert status in RUN_STATUSES, status
    opt = getattr(model, "_optimizer", None)
    mesh = getattr(getattr(opt, "communicator", None), "mesh", None)
    axes = {str(k): int(v) for k, v in mesh.shape.items()} \
        if mesh is not None else None
    man = {
        "kind": "singa_ckpt_manifest",
        "version": MANIFEST_VERSION,
        "step": int(step),
        "ts": round(time.time(), 6),
        "status": status,
        "mesh": {"axes": axes, **distributed.topology()},
        "params": param_signature(model),
        "n_opt_slots": len(opt.state_arrays()) if opt is not None else 0,
        "hlo_fingerprints": [
            {"key": e.get("key"), "fingerprint": e.get("fingerprint")}
            for e in introspect.executable_manifest()[-8:]],
        # the warm store comes with warmstart (item 7)
        "warm_store": None,
    }
    if extra:
        man.update(extra)
    return man


def write_manifest(step_dir: str, manifest: dict) -> str:
    """Atomically write `manifest` next to `step_dir` (tmp, fsync,
    os.replace: a crash mid-write leaves no half manifest). Call only
    after the checkpoint's bytes are durable
    (`overlap.wait_for_checkpoints`)."""
    path = manifest_path(step_dir)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, separators=(",", ":"), default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_manifest(step_dir: str) -> "dict | None":
    """The manifest of `step_dir`, or None when it is missing or
    unreadable (the checkpoint is then not known to be complete)."""
    try:
        with open(manifest_path(step_dir), encoding="utf-8") as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(man, dict) \
            or man.get("kind") != "singa_ckpt_manifest" \
            or not isinstance(man.get("step"), int):
        return None
    return man


def is_complete_checkpoint(step_dir: str) -> bool:
    """True when `step_dir` exists and carries a readable manifest."""
    return os.path.isdir(step_dir) and read_manifest(step_dir) is not None


def validate_manifest(manifest: dict, model) -> list:
    """Fatal problems restoring this checkpoint into `model` (empty ==
    compatible): the parameter signature must match exactly; the
    topology is not checked."""
    problems = []
    want = manifest.get("params")
    if not isinstance(want, dict):
        return [f"manifest has no params signature "
                f"(version {manifest.get('version')})"]
    have = param_signature(model)
    for name in sorted(set(want) | set(have)):
        a, b = want.get(name), have.get(name)
        if a is None:
            problems.append(f"param {name!r} exists only in the live model")
        elif b is None:
            problems.append(f"param {name!r} exists only in the checkpoint")
        elif list(a["shape"]) != list(b["shape"]) \
                or a["dtype"] != b["dtype"]:
            problems.append(
                f"param {name!r} is {a['shape']}/{a['dtype']} in the "
                f"checkpoint but {b['shape']}/{b['dtype']} live")
    return problems


# ---- discovery & retention -------------------------------------------------

def list_checkpoints(ckpt_dir: str, complete_only: bool = True):
    """[(step, path, manifest_or_None)] under `ckpt_dir`, ascending by
    step; with complete_only (default) the entries without a readable
    manifest are left out."""
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        m = _STEP_DIR_RE.match(name)
        if not m:
            continue
        path = os.path.join(os.path.abspath(ckpt_dir), name)
        if not os.path.isdir(path):
            continue
        man = read_manifest(path)
        if complete_only and man is None:
            continue
        out.append((int(m.group(1)), path, man))
    out.sort(key=lambda t: t[0])
    return out


def latest_checkpoint(ckpt_dir: str):
    """(path, manifest) of the newest complete checkpoint under
    `ckpt_dir`, or None."""
    cands = list_checkpoints(ckpt_dir, complete_only=True)
    if not cands:
        return None
    _, path, man = cands[-1]
    return path, man


def set_aside_checkpoint(path: str, suffix: str, keep: int = 3) -> str:
    """Rename the checkpoint directory `path` to `path + suffix` (numbered
    on a collision), its manifest first, so a crash between the two
    renames leaves an unmanifested directory, never a manifested half.
    At most `keep` set-asides of (path, suffix) are kept, the oldest
    deleted first. Returns the destination."""
    dst = path + suffix
    i = 0
    while os.path.exists(dst):
        i += 1
        dst = f"{path}{suffix}{i}"
    try:
        os.replace(manifest_path(path), dst + MANIFEST_SUFFIX)
    except OSError:
        pass   # no manifest to move
    os.replace(path, dst)
    base = os.path.basename(path) + suffix
    parent = os.path.dirname(path)
    aside = [os.path.join(parent, n) for n in os.listdir(parent)
             if n.startswith(base) and not n.endswith(MANIFEST_SUFFIX)
             and os.path.isdir(os.path.join(parent, n))]
    aside.sort(key=os.path.getmtime)
    for p in aside[:-keep] if len(aside) > keep else []:
        try:
            os.remove(p + MANIFEST_SUFFIX)
        except OSError:
            pass
        shutil.rmtree(p, ignore_errors=True)
    return dst


def keep_last_k(ckpt_dir: str, k: int) -> list:
    """Retention: delete all but the newest `k` complete checkpoints
    (manifest first, then the directory). Incomplete directories, an
    in-flight async write among them, are left alone. Returns the
    removed paths."""
    if k <= 0:
        return []
    removed = []
    cands = list_checkpoints(ckpt_dir, complete_only=True)
    for _step, path, _man in cands[:-k] if len(cands) > k else []:
        try:
            os.remove(manifest_path(path))
        except OSError:
            pass
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    return removed


# ---- the supervised training controller ------------------------------------

_active_controller: "TrainController | None" = None


class TrainController:
    """Supervised training loop that survives failure.

    `model` must be compiled (its optimizer attached); `ckpt_dir` is the
    run's checkpoint root. The controller saves a full training
    checkpoint (`Model.save_checkpoint`, async by default) every
    `save_every_steps` steps and/or `save_every_s` seconds, writes its
    manifest once the write is durable and prunes to `keep` complete
    checkpoints; auto-resumes from the latest valid checkpoint on `fit()`
    (corrupt ones skipped and counted, older ones tried when a restore
    fails, consumed batches replayed without stepping); retries
    transient save/restore failures `retries` times (decorrelated jitter
    from `random.Random(retry_seed)`, capped by `backoff_max_s` and in
    total by `max_elapsed_s`); restarts in-process up to `max_restarts`
    times when a step raises or hangs; honors SIGTERM/SIGINT as
    preemption (`handle_signals`, main thread only); and routes a
    `HealthError` halt into a final "halt" checkpoint before re-raising
    it with a `.resilience` report."""

    def __init__(self, model, ckpt_dir: str, save_every_steps: int = 0,
                 save_every_s: float = 0.0, keep: int = 3,
                 max_restarts: int = 2, retries: int = 3,
                 backoff_s: float = 0.05, backoff_mult: float = 2.0,
                 backoff_max_s: float = 30.0, retry_jitter: bool = True,
                 max_elapsed_s: "float | None" = None,
                 retry_seed: "int | None" = None,
                 handle_signals: bool = True, async_save: bool = True,
                 verbose: int = 0):
        self.model = model
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.save_every_steps = int(save_every_steps)
        self.save_every_s = float(save_every_s)
        self.keep = int(keep)
        self.max_restarts = int(max_restarts)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.backoff_mult = float(backoff_mult)
        self.backoff_max_s = float(backoff_max_s)
        self.retry_jitter = bool(retry_jitter)
        self.max_elapsed_s = (float(max_elapsed_s)
                              if max_elapsed_s is not None else None)
        self._retry_rng = random.Random(retry_seed)
        self.handle_signals = bool(handle_signals)
        self.async_save = bool(async_save)
        self.verbose = int(verbose)
        self._step = 0            # completed steps (== next step index)
        self._cursor = 0          # batches consumed in the current pass
        self._resumed_step = 0
        self._resume_done = False
        self.resume_restore_s = 0.0
        self._restarts = 0
        self._preempt = None      # signum once a preemption was requested
        self._pending_manifest = None   # (path, manifest) awaiting barrier
        self._last_saved_step = -1
        self._last_save_time = None
        self._last_ckpt_path = None
        self._history = {}        # global step -> loss (device tensor/float)
        self._status = "idle"

    # -- logging / telemetry ----------------------------------------------
    def _log(self, msg):
        if self.verbose:
            print(f"[resilience] {msg}", flush=True)

    def _emit(self, event, **kw):
        observe.get_registry().emit(
            {"kind": "resilience", "event": event, "step": self._step,
             **kw})

    # -- retry-with-backoff wrapper ----------------------------------------
    def _retry_delay(self, attempt: int, prev: float) -> float:
        """Next backoff sleep: decorrelated jitter, uniform(base, 3 x the
        previous sleep), or with retry_jitter=False the exponential
        schedule; capped at `backoff_max_s` either way."""
        if self.retry_jitter:
            hi = max(self.backoff_s, prev * 3.0)
            delay = self._retry_rng.uniform(self.backoff_s, hi)
        else:
            delay = self.backoff_s * (self.backoff_mult ** (attempt - 1))
        return min(delay, self.backoff_max_s)

    def _retry(self, what, fn):
        attempt = 0
        t_start = time.monotonic()
        prev = self.backoff_s
        while True:
            try:
                return fn()
            except (KeyboardInterrupt, SystemExit, health.HealthError):
                raise
            except Exception as e:
                attempt += 1
                elapsed = time.monotonic() - t_start
                if attempt > self.retries:
                    raise
                if self.max_elapsed_s is not None \
                        and elapsed >= self.max_elapsed_s:
                    self._emit("retry_exhausted", what=what,
                               attempt=attempt,
                               elapsed_s=round(elapsed, 4),
                               max_elapsed_s=self.max_elapsed_s,
                               error=f"{type(e).__name__}: {e}")
                    raise
                m = _metrics()
                m["retries"].inc()
                delay = self._retry_delay(attempt, prev)
                if self.max_elapsed_s is not None:
                    delay = min(delay, max(
                        0.0, self.max_elapsed_s - elapsed))
                prev = delay
                m["retry_s"].inc(delay)
                self._emit("retry", what=what, attempt=attempt,
                           backoff_s=round(delay, 4),
                           error=f"{type(e).__name__}: {e}")
                self._log(f"{what} failed ({e}); retry {attempt}/"
                          f"{self.retries} in {delay:.3f}s")
                time.sleep(delay)

    # -- checkpointing ------------------------------------------------------
    def _flush_pending_manifest(self):
        """Write the previous save's manifest; called only once a barrier
        proved its bytes durable (`_settle_pending`, the final `_save`).
        In a data-parallel job every rank waits here for the others, and
        rank 0 writes it."""
        if self._pending_manifest is None:
            return
        path, man = self._pending_manifest
        self._pending_manifest = None
        distributed.barrier()
        if distributed.process_index() == 0:
            write_manifest(path, man)

    def _save(self, status: str = "ok", final: bool = False):
        if self._step <= self._last_saved_step and not final:
            return
        step = self._step
        # the losses come to the host in one transfer (the save blocks on
        # the device anyway)
        self._flush_losses()

        def do_save():
            # the ckpt_save deadline arms over the whole save (the model's
            # own guard nests); an injected stall breaches it
            with watchdog.guard("ckpt_save", step=step):
                fault_point("ckpt.save", step=step)
                return self.model.save_checkpoint(
                    self.ckpt_dir, step=step, async_save=self.async_save)

        if step > self._last_saved_step:
            # barrier the previous async write here, not inside a retried
            # save: a deferred error drained there would let the retry
            # succeed and the dead save's manifest be flushed
            self._settle_pending()
            path = self._retry("checkpoint save", do_save)
            self._pending_manifest = (
                path, build_manifest(self.model, step, status=status))
            self._last_saved_step = step
            self._last_ckpt_path = path
            self._last_save_time = time.monotonic()
            m = _metrics()
            m["saves"].inc()
            m["save_age"].set(0.0)
            self._emit("save", path=path, status=status, final=final)
        if final:
            # the durability barrier, not retried: a second wait after a
            # drained failure would succeed and manifest dead bytes
            from . import overlap
            if status != "ok" and self._pending_manifest is not None:
                p, man = self._pending_manifest
                self._pending_manifest = (p, dict(man, status=status))
            try:
                overlap.wait_for_checkpoints()
            except Exception:
                # the raise may be another actor's save: ours is durable
                # unless the per-path record names it
                if self._pending_manifest is not None and \
                        not overlap.write_failed(self._pending_manifest[0]):
                    self._flush_pending_manifest()
                else:
                    self._pending_manifest = None
                raise
            if self._pending_manifest is not None \
                    and overlap.write_failed(self._pending_manifest[0]):
                bad = self._pending_manifest[0]
                self._pending_manifest = None
                raise RuntimeError(
                    f"final checkpoint write to {bad} failed (deferred "
                    f"error was drained by another barrier)")
            self._flush_pending_manifest()
        if distributed.process_index() == 0:
            keep_last_k(self.ckpt_dir, self.keep)

    def _maybe_save(self):
        due = (self.save_every_steps > 0
               and self._step % self.save_every_steps == 0)
        if not due and self.save_every_s > 0:
            last = self._last_save_time
            due = last is None \
                or time.monotonic() - last >= self.save_every_s
        if due:
            self._save()

    # -- resume -------------------------------------------------------------
    def resume(self) -> int:
        """Restore the latest valid checkpoint into the model (older ones
        when a restore fails) and return the resumed step, 0 when
        starting fresh. Idempotent per controller; `fit` calls it."""
        if self._resume_done:
            return self._resumed_step
        self._resume_done = True
        t0 = time.perf_counter()
        self._do_resume(require=False)
        self.resume_restore_s = time.perf_counter() - t0
        return self._resumed_step

    def _settle_pending(self):
        """Make any in-flight async save durable and flush its manifest;
        a failed write drops the pending manifest (reported, not raised:
        the next save proceeds, a resume falls back to an older
        checkpoint)."""
        from . import overlap
        if self._pending_manifest is None \
                and not overlap.pending_checkpoints():
            return
        try:
            overlap.wait_for_checkpoints()
        except Exception as e:
            if self._pending_manifest is not None and \
                    not overlap.write_failed(self._pending_manifest[0]):
                self._flush_pending_manifest()
            else:
                self._pending_manifest = None
            self._emit("pending_save_failed",
                       error=f"{type(e).__name__}: {e}")
            return
        # another actor's barrier may have drained our failure: the
        # per-path record outlives the drain
        if self._pending_manifest is not None \
                and overlap.write_failed(self._pending_manifest[0]):
            path = self._pending_manifest[0]
            self._pending_manifest = None
            self._emit("pending_save_failed", path=path,
                       error="deferred write failed "
                             "(drained by another barrier)")
            return
        self._flush_pending_manifest()

    def _do_resume(self, require: bool):
        m = _metrics()
        self._settle_pending()
        cands = list_checkpoints(self.ckpt_dir, complete_only=False)
        skipped = 0
        for step, path, man in reversed(cands):
            if man is None:
                skipped += 1
                m["corrupt"].inc()
                self._emit("skip_checkpoint", path=path,
                           why="missing/corrupt manifest")
                continue
            problems = validate_manifest(man, self.model)
            if problems:
                skipped += 1
                m["corrupt"].inc()
                self._emit("skip_checkpoint", path=path,
                           why="; ".join(problems[:3]))
                continue
            try:
                self._retry("checkpoint restore",
                            lambda p=path: self.model.load_checkpoint(p))
            except Exception as e:
                skipped += 1
                m["corrupt"].inc()
                self._emit("skip_checkpoint", path=path,
                           why=f"restore failed: {e}")
                continue
            self._step = self._resumed_step = int(man["step"])
            self._last_saved_step = self._step
            self._last_ckpt_path = path
            m["resumed_step"].set(float(self._step))
            saved = (man.get("mesh") or {}).get("n_devices")
            live = distributed.topology()["n_devices"]
            self._emit("resume", path=path, resumed_step=self._step,
                       skipped=skipped, saved_devices=saved,
                       live_devices=live,
                       resharded=bool(saved and saved != live))
            self._log(f"resumed from {path} at step {self._step}")
            # checkpoints newer than the resume point belong to a dead
            # timeline: unmanifested debris is deleted, manifested ones
            # (skipped, perhaps transiently) are set aside, never
            # destroyed; by rank 0, once every rank has restored
            distributed.barrier()
            if distributed.process_index() != 0:
                return
            for s2, p2, m2 in cands:
                if s2 <= self._step:
                    continue
                if m2 is None:
                    try:
                        os.remove(manifest_path(p2))
                    except OSError:
                        pass
                    shutil.rmtree(p2, ignore_errors=True)
                    self._emit("purge_stale_checkpoint", path=p2)
                else:
                    dst = set_aside_checkpoint(p2, ".stale")
                    self._emit("stale_checkpoint_set_aside",
                               src=p2, dst=dst)
            return
        if require:
            raise RuntimeError(
                f"no restorable checkpoint under {self.ckpt_dir} "
                f"({skipped} candidate(s) skipped)")
        self._step = self._resumed_step = 0
        m["resumed_step"].set(0.0)

    # -- signals ------------------------------------------------------------
    def _request_preempt(self, signum, frame=None):
        self._preempt = signum

    def _install_signals(self):
        if not self.handle_signals \
                or threading.current_thread() is not threading.main_thread():
            return None
        prev = {}
        for sig in (_signal.SIGTERM, _signal.SIGINT):
            try:
                prev[sig] = _signal.signal(sig, self._request_preempt)
            except (ValueError, OSError):
                pass
        return prev

    @staticmethod
    def _restore_signals(prev):
        for sig, handler in (prev or {}).items():
            try:
                _signal.signal(sig, handler)
            except (ValueError, OSError):
                pass

    # -- the loop -----------------------------------------------------------
    def _record_loss(self, out):
        loss = out[1] if isinstance(out, (tuple, list)) and len(out) > 1 \
            else out
        loss = getattr(loss, "data", loss) if not torch.is_tensor(loss) \
            else loss
        if torch.is_tensor(loss):
            # kept on the device: the host reads them in one transfer
            self._history[self._step] = loss.detach()

    def _flush_losses(self):
        keys = [k for k, v in self._history.items()
                if not isinstance(v, float)]
        if keys:
            vals = torch.stack([self._history[k].float().reshape(())
                                for k in keys]).cpu().tolist()
            for k, v in zip(keys, vals):
                self._history[k] = float(v)

    def _fit_once(self, data, epochs):
        _end = object()
        self._cursor = 0
        multi = distributed.process_count() > 1
        for _epoch in range(epochs):
            it = iter(data)
            while True:
                if self._preempt_agreed(multi):
                    return self._preempt_exit()
                if self._cursor < self._step:
                    # replay: consumed before the resumed checkpoint
                    if next(it, _end) is _end:
                        break
                    self._cursor += 1
                    continue
                with observe.span("data.wait"), \
                        watchdog.guard("data_wait", step=self._step):
                    fault_point("data.next", step=self._step)
                    batch = next(it, _end)
                if batch is _end:
                    break
                if not isinstance(batch, (tuple, list)):
                    batch = (batch,)
                # the step guard encloses the fault point and the model
                # call (the model's own guard nests, counting once here)
                with watchdog.guard("step", step=self._step):
                    fault_point("step", step=self._step)
                    # a data-parallel job stops only where the ranks agreed
                    preempted = self._preempt is not None and not multi
                    out = None if preempted else self.model(*batch)
                if preempted:
                    return self._preempt_exit()
                self._record_loss(out)
                self._step += 1
                self._cursor += 1
                self._maybe_save()
        self._save(final=True)
        self._status = "completed"
        return self._report()

    def _preempt_agreed(self, multi: bool) -> bool:
        """Whether to stop before the next step: this process's signal,
        or in a job of several ranks any rank's (a MAX all-reduce at
        every step boundary), so all of them stop after the same step."""
        if not multi:
            return self._preempt is not None
        import torch.distributed as dist
        flag = torch.tensor([0 if self._preempt is None else 1],
                            device=distributed.rank_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if flag.item() and self._preempt is None:
            self._preempt = _signal.SIGTERM
        return bool(flag.item())

    def _preempt_exit(self):
        signum = self._preempt
        self._log(f"preemption (signal {signum}): finishing with a "
                  "final checkpoint")
        self._save(status="preempt", final=True)
        _metrics()["preempt"].inc()
        self._emit("preempted", signum=signum,
                   checkpoint=self._last_ckpt_path)
        self._status = "preempted"
        return self._report()

    def fit(self, data, epochs: int = 1) -> dict:
        """Run the supervised loop over `data` (a re-iterable of per-batch
        argument tuples, as `Model.fit` takes) and return the report:
        status ("completed" | "preempted"), resumed_step, steps_run,
        restarts, history ([[global_step, loss], ...]), last_checkpoint.
        A HealthError halt raises after a final "halt" checkpoint; a
        watchdog HangError restarts from the latest checkpoint (and
        clears the watchdog's hang verdict) while restarts remain."""
        global _active_controller
        if iter(data) is data:
            raise ValueError(
                "`data` must be re-iterable (a list, not a generator): "
                "the resilient loop replays it across epochs, restarts "
                "and resumes")
        _active_controller = self
        self._status = "running"
        self._preempt = None
        prev_handlers = self._install_signals()
        try:
            self.resume()
            if self._last_save_time is None:
                self._last_save_time = time.monotonic()
            while True:
                try:
                    return self._fit_once(data, epochs)
                except watchdog.HangError as e:
                    if self._restarts < self.max_restarts:
                        self._emit("hang_restart", op=e.op,
                                   seconds=e.seconds,
                                   hosts=list(e.hosts),
                                   bundle=e.bundle_path)
                        self._restart_after(e, "hung")
                        wd = watchdog.get_watchdog()
                        if wd is not None:
                            wd.clear_hang()
                        continue
                    self._halt_exit(e)
                except health.HealthError as e:
                    self._halt_exit(e)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as e:
                    if self._restarts >= self.max_restarts:
                        self._status = "failed"
                        raise
                    self._restart_after(e, "failed")
        finally:
            # _active_controller stays set: the report keeps answering
            # for the last run
            self._restore_signals(prev_handlers)

    def _restart_after(self, e, verb: str):
        """The in-process restart: count it and restore the latest durable
        checkpoint (required: the model's state is suspect after a
        mid-step failure)."""
        self._restarts += 1
        _metrics()["restarts"].inc()
        self._emit("restart", n=self._restarts,
                   error=f"{type(e).__name__}: {e}")
        self._log(f"step {self._step} {verb} ({e}); "
                  f"restart {self._restarts}/"
                  f"{self.max_restarts} from latest checkpoint")
        self._resume_done = True
        self._do_resume(require=True)

    def _halt_exit(self, e):
        """The HealthError save-then-stop path: a final checkpoint with
        manifest status "halt", the report attached, re-raise."""
        self._status = "halted"
        try:
            self._save(status="halt", final=True)
        except Exception as save_err:
            self._emit("halt_save_failed", error=str(save_err))
        e.resilience = self._report()
        hosts = getattr(e, "hosts", None)
        if hosts:
            e.resilience["exclude_hosts"] = list(hosts)
        raise e

    def _report(self) -> dict:
        self._flush_losses()
        hist = sorted(self._history.items())
        return {
            "status": self._status,
            "resumed_step": self._resumed_step,
            "resume_restore_s": round(self.resume_restore_s, 4),
            "final_step": self._step,
            "steps_run": len([k for k, _ in hist
                              if k >= self._resumed_step]),
            "restarts": self._restarts,
            "history": [[k, v] for k, v in hist],
            "last_checkpoint": self._last_ckpt_path,
        }

    # -- status -------------------------------------------------------------
    def status_lines(self) -> list:
        age = None if self._last_save_time is None \
            else time.monotonic() - self._last_save_time
        if age is not None:
            _metrics()["save_age"].set(age)
        n_complete = len(list_checkpoints(self.ckpt_dir))
        latest = os.path.basename(self._last_ckpt_path) \
            if self._last_ckpt_path else None
        return [
            f"controller: status={self._status} step={self._step} "
            f"resumed_from={self._resumed_step} restarts={self._restarts}",
            f"checkpoints: dir={self.ckpt_dir} complete={n_complete} "
            f"latest={latest} "
            f"last_save_age_s={round(age, 1) if age is not None else None}",
        ]


def fit_resilient(model, data, ckpt_dir: str, epochs: int = 1,
                  **controller_kwargs) -> dict:
    """One call: a TrainController over `model`/`ckpt_dir` running
    `fit(data, epochs)`. Returns the controller's report."""
    return TrainController(model, ckpt_dir,
                           **controller_kwargs).fit(data, epochs=epochs)


def active_controller() -> "TrainController | None":
    """The last controller to run fit() in this process."""
    return _active_controller


def resilience_report() -> str:
    """Text block of the controller's state and the resilience
    counters."""
    reg = observe.get_registry()
    lines = ["== resilience =="]
    ctrl = _active_controller
    if ctrl is None:
        lines.append("controller: none (fit_resilient not used)")
    else:
        lines.extend(ctrl.status_lines())

    def _val(name):
        c = reg.get(name)
        if c is None:
            return 0
        return int(sum(v for _n, _k, v in c.samples()))

    lines.append(
        f"counters: saves={_val('singa_resilience_saves_total')} "
        f"retries={_val('singa_resilience_retries_total')} "
        f"restarts={_val('singa_resilience_restarts_total')} "
        f"corrupt_skipped={_val('singa_resilience_corrupt_skipped_total')} "
        f"preempts={_val('singa_resilience_preempt_total')} "
        f"faults_injected={_val('singa_resilience_faults_injected_total')}")
    return "\n".join(lines)


# ---- CLI: the kill-and-resume A/B ------------------------------------------
# `--worker` trains a small deterministic MLP under a TrainController (the
# subprocess leg); `--ab` runs three legs (an uninterrupted baseline, a
# SIGTERM'd run, and its resume) and writes a JSON record comparing the
# loss curves. A leg of N > 1 devices is N worker processes (ranks) that
# join one process group (SINGA_COORDINATOR, SINGA_NPROCS, SINGA_PROC_ID)
# and train under DistOpt over a data mesh of N. The killed leg's ranks
# each write a marker and hold after their first checkpoint; the parent
# sends SIGTERM once every marker is there, so the kill never races the
# run to its end.

def _worker_build(n_devices: int, batch: int, seed: int, device: str):
    import numpy as np

    from . import device as device_mod
    from . import layer, opt, tensor
    from . import model as model_mod
    from .parallel import data_parallel_mesh

    class Net(model_mod.Model):
        def __init__(self):
            super().__init__()
            self.fc1 = layer.Linear(16)
            self.relu = layer.ReLU()
            self.fc2 = layer.Linear(4)
            self.sce = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc2(self.relu(self.fc1(x)))

        def train_one_batch(self, x, y):
            loss = self.sce(self.forward(x), y)
            self.optimizer(loss)
            return loss

    dev = device_mod.of(device_mod.resolve(device))
    dev.SetRandSeed(seed)
    rng = np.random.RandomState(seed)
    X = rng.randn(batch, 8).astype(np.float32)
    Y = rng.randint(0, 4, batch).astype(np.int32)
    m = Net()
    sgd = opt.SGD(lr=0.1, momentum=0.9)
    if n_devices > 1:
        sgd = opt.DistOpt(sgd, mesh=data_parallel_mesh(n_devices))
    m.set_optimizer(sgd)
    tx = tensor.from_numpy(X, dev)
    ty = tensor.from_numpy(Y, dev)
    m.compile([tx], is_train=True, use_graph=True)
    return m, tx, ty


class _SleepySrc:
    """`steps` copies of one batch with a host-side pause before each.
    With `hold_at` > 0 the source writes the marker file `hold_path`
    before its batch `hold_at` (the controller has started its first
    checkpoint by then) and holds there until `released()` (the A/B
    parent's SIGTERM has landed) or `hold_s` pass: the kill then lands at
    a step the run reports, whatever the load on the host."""

    def __init__(self, tx, ty, steps, sleep_s, hold_at=0, hold_path=None,
                 released=None, hold_s=0.0):
        self.tx, self.ty = tx, ty
        self.steps, self.sleep_s = steps, sleep_s
        self.hold_at, self.hold_path = hold_at, hold_path
        self.released, self.hold_s = released, hold_s

    def _hold(self):
        with open(self.hold_path, "w", encoding="utf-8") as f:
            f.write(str(self.hold_at))
        deadline = time.monotonic() + self.hold_s
        while not self.released() and time.monotonic() < deadline:
            time.sleep(0.01)

    def __iter__(self):
        for i in range(self.steps):
            if self.sleep_s:
                time.sleep(self.sleep_s)
            if self.hold_at and i == self.hold_at:
                self._hold()
            yield (self.tx, self.ty)


def _worker_main(args) -> int:
    if args.mesh_devices > 1:
        distributed.init(device=args.device)
    m, tx, ty = _worker_build(args.mesh_devices, args.batch, args.seed,
                              args.device)
    ctrl = TrainController(
        m, args.ckpt_dir, save_every_steps=args.save_every,
        keep=args.keep, handle_signals=True, verbose=1)
    hold_path = None
    if args.hold_dir:
        hold_path = os.path.join(args.hold_dir,
                                 f"held.{distributed.process_index()}")
    src = _SleepySrc(tx, ty, args.steps, args.step_sleep,
                     args.save_every if hold_path else 0, hold_path,
                     lambda: ctrl._preempt is not None, args.timeout)
    try:
        report = ctrl.fit(src, epochs=1)
    except health.HealthError as e:
        report = getattr(e, "resilience", {"status": "halted"})
    from . import overlap
    overlap.wait_for_checkpoints()
    if args.report_out and distributed.process_index() == 0:
        with open(args.report_out, "w", encoding="utf-8") as f:
            json.dump(report, f)
    print(json.dumps(report))
    distributed.shutdown()
    # preemption is a clean exit: the scheduler asked, we checkpointed
    return 0 if report["status"] in ("completed", "preempted") else 1


def _spawn_worker(py, root, ckpt_dir, n_devices, steps, save_every,
                  report_out, step_sleep, seed, batch, device,
                  hold_dir=None, timeout=600.0):
    """The leg's worker processes: one, or one per rank of a process
    group over a free localhost port."""
    import socket
    import subprocess
    import sys
    cmd = [py, "-m", "singa_tpu_torch.resilience", "--worker",
           "--ckpt-dir", ckpt_dir, "--mesh-devices", str(n_devices),
           "--steps", str(steps), "--save-every", str(save_every),
           "--report-out", report_out, "--step-sleep", str(step_sleep),
           "--seed", str(seed), "--batch", str(batch), "--device", device]
    if hold_dir is not None:
        cmd += ["--hold-dir", hold_dir, "--timeout", str(timeout)]
    env = dict(os.environ)
    if n_devices > 1:
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        env.update(SINGA_COORDINATOR=f"127.0.0.1:{port}",
                   SINGA_NPROCS=str(n_devices))
    procs = []
    for rank in range(n_devices):
        env["SINGA_PROC_ID"] = str(rank)
        procs.append(subprocess.Popen(cmd, cwd=root, env=dict(env),
                                      stdout=sys.stderr, stderr=sys.stderr))
    return procs


def _ab_main(args) -> int:
    import sys
    import tempfile
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    work = tempfile.mkdtemp(prefix="singa_resilience_ab_")
    py = sys.executable
    rec = {"n_devices_a": args.devices_a, "n_devices_b": args.devices_b,
           "steps": args.steps, "save_every": args.save_every,
           "batch": args.batch, "seed": args.seed, "device": args.device,
           "ok": False}

    def leg(name, ckpt_dir, n_devices, step_sleep=0.0, kill=False):
        import subprocess
        rep_path = os.path.join(work, f"{name}.json")
        hold_dir = os.path.join(work, f"{name}.held") if kill else None
        if kill:
            os.makedirs(hold_dir)
        procs = _spawn_worker(py, root, ckpt_dir, n_devices, args.steps,
                              args.save_every, rep_path, step_sleep,
                              args.seed, args.batch, args.device, hold_dir,
                              args.timeout)
        if kill:
            # every rank holds after its first checkpoint, marked by a
            # file, until its SIGTERM lands: wait for all the markers,
            # then preempt every rank
            deadline = time.monotonic() + args.timeout
            while time.monotonic() < deadline:
                if len(os.listdir(hold_dir)) == n_devices:
                    break
                if any(p.poll() is not None for p in procs):
                    break
                time.sleep(0.05)
            for p in procs:
                if p.poll() is None:
                    p.send_signal(_signal.SIGTERM)
        deadline = time.monotonic() + args.timeout
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(0.0,
                                              deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        rc = None if None in rcs else max(rcs, key=abs)
        report = {}
        try:
            with open(rep_path, encoding="utf-8") as f:
                report = json.load(f)
        except (OSError, ValueError):
            pass
        if rc is None and not report:
            report = {"status": "timeout"}
        return rc, report

    try:
        rc_a, rep_a = leg("baseline", os.path.join(work, "ck_a"),
                          args.devices_a)
        rec["baseline_rc"] = rc_a
        rec["baseline_status"] = rep_a.get("status")
        # the ranks hold after their first checkpoint until the SIGTERM
        ck_b = os.path.join(work, "ck_b")
        rc_k, rep_k = leg("killed", ck_b, args.devices_a,
                          step_sleep=args.step_sleep, kill=True)
        rec["killed_rc"] = rc_k
        rec["killed_status"] = rep_k.get("status")
        rec["killed_final_step"] = rep_k.get("final_step")
        rc_r, rep_r = leg("resumed", ck_b, args.devices_b)
        rec["resumed_rc"] = rc_r
        rec["resumed_status"] = rep_r.get("status")
        rec["resumed_step"] = rep_r.get("resumed_step")
        rec["resume_restore_s"] = rep_r.get("resume_restore_s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    base = dict((int(k), float(v)) for k, v in rep_a.get("history", []))
    res = dict((int(k), float(v)) for k, v in rep_r.get("history", []))
    deltas = [abs(base[k] - res[k]) for k in res if k in base]
    rec["compared_steps"] = len(deltas)
    rec["max_abs_loss_delta"] = round(max(deltas), 8) if deltas else None
    rec["ok"] = bool(
        rc_a == 0 and rc_k == 0 and rc_r == 0
        and rep_k.get("status") == "preempted"
        and rep_r.get("status") == "completed"
        and (rep_r.get("resumed_step") or 0) > 0
        and deltas and max(deltas) < args.tolerance)
    out = os.path.abspath(args.out)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps(rec, indent=1))
    return 0 if rec["ok"] else 1


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m singa_tpu_torch.resilience",
        description="kill-and-resume harness (worker + A/B orchestrator); "
                    "a leg of N > 1 devices runs N ranks under DistOpt")
    p.add_argument("--worker", action="store_true",
                   help="run one training leg under a TrainController")
    p.add_argument("--ab", action="store_true",
                   help="run the kill-and-resume A/B as subprocesses")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--save-every", type=int, default=3)
    p.add_argument("--keep", type=int, default=3)
    p.add_argument("--mesh-devices", type=int, default=1)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--step-sleep", type=float, default=0.0)
    p.add_argument("--report-out", default=None)
    p.add_argument("--hold-dir", default=None,
                   help="(worker) write held.<rank> there before the step "
                        "after the first checkpoint and hold until a "
                        "SIGTERM lands (at most --timeout seconds)")
    p.add_argument("--devices-a", type=int, default=1)
    p.add_argument("--devices-b", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--tolerance", type=float, default=1e-4)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--out", default="RESILIENCE_torch.json")
    args = p.parse_args(argv)
    most = max(args.devices_a, args.devices_b, args.mesh_devices)
    if min(args.devices_a, args.devices_b, args.mesh_devices) < 1:
        p.error("a leg needs at least one device")
    if args.device == "cuda" and most > 1 \
            and most > torch.cuda.device_count():
        p.error(f"{most} ranks over NCCL need {most} cards; this host has "
                f"{torch.cuda.device_count()} (one rank a card)")
    if args.worker:
        if not args.ckpt_dir:
            p.error("--worker requires --ckpt-dir")
        return _worker_main(args)
    if args.ab:
        return _ab_main(args)
    p.error("pass --worker or --ab")
    return 2


__all__ = [
    "FaultPlan", "install_fault_plan", "clear_fault_plan", "fault_point",
    "manifest_path", "param_signature", "build_manifest", "write_manifest",
    "read_manifest", "is_complete_checkpoint", "validate_manifest",
    "list_checkpoints", "latest_checkpoint", "keep_last_k",
    "set_aside_checkpoint",
    "TrainController", "fit_resilient", "active_controller",
    "resilience_report", "RUN_STATUSES", "MANIFEST_SUFFIX",
    "MANIFEST_VERSION", "main",
]

if __name__ == "__main__":
    import sys
    sys.exit(main())
