"""Training-health telemetry (counterpart of singa_tpu/health.py): step
statistics computed on the device, the anomaly policies, the flight
recorder, and the serving-side non-finite logit watch.

On the device (`StepStatsCollector`): the optimizer's
`backward_and_update` feeds the active collector the loss and every
(param, grad, pre-update value, post-update value), and the collector
reduces them with fp32 torch ops into the step's stats: the global grad
norm, the count of non-finite grad entries, whether the loss is finite,
and per layer group (the first component of the parameter's name) the
parameter norm, the update norm and their ratio. `finalize` packs every
scalar of the step into one flat fp32 tensor (`packed`), so the host
reads a step's stats with a single copy. The JAX package reduces with
one variadic `lax.reduce` per gradient; here each statistic is its own
torch reduction (no hand-written kernel: the work is a sum).

The port's backward hands over every gradient before the first update,
so the anomaly flag (a non-finite grad entry or loss) is known before any
parameter changes. Under the `skip_step` policy in graph mode the
collector keeps the step's pre-update values of each parameter and its
optimizer slots in a persistent scratch buffer (`Scratch`, one
parameter's worth at a time, made at the step's first, eager run) and
selects them back with `torch.where(flag, old, new)` after the update,
as the step counter is; no host read and no branch on the flag, so the
select is recorded in a CUDA graph and runs at every replay.

On the host (`HealthMonitor`): the `singa_health_*` metrics, an
EMA-based loss-spike score, a grad-norm ceiling, and the policy on an
anomaly: "warn" (count, event, flight-recorder dump), "skip_step" (the
update was discarded on the device; a loss spike downgrades to warn),
"halt" (dump, then raise HealthError).

Under data parallelism (`opt.DistOpt` with a process group) the model
gives the collector the optimizer's communicator: the collector then sees
the reduced gradients, its anomaly flag is the cross-rank OR
(`Communicator.agree_any`) before the first update, so skip_step fires on
every rank in the same step, and `finalize` takes the largest
non-finite counts across the ranks (`all_reduce_max`: a sum would count
a replicated gradient world_size times) and the mean of the loss and the
squared norms, so every rank records the same stats. The bundle header's
`executables` are the last eight builds of `introspect`'s manifest (None
before any build), which pin the step a dump came from. The
memory ledger attributes the step inputs a graph-mode step retains for
the flight recorder (`memory.track_model`) to `flight_snapshot`, and a
dump notes the batch it is given under the same region; a host copy
(the port's batch snapshots are numpy arrays) holds no device tensor
and notes nothing, as in the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque

import numpy as np
import torch

from . import introspect, observe

POLICIES = ("warn", "skip_step", "halt")

# anomaly kinds (the `kind` label on singa_health_anomaly_total)
KIND_NONFINITE_GRAD = "nonfinite_grad"
KIND_NONFINITE_LOSS = "nonfinite_loss"
KIND_LOSS_SPIKE = "loss_spike"
KIND_GRAD_NORM = "grad_norm_limit"
KIND_STRAGGLER = "straggler"
KIND_MEM_LEAK = "mem_leak"
KIND_HANG = "hang"
KIND_SLO = "slo"
KIND_DIVERGENCE = "divergence"
KIND_REGRESSION = "regression"

#: non-finite counts travel in the fp32 stats tensor as two exact parts,
#: count // _SPLIT and count % _SPLIT (fp32 holds integers exactly to 2^24)
_SPLIT = 1 << 24


class HealthError(RuntimeError):
    """Raised by the `halt` policy; carries the flight-bundle path.
    `Model.fit` fills `partial` with {"epoch", "steps_completed",
    "losses", "last_loss"} on its way out."""

    def __init__(self, msg, bundle_path=None, stats=None, partial=None):
        super().__init__(msg)
        self.bundle_path = bundle_path
        self.stats = stats
        self.partial = partial


# the collector the optimizer feeds while a step runs (one step runs at a
# time), and the monitor the process reports on
_collector = None
_active_monitor = None


def set_active_monitor(monitor):
    """Register (or clear, with None) the process's reporting monitor."""
    global _active_monitor
    _active_monitor = monitor
    return monitor


def active_monitor():
    """The process's reporting monitor, or None."""
    return _active_monitor


def collector():
    """The active StepStatsCollector, or None when health is off."""
    return _collector


def _set_collector(c):
    global _collector
    _collector = c


class Scratch:
    """Persistent flat buffers, one per (dtype, device), that hold a step's
    pre-update values. `hold(tensors)` copies the tensors into views of
    the buffers (from offset 0: one holder at a time) and returns the
    views. A buffer grows only outside a CUDA-graph capture: the step's
    first, eager run sizes it, and a capture that needed a larger one
    raises. The copies are taken outside autograd: a persistent buffer
    on a parameter's tape would keep its gradient accumulator alive
    from step to step."""

    def __init__(self):
        self._bufs = {}

    @torch.no_grad()
    def hold(self, tensors):
        need = {}
        for t in tensors:
            key = (t.dtype, t.device)
            need[key] = need.get(key, 0) + t.numel()
        for key, n in need.items():
            buf = self._bufs.get(key)
            if buf is None or buf.numel() < n:
                if key[1].type == "cuda" \
                        and torch.cuda.is_current_stream_capturing():
                    raise RuntimeError(
                        "health scratch would grow inside a CUDA-graph "
                        "capture; the step's warm-up run sizes it")
                self._bufs[key] = buf = torch.empty(n, dtype=key[0],
                                                    device=key[1])
        at = dict.fromkeys(need, 0)
        out = []
        for t in tensors:
            key = (t.dtype, t.device)
            v = self._bufs[key][at[key]:at[key] + t.numel()].view(t.shape)
            at[key] += t.numel()
            v.copy_(t)
            out.append(v)
        return out


@torch.no_grad()
def select_back(flag, olds, news):
    """In place: each of `news` takes its `olds` value where `flag` (a 0-d
    bool tensor) is set, else keeps its own."""
    for o, n in zip(olds, news):
        n.copy_(torch.where(flag, o, n))


class StepStatsCollector:
    """Accumulates one step's health statistics on the device.

    `group_of` maps id(raw parameter) -> layer group (the model passes the
    first component of each parameter's name, so "l1.W" and "l1.b" group
    under "l1"); unknown parameters land in "other". With `skip=True` the
    optimizer rolls a flagged step back (`Optimizer.backward_and_update`);
    `scratch` (a `Scratch`) holds the pre-update values, else each is a
    fresh copy. With `comm` (a `parallel.Communicator`) the anomaly flag
    is agreed across its ranks."""

    def __init__(self, group_of=None, skip=False, scratch=None, comm=None):
        self.group_of = group_of or {}
        self.skip = bool(skip)
        self.scratch = scratch
        self.comm = comm
        self.loss = None
        self._gsq = []          # per-grad sum of squares (fp32, 0-d)
        self._nonfinite = []    # per-grad non-finite entry count (int64)
        self._groups = {}       # group -> [[param_sq], [update_sq]]
        self._bad = None
        self.packed = None
        self.layout = None

    # -- feeding --------------------------------------------------------------
    @torch.no_grad()
    def observe_loss(self, loss):
        self.loss = loss.detach().float().reshape(())

    @torch.no_grad()
    def observe_grad(self, param, grad):
        """One post-reduction gradient: its sum of squares and its count
        of non-finite entries."""
        g = grad.detach()
        self._gsq.append(torch.linalg.vector_norm(
            g, dtype=torch.float32).square())
        self._nonfinite.append(g.numel() - torch.isfinite(g).sum())

    @torch.no_grad()
    def observe_update(self, param, old, new):
        """One parameter's pre- and post-update values."""
        new, old = new.detach().float(), old.detach().float()
        slot = self._groups.setdefault(
            self.group_of.get(id(param), "other"), [[], []])
        # norms, one pass each with no temporary, squared back
        slot[0].append(torch.linalg.vector_norm(new).square())
        slot[1].append(torch.dist(new, old).square())

    def observe(self, param, grad, old, new):
        """One (param, grad, pre-update value, post-update value)."""
        self.observe_grad(param, grad)
        self.observe_update(param, old, new)

    @torch.no_grad()
    def _loss(self):
        if self.loss is None:
            dev = self._gsq[0].device if self._gsq else None
            self.loss = torch.full((), float("nan"), dtype=torch.float32,
                                   device=dev)
        return self.loss

    @torch.no_grad()
    def _nf_grads(self, device):
        if not self._nonfinite:
            return torch.zeros((), dtype=torch.long, device=device)
        return torch.stack(self._nonfinite).sum()

    @torch.no_grad()
    def anomaly(self):
        """The step's anomaly flag, a 0-d bool tensor: a non-finite grad
        entry or loss among what was fed so far (fixed at the first
        call), OR-ed across the ranks of `comm`."""
        if self._bad is None:
            loss = self._loss()
            nf_l = (~torch.isfinite(loss)).long()
            bad = (self._nf_grads(loss.device) + nf_l) > 0
            if self.comm is not None:
                bad = self.comm.agree_any(bad)
            self._bad = bad
        return self._bad

    # -- finalize -------------------------------------------------------------
    @torch.no_grad()
    def finalize(self, comm=None):
        """The step's stats as 0-d tensors, {"loss", "grad_norm",
        "nonfinite_grads", "nonfinite_loss", "groups": {group:
        {"param_norm", "update_norm", "update_ratio"}}, "anomaly"}, and
        every scalar packed in order into `self.packed` (one flat fp32
        tensor; `self.layout` names its entries, `unpack` reads it on the
        host).

        With a communicator (the collector's, or `comm` for one made
        without, the JAX package's `finalize(comm)`) that has a process
        group, the counts are the largest over its ranks and the loss and
        squared norms their mean, and the flag is agreed across them."""
        if comm is not None and comm is not self.comm:
            if self.comm is not None:
                raise ValueError("finalize(comm=...) names another "
                                 "communicator than the collector's")
            self.comm = comm
            if self._bad is not None:
                self._bad = comm.agree_any(self._bad)
        comm = self.comm
        dist = comm is not None and comm.group is not None
        loss = self._loss()
        dev = loss.device
        gsq = torch.stack(self._gsq).sum() if self._gsq \
            else torch.zeros((), dtype=torch.float32, device=dev)
        nf_g = self._nf_grads(dev)
        nf_l = (~torch.isfinite(loss)).long()
        bad = self.anomaly()
        if dist:
            ws = comm.world_size
            nf_g = comm.all_reduce_max(nf_g)
            nf_l = comm.all_reduce_max(nf_l)
            gsq = comm.all_reduce(gsq) / ws
            loss = comm.all_reduce(loss) / ws
        stats = {"loss": loss, "grad_norm": torch.sqrt(gsq),
                 "nonfinite_grads": nf_g, "nonfinite_loss": nf_l}
        scalars = [loss, stats["grad_norm"],
                   torch.div(nf_g, _SPLIT, rounding_mode="floor").float(),
                   torch.remainder(nf_g, _SPLIT).float(), nf_l.float(),
                   bad.float()]
        layout = ["loss", "grad_norm", "nonfinite_grads_hi",
                  "nonfinite_grads_lo", "nonfinite_loss", "anomaly"]
        groups = {}
        for grp, (psq, usq) in sorted(self._groups.items()):
            psq, usq = torch.stack(psq).sum(), torch.stack(usq).sum()
            if dist:
                psq = comm.all_reduce(psq) / ws
                usq = comm.all_reduce(usq) / ws
            pn, un = torch.sqrt(psq), torch.sqrt(usq)
            groups[grp] = {"param_norm": pn, "update_norm": un,
                           # the classic LR sanity signal (healthy ~1e-3)
                           "update_ratio": un / torch.clamp(pn, min=1e-12)}
            for k in ("param_norm", "update_norm", "update_ratio"):
                scalars.append(groups[grp][k])
                layout.append((grp, k))
        stats["groups"] = groups
        stats["anomaly"] = bad.int()
        self.packed = torch.stack([s.reshape(()).float() for s in scalars])
        self.layout = layout
        return stats


def unpack(values, layout) -> dict:
    """Host stats from a packed tensor's values (a sequence of floats, in
    `layout`'s order): the JAX package's stats dict with ints for the
    counts and the flag."""
    out = {"groups": {}}
    for key, v in zip(layout, values):
        if isinstance(key, tuple):
            out["groups"].setdefault(key[0], {})[key[1]] = float(v)
        else:
            out[key] = float(v)
    out["nonfinite_grads"] = (int(out.pop("nonfinite_grads_hi")) * _SPLIT
                              + int(out.pop("nonfinite_grads_lo")))
    out["nonfinite_loss"] = int(out["nonfinite_loss"])
    out["anomaly"] = int(out["anomaly"])
    return out


@torch.no_grad()
def apply_skip(stats, old_arrays, new_arrays):
    """Conditional commit: every pre-step tensor where the anomaly flag is
    set, else the updated one. `new_arrays` may be longer than
    `old_arrays` (state created during the step): those roll back to
    zeros, their creation-time value."""
    bad = stats["anomaly"] > 0
    out = [torch.where(bad, o, n) for o, n in zip(old_arrays, new_arrays)]
    out.extend(torch.where(bad, torch.zeros_like(n), n)
               for n in new_arrays[len(old_arrays):])
    return out


# ---- flight recorder -------------------------------------------------------

class FlightRecorder:
    """Bounded ring of the last `capacity` steps' health stats; `dump`
    writes the ring and the recent EventLog tail to a JSONL bundle (plus
    an optional offending-batch snapshot)."""

    def __init__(self, capacity=64, out_dir=".", event_tail=64):
        self.ring = deque(maxlen=int(capacity))
        self.out_dir = str(out_dir)
        self.event_tail = int(event_tail)
        self.last_bundle = None

    def record(self, rec: dict):
        self.ring.append(rec)

    def dump(self, reason: str, step: int, batch_arrays=None,
             path: str | None = None) -> str:
        """Write `flight_step<N>.jsonl` (a header line, one line per ring
        entry, then the EventLog tail) and return its path. With
        `batch_arrays` (host arrays) the batch is written next to it
        through `snapshot.Snapshot` as `<bundle>_batch.*`. The header's
        `executables` are introspect's last eight builds (or None)."""
        os.makedirs(self.out_dir, exist_ok=True)
        if path is None:
            path = os.path.join(self.out_dir, f"flight_step{int(step)}.jsonl")
        tail = list(observe.get_registry().recent)[-self.event_tail:]
        snap_prefix = None
        if batch_arrays:
            from . import memory
            from .snapshot import Snapshot
            # the memory ledger's birth site: tensors held for this
            # snapshot attribute to `flight_snapshot` while they live
            memory.note_arrays(memory.REGION_FLIGHT_SNAPSHOT,
                               list(batch_arrays))
            snap_prefix = os.path.splitext(path)[0] + "_batch"
            with Snapshot(snap_prefix, mode_write=True) as s:
                for i, a in enumerate(batch_arrays):
                    s.write(f"input{i}", np.asarray(a))
        header = {"kind": "flight_header", "ts": round(time.time(), 6),
                  "reason": reason, "step": int(step),
                  "n_steps": len(self.ring), "n_events": len(tail),
                  "batch_snapshot": snap_prefix,
                  "executables": introspect.executable_manifest()[-8:]
                  or None}
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps(header, separators=(",", ":"),
                               default=str) + "\n")
            for rec in self.ring:
                f.write(json.dumps({"kind": "flight_step", **rec},
                                   separators=(",", ":"),
                                   default=str) + "\n")
            for ev in tail:
                # nested: the event's own "kind" keeps its value
                f.write(json.dumps({"kind": "flight_event", "event": ev},
                                   separators=(",", ":"),
                                   default=str) + "\n")
        self.last_bundle = path
        return path


def load_flight_bundle(path: str) -> dict:
    """A FlightRecorder bundle back as {"header", "steps", "events",
    "batch"}: `batch` is {name: ndarray} when the bundle carried a
    snapshot, else None."""
    rows = observe.EventLog.read(path)
    header = next((r for r in rows if r.get("kind") == "flight_header"), {})
    out = {
        "header": header,
        "steps": [r for r in rows if r.get("kind") == "flight_step"],
        "events": [r["event"] for r in rows
                   if r.get("kind") == "flight_event" and "event" in r],
        "batch": None,
    }
    prefix = header.get("batch_snapshot")
    if prefix:
        from .snapshot import Snapshot
        try:
            s = Snapshot(prefix, mode_write=False)
            out["batch"] = {n: s.read(n).numpy() for n in s.names()}
        except (OSError, FileNotFoundError):
            pass  # the bundle moved without its sidecar; the stats load
    return out


# ---- host-side monitor -----------------------------------------------------

class HealthMonitor:
    """Watches the per-step stats, exports `singa_health_*` metrics,
    applies the anomaly policy, and owns the flight recorder.

    ema_decay/spike_factor: the loss EMA and an EMA of absolute deviation
    update only on finite losses; a step whose deviation exceeds
    `spike_factor` x the deviation EMA after `warmup_steps` healthy steps
    scores as a spike. grad_norm_limit: an optional ceiling on the global
    grad norm. snapshot_batch: write the offending batch into the bundle.
    dump_cooldown: within one episode of consecutive anomalous steps,
    re-dump only after this many steps (default: the ring's capacity)."""

    def __init__(self, policy="warn", ema_decay=0.98, spike_factor=10.0,
                 warmup_steps=10, grad_norm_limit=None, window=64,
                 out_dir=".", snapshot_batch=False, recorder=None,
                 dump_cooldown=None):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        self.policy = policy
        self.ema_decay = float(ema_decay)
        self.spike_factor = float(spike_factor)
        self.warmup_steps = int(warmup_steps)
        self.grad_norm_limit = grad_norm_limit
        self.snapshot_batch = bool(snapshot_batch)
        self.recorder = recorder or FlightRecorder(capacity=window,
                                                   out_dir=out_dir)
        self.dump_cooldown = int(dump_cooldown
                                 if dump_cooldown is not None
                                 else self.recorder.ring.maxlen)
        self._ema = None
        self._dev_ema = None
        self._healthy_steps = 0
        self._prev_anomalous = False
        self._last_dump_step = None
        self.last_action = None

    @staticmethod
    def _metrics():
        # observe.gauge/counter spelled out so the static lint sees every
        # registration
        return {
            "loss": observe.gauge(
                "singa_health_loss",
                "last train-step loss seen by the health layer"),
            "grad_norm": observe.gauge(
                "singa_health_grad_norm",
                "global gradient L2 norm, last step"),
            "spike": observe.gauge(
                "singa_health_spike_score",
                "loss deviation / EMA deviation (robust z-score)"),
            "nonfinite": observe.gauge(
                "singa_health_nonfinite_grads",
                "non-finite gradient entries, last step"),
            "param_norm": observe.gauge(
                "singa_health_param_norm",
                "per-layer-group parameter L2 norm"),
            "update_norm": observe.gauge(
                "singa_health_update_norm",
                "per-layer-group update L2 norm"),
            "update_ratio": observe.gauge(
                "singa_health_update_ratio",
                "per-layer-group update-to-param norm ratio"),
            "anomaly": observe.counter(
                "singa_health_anomaly_total",
                "training anomalies by kind"),
            "skipped": observe.counter(
                "singa_health_skipped_steps_total",
                "train steps whose update was discarded"),
            "halt": observe.counter(
                "singa_health_halt_total",
                "halt-policy firings"),
            "overflow": observe.counter(
                "singa_health_overflow_total",
                "AMP steps with non-finite grads "
                "(loss-scale-overflow analog)"),
        }

    def verdict(self) -> dict:
        """One JSON-able health summary: the last action, the policy, and
        the most recent recorded step."""
        last = self.recorder.ring[-1] if self.recorder.ring else None
        return {
            "status": self.last_action or "idle",
            "policy": self.policy,
            "healthy_steps": self._healthy_steps,
            "last_step": last,
            "last_bundle": self.recorder.last_bundle,
        }

    def note_external(self, kind: str, detail=None, step=None,
                      action=None) -> str:
        """An anomaly from outside the step path (the SLO tracker's
        sustained burn-rate breach, KIND_SLO): counted, ring-recorded and
        policy-mapped like a step anomaly, but never raised here (the
        producer usually runs off the training thread). Returns the
        action ("warn" | "halt"); `action` overrides the policy mapping
        when the producer resolved one."""
        if action is not None and action not in ("warn", "halt"):
            raise ValueError(f"action {action!r} not in ('warn','halt')")
        m = self._metrics()
        m["anomaly"].inc(kind=kind)
        rec = {"external": kind, "detail": detail,
               "step": int(step) if step is not None else None,
               "anomaly_kinds": [kind]}
        self.recorder.record(rec)
        if action is None:
            action = "halt" if self.policy == "halt" else "warn"
        if action == "halt":
            m["halt"].inc()
        self.last_action = action
        observe.get_registry().emit(
            {"kind": "health", "external": kind, "detail": detail,
             "policy": self.policy, "action": action})
        return action

    def _spike_score(self, loss: float) -> float:
        if not math.isfinite(loss):
            return 0.0  # non-finite is its own anomaly kind
        if self._ema is None:
            self._ema = loss
            self._dev_ema = 0.0
            return 0.0
        dev = abs(loss - self._ema)
        score = dev / (self._dev_ema + 1e-8) \
            if self._healthy_steps >= self.warmup_steps else 0.0
        d = self.ema_decay
        self._ema = d * self._ema + (1 - d) * loss
        self._dev_ema = d * self._dev_ema + (1 - d) * dev
        return score

    def on_step(self, stats: dict, step: int, batch_provider=None,
                amp: bool = False, in_graph_skip: bool = False) -> str:
        """Feed one step's host stats. Returns the action: "ok" | "warn"
        | "skip" (raises HealthError on halt). `batch_provider`: a
        zero-argument callable giving host copies of the step's inputs,
        called only on an anomaly with snapshot_batch set.
        `in_graph_skip`: the step already applied the skip select."""
        m = self._metrics()
        loss = float(stats.get("loss", float("nan")))
        grad_norm = float(stats.get("grad_norm", 0.0))
        nf_g = int(stats.get("nonfinite_grads", 0))
        nf_l = int(stats.get("nonfinite_loss", 0))
        spike = self._spike_score(loss)
        m["loss"].set(loss)
        m["grad_norm"].set(grad_norm)
        m["spike"].set(spike)
        m["nonfinite"].set(nf_g)
        groups = stats.get("groups") or {}
        for grp, gs in groups.items():
            m["param_norm"].set(float(gs["param_norm"]), group=grp)
            m["update_norm"].set(float(gs["update_norm"]), group=grp)
            m["update_ratio"].set(float(gs["update_ratio"]), group=grp)

        kinds = []
        if nf_g > 0:
            kinds.append(KIND_NONFINITE_GRAD)
        if nf_l > 0:
            kinds.append(KIND_NONFINITE_LOSS)
        if spike > self.spike_factor:
            kinds.append(KIND_LOSS_SPIKE)
        if self.grad_norm_limit is not None \
                and grad_norm > float(self.grad_norm_limit):
            kinds.append(KIND_GRAD_NORM)

        rec = {"step": int(step), "loss": loss, "grad_norm": grad_norm,
               "nonfinite_grads": nf_g, "nonfinite_loss": nf_l,
               "spike_score": round(spike, 6),
               "groups": {g: {k: float(v) for k, v in gs.items()}
                          for g, gs in groups.items()},
               "anomaly_kinds": kinds}
        self.recorder.record(rec)
        if not kinds:
            self._healthy_steps += 1
            self._prev_anomalous = False
            self.last_action = "ok"
            return "ok"

        for k in kinds:
            m["anomaly"].inc(kind=k)
        nonfinite = nf_g > 0 or nf_l > 0
        if amp and nf_g > 0:
            m["overflow"].inc()
        do_dump = (not self._prev_anomalous
                   or self._last_dump_step is None
                   or int(step) - self._last_dump_step
                   >= self.dump_cooldown)
        self._prev_anomalous = True
        bundle = self.recorder.last_bundle
        if do_dump:
            batch = None
            if self.snapshot_batch and batch_provider is not None:
                try:
                    batch = batch_provider()
                except Exception:
                    batch = None
            bundle = self.recorder.dump(reason=",".join(kinds), step=step,
                                        batch_arrays=batch)
            self._last_dump_step = int(step)
        observe.get_registry().emit(
            {"kind": "health", "step": int(step), "anomaly": kinds,
             "policy": self.policy, "bundle": bundle, "loss": loss,
             "grad_norm": grad_norm, "nonfinite_grads": nf_g})
        if self.policy == "halt":
            m["halt"].inc()
            self.last_action = "halt"
            raise HealthError(
                f"training halted at step {step}: {','.join(kinds)} "
                f"(flight bundle: {bundle})", bundle_path=bundle, stats=rec)
        if self.policy == "skip_step" and nonfinite and in_graph_skip:
            m["skipped"].inc()
            self.last_action = "skip"
            return "skip"
        # warn, or skip_step on an anomaly the select cannot cover (a
        # loss spike: the update is already committed)
        self.last_action = "warn"
        return "warn"


def record_nan_logits(n: int, kind: str):
    """Serving-side NaN watch: non-finite logits seen during one decode
    call (prefill and every generated position), or one engine prefill
    or sync. Books nothing while observe is disabled."""
    if n <= 0 or not observe.is_enabled():
        return
    observe.counter("singa_health_nan_logits_total",
                    "non-finite logit entries seen while decoding"
                    ).inc(float(n), kind=kind)


__all__ = [
    "POLICIES", "HealthError", "StepStatsCollector", "collector",
    "KIND_STRAGGLER", "KIND_MEM_LEAK", "KIND_HANG", "KIND_SLO",
    "KIND_DIVERGENCE", "KIND_REGRESSION",
    "apply_skip", "FlightRecorder", "load_flight_bundle", "HealthMonitor",
    "record_nan_logits", "set_active_monitor", "active_monitor",
]
