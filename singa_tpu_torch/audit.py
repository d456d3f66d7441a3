"""Serving correctness observatory (counterpart of singa_tpu/audit.py): is
the fleet serving the RIGHT tokens?

A replica with corrupted weights (a bad memory bank, a botched restore)
serves confidently wrong output at 100% SLO attainment, and no latency or
capacity signal notices. This module is that detector: three legs feeding
one quarantine path, built on greedy determinism (the same request on two
healthy replicas gives the same tokens, so any divergence is a fault).

The legs (`AUDIT_LEGS`):

  - **fingerprint**: a per-layer-group checksum over the parameters
    (`ParamFingerprinter`: each parameter's fp32 bits as 32-bit words,
    position-mixed, avalanched and sum-folded mod 2^32, the groups
    combined FNV-style), bit-equal to the JAX package's for the same
    weights. It is computed at replica startup, after a checkpoint
    restore (`refresh_fingerprint`) and on a low-rate timer; the snapshot
    rides the `fleet_audit` shard line, and the `FleetAggregator`
    majority-votes fingerprints across replicas.
  - **canary**: `CanaryProber` sends seeded golden prompts through the
    `Router` front door, tagged `synthetic=True` end to end (probe
    traffic moves neither SLO attainment, the capacity forecast nor the
    admitted-RPS stamps), and compares them token for token with the
    recorded goldens.
  - **replay**: `ShadowReplayer` replays a fraction of completed real
    requests on a different replica and compares the token streams; a
    replica is convicted only when it diverges against >= 2 distinct
    peers.

A sustained verdict notes `health.KIND_DIVERGENCE` on the active monitor
(not gated on `observe.enable`) and quarantines the suspect through
`Router.drain_replica`, never below `min_replicas` live.

Surfaces: `/auditz` (+`?json=1`) and `== audit ==` on /statusz (diag),
the fingerprint and canary columns on /fleetz (fleet), and
`singa_audit_*` metrics over the AUDIT_LEGS x AUDIT_VERDICTS labels.

CLI: `python -m singa_tpu_torch.audit --ab [--device cpu]` runs a clean
arm and a corrupt arm of replica processes on `--device` (the card by
default: `--dim 256` or `512` there, the flash kernel's head widths); in
the corrupt arm `fault_point("audit.corrupt_params")` flips one layer of
one replica's parameters mid-run. The record (AUDIT_torch.json) must show
detection by >= 2 legs within the probe budget, quarantine by drain with
zero lost requests, and zero false positives on the clean arm.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import threading
import time
from collections import deque

import numpy as np
import torch

from . import health, observe

#: the three detection legs — the `leg=` label on singa_audit_*
#: counters (lint rule 5; the aliases are the literal re-statements the
#: lint's constant-resolution proves membership from)
AUDIT_LEGS = ("fingerprint", "canary", "replay")
LEG_FINGERPRINT = "fingerprint"
LEG_CANARY = "canary"
LEG_REPLAY = "replay"

#: what one probe concluded — the `verdict=` label on singa_audit_*
#: counters. "error" is a probe that could not run to a comparison
#: (rejected canary, no replay target); it never sustains a quarantine
AUDIT_VERDICTS = ("match", "mismatch", "error")
VERDICT_MATCH = "match"
VERDICT_MISMATCH = "mismatch"
VERDICT_ERROR = "error"

#: rid namespace for direct (non-front-door) shadow-replay dispatches —
#: far above any real router rid so a drain hand-back can never collide
_REPLAY_RID_BASE = 10_000_000

#: 0x80000000 as an int32: XOR flips an fp32 word's sign bit
_SIGN_BIT = -(1 << 31)

_metrics_cache = None


def _metrics():
    # memoize-with-revalidation (engine._metrics shape): cheap on the
    # probe path, rebuilt after a registry reset
    global _metrics_cache
    c = _metrics_cache
    if c is not None and observe.get_registry().get(
            "singa_audit_checks_total") is c["checks"]:
        return c
    _metrics_cache = c = {
        "checks": observe.counter(
            "singa_audit_checks_total",
            "audit probe results by detection leg and verdict"),
        "quarantines": observe.counter(
            "singa_audit_quarantine_total",
            "replicas quarantined (drain-driven) on a sustained audit "
            "verdict, by triggering leg"),
        "fingerprints": observe.counter(
            "singa_audit_fingerprint_total",
            "param-integrity fingerprint computations (startup, "
            "restore, timer ticks)"),
        "divergence_pos": observe.histogram(
            "singa_audit_divergence_position",
            "first diverging token index in a canary miscompare or "
            "shadow-replay divergence"),
    }
    return c


# ---- leg 1: param-integrity fingerprints ------------------------------------

#: the fold's constants (the JAX package's): FNV-1a's offset basis and
#: prime combine the groups; the two multipliers mix each word with its
#: index, the third finishes the murmur-style avalanche
_FNV_BASIS = 2166136261
_FNV_PRIME = 16777619
_MIX_INDEX = 2654435761
_MIX_WORD = 2246822519
_MIX_AVALANCHE = 2716044179
_M32 = 0xFFFFFFFF
#: elements folded per pass: bounds the int64 temporaries of one
#: parameter (GPT-2's 38.6M-element embedding) to a few tens of MB
_FOLD_CHUNK = 1 << 21


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 `x` in [0, 2^32) and a 32-bit constant,
    without overflowing int64: c splits into 16-bit halves, and the high
    half's product keeps only the 16 bits that land below 2^32."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _word_sum(a):
    """One parameter's contribution: the sum mod 2^32 of its fp32 words,
    each XORed with its mixed flat index, multiplied, avalanched (shift
    16, XOR, multiply) — JAX's `fold` body, in int64 on `a`'s device, a
    chunk at a time with the chunk's global index offset. Returns a 0-d
    int64 tensor (the caller reads every group's sums in one copy)."""
    flat = a.detach().to(torch.float32).contiguous().reshape(-1)
    words = flat.view(torch.int32)
    total = torch.zeros((), dtype=torch.int64, device=flat.device)
    for off in range(0, words.numel(), _FOLD_CHUNK):
        w = words[off:off + _FOLD_CHUNK].to(torch.int64) & _M32
        idx = torch.arange(off, off + w.numel(), dtype=torch.int64,
                           device=flat.device)
        mixed = _mul32(w ^ _mul32(idx, _MIX_INDEX), _MIX_WORD)
        mixed = _mul32(mixed ^ (mixed >> 16), _MIX_AVALANCHE)
        total += mixed.sum()
    return total & _M32


class ParamFingerprinter:
    """A per-layer-group checksum over the model's parameters.

    Each parameter's fp32 bits are read as unsigned 32-bit words (any
    single flipped bit changes the checksum), position-mixed (word XOR
    index*prime, times a second prime), avalanched and sum-folded mod
    2^32; parameters fold into their layer group (the first component of
    the parameter name) with an order-dependent FNV-style combine. The
    arithmetic is the JAX package's (`singa_tpu/audit.py:170-202`), done
    in int64 torch ops on the parameters' device with masks where JAX
    wraps uint32, so both packages give the same checksums for the same
    weights. It builds nothing and never touches the model's own steps,
    so `singa_model_compile_total` stays unchanged.

    `tick()` (the timer body) consults
    `fault_point("audit.corrupt_params")` FIRST: a FaultPlan `fail` rule
    there is the deterministic silent-data-corruption injection — the
    caught raise flips the sign bit of one parameter layer in place
    (`_corrupt`) and refreshes the engine's decode parameters so served
    tokens actually change."""

    def __init__(self, model, engine=None, *, interval_s: float = 0.0,
                 corrupt_target: "str | None" = None):
        self.model = model
        self.engine = engine
        self.interval_s = float(interval_s)
        self.corrupt_target = corrupt_target
        sep = getattr(model, "sep", ".")
        self._names = list(model._raw_params().keys())
        self.groups: "list[str]" = []
        group_of = []
        for name in self._names:
            g = name.split(sep, 1)[0]
            if g not in self.groups:
                self.groups.append(g)
            group_of.append(self.groups.index(g))
        self._group_of = group_of
        self.last: "list[tuple[str, int]] | None" = None
        self.last_ts = None
        self.count = 0
        self.corrupted: "dict | None" = None
        self._stop = threading.Event()
        self._thread = None
        self._lock = threading.Lock()
        self._stream = None

    def _on_side_stream(self, device):
        """On the card the fold runs on a stream of its own, after the
        work already queued on the calling thread's stream: a replica's
        engine keeps launching on the default stream while a tick runs
        instead of queueing behind its kernels. The fold's temporaries
        live and die on that stream, and its host read ends the tick
        with nothing left in flight."""
        if device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=device)
        self._stream.wait_stream(torch.cuda.current_stream(device))
        return torch.cuda.stream(self._stream)

    def _fold(self) -> "list[int]":
        """The group checksums, in group order: each parameter's word sum
        on its device, one copy to the host, then the FNV combine on
        Python ints."""
        raw = self.model._raw_params()
        params = [raw[n] for n in self._names]
        with torch.no_grad(), self._on_side_stream(params[0].device):
            sums = torch.stack([_word_sum(p) for p in params]).tolist()
        acc = [_FNV_BASIS] * len(self.groups)
        for g, contrib in zip(self._group_of, sums):
            acc[g] = ((acc[g] * _FNV_PRIME) & _M32) ^ int(contrib)
        return acc

    def compute(self) -> "list[tuple[str, int]]":
        """One fingerprint pass: list of (layer_group, uint32 checksum)
        in stable group order. The parameters are re-read each call, so
        an in-place corruption or a restore flows in."""
        out = self._fold()
        fp = list(zip(self.groups, out))
        with self._lock:
            self.last = fp
            self.last_ts = round(time.time(), 6)
            self.count += 1
        if observe.is_enabled():
            _metrics()["fingerprints"].inc()
        return fp

    def tick(self) -> "list[tuple[str, int]]":
        """Timer body: corruption fault point first, then recompute."""
        from . import resilience
        try:
            resilience.fault_point("audit.corrupt_params")
        except RuntimeError as e:
            self._corrupt(str(e))
        return self.compute()

    def _corrupt(self, detail: str):
        """The injected SDC: flip the sign bit of every element of one
        parameter layer (drastic enough that greedy tokens change, which
        the canary and replay legs must catch from the outside). The
        write is an in-place copy, so the parameter's version counter
        moves and `serving.decode_state`'s memo misses; the engine's
        decode parameters are then rebuilt, so serving uses the
        corrupted weights."""
        params = self.model._raw_params()
        name = self.corrupt_target
        if name is None or name not in params:
            names = self._names
            name = next((n for n in names if n.endswith("fc1.W")),
                        names[len(names) // 2])
        p = params[name]
        with torch.no_grad():
            bits = p.detach().to(torch.float32).contiguous() \
                .view(torch.int32) ^ _SIGN_BIT
            p.copy_(bits.view(torch.float32).to(p.dtype))
        eng = self.engine
        if eng is not None:
            from . import serving
            eng._params = serving.decode_state(eng.model, eng.dtype)
        self.corrupted = {"param": name, "ts": round(time.time(), 6),
                          "detail": detail}
        if observe.is_enabled():
            observe.get_registry().emit(
                {"kind": "audit", "event": "corrupt_injected",
                 "param": name, "detail": detail})

    def start(self) -> "ParamFingerprinter":
        if self.interval_s <= 0 or self._thread is not None:
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:
                    pass  # the timer must not die on a transient

        self._thread = threading.Thread(
            target=_loop, name="singa-audit-fp", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=5.0)

    def snapshot(self) -> dict:
        """The fleet_audit shard line: ordered [group, checksum] pairs
        plus provenance. `injected` is ground truth for harness
        assertions/debugging only — the aggregator's vote never reads
        it (the detector must not need the answer key)."""
        with self._lock:
            return {
                "fingerprint": [[g, v] for g, v in (self.last or [])],
                "count": self.count,
                "ts": self.last_ts,
                "groups": len(self.groups),
                "params": len(self._names),
                "injected": bool(self.corrupted),
            }


# ---- leg 2: canary probing --------------------------------------------------

class CanaryProber:
    """Background prober: seeded golden prompts through the router's
    front door, `synthetic=True` end to end. The first completed
    sighting of each golden records its token stream (all replicas are
    byte-identical at startup — greedy determinism makes the first
    answer the reference); every later probe must match token-for-token
    and a miscompare is attributed to the replica that SERVED it."""

    def __init__(self, observatory, router, *, vocab: int,
                 n_goldens: int = 4, prompt_len: int = 6,
                 max_new: int = 8, interval_s: float = 0.25,
                 seed: int = 0, timeout_s: float = 30.0):
        self.obs = observatory
        self.router = router
        self.max_new = int(max_new)
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        rng = np.random.RandomState((int(seed) ^ 0xA0D17) % (2 ** 31))
        self.prompts = [
            rng.randint(1, max(2, int(vocab)),
                        size=(int(prompt_len),)).astype(np.int32)
            for _ in range(int(n_goldens))]
        self.goldens: "dict[int, list[int]]" = {}
        self.probes = 0
        self._stop = threading.Event()
        self._thread = None

    def record_goldens(self):
        """Synchronous recording pass: one probe per golden prompt.
        Run BEFORE any fault window opens — the goldens are the
        reference the whole leg compares against."""
        for idx in range(len(self.prompts)):
            self._probe(idx)

    def _probe(self, idx: int):
        h = self.router.submit(self.prompts[idx], self.max_new,
                               synthetic=True)
        self.probes += 1
        done = h.wait(self.timeout_s)
        if not done or h.outcome != "completed":
            if h.replica is not None:
                self.obs.note(h.replica, LEG_CANARY, VERDICT_ERROR,
                              detail=h.detail or "canary not completed")
            return
        toks = [int(t) for t in h.tokens]
        golden = self.goldens.get(idx)
        if golden is None:
            self.goldens[idx] = toks
            return
        if toks == golden:
            self.obs.note(h.replica, LEG_CANARY, VERDICT_MATCH)
        else:
            pos = _first_divergence(golden, toks)
            self.obs.note(
                h.replica, LEG_CANARY, VERDICT_MISMATCH, position=pos,
                detail=f"golden {idx} diverged at token {pos}")

    def run_once(self):
        """One probe of the next golden in rotation (test hook — the
        background loop calls exactly this)."""
        idx = self.probes % max(1, len(self.prompts))
        self._probe(idx)

    def confirm(self, replica: str) -> int:
        """Targeted confirmation burst: run every recorded golden
        DIRECTLY against `replica`'s control surface and note a canary
        verdict for each. The quarantine path fires this at a
        fingerprint conviction, just before the drain retires the
        accused: the front door stops routing to a suspect the moment
        it is convicted, so front-door probes can never corroborate an
        internal (param-level) verdict — a direct probe of the accused
        can, and turns a one-leg conviction into externally observed
        wrong-token evidence with a divergence position. Returns the
        miscompare count."""
        get = getattr(self.router, "get_replica", None)
        rep = get(replica) if get is not None else None
        if rep is None or getattr(rep, "ctl_url", None) is None:
            return 0
        bad = 0
        # the burst runs AHEAD of the drain on the drain thread: bound
        # each probe so a wedged replica cannot postpone its own
        # retirement indefinitely
        per_probe = min(self.timeout_s, 30.0)
        for idx in sorted(self.goldens):
            golden = self.goldens[idx]
            out = _direct_generate(rep, self.prompts[idx],
                                   self.max_new,
                                   timeout_s=per_probe,
                                   stop_evt=self._stop,
                                   tag="audit-confirm")
            self.probes += 1
            if out is None:
                self.obs.note(
                    replica, LEG_CANARY, VERDICT_ERROR,
                    detail=f"confirm golden {idx} did not complete")
            elif out == golden:
                self.obs.note(replica, LEG_CANARY, VERDICT_MATCH)
            else:
                bad += 1
                pos = _first_divergence(golden, out)
                self.obs.note(
                    replica, LEG_CANARY, VERDICT_MISMATCH,
                    position=pos,
                    detail=f"confirm golden {idx} diverged "
                           f"at token {pos}")
        return bad

    def start(self) -> "CanaryProber":
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.run_once()
                except Exception:
                    pass

        self._thread = threading.Thread(
            target=_loop, name="singa-audit-canary", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=self.timeout_s + 5.0)


def _first_divergence(a, b) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


# ---- leg 3: shadow replay ---------------------------------------------------

_replay_rid_lock = threading.Lock()
_replay_rid = _REPLAY_RID_BASE


def _next_replay_rid() -> int:
    global _replay_rid
    with _replay_rid_lock:
        _replay_rid += 1
        return _replay_rid


def _direct_generate(target, prompt, max_new, *, timeout_s,
                     stop_evt=None, tag="audit") -> "list | None":
    """Drive one synthetic generation on `target`'s control surface to
    a terminal outcome (same bounded-poll shape as Router._dispatch).
    Shared by the shadow replayer and the canary confirmation burst —
    both need a replica the router would never (replay: origin must
    differ) or can no longer (confirm: the accused is leaving rotation)
    route to. Returns the tokens, or None when the run could not
    complete."""
    from .router import _http_json
    rid = _next_replay_rid()
    payload = {"rid": rid, "prompt": [int(t) for t in prompt],
               "max_new": int(max_new), "wait_s": 1.0,
               "synthetic": True, "trace": f"{tag}-{rid}"}
    deadline = time.monotonic() + float(timeout_s)
    while time.monotonic() < deadline \
            and not (stop_evt is not None and stop_evt.is_set()):
        try:
            out = _http_json(target.ctl_url + "/submit", payload,
                             timeout=11.0)
        except Exception:
            return None
        st = out.get("outcome")
        if st == "pending":
            payload["resume"] = True
            continue
        if st == "completed":
            return [int(t) for t in (out.get("tokens") or [])]
        return None
    return None


class ShadowReplayer:
    """Samples completed REAL requests off the router's terminal-request
    listener and replays each on a DIFFERENT live replica (direct
    control-surface dispatch, `synthetic=True` so the replay is
    excluded from every demand signal), comparing token streams.

    A mismatch implicates the (origin, target) PAIR — both get a
    mismatch note carrying the peer — and the observatory convicts
    only a replica that diverged against >= `replay_min_peers` distinct
    peers: with 3+ replicas the corrupted one diverges with everyone
    while a healthy one diverges only with the corrupted one, so the
    leg can never sustain a quarantine against a healthy replica."""

    def __init__(self, observatory, router, *, fraction: float = 0.25,
                 timeout_s: float = 30.0, max_queue: int = 256,
                 replay_fn=None):
        self.obs = observatory
        self.router = router
        self.fraction = float(fraction)
        self.timeout_s = float(timeout_s)
        self.max_queue = int(max_queue)
        self._replay_fn = replay_fn or self._replay_direct
        self._queue: "deque[tuple]" = deque()
        self._have = threading.Event()
        self._stop = threading.Event()
        self._thread = None
        self._acc = 0.0
        self.sampled = 0
        self.replays = 0

    # -- sampling (router terminal-listener callback) ----------------------
    def _on_terminal(self, req, timeline):
        if getattr(req, "synthetic", False) \
                or req.outcome != "completed" \
                or req.replica is None or not req.tokens:
            return
        self._acc += self.fraction
        if self._acc < 1.0:
            return
        self._acc -= 1.0
        self.sampled += 1
        item = ([int(t) for t in req.prompt], int(req.max_new),
                [int(t) for t in req.tokens], req.replica)
        self._queue.append(item)
        while len(self._queue) > self.max_queue:
            self._queue.popleft()
        self._have.set()

    # -- replay ------------------------------------------------------------
    def _pick_target(self, origin: str):
        live = [rep for rep in self.router.replicas()
                if rep.state == "live" and rep.name != origin]
        return live[self.replays % len(live)] if live else None

    def _replay_direct(self, prompt, max_new, target) -> "list | None":
        """Drive one replay on `target`'s control surface to a terminal
        outcome (same bounded-poll shape as Router._dispatch). Returns
        the generated tokens, or None when the replay could not run."""
        return _direct_generate(target, prompt, max_new,
                                timeout_s=self.timeout_s,
                                stop_evt=self._stop, tag="audit-replay")

    def process_one(self) -> bool:
        """Replay one queued sample (test hook — the worker loop calls
        exactly this). Returns False when the queue is empty."""
        try:
            prompt, max_new, tokens, origin = self._queue.popleft()
        except IndexError:
            self._have.clear()
            return False
        target = self._pick_target(origin)
        if target is None:
            return True  # nothing to compare against; not an error
        out = self._replay_fn(prompt, max_new, target)
        self.replays += 1
        if out is None:
            self.obs.note(target.name, LEG_REPLAY, VERDICT_ERROR,
                          peer=origin, detail="replay did not complete")
        elif out == tokens:
            self.obs.note(origin, LEG_REPLAY, VERDICT_MATCH,
                          peer=target.name)
            self.obs.note(target.name, LEG_REPLAY, VERDICT_MATCH,
                          peer=origin)
        else:
            pos = _first_divergence(tokens, out)
            detail = f"replay diverged at token {pos}"
            self.obs.note(origin, LEG_REPLAY, VERDICT_MISMATCH,
                          peer=target.name, position=pos, detail=detail)
            self.obs.note(target.name, LEG_REPLAY, VERDICT_MISMATCH,
                          peer=origin, position=pos, detail=detail)
        return True

    def attach(self) -> "ShadowReplayer":
        self.router.add_request_listener(self._on_terminal)
        if self._thread is None:
            self._stop.clear()

            def _loop():
                while not self._stop.is_set():
                    if not self.process_one():
                        self._have.wait(timeout=0.1)

            self._thread = threading.Thread(
                target=_loop, name="singa-audit-replay", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        try:
            self.router.remove_request_listener(self._on_terminal)
        except Exception:
            pass
        self._stop.set()
        self._have.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=self.timeout_s + 5.0)


# ---- the verdict ledger + quarantine path -----------------------------------

class AuditObservatory:
    """Router-side verdict ledger for all three legs, and the ONE
    quarantine path they feed.

    Sustain rules: fingerprint and canary convict on `sustain`
    consecutive mismatches (the fingerprint dissent is re-noted every
    aggregator poll while it persists, so its streak builds at poll
    cadence); replay convicts on divergence against >=
    `replay_min_peers` distinct peers (pair evidence, see
    ShadowReplayer). A fingerprint conviction additionally fires a
    targeted canary CONFIRMATION burst at the accused (direct
    control-surface probes of the recorded goldens, just before the
    drain retires it) — the front door stops routing to a convicted
    suspect immediately, so only a direct probe can corroborate the
    internal verdict with externally observed wrong tokens.
    A conviction health-notes KIND_DIVERGENCE
    unconditionally (a verdict is health state, not telemetry — the
    counters and EventLog records are the part `observe.enable(False)`
    silences) and drains the suspect via `Router.drain_replica` —
    idempotent, so the poll loop re-firing the same verdict is safe —
    unless the fleet is already at `min_replicas` live, in which case
    the quarantine is recorded as CAPPED and no drain happens: a
    fleet-wide false alarm must never drain the fleet dark."""

    def __init__(self, router=None, *, sustain: int = 3,
                 min_replicas: int = 1, replay_min_peers: int = 2):
        self.router = router
        self.sustain = int(sustain)
        self.min_replicas = int(min_replicas)
        self.replay_min_peers = int(replay_min_peers)
        self._lock = threading.Lock()
        self._stats: "dict[str, dict[str, dict]]" = {}
        self._quarantined: "dict[str, dict]" = {}
        self._drains: "list[threading.Thread]" = []
        self.prober: "CanaryProber | None" = None
        self.replayer: "ShadowReplayer | None" = None

    # -- the verdict feed --------------------------------------------------
    def _leg_state(self, replica: str, leg: str) -> dict:
        legs = self._stats.setdefault(replica, {})
        st = legs.get(leg)
        if st is None:
            st = legs[leg] = {
                "match": 0, "mismatch": 0, "error": 0, "streak": 0,
                "peers": set(), "last_position": None,
                "last_detail": None}
        return st

    def note(self, replica: str, leg: str, verdict: str, *, peer=None,
             position=None, detail=None):
        """Feed one probe verdict. Every verdict emits a structured
        EventLog record and bumps the leg/verdict counter (both gated
        on observe.enable); a SUSTAINED mismatch additionally fires the
        quarantine path, which is never gated."""
        assert leg in AUDIT_LEGS, leg
        assert verdict in AUDIT_VERDICTS, verdict
        with self._lock:
            st = self._leg_state(replica, leg)
            st[verdict] += 1
            if verdict == VERDICT_MISMATCH:
                st["streak"] += 1
                if peer is not None:
                    st["peers"].add(peer)
                st["last_position"] = position
                st["last_detail"] = detail
            elif verdict == VERDICT_MATCH:
                st["streak"] = 0
            if leg == LEG_REPLAY:
                sustained = len(st["peers"]) >= self.replay_min_peers
            else:
                sustained = st["streak"] >= self.sustain
            sustained = sustained and verdict == VERDICT_MISMATCH
        if observe.is_enabled():
            m = _metrics()
            m["checks"].inc(leg=leg, verdict=verdict)
            if position is not None:
                m["divergence_pos"].observe(float(position))
            observe.get_registry().emit(
                {"kind": "audit", "event": "verdict", "replica": replica,
                 "leg": leg, "verdict": verdict, "peer": peer,
                 "position": position, "detail": detail})
        if sustained:
            self._quarantine(replica, leg, detail)

    # -- quarantine --------------------------------------------------------
    def _live_count(self) -> "int | None":
        if self.router is None:
            return None
        try:
            return sum(1 for rep in self.router.replicas()
                       if rep.state == "live")
        except Exception:
            return None

    def _quarantine(self, replica: str, leg: str, detail):
        live = self._live_count()
        with self._lock:
            if replica in self._quarantined:
                return
            capped = live is not None and live <= self.min_replicas
            rec = self._quarantined[replica] = {
                "leg": leg, "detail": detail,
                "ts": round(time.time(), 6), "capped": capped,
                "live_at_verdict": live}
        # the health note is NOT telemetry: it survives
        # observe.enable(False) so /healthz cannot claim a clean fleet
        # that the audit just convicted
        mon = health.active_monitor()
        if mon is not None:
            try:
                mon.note_external(
                    health.KIND_DIVERGENCE,
                    detail={"replica": replica, "leg": leg,
                            "detail": detail, "capped": capped},
                    action="warn")
            except Exception:
                pass  # the monitor must not break the audit path
        if observe.is_enabled():
            assert leg in AUDIT_LEGS
            _metrics()["quarantines"].inc(leg=leg)
            observe.get_registry().emit(
                {"kind": "audit", "event": "quarantine",
                 "replica": replica, "leg": leg, "capped": capped,
                 "detail": detail})
        if capped or self.router is None:
            return
        t = threading.Thread(
            target=self._drain, args=(replica, leg),
            name=f"singa-audit-drain-{replica}", daemon=True)
        with self._lock:
            self._drains.append(t)
        t.start()
        rec["drain_started"] = True

    def _drain(self, replica: str, leg=None):
        # a FINGERPRINT conviction is internal (param-level) evidence;
        # before the drain retires the accused — taking its engine with
        # it — the canary prober corroborates with a targeted golden
        # burst against its control surface. Confirmation is evidence,
        # not a gate: the drain proceeds whatever the burst says.
        if leg == LEG_FINGERPRINT:
            prober = self.prober
            if prober is not None and prober.goldens:
                try:
                    prober.confirm(replica)
                except Exception:
                    pass
        try:
            self.router.drain_replica(replica)
        except Exception:
            pass  # drain failure leaves the health note standing

    # -- probe lifecycle ---------------------------------------------------
    def start_canary(self, *, vocab: int, n_goldens: int = 4,
                     prompt_len: int = 6, max_new: int = 8,
                     interval_s: float = 0.25, seed: int = 0,
                     timeout_s: float = 30.0,
                     record: bool = True) -> CanaryProber:
        if self.router is None:
            raise ValueError("canary probing needs a router")
        self.prober = CanaryProber(
            self, self.router, vocab=vocab, n_goldens=n_goldens,
            prompt_len=prompt_len, max_new=max_new,
            interval_s=interval_s, seed=seed, timeout_s=timeout_s)
        if record:
            self.prober.record_goldens()
        return self.prober.start()

    def start_replay(self, *, fraction: float = 0.25,
                     timeout_s: float = 30.0,
                     replay_fn=None) -> ShadowReplayer:
        if self.router is None:
            raise ValueError("shadow replay needs a router")
        self.replayer = ShadowReplayer(
            self, self.router, fraction=fraction, timeout_s=timeout_s,
            replay_fn=replay_fn)
        return self.replayer.attach()

    def stop(self):
        if self.prober is not None:
            self.prober.stop()
        if self.replayer is not None:
            self.replayer.stop()
        with self._lock:
            drains = list(self._drains)
            self._drains = []
        for t in drains:
            t.join(timeout=30.0)

    # -- reading -----------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            reps = {}
            for name in sorted(self._stats):
                reps[name] = {
                    leg: {"match": st["match"],
                          "mismatch": st["mismatch"],
                          "error": st["error"], "streak": st["streak"],
                          "peers": sorted(st["peers"]),
                          "last_position": st["last_position"],
                          "last_detail": st["last_detail"]}
                    for leg, st in self._stats[name].items()}
            return {
                "sustain": self.sustain,
                "min_replicas": self.min_replicas,
                "replay_min_peers": self.replay_min_peers,
                "replicas": reps,
                "quarantined": {k: dict(v)
                                for k, v in self._quarantined.items()},
                "canary_probes": self.prober.probes
                if self.prober is not None else 0,
                "goldens": len(self.prober.goldens)
                if self.prober is not None else 0,
                "replays": self.replayer.replays
                if self.replayer is not None else 0,
                "replay_sampled": self.replayer.sampled
                if self.replayer is not None else 0,
            }


# ---- module singletons ------------------------------------------------------

_lock = threading.Lock()
_fingerprinter: "ParamFingerprinter | None" = None
_observatory: "AuditObservatory | None" = None


def install_fingerprint(model, engine=None, *, interval_s: float = 0.0,
                        corrupt_target=None) -> ParamFingerprinter:
    """Install the replica-side fingerprinter: computes the STARTUP
    fingerprint synchronously, then (interval_s > 0) recomputes on the
    singa-audit-fp timer. Replaces any previous fingerprinter."""
    global _fingerprinter
    fp = ParamFingerprinter(model, engine, interval_s=interval_s,
                            corrupt_target=corrupt_target)
    fp.compute()
    with _lock:
        old, _fingerprinter = _fingerprinter, fp
    if old is not None:
        old.stop()
    return fp.start()


def get_fingerprinter() -> "ParamFingerprinter | None":
    return _fingerprinter


def refresh_fingerprint(reason: str = "restore"):
    """Recompute the fingerprint NOW — the post-checkpoint-restore hook
    (a botched restore is indistinguishable from bad memory without a
    fresh fingerprint to vote on). No-op without an installed
    fingerprinter."""
    fp = _fingerprinter
    if fp is None:
        return None
    out = fp.compute()
    if observe.is_enabled():
        observe.get_registry().emit(
            {"kind": "audit", "event": "fingerprint_refresh",
             "reason": reason})
    return out


def install_observatory(router=None, **kw) -> AuditObservatory:
    """Install the router-side observatory (verdict ledger + quarantine
    path). kwargs pass through to AuditObservatory."""
    global _observatory
    obs = AuditObservatory(router, **kw)
    with _lock:
        old, _observatory = _observatory, obs
    if old is not None:
        old.stop()
    return obs


def get_observatory() -> "AuditObservatory | None":
    return _observatory


def reset():
    """Conftest contract: prober/replayer/fingerprint-timer threads
    joined (singa-audit-*), the router terminal listener detached,
    pending drain threads joined, singletons dropped."""
    global _fingerprinter, _observatory
    with _lock:
        fp, _fingerprinter = _fingerprinter, None
        obs, _observatory = _observatory, None
    if obs is not None:
        obs.stop()
    if fp is not None:
        fp.stop()


# ---- report surfaces --------------------------------------------------------

def fleet_audit_snapshot() -> "dict | None":
    """This process's fleet_audit shard line (None without an installed
    fingerprinter — the aggregator skips hosts without one)."""
    fp = _fingerprinter
    return fp.snapshot() if fp is not None else None


def audit_json() -> dict:
    out = {"fingerprint": fleet_audit_snapshot()}
    obs = _observatory
    out["observatory"] = obs.snapshot() if obs is not None else None
    return out


def audit_report() -> str:
    """The /auditz text: the local fingerprint, the per-replica verdict
    table, and the quarantine ledger."""
    lines = ["== audit =="]
    fp = _fingerprinter
    if fp is not None:
        snap = fp.snapshot()
        head = (f"fingerprint: {snap['groups']} layer groups over "
                f"{snap['params']} params, computed {snap['count']}x")
        if snap["injected"]:
            head += "  [INJECTED CORRUPTION ACTIVE]"
        lines.append(head)
        for g, v in (fp.last or []):
            lines.append(f"  {g}: 0x{v:08x}")
    obs = _observatory
    if obs is not None:
        s = obs.snapshot()
        lines.append(
            f"observatory: sustain {s['sustain']}, min_replicas "
            f"{s['min_replicas']}, canary probes {s['canary_probes']} "
            f"({s['goldens']} goldens), replays {s['replays']} "
            f"(sampled {s['replay_sampled']})")
        for name, legs in s["replicas"].items():
            cells = []
            for leg in AUDIT_LEGS:
                st = legs.get(leg)
                if st is None:
                    continue
                cell = (f"{leg} {st['match']}/{st['mismatch']}"
                        f"/{st['error']}")
                if st["peers"]:
                    cell += f" peers={','.join(st['peers'])}"
                cells.append(cell)
            lines.append(f"  replica {name}: "
                         + ("; ".join(cells) if cells else "no probes")
                         + " (match/mismatch/error)")
        for name, q in s["quarantined"].items():
            lines.append(
                f"  QUARANTINED {name}: leg {q['leg']}"
                + (" [capped: no drain]" if q["capped"] else " [drained]")
                + (f" — {q['detail']}" if q.get("detail") else ""))
    if fp is None and obs is None:
        lines.append("(not installed)")
    return "\n".join(lines)


def fleetz_lines() -> "list[str]":
    """Observatory rows for /fleetz (empty without one installed): the
    per-replica canary/replay verdict columns next to the data-plane
    serving table (the fingerprint column itself comes from each
    worker's fleet_audit shard line via the aggregator rollup)."""
    obs = _observatory
    if obs is None:
        return []
    s = obs.snapshot()
    lines = ["== fleet audit ==",
             f"canary probes {s['canary_probes']}   replays "
             f"{s['replays']}   quarantined {len(s['quarantined'])}"]
    for name, legs in s["replicas"].items():
        cn = legs.get(LEG_CANARY) or {}
        rp = legs.get(LEG_REPLAY) or {}
        fpr = legs.get(LEG_FINGERPRINT) or {}
        lines.append(
            f"  {name}: canary ok {cn.get('match', 0)} bad "
            f"{cn.get('mismatch', 0)}   replay ok {rp.get('match', 0)} "
            f"bad {rp.get('mismatch', 0)}   fp dissent "
            f"{fpr.get('mismatch', 0)}"
            + ("   QUARANTINED" if name in s["quarantined"] else ""))
    return lines


# ---- the adversarial A/B harness -------------------------------------------

def _detection(osnap: dict, victim: str) -> dict:
    st = (osnap.get("replicas") or {}).get(victim) or {}
    legs = sorted(leg for leg in AUDIT_LEGS
                  if (st.get(leg) or {}).get("mismatch", 0) > 0)
    return {
        "legs": legs,
        "quarantined": victim in (osnap.get("quarantined") or {}),
        "capped": bool(((osnap.get("quarantined") or {}).get(victim)
                        or {}).get("capped")),
    }


def _mismatch_total(osnap: dict) -> int:
    return sum((st or {}).get("mismatch", 0)
               for legs in (osnap.get("replicas") or {}).values()
               for st in legs.values())


def _ab_arm(args, workdir: str, *, corrupt: bool) -> dict:
    """One harness arm: N replicas + router + the full observatory
    under the seeded Poisson workload. The corrupt arm gives ONE
    replica a FaultPlan that bit-flips a param layer at its
    --corrupt-after'th fingerprint tick; the arm then waits (with a
    trickle of real traffic so the replay sampler stays fed) for the
    fingerprint vote + a second leg to convict and quarantine it."""
    from types import SimpleNamespace

    from . import diag, fleet, serving, slo
    from . import router as _router
    fleet_dir = os.path.join(workdir, "spool")
    os.makedirs(fleet_dir, exist_ok=True)
    fleet.install_aggregator(fleet_dir, stale_after_s=60.0,
                             poll_interval_s=0.05)
    diag.start_diag_server(port=0)
    r = _router.Router(
        fleet_dir=fleet_dir, queue_limit=max(64, 4 * args.requests),
        max_attempts=8, retry_base_s=0.05, retry_max_s=1.0,
        retry_total_s=args.timeout, retry_seed=args.seed,
        health_interval_s=0.05, liveness_floor_s=1.0,
        liveness_ceiling_s=15.0).start()
    arm = {"corrupt": corrupt}
    try:
        names = [f"r{i}" for i in range(args.replicas)]
        victim = names[-1] if corrupt else None
        spawned, threads, errs = {}, [], {}

        def _spawn_one(n):
            sa = SimpleNamespace(**vars(args))
            sa.fault_delay = 0.0
            sa.corrupt_after = (args.corrupt_after
                                if corrupt and n == victim else 0)
            try:
                spawned[n] = _router.spawn_replica(n, fleet_dir, sa)
            except Exception as e:
                errs[n] = e

        for n in names:
            t = threading.Thread(target=_spawn_one, args=(n,))
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
        obs = install_observatory(
            r, sustain=2, min_replicas=args.min_replicas,
            replay_min_peers=2)
        obs.start_canary(
            vocab=args.vocab, n_goldens=4, prompt_len=6, max_new=8,
            interval_s=args.canary_interval, seed=args.seed,
            timeout_s=args.timeout)
        obs.start_replay(fraction=args.replay_fraction,
                         timeout_s=args.timeout)
        wl = serving.poisson_workload(
            args.seed, args.requests, args.rps, args.vocab,
            (args.prompt_lo, args.prompt_hi), (4, args.new_hi))
        handles = []
        t0 = time.perf_counter()
        for i in range(args.requests):
            dt = t0 + wl["arrivals"][i] - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
            handles.append(r.submit(wl["prompts"][i],
                                    int(wl["new_lens"][i])))
        stuck = [h.id for h in handles if not h.wait(args.timeout)]
        # detection window: the corrupt arm waits for conviction, the
        # clean arm holds the same probe pressure to prove NO false
        # positive fires over an equivalent budget
        deadline = time.monotonic() + (args.detect_timeout if corrupt
                                       else args.settle)
        trickles = []
        det = _detection(obs.snapshot(), victim) if corrupt else None
        probes_at_detect = None
        while time.monotonic() < deadline:
            if corrupt:
                det = _detection(obs.snapshot(), victim)
                if det["quarantined"] and "fingerprint" in det["legs"] \
                        and len(det["legs"]) >= 2:
                    probes_at_detect = obs.prober.probes
                    break
                i = len(trickles) % args.requests
                trickles.append(r.submit(wl["prompts"][i],
                                         int(wl["new_lens"][i])))
            time.sleep(0.25)
        stuck += [h.id for h in trickles if not h.wait(args.timeout)]
        if corrupt and det and det["quarantined"] \
                and not det.get("capped"):
            # detection and retirement are separate milestones: the
            # drain thread runs the confirmation burst first, so give
            # the quarantine (bounded) time to actually retire the
            # victim before sampling its state
            drain_deadline = time.monotonic() + 120.0
            while time.monotonic() < drain_deadline:
                state = next(
                    (rep["state"] for rep in r.snapshot()["replicas"]
                     if rep["name"] == victim), None)
                if state != "live":
                    break
                time.sleep(0.25)
        osnap = obs.snapshot()
        rsnap = r.snapshot()
        arm.update({
            "stuck": stuck,
            "outcomes": {h.id: h.outcome
                         for h in handles + trickles},
            "completed": sum(1 for h in handles + trickles
                             if h.outcome == "completed"),
            "submitted": len(handles) + len(trickles),
            "observatory": osnap,
            "mismatch_total": _mismatch_total(osnap),
            "victim": victim,
            "victim_state": next(
                (rep["state"] for rep in rsnap["replicas"]
                 if rep["name"] == victim), None) if corrupt else None,
            "detection": (_detection(osnap, victim)
                          if corrupt else None),
            "probes_at_detect": probes_at_detect,
            "canary_probes": osnap["canary_probes"],
            "replays": osnap["replays"],
            "auditz_has_section": "== audit ==" in audit_report(),
            "fleetz_has_audit": "== fleet audit =="
            in "\n".join(fleetz_lines()),
        })
        return arm
    finally:
        reset()
        _router.reset()
        fleet.uninstall()
        diag.stop_diag_server()
        slo.tail_reset()


def _ab_main(args) -> int:
    import shutil

    from .fleet import _require_device
    _require_device(args.device)
    base = tempfile.mkdtemp(prefix="singa_audit_ab_")
    rec = {"replicas": args.replicas, "requests": args.requests,
           "rps": args.rps, "seed": args.seed,
           "corrupt_after": args.corrupt_after,
           "audit_interval": args.audit_interval,
           "device": args.device, "ok": False}
    try:
        clean = _ab_arm(args, os.path.join(base, "clean"),
                        corrupt=False)
        corrupt = _ab_arm(args, os.path.join(base, "corrupt"),
                          corrupt=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    lost = (len(clean["stuck"]) + len(corrupt["stuck"])
            + sum(1 for o in clean["outcomes"].values() if o is None)
            + sum(1 for o in corrupt["outcomes"].values() if o is None))
    not_completed = (
        clean["submitted"] - clean["completed"]
        + corrupt["submitted"] - corrupt["completed"])
    false_pos = clean["mismatch_total"] \
        + len(clean["observatory"]["quarantined"])
    det = corrupt["detection"] or {}
    legs = det.get("legs") or []
    probe_budget = args.probe_budget
    rec.update({
        "clean_completed": clean["completed"],
        "clean_submitted": clean["submitted"],
        "corrupt_completed": corrupt["completed"],
        "corrupt_submitted": corrupt["submitted"],
        "lost_requests": lost,
        "not_completed": not_completed,
        "false_positives_clean_arm": false_pos,
        "clean_canary_probes": clean["canary_probes"],
        "clean_replays": clean["replays"],
        "legs_detected": legs,
        "victim": corrupt["victim"],
        "victim_quarantined": det.get("quarantined"),
        "victim_state": corrupt["victim_state"],
        "quarantine_capped": det.get("capped"),
        "probes_at_detect": corrupt["probes_at_detect"],
        "corrupt_canary_probes": corrupt["canary_probes"],
        "corrupt_replays": corrupt["replays"],
        "corrupt_mismatches": corrupt["mismatch_total"],
        "auditz_has_section": bool(
            clean["auditz_has_section"]
            and corrupt["auditz_has_section"]),
        "fleetz_has_audit": bool(clean["fleetz_has_audit"]
                                 and corrupt["fleetz_has_audit"]),
    })
    rec["ok"] = bool(
        clean["completed"] == clean["submitted"]
        and corrupt["completed"] == corrupt["submitted"]
        and lost == 0
        and false_pos == 0
        and det.get("quarantined") and not det.get("capped")
        and corrupt["victim_state"] in ("draining", "dead")
        and "fingerprint" in legs and len(legs) >= 2
        and corrupt["probes_at_detect"] is not None
        and corrupt["canary_probes"] <= probe_budget
        and corrupt["replays"] <= probe_budget
        and rec["auditz_has_section"] and rec["fleetz_has_audit"])
    lines = [
        {"metric": "audit_divergence_count",
         "value": float(corrupt["mismatch_total"]), "unit": "count"},
        {"metric": "audit_canary_miscompare_count",
         "value": float(sum(
             (legs_.get(LEG_CANARY) or {}).get("mismatch", 0)
             for legs_ in (corrupt["observatory"]["replicas"]
                           or {}).values())), "unit": "count"},
        {"metric": "audit_false_positive_count",
         "value": float(false_pos), "unit": "count"},
        {"metric": "audit_lost_requests", "value": float(lost),
         "unit": "count"},
        {"metric": "audit_probes_to_detect",
         "value": float(corrupt["probes_at_detect"] or -1),
         "unit": "count"},
        {"metric": "audit_replays_run",
         "value": float(corrupt["replays"]), "unit": "count"},
        rec,
    ]
    with open(args.out, "w", encoding="utf-8") as f:
        for obj in lines:
            f.write(json.dumps(obj, sort_keys=True) + "\n")
    print(json.dumps(rec, indent=2, sort_keys=True))
    return 0 if rec["ok"] else 1


# ---- CLI --------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m singa_tpu_torch.audit",
        description="serving correctness observatory: --ab runs the "
                    "injected-corruption detection harness")
    p.add_argument("--ab", action="store_true")
    p.add_argument("--replicas", type=int, default=3)
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--rps", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--vocab", type=int, default=211)
    p.add_argument("--dim", type=int, default=64,
                   help="model width (4 heads); on the card 256 or 512, "
                        "the flash kernel's head widths 64 and 128")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--prompt-lo", type=int, default=4)
    p.add_argument("--prompt-hi", type=int, default=12)
    p.add_argument("--new-hi", type=int, default=16)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--page-size", type=int, default=8)
    p.add_argument("--publish-interval", type=float, default=0.1)
    p.add_argument("--audit-interval", type=float, default=0.25,
                   help="replica fingerprint recompute period")
    p.add_argument("--corrupt-after", type=int, default=80,
                   help="corrupt arm: bit-flip the victim's params at "
                        "its Nth fingerprint tick (~N*interval seconds "
                        "after the victim's ready line — late enough "
                        "that goldens are recorded and traffic is "
                        "flowing before the fault window opens)")
    p.add_argument("--canary-interval", type=float, default=0.15)
    p.add_argument("--replay-fraction", type=float, default=0.5)
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--detect-timeout", type=float, default=90.0,
                   help="corrupt arm: max seconds to wait for >=2-leg "
                        "detection + quarantine")
    p.add_argument("--settle", type=float, default=4.0,
                   help="clean arm: probe-pressure window that must "
                        "produce zero false positives")
    p.add_argument("--probe-budget", type=int, default=400,
                   help="detection must fit inside this many canary "
                        "probes / replays")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where every replica runs")
    p.add_argument("--out", default="AUDIT_torch.json")
    args = p.parse_args(argv)
    if args.ab:
        return _ab_main(args)
    p.error("pick a mode: --ab")
    return 2


__all__ = [
    "AUDIT_LEGS", "AUDIT_VERDICTS",
    "LEG_FINGERPRINT", "LEG_CANARY", "LEG_REPLAY",
    "VERDICT_MATCH", "VERDICT_MISMATCH", "VERDICT_ERROR",
    "ParamFingerprinter", "CanaryProber", "ShadowReplayer",
    "AuditObservatory",
    "install_fingerprint", "get_fingerprinter", "refresh_fingerprint",
    "install_observatory", "get_observatory", "reset",
    "fleet_audit_snapshot", "audit_json", "audit_report",
    "fleetz_lines",
]

if __name__ == "__main__":
    # run under the CANONICAL module (not the runpy __main__ alias): the
    # CLI installs module singletons the diag/fleet layers reach via
    # `import singa_tpu_torch.audit`
    from singa_tpu_torch.audit import main as _main
    sys.exit(_main())
