"""The live device-memory ledger with OOM forensics (counterpart of
singa_tpu/memory.py).

  - **MemoryLedger**: one device's live total, attributed to the declared
    regions of `MEM_REGIONS` through registration hooks at the sites
    where tensors are born: model parameters (`Model`'s first step of a
    signature), optimizer slots (`Optimizer.setup`), the device prefetch
    ring (`overlap.DevicePrefetcher`), serving KV caches (the engine's
    page pools, `generate`'s caches) and flight-recorder batch snapshots
    (the retained step inputs while a health monitor is attached).
    Anything unclaimed is `unattributed`, so the regions always
    RECONCILE: the sum of `singa_mem_region_bytes{region=...}` equals the
    live total at every snapshot, by construction.

  - **The live total.** torch keeps no list of live tensors (the JAX
    package enumerates `jax.live_arrays()`), so the total is read per
    device:

      - on the card it is the caching allocator's
        `torch.cuda.memory_allocated(device)` and `n_arrays` its count of
        active blocks (`torch.cuda.memory_stats`);
      - on the CPU, where no allocator keeps counts, the live tensors are
        enumerated through `gc.get_objects()`: this is the port's
        `jax.live_arrays()`. It costs ~0.1 s in a process of a few
        hundred thousand objects, so `observe.record_hbm`'s fallback is
        throttled (`hbm_fallback_bytes`) and the ledger snapshots every
        `interval_steps` steps.

    Tensors are attributed by their storage (keyed on the device and
    `untyped_storage().data_ptr()`, sized by the storage's bytes), so two
    views of one storage count once: `Layer.get_params()` returns views
    over the parameters' storage. `unattributed` is the total less the
    attributed bytes. On the card it therefore also holds what no
    provider names: the CUDA-graph pools' intermediates and static
    buffers, the allocator's rounding of each block to 512 bytes, and
    workspaces. A snapshot that attributes more than the total counts
    something twice: it raises instead of clamping.

  - **Timeline ring**: a bounded deque of snapshots, taken after each
    graph-mode training step (`observe.add_step_listener`, after
    `record_step`) and at the exit of the `SNAPSHOT_SPAN_LEAVES` spans
    (`generate`'s `serving.decode`, the engine's per-sync and prefill
    spans, on the engine's thread), exported as the `singa_mem_*`
    gauges.

  - **Leak detector**: a sustained positive slope of the total after
    warmup feeds `HealthMonitor.note_external(KIND_MEM_LEAK)`; the region
    with the largest growth over the window names the suspect.

  - **OOM forensics**: the dispatch sites (the training step, eager and
    graph-mode, under the key "step"; `generate`'s prefill and token
    loop, the speculative and beam calls, the engine's prefill and sync,
    under the JAX package's executor keys) dump a FlightRecorder-style
    JSONL bundle on `torch.OutOfMemoryError` (`on_oom`), which
    `health.load_flight_bundle` loads, and the error propagates
    unchanged. The bundle's `executables` are the last eight builds of
    `introspect`'s manifest (None before any build).

  - **Pre-flight fit**: `estimate_fit(model, batch)` sets the larger of
    the last step build's memory (`introspect.last_build("step")`:
    arguments, outputs and, on the card, temps) and the measured
    parameter, optimizer and batch bytes against the device limit
    (`torch.cuda.mem_get_info` on the card, `SINGA_TPU_HBM_LIMIT_BYTES`
    elsewhere); `source` says which side won.

Overhead contract: a snapshot is host-only on both devices: no `.item()`,
no synchronize and no read of tensor values, so a ledger installed
during graph-mode training adds no capture (the build count stays 1).
"""

from __future__ import annotations

import gc
import json
import os
import threading
import time
import weakref
from collections import deque

import torch

from . import device as device_module
from . import introspect, observe

# ---- regions (the lint in tools/check_metrics_names.py greps this) --------

#: Every region a live device storage can be attributed to. Attribution
#: is first-match in THIS order (params before opt_state before caches),
#: with `unattributed` the catch-all, so each storage lands in exactly
#: one region and the per-region bytes always sum to the live total.
MEM_REGIONS = ("params", "opt_state", "prefetch_ring", "kv_cache",
               "flight_snapshot", "unattributed")
REGION_PARAMS = "params"
REGION_OPT_STATE = "opt_state"
REGION_PREFETCH_RING = "prefetch_ring"
REGION_KV_CACHE = "kv_cache"
REGION_FLIGHT_SNAPSHOT = "flight_snapshot"
REGION_UNATTRIBUTED = "unattributed"

#: span leaves whose exit triggers a ledger snapshot. Train steps are
#: snapshotted from the post-step `observe.add_step_listener` hook, as in
#: the JAX package; `generate`'s decode span exit is when its KV caches
#: are alive, the engine's per-sync span keeps the page pools on the
#: timeline of a process that only serves, and its prefill span catches
#: the admission seam.
SNAPSHOT_SPAN_LEAVES = ("serving.decode", "serving.engine_step",
                        "serving.engine_prefill")

#: top-K largest live storages embedded in an OOM bundle
OOM_TOP_K = 16


# ---- birth-site registry ---------------------------------------------------
# Providers persist independently of any installed ledger: the hooks in
# model/opt/overlap fire at construction time, which may predate
# install_ledger(). Each provider is a zero-arg callable returning the
# CURRENT tensors of its region (re-asked at every snapshot).

_lock = threading.RLock()
_providers: "dict[tuple[str, int], callable]" = {}
_transients: "dict[int, tuple[weakref.ref, str]]" = {}


def _check_region(region: str):
    if region not in MEM_REGIONS:
        raise ValueError(f"region {region!r} not in {MEM_REGIONS}")


def _cleanup_providers(key_id: int, regions):
    """Weakref callback factory: when a tracked object dies, its
    provider entries are dropped, so a long-lived process that rebuilds
    models and optimizers does not accumulate dead closures."""

    def _cb(_ref):
        with _lock:
            for rg in regions:
                _providers.pop((rg, key_id), None)

    return _cb


def register_provider(region: str, key, fn):
    """Register `fn() -> tensors` as the current contents of `region`
    (keyed, so re-registration for the same object replaces)."""
    _check_region(region)
    with _lock:
        _providers[(region, id(key) if not isinstance(key, int) else key)] \
            = fn
    return fn


def unregister_provider(region: str, key):
    with _lock:
        _providers.pop(
            (region, id(key) if not isinstance(key, int) else key), None)


def region_has_provider(region: str) -> bool:
    """True when a persistent birth-site provider owns `region`: the
    decode paths skip their transient note_arrays(kv_cache) once an
    engine's page pools are registered."""
    _check_region(region)
    with _lock:
        return any(rg == region for (rg, _k) in _providers)


def _is_dense(t) -> bool:
    return t.layout == torch.strided and t.device.type != "meta"


def _iter_arrays(obj):
    """Yield every dense torch tensor reachable from `obj` (tuples, lists,
    dicts, Tensor-likes via `.data`); other leaves are skipped."""
    if obj is None:
        return
    if isinstance(obj, torch.Tensor):
        if _is_dense(obj):
            yield obj
        return
    data = getattr(obj, "data", None)
    if isinstance(data, torch.Tensor):
        if _is_dense(data):
            yield data
        return
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _iter_arrays(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _iter_arrays(v)


def _storage(t):
    """(key, bytes) of a tensor's storage: views of one storage share the
    key."""
    s = t.untyped_storage()
    return (t.device, s.data_ptr()), int(s.nbytes())


def note_arrays(region: str, tree):
    """Transiently attribute every tensor in `tree` to `region` for as
    long as the tensor object stays alive (weakref-keyed, so a freed
    tensor, or an id reused after GC, is never misattributed). The
    decode paths use it for their KV caches."""
    _check_region(region)
    n = 0
    with _lock:
        for a in _iter_arrays(tree):
            aid = id(a)

            def _drop(_ref, _aid=aid):
                with _lock:
                    _transients.pop(_aid, None)

            _transients[aid] = (weakref.ref(a, _drop), region)
            n += 1
    return n


def track_model(model):
    """The model's birth-site hook (called when a training step signature
    is first built): params follow the model's raw parameters, and the
    retained step inputs attribute to `flight_snapshot` while a health
    monitor is attached."""
    key_id = id(model)
    ref = weakref.ref(model, _cleanup_providers(
        key_id, (REGION_PARAMS, REGION_FLIGHT_SNAPSHOT)))

    def params():
        m = ref()
        return list(m._raw_params().values()) if m is not None else ()

    def flight():
        m = ref()
        if m is None or getattr(m, "_health_monitor", None) is None:
            return ()
        return getattr(m, "_last_input_arrs", None) or ()

    register_provider(REGION_PARAMS, key_id, params)
    register_provider(REGION_FLIGHT_SNAPSHOT, key_id, flight)


def track_optimizer(opt):
    """`Optimizer.setup`'s birth-site hook: the step counter and every
    slot, re-read per snapshot."""
    key_id = id(opt)
    ref = weakref.ref(opt, _cleanup_providers(key_id,
                                              (REGION_OPT_STATE,)))

    def slots():
        o = ref()
        return list(o.state_arrays()) if o is not None else ()

    register_provider(REGION_OPT_STATE, key_id, slots)


def track_prefetcher(prefetcher):
    """`overlap.DevicePrefetcher`'s birth-site hook: the batches parked
    in its ring."""
    key_id = id(prefetcher)
    ref = weakref.ref(prefetcher, _cleanup_providers(
        key_id, (REGION_PREFETCH_RING,)))

    def ring():
        p = ref()
        if p is None:
            return ()
        with p._cond:
            items = list(p._ring)   # may hold the end marker: no tensors
        return list(_iter_arrays(items))

    register_provider(REGION_PREFETCH_RING, key_id, ring)


def untrack(region: str, obj):
    """Drop a birth-site registration (DevicePrefetcher.close)."""
    unregister_provider(region, obj)


def _resolve(device) -> torch.device:
    td = device_module.resolve(device)
    if td.type == "cuda" and td.index is None:
        td = torch.device("cuda", torch.cuda.current_device())
    return td


def _live_storages(td) -> dict:
    """{storage key: (bytes, a tensor on it)} of every live dense tensor
    on `td` that the garbage collector tracks."""
    out = {}
    for o in gc.get_objects():
        # type(), not isinstance(): isinstance falls back to __class__,
        # which some lazily deprecated module attributes warn on
        if not issubclass(type(o), torch.Tensor):
            continue
        if o.device != td or not _is_dense(o):
            continue
        key, nb = _storage(o)
        if nb and key not in out:
            out[key] = (nb, o)
    return out


def total_live_bytes(device=None) -> int:
    """The live byte total of one device (the card unless `device` says
    otherwise): the caching allocator's count on the card, the
    enumerated live storages on the CPU."""
    td = _resolve(device)
    if td.type == "cuda":
        return int(torch.cuda.memory_allocated(td))
    return sum(nb for nb, _ in _live_storages(td).values())


_fallback_cache = [float("-inf"), 0]  # [monotonic ts, bytes]


def hbm_fallback_bytes(max_age_s: float = 0.5) -> int:
    """`observe.record_hbm`'s in-use bytes on the CPU, where no allocator
    keeps counters: the installed CPU ledger's latest snapshot total when
    one exists, else a direct enumeration throttled to one per
    `max_age_s` (record_hbm runs on every step)."""
    led = _ledger
    if led is not None and led.device.type == "cpu" and led.timeline:
        return int(led.timeline[-1]["total_bytes"])
    now = time.monotonic()
    if now - _fallback_cache[0] < max_age_s:
        return _fallback_cache[1]
    v = total_live_bytes("cpu")
    _fallback_cache[0] = now
    _fallback_cache[1] = v
    return v


# ---- leak detection --------------------------------------------------------

class LeakDetector:
    """Sustained-growth watchdog over the ledger's total-bytes series.

    After `warmup` snapshots, a least-squares slope over the last
    `window` snapshots above `min_slope_bytes` (per step) for `sustain`
    consecutive checks is a leak verdict: counted per suspect region
    (`singa_mem_leak_verdicts_total{region=...}`), fed to the active
    `HealthMonitor.note_external(KIND_MEM_LEAK)` under `policy` (None =
    the monitor's own warn/halt), and held until the slope drops back
    under the threshold (one verdict per episode, not one per step).
    """

    def __init__(self, warmup: int = 5, window: int = 8,
                 min_slope_bytes: float = 4096.0, sustain: int = 3,
                 policy: "str | None" = None):
        if policy is not None and policy not in ("warn", "halt"):
            raise ValueError(f"policy {policy!r} not in ('warn','halt')")
        self.warmup = int(warmup)
        self.window = max(2, int(window))
        self.min_slope_bytes = float(min_slope_bytes)
        self.sustain = int(sustain)
        self.policy = policy
        self.slope = 0.0
        self.verdicts: list = []
        self._seen = 0
        self._over = 0
        self._flagged = False

    @staticmethod
    def _fit_slope(ys):
        n = len(ys)
        xm = (n - 1) / 2.0
        ym = sum(ys) / n
        num = sum((i - xm) * (y - ym) for i, y in enumerate(ys))
        den = sum((i - xm) ** 2 for i in range(n))
        return num / den if den else 0.0

    def check(self, timeline, step=None) -> "dict | None":
        """Feed one snapshot tick; returns the verdict dict when a new
        leak episode is flagged, else None."""
        self._seen += 1
        if self._seen <= self.warmup or len(timeline) < self.window:
            return None
        tail = list(timeline)[-self.window:]
        self.slope = self._fit_slope([s["total_bytes"] for s in tail])
        if observe.is_enabled():
            observe.gauge(
                "singa_mem_leak_slope_bytes",
                "live-bytes growth per step over the leak-detector "
                "window").set(self.slope)
        if self.slope <= self.min_slope_bytes:
            self._over = 0
            self._flagged = False
            return None
        self._over += 1
        if self._over < self.sustain or self._flagged:
            return None
        self._flagged = True
        deltas = {r: tail[-1]["regions"].get(r, 0)
                  - tail[0]["regions"].get(r, 0) for r in MEM_REGIONS}
        suspect = max(deltas, key=lambda r: deltas[r])
        verdict = {
            "step": int(step) if step is not None else None,
            "slope_bytes_per_step": round(self.slope, 1),
            "suspect_region": suspect,
            "suspect_delta_bytes": int(deltas[suspect]),
            "window": self.window,
            "ts": round(time.time(), 6),
        }
        self.verdicts.append(verdict)
        assert suspect in MEM_REGIONS
        if observe.is_enabled():
            observe.counter(
                "singa_mem_leak_verdicts_total",
                "sustained live-bytes growth verdicts, by suspect region"
            ).inc(region=suspect)
            observe.get_registry().emit(
                {"kind": "mem", "event": "leak", **verdict})
        from . import health
        mon = health.active_monitor()
        if mon is not None:
            action = self.policy
            if action is None:
                action = "halt" if mon.policy == "halt" else "warn"
            try:
                verdict["action"] = mon.note_external(
                    health.KIND_MEM_LEAK, detail=dict(verdict),
                    step=step, action=action)
            except Exception:
                pass  # the monitor must never break the step path
        return verdict


# ---- the ledger ------------------------------------------------------------

class MemoryLedger:
    """Live device-memory ledger of one device (the card unless `device`
    says otherwise): snapshot on demand (or per step via the listeners
    `install_ledger` wires), keep a bounded timeline, export gauges, and
    run the leak detector.

    `interval_steps`: snapshot every Nth training step (1 = every step).
    `sample_interval_s > 0` additionally starts a daemon sampler thread
    (``singa-mem-sampler``) for processes that never step (pure
    serving); `close()`/`uninstall_ledger`/`reset()` joins it.

    `out_dir=None` (the default) means OOM bundles follow the active
    HealthMonitor's recorder directory, falling back to the CWD.
    """

    def __init__(self, timeline: int = 512, interval_steps: int = 1,
                 sample_interval_s: float = 0.0, leak: "LeakDetector | "
                 "bool | None" = True, out_dir: "str | None" = None,
                 top_k: int = OOM_TOP_K, device=None):
        self.device = _resolve(device)
        self.timeline: "deque[dict]" = deque(maxlen=int(timeline))
        self.interval_steps = max(1, int(interval_steps))
        self.out_dir = str(out_dir) if out_dir is not None else None
        self.top_k = int(top_k)
        self.enabled = True
        self.leak = (LeakDetector() if leak is True
                     else (leak or None))
        self.steps_seen = 0
        self._snap_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        if sample_interval_s > 0:
            self._thread = threading.Thread(
                target=self._sample_loop, args=(float(sample_interval_s),),
                name="singa-mem-sampler", daemon=True)
            with _lock:
                _samplers.append(self)
            self._thread.start()

    # -- attribution -------------------------------------------------------
    def _region_keys(self) -> "dict[tuple, tuple[str, int]]":
        """storage key -> (region, bytes) of this device's provided and
        noted tensors; first region in MEM_REGIONS order wins."""
        with _lock:
            providers = list(_providers.items())
            transients = list(_transients.values())
        by_region = {r: [] for r in MEM_REGIONS}
        for (region, _key), fn in providers:
            by_region[region].extend(_iter_arrays(fn()))
        for ref, region in transients:
            a = ref()
            if a is not None:
                by_region[region].append(a)
        keys = {}
        for region in MEM_REGIONS:
            for a in by_region[region]:
                if a.device != self.device:
                    continue
                key, nb = _storage(a)
                if nb:
                    keys.setdefault(key, (region, nb))
        return keys

    def snapshot(self, step: "int | None" = None) -> dict:
        """One reconciled breakdown of the device's live memory. The
        region sums equal the live total by construction: every
        attributed storage counts once, `unattributed` is the rest."""
        with self._snap_lock:
            keys = self._region_keys()
            regions = {r: 0 for r in MEM_REGIONS}
            counts = {r: 0 for r in MEM_REGIONS}
            if self.device.type == "cuda":
                stats = torch.cuda.memory_stats(self.device)
                total = int(stats.get("allocated_bytes.all.current", 0))
                n = int(stats.get("active.all.current", 0))
                for region, nb in keys.values():
                    regions[region] += nb
                    counts[region] += 1
            else:
                live = _live_storages(self.device)
                for key, (region, nb) in keys.items():
                    live.setdefault(key, (nb, None))
                total = n = 0
                for key, (nb, _t) in live.items():
                    region = keys.get(key, (REGION_UNATTRIBUTED,))[0]
                    regions[region] += nb
                    counts[region] += 1
                    total += nb
                    n += 1
            attributed = sum(regions.values())
            got = sum(counts.values())
            if self.device.type == "cuda":
                if attributed > total or got > n:
                    raise RuntimeError(
                        f"memory ledger attributes {attributed} bytes in "
                        f"{got} storages on {self.device}, more than the "
                        f"allocator's {total} bytes in {n} blocks: a "
                        "storage is counted twice")
                regions[REGION_UNATTRIBUTED] = total - attributed
                counts[REGION_UNATTRIBUTED] = n - got
            snap = {
                "ts": round(time.time(), 6),
                "step": int(step) if step is not None
                else self.steps_seen,
                "regions": regions,
                "counts": counts,
                "total_bytes": total,
                "n_arrays": n,
            }
            self.timeline.append(snap)
            self._export(snap)
            return snap

    @staticmethod
    def _export(snap: dict):
        if not observe.is_enabled():
            return
        g = observe.gauge(
            "singa_mem_region_bytes",
            "live device bytes attributed to each ledger region")
        for region in MEM_REGIONS:
            g.set(float(snap["regions"][region]), region=region)
        observe.gauge("singa_mem_total_bytes",
                      "total live device bytes (jax.live_arrays)"
                      ).set(float(snap["total_bytes"]))
        observe.gauge("singa_mem_live_arrays",
                      "live device arrays (jax.live_arrays)"
                      ).set(float(snap["n_arrays"]))
        observe.counter("singa_mem_snapshots_total",
                        "memory-ledger snapshots taken").inc()

    def top_arrays(self, k: "int | None" = None) -> list:
        """The K largest live storages of the device, freshly attributed:
        [{nbytes, shape, dtype, region}] (shape and dtype of one tensor
        on the storage), the OOM bundle's "who is biggest"."""
        keys = self._region_keys()
        rows = [{"nbytes": nb, "shape": list(t.shape), "dtype": str(t.dtype),
                 "region": keys.get(key, (REGION_UNATTRIBUTED,))[0]}
                for key, (nb, t) in _live_storages(self.device).items()]
        rows.sort(key=lambda r: -r["nbytes"])
        return rows[:(k or self.top_k)]

    def timeline_copy(self) -> list:
        """A consistent copy of the timeline ring, for readers on other
        threads (a deque iterated raw races the training thread's
        append)."""
        with self._snap_lock:
            return list(self.timeline)

    def region_bytes(self) -> "dict | None":
        """The latest snapshot's {regions, total_bytes, n_arrays, step}."""
        if not self.timeline:
            return None
        s = self.timeline[-1]
        return {"regions": dict(s["regions"]),
                "total_bytes": s["total_bytes"],
                "n_arrays": s["n_arrays"], "step": s["step"]}

    # -- step plumbing -----------------------------------------------------
    def _on_step(self, _seconds):
        """observe.add_step_listener hook: fires at the end of
        record_step, after the step's call returned."""
        if not self.enabled:
            return
        self.steps_seen += 1
        if self.steps_seen % self.interval_steps:
            return
        self.snapshot(step=self.steps_seen)
        if self.leak is not None:
            self.leak.check(self.timeline_copy(), step=self.steps_seen)

    def _on_span(self, path, _seconds, _attrs):
        if not self.enabled:
            return
        if path.rsplit("/", 1)[-1] in SNAPSHOT_SPAN_LEAVES:
            self.snapshot()

    def _sample_loop(self, interval_s: float):
        while not self._stop.wait(interval_s):
            try:
                if self.enabled:
                    self.snapshot()
            except Exception:
                pass  # sampling must never kill the thread

    def close(self):
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=5.0)
        with _lock:
            if self in _samplers:
                _samplers.remove(self)


# ---- module singleton ------------------------------------------------------

_ledger: "MemoryLedger | None" = None
_samplers: "list[MemoryLedger]" = []  # ledgers with a live sampler thread


def install_ledger(**kwargs) -> MemoryLedger:
    """Install (or return) the process MemoryLedger and wire it to the
    step and span streams. Idempotent: a second call returns the running
    ledger. `device=` picks the device (the card by default)."""
    global _ledger
    with _lock:
        if _ledger is not None:
            return _ledger
        _ledger = MemoryLedger(**kwargs)
        observe.add_step_listener(_ledger._on_step)
        observe.add_span_listener(_ledger._on_span)
        return _ledger


def uninstall_ledger():
    """Remove the ledger: listeners detached, sampler thread joined.
    Birth-site providers stay registered (they belong to the objects,
    not the ledger); `reset()` clears those too."""
    global _ledger
    with _lock:
        led = _ledger
        _ledger = None
    if led is not None:
        observe.remove_step_listener(led._on_step)
        observe.remove_span_listener(led._on_span)
        led.close()


def get_ledger() -> "MemoryLedger | None":
    return _ledger


def reset():
    """Full teardown: ledger uninstalled, every sampler thread joined
    (including a raw MemoryLedger built without install_ledger), every
    provider and transient note dropped, the record_hbm fallback cache
    invalidated."""
    uninstall_ledger()
    with _lock:
        stray = list(_samplers)
    for led in stray:
        led.close()
    with _lock:
        _providers.clear()
        _transients.clear()
    _fallback_cache[0] = float("-inf")
    _fallback_cache[1] = 0


# ---- OOM forensics ---------------------------------------------------------

def is_resource_exhausted(exc) -> bool:
    """True for the caching allocator's `torch.OutOfMemoryError` (also
    spelled `torch.cuda.OutOfMemoryError`)."""
    return isinstance(exc, torch.OutOfMemoryError)


def dump_oom_bundle(exc=None, key=None, out_dir=None,
                    ledger: "MemoryLedger | None" = None,
                    device=None) -> str:
    """Write the OOM post-mortem bundle (JSONL, `flight_oom_step<N>`,
    loaded by `health.load_flight_bundle`): a header carrying the region
    breakdown, the top-K largest live storages and the fit estimate,
    then the memory timeline as `flight_step` lines and the recent
    EventLog tail. Without a ledger, a one-shot one on `device` (the
    card by default) takes the snapshot."""
    led = ledger if ledger is not None else _ledger
    one_shot = led is None
    if one_shot:
        led = MemoryLedger(timeline=1, leak=None, device=device)
    snap = led.snapshot()
    top = led.top_arrays()
    fit = None
    try:
        fit = estimate_fit(device=led.device)
    except Exception:
        pass  # the post-mortem must land even if the estimate fails
    d = out_dir or led.out_dir
    if d is None:
        from . import health
        mon = health.active_monitor()
        d = getattr(getattr(mon, "recorder", None), "out_dir", None) \
            or "."
    os.makedirs(d, exist_ok=True)
    c = observe.get_registry().get("singa_steps_total")
    step = int(c.value()) if c is not None else led.steps_seen
    path = os.path.join(d, f"flight_oom_step{step}.jsonl")
    k = 1
    while os.path.exists(path):
        # a second OOM at the same step count (a serving process that
        # catches and carries on) must not overwrite the first
        k += 1
        path = os.path.join(d, f"flight_oom_step{step}_{k}.jsonl")
    tail = list(observe.get_registry().recent)[-64:]
    timeline = led.timeline_copy()
    header = {
        "kind": "flight_header", "ts": round(time.time(), 6),
        "reason": "oom", "step": step,
        "n_steps": len(timeline), "n_events": len(tail),
        "oom": {
            "error": str(exc)[:2000] if exc is not None else None,
            "executable_key": key,
            "regions": dict(snap["regions"]),
            "total_bytes": snap["total_bytes"],
            "n_arrays": snap["n_arrays"],
            "top_arrays": top,
            "fit": fit,
        },
        "executables": introspect.executable_manifest()[-8:] or None,
    }
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps(header, separators=(",", ":"),
                           default=str) + "\n")
        for s in timeline:
            f.write(json.dumps({"kind": "flight_step", **s},
                               separators=(",", ":"), default=str) + "\n")
        for ev in tail:
            f.write(json.dumps({"kind": "flight_event", "event": ev},
                               separators=(",", ":"), default=str) + "\n")
    if one_shot:
        led.close()
    return path


def handle_oom(exc, key=None, out_dir=None) -> "str | None":
    """The dispatch-site hook: dump the forensics bundle for an
    out-of-memory error and return its path. Never raises: the original
    OOM must propagate, not a forensics failure."""
    if not is_resource_exhausted(exc):
        return None
    try:
        path = dump_oom_bundle(exc=exc, key=key, out_dir=out_dir)
        # counted only once the bundle exists on disk
        observe.counter("singa_mem_oom_dumps_total",
                        "OOM forensics bundles written").inc()
        observe.get_registry().emit(
            {"kind": "mem", "event": "oom", "bundle": path,
             "executable_key": key, "error": str(exc)[:500]})
        return path
    except Exception:
        return None


class on_oom:
    """`with memory.on_oom("step"): ...`: an out-of-memory error raised
    inside writes the forensics bundle (`handle_oom`, under `key`) and
    propagates unchanged."""

    __slots__ = ("key",)

    def __init__(self, key: str):
        self.key = key

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None and is_resource_exhausted(exc):
            handle_oom(exc, key=self.key)
        return False


# ---- pre-flight fit --------------------------------------------------------

def _device_or_ledger(device) -> torch.device:
    if device is None and _ledger is not None:
        return _ledger.device
    return _resolve(device)


def device_limit_bytes(device=None) -> "int | None":
    """The device memory limit: the card's total memory
    (`torch.cuda.mem_get_info`), else the `SINGA_TPU_HBM_LIMIT_BYTES`
    override (how the CPU tests drive the fit arithmetic), else None.
    `device` None is the ledger's device, or the card."""
    td = _device_or_ledger(device)
    if td.type == "cuda":
        return int(torch.cuda.mem_get_info(td)[1])
    env = os.environ.get("SINGA_TPU_HBM_LIMIT_BYTES")
    if env:
        try:
            return int(float(env))
        except ValueError:
            return None
    return None


def _bytes_of(tensors) -> int:
    """Bytes of the distinct storages among `tensors`."""
    seen = {}
    for a in _iter_arrays(list(tensors)):
        key, nb = _storage(a)
        seen[key] = nb
    return sum(seen.values())


def estimate_fit(model=None, batch=None, device=None) -> dict:
    """Pre-flight "does this training step fit" estimate: the step
    build's memory (`introspect.last_build("step")`: arguments, outputs,
    temps on the card; the `exec_*` fields) against the measured
    parameter + optimizer + batch bytes, the larger of the two against
    the device limit. The build record is process-wide, so the measured
    floor always applies; `source` is "executable" when the build's
    total is at least that floor, else "ledger". `fits` is None when no
    limit is known (the CPU without the env override)."""
    params_b = opt_b = 0
    if model is not None:
        params_b = _bytes_of(model._raw_params().values())
        o = getattr(model, "_optimizer", None)
        if o is not None:
            opt_b = _bytes_of(o.state_arrays())
    elif _ledger is not None and _ledger.timeline:
        regions = _ledger.timeline[-1]["regions"]
        params_b = int(regions.get(REGION_PARAMS, 0))
        opt_b = int(regions.get(REGION_OPT_STATE, 0))
    batch_b = _bytes_of(_iter_arrays(batch)) if batch is not None else 0
    step = introspect.last_build("step")
    mem = dict((step or {}).get("memory") or {})
    exec_total = sum(int(v) for v in mem.values())
    floor = params_b + opt_b + batch_b
    estimated = max(exec_total, floor)
    dev = device if device is not None \
        else getattr(model, "_device", None)
    limit = device_limit_bytes(dev)
    return {
        "params_bytes": params_b,
        "opt_state_bytes": opt_b,
        "batch_bytes": batch_b,
        "exec_arguments_bytes": mem.get("arguments"),
        "exec_outputs_bytes": mem.get("outputs"),
        "exec_temps_bytes": mem.get("temps"),
        "exec_generated_code_bytes": mem.get("generated_code"),
        "estimated_peak_bytes": int(estimated),
        "limit_bytes": limit,
        "fits": (estimated <= limit) if limit else None,
        "headroom_frac": round(1.0 - estimated / limit, 4)
        if limit else None,
        "source": "executable" if exec_total >= floor and exec_total
        else "ledger",
    }


# ---- /memz reports ---------------------------------------------------------

def _mb(b) -> str:
    return f"{(b or 0) / 1e6:10.2f} MB"


def memz_json(timeline_tail: int = 64, include_top: bool = True) -> dict:
    """The JSON memory report: latest breakdown, timeline, leak state and
    the fit estimate, and `static_hbm`, the step build's memory record
    (introspect's static view). The text view passes include_top=False:
    top_arrays costs a fresh enumeration it never renders."""
    led = _ledger
    out: dict = {"installed": led is not None}
    if led is None:
        return out
    if not led.timeline:
        led.snapshot()
    tl = led.timeline_copy()
    s = tl[-1]
    out.update({
        "regions": dict(s["regions"]),
        "counts": dict(s["counts"]),
        "total_bytes": s["total_bytes"],
        "n_arrays": s["n_arrays"],
        "step": s["step"],
        "timeline": [{"step": t["step"], "ts": t["ts"],
                      "total_bytes": t["total_bytes"],
                      "regions": dict(t["regions"])}
                     for t in tl[-timeline_tail:]],
    })
    if include_top:
        out["top_arrays"] = led.top_arrays(8)
    if led.leak is not None:
        out["leak"] = {
            "slope_bytes_per_step": round(led.leak.slope, 1),
            "min_slope_bytes": led.leak.min_slope_bytes,
            "verdicts": list(led.leak.verdicts),
        }
    step = introspect.last_build("step")
    out["static_hbm"] = dict((step or {}).get("memory") or {})
    try:
        out["fit"] = estimate_fit()
    except Exception:
        out["fit"] = None
    return out


def memz_report() -> str:
    """Text block of the memory report: the region breakdown table, the
    reconciliation line, the leak state and the timeline tail."""
    rep = memz_json(timeline_tail=8, include_top=False)
    lines = ["== memory =="]
    if not rep.get("installed"):
        lines.append("no MemoryLedger installed "
                     "(singa_tpu_torch.memory.install_ledger())")
        return "\n".join(lines)
    lines.append(f"{'region':<16} {'bytes':>14} {'MB':>13} {'arrays':>7}")
    for region in MEM_REGIONS:
        b = rep["regions"].get(region, 0)
        lines.append(f"{region:<16} {b:>14}{_mb(b)} "
                     f"{rep['counts'].get(region, 0):>7}")
    lines.append(f"{'TOTAL':<16} {rep['total_bytes']:>14}"
                 f"{_mb(rep['total_bytes'])} {rep['n_arrays']:>7}")
    region_sum = sum(rep["regions"].values())
    ok = "OK" if region_sum == rep["total_bytes"] else "BROKEN"
    lines.append(f"reconciliation: region sum {region_sum} == live "
                 f"total {rep['total_bytes']} ({ok})")
    static = rep.get("static_hbm") or {}
    if static:
        lines.append("static estimate (introspect, step build): "
                     + " | ".join(f"{k} {v / 1e6:.2f} MB"
                                  for k, v in sorted(static.items())))
        live_po = (rep["regions"].get(REGION_PARAMS, 0)
                   + rep["regions"].get(REGION_OPT_STATE, 0))
        est_args = static.get("arguments")
        if est_args:
            drift = (live_po - est_args) / est_args * 100.0
            lines.append(f"estimate-vs-actual: live params+opt "
                         f"{live_po / 1e6:.2f} MB vs build arguments "
                         f"{est_args / 1e6:.2f} MB ({drift:+.1f}% drift)")
    else:
        lines.append("static estimate: none (no step build)")
    leak = rep.get("leak")
    if leak is not None:
        lines.append(f"leak: slope {leak['slope_bytes_per_step']} B/step "
                     f"(threshold {leak['min_slope_bytes']:g}), "
                     f"{len(leak['verdicts'])} verdict(s)")
        for v in leak["verdicts"][-3:]:
            lines.append(f"  step {v['step']}: suspect "
                         f"{v['suspect_region']} "
                         f"(+{v['suspect_delta_bytes']} B over "
                         f"{v['window']} steps)")
    fit = rep.get("fit")
    if fit:
        lim = fit.get("limit_bytes")
        lines.append(
            f"fit: estimated peak {fit['estimated_peak_bytes'] / 1e6:.2f}"
            f" MB vs limit "
            + (f"{lim / 1e6:.2f} MB -> "
               f"{'fits' if fit['fits'] else 'DOES NOT FIT'} "
               f"(headroom {fit['headroom_frac'] * 100.0:.1f}%)"
               if lim else "unknown (no device limit; set "
               "SINGA_TPU_HBM_LIMIT_BYTES)"))
    lines.append("timeline (newest last): " + "  ".join(
        f"s{t['step']}:{t['total_bytes'] / 1e6:.1f}MB"
        for t in rep.get("timeline", [])))
    return "\n".join(lines)


__all__ = [
    "MEM_REGIONS", "MemoryLedger", "LeakDetector",
    "install_ledger", "uninstall_ledger", "get_ledger", "reset",
    "register_provider", "unregister_provider", "region_has_provider",
    "note_arrays",
    "track_model", "track_optimizer", "track_prefetcher", "untrack",
    "total_live_bytes", "hbm_fallback_bytes",
    "is_resource_exhausted", "dump_oom_bundle",
    "handle_oom", "on_oom", "estimate_fit", "device_limit_bytes",
    "memz_report", "memz_json", "SNAPSHOT_SPAN_LEAVES", "OOM_TOP_K",
]
