"""Continuous-batching serving engine with a paged KV cache (counterpart of
singa_tpu/engine.py).

- **Admission queue**: `submit()` enqueues a request (its own prompt, its
  own max_new, optional deadlines) and returns a handle; a background
  daemon thread (``torch-serve-<n>``) owns the decode loop.
- **Continuous batching**: a fixed batch of `max_slots` sequences driven
  by an active mask; finished sequences are evicted and queued ones
  admitted between decode syncs (every `steps_per_sync` steps).
- **Paged KV cache**: one pool of pages per block shared by all slots,
  with a host-side page table per sequence. A request gets
  ceil((S0 + max_new) / page_size) pages at admission and returns them at
  eviction.

Decode is greedy, and its math is `serving._DecodeCore.paged_token_step`
on the paged-attention kernel; prefill runs `prefill_parts` (the
flash-attention kernel) over the prompt padded to its bucket and writes
the true prompt rows into the slot's pages. `kv_dtype` ("int8"/"int4")
quantizes the pools. With `draft_model` and `spec_k`, each sync runs
`steps_per_sync` speculative rounds instead of steps: the draft proposes
spec_k tokens against its own fp pools (indexed by the same page table),
the target verifies them in one `paged_verify_step`, and the longest
accepted prefix plus the target's own token commit, so the tokens equal
plain greedy decoding's. The engine runs on its model's device.

Telemetry (`observe`): the sixteen `singa_serve_*` metrics of the JAX
engine, set where it sets them (`_metrics()`), and the spans
`serving.engine_prefill` around each admission's prefill and
`serving.engine_step` around each sync's decode and its host read. The
decode thread records while `submit` records from the caller's thread:
every metric carries its own lock, and the engine reads its slot state
under its own.

Request timelines (`slo`): every `EngineRequest` stamps the phases of
`slo.REQUEST_PHASES` with `time.perf_counter()` (`mark`): submit, queue,
admit, prefill, first_token, one decode per sync it rode (with the tokens
so far and the sync's id) and terminal. A finished request's timeline
goes into a ring (`timelines()`), each sync's window into another
(`sync_records()`: `t0`/`dur` bracket the sync's decode launches and the
host read of its tokens, inside its `serving.engine_step` span), and the
terminal-request listeners (`add_request_listener`; `slo.SLOTracker` is
one) fire after the engine's bookkeeping and before the handle's
done-event. Every read surface is a locked copy. Each sync passes the
fault point "serving.engine_step" (`resilience`) inside its span, before
its decode. With observe enabled, the non-finite logits of a prefill and
of a sync are counted on the device beside the tokens, come back in the
same host copy, and are booked by `health.record_nan_logits(n,
"engine")`.

Threads: on the CPU each decode thread runs the intra-op threads of the
thread that started its engine divided among the running CPU engines
(`_fit_threads`; torch's OpenMP team size is a per-thread setting), so N
in-process engines do not each run the machine's full count. On the card
nothing is set.

Run-time accounting: each prefill and each sync (its decode and host
read) runs under the watchdog's `decode` deadline (`watchdog.guard`); a
`HangError` raised at a guard's exit, or delivered into the host read
by the watchdog's hard abort, ends the decode loop like any error: every
queued and active request finishes evicted with the error in its
`detail`, and a `loop_error` event is emitted. From `start()` to
`stop()` the page pools (the target's and the draft's) are the memory
ledger's kv_cache provider and the draft's decode parameters its params
provider; an out-of-memory error in a prefill or a sync writes the OOM
bundle under the JAX engine's executor keys (`serving.engine_prefill`,
`serving.engine_step`, `serving.engine_spec_prefill`,
`serving.engine_spec_step`), which are also its `introspect` builds: the
prefill and the sync's decode run through `introspect.AotExecutor`s kept
on the model (`_executors`), whose signatures carry the decode params and
the page pools as the JAX engine's do, so each new signature registers
one build at its first call, counted on the engine thread, and a fresh
engine of the same model and configuration builds nothing. A prefill's
page list is padded to cover its bucket (the JAX engine's fixed length):
one prefill build per bucket.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from . import (health, introspect, memory, observe, resilience, serving,
               watchdog)
from .slo import (PHASE_ADMIT, PHASE_DECODE, PHASE_FIRST_TOKEN,
                  PHASE_PREFILL, PHASE_QUEUE, PHASE_SUBMIT,
                  PHASE_TERMINAL)

#: every terminal state a request can reach
REQUEST_OUTCOMES = ("completed", "evicted", "rejected", "timeout")
OUTCOME_COMPLETED = "completed"
OUTCOME_EVICTED = "evicted"
OUTCOME_REJECTED = "rejected"
OUTCOME_TIMEOUT = "timeout"
#: KV-cache storage modes, as serving.KV_DTYPES: the `kv_dtype=` label of
#: singa_serve_kv_pool_bytes is proven against this tuple by
#: tools/check_metrics_names.py rule 5
KV_DTYPES = ("fp", "int8", "int4")

_metrics_cache: "dict | None" = None


def _metrics():
    """The engine's metrics, registered with the JAX engine's names, types
    and help strings (spelled out so the static lint sees every one).
    Memoized, and rebuilt when the registry was reset."""
    global _metrics_cache
    c = _metrics_cache
    if c is not None and observe.get_registry().get(
            "singa_serve_requests_total") is c["requests"]:
        return c
    _metrics_cache = c = {
        "requests": observe.counter(
            "singa_serve_requests_total",
            "engine requests finished, by terminal outcome"),
        "admitted": observe.counter(
            "singa_serve_admitted_total",
            "requests admitted into a decode slot"),
        "tokens": observe.counter(
            "singa_serve_tokens_total",
            "tokens generated by the serving engine"),
        "steps": observe.counter(
            "singa_serve_steps_total",
            "engine decode steps executed (all slots, per step)"),
        "prefills": observe.counter(
            "singa_serve_prefills_total",
            "engine prefill calls (one per admission)"),
        "queue_depth": observe.gauge(
            "singa_serve_queue_depth",
            "requests waiting in the admission queue"),
        "occupancy": observe.gauge(
            "singa_serve_slot_occupancy",
            "decode slots currently active"),
        "slots": observe.gauge(
            "singa_serve_slots",
            "decode slots the engine was built with"),
        "pages_in_use": observe.gauge(
            "singa_serve_pages_in_use",
            "KV-cache pages currently allocated to sequences"),
        "pages": observe.gauge(
            "singa_serve_page_pool_pages",
            "KV-cache pages in the pool (capacity)"),
        "queue_delay": observe.histogram(
            "singa_serve_queue_delay_seconds",
            "submit-to-admission wall seconds per request"),
        "ttft": observe.histogram(
            "singa_serve_ttft_seconds",
            "submit-to-first-token wall seconds per request"),
        "request_s": observe.histogram(
            "singa_serve_request_seconds",
            "submit-to-terminal wall seconds per request"),
        "rate": observe.gauge(
            "singa_serve_request_tokens_per_sec",
            "last completed request's generation rate"),
        "kv_pool_bytes": observe.gauge(
            "singa_serve_kv_pool_bytes",
            "target KV page-pool bytes by cache storage mode (the "
            "draft model's fp pool is reported separately via "
            "engine.report draft_pool_bytes)"),
    }
    return c


def pctile(xs, p):
    """Nearest-rank percentile over an unsorted sequence (None when
    empty)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))] if xs else None


class EngineRequest:
    """Handle for one submitted request. `wait()`/`result()` block until
    the request reaches a terminal outcome; `tokens` holds what was
    generated (partial on eviction or timeout), `outcome` one of
    REQUEST_OUTCOMES. `events` is the phase-stamped timeline
    (slo.REQUEST_PHASES, perf_counter stamps) that `mark()` appends to,
    `syncs` the engine syncs the request rode, `trace` a router-minted
    trace id, `synthetic` a probe or warm-up kept out of the SLO
    accounting."""

    def __init__(self, rid, prompt, max_new, deadline_s, ttft_deadline_s):
        self.id = rid
        self.prompt = prompt
        self.max_new = int(max_new)
        self.deadline_s = deadline_s
        self.ttft_deadline_s = ttft_deadline_s
        self.trace = None
        self.synthetic = False
        self.submitted = time.monotonic()
        self.admitted = None
        self.first_token_ts = None
        self.finished_ts = None
        self.outcome = None
        self.tokens: "list[int]" = []
        self.slot = None
        self.pages: "list[int]" = []
        self.detail = None
        self.events: "list[tuple]" = []
        self.syncs: "list[int]" = []
        self.last_slot = None
        self._done = threading.Event()
        self.mark(PHASE_SUBMIT)

    def mark(self, phase: str, **info):
        """Stamp one lifecycle event onto the timeline (appends are
        atomic under the GIL; readers take the engine's locked
        copies)."""
        self.events.append((phase, time.perf_counter(), info or None))

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout=None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout=None) -> np.ndarray:
        """The full (prompt + generated) token sequence. Raises on a
        non-completed outcome (the partial `tokens` stay readable)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} still in flight")
        if self.outcome != OUTCOME_COMPLETED:
            raise RuntimeError(
                f"request {self.id} finished {self.outcome}"
                + (f": {self.detail}" if self.detail else ""))
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.tokens, np.int32)])

    @property
    def ttft_s(self):
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.submitted


def _prefill_stage(eng, *args):
    """The engine's prefill behind its executor: (engine, params[, draft
    params], pools[, draft pools], prompt, true_len, pages, count_nf)."""
    return eng._prefill(*args[-4:])


def _decode_stage(eng, *args):
    """The engine's sync decode behind its executor: (engine, params[,
    draft params], pools[, draft pools], tok, page_table, lens, limits,
    active, count_nf)."""
    fn = eng._decode_spec if eng.dcore is not None else eng._decode
    return fn(*args[-6:])


def _executors(model, draft_model):
    """The (prefill, decode) AotExecutors of `model`'s engines under the
    JAX engine's keys (the speculative ones have their own), kept on the
    model so that every engine of it shares their builds."""
    spec = draft_model is not None
    cache = model.__dict__.setdefault("_engine_executors", {})
    if spec not in cache:
        state = ("params", "draft_params", "pools", "draft_pools") if spec \
            else ("params", "pools")
        cache[spec] = (
            introspect.AotExecutor(
                _prefill_stage, "serving.engine_spec_prefill" if spec
                else "serving.engine_prefill",
                names=("engine",) + state + ("prompt", "true_len", "pages",
                                             "count_nf")),
            introspect.AotExecutor(
                _decode_stage, "serving.engine_spec_step" if spec
                else "serving.engine_step",
                names=("engine",) + state + ("tok", "page_table", "lens",
                                             "limits", "active",
                                             "count_nf")))
    return cache[spec]


class ServingEngine:
    """The request-level continuous-batching engine over one model.

    `max_slots` bounds in-flight sequences; `page_size` tokens per KV
    page; `num_pages` the pool size (default: every slot at `max_ctx`);
    `steps_per_sync` decode steps per host sync (the admission/eviction
    cadence); `eos_id` stops a sequence early; `ttft_deadline_s` bounds
    submit-to-first-token (queued requests past it finish "timeout");
    `prompt_buckets` the padded prompt lengths of prefill (default 16,
    32, ... up to max_ctx - 1); `poll_interval_s` how long the idle loop
    waits for a submission before it checks deadlines and the stop flag
    again; `timeline_capacity` the finished-timeline ring's size.
    `use_kernel` goes to every attention op
    as in `_DecodeCore`: None picks by device, False runs the plain
    versions on the card (for holding the engine's tokens against its
    kernels), True on a CPU model raises here. `kv_dtype` quantizes the
    page pools; `draft_model` with `spec_k` >= 1 turns on speculative
    decoding (both or neither). `moe_capacity_factor` overrides the MoE
    layers' factor, the target's and the draft's: a step routes every
    slot's row, inactive slots included, and a prefill the prompt padded
    to its bucket, so a drop depends on the whole step, as in the JAX
    engine."""

    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(self, model, *, max_slots=4, page_size=8, num_pages=None,
                 max_ctx=None, dtype=None, steps_per_sync=4, eos_id=None,
                 prompt_buckets=None, queue_limit=128, ttft_deadline_s=None,
                 poll_interval_s=0.01, use_kernel=None,
                 timeline_capacity=256, kv_dtype=None, draft_model=None,
                 spec_k=0, moe_capacity_factor=None):
        if dtype not in serving.DTYPES:
            raise ValueError(f"dtype {dtype!r} not in {serving.DTYPES}")
        serving.kv_label(kv_dtype)
        if (draft_model is None) != (not spec_k):
            raise ValueError("speculative decoding needs BOTH "
                             "draft_model and spec_k >= 1")
        if draft_model is not None and (
                draft_model.vocab_size < model.vocab_size
                or draft_model.device != model.device):
            raise ValueError("the draft must cover the target's vocab and "
                             "live on its device")
        if use_kernel and model.device.type != "cuda":
            raise ValueError(f"use_kernel=True needs a CUDA model, got "
                             f"{model.device}")
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.max_ctx = int(max_ctx if max_ctx is not None else model.max_seq)
        if self.max_ctx > model.max_seq:
            raise ValueError(f"max_ctx {self.max_ctx} exceeds the "
                             f"model's max_seq {model.max_seq}")
        self.dtype = dtype
        self.kv_dtype = kv_dtype
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.eos_id = eos_id
        self.queue_limit = int(queue_limit)
        self.ttft_deadline_s = ttft_deadline_s
        self.poll_interval_s = float(poll_interval_s)
        self.use_kernel = use_kernel
        # S0 is unused on the paged step; T = max_ctx bounds positions
        self.core = serving._decode_core(model, 0, self.max_ctx,
                                         moe_capacity_factor, kv_dtype)
        # speculative decoding: the draft gets its own fp page pools,
        # indexed by the same page table
        self.draft_model = draft_model
        self.spec_k = int(spec_k or 0)
        self.dcore = None if draft_model is None else \
            serving._decode_core(draft_model, 0, self.max_ctx,
                                 moe_capacity_factor)
        self._prefill_x, self._decode_x = _executors(model, draft_model)
        self.max_pages_per_seq = -(-self.max_ctx // self.page_size)
        if num_pages is None:
            num_pages = self.max_slots * self.max_pages_per_seq
        self.num_pages = int(num_pages)
        maxp = self.max_ctx - 1
        if prompt_buckets is None:
            b, prompt_buckets = 16, []
            while b < maxp:
                prompt_buckets.append(b)
                b *= 2
        # the largest bucket covers every admissible prompt
        self.prompt_buckets = sorted(
            {min(int(b), maxp) for b in prompt_buckets} | {maxp})

        # host-side state (touched only under _lock)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: "deque[EngineRequest]" = deque()
        self._slots: "list[EngineRequest | None]" = [None] * self.max_slots
        self._free_pages = list(range(self.num_pages))
        N, M = self.max_slots, self.max_pages_per_seq
        self._tok = np.zeros(N, np.int64)
        self._lens = np.zeros(N, np.int32)
        self._limits = np.zeros(N, np.int32)
        self._active = np.zeros(N, bool)
        self._ptab = np.zeros((N, M), np.int32)
        self._stop = threading.Event()
        self._draining = False
        # requests popped from the queue but not yet seated (prefill runs
        # outside the lock): a graceful drain waits for these too
        self._admitting = 0
        self._thread = None
        # the caller's intra-op thread count at start(), on the CPU only:
        # the pool the running CPU engines split (`_fit_threads`)
        self._thread_pool = 0
        self._pools = None
        self._params = None
        self._dpools = None
        self._draft_params = None
        self._steps = 0
        # speculative-decoding counts, running totals over the syncs
        self._spec = {"drafted": 0, "accepted": 0, "bonus": 0, "rounds": 0}
        self._finished = {o: 0 for o in REQUEST_OUTCOMES}
        # request-level observability (slo), appended under _lock and read
        # through locked copies: finished timelines, sync windows, terminal
        # stamps (rps), TTFTs and queue delays
        self._recent_ttft: "deque[float]" = deque(maxlen=256)
        self._recent_qdelay: "deque[float]" = deque(maxlen=256)
        self._timelines: "deque[dict]" = deque(maxlen=int(timeline_capacity))
        self._sync_ring: "deque[dict]" = deque(maxlen=512)
        self._sync_id = 0
        self._recent_done: "deque[float]" = deque(maxlen=512)

    # -- pools ---------------------------------------------------------------
    def _alloc_pools(self, core, model):
        """One model's page pools: per block (K, V), or quantized
        ((K8, Ks), (V8, Vs)), each (num_pages, Hp, page_size, ·). An int4
        pool holds half an int8 pool's bytes; the scale pools are
        equal."""
        cd = torch.float32 if self.dtype is None else torch.bfloat16
        return [core.new_cache(self.num_pages, self.page_size, cd,
                               self.device)
                for _ in range(len(model.blocks))]

    @staticmethod
    def _bytes(tree) -> int:
        return sum(t.numel() * t.element_size()
                   for t in serving.tree_leaves(tree or ()))

    def _pool_arrays(self):
        """The memory ledger's kv_cache provider: the target's and the
        draft's page pools (draft KV is KV-cache memory like any other)."""
        return serving.tree_leaves([self._pools or (), self._dpools or ()])

    def _draft_param_arrays(self):
        """The memory ledger's params provider for the draft's decode
        parameters (the draft exists only for serving)."""
        p = self._draft_params
        return () if p is None else (
            [v for k, v in p.items() if k != "blocks"]
            + [v for bp in p["blocks"] for v in bp.values()])

    def pool_bytes(self) -> int:
        """Bytes of the target's page pools (scales included); the
        ledger's kv_cache provider adds the draft's."""
        return self._bytes(self._pools)

    def draft_pool_bytes(self) -> int:
        return self._bytes(self._dpools)

    def draft_param_bytes(self) -> int:
        return self._bytes(self._draft_param_arrays())

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingEngine":
        """Allocate the page pools, register them as the memory ledger's
        kv_cache provider, and start the decode thread. Idempotent."""
        with self._lock:
            if self._thread is not None:
                return self
            self._params = serving.decode_state(self.model, self.dtype)
            self._pools = self._alloc_pools(self.core, self.model)
            if self.dcore is not None:
                self._draft_params = serving.decode_state(self.draft_model,
                                                          self.dtype)
                self._dpools = self._alloc_pools(self.dcore,
                                                 self.draft_model)
            self._stop.clear()
            if self.device.type == "cpu":
                self._thread_pool = torch.get_num_threads()
            with ServingEngine._seq_lock:
                ServingEngine._seq += 1
                n = ServingEngine._seq
            self._thread = threading.Thread(
                target=self._loop, name=f"torch-serve-{n}", daemon=True)
        memory.register_provider(memory.REGION_KV_CACHE, self,
                                 self._pool_arrays)
        if self.dcore is not None:
            memory.register_provider(memory.REGION_PARAMS, self,
                                     self._draft_param_arrays)
        with _registry_lock:
            _engines.append(self)
        if observe.is_enabled():
            m = _metrics()
            m["slots"].set(float(self.max_slots))
            m["pages"].set(float(self.num_pages))
            m["pages_in_use"].set(0.0)
            kvl = serving.kv_label(self.kv_dtype)
            assert kvl in KV_DTYPES, self.kv_dtype
            m["kv_pool_bytes"].set(float(self.pool_bytes()), kv_dtype=kvl)
        self._thread.start()
        return self

    def stop(self, drain_outcome: str = OUTCOME_EVICTED, *,
             drain: bool = False, drain_timeout_s: float = 300.0):
        """Stop the decode thread (joined), finish every in-flight and
        queued request as `drain_outcome` (partial tokens kept) and free
        the pools. Idempotent.

        With `drain=True` the stop is graceful: new submissions are
        refused, queued requests not yet admitted are handed back to the
        caller (outcome still None), and the in-flight slots decode to
        completion (bounded by `drain_timeout_s`) before the teardown.
        Returns the handed-back requests (empty unless drain=True)."""
        handed_back: "list[EngineRequest]" = []
        if drain:
            with self._lock:
                if self._thread is not None and not self._stop.is_set():
                    self._draining = True
                    handed_back = list(self._queue)
                    self._queue.clear()
                    self._cond.notify_all()
            for req in handed_back:
                req.mark(PHASE_QUEUE, handed_back=True)
            deadline = time.monotonic() + float(drain_timeout_s)
            while time.monotonic() < deadline:
                with self._lock:
                    busy = (any(r is not None for r in self._slots)
                            or self._admitting > 0)
                    alive = self._thread is not None \
                        and self._thread.is_alive()
                if not busy or not alive:
                    break
                time.sleep(min(self.poll_interval_s, 0.05))
        with self._lock:
            t = self._thread
            self._thread = None
            self._stop.set()
            self._cond.notify_all()
        if t is not None:
            t.join(timeout=60.0)
        with self._lock:
            rest = [r for r in self._slots if r is not None]
            rest += list(self._queue)
            self._queue.clear()
            self._slots = [None] * self.max_slots
            self._active[:] = False
        for req in rest:
            self._finish(req, drain_outcome)
        with self._lock:
            self._free_pages = list(range(self.num_pages))
            self._pools = self._dpools = None
            self._draining = False
        memory.unregister_provider(memory.REGION_KV_CACHE, self)
        memory.unregister_provider(memory.REGION_PARAMS, self)
        with _registry_lock:
            if self in _engines:
                _engines.remove(self)
        if observe.is_enabled():
            m = _metrics()
            m["pages_in_use"].set(0.0)
            m["occupancy"].set(0.0)
            m["queue_depth"].set(0.0)
        return handed_back

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- submission ----------------------------------------------------------
    def submit(self, prompt, max_new, deadline_s=None,
               ttft_deadline_s=None, trace_ctx=None,
               synthetic=False) -> EngineRequest:
        """Enqueue one request: `prompt` a 1-D int sequence, `max_new`
        tokens to generate. Returns the handle at once; a full queue, an
        over-length request or a stopped engine REJECTS it (the handle is
        then already terminal). `trace_ctx` carries a router-minted trace
        id into the request's timeline; `synthetic` marks a probe or a
        warm-up: it rides the same path, flagged in its timeline so that
        `slo` leaves it out of attainment."""
        ids = np.asarray(prompt, np.int32).reshape(-1)
        with ServingEngine._seq_lock:
            ServingEngine._seq += 1
            rid = ServingEngine._seq
        req = EngineRequest(
            rid, ids, max_new, deadline_s,
            self.ttft_deadline_s if ttft_deadline_s is None
            else ttft_deadline_s)
        if trace_ctx is not None:
            req.trace = str(trace_ctx)
        if synthetic:
            req.synthetic = True
        npages = -(-(len(ids) + int(max_new)) // self.page_size)
        reason = None
        if len(ids) < 1 or int(max_new) < 1:
            reason = "prompt and max_new must both be >= 1"
        elif len(ids) + int(max_new) > self.max_ctx:
            reason = (f"prompt {len(ids)} + max_new {int(max_new)} "
                      f"exceeds max_ctx {self.max_ctx}")
        elif npages > self.num_pages:
            reason = (f"request needs {npages} pages, pool holds "
                      f"{self.num_pages}")
        if reason is None:
            with self._lock:
                # the liveness check shares the lock with stop()'s
                # shutdown, so no request lands after the drain
                if self._thread is None or self._stop.is_set() \
                        or not self._thread.is_alive():
                    reason = "engine not running"
                elif self._draining:
                    reason = "engine draining (graceful stop)"
                elif len(self._queue) >= self.queue_limit:
                    reason = f"admission queue full ({self.queue_limit})"
                else:
                    self._queue.append(req)
                    req.mark(PHASE_QUEUE, depth=len(self._queue))
                    self._cond.notify_all()
        if reason is not None:
            req.detail = reason
            self._finish(req, OUTCOME_REJECTED)
        elif observe.is_enabled():
            _metrics()["queue_depth"].set(float(len(self._queue)))
        return req

    def prewarm(self, lens, max_new: int = 2, timeout_s: float = 600.0):
        """Drive one synthetic request through every prefill bucket that
        the prompt lengths in `lens` map to, before real traffic: on the
        card this builds the kernels' libraries and makes the pools' and
        the allocator's first allocations. Returns `(buckets,
        first_token_wall)`: the sorted buckets and the wall-clock time of
        the first token produced. Raises RuntimeError when a bucket's
        request stalls past `timeout_s` or ends without a token."""
        buckets = sorted({self._bucket(int(s)) for s in lens})
        first_token_wall = None
        for b in buckets:
            n = max(1, min(int(b), self.max_ctx - int(max_new)))
            w = self.submit(np.zeros(n, np.int32) + 1, int(max_new),
                            synthetic=True)
            if not w.wait(float(timeout_s)):
                raise RuntimeError(
                    f"prewarm (bucket {b}) stalled after {timeout_s}s")
            if w.outcome != OUTCOME_COMPLETED or w.first_token_ts is None:
                raise RuntimeError(
                    f"prewarm (bucket {b}) failed: {w.outcome} "
                    f"({w.detail})")
            if first_token_wall is None:
                # first_token_ts is on the monotonic clock
                first_token_wall = (float(w.first_token_ts)
                                    + (time.time() - time.monotonic()))
        return buckets, first_token_wall

    # -- terminal bookkeeping ------------------------------------------------
    def _timeline_of(self, req: EngineRequest, outcome: str) -> dict:
        """The ring entry for one terminal request (caller holds _lock):
        its phase-stamped events, the syncs it rode, and the latency
        summary the SLO tracker evaluates."""
        total_s = req.finished_ts - req.submitted
        rate = None
        if outcome == OUTCOME_COMPLETED and req.tokens and total_s > 0:
            rate = len(req.tokens) / total_s
        return {
            "id": req.id,
            "outcome": outcome,
            "trace": req.trace,
            "synthetic": bool(req.synthetic),
            "prompt_tokens": int(len(req.prompt)),
            "new_tokens": len(req.tokens),
            "slot": req.last_slot,
            "queue_delay_s": round(req.admitted - req.submitted, 6)
            if req.admitted else None,
            "ttft_s": round(req.ttft_s, 6)
            if req.ttft_s is not None else None,
            "total_s": round(total_s, 6),
            "tokens_per_sec": round(rate, 3)
            if rate is not None else None,
            "detail": req.detail,
            "events": [(p, round(float(t), 7), info)
                       for p, t, info in list(req.events)],
            "syncs": list(req.syncs),
        }

    def _finish(self, req: EngineRequest, outcome: str):
        if outcome not in REQUEST_OUTCOMES:
            raise ValueError(outcome)
        with self._lock:
            # submit()'s rejects land here on the caller's thread, the
            # rest on the engine's: one gate for both
            if req.outcome is not None:
                return
            req.outcome = outcome
            req.finished_ts = time.monotonic()
            self._finished[outcome] += 1
            req.mark(PHASE_TERMINAL, outcome=outcome)
            self._recent_done.append(req.finished_ts)
            timeline = self._timeline_of(req, outcome)
            self._timelines.append(timeline)
        if observe.is_enabled():
            m = _metrics()
            m["requests"].inc(outcome=outcome)
            total_s = req.finished_ts - req.submitted
            m["request_s"].observe(total_s)
            if outcome == OUTCOME_COMPLETED and req.tokens and total_s > 0:
                m["rate"].set(len(req.tokens) / total_s)
            observe.get_registry().emit({
                "kind": "serve_request", "id": req.id,
                "outcome": outcome,
                "prompt_tokens": int(len(req.prompt)),
                "new_tokens": len(req.tokens),
                "queue_delay_s": round(req.admitted - req.submitted, 6)
                if req.admitted else None,
                "ttft_s": round(req.ttft_s, 6)
                if req.ttft_s is not None else None,
                "total_s": round(total_s, 6),
                "detail": req.detail,
            })
        for cb in tuple(_request_listeners):
            try:
                cb(req, timeline)
            except Exception:
                pass  # a listener must never break the serving path
        req._done.set()

    def _bucket(self, s0: int) -> int:
        for b in self.prompt_buckets:
            if b >= s0:
                return b
        return self.prompt_buckets[-1]

    # -- the decode loop -----------------------------------------------------
    def _evict(self, req: EngineRequest, outcome: str):
        """Free a slot: pages back to the pool, slot state cleared,
        request finished."""
        with self._lock:
            slot = req.slot
            if slot is not None and self._slots[slot] is req:
                self._slots[slot] = None
                self._active[slot] = False
                self._lens[slot] = 0
                self._tok[slot] = 0
                self._ptab[slot, :] = 0
            self._free_pages.extend(req.pages)
            req.pages = []
            req.slot = None
        self._finish(req, outcome)

    def _state(self):
        """The decode params and page pools (the draft's too under spec):
        the executors' leading arguments, as in the JAX engine's
        signatures."""
        if self.dcore is None:
            return self._params, self._pools
        return self._params, self._draft_params, self._pools, self._dpools

    @staticmethod
    def _scatter(core, kvs, pools, pvec, off, true_len):
        """Write one model's per-block prompt K/V rows (n = 1, padded
        bucket) into its pools: the true prompt's rows only."""
        def put(dst, rows):
            dst[pvec, :, off] = rows[0].transpose(0, 1)[:true_len]
        for (k, v), pool in zip(kvs, pools):
            core._store(pool, k, v, 1, k.shape[2], put)

    @torch.no_grad()
    def _prefill(self, prompt, true_len, pages, count_nf):
        """Prefill one request padded to its bucket: write the true
        prompt's K/V rows into its pages (and the draft's, under spec;
        the padded tail writes nothing). Returns the first token and,
        with `count_nf`, the count of non-finite logits, as one (1,) or
        (2,) int64 device tensor (one host read)."""
        core, p, ps = self.core, self._params, self.page_size
        h, kvs = core.prefill_parts(p, prompt, 1, self.use_kernel)
        logits = core.head(p, h[:, true_len - 1])
        t = torch.arange(true_len, device=self.device)
        pvec = pages[t // ps]
        off = t % ps
        self._scatter(core, kvs, self._pools, pvec, off, true_len)
        if self.dcore is not None:
            _, dkvs = self.dcore.prefill_parts(self._draft_params, prompt, 1,
                                               self.use_kernel)
            self._scatter(self.dcore, dkvs, self._dpools, pvec, off,
                          true_len)
        out = [torch.argmax(logits[0])]
        if count_nf:
            out.append((~torch.isfinite(logits)).sum())
        return torch.stack(out)

    @torch.no_grad()
    def _decode(self, tok, ptab, lens, limits, active, count_nf):
        """`steps_per_sync` greedy paged steps; returns the new (tok,
        lens, active), the per-step tokens (steps, N), how many of each
        slot's commit (steps, N) and, with `count_nf`, the count of
        non-finite logits of the active slots, all on the device."""
        core, N = self.core, self.max_slots
        toks, takes = [], []
        nf = torch.zeros((), dtype=torch.long, device=self.device)
        for _ in range(self.steps_per_sync):
            logits, self._pools = core.paged_token_step(
                self._params, tok, self._pools, ptab, lens, active, N,
                self.page_size, use_kernel=self.use_kernel)
            if count_nf:
                nf = nf + ((~torch.isfinite(logits))
                           & active[:, None]).sum()
            nxt = torch.argmax(logits, dim=-1)
            toks.append(nxt[:, None])
            takes.append(active.long())
            new_lens = torch.where(active, lens + 1, lens)
            alive = active & (new_lens < limits)
            if self.eos_id is not None:
                alive = alive & (nxt != self.eos_id)
            tok = torch.where(active, nxt, tok)
            lens, active = new_lens, alive
        return (tok, lens, active, torch.stack(toks), torch.stack(takes),
                nf)

    @torch.no_grad()
    def _decode_spec(self, tok, ptab, lens, limits, active, count_nf):
        """`steps_per_sync` speculative rounds (`serving._spec_round`,
        which the dense decode loop shares): the draft proposes spec_k
        tokens (spec_k + 1 draft steps, per-slot positions), the target
        verifies them in one paged_verify_step (the spec_k + 1 token
        ladder), and each slot commits its longest accepted prefix plus
        the target's own token, cut at its budget and at an eos. Returns
        the new (tok, lens, active), the candidates (rounds, N, spec_k +
        1), the tokens each slot commits (rounds, N), the sync's counts
        (drafted, accepted, bonus) and the count of non-finite committed
        logits, all on the device (`count_nf` is unused: the round counts
        them always)."""
        core, dcore, N, K = self.core, self.dcore, self.max_slots, \
            self.spec_k
        ps, uk = self.page_size, self.use_kernel
        wl = limits + 1                 # the slot's reserved positions
        lens = lens.long()
        toks, takes = [], []
        counts = torch.zeros(3, dtype=torch.long, device=self.device)
        nf = torch.zeros((), dtype=torch.long, device=self.device)
        for _ in range(self.steps_per_sync):
            def draft_step(t, j):
                return dcore.paged_verify_step(
                    self._draft_params, t[:, None], self._dpools, ptab,
                    lens + j, active, N, ps, 1, uk, write_limits=wl)[0][:, 0]

            def verify(feed):
                return core.paged_verify_step(
                    self._params, feed, self._pools, ptab, lens, active, N,
                    ps, K + 1, uk, write_limits=wl)[0]

            g, take, tok, c, ended, n = serving._spec_round(
                draft_step, verify, tok, active, limits.long() - lens, K,
                self.eos_id)
            counts += c
            nf = nf + n
            toks.append(g)
            takes.append(take)
            lens = lens + take
            active = active & (lens < limits) & ~ended
        return (tok, lens, active, torch.stack(toks), torch.stack(takes),
                counts, nf)

    def _admit_one(self, req: EngineRequest, slot: int, pages) -> bool:
        """Prefill `req` into `slot` (pages already allocated). Returns
        False when the request finished at prefill (max_new == 1 or an
        immediate eos)."""
        s0 = len(req.prompt)
        bucket = self._bucket(s0)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :s0] = req.prompt
        # the pages covering the bucket, a fixed length per bucket as in
        # the JAX engine: one prefill build per bucket, not per max_new
        page_arr = np.zeros(-(-bucket // self.page_size), np.int64)
        n_pref = min(len(pages), len(page_arr))
        page_arr[:n_pref] = pages[:n_pref]
        req.admitted = time.monotonic()
        req.last_slot = slot
        req.mark(PHASE_ADMIT, slot=slot, pages=len(pages))
        req.mark(PHASE_PREFILL, bucket=bucket)
        obs = observe.is_enabled()
        key = "serving.engine_spec_prefill" if self.dcore is not None \
            else "serving.engine_prefill"
        with watchdog.guard("decode", stage="engine_prefill"), \
                observe.span("serving.engine_prefill", bucket=bucket,
                             prompt_tokens=s0), memory.on_oom(key):
            got = self._prefill_x(
                self, *self._state(),
                torch.as_tensor(padded, device=self.device), s0,
                torch.as_tensor(page_arr, device=self.device),
                obs).tolist()
        tok0 = got[0]
        req.first_token_ts = time.monotonic()
        req.tokens.append(tok0)
        req.mark(PHASE_FIRST_TOKEN, tokens=1)
        if obs:
            m = _metrics()
            m["admitted"].inc()
            m["prefills"].inc()
            m["tokens"].inc()
            m["queue_delay"].observe(req.admitted - req.submitted)
            m["ttft"].observe(req.first_token_ts - req.submitted)
            health.record_nan_logits(got[1], "engine")
        with self._lock:
            self._recent_ttft.append(req.first_token_ts - req.submitted)
            self._recent_qdelay.append(req.admitted - req.submitted)
        if req.max_new == 1 or (self.eos_id is not None
                                and tok0 == self.eos_id):
            self._evict(req, OUTCOME_COMPLETED)
            return False
        with self._lock:
            self._slots[slot] = req
            req.slot = slot
            self._tok[slot] = tok0
            self._lens[slot] = s0
            # the token produced at cache length L is the
            # (L - S0 + 1)-th generated one: the last lands when the
            # length reaches S0 + max_new - 1
            self._limits[slot] = s0 + req.max_new - 1
            self._active[slot] = True
            self._ptab[slot, :] = 0
            self._ptab[slot, :len(pages)] = pages
        return True

    def _admission_pass(self):
        """Expire queued requests past their TTFT deadline, then admit
        FIFO while a free slot and enough pages exist (head-of-line
        blocking by design: fairness over fragmentation)."""
        now = time.monotonic()
        with self._lock:
            expired = [r for r in self._queue
                       if r.ttft_deadline_s is not None
                       and now - r.submitted > r.ttft_deadline_s]
            for r in expired:
                self._queue.remove(r)
        for r in expired:
            r.detail = (f"submit-to-first-token deadline "
                        f"{r.ttft_deadline_s}s exceeded")
            self._finish(r, OUTCOME_TIMEOUT)
        while True:
            with self._lock:
                if not self._queue or None not in self._slots:
                    break
                slot = self._slots.index(None)
                req = self._queue[0]
                npages = -(-(len(req.prompt) + req.max_new)
                           // self.page_size)
                if len(self._free_pages) < npages:
                    break
                self._queue.popleft()
                req.pages = [self._free_pages.pop() for _ in range(npages)]
                self._admitting += 1
            try:
                self._admit_one(req, slot, req.pages)
            finally:
                with self._lock:
                    self._admitting -= 1
        if observe.is_enabled():
            m = _metrics()
            with self._lock:
                m["queue_depth"].set(float(len(self._queue)))
                m["pages_in_use"].set(
                    float(self.num_pages - len(self._free_pages)))
                m["occupancy"].set(float(np.sum(self._active)))

    def _fit_threads(self):
        """On the CPU, this decode thread's intra-op threads: the pool
        (the count of the thread that started the engine) split over the
        running CPU engines. torch's OpenMP team size is a per-thread
        setting, so each engine thread sets its own; N engine threads at
        the machine's full count oversubscribe its cores, and a sync then
        takes several times as long (ROADMAP, Queue 3, fault 16). Nothing
        on the card."""
        if not self._thread_pool:
            return
        with _registry_lock:
            n = sum(1 for e in _engines if e.device.type == "cpu")
        want = max(1, self._thread_pool // max(n, 1))
        if want != torch.get_num_threads():
            torch.set_num_threads(want)

    def _loop(self):
        try:
            self._loop_body()
        except BaseException as exc:
            # the loop must never die silently: every in-flight and
            # queued request would block its caller forever. Finish them
            # all as evicted, with the error as the detail, and re-raise.
            detail = f"engine decode loop died: {type(exc).__name__}: {exc}"
            self._stop.set()
            with self._lock:
                rest = [r for r in self._slots if r is not None]
                rest += list(self._queue)
                self._queue.clear()
                self._slots = [None] * self.max_slots
                self._active[:] = False
                for r in rest:
                    self._free_pages.extend(r.pages)
                    r.pages = []
                    r.slot = None
            for r in rest:
                r.detail = r.detail or detail
                self._finish(r, OUTCOME_EVICTED)
            observe.get_registry().emit(
                {"kind": "serve", "event": "loop_error", "detail": detail})
            raise
        finally:
            if self._thread_pool:
                # torch.set_num_threads also sets the count that threads
                # started later take: give them the pool back
                torch.set_num_threads(self._thread_pool)

    def _loop_body(self):
        dev = self.device
        while not self._stop.is_set():
            self._fit_threads()
            now = time.monotonic()
            with self._lock:
                overdue = [r for r in self._slots
                           if r is not None and r.deadline_s is not None
                           and now - r.submitted > r.deadline_s]
            for req in overdue:
                req.detail = f"deadline {req.deadline_s}s exceeded"
                self._evict(req, OUTCOME_TIMEOUT)
            self._admission_pass()
            with self._lock:
                if not self._active.any():
                    self._cond.wait(timeout=self.poll_interval_s)
                    continue
                tok = torch.as_tensor(self._tok, device=dev)
                ptab = torch.as_tensor(self._ptab, device=dev)
                lens = torch.as_tensor(self._lens, device=dev)
                limits = torch.as_tensor(self._limits, device=dev)
                active = torch.as_tensor(self._active, device=dev)
                n_active = int(self._active.sum())
                act_before = self._active.copy()
                queued = len(self._queue)
            spec = self.dcore is not None
            obs = observe.is_enabled()
            key = "serving.engine_spec_step" if spec \
                else "serving.engine_step"
            with watchdog.guard("decode", slots=n_active), \
                    observe.span("serving.engine_step", slots=n_active,
                                 steps=self.steps_per_sync, queue=queued), \
                    memory.on_oom(key):
                # the sync's window (the sync ring), inside its span
                sync_t0 = time.perf_counter()
                resilience.fault_point("serving.engine_step",
                                       slots=n_active)
                out = self._decode_x(self, *self._state(), tok, ptab, lens,
                                     limits, active, obs)
                # one host read a sync: tokens, takes, counts, non-finite
                tok_new, lens_new, act_new, toks, takes, *counts, nf = \
                    _host(out)
                sync_dur = time.perf_counter() - sync_t0
            finished = []
            emitted = 0
            with self._lock:
                self._sync_id += 1
                sid = self._sync_id
                if spec:
                    for key, c in zip(("drafted", "accepted", "bonus"),
                                      counts[0]):
                        self._spec[key] += int(c)
                    self._spec["rounds"] += self.steps_per_sync
                for i in range(self.max_slots):
                    req = self._slots[i]
                    if req is None or not act_before[i]:
                        continue
                    # round/step h committed the first takes[h, i] of
                    # its candidates toks[h, i] (prefix order)
                    n_before = len(req.tokens)
                    for th, kh in zip(toks[:, i], takes[:, i]):
                        req.tokens.extend(int(t) for t in th[:kh])
                    emitted += len(req.tokens) - n_before
                    self._lens[i] = lens_new[i]
                    self._active[i] = act_new[i]
                    self._tok[i] = tok_new[i]
                    # the sync on the request's timeline: the trace's
                    # flow link and the tokens so far
                    req.mark(PHASE_DECODE, tokens=len(req.tokens), sync=sid)
                    req.syncs.append(sid)
                    if not act_new[i]:
                        finished.append(req)
                self._sync_ring.append({
                    "sync": sid, "t0": round(sync_t0, 7),
                    "dur": round(sync_dur, 7),
                    "tid": threading.get_ident(), "slots": n_active,
                    "steps": self.steps_per_sync, "tokens": emitted})
                self._steps += self.steps_per_sync
            for req in finished:
                self._evict(req, OUTCOME_COMPLETED)
            if spec:
                dr, ac, bo = (int(c) for c in counts[0])
                if dr or bo:
                    serving.record_spec(dr, ac, bo, self.steps_per_sync)
            if obs:
                m = _metrics()
                m["steps"].inc(self.steps_per_sync)
                if emitted:
                    m["tokens"].inc(emitted)
                health.record_nan_logits(int(nf), "engine")
                with self._lock:
                    m["occupancy"].set(float(np.sum(self._active)))
                    m["pages_in_use"].set(
                        float(self.num_pages - len(self._free_pages)))

    # -- reporting -----------------------------------------------------------
    def timelines(self) -> "list[dict]":
        """Locked copy of the finished-request timeline ring, oldest
        first."""
        with self._lock:
            return list(self._timelines)

    def active_timelines(self) -> "list[dict]":
        """Timeline-shaped dicts of the in-flight requests (queued and
        slotted): outcome None, no terminal event."""
        with self._lock:
            live = [r for r in self._slots if r is not None]
            live.extend(self._queue)
        out = []
        for req in live:
            if req.outcome is not None:
                continue  # finished while we copied
            out.append({
                "id": req.id,
                "outcome": None,
                "trace": req.trace,
                "prompt_tokens": int(len(req.prompt)),
                "new_tokens": len(req.tokens),
                "slot": req.last_slot,
                "ttft_s": round(req.ttft_s, 6)
                if req.ttft_s is not None else None,
                "detail": req.detail,
                "events": [(p, round(float(t), 7), info)
                           for p, t, info in list(req.events)],
                "syncs": list(req.syncs),
            })
        return out

    def sync_records(self) -> "list[dict]":
        """Locked copy of the sync ring: {sync, t0, dur, tid, slots,
        steps, tokens} per decode sync."""
        with self._lock:
            return list(self._sync_ring)

    def recent_ttfts(self) -> "list[float]":
        with self._lock:
            return list(self._recent_ttft)

    def rps(self, window_s: float = 10.0) -> float:
        """Terminal requests per second over the trailing window (over
        the span the stamp ring covers, when it is full and younger than
        the window)."""
        now = time.monotonic()
        with self._lock:
            n = sum(1 for t in self._recent_done if now - t <= window_s)
            full = len(self._recent_done) == self._recent_done.maxlen
            oldest = self._recent_done[0] if self._recent_done else None
        span = window_s
        if full and oldest is not None and now - oldest < window_s:
            span = max(now - oldest, 1e-6)
        return n / span

    def decode_tok_s(self, window_s: float = 10.0) -> "float | None":
        """Decoded tokens per second over the trailing window of the sync
        ring; None before a sync lands in the window."""
        now = time.perf_counter()
        with self._lock:
            recs = [r for r in self._sync_ring if now - r["t0"] <= window_s]
        if not recs:
            return None
        span = min(window_s, max(now - recs[0]["t0"], 1e-6))
        return sum(r["tokens"] for r in recs) / span

    def report(self) -> dict:
        with self._lock:
            active = int(self._active.sum())
            qd = len(self._queue)
            free = len(self._free_pages)
            spec = dict(self._spec)
            finished = dict(self._finished)
        ttfts = self.recent_ttfts()
        tok_s = self.decode_tok_s()
        return {
            "running": self.running(),
            "slots": self.max_slots,
            "active": active,
            "queue_depth": qd,
            "pages_total": self.num_pages,
            "pages_in_use": self.num_pages - free,
            "page_size": self.page_size,
            "pool_bytes": self.pool_bytes(),
            "steps": self._steps,
            "rps": round(self.rps(), 3),
            "decode_tok_s": round(tok_s, 3) if tok_s is not None else None,
            "finished": finished,
            "ttft_p50_s": pctile(ttfts, 0.5),
            "ttft_p99_s": pctile(ttfts, 0.99),
            "kv_dtype": self.kv_dtype,
            "max_ctx": self.max_ctx,
            "spec_k": self.spec_k or None,
            "spec": spec,
            "spec_acceptance": (spec["accepted"] / spec["drafted"]
                                if spec["drafted"] else None),
            "draft_params_bytes": self.draft_param_bytes(),
            "draft_pool_bytes": self.draft_pool_bytes(),
        }


def _host(tensors) -> list:
    """The tensors as host numpy arrays through one device-to-host copy
    (flattened and concatenated as int64; every output of a sync is an
    integer or a flag)."""
    flat = torch.cat([t.reshape(-1).long() for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].reshape(tuple(t.shape)))
        at += n
    return out


# ---- module registry ---------------------------------------------------------

_engines: "list[ServingEngine]" = []
_registry_lock = threading.Lock()

# Terminal-request listeners: `cb(req, timeline)` fires once per request
# reaching a terminal outcome (on whichever thread finished it), after the
# engine's bookkeeping and before the handle's done-event is set.
_request_listeners: list = []


def add_request_listener(cb):
    """Register `cb(req, timeline)` on every terminal request. Its
    exceptions are swallowed: a listener never breaks serving."""
    _request_listeners.append(cb)
    return cb


def remove_request_listener(cb):
    """Unregister (an equality match)."""
    _request_listeners[:] = [c for c in _request_listeners if c != cb]


def request_listeners() -> list:
    """The registered terminal-request listeners."""
    return list(_request_listeners)


def clear_request_listeners():
    """Drop every listener."""
    _request_listeners.clear()


def get_engines() -> "list[ServingEngine]":
    return list(_engines)


def reset():
    """Stop every live engine (threads joined, queues drained as
    "evicted", pools freed)."""
    for e in get_engines():
        e.stop()


def serving_report() -> str:
    """The `== serving ==` status section: the installed router's rows
    (`router.serving_lines`), then per engine the slot occupancy,
    page-pool use, queue depth and outcome counts."""
    lines = ["== serving =="]

    def _router_rows():
        # a routing coordinator often holds no engine of its own (the
        # engines live in replica processes): its rows stand alone
        try:
            from . import router
            return router.serving_lines()
        except Exception:
            return []

    engines = get_engines()
    if not engines:
        rows = _router_rows()
        if rows:
            lines.extend(rows)
        else:
            lines.append(
                "no ServingEngine running "
                "(singa_tpu_torch.engine.ServingEngine(model).start())")
        return "\n".join(lines)
    lines.extend(_router_rows())
    for i, e in enumerate(engines):
        r = e.report()
        lines.append(
            f"engine {i}: slots {r['active']}/{r['slots']} active, "
            f"pages {r['pages_in_use']}/{r['pages_total']} "
            f"(x{r['page_size']} tok, {r['pool_bytes'] / 1e6:.2f} MB), "
            f"queue {r['queue_depth']}, steps {r['steps']}"
            + (f", kv {r['kv_dtype']}" if r["kv_dtype"] else ""))
        fin = r["finished"]
        lines.append("  requests: " + ", ".join(
            f"{o} {fin.get(o, 0)}" for o in REQUEST_OUTCOMES))
        if r["ttft_p50_s"] is not None:
            lines.append(
                f"  ttft p50 {r['ttft_p50_s'] * 1e3:.1f} ms"
                + (f", p99 {r['ttft_p99_s'] * 1e3:.1f} ms"
                   if r["ttft_p99_s"] is not None else "")
                + f", rps {r['rps']:.2f}")
        else:
            lines.append("  ttft: no data (0 admitted requests)")
        if r["spec_k"]:
            sp = r["spec"]
            if sp["drafted"]:
                acc = r["spec_acceptance"]
                lines.append(
                    f"  spec acceptance {acc * 100.0:.1f}% "
                    f"(k={r['spec_k']}, drafted {sp['drafted']}, "
                    f"accepted {sp['accepted']}, bonus {sp['bonus']}, "
                    f"wasted {sp['drafted'] - sp['accepted']})")
                lines.append(
                    f"  spec draft overhead: params "
                    f"{r['draft_params_bytes'] / 1e6:.2f} MB, kv pool "
                    f"{r['draft_pool_bytes'] / 1e6:.2f} MB, "
                    f"{(1.0 - acc) * 100.0:.1f}% of drafted tokens "
                    "wasted")
            else:
                lines.append(
                    f"  spec acceptance: no data (0 verify rounds, "
                    f"k={r['spec_k']})")
        else:
            lines.append("  spec: off (no draft model)")
    return "\n".join(lines)


__all__ = ["REQUEST_OUTCOMES", "KV_DTYPES", "ServingEngine", "EngineRequest",
           "pctile", "get_engines", "reset", "serving_report",
           "add_request_listener", "remove_request_listener",
           "request_listeners", "clear_request_listeners"]
