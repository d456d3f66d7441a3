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
plain greedy decoding's. The engine runs on its model's device. The JAX
engine's links to the operations layers (observe, slo, watchdog, memory,
introspect, resilience) and its `prewarm` are not ported yet.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from . import serving

#: every terminal state a request can reach
REQUEST_OUTCOMES = ("completed", "evicted", "rejected", "timeout")
OUTCOME_COMPLETED = "completed"
OUTCOME_EVICTED = "evicted"
OUTCOME_REJECTED = "rejected"
OUTCOME_TIMEOUT = "timeout"
#: seconds the idle decode loop waits for a submission before it checks
#: deadlines and the stop flag again
_POLL_S = 0.01


class EngineRequest:
    """Handle for one submitted request. `wait()`/`result()` block until
    the request reaches a terminal outcome; `tokens` holds what was
    generated (partial on eviction or timeout), `outcome` one of
    REQUEST_OUTCOMES."""

    def __init__(self, rid, prompt, max_new, deadline_s, ttft_deadline_s):
        self.id = rid
        self.prompt = prompt
        self.max_new = int(max_new)
        self.deadline_s = deadline_s
        self.ttft_deadline_s = ttft_deadline_s
        self.submitted = time.monotonic()
        self.first_token_ts = None
        self.outcome = None
        self.tokens: "list[int]" = []
        self.slot = None
        self.pages: "list[int]" = []
        self.detail = None
        self._done = threading.Event()

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


class ServingEngine:
    """The request-level continuous-batching engine over one model.

    `max_slots` bounds in-flight sequences; `page_size` tokens per KV
    page; `num_pages` the pool size (default: every slot at `max_ctx`);
    `steps_per_sync` decode steps per host sync (the admission/eviction
    cadence); `eos_id` stops a sequence early; `ttft_deadline_s` bounds
    submit-to-first-token (queued requests past it finish "timeout");
    `prompt_buckets` the padded prompt lengths of prefill (default 16,
    32, ... up to max_ctx - 1). `use_kernel` goes to every attention op
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
                 use_kernel=None, kv_dtype=None, draft_model=None,
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
        self._pools = None
        self._params = None
        self._dpools = None
        self._draft_params = None
        self._steps = 0
        # speculative-decoding counts, running totals over the syncs
        self._spec = {"drafted": 0, "accepted": 0, "bonus": 0, "rounds": 0}
        self._finished = {o: 0 for o in REQUEST_OUTCOMES}

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

    def pool_bytes(self) -> int:
        """Bytes of the target's page pools (scales included)."""
        return self._bytes(self._pools)

    def draft_pool_bytes(self) -> int:
        return self._bytes(self._dpools)

    def draft_param_bytes(self) -> int:
        p = self._draft_params
        if p is None:
            return 0
        return self._bytes([v for k, v in p.items() if k != "blocks"]
                           + [v for bp in p["blocks"] for v in bp.values()])

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingEngine":
        """Allocate the page pools and start the decode thread.
        Idempotent."""
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
            with ServingEngine._seq_lock:
                ServingEngine._seq += 1
                n = ServingEngine._seq
            self._thread = threading.Thread(
                target=self._loop, name=f"torch-serve-{n}", daemon=True)
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
            deadline = time.monotonic() + float(drain_timeout_s)
            while time.monotonic() < deadline:
                with self._lock:
                    busy = (any(r is not None for r in self._slots)
                            or self._admitting > 0)
                    alive = self._thread is not None \
                        and self._thread.is_alive()
                if not busy or not alive:
                    break
                time.sleep(_POLL_S)
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
        return handed_back

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- submission ----------------------------------------------------------
    def submit(self, prompt, max_new, deadline_s=None,
               ttft_deadline_s=None) -> EngineRequest:
        """Enqueue one request: `prompt` a 1-D int sequence, `max_new`
        tokens to generate. Returns the handle at once; a full queue, an
        over-length request or a stopped engine REJECTS it (the handle is
        then already terminal)."""
        ids = np.asarray(prompt, np.int32).reshape(-1)
        with ServingEngine._seq_lock:
            ServingEngine._seq += 1
            rid = ServingEngine._seq
        req = EngineRequest(
            rid, ids, max_new, deadline_s,
            self.ttft_deadline_s if ttft_deadline_s is None
            else ttft_deadline_s)
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
                    self._cond.notify_all()
        if reason is not None:
            req.detail = reason
            self._finish(req, OUTCOME_REJECTED)
        return req

    # -- terminal bookkeeping ------------------------------------------------
    def _finish(self, req: EngineRequest, outcome: str):
        if outcome not in REQUEST_OUTCOMES:
            raise ValueError(outcome)
        with self._lock:
            if req.outcome is not None:
                return
            req.outcome = outcome
            self._finished[outcome] += 1
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

    @staticmethod
    def _scatter(core, kvs, pools, pvec, off, true_len):
        """Write one model's per-block prompt K/V rows (n = 1, padded
        bucket) into its pools: the true prompt's rows only."""
        def put(dst, rows):
            dst[pvec, :, off] = rows[0].transpose(0, 1)[:true_len]
        for (k, v), pool in zip(kvs, pools):
            core._store(pool, k, v, 1, k.shape[2], put)

    @torch.no_grad()
    def _prefill(self, prompt, true_len, pages):
        """Prefill one request padded to its bucket: write the true
        prompt's K/V rows into its pages (and the draft's, under spec;
        the padded tail writes nothing) and return the first token."""
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
        return int(torch.argmax(logits[0]))

    @torch.no_grad()
    def _decode(self, tok, ptab, lens, limits, active):
        """`steps_per_sync` greedy paged steps; returns the new (tok,
        lens, active) and the per-step tokens (steps, N) and how many of
        each slot's commit (steps, N), all on the device."""
        core, N = self.core, self.max_slots
        toks, takes = [], []
        for _ in range(self.steps_per_sync):
            logits, self._pools = core.paged_token_step(
                self._params, tok, self._pools, ptab, lens, active, N,
                self.page_size, use_kernel=self.use_kernel)
            nxt = torch.argmax(logits, dim=-1)
            toks.append(nxt[:, None])
            takes.append(active.long())
            new_lens = torch.where(active, lens + 1, lens)
            alive = active & (new_lens < limits)
            if self.eos_id is not None:
                alive = alive & (nxt != self.eos_id)
            tok = torch.where(active, nxt, tok)
            lens, active = new_lens, alive
        return tok, lens, active, torch.stack(toks), torch.stack(takes)

    @torch.no_grad()
    def _decode_spec(self, tok, ptab, lens, limits, active):
        """`steps_per_sync` speculative rounds (`serving._spec_round`,
        which the dense decode loop shares): the draft proposes spec_k
        tokens (spec_k + 1 draft steps, per-slot positions), the target
        verifies them in one paged_verify_step (the spec_k + 1 token
        ladder), and each slot commits its longest accepted prefix plus
        the target's own token, cut at its budget and at an eos. Returns
        the new (tok, lens, active), the candidates (rounds, N, spec_k +
        1), the tokens each slot commits (rounds, N) and the sync's
        counts (drafted, accepted, bonus), all on the device."""
        core, dcore, N, K = self.core, self.dcore, self.max_slots, \
            self.spec_k
        ps, uk = self.page_size, self.use_kernel
        wl = limits + 1                 # the slot's reserved positions
        lens = lens.long()
        toks, takes = [], []
        counts = torch.zeros(3, dtype=torch.long, device=self.device)
        for _ in range(self.steps_per_sync):
            def draft_step(t, j):
                return dcore.paged_verify_step(
                    self._draft_params, t[:, None], self._dpools, ptab,
                    lens + j, active, N, ps, 1, uk, write_limits=wl)[0][:, 0]

            def verify(feed):
                return core.paged_verify_step(
                    self._params, feed, self._pools, ptab, lens, active, N,
                    ps, K + 1, uk, write_limits=wl)[0]

            g, take, tok, c, ended = serving._spec_round(
                draft_step, verify, tok, active, limits.long() - lens, K,
                self.eos_id)
            counts += c
            toks.append(g)
            takes.append(take)
            lens = lens + take
            active = active & (lens < limits) & ~ended
        return (tok, lens, active, torch.stack(toks), torch.stack(takes),
                counts)

    def _admit_one(self, req: EngineRequest, slot: int, pages) -> bool:
        """Prefill `req` into `slot` (pages already allocated). Returns
        False when the request finished at prefill (max_new == 1 or an
        immediate eos)."""
        s0 = len(req.prompt)
        bucket = self._bucket(s0)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :s0] = req.prompt
        tok0 = self._prefill(
            torch.as_tensor(padded, device=self.device), s0,
            torch.as_tensor(pages, dtype=torch.long, device=self.device))
        req.first_token_ts = time.monotonic()
        req.tokens.append(tok0)
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
            raise

    def _loop_body(self):
        dev = self.device
        while not self._stop.is_set():
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
                    self._cond.wait(timeout=_POLL_S)
                    continue
                tok = torch.as_tensor(self._tok, device=dev)
                ptab = torch.as_tensor(self._ptab, device=dev)
                lens = torch.as_tensor(self._lens, device=dev)
                limits = torch.as_tensor(self._limits, device=dev)
                active = torch.as_tensor(self._active, device=dev)
            spec = self.dcore is not None
            out = (self._decode_spec if spec else self._decode)(
                tok, ptab, lens, limits, active)
            # one host read a sync: tokens, takes and counts
            tok_new, lens_new, act_new, toks, takes, *counts = (
                t.cpu().numpy() for t in out)
            act_before = active.cpu().numpy()
            finished = []
            with self._lock:
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
                    for th, kh in zip(toks[:, i], takes[:, i]):
                        req.tokens.extend(int(t) for t in th[:kh])
                    self._lens[i] = lens_new[i]
                    self._active[i] = act_new[i]
                    self._tok[i] = tok_new[i]
                    if not act_new[i]:
                        finished.append(req)
                self._steps += self.steps_per_sync
            for req in finished:
                self._evict(req, OUTCOME_COMPLETED)

    # -- reporting -----------------------------------------------------------
    def report(self) -> dict:
        with self._lock:
            spec = dict(self._spec)
            return {
                "running": self.running(),
                "slots": self.max_slots,
                "active": int(self._active.sum()),
                "queue_depth": len(self._queue),
                "pages_total": self.num_pages,
                "pages_in_use": self.num_pages - len(self._free_pages),
                "page_size": self.page_size,
                "pool_bytes": self.pool_bytes(),
                "steps": self._steps,
                "finished": dict(self._finished),
                "kv_dtype": self.kv_dtype,
                "spec_k": self.spec_k or None,
                "spec": spec,
                "spec_acceptance": (spec["accepted"] / spec["drafted"]
                                    if spec["drafted"] else None),
                "draft_params_bytes": self.draft_param_bytes(),
                "draft_pool_bytes": self.draft_pool_bytes(),
            }


__all__ = ["EngineRequest", "REQUEST_OUTCOMES", "ServingEngine"]
