"""Overlap (counterpart of singa_tpu/overlap.py): batches moved to the
card ahead of use, and checkpoints written while training goes on.

- `DevicePrefetcher` / `prefetch_to_device(it, model, size)`: a
  background thread pulls batches from any iterator and moves up to
  `size` of them to the model's device ahead of use: each array leaf is
  pinned and copied with `non_blocking=True` on a side CUDA stream, and
  an event recorded after the copies; `__next__` makes the consumer's
  current stream wait on that event (and records the batch's tensors as
  used on that stream, for the caching allocator), so the copy of batch
  k+1 overlaps step k and the step never reads a half-copied batch.
  Order is preserved; static (non-array) arguments pass through
  untouched; a source error is re-raised to the consumer, and a producer
  that died without posting its end marker is detected instead of
  waited for. `Model.fit(..., prefetch_to_device=N)` wraps each epoch in
  one and closes it on every exit path.

- Async checkpoints: `start_async_save(path, write)` runs `write()` (the
  file writes of a checkpoint whose device-to-host snapshot the caller
  has already taken) on a thread. `wait_for_checkpoints()` is the
  barrier: it waits for every pending write and re-raises the first
  failure. `Model.save_checkpoint` and `load_checkpoint` call it first,
  and it runs at interpreter exit, so a failed write is reported late
  but never lost. `write_failed(path)` remembers a failure after the
  barrier that raised it, until a new write to that path starts.

Threads are daemons named `torch-prefetch-<n>` and `torch-ckpt-<n>`.
Telemetry, as the JAX package's: the consumer's ring wait is the span
`data.wait` (the producer thread runs under `observe.suppress_spans`),
`observe.record_prefetch` books the ring's depth, the consumer's blocked
time and the batches moved, `observe.record_ckpt_async` the pending
saves and the caller's blocking time, and the barrier is the span
`checkpoint.wait`. Fault points (`resilience`): "data.next" before each
ring wait, "ckpt.wait" (ctx: path) before each pending write is awaited.
The ring wait runs under the watchdog's `data_wait` deadline and the
barrier under `ckpt_wait`; the ring's batches are the memory ledger's
`prefetch_ring` region from construction to `close()`.
`overlap_report()` is /statusz's `== overlap ==` section, in the JAX
package's form.
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from . import device as device_module
from . import memory, observe, resilience, watchdog
from .tensor import Tensor

_END = object()          # ring marker: the source is exhausted
_ids = itertools.count()


def _torch_device(dev) -> torch.device:
    if isinstance(dev, device_module.Device):
        return dev.torch_device
    return torch.device(dev)


class DevicePrefetcher:
    """Bounded background transfer ring over a batch iterator.

    `it` yields per-batch tuples or lists (or single values) of
    `tensor.Tensor`s, torch tensors or numpy arrays, and static
    arguments. Each array leaf comes back on the device: a Tensor as a
    Tensor, a torch tensor as a torch tensor, a numpy array as a Tensor
    (as the JAX package's prefetcher wraps it). Single use; `close()` is
    idempotent, joins the producer, and runs by itself at the source's
    end, on a source error and on leaving a `with` block.

    Under data parallelism (a DistOpt over a process group) each rank's
    prefetcher moves the FULL batch to the rank's device, and the step
    takes the rank's rows; the JAX package's prefetcher puts the batch
    sharded over the mesh (`_dist_shardings`), which has no counterpart
    here."""

    def __init__(self, it, model=None, size=2, device=None):
        if model is None and device is None:
            raise ValueError("DevicePrefetcher needs a model (for its "
                             "device) or an explicit device")
        if device is None:
            device = getattr(model, "_device", None)
            if device is None:
                raise ValueError("model has no device yet: call "
                                 "Model.compile first, or pass device=")
        self._td = _torch_device(device)
        self._dev = device_module.of(self._td)
        self._src = iter(it)
        self.size = max(1, int(size))
        self._ring = deque()
        self._cond = threading.Condition()
        self._stop = False
        self._err = None
        self._closed = False
        self._stream = torch.cuda.Stream(self._td) \
            if self._td.type == "cuda" else None
        self._thread = threading.Thread(
            target=self._produce, name=f"torch-prefetch-{next(_ids)}",
            daemon=True)
        # the memory ledger's birth site: the batches parked in the ring
        memory.track_prefetcher(self)
        self._thread.start()

    # -- producer side ---------------------------------------------------
    def _move_leaf(self, x, moved):
        if isinstance(x, Tensor):
            t, wrap = x.data, True
        elif torch.is_tensor(x):
            t, wrap = x, False
        elif isinstance(x, np.ndarray):
            t, wrap = torch.from_numpy(x), True
        else:
            return x   # a static argument
        if t.device != self._td:
            if self._stream is not None and t.device.type == "cpu":
                t = t.pin_memory().to(self._td, non_blocking=True)
            else:
                t = t.to(self._td)
        moved.append(t)
        if not wrap:
            return t
        return Tensor._wrap(t, self._dev,
                            x.requires_grad if isinstance(x, Tensor)
                            else False)

    def _move(self, batch):
        """(batch on the device, its tensors, the copies' event)."""
        moved = []
        ctx = torch.cuda.stream(self._stream) if self._stream is not None \
            else contextlib.nullcontext()
        with ctx:
            if isinstance(batch, (tuple, list)):
                out = type(batch)(self._move_leaf(v, moved) for v in batch)
            else:
                out = self._move_leaf(batch, moved)
            ev = None
            if self._stream is not None:
                ev = torch.cuda.Event()
                ev.record(self._stream)
        return out, moved, ev

    def _produce(self):
        # the source's own spans (a loader's data.wait) must not fire on
        # this thread: only the consumer's ring wait is a data stall
        with observe.suppress_spans():
            self._produce_loop()

    def _produce_loop(self):
        try:
            while True:
                with self._cond:
                    while len(self._ring) >= self.size and not self._stop:
                        self._cond.wait(0.2)
                    if self._stop:
                        return
                try:
                    batch = next(self._src)
                except StopIteration:
                    return
                item = self._move(batch)
                with self._cond:
                    if self._stop:
                        return
                    self._ring.append(item)
                    observe.record_prefetch(depth=len(self._ring),
                                            produced=True)
                    self._cond.notify_all()
        except BaseException as e:  # noqa: BLE001  relayed to the consumer
            self._err = e
        finally:
            with self._cond:
                self._ring.append(_END)
                self._cond.notify_all()

    # -- consumer side ---------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        # the ring wait is the host's data stall (nested under fit's own
        # data.wait span)
        with observe.span("data.wait"), watchdog.guard("data_wait"):
            resilience.fault_point("data.next")
            item, depth, err = self._take()
        if item is _END:
            self.close()
            if err is not None:
                raise err
            raise StopIteration
        observe.record_prefetch(depth=depth,
                                blocked_s=time.perf_counter() - t0)
        out, moved, ev = item
        if ev is not None:
            stream = torch.cuda.current_stream(self._td)
            stream.wait_event(ev)
            for t in moved:
                t.record_stream(stream)
        return out

    def _take(self):
        """The ring's next item (waiting for one) -> (item, depth after,
        the producer's error when the item is the end marker)."""
        depth = err = None
        with self._cond:
            while not self._ring:
                if self._closed:
                    raise StopIteration
                t = self._thread
                if not t.is_alive():
                    # checked under the ring's lock: an end marker posted
                    # before the thread ended would be in the ring
                    raise RuntimeError(
                        f"prefetch producer thread {t.name!r} died without "
                        "posting its end marker; the ring will never fill")
                self._cond.wait(0.2)
            item = self._ring[0]
            if item is _END:
                err, self._err = self._err, None   # raise it once
            else:
                self._ring.popleft()
                depth = len(self._ring)
                self._cond.notify_all()
        return item, depth, err

    def close(self, timeout: float = 5.0):
        """Stop the producer and join it (a producer inside the source's
        next() finishes that fetch first)."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._stop = True
            self._cond.notify_all()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=timeout)
        with self._cond:
            self._ring.clear()
            observe.record_prefetch(depth=0)
        memory.untrack(memory.REGION_PREFETCH_RING, self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def prefetch_to_device(it, model, size: int = 2, device=None):
    """A started `DevicePrefetcher` over `it` for `model`'s device; use it
    as a context manager so an abandoned iteration joins its thread."""
    return DevicePrefetcher(it, model=model, size=size, device=device)


# ---- async checkpoints ------------------------------------------------------

_ckpt_lock = threading.Lock()
_pending: "list[_PendingSave]" = []
_failed_paths: "set[str]" = set()
_atexit_installed = False


class _PendingSave:
    """One write in flight: its thread and, once it ended, its error."""

    def __init__(self, path, write):
        self.path = path
        self.error = None
        self._write = write
        self.thread = threading.Thread(
            target=self._run, name=f"torch-ckpt-{next(_ids)}", daemon=True)

    def _run(self):
        try:
            self._write()
        except BaseException as e:  # noqa: BLE001  re-raised at the barrier
            self.error = e

    def wait(self):
        self.thread.join()
        if self.error is not None:
            raise self.error


def _atexit_barrier():
    try:
        wait_for_checkpoints()
    except BaseException:
        import traceback
        traceback.print_exc()   # with the cause, which atexit's own
        raise                   # report would leave out


def pending_checkpoints() -> int:
    """Async writes started and not yet waited for."""
    with _ckpt_lock:
        return len(_pending)


def write_failed(path: str) -> bool:
    """True when an async write to `path` failed at a past barrier (kept
    until a new write to the path starts)."""
    with _ckpt_lock:
        return os.path.abspath(path) in _failed_paths


def clear_write_failed(path: str):
    """Forget a recorded failure for `path`."""
    with _ckpt_lock:
        _failed_paths.discard(os.path.abspath(path))


def wait_for_checkpoints():
    """Barrier: wait for every pending async write; re-raise the first
    failure (after waiting for the others) as a RuntimeError whose cause
    is the write's own error."""
    with _ckpt_lock:
        entries = list(_pending)
        del _pending[:]
    if not entries:
        return
    errors = []
    # the ckpt_wait deadline arms over the whole barrier
    with observe.span("checkpoint.wait"), watchdog.guard("ckpt_wait"):
        for e in entries:
            try:
                try:
                    resilience.fault_point("ckpt.wait", path=e.path)
                finally:
                    # a fault injected here fails the entry, but its
                    # writer still ends before the barrier returns: a
                    # later save of the path must not race it
                    e.thread.join()
                e.wait()
            except BaseException as err:  # noqa: BLE001  re-raised below
                errors.append((e, err))
    observe.record_ckpt_async(pending_checkpoints())
    if errors:
        with _ckpt_lock:
            _failed_paths.update(os.path.abspath(e.path) for e, _ in errors)
        e, err = errors[0]
        raise RuntimeError(
            f"async checkpoint write to {e.path} failed ({len(errors)} of "
            f"{len(entries)} pending save(s) failed)") from err


def start_async_save(path: str, write, blocking_s=None) -> None:
    """Run `write()` on a thread as the async write of the checkpoint at
    `path`; `wait_for_checkpoints()` waits for it. The caller has taken
    the device-to-host snapshot that `write` writes, in `blocking_s`
    seconds (booked by `observe.record_ckpt_async`)."""
    global _atexit_installed
    clear_write_failed(path)
    entry = _PendingSave(path, write)
    with _ckpt_lock:
        _pending.append(entry)
        n = len(_pending)
        if not _atexit_installed:
            _atexit_installed = True
            atexit.register(_atexit_barrier)
    observe.record_ckpt_async(n, blocking_s=blocking_s)
    entry.thread.start()


def async_available() -> bool:
    """True: the port's async save is its own thread writer
    (`start_async_save`), which needs nothing an installation could lack
    (the JAX package's answers whether its orbax can build an async
    checkpointer). A pure probe: it starts nothing."""
    return True


# ---- /statusz section ------------------------------------------------------

def overlap_report() -> str:
    """Text block for /statusz: prefetch ring + async-ckpt state."""
    reg = observe.get_registry()
    lines = ["== overlap =="]
    depth = reg.get("singa_prefetch_ring_depth")
    moved = reg.get("singa_prefetch_batches_total")
    blocked = reg.get("singa_prefetch_blocked_seconds")
    if moved is None and depth is None:
        lines.append("prefetch: not in use")
    else:
        lines.append(
            f"prefetch: ring_depth={int(depth.value()) if depth else 0} "
            f"batches_moved={int(moved.value()) if moved else 0} "
            f"consumer_blocked_s="
            f"{blocked.sum() if blocked else 0.0:.3f}")
    started = reg.get("singa_checkpoint_async_total")
    blk = reg.get("singa_checkpoint_async_blocking_seconds")
    lines.append(
        f"async-ckpt: pending={pending_checkpoints()} "
        f"started={int(started.value()) if started else 0} "
        f"blocking_s_sum={blk.sum() if blk else 0.0:.3f} "
        f"(available={async_available()})")
    return "\n".join(lines)


__all__ = ["DevicePrefetcher", "async_available", "clear_write_failed",
           "overlap_report", "pending_checkpoints", "prefetch_to_device",
           "start_async_save", "wait_for_checkpoints", "write_failed"]
