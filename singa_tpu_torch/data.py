"""Data loading (counterpart of singa_tpu/data.py).

`ImageBatchIter` keeps SINGA's API (start/next/end) and its worker
process, which fills a bounded queue with (images NCHW fp32, labels).
`NumpyBatchIter` yields shuffled mini-batches of in-memory arrays, built
ahead of use by a bounded background thread; with the same seed it
yields the JAX package's batches in the same order (both shuffle with
`np.random.RandomState(seed)`). Batches are host numpy arrays: moving
them to the card is `overlap.DevicePrefetcher`'s work
(`Model.fit(..., prefetch_to_device=N)`). Each batch's wait is the span
`data.wait` under the watchdog's `data_wait` deadline, and passes the
fault point "data.next" (`resilience`) first.
"""

from __future__ import annotations

import os
import queue as _queue
import random
import threading
from multiprocessing import Event, Process, Queue

import numpy as np

from . import observe, resilience, watchdog


class ImageBatchIter:
    """Iterate an image-list file, yielding (images NCHW fp32, labels).

    `img_list_file` lines are "<path><delimiter><meta>";
    `image_transform(full_path)` returns a list of augmented PIL images
    (or arrays). Integer metas come back as an int32 array, others as
    the raw strings."""

    def __init__(self, img_list_file, batch_size, image_transform,
                 shuffle=True, delimiter=' ', image_folder=None, capacity=10):
        self.img_list_file = img_list_file
        self.queue = Queue(capacity)
        self.batch_size = batch_size
        self.image_transform = image_transform
        self.shuffle = shuffle
        self.delimiter = delimiter
        self.image_folder = image_folder
        self.stop_flag = Event()   # shared with the worker process
        self.p = None
        with open(img_list_file, 'r') as fd:
            self.num_samples = len(fd.readlines())
        if self.num_samples < batch_size:
            # the worker could never assemble a batch and next() would
            # wait on an empty queue for ever
            raise ValueError(
                f"batch_size {batch_size} exceeds the {self.num_samples} "
                f"sample(s) in {img_list_file}")

    def start(self):
        if self.p is not None and self.p.is_alive():
            self.end()   # two workers would interleave into one queue
        self.stop_flag.clear()
        while not self.queue.empty():
            try:
                self.queue.get_nowait()
            except _queue.Empty:
                break
        self.p = Process(target=self.run, daemon=True)
        self.p.start()

    def __next__(self):
        assert self.p is not None, 'call start before next'
        if self.stop_flag.is_set():
            raise StopIteration   # end() was called
        with observe.span("data.wait"), watchdog.guard("data_wait"):
            resilience.fault_point("data.next")
            return self._get()

    def _get(self):
        while True:
            try:
                return self.queue.get(timeout=0.2)
            except _queue.Empty:
                if self.p.is_alive():
                    continue
                # the worker's feeder may still be flushing its last batch
                try:
                    return self.queue.get(timeout=0.2)
                except _queue.Empty:
                    if self.stop_flag.is_set():
                        raise StopIteration from None
                    raise RuntimeError(
                        f"ImageBatchIter worker process died (exitcode "
                        f"{self.p.exitcode}) with the queue empty; see its "
                        "traceback on stderr") from None

    next = __next__

    def __iter__(self):
        return self

    def end(self):
        if self.p is not None:
            self.stop_flag.set()
            # drain so a worker blocked on put() can finish
            while not self.queue.empty():
                self.queue.get_nowait()
            self.p.join(timeout=1.0)
            if self.p.is_alive():
                # joined, so start() never runs a second worker beside a
                # dying one (the JAX package returns after terminate())
                self.p.terminate()
                self.p.join(timeout=5.0)
                if self.p.is_alive():
                    self.p.kill()
                    self.p.join()

    def run(self):
        samples = []
        with open(self.img_list_file, 'r') as fd:
            for line in fd:
                path, meta = line.strip().split(self.delimiter, 1)
                samples.append((path, meta))
        while not self.stop_flag.is_set():
            if self.shuffle:
                random.shuffle(samples)
            i = 0
            while i + self.batch_size <= len(samples) \
                    and not self.stop_flag.is_set():
                xs, ys = [], []
                for path, meta in samples[i:i + self.batch_size]:
                    full = os.path.join(self.image_folder, path) \
                        if self.image_folder else path
                    for img in self.image_transform(full):
                        arr = np.asarray(img, dtype=np.float32)
                        if arr.ndim == 2:
                            arr = arr[:, :, None]
                        xs.append(arr.transpose(2, 0, 1))
                        ys.append(meta)
                x = np.stack(xs)
                try:
                    y = np.asarray([int(v) for v in ys], np.int32)
                except ValueError:
                    y = ys
                self.queue.put((x, y))
                i += self.batch_size


class NumpyBatchIter:
    """Shuffled mini-batches over in-memory arrays, built ahead of use by
    a bounded background thread (`prefetch` batches deep). Each
    iteration is one epoch with a fresh order from the iterator's
    RandomState."""

    def __init__(self, x, y, batch_size, transform=None, shuffle=True,
                 seed=0, drop_last=True, prefetch=2):
        assert len(x) == len(y)
        self.x, self.y = x, y
        self.bs = batch_size
        self.transform = transform
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.prefetch = max(1, int(prefetch))
        self.num_batches = len(x) // batch_size if drop_last \
            else -(-len(x) // batch_size)
        self._producer = None   # (thread, condition, stop flag) of the
                                # last epoch, reaped on re-iteration

    def __len__(self):
        return self.num_batches

    def _stop_producer(self, timeout=2.0):
        """Stop and join the previous epoch's producer if the consumer
        abandoned it without closing the generator."""
        if self._producer is None:
            return
        t, lock, stop = self._producer
        with lock:
            stop[0] = True
            lock.notify_all()
        t.join(timeout=timeout)

    def _make(self, order, b):
        sel = order[b * self.bs:(b + 1) * self.bs]
        xb = self.x[sel]
        if self.transform is not None:
            xb = self.transform(xb)
        return xb, self.y[sel]

    def __iter__(self):
        self._stop_producer()
        order = np.arange(len(self.x))
        if self.shuffle:
            self.rng.shuffle(order)
        ready = {}
        lock = threading.Condition()
        stop = [False]   # set when the consumer abandons the epoch

        def producer():
            for b in range(self.num_batches):
                if stop[0]:
                    return
                batch = self._make(order, b)
                with lock:
                    while (len(ready) >= self.prefetch) and not stop[0]:
                        lock.wait()
                    if stop[0]:
                        return
                    ready[b] = batch
                    lock.notify_all()

        t = threading.Thread(target=producer, name="torch-data-producer",
                             daemon=True)
        self._producer = (t, lock, stop)
        t.start()
        try:
            for b in range(self.num_batches):
                with observe.span("data.wait"), \
                        watchdog.guard("data_wait"):
                    resilience.fault_point("data.next")
                    with lock:
                        while b not in ready:
                            # a transform that raised killed the thread
                            # without a notify: do not wait for ever
                            if not t.is_alive():
                                raise RuntimeError(
                                    "NumpyBatchIter producer thread died "
                                    f"before batch {b}: the transform "
                                    "raised; see its traceback on stderr")
                            lock.wait(timeout=0.2)
                        batch = ready.pop(b)
                        lock.notify_all()
                yield batch
        finally:
            with lock:
                stop[0] = True
                lock.notify_all()
            t.join(timeout=1.0)


__all__ = ["ImageBatchIter", "NumpyBatchIter"]
