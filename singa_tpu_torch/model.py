"""The Model API (counterpart of singa_tpu/model.py): `compile`,
`train_one_batch` through `__call__`, train/eval, the buffered graph,
`fit`, `save_states`/`load_states` in the JAX package's format, and
resumable training checkpoints.

A `Model` is a `layer.Layer`. `compile` runs one forward on the example
inputs with no graph recorded (`autograd.training` off), which creates
the parameters of the layers that defer their init, and only then sets
up the optimizer, as the JAX package's compile does.

The buffered graph (SINGA's `ModelMeta.buffer_operation`, the JAX
package's jitted step): every subclass's `train_one_batch` is wrapped
(`ModelMeta`), so `m(x, y)` and `m.train_one_batch(x, y)` both go
through it. In graph mode (`compile(use_graph=True)`), on CUDA and not
`sequential`, each input signature (every tensor's shape, dtype and
device, `autograd.training`, the compute dtype) is a CUDA graph of the
whole step, forward, backward and the optimizer's update:

- the first call runs eagerly on a side stream and is the real first
  step: it builds the kernel libraries, creates optimizer states made at
  first use, and lets cuBLAS and cuDNN pick their algorithms;
- the second copies the inputs into static buffers, captures the step
  once (capture records without running, so no update is lost or done
  twice) with the device's generator registered, then replays it;
- every later call copies its inputs into the buffers and replays.

Every state the step updates is updated in place (parameters, optimizer
slots and its step counter, batch norm's running statistics), so the
replays accumulate it; the outputs come back as fresh tensors, so a loss
kept from step k still reads step k's value after step k+1. All of a
model's graphs share one memory pool. A kernel launched inside a graph
counts in `ops.attention.LAUNCHES` once per replay. A non-tensor argument
that differs from the first call's raises. A failed capture raises:
nothing falls back to eager on the card. On the CPU, where CUDA graphs do
not exist, graph mode runs the same step function with the same
bookkeeping and no capture. `graph_backend` says which ran: "cuda_graph"
or "eager". In eval mode under graph mode the forward is buffered the
same way, per power-of-two batch bucket (`compile(eval_buckets=...)`).

Checkpoints: `save_states` writes a zip of `tensor_dict.npz` and
`states_attr.json` keyed by the JAX package's state names (`conv1.W`,
`TransformerBlock_<i>.attn.Wq`, ...), so each package loads the other's.
`save_checkpoint` writes `ckpt_dir/step_N/` (that zip, the optimizer's
states, the device generator's state and `meta.json`), asynchronously by
default (`overlap`); `load_checkpoint` resumes from it. The JAX package
writes its checkpoints with orbax, which the port cannot read or write.

Telemetry (`observe`), with the JAX package's span and metric names. A
graph-mode training call runs inside the span `model.step` (tag: the
optimizer's `step_tag()`), whether it runs eagerly (the CPU, a new
signature's warm-up) or replays a graph, and then books
`observe.record_step` (dispatch wall seconds, the device's memory
gauges). A new signature's first call runs inside `model.build` (its
warm-up, and the capture at its second call), and books
`record_step_build` and `record_compile` (the batch class, the state
bytes a step updates in place). At `Device.SetVerbosity(1)` and above,
each graph-mode step past the device's `skip_iteration` is fenced (a
synchronize after the call; never inside a capture), its wall time
appended to `Device.step_times` and booked by `record_step_fenced`. The
eager path (`use_graph=False`) books none of these, as in the JAX
package; the optimizer's own hooks fire there. Other spans:
`model.eval`, `model.fit_epoch`, `data.wait`, `checkpoint.save`,
`checkpoint.load`; `record_checkpoint_bytes` after a save.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import shutil
import time
import zipfile

import numpy as np
import torch
from torch import nn

from . import _ckpt, autograd, layer, observe, overlap
from . import device as device_module
from .ops import attention as _attention
from .tensor import Tensor, _raw

#: what compile(health=...) and set_health_monitor raise with
_HEALTH_LATER = ("the health monitor comes with the operations layers, a "
                 "later slice of the port (ROADMAP.md Queue 1)")


def _is_tensor(x) -> bool:
    return isinstance(x, Tensor) or torch.is_tensor(x)


def _same_static(a, b) -> bool:
    if a is b:
        return True
    if _is_tensor(a) or _is_tensor(b) or type(a) is not type(b):
        return False
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and a.dtype == b.dtype \
            and bool(np.array_equal(a, b))
    try:
        return bool(a == b)
    except (TypeError, ValueError):
        return False


def _map_out(out, fn):
    """`out` with `fn` applied to every tensor leaf: a Tensor's data (the
    result wrapped on the Tensor's device) or a raw tensor."""
    if isinstance(out, Tensor):
        return Tensor._wrap(fn(out.data), out.device)
    if torch.is_tensor(out):
        return fn(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_map_out(o, fn) for o in out)
    if isinstance(out, dict):
        return {k: _map_out(v, fn) for k, v in out.items()}
    return out


def _leaves(out) -> list:
    """The raw tensors of `out`, in order."""
    got = []
    _map_out(out, lambda t: got.append(t) or t)
    return got


def _detached(out):
    """`out` cut from the step's autograd graph, as a jitted step's
    outputs are: no tape (`creator`) and no grad_fn keeps the spent
    graph, and the parameters' gradient accumulators with it, alive."""
    return _map_out(out, lambda t: t.detach())


def _fresh(out):
    return _map_out(out, lambda t: t.detach().clone())


class _Buffered:
    """One buffered signature: calls so far, and once captured its CUDA
    graph, static input buffers, static outputs and launch counts."""

    __slots__ = ("calls", "graph", "inputs", "out", "launches")

    def __init__(self):
        self.calls = 0
        self.graph = None
        self.inputs = None
        self.out = None
        self.launches = None


def _buffer_operation(func):
    """Route a subclass's `train_one_batch` through the buffered step in
    graph mode (SINGA's ModelMeta.buffer_operation)."""

    @functools.wraps(func)
    def train_one_batch(self, *args, **kwargs):
        if self._device is None:
            raise RuntimeError("call Model.compile([inputs], ...) before "
                               "training")
        prev = autograd.compute_dtype
        autograd.compute_dtype = self.amp
        try:
            if not (self.graph_mode and self.training):
                return func(self, *args, **kwargs)
            return self._train_step(func, args, kwargs)
        finally:
            autograd.compute_dtype = prev

    train_one_batch._singa_buffered = True
    return train_one_batch


class ModelMeta(layer.LayerMeta):
    """The Model classes' metaclass (SINGA's ModelMeta): it routes each
    class's own `train_one_batch` through the buffered step
    (`buffer_operation`), so `m(x, y)` and `m.train_one_batch(x, y)`
    both take it."""

    buffer_operation = staticmethod(_buffer_operation)

    def __new__(mcs, name, bases, attrs):
        fn = attrs.get("train_one_batch")
        if fn is not None and not getattr(fn, "_singa_buffered", False):
            attrs["train_one_batch"] = _buffer_operation(fn)
        return super().__new__(mcs, name, bases, attrs)


class Model(layer.Layer, metaclass=ModelMeta):
    """Base user model: subclass, define `forward` and (optionally)
    `train_one_batch`. A new model is in eval mode until
    `compile(is_train=True)`; `m(x)` in eval mode runs `forward` with no
    autograd graph, `m(x, y)` in train mode runs `train_one_batch`. Both
    take `tensor.Tensor`s or raw tensors."""

    def __init__(self, name=None):
        super().__init__(name)
        self._optimizer = None
        self._device = None
        self.graph_mode = False
        self.sequential = False
        self.amp = None
        self.eval_buckets = "auto"
        #: "cuda_graph" or "eager": how the last graph-mode call ran
        self.graph_backend = None
        self._train_steps = {}   # signature -> _Buffered
        self._eval_steps = {}
        self._static_args = None
        self._build_count = 0        # train signatures built
        self._graph_steps = 0        # graph-mode training calls
        self._eval_trace_count = 0   # eval signatures built
        self._eval_per_sample = None
        self._eval_probed_nbs = set()
        self._graph_pool = None
        self._side_stream = None
        nn.Module.train(self, False)

    # ---- configuration ----------------------------------------------------
    def set_optimizer(self, opt):
        self._optimizer = opt

    def set_health_monitor(self, monitor):
        raise NotImplementedError(_HEALTH_LATER)

    @property
    def optimizer(self):
        return self._optimizer

    def graph(self, mode=True, sequential=False):
        """Turn graph mode on or off (`sequential=True` runs the buffered
        steps eagerly, for debugging); a change of either flag drops the
        graphs built so far."""
        if mode == self.graph_mode and sequential == self.sequential:
            return
        self.graph_mode = mode
        self.sequential = sequential
        self._train_steps = {}
        self._eval_steps = {}

    def compile(self, inputs, is_train=True, use_graph=False,
                sequential=False, amp=None, eval_buckets="auto",
                health=None):
        """Set the device, the graph flags and the amp dtype ("bfloat16":
        fp32 master weights, bf16 compute at the layers' cast points);
        create the deferred parameters with one forward on `inputs`, no
        graph recorded; set train or eval mode; set up the optimizer's
        state in the JAX package's parameter order.

        The device is the inputs' while some layer still defers its
        parameters: the model moves there (parameters drawn at
        construction included) before that forward. A model whose every
        parameter exists (the GPT, built with a device) keeps its
        parameters' device and moves its inputs there at each call.

        eval_buckets: in graph mode, pad an eval batch to the next power
        of two so varying batch sizes share O(log B) graphs. Sound only
        when every output is per-sample: "auto" (the default) probes the
        first call of each batch size (out(x[:h]) against out(x)[:h])
        and buckets later calls only if every output passed; True forces
        it (an output that is not per-sample raises); False buckets
        nothing. `health` must be None (the health monitor comes with the
        operations layers)."""
        if health is not None:
            raise NotImplementedError(_HEALTH_LATER)
        if not inputs:
            raise ValueError("compile needs the example inputs")
        deferred = self._deferred()
        p = next(self.parameters(), None)
        if deferred or p is None:
            self._device = _input_device(inputs[0])
            self.to(self._device)
        else:
            self._device = p.device
        self.graph(use_graph, sequential)
        if amp in ("bf16", True):
            amp = "bfloat16"
        if amp not in (None, "bfloat16"):
            raise ValueError(f"amp={amp!r}; the port takes None or "
                             "'bfloat16'")
        self.amp = amp
        self.eval_buckets = eval_buckets
        if deferred:
            prev = autograd.training
            autograd.training = False   # the init pass builds no graph
            try:
                with torch.no_grad():
                    self.forward(*inputs)
            finally:
                autograd.training = prev
        self.train(is_train)
        if self._optimizer is not None:
            self._optimizer.setup(self._raw_params().values())

    def train(self, mode: bool = True):
        """nn.Module's recursive mode switch, which also sets the global
        `autograd.training`, as the JAX package's Model.train does."""
        super().train(mode)
        autograd.training = bool(mode)
        return self

    def eval(self):
        return self.train(False)

    # ---- the call ---------------------------------------------------------
    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def train_one_batch(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        prev = autograd.compute_dtype
        autograd.compute_dtype = self.amp
        try:
            if self.training:
                if self._optimizer is None or self._device is None:
                    raise RuntimeError(
                        "call set_optimizer(...) and compile([inputs], "
                        "is_train=True) before training")
                return self.train_one_batch(*args, **kwargs)
            with torch.no_grad():
                if self.graph_mode and self._device is not None \
                        and args and not kwargs \
                        and all(_is_tensor(a) for a in args):
                    with observe.span("model.eval"):
                        return self._eval_step(args)
                return super().__call__(*args, **kwargs)
        finally:
            autograd.compute_dtype = prev

    # ---- the buffered steps -------------------------------------------------
    def _static_mismatch(self, statics):
        raise ValueError(
            f"graph mode compiled with static args {self._static_args}, "
            f"got {statics}; non-Tensor arguments cannot change between "
            "calls (recompile by resetting the model, or run with "
            "use_graph=False)")

    def _signature(self, vals) -> tuple:
        return (tuple((tuple(v.shape), v.dtype, v.device)
                      for v in map(_raw, vals) if torch.is_tensor(v)),
                autograd.training, autograd.compute_dtype)

    def _train_step(self, func, args, kwargs):
        """One graph-mode training step (see the module's docstring)."""
        names = list(range(len(args))) + sorted(kwargs)
        vals = list(args) + [kwargs[k] for k in sorted(kwargs)]
        statics = {n: v for n, v in zip(names, vals) if not _is_tensor(v)}
        tensor_at = tuple(n for n, v in zip(names, vals) if _is_tensor(v))
        if self._static_args is None:
            self._static_args, self._tensor_at = statics, tensor_at
        elif tensor_at != self._tensor_at \
                or statics.keys() != self._static_args.keys() \
                or not all(_same_static(statics[k], v)
                           for k, v in self._static_args.items()):
            self._static_mismatch(statics)
        n_pos = len(args)

        def call(vs):
            kw = dict(zip(names[n_pos:], vs[n_pos:]))
            return func(self, *vs[:n_pos], **kw)

        key = self._signature(vals)
        entry = self._train_steps.get(key)
        raws = [_raw(v) for v in vals if _is_tensor(v)]
        bs = raws[0].shape[0] if raws and raws[0].dim() > 0 else None
        if entry is None:
            entry = self._train_steps[key] = _Buffered()
            self._build_count += 1
            observe.record_compile(
                bs, recompile=len(self._train_steps) > 1,
                donated_bytes=self._step_state_bytes())
        tag = self._optimizer.step_tag() \
            if self._optimizer is not None else 0
        dev = device_module.of(self._device)
        profiling = dev.verbosity > 0 \
            and self._graph_steps >= dev.skip_iteration
        first = entry.calls == 0
        t0 = time.perf_counter()
        with observe.span("model.step", tag=tag):
            out = self._run_buffered(entry, call, vals)
            if profiling:
                # after the call returns: a capture has ended by then
                dev.Sync()
                fenced = time.perf_counter() - t0
                dev.step_times.append(fenced)
                observe.record_step_fenced(fenced)
        seconds = time.perf_counter() - t0
        self._graph_steps += 1
        if first:
            observe.record_step_build(seconds)
        observe.record_step(seconds, batch=bs, tag=tag, device=dev)
        return out

    def _step_state_bytes(self) -> int:
        """Bytes of what a training step updates in place: parameters,
        buffers and the optimizer's states."""
        ts = list(self._raw_states().values())
        if self._optimizer is not None:
            ts += self._optimizer.state_arrays()
        return sum(t.numel() * t.element_size() for t in ts)

    def _eval_forward(self, vs):
        prev = autograd.training
        autograd.training = False
        try:
            return nn.Module.__call__(self, *vs)
        finally:
            autograd.training = prev

    def _eval_run(self, vals):
        key = ("eval",) + self._signature(vals)
        entry = self._eval_steps.get(key)
        if entry is None:
            entry = self._eval_steps[key] = _Buffered()
            self._eval_trace_count += 1
        return self._run_buffered(entry, self._eval_forward, vals)

    def _eval_step(self, args):
        """Graph-mode eval with batch buckets (the JAX package's
        `_eval_step`): pad to the bucket, run, slice the padding off;
        under "auto" probe each new batch size's outputs for being
        per-sample."""
        raws = [_raw(a) for a in args]
        nb = raws[0].shape[0] if raws[0].dim() > 0 else None
        mode = self.eval_buckets
        enabled = mode is True or (mode == "auto"
                                   and self._eval_per_sample is True)
        vals, bucket = list(args), None
        if enabled and nb and all(r.dim() > 0 and r.shape[0] == nb
                                  for r in raws):
            bucket = 1 << (nb - 1).bit_length()
            if bucket != nb:
                vals = [_map_out(a, lambda t: torch.cat(
                    [t, t.new_zeros((bucket - nb,) + tuple(t.shape[1:]))]))
                    for a in args]
            else:
                bucket = None
        out = self._eval_run(vals)
        if bucket is not None:
            for o in _leaves(out):
                if o.dim() == 0 or o.shape[0] != bucket:
                    raise ValueError(
                        f"eval_buckets requires per-sample outputs; got "
                        f"shape {tuple(o.shape)} with batch bucket {bucket} "
                        "(compile with eval_buckets=False to build a graph "
                        "per shape instead)")
            return _map_out(out, lambda t: t[:nb])
        if mode == "auto" and nb is not None \
                and self._eval_per_sample is not False \
                and nb not in self._eval_probed_nbs:
            outs = _leaves(out)
            shaped = all(o.dim() > 0 and o.shape[0] == nb for o in outs)
            ok = False
            if shaped and nb > 1:
                h = nb // 2
                half = _leaves(self._eval_run(
                    [_map_out(a, lambda t: t[:h]) for a in args]))
                # an output whose half-batch run is shaped otherwise (a
                # time-major input, batch on axis 1) is not per-sample:
                # shapes first, then values
                ok = len(half) == len(outs) and all(
                    tuple(a.shape) == (h,) + tuple(b.shape[1:])
                    and torch.allclose(a.float(), b[:h].float(), rtol=1e-5,
                                       atol=1e-6)
                    for a, b in zip(half, outs))
            self._eval_probed_nbs.add(nb)
            self._eval_per_sample = shaped and ok
        return out

    def _run_buffered(self, entry, fn, vals):
        """fn(vals) as a buffered step: on CUDA (not sequential) eager on
        a side stream at the first call, captured at the second, replayed
        after; on the CPU, or sequential, eagerly every time."""
        dev = torch.device(self._device)
        entry.calls += 1
        if dev.type != "cuda" or self.sequential:
            self.graph_backend = "eager"
            with observe.span("model.build") if entry.calls == 1 \
                    else contextlib.nullcontext():
                return _detached(fn(vals))
        self.graph_backend = "cuda_graph"
        cur = torch.cuda.current_stream(dev)
        if entry.calls == 1:
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(dev)
            side = self._side_stream
            side.wait_stream(cur)
            with observe.span("model.build"), torch.cuda.stream(side):
                out = _detached(fn(vals))
            cur.wait_stream(side)
            return out
        if entry.graph is None:
            self._capture(entry, fn, vals, dev)
        for buf, v in zip(entry.inputs, (v for v in vals if _is_tensor(v))):
            buf.copy_(_raw(v), non_blocking=True)
        entry.graph.replay()
        _attention.add_launches(entry.launches)
        return _fresh(entry.out)

    def _capture(self, entry, fn, vals, dev):
        """Capture fn on static copies of the inputs (on the model's
        device) into a CUDA graph in the model's pool, with the device's
        generator registered; the kernels' launch counts of the capture
        are kept for the replays."""
        statics, bufs = [], []
        for v in vals:
            if not _is_tensor(v):
                statics.append(v)
                continue
            r = _raw(v)
            buf = torch.empty(r.shape, dtype=r.dtype, device=dev)
            buf.copy_(r)
            bufs.append(buf)
            statics.append(Tensor._wrap(buf, device_module.of(dev),
                                        v.requires_grad)
                           if isinstance(v, Tensor) else buf)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(device_module.of(dev).generator)
        before = _attention.launch_counts()
        with observe.span("model.build"):
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  capture_error_mode="thread_local"):
                out = fn(statics)
        entry.launches = _attention.launches_since(before)
        entry.graph, entry.inputs, entry.out = graph, bufs, _detached(out)

    def _reset_steps(self):
        """Drop the training graphs and the recorded static arguments (a
        load replaces the states the steps were built on, as the JAX
        package drops its compiled step)."""
        self._train_steps = {}
        self._static_args = None

    # ---- the training loop --------------------------------------------------
    def fit(self, data, epochs=1, verbose=0, prefetch_to_device=0):
        """Train over `data`, an iterable of per-batch argument tuples for
        `train_one_batch`, re-iterated each epoch (a list or a dataset,
        not a one-shot generator). Returns the per-epoch mean losses: the
        step's second output, or its only one. The losses stay on the
        device until the epoch ends, then come back in one transfer.

        prefetch_to_device=N wraps each epoch in an
        `overlap.DevicePrefetcher`, which moves up to N batches to the
        model's device ahead of use; it is closed on every exit path."""
        history = []
        end = object()
        for epoch in range(epochs):
            losses = []
            with observe.span("model.fit_epoch", epoch=epoch):
                it = iter(data)
                prefetcher = None
                if prefetch_to_device:
                    it = prefetcher = overlap.DevicePrefetcher(
                        it, model=self, size=int(prefetch_to_device))
                try:
                    while True:
                        with observe.span("data.wait"):
                            batch = next(it, end)
                        if batch is end:
                            break
                        if not isinstance(batch, (tuple, list)):
                            batch = (batch,)
                        out = self(*batch)
                        loss = out[1] if isinstance(out, (tuple, list)) \
                            and len(out) > 1 else out
                        if _is_tensor(loss):
                            losses.append(_raw(loss).detach())
                finally:
                    if prefetcher is not None:
                        prefetcher.close()
            if not losses:
                raise ValueError(
                    f"fit epoch {epoch} saw no batches - `data` must be "
                    "re-iterable across epochs (a list, not a generator)")
            vals = torch.stack([v.float().reshape(()) for v in losses]) \
                .cpu().tolist()
            mean = sum(vals) / len(vals)
            history.append(mean)
            if verbose:
                print(f"epoch {epoch}: loss {mean:.6f} ({len(vals)} steps)")
        return history

    # ---- checkpoints --------------------------------------------------------
    def _host_states(self, aux_states=None) -> dict:
        """numpy copies of the states (device to host), `aux.<key>` for
        the aux states."""
        states = {k: t.detach().cpu().numpy()
                  for k, t in self._raw_states().items()}
        for k, v in (aux_states or {}).items():
            v = _raw(v)
            states[f"aux.{k}"] = np.asarray(
                v.detach().cpu().numpy() if torch.is_tensor(v) else v)
        return states

    def save_states(self, fpath: str, aux_states: dict | None = None):
        """zip(tensor_dict.npz + states_attr.json) under the JAX names;
        `aux_states` go in as `aux.<key>`."""
        states = self._host_states(aux_states)
        with observe.span("checkpoint.save"):
            _write_states_zip(fpath, states)
        observe.record_checkpoint_bytes(
            sum(int(v.nbytes) for v in states.values()))

    def load_states(self, fpath: str) -> dict:
        """Load a save_states zip (either package's); returns the aux
        states, without their `aux.` prefix."""
        with observe.span("checkpoint.load"):
            loaded = _read_states_zip(fpath)
            self.set_states({k: v for k, v in loaded.items()
                             if not k.startswith("aux.")})
        self._reset_steps()
        return {k[len("aux."):]: v for k, v in loaded.items()
                if k.startswith("aux.")}

    def _rng_device(self) -> device_module.Device:
        if self._device is None:
            raise RuntimeError("compile the model before checkpointing")
        return device_module.of(self._device)

    def save_checkpoint(self, ckpt_dir: str, step: int = 0,
                        overwrite: bool = False, async_save: bool = True):
        """Write a resumable training checkpoint to `ckpt_dir/step_N`:
        `model.zip` (the save_states format), `opt.npz` (the optimizer's
        `get_states()`, the JAX package's keys), `rng.npy` (the device
        generator's state) and `meta.json`. Training resumed from it
        matches uninterrupted training.

        An existing step_N with a `step_N.manifest.json` beside it (a
        complete checkpoint) raises unless `overwrite=True`, which also
        removes that now stale manifest; one without a manifest (a save
        cut short) is set aside as `step_N.reclaimed`. The files are
        written to `step_N.partial-<pid>` and renamed into place.

        async_save=True returns once the device-to-host snapshot is
        taken; a thread writes the files, durable after
        `overlap.wait_for_checkpoints()`, which the next save,
        `load_checkpoint` and interpreter exit call. Returns the path."""
        overlap.wait_for_checkpoints()
        path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
        if os.path.isdir(path):
            if overwrite:
                try:
                    os.remove(_ckpt.manifest_path(path))
                except OSError:
                    pass
            elif _ckpt.is_complete_checkpoint(path):
                raise ValueError(f"checkpoint {path} exists and is complete "
                                 "(pass overwrite=True to replace it)")
            else:
                _ckpt.set_aside_checkpoint(path, ".reclaimed")
        t0 = time.perf_counter()
        with observe.span("checkpoint.save"):
            states = self._host_states()
            opt_states = self._optimizer.get_states() \
                if self._optimizer is not None else {}
            rng = self._rng_device().rng_state.numpy()
        nbytes = sum(int(v.nbytes) for v in (*states.values(),
                                              *opt_states.values(), rng))
        meta = {"format": "singa_tpu_torch.checkpoint", "version": 1,
                "step": int(step), "model": type(self).__name__,
                "files": ["model.zip", "opt.npz", "rng.npy"]}

        def write():
            tmp = f"{path}.partial-{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            _write_states_zip(os.path.join(tmp, "model.zip"), states)
            np.savez(os.path.join(tmp, "opt.npz"), **opt_states)
            np.save(os.path.join(tmp, "rng.npy"), rng)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f, indent=1)
            if os.path.isdir(path):
                shutil.rmtree(path)   # overwrite=True
            os.replace(tmp, path)

        if async_save:
            overlap.start_async_save(path, write,
                                     blocking_s=time.perf_counter() - t0)
        else:
            with observe.span("checkpoint.save"):
                write()
            overlap.clear_write_failed(path)
        observe.record_checkpoint_bytes(nbytes)
        return path

    def load_checkpoint(self, path: str):
        """Restore a `save_checkpoint` directory (a .../step_N path) into
        this compiled model, its optimizer and the device generator, in
        place; waits for pending async saves first."""
        overlap.wait_for_checkpoints()
        if not os.path.isfile(os.path.join(path, "meta.json")):
            raise FileNotFoundError(f"no checkpoint at {path} (meta.json "
                                    "missing)")
        with observe.span("checkpoint.load"):
            self.set_states(_read_states_zip(os.path.join(path,
                                                          "model.zip")))
            if self._optimizer is not None:
                self._optimizer.setup(self._raw_params().values())
                with np.load(os.path.join(path, "opt.npz")) as z:
                    self._optimizer.set_states({k: z[k] for k in z.files})
        self._rng_device().rng_state = torch.from_numpy(
            np.load(os.path.join(path, "rng.npy")))
        self._reset_steps()
        return self


def _write_states_zip(fpath, states: dict):
    attrs = {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
             for k, v in states.items()}
    buf = io.BytesIO()
    np.savez(buf, **states)
    with zipfile.ZipFile(fpath, "w") as zf:
        zf.writestr("tensor_dict.npz", buf.getvalue())
        zf.writestr("states_attr.json", json.dumps(attrs))


def _read_states_zip(fpath) -> dict:
    with zipfile.ZipFile(fpath, "r") as zf:
        raw = zf.read("tensor_dict.npz")
    with np.load(io.BytesIO(raw)) as npz:
        return {k: npz[k] for k in npz.files}


def _input_device(x) -> torch.device:
    """Where an example input lives: a Tensor's Device, a raw tensor's
    device, else (numpy) the default device."""
    if isinstance(x, Tensor):
        return x.device.torch_device
    if torch.is_tensor(x):
        return x.device
    return device_module.resolve(None)


__all__ = ["Model", "ModelMeta"]
