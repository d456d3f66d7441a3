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

Run-time accounting: the watchdog's `step` guard arms over the
`model.step` span (its fence is the health monitor's stats read), the
`data_wait` guard over `fit`'s fetch and the `ckpt_save` guard over a
checkpoint's blocking part (`watchdog`); a graph-mode step that the
health monitor skipped is booked as `health_skip` (`goodput`); the
first call of a training signature registers the model's parameters and
retained inputs with the memory ledger, and an out-of-memory error in a
training step, eager or graph-mode, writes the OOM bundle (`memory`).

Data parallelism (`opt.DistOpt` whose mesh carries a process group, at
any size; one process per rank): the graph-mode step takes the rank's
rows of every batched input (the JAX package's `P(axis)`), returns the
0-d outputs averaged over the ranks and the batched ones gathered along
axis 0, averages the buffers (batch norm's running statistics) over the
ranks after the step, and, at the model's first such build, broadcasts
rank 0's parameters, buffers and optimizer slots (the ranks then start
equal, as DistributedDataParallel makes them). The collectives are
`torch.distributed` calls on the step's stream: the warm-up issues them
eagerly first (NCCL makes its communicator there, never inside a
capture) and a CUDA graph records and replays them. DistOpt's partial
strategy builds one step per tag (the tag is part of the key). A
multi-rank DistOpt in eager mode raises: its step exists only in graph
mode, as in the JAX package, where `psum` has no bound axis outside the
shard_mapped step. Over more than one rank each step draws from the
rank's own random stream, made from the shared one and the rank (the JAX
package's `fold_in(rng, rank)`; `_dp_stream`), so dropout masks differ
across the ranks. Checkpoints: every rank calls `save_checkpoint` and
`load_checkpoint`; rank 0 writes, the others wait for it and raise where
it raises.

Tensor parallelism (a parameter with a `spec` from a `tp_axis` layer, on
a DistOpt mesh that has the spec's axis): the step body binds the mesh,
so the layers run their tp collectives (inside the CUDA graph on the
card); at the first data-parallel build, after the broadcast, each such
parameter and its optimizer slots are cut to the rank's block
(`_shard`), and the model keeps their placements. `get_params`,
`get_states`, `save_states` and checkpoints gather the global arrays (a
collective every rank joins); `set_params`, `set_states` and loads cut
global arrays to the block; eval and the eager step bind the mesh too.
The batch splits over the DistOpt's axis only. Once sharded, the
parameters train only under a DistOpt on that mesh: any other optimizer
raises, where it would run the serial math on the shards.

Sequence and expert parallelism ride the same binding: a `seq_axis`
GPT's attention is a ring and an `ep_axis` MoE dispatches its tokens by
all-to-all while the DistOpt's mesh carries the axis (the batch is not
split over a sequence axis, as in the JAX package's step). A step's
first build refuses an expert-parallel MoE on a mesh of more than one
device whose DistOpt does not reduce over its axis
(`_check_ep_reduction`).

Pipeline parallelism rides it too: `compile(pipeline_axis, n_micro,
pipeline_schedule)` stores the pipeline execution, in the JAX package's
positions, and it is part of a graph-mode step's key; a pipelined model
(models.transformer.PipelinedGPT) lays its block stacks out for the
degree of that axis on its DistOpt's mesh, and its step runs the
schedule over the bound axis (`parallel.pipeline`): the rank's rows of
the batch split into n_micro microbatches that flow through its stage.

Builds (`introspect`): a graph-mode step or eval signature registers a
build at its first call, the warm-up, which runs under introspect's
counting mode (the trace phase: its flops, bytes and op listing), with
the JAX package's signature (state, opt, rng, arg; the step tag, the
static-argument repr and the true batch size), so a new batch bucket
blames as it does there; the capture at the second call is the build's
compile phase. `Device.cost_analysis` is the last step build's cost.
`lower_step(tag)` returns that build as a `StepLowering` (a CUDA graph has
no lowering: its op listing and counted cost) and `step_cost_analysis()`
the cost, under XLA's key names; both are None / {} before a step.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import hashlib
import io
import json
import os
import shutil
import time
import zipfile
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from . import (autograd, distributed, goodput, health, introspect, layer,
               memory, observe, overlap, resilience, watchdog)
from . import device as device_module
from . import opt as opt_module
from .ops import attention as _attention
from .tensor import Tensor, _param_view, _raw

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


class StepLowering:
    """`Model.lower_step`'s result. The JAX package returns the step's
    jax `Lowered` (its HLO text, its cost analysis); a CUDA graph has no
    lowering, and this holds what the port keeps of one step build
    instead: `as_text()` the build's op listing (one line per aten op and
    hand-written kernel of the warm-up's count, written while
    `introspect.capture_hlo` is on; None otherwise) and `cost_analysis()`
    its counted cost."""

    def __init__(self, rec):
        self._rec = rec

    def as_text(self) -> "str | None":
        path = self._rec.get("hlo_path")
        if not path:
            return None
        with open(path, encoding="utf-8") as f:
            return f.read()

    def cost_analysis(self) -> dict:
        return dict(self._rec.get("cost") or {})


class _Buffered:
    """One buffered signature: calls so far, its build (introspect key,
    signature and, once the warm-up ran, the build record), and once
    captured its CUDA graph, static input buffers, static outputs and
    launch counts."""

    __slots__ = ("calls", "graph", "inputs", "out", "launches", "key",
                 "sig", "rec")

    def __init__(self, key, sig):
        self.calls = 0
        self.graph = None
        self.inputs = None
        self.out = None
        self.launches = None
        self.key = key
        self.sig = sig
        self.rec = None


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
            if self.training:
                self._check_sharded_step()
            if not (self.graph_mode and self.training):
                comm = self._dp_comm() if self.training else None
                if comm is not None and comm.world_size > 1:
                    raise ValueError(
                        f"DistOpt over {comm.world_size} ranks trains in "
                        "graph mode only: compile(use_graph=True) (the "
                        "data-parallel step slices the batch and reduces "
                        "the outputs)")
                # the eager step: an OOM writes the forensics bundle
                # under the graph-mode step's key; sharded parameters
                # run with their mesh bound
                with memory.on_oom("step"), self._tp_bound():
                    if self._health_monitor is not None and self.training:
                        return self._eager_health_step(func, args, kwargs)
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
        self._health_monitor = None
        self._last_input_arrs = None  # the last graph-mode step's inputs
        self._step_entry = None       # the last dispatched step signature
        self._health_steps = 0
        self._health_layout = None   # the packed stats' entries
        # pre-update values of a skip_step step: one for the optimizer's
        # per-parameter holds, one for the buffers held over the step
        self._health_scratch = (health.Scratch(), health.Scratch())
        self._dp_synced = False   # rank 0's states broadcast (DistOpt)
        self._dp_gen = None       # the rank's random stream (DistOpt)
        # tensor parallelism: the mesh the parameters are sharded over,
        # and {id(raw parameter): (Placement, global shape)}
        self._tp_mesh = None
        self._placements = {}
        # pipeline execution (compile's pipeline_axis, n_micro and
        # schedule)
        self.pipeline_axis = None
        self.n_micro = 1
        self.pipeline_schedule = "gpipe"
        nn.Module.train(self, False)

    # ---- configuration ----------------------------------------------------
    def set_optimizer(self, opt):
        self._optimizer = opt
        self._dp_synced = False

    def set_health_monitor(self, monitor):
        """Attach (or detach, with None) a health.HealthMonitor. The
        policy is part of a graph-mode step (skip_step records the select
        into it), so the training graphs built so far are dropped."""
        prev = self._health_monitor
        self._health_monitor = monitor
        self._reset_steps()
        if monitor is not None:
            health.set_active_monitor(monitor)
        elif prev is not None and health.active_monitor() is prev:
            # only the owner's detach clears the process registration
            health.set_active_monitor(None)
        return monitor

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
        self._release_pool()

    def compile(self, inputs, is_train=True, use_graph=False,
                sequential=False, pipeline_axis=None, n_micro=1,
                pipeline_schedule="gpipe", amp=None, eval_buckets="auto",
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
        nothing.

        health: a health.HealthMonitor to attach, True for a default
        (warn) one, False to detach, None to leave it as it is; attaching
        or detaching drops the training graphs built so far.

        pipeline_axis, n_micro, pipeline_schedule: the mesh axis and
        microbatch count of pipeline execution, read by the models that
        pipeline (models.transformer.PipelinedGPT) when they lay out
        their parameters (`_layout_for_compile`); "gpipe" (autograd
        through the schedule, every microbatch's activations held until
        the backward) or "1f1b" (forward and backward interleaved, the
        loss inside the schedule, in-flight activations bounded by about
        twice the stages). They are part of a graph-mode step's key."""
        if pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"pipeline_schedule {pipeline_schedule!r}; "
                             "the JAX package takes 'gpipe' or '1f1b'")
        self.pipeline_axis = pipeline_axis
        self.n_micro = n_micro
        self.pipeline_schedule = pipeline_schedule
        self._layout_for_compile()
        if health is not None:
            from . import health as _health
            if health is False:
                self.set_health_monitor(None)
            elif health is True:
                self.set_health_monitor(_health.HealthMonitor())
            elif isinstance(health, _health.HealthMonitor):
                self.set_health_monitor(health)
            else:
                raise TypeError(
                    f"health= expects a health.HealthMonitor, True, "
                    f"False, or None; got {type(health).__name__}")
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

    def _layout_for_compile(self):
        """Called by `compile` once the pipeline execution is stored: a
        model that lays its parameters out for it checks the combination
        and lays them out here. Nothing by default."""

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
            with torch.no_grad(), self._tp_bound():
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

    def _signature(self, vals, tag=0) -> tuple:
        """A buffered step's key: every tensor's shape, dtype and device,
        the training flag, the compute dtype, the optimizer's step tag
        (DistOpt's partial strategy builds one step per tag, as the JAX
        package compiles one executable per tag) and the pipeline
        execution (axis, n_micro, schedule)."""
        return (tuple((tuple(v.shape), v.dtype, v.device)
                      for v in map(_raw, vals) if torch.is_tensor(v)),
                autograd.training, autograd.compute_dtype, tag,
                (self.pipeline_axis, self.n_micro, self.pipeline_schedule))

    # ---- data parallelism (DistOpt) ---------------------------------------
    def _dp_comm(self):
        """The DistOpt's communicator when the step is data parallel (its
        mesh carries a process group, at any size), else None."""
        opt = self._optimizer
        if isinstance(opt, opt_module.DistOpt) \
                and opt.communicator.group is not None:
            return opt.communicator
        return None

    def _dp_sync(self, comm, dev):
        """Once per model, at its first data-parallel build: a collective
        on every axis group of the mesh (NCCL makes its communicators
        there, eagerly, never inside a capture); rank 0's parameters,
        buffers, optimizer slots (step counter included; not the
        per-rank sparse residuals) and device random stream broadcast to
        every rank of the mesh, so the ranks start equal, as
        DistributedDataParallel makes them at its construction; then the
        parameters with a tensor-parallel spec on the mesh, and their
        slots, cut to this rank's shard (`_shard`). A tensor already
        sharded is broadcast only among the ranks that hold its block."""
        if self._dp_synced:
            return
        from .parallel.tp import sanitize
        mesh = comm.mesh
        if self._tp_mesh is not None and mesh is not self._tp_mesh:
            raise ValueError("the parameters are sharded over another mesh "
                             f"({self._tp_mesh!r}); build the model anew")
        for a in mesh.axis_names:
            _group_all_reduce(mesh.group(a), comm.device)
        inner = self._optimizer.opt

        def spec(raw_spec):
            return sanitize(raw_spec, mesh) if self._tp_mesh else None

        held = [(t, spec(getattr(t, "spec", None)))
                for t in self._raw_states().values()]
        held += zip(inner.state_arrays(),
                    (spec(s) for s in inner.state_specs()))
        for t, s in held:
            _broadcast_(t, _group_over(mesh, [a for a in mesh.axis_names
                                              if a not in (s or ())]))
        rng = dev.rng_state.to(comm.device)
        _broadcast_(rng, _group_over(mesh, list(mesh.axis_names)))
        dev.rng_state = rng
        self._shard(mesh, inner)
        self._dp_synced = True

    @torch.no_grad()
    def _shard(self, mesh, inner):
        """Cut every parameter whose spec names an axis of `mesh` to this
        rank's block, in place (the same nn.Parameter, so the optimizer's
        states stay keyed on it), with its slots in the optimizer
        `inner`, which gets the placements (its checkpoints stay
        global)."""
        from .parallel.tp import Placement, sanitize
        for p in self._raw_params().values():
            spec = sanitize(getattr(p, "spec", None), mesh)
            if spec is None or id(p) in self._placements:
                continue
            pl = Placement(mesh, spec)
            self._placements[id(p)] = (pl, tuple(p.shape))
            p.data = _block(pl, p.data)
            slots = inner._states.get(id(p), {})
            for k, v in slots.items():
                slots[k] = _block(pl, v)
        if self._placements:
            self._tp_mesh = mesh
            inner._placements = {pid: pl for pid, (pl, _)
                                 in self._placements.items()}

    def _check_sharded_step(self):
        """Sharded parameters train only under a DistOpt on the mesh they
        are sharded over: its step binds that mesh, so the layers run
        their collectives. Any other optimizer would run the serial math
        on this rank's shards (JAX's global arrays stay whole there)."""
        if not self._placements:
            return
        comm = self._dp_comm()
        if comm is None or comm.mesh is not self._tp_mesh:
            raise ValueError(
                "the parameters are sharded over "
                f"{self._tp_mesh!r}: train them with a DistOpt on that "
                "mesh, or build the model anew")

    def _check_ep_reduction(self):
        """At a step's first build (JAX model.py:283-304): an
        expert-parallel MoE layer whose axis is on a DistOpt mesh of more
        than one device needs the DistOpt to reduce over that axis too;
        over `data` alone each ep rank's replicated expert tables would
        take only its own slices' gradients and diverge, so it raises."""
        opt = self._optimizer
        if not isinstance(opt, opt_module.DistOpt) \
                or opt.communicator.mesh is None \
                or opt.communicator.mesh.size <= 1:
            return
        mesh_axes = set(opt.communicator.mesh.shape)
        red_axes = set(opt.axis if isinstance(opt.axis, tuple)
                       else (opt.axis,))
        for lyr in self.modules():
            ep = getattr(lyr, "ep_axis", None)
            if (ep is not None and hasattr(lyr, "num_experts")
                    and ep in mesh_axes and ep not in red_axes):
                raise ValueError(
                    f"MoE layer routes experts over mesh axis '{ep}' "
                    f"but DistOpt reduces only over {sorted(red_axes)}"
                    f"; expert gradients would diverge across '{ep}'. "
                    f"Use DistOpt(axis={tuple(sorted(red_axes) + [ep])}"
                    f", mesh=mesh)")

    def _tp_bound(self):
        """The mesh the parameters are sharded over, bound (a context
        manager), or a null context."""
        return self._tp_mesh.bind() if self._tp_mesh is not None \
            else contextlib.nullcontext()

    def _global(self, t):
        """`t`, or for a sharded parameter the global array gathered from
        every rank's block (a collective)."""
        entry = self._placements.get(id(t))
        return t if entry is None else entry[0].gather(t.detach())

    def _global_shape(self, t) -> tuple:
        entry = self._placements.get(id(t))
        return tuple(t.shape) if entry is None else entry[1]

    def _to_local(self, p, value):
        """`value` for parameter `p`: cut to this rank's block when `p` is
        sharded and `value` has the global shape."""
        entry = self._placements.get(id(p))
        if entry is None:
            return value
        src = _raw(value).detach() if _is_tensor(value) \
            else torch.as_tensor(np.array(value))
        return entry[0].shard(src) if tuple(src.shape) == entry[1] else src

    def get_params(self):
        """As `Layer.get_params`; a sharded parameter's entry is its
        global array, gathered (every rank calls it), not a view."""
        if not self._placements:
            return super().get_params()
        return OrderedDict((k, self._global_view(v))
                           for k, v in self._raw_params().items())

    def get_states(self):
        if not self._placements:
            return super().get_states()
        return OrderedDict((k, self._global_view(v))
                           for k, v in self._raw_states().items())

    def _global_view(self, t):
        if id(t) not in self._placements:
            return _param_view(t)
        return Tensor._wrap(self._global(t), device_module.of(t.device))

    def _copy_into(self, own, states, strict):
        """`Layer._copy_into`, with global arrays for sharded parameters
        cut to this rank's block."""
        if self._placements:
            states = {n: self._to_local(own[n], v) if n in own else v
                      for n, v in states.items()}
        super()._copy_into(own, states, strict)

    def _folds_rank(self, comm) -> bool:
        """Whether the data-parallel step draws from a per-rank stream:
        over more than one rank, as the JAX package folds the rank in only
        when its mesh has more than one device."""
        return comm.world_size > 1

    def _dp_stream(self, comm, dev):
        """The rank's random stream for one data-parallel step (the JAX
        package's `fold_in(rng, rank)`), or None to draw from the shared
        one (`_folds_rank`). The shared stream is the device generator,
        equal on every rank: the rank's generator, on the model's device,
        is seeded from a hash of its state and the rank; the shared one
        then moves on to a seed hashed from its state (JAX's `split`),
        alike on every rank, so a checkpoint of it resumes every rank's
        stream. Called on the host before every step: on the card the
        step's graph registers the rank's generator and each replay
        reads the seed it was given here."""
        if not self._folds_rank(comm):
            return None
        shared = dev.generator
        state = shared.get_state().numpy().tobytes()

        def seed(tag: bytes) -> int:
            return int.from_bytes(hashlib.blake2b(
                state + tag, digest_size=8).digest(), "little") >> 1

        if self._dp_gen is None:
            self._dp_gen = torch.Generator(device=dev.torch_device)
        self._dp_gen.manual_seed(seed(b"rank%d" % comm._rank_index()))
        shared.manual_seed(seed(b"split"))
        return self._dp_gen

    def _dp_call(self, call, comm):
        """`call` as the data-parallel step body, with the mesh's axes
        bound (the JAX shard_map body's): the rank's rows of every
        batched input over the DistOpt's axis only (JAX's P(axis)
        in-spec), then the outputs as JAX's step returns them (0-d
        averaged over the ranks, batched ones gathered along axis 0) and
        the buffers (batch norm's running statistics) averaged over the
        ranks."""
        n, r = comm.world_size, comm._rank_index()
        param_ids = {id(t) for t in self._raw_params().values()}

        def rows(v):
            t = _raw(v)
            if not torch.is_tensor(t) or t.dim() == 0:
                return v
            b = t.shape[0]
            if b % n:
                raise ValueError(
                    f"axis '{comm.axis}' has {n} shards; they must divide "
                    f"the global batch of {b}")
            part = t[r * b // n:(r + 1) * b // n]
            return Tensor._wrap(part, v.device, v.requires_grad) \
                if isinstance(v, Tensor) else part

        def gathered(t):
            t = t.detach()
            return comm._mean(t) if t.dim() == 0 \
                else comm._gather(t, tiled=True)

        def body(vs):
            with comm.mesh.bind():
                out = call([rows(v) for v in vs])
            out = _map_out(out, gathered)
            for t in self._raw_states().values():
                if id(t) not in param_ids and t.is_floating_point():
                    comm._mean_(t)
            return out

        return body

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
        opt = self._optimizer
        # the tag first: it is part of the step's key
        tag = opt.step_tag() if opt is not None else 0
        partial = isinstance(opt, opt_module.DistOpt)

        def call(vs):
            kw = dict(zip(names[n_pos:], vs[n_pos:]))
            if partial:
                opt._partial_static_idx = tag
            try:
                return func(self, *vs[:n_pos], **kw)
            finally:
                if partial:
                    opt._partial_static_idx = None

        comm = self._dp_comm()
        if comm is not None:
            call = self._dp_call(call, comm)
        key = self._signature(vals, tag)
        entry = self._train_steps.get(key)
        raws = [_raw(v) for v in vals if _is_tensor(v)]
        bs = raws[0].shape[0] if raws and raws[0].dim() > 0 else None
        dev = device_module.of(self._device)
        if entry is None:
            self._check_ep_reduction()
        if entry is None and comm is not None:
            self._dp_sync(comm, dev)
        stream = self._dp_stream(comm, dev) if comm is not None else None
        if entry is None:
            # the JAX package's step signature: its parts, step tag,
            # static-argument repr and true batch size, so a rebuild
            # blames as it does there
            sig = introspect.signature(
                (list(self._raw_states().values()),
                 self._optimizer.state_arrays()
                 if self._optimizer is not None else [],
                 dev.rng_state, raws),
                names=("state", "opt", "rng", "arg"), tag=tag,
                static=repr(sorted(
                    ((i, repr(v)) for i, v in self._static_args.items()),
                    key=lambda t: (isinstance(t[0], str), str(t[0])))),
                donated=(0, 1), batch_hint=bs)
            entry = self._train_steps[key] = _Buffered("step", sig)
            self._build_count += 1
            # the memory ledger's birth site: parameters, and the
            # retained inputs while a health monitor is attached
            memory.track_model(self)
            observe.record_compile(
                bs, recompile=len(self._train_steps) > 1,
                donated_bytes=self._step_state_bytes())
        profiling = dev.verbosity > 0 \
            and self._graph_steps >= dev.skip_iteration
        first = entry.calls == 0
        mon = self._health_monitor
        self._last_input_arrs = raws
        t0 = time.perf_counter()
        # the watchdog's `step` deadline arms over the span: the warm-up
        # and the capture run under `model.build`, which taints it; with
        # a health monitor the stats read is the step's fence, without
        # one only the dispatch is guarded (as in the JAX package)
        with watchdog.guard("step"), observe.span("model.step", tag=tag):
            with memory.on_oom("step"), dev.drawing_from(stream):
                if mon is None:
                    out = self._run_buffered(entry, call, vals)
                else:
                    out, packed = self._run_buffered(
                        entry,
                        self._health_body(call, mon.policy == "skip_step",
                                          comm),
                        vals)
            if mon is not None:
                # the step's one read of its stats (inside the span: on
                # the card it is the step's fence)
                stats = packed.cpu().tolist()
            if profiling:
                # after the call returns: a capture has ended by then
                dev.Sync()
                fenced = time.perf_counter() - t0
                dev.step_times.append(fenced)
                observe.record_step_fenced(fenced)
        seconds = time.perf_counter() - t0
        self._graph_steps += 1
        if entry is not self._step_entry:
            # MFU follows the dispatched signature's flops
            self._step_entry = entry
            introspect.note_step_flops(entry.rec["cost"].get("flops")
                                       if entry.rec is not None else 0)
        if first:
            observe.record_step_build(seconds)
        observe.record_step(seconds, batch=bs, tag=tag, device=dev)
        if mon is not None and self._health_feed(
                stats, raws, in_graph_skip=True) == "skip":
            # the update was discarded on the device: this step's wall
            # time produced nothing, so goodput moves it out of `step`
            goodput.mark_step_skipped()
        return out

    def lower_step(self, tag=0):
        """What the port keeps of the graph-mode step build of `tag`, for
        inspection: a `StepLowering` over its build record (the counted
        cost, the op listing). A CUDA graph has no lowering, so nothing
        is traced or run here and no state changes (the generator, the
        parameters and the optimizer's slots stay as they are). None
        where the JAX package's returns None: before a graph-mode step,
        or with no build of `tag`."""
        if not self._train_steps or self._last_input_arrs is None:
            return None
        for key, entry in reversed(list(self._train_steps.items())):
            if key[3] == tag and entry.rec is not None:
                return StepLowering(entry.rec)
        return None

    def step_cost_analysis(self):
        """The counted cost of the graph-mode step build (introspect's
        count at its warm-up: "flops", "bytes accessed", "aten ops",
        "kernel launches"), under XLA's key names; {} where the JAX
        package's is: before a graph-mode step. The flops are the port's
        count (matmuls, convolutions and the hand-written kernels by
        formula), not XLA's, which adds the elementwise work."""
        lowered = self.lower_step()
        return lowered.cost_analysis() if lowered is not None else {}

    # ---- training health (health) -------------------------------------------
    def _health_groups(self):
        """{id(raw parameter): layer group}: the first component of the
        parameter's name ("l1.W" -> "l1")."""
        return {id(t): name.split(".", 1)[0]
                for name, t in self._raw_params().items()}

    def _health_body(self, call, skip, comm=None):
        """`call` as a graph-mode step with the health collector active:
        returns (outputs, the packed stats tensor). With `skip` the
        optimizer selects a flagged step's update back, and so does this
        body for the model's buffers (batch norm's running statistics),
        held over the whole step; both holds live in the model's
        persistent scratch, sized at the warm-up call. With `comm` (the
        data-parallel step's) the flag is agreed and the stats reduced
        across its ranks."""
        opt_scratch, buf_scratch = self._health_scratch

        def body(vs):
            col = health.StepStatsCollector(self._health_groups(), skip=skip,
                                            scratch=opt_scratch, comm=comm)
            bufs = list(self.buffers()) if skip else []
            held = buf_scratch.hold(bufs) if bufs else []
            health._set_collector(col)
            try:
                out = call(vs)
            finally:
                health._set_collector(None)
            col.finalize()
            if bufs:
                health.select_back(col.anomaly(), held, bufs)
            self._health_layout = col.layout
            return out, col.packed

        return body

    def _health_feed(self, values, input_arrs, in_graph_skip):
        """Feed one step's host stats (the packed tensor's values) to the
        monitor; its policy acts here (halt raises HealthError)."""
        mon = self._health_monitor
        self._health_steps += 1
        provider = None
        if input_arrs is not None and mon.snapshot_batch:
            def provider():
                return [a.detach().cpu().numpy() for a in input_arrs]
        return mon.on_step(health.unpack(values, self._health_layout),
                           step=self._health_steps, batch_provider=provider,
                           amp=self.amp is not None,
                           in_graph_skip=in_graph_skip)

    def _eager_health_step(self, func, args, kwargs):
        """The eager step (use_graph=False) with the same collector,
        finalized eagerly: warn and halt only, as in the JAX package
        (skip_step's rollback belongs to the graph-mode step, so an eager
        anomaly under skip_step is booked as warn)."""
        col = health.StepStatsCollector(self._health_groups())
        health._set_collector(col)
        try:
            out = func(self, *args, **kwargs)
        finally:
            health._set_collector(None)
        col.finalize()
        self._health_layout = col.layout
        self._health_feed(col.packed.cpu().tolist(),
                          [_raw(a) for a in args if _is_tensor(a)],
                          in_graph_skip=False)
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

    def _eval_run(self, vals, nb=None):
        """The buffered eval forward of `vals`; `nb` is the batch before
        padding to its bucket (the build signature's batch hint)."""
        key = ("eval",) + self._signature(vals)
        entry = self._eval_steps.get(key)
        if entry is None:
            sig = introspect.signature(
                (list(self._raw_states().values()),
                 [_raw(v) for v in vals if _is_tensor(v)]),
                names=("state", "arg"), batch_hint=nb)
            entry = self._eval_steps[key] = _Buffered("eval", sig)
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
        out = self._eval_run(vals, nb)
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
                    [_map_out(a, lambda t: t[:h]) for a in args], h))
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
        after; on the CPU, or sequential, eagerly every time. The first
        call is the signature's build (`_warm_up`)."""
        dev = torch.device(self._device)
        entry.calls += 1
        if dev.type != "cuda" or self.sequential:
            self.graph_backend = "eager"
            if entry.calls == 1:
                with observe.span("model.build"):
                    return self._warm_up(entry, fn, vals, dev, False)
            return _detached(fn(vals))
        self.graph_backend = "cuda_graph"
        cur = torch.cuda.current_stream(dev)
        if entry.calls == 1:
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(dev)
            side = self._side_stream
            side.wait_stream(cur)
            with observe.span("model.build"), torch.cuda.stream(side):
                out = self._warm_up(entry, fn, vals, dev, True)
            cur.wait_stream(side)
            return out
        if entry.graph is None:
            self._capture(entry, fn, vals, dev)
        for buf, v in zip(entry.inputs, (v for v in vals if _is_tensor(v))):
            buf.copy_(_raw(v), non_blocking=True)
        entry.graph.replay()
        _attention.add_launches(entry.launches)
        return _fresh(entry.out)

    def _held_bytes(self, key) -> int:
        """Bytes of the states a build of `key` takes besides its inputs:
        the step's parameters, buffers and optimizer states (what it
        updates in place), eval's parameters and buffers."""
        if key == "step":
            return self._step_state_bytes()
        return sum(t.numel() * t.element_size()
                   for t in self._raw_states().values())

    def _warm_up(self, entry, fn, vals, dev, capture_next):
        """A signature's first call, its build's trace phase: fn(vals)
        under introspect's counting mode (`introspect.first_call`: plainly
        on a warm-store hit, whose stored record holds the count), then
        the build registers with its memory (arguments: the inputs and
        held states; outputs; on CUDA temps, the call's peak rise less the
        outputs and the states it created; a hit's are the stored ones)
        and, after a cold build with the store enabled, writes its record.
        With `capture_next` the capture at the second call completes the
        record's compile phase."""
        cuda = dev.type == "cuda"
        held0 = self._held_bytes(entry.key)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.memory_allocated(dev)
        out, cost, mem, lines, seconds, warm = introspect.first_call(
            lambda: _detached(fn(vals)), entry.key, entry.sig)
        if mem is None:
            held = self._held_bytes(entry.key)
            outputs = sum(t.numel() * t.element_size() for t in _leaves(out))
            mem = {"arguments": held + sum(
                _raw(v).numel() * _raw(v).element_size()
                for v in vals if _is_tensor(v)), "outputs": outputs}
            if cuda:
                mem["temps"] = max(0, torch.cuda.max_memory_allocated(dev)
                                   - start - outputs - (held - held0))
        entry.rec = introspect.record_build(
            entry.key, entry.sig, {"trace": seconds}, cost, mem, lines,
            device=device_module.of(dev), capture_pending=capture_next,
            warm=warm)
        introspect.export_built(entry.key, entry.sig, entry.rec, lines)
        return out

    def _capture(self, entry, fn, vals, dev):
        """Capture fn on static copies of the inputs (on the model's
        device) into a CUDA graph in the model's pool, with the device's
        generator registered; the kernels' launch counts of the capture
        are kept for the replays. The capture is the build's compile
        phase (`introspect.complete_build`; with `capture_hlo` on, the
        graph is dumped beside the op listing).

        Python's cyclic garbage is collected before the capture and the
        collector is off during it: a dead model in a reference cycle
        (one held by a caught exception's traceback, say) frees its own
        CUDA graphs when it is collected, and a graph destroyed inside
        another's capture invalidates that capture."""
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
        # with capture_hlo on, the graph is kept past the capture for its
        # dump, then instantiated
        dot = introspect.graph_dump_path(entry.rec)
        graph = torch.cuda.CUDAGraph(keep_graph=dot is not None)
        graph.register_generator_state(device_module.of(dev).generator)
        before = _attention.launch_counts()
        dump_s = 0.0
        with observe.span("model.build"):
            gc.collect()   # build time: a step guard is tainted by now
            t0 = time.perf_counter()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self._graph_pool,
                                      capture_error_mode="thread_local"):
                    out = fn(statics)
            finally:
                if collecting:
                    gc.enable()
            if dot is not None:
                t1 = time.perf_counter()
                graph.debug_dump(dot)
                dump_s = time.perf_counter() - t1
                graph.instantiate()
        compile_s = time.perf_counter() - t0 - dump_s
        entry.launches = _attention.launches_since(before)
        entry.graph, entry.inputs, entry.out = graph, bufs, _detached(out)
        if entry.rec is not None:
            introspect.complete_build(entry.rec, compile_s, graph_path=dot)

    def _reset_steps(self):
        """Drop the training graphs and the recorded static arguments (a
        load replaces the states the steps were built on, as the JAX
        package drops its compiled step)."""
        self._train_steps = {}
        self._static_args = None
        self._release_pool()

    def _release_pool(self):
        """Forget the graph pool once no graph holds it: a capture into a
        pool whose graphs were all destroyed fails inside the caching
        allocator, so the next capture makes a new one."""
        if not any(e.graph is not None for e in (
                *self._train_steps.values(), *self._eval_steps.values())):
            self._graph_pool = None

    # ---- the training loop --------------------------------------------------
    def fit(self, data, epochs=1, verbose=0, prefetch_to_device=0):
        """Train over `data`, an iterable of per-batch argument tuples for
        `train_one_batch`, re-iterated each epoch (a list or a dataset,
        not a one-shot generator). Returns the per-epoch mean losses: the
        step's second output, or its only one. The losses stay on the
        device until the epoch ends, then come back in one transfer.

        prefetch_to_device=N wraps each epoch in an
        `overlap.DevicePrefetcher`, which moves up to N batches to the
        model's device ahead of use; it is closed on every exit path.

        Each fetch passes the fault point "data.next". A health monitor's
        halt raises HealthError out of fit with the epoch's progress as
        `partial`: {"epoch", "steps_completed", "losses", "last_loss"}."""
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
                        with observe.span("data.wait"), \
                                watchdog.guard("data_wait"):
                            resilience.fault_point("data.next")
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
                except health.HealthError as e:
                    vals = _host_losses(losses)
                    e.partial = {"epoch": epoch,
                                 "steps_completed": len(vals),
                                 "losses": vals,
                                 "last_loss": vals[-1] if vals else None}
                    raise
                finally:
                    if prefetcher is not None:
                        prefetcher.close()
            if not losses:
                raise ValueError(
                    f"fit epoch {epoch} saw no batches - `data` must be "
                    "re-iterable across epochs (a list, not a generator)")
            vals = _host_losses(losses)
            mean = sum(vals) / len(vals)
            history.append(mean)
            if verbose:
                print(f"epoch {epoch}: loss {mean:.6f} ({len(vals)} steps)")
        return history

    # ---- checkpoints --------------------------------------------------------
    def _host_states(self, aux_states=None) -> dict:
        """numpy copies of the states (device to host), `aux.<key>` for
        the aux states. Copies on the CPU too (`.cpu()` returns a CPU
        tensor itself): an async checkpoint writes them while the next
        steps update the states in place."""
        states = {k: self._global(t).detach().to("cpu", copy=True).numpy()
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
        `load_checkpoint` and interpreter exit call. Returns the path.

        Under a process group every rank calls it (the sparse residuals
        of a DistOpt, one per rank, are gathered into `res.npz` as `r<i>`:
        (world, ...) stacks, JAX's `res` tree) and only rank 0 writes; the
        states are the same on every rank. Tensor-parallel shards are
        gathered first, so the files hold the global arrays, and a load
        cuts them to each rank's block. The others wait for rank 0's
        save, its write too when `async_save=False`, and raise where it
        raises."""
        # rank 0's pending writes first (a failed one raises everywhere)
        distributed.on_rank0(overlap.wait_for_checkpoints)
        path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
        get_stacks = getattr(self._optimizer, "residual_device_stacks",
                             None)
        stacks = get_stacks() if get_stacks is not None else {}
        # sharded parameters and slots are gathered to the global arrays
        # on every rank (a collective), before rank 0 writes them
        held = (self._host_states(), self._opt_states()) \
            if self._placements else None
        distributed.on_rank0(lambda: self._write_checkpoint(
            path, step, overwrite, async_save, stacks, held))
        return path

    def _opt_states(self) -> dict:
        return self._optimizer.get_states() \
            if self._optimizer is not None else {}

    def _write_checkpoint(self, path, step, overwrite, async_save, stacks,
                          held=None):
        """save_checkpoint's writing part (rank 0's alone in a job);
        `held` the (states, optimizer states) already on the host."""
        if os.path.isdir(path):
            if overwrite:
                try:
                    os.remove(resilience.manifest_path(path))
                except OSError:
                    pass
            elif resilience.is_complete_checkpoint(path):
                raise ValueError(f"checkpoint {path} exists and is complete "
                                 "(pass overwrite=True to replace it)")
            else:
                resilience.set_aside_checkpoint(path, ".reclaimed")
        t0 = time.perf_counter()
        # the blocking device-to-host part, under the ckpt_save deadline
        with observe.span("checkpoint.save"), watchdog.guard("ckpt_save"):
            states, opt_states = held if held is not None \
                else (self._host_states(), self._opt_states())
            rng = self._rng_device().rng_state.numpy()
        res = {f"r{i}": v for i, v in stacks.items()}
        nbytes = sum(int(v.nbytes) for v in (*states.values(),
                                              *opt_states.values(),
                                              *res.values(), rng))
        meta = {"format": "singa_tpu_torch.checkpoint", "version": 1,
                "step": int(step), "model": type(self).__name__,
                "files": ["model.zip", "opt.npz", "rng.npy"]
                + (["res.npz"] if res else [])}

        def write():
            tmp = f"{path}.partial-{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            _write_states_zip(os.path.join(tmp, "model.zip"), states)
            np.savez(os.path.join(tmp, "opt.npz"), **opt_states)
            if res:
                np.savez(os.path.join(tmp, "res.npz"), **res)
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
            with observe.span("checkpoint.save"), \
                    watchdog.guard("ckpt_save"):
                write()
            overlap.clear_write_failed(path)
        observe.record_checkpoint_bytes(nbytes)

    def load_checkpoint(self, path: str, validate: bool = True):
        """Restore a `save_checkpoint` directory (a .../step_N path) into
        this compiled model, its optimizer and the device generator, in
        place; waits for pending async saves first.

        With `validate` (default) and a `step_N.manifest.json` beside
        `path` (the resilience layer writes one per durable save), the
        manifest's parameter signature is checked first: a mismatch
        raises ValueError naming the parameters before anything is
        restored; a different device count is allowed and emits the
        `reshard_restore` event. The training graphs are dropped, so the
        next step warms up and captures again (a new build of the same
        signature: `introspect` blames it `new_function`).

        Every rank of a job restores the same files, once rank 0's
        pending writes are durable (the others wait for its wait): the
        replicated states on any world size, a DistOpt's sparse residual
        stacks (`res.npz`) only on the world size that saved them (this
        rank's row; another size raises)."""
        distributed.on_rank0(overlap.wait_for_checkpoints)
        if not os.path.isfile(os.path.join(path, "meta.json")):
            raise FileNotFoundError(f"no checkpoint at {path} (meta.json "
                                    "missing)")
        manifest = resilience.read_manifest(path)
        if validate and manifest is not None:
            problems = resilience.validate_manifest(manifest, self)
            if problems:
                raise ValueError(f"checkpoint {path} does not fit this "
                                 "model: " + "; ".join(problems))
            saved = (manifest.get("mesh") or {}).get("n_devices")
            live = distributed.topology()["n_devices"]
            if saved and saved != live:
                observe.get_registry().emit(
                    {"kind": "resilience", "event": "reshard_restore",
                     "path": path, "saved_devices": saved,
                     "live_devices": live})
        with observe.span("checkpoint.load"):
            self.set_states(_read_states_zip(os.path.join(path,
                                                          "model.zip")))
            if self._optimizer is not None:
                self._optimizer.setup(self._raw_params().values())
                with np.load(os.path.join(path, "opt.npz")) as z:
                    self._optimizer.set_states({k: z[k] for k in z.files})
                res = os.path.join(path, "res.npz")
                load_stacks = getattr(self._optimizer,
                                      "load_residual_device_stacks", None)
                if load_stacks is not None and os.path.isfile(res):
                    with np.load(res) as z:
                        load_stacks({int(k[1:]): z[k] for k in z.files})
        self._rng_device().rng_state = torch.from_numpy(
            np.load(os.path.join(path, "rng.npy")))
        self._reset_steps()
        return self


def _group_over(mesh, axes):
    """The process group over `axes` of `mesh` (one name or their
    product), or None when there are none."""
    if not axes:
        return None
    return mesh.group(axes[0] if len(axes) == 1 else tuple(axes))


def _broadcast_(t, group):
    """The group's first rank's t written into every member's t, in
    place; nothing without a group."""
    from .parallel.communicator import _bcast_
    if group is not None:
        _bcast_(t, group)


def _group_all_reduce(group, device):
    """One small all-reduce on `group`, eagerly."""
    from .parallel.communicator import _reduce_
    if group is not None:
        _reduce_(torch.zeros(1, device=device), group)


def _block(placement, t):
    """This rank's block of `t` as a contiguous tensor of its own."""
    return placement.shard(t).clone(memory_format=torch.contiguous_format)


def _host_losses(losses) -> list:
    """Device losses as floats, in one transfer."""
    if not losses:
        return []
    return torch.stack([v.float().reshape(()) for v in losses]).cpu().tolist()


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
