"""Optimizers (counterpart of singa_tpu/opt.py): the learning-rate
schedules, the `Optimizer` base with its step counter and per-parameter
state, and SGD, RMSProp, AdaGrad and Adam written out with the JAX
package's formulas.

Not `torch.optim`, whose updates differ from the JAX package's: its SGD
seeds the momentum buffer with g on the first step where JAX starts from
zeros and adds (1 - dampening) g, and both packages' weight decay is an L2
term added to g before momentum or Adam's moments.

Each `nn.Parameter` is updated IN PLACE under `torch.no_grad()`, never
through `.data`: an in-place op bumps the tensor's version counter, which
is how `serving.decode_state` notices that the weights it cached are
stale.

`DistOpt` wraps an optimizer for synchronous data parallelism over a
mesh axis (`parallel.Communicator`: NCCL on the card, gloo on the CPU),
with the JAX package's four strategies; see its docstring.

The step counter is a 0-d fp32 tensor on the parameters' device, stepped
in place, and the schedules and Adam's bias correction are fp32 torch ops
on it, as the JAX package's are jnp ops on its counter: a step captured
in a CUDA graph (`Model.compile(use_graph=True)`) then reads the counter
of the step it replays, not the value it had at capture.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import autograd, health, memory, observe
from .tensor import Tensor, _raw


# ---- learning-rate schedules ---------------------------------------------

class DecayScheduler:
    """`sched(step)`: the learning rate at `step`, a 0-d fp32 tensor (the
    optimizer's counter), as a 0-d fp32 tensor on its device."""

    def __init__(self, init_value: float):
        self.init_value = init_value

    def __call__(self, step):
        raise NotImplementedError


class Constant(DecayScheduler):
    def __call__(self, step):
        return torch.full((), self.init_value, dtype=torch.float32,
                          device=step.device)


class ExponentialDecay(DecayScheduler):
    def __init__(self, init_value, decay_steps, decay_rate, staircase=False):
        super().__init__(init_value)
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def __call__(self, step):
        s = step / self.decay_steps
        if self.staircase:
            s = torch.floor(s)
        return self.init_value * torch.pow(self.decay_rate, s)


def _sched(lr) -> DecayScheduler:
    return lr if isinstance(lr, DecayScheduler) else Constant(float(lr))


# ---- base optimizer --------------------------------------------------------

class Optimizer:
    """Per-parameter state lives in `self._states[id(param)]` as dicts of
    tensors shaped like the parameter; `step_counter` counts applied
    steps (a 0-d fp32 tensor, as in the JAX package), on the CPU until
    the first parameter's state is made, then on that parameter's
    device.

    A parameter with a tensor-parallel spec (`param.spec`, set by the
    `tp_axis` layers) has slots sharded like it (`state_specs`). Once a
    model holds this rank's shards it gives the optimizer their
    placements (`_placements`): `get_states` then gathers those slots to
    the global arrays (a collective: every rank calls it) and
    `set_states` cuts global arrays to this rank's block."""

    def __init__(self, lr):
        self.lr = _sched(lr)
        self.step_counter = torch.zeros((), dtype=torch.float32)
        self._states = {}       # id(param) -> {name: tensor}
        self._state_order = []  # ids in creation order (checkpoint order)
        self._params_by_id = {}  # id(param) -> param
        self._placements = {}   # id(param) -> its Placement, once sharded

    def _state(self, param) -> dict:
        pid = id(param)
        self._params_by_id[pid] = param
        if pid not in self._states:
            if self.step_counter.device != param.device:
                self.step_counter = self.step_counter.to(param.device)
            self._states[pid] = self._init_state(param)
            self._state_order.append(pid)
        return self._states[pid]

    def _init_state(self, param) -> dict:
        return {}

    def setup(self, params):
        """Create every parameter's state up front, in the order given
        (Model.compile passes the JAX package's parameter order), so the
        checkpoint keys p{j}.{k} line up with the JAX package's."""
        for p in params:
            self._state(_raw(p))
        # the memory ledger's birth site: the step counter and the slots
        memory.track_optimizer(self)

    def get_states(self) -> dict:
        """numpy copies under the JAX package's keys: `step_counter` and
        `p{j}.{k}` for state k of the j-th parameter."""
        # copies on the CPU too (`.cpu()` returns a CPU tensor itself): an
        # async checkpoint writes them while the next steps update the
        # states in place
        out = {"step_counter": self.step_counter.to("cpu", copy=True)
               .numpy()}
        for j, pid in enumerate(self._state_order):
            pl = self._placements.get(pid)
            for k, v in self._states[pid].items():
                v = v.detach() if pl is None else pl.gather(v.detach())
                out[f"p{j}.{k}"] = v.to("cpu", copy=True).numpy()
        return out

    @torch.no_grad()
    def set_states(self, states: dict):
        if "step_counter" in states:
            self.step_counter.copy_(torch.as_tensor(
                np.asarray(states["step_counter"], np.float32)))
        for j, pid in enumerate(self._state_order):
            pl = self._placements.get(pid)
            for k, v in self._states[pid].items():
                key = f"p{j}.{k}"
                if key in states:
                    val = torch.as_tensor(np.asarray(states[key]))
                    if pl is not None and val.shape != v.shape:
                        val = pl.shard(val)
                    v.copy_(val)

    # -- API ---------------------------------------------------------------
    def __call__(self, loss):
        return self.backward_and_update(loss)

    def backward_and_update(self, loss):
        """Backward from `loss` (a Tensor or a raw tensor), then every
        parameter's update, then one step of the counter (JAX's order: an
        update reads the counter of the step it belongs to). Parameters
        created after `setup` (at a layer's first call) get their state
        at their first update. The updates run inside the span
        `opt.apply_updates` (`observe.span`: a profiler range to which
        torch.profiler attributes the update kernels);
        backward hands over every grad at once, so the span holds only
        the updates. `observe.record_opt_update` counts the parameters
        updated each time this body runs on the host: every step eagerly,
        and under a CUDA graph at the warm-up call and at the capture
        only (a replay runs no Python).

        With a `health.StepStatsCollector` active, the collector sees the
        loss and every gradient before the first update (its anomaly flag
        is then final), and each parameter's value just before and just
        after its update. Under `skip=True` each parameter and its
        optimizer slots are held (the collector's scratch) before the
        update and selected back where the flag is set, and the counter
        steps only where it is not: a flagged step leaves them all
        bitwise as they were, with no host read."""
        t0 = time.perf_counter()
        pairs = list(autograd.backward(loss))
        col = health.collector()
        if col is not None:
            col.observe_loss(_raw(loss))
            for p, g in pairs:
                col.observe_grad(_raw(p), _raw(g))
        with observe.span("opt.apply_updates"):
            for p, g in pairs:
                if col is None:
                    self.apply(p, g)
                else:
                    self._apply_observed(col, p, g)
        if col is not None and col.skip:
            self._step_unless(col.anomaly())
        else:
            self.step()
        observe.record_opt_update(len(pairs), time.perf_counter() - t0,
                                  "local")

    def _apply_observed(self, col, param, grad):
        """One update fed to the health collector (see
        backward_and_update); the pre-update values live only until the
        parameter's update and select are done."""
        raw = _raw(param)
        held = [raw] + ([v for _, v in sorted(self._state(raw).items())]
                        if col.skip else [])
        old = col.scratch.hold(held) if col.scratch is not None \
            else [t.detach().clone() for t in held]
        self.apply(param, grad)
        col.observe_update(raw, old[0], raw)
        if col.skip:
            health.select_back(col.anomaly(), old, held)

    @torch.no_grad()
    def step(self):
        self.step_counter.add_(1.0)

    @torch.no_grad()
    def _step_unless(self, flag):
        self.step_counter.copy_(torch.where(flag, self.step_counter,
                                            self.step_counter + 1.0))

    def apply(self, param, grad):
        """Update `param` from `grad` in place: SINGA Tensors (the pairs
        `autograd.backward` yields for a Tensor loss) or raw tensors (the
        GPT's path)."""
        self._apply(_raw(param), _raw(grad))

    def _apply(self, param, grad):
        raise NotImplementedError

    def step_tag(self) -> int:
        """The step variant a graph-mode step is built for: a local
        optimizer has one (the JAX package keys its executables on
        it)."""
        return 0

    def state_arrays(self) -> list:
        """The step counter, then every parameter's state tensors (keys
        sorted), in creation order: the tensors a step updates in
        place."""
        arrs = [self.step_counter]
        for pid in self._state_order:
            st = self._states[pid]
            arrs.extend(st[k] for k in sorted(st))
        return arrs

    def state_specs(self) -> list:
        """The spec of each `state_arrays()` entry: () for the step
        counter and a replicated parameter's slots, a sharded
        parameter's spec for its slots (the momentum of a column shard
        is a column shard)."""
        specs = [()]
        for pid in self._state_order:
            spec = tuple(getattr(self._params_by_id.get(pid), "spec", None)
                         or ())
            specs.extend(spec for _ in self._states[pid])
        return specs

    @torch.no_grad()
    def load_state_arrays(self, arrs):
        """Copy `state_arrays()`-ordered values into the states, in
        place."""
        for dst, src in zip(self.state_arrays(), arrs):
            dst.copy_(torch.as_tensor(src))

    def device_check(self, *args):
        pass

    def _lr(self):
        return self.lr(self.step_counter)

    @staticmethod
    def _decayed(param, grad, weight_decay):
        return grad + weight_decay * param if weight_decay > 0 else grad


class SGD(Optimizer):
    """buf = momentum * buf + (1 - dampening) * g (buf starts at zero);
    g = g + momentum * buf with nesterov, else buf; p -= lr * g."""

    def __init__(self, lr=0.1, momentum=0.0, dampening=0.0, weight_decay=0.0,
                 nesterov=False):
        super().__init__(lr)
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("nesterov needs momentum>0, dampening=0")

    def _init_state(self, param):
        if self.momentum > 0:
            return {"momentum_buf": torch.zeros_like(param,
                                                     requires_grad=False)}
        return {}

    @torch.no_grad()
    def _apply(self, param, grad):
        g = self._decayed(param, grad, self.weight_decay)
        if self.momentum > 0:
            buf = self._state(param)["momentum_buf"]
            buf.mul_(self.momentum).add_((1 - self.dampening) * g)
            g = g + self.momentum * buf if self.nesterov else buf
        param.sub_(self._lr() * g)


class RMSProp(Optimizer):
    """avg = rho * avg + (1 - rho) g^2; p -= lr * g / sqrt(avg + eps)."""

    def __init__(self, lr=0.1, rho=0.9, epsilon=1e-8, weight_decay=0.0):
        super().__init__(lr)
        self.rho = rho
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def _init_state(self, param):
        return {"running_average": torch.zeros_like(param,
                                                    requires_grad=False)}

    @torch.no_grad()
    def _apply(self, param, grad):
        g = self._decayed(param, grad, self.weight_decay)
        avg = self._state(param)["running_average"]
        avg.mul_(self.rho).add_((1 - self.rho) * g * g)
        param.sub_(self._lr() * g / torch.sqrt(avg + self.epsilon))


class AdaGrad(Optimizer):
    """hist += g^2; p -= lr * g / sqrt(hist + eps)."""

    def __init__(self, lr=0.1, epsilon=1e-8, weight_decay=0.0):
        super().__init__(lr)
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def _init_state(self, param):
        return {"history": torch.zeros_like(param, requires_grad=False)}

    @torch.no_grad()
    def _apply(self, param, grad):
        g = self._decayed(param, grad, self.weight_decay)
        hist = self._state(param)["history"]
        hist.add_(g * g)
        param.sub_(self._lr() * g / torch.sqrt(hist + self.epsilon))


class Adam(Optimizer):
    """m, v moments of g (L2 decay added to g first); bias correction at
    t = step_counter + 1; p -= lr * mhat / (sqrt(vhat) + eps)."""

    def __init__(self, lr=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                 weight_decay=0.0):
        super().__init__(lr)
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def _init_state(self, param):
        return {"m": torch.zeros_like(param, requires_grad=False),
                "v": torch.zeros_like(param, requires_grad=False)}

    @torch.no_grad()
    def _apply(self, param, grad):
        g = self._decayed(param, grad, self.weight_decay)
        st = self._state(param)
        t = self.step_counter + 1.0
        m, v = st["m"], st["v"]
        m.mul_(self.beta_1).add_((1 - self.beta_1) * g)
        v.mul_(self.beta_2).add_((1 - self.beta_2) * g * g)
        mhat = m / (1 - torch.pow(self.beta_1, t))
        vhat = v / (1 - torch.pow(self.beta_2, t))
        param.sub_(self._lr() * mhat / (torch.sqrt(vhat) + self.epsilon))


# ---- distributed optimizer (ref opt.py:686-1094) -------------------------

def _put(t, value):
    """Write `value` into a Tensor (its `_replace`) or a raw tensor (in
    place)."""
    if isinstance(t, Tensor):
        t._replace(value)
    else:
        with torch.no_grad():
            t.copy_(value)


class DistOpt(Optimizer):
    """Synchronous data-parallel wrapper (the JAX package's DistOpt, the
    reference's opt.py:686-1094): the gradients are reduced over the mesh
    axis by the communicator (`parallel.Communicator`), then the wrapped
    optimizer updates. `world_size` is the axis's size.

    Each rank runs the same program (one process per rank): `Model`'s
    data-parallel graph-mode step feeds each rank its rows of the global
    batch, so the reduced mean gradient is the full batch's. A DistOpt
    whose mesh carries a process group takes that path at any size,
    world size 1 included (the collectives run through the group); one
    with no mesh, or a mesh of one rank without a group, is the identity,
    as in the JAX package.

    The four strategies, as the JAX package's:
      - `backward_and_update` ("dense", also `__call__`): a mean
        all-reduce of every gradient;
      - `backward_and_update_half` ("half"): bf16 on the wire;
      - `backward_and_partial_update` ("partial"): only the parameters
        with index % k == tag are reduced, the others update from the
        local gradient; the tag rotates per step (`step_tag`) and `Model`
        builds one step per tag;
      - `backward_and_sparse_update` ("sparse"): top-K or threshold
        sparsified all-gathers of (index, value) pairs with
        error-feedback residuals.
    The port's backward hands over every gradient at once, so the
    reductions run after the whole backward (JAX's XLA schedule overlaps
    them with it). With a health collector active, it sees the loss and
    the REDUCED gradients before the first update, and its anomaly flag
    is agreed across the ranks (`agree_any`) before any parameter
    changes. The sparse residuals are per rank and updated in place,
    never rebound (a captured step writes the tensors `get_states`
    reads); `residual_device_stacks` gathers them for a checkpoint."""

    def __init__(self, opt: Optimizer, axis: str = "data", mesh=None,
                 topk_frac: float = 0.01, sparse_residuals: bool = False):
        # not Optimizer.__init__: the wrapped optimizer owns the step
        # counter, the schedule and the slots
        from .parallel.communicator import Communicator
        self.opt = opt
        self.axis = axis
        self.communicator = Communicator(axis=axis, mesh=mesh)
        self.world_size = self.communicator.world_size
        self.topk_frac = topk_frac
        # pre-create the residuals at setup (zeros), so they are step
        # inputs from the first step on and a checkpoint restores them
        # before the first backward
        self.sparse_residuals = sparse_residuals
        self._spars_residual = {}   # id(raw param) -> residual tensor
        self._spars_order = []
        self._pending_residuals = None
        self._partial_counter = 0
        self._partial_mode = False
        self.partial_k = 1
        self._partial_static_idx = None   # set by Model per built tag

    # delegate the schedule and the step state to the wrapped optimizer
    @property
    def lr(self):
        return self.opt.lr

    @property
    def step_counter(self):
        return self.opt.step_counter

    def setup(self, params):
        params = list(params)
        self.opt.setup(params)
        if not self.sparse_residuals:
            return
        for p in params:
            raw = _raw(p)
            if getattr(raw, "spec", None) is None \
                    and id(raw) not in self._spars_residual:
                self._spars_residual[id(raw)] = torch.zeros_like(raw)
                self._spars_order.append(id(raw))

    def state_arrays(self):
        return list(self.opt.state_arrays()) + [
            self._spars_residual[pid] for pid in self._spars_order]

    def state_specs(self):
        """The wrapped optimizer's, then () for each sparse residual (only
        replicated parameters have one)."""
        return list(self.opt.state_specs()) + [()] * len(self._spars_order)

    @torch.no_grad()
    def load_state_arrays(self, arrs):
        n_inner = len(self.opt.state_arrays())
        self.opt.load_state_arrays(arrs[:n_inner])
        tail = list(arrs[n_inner:])
        if tail and len(tail) < len(self._spars_order):
            raise ValueError(
                f"checkpoint has {len(tail)} sparse residuals but the "
                f"optimizer tracks {len(self._spars_order)}; save and "
                "restore with the same sparse_residuals setting")
        for i, pid in enumerate(self._spars_order):
            r = self._spars_residual[pid]
            if i < len(tail):
                r.copy_(torch.as_tensor(tail[i]))
            else:
                # a checkpoint from before the residuals existed: exact
                # resume starts from zero error feedback
                r.zero_()
        if tail[len(self._spars_order):]:
            self._pending_residuals = tail[len(self._spars_order):]

    # -- per-rank residual checkpointing -----------------------------------
    def residual_device_stacks(self):
        """{state_arrays index: (world, *shape) numpy}: every rank's
        residuals, gathered (a collective: every rank calls it). Empty
        without a process group or before the residuals exist."""
        if self.communicator.group is None:
            return {}
        out = {}
        n_inner = len(self.opt.state_arrays())
        for i, pid in enumerate(self._spars_order):
            g = self.communicator._gather(self._spars_residual[pid])
            out[n_inner + i] = g.cpu().numpy()
        return out

    @torch.no_grad()
    def load_residual_device_stacks(self, stacks):
        """Restore this rank's row of `residual_device_stacks` output;
        stacks saved on another world size raise."""
        if not stacks:
            return
        if self.communicator.group is None:
            raise ValueError(
                "checkpoint carries per-device sparse residuals but this "
                "DistOpt has no mesh; restore on the same topology")
        n_inner = len(self.opt.state_arrays())
        rank = self.communicator._rank_index()
        for idx, stacked in sorted(stacks.items()):
            stacked = np.asarray(stacked)
            if stacked.shape[0] != self.world_size:
                raise ValueError(
                    f"per-device residual saved on {stacked.shape[0]} "
                    f"devices cannot restore on a {self.world_size}-device "
                    "mesh (error-feedback state is per-device; use the "
                    "same topology)")
            row = torch.as_tensor(stacked[rank])
            i = int(idx) - n_inner
            if i < len(self._spars_order):
                self._spars_residual[self._spars_order[i]].copy_(row)
            else:
                pend = self._pending_residuals
                j = i - len(self._spars_order)
                if pend is not None and j < len(pend):
                    pend[j] = row

    def get_states(self):
        out = self.opt.get_states()
        for i, pid in enumerate(self._spars_order):
            out[f"spars_residual.{i}"] = self._spars_residual[pid].detach() \
                .to("cpu", copy=True).numpy()
        return out

    @torch.no_grad()
    def set_states(self, states):
        self.opt.set_states(states)
        for i, pid in enumerate(self._spars_order):
            key = f"spars_residual.{i}"
            if key in states:
                self._spars_residual[pid].copy_(
                    torch.as_tensor(np.asarray(states[key])))
        # residuals restored before the first backward created them: the
        # sparse strategy takes them in creation order
        pending = []
        i = len(self._spars_order)
        while f"spars_residual.{i}" in states:
            pending.append(np.asarray(states[f"spars_residual.{i}"]))
            i += 1
        if pending:
            self._pending_residuals = pending

    def step(self):
        self.opt.step()

    def apply(self, param, grad):
        self.opt.apply(param, grad)

    # -- the shared update tail ---------------------------------------------
    def _update(self, loss, pairs, strategy, t0, residuals=()):
        """Feed the health collector (the loss, the reduced grads), write
        the new residuals in place (a skip_step flag keeps the old ones),
        update every parameter, step the counter; then book the
        update."""
        col = health.collector()
        if col is not None:
            col.observe_loss(_raw(loss))
            for p, g in pairs:
                col.observe_grad(_raw(p), g)
        with torch.no_grad():
            for r, new in residuals:
                if col is not None and col.skip:
                    new = torch.where(col.anomaly(), r, new)
                r.copy_(new)
        with observe.span("opt.apply_updates"):
            for p, g in pairs:
                if col is None:
                    self.opt.apply(p, g)
                else:
                    self.opt._apply_observed(col, p, g)
        if col is not None and col.skip:
            self.opt._step_unless(col.anomaly())
        else:
            self.opt.step()
        observe.record_opt_update(len(pairs), time.perf_counter() - t0,
                                  strategy)

    # -- strategy 1: plain synchronous all-reduce (ref opt.py:826) ---------
    def backward_and_update(self, loss):
        t0 = time.perf_counter()
        ws = self.world_size
        pairs = [(p, self.communicator.all_reduce(_raw(g)) / ws)
                 for p, g in autograd.backward(loss)]
        self._update(loss, pairs, "dense", t0)

    def __call__(self, loss):
        return self.backward_and_update(loss)

    # -- strategy 2: reduced-precision all-reduce (ref opt.py:867) ---------
    def backward_and_update_half(self, loss, clipping=False,
                                 clip_value=100.0):
        """bf16 on the wire where the reference sends fp16 (bf16 keeps
        fp32's exponent, so no loss scaling)."""
        t0 = time.perf_counter()
        pairs = []
        for p, g in autograd.backward(loss):
            gd = _raw(g)
            if clipping:
                gd = torch.clamp(gd, -clip_value, clip_value)
            gd = self.communicator.all_reduce_half(gd) / self.world_size
            pairs.append((p, gd.to(_raw(p).dtype)))
        self._update(loss, pairs, "half", t0)

    # -- strategy 3: partial-parameter update (ref opt.py:922) -------------
    def step_tag(self) -> int:
        """The rotating partition index: Model builds one step per tag,
        each holding only its partition's collectives (the JAX package
        compiles one executable per tag). 0 until the partial strategy
        has run once; its first step is tag 0, the next tag 1."""
        if not self._partial_mode:
            return 0
        tag = self._partial_counter % self.partial_k
        self._partial_counter += 1
        return tag

    def backward_and_partial_update(self, loss, num_partitions=4):
        """Each step reduces only the parameters with index % k == sel
        (the backward's order); the others update from the local
        gradient (ref opt.py:922-992). In graph mode `sel` is the tag
        Model built the step for; eagerly it rotates on a host counter."""
        k = int(num_partitions)
        self.partial_k = k
        if not self._partial_mode:
            self._partial_mode = True
            # the step running now is tag 0; the next one takes tag 1
            self._partial_counter = max(self._partial_counter, 1)
        sel = self._partial_static_idx
        if sel is None:
            sel = self._partial_counter % k
            self._partial_counter += 1
        t0 = time.perf_counter()
        pairs = []
        for i, (p, g) in enumerate(autograd.backward(loss)):
            gd = _raw(g)
            if i % k == sel:
                gd = self.communicator.all_reduce(gd) / self.world_size
            pairs.append((p, gd))
        self._update(loss, pairs, "partial", t0)

    # -- the raw verbs (ref opt.py:738-817) ----------------------------------
    def update(self, param, grad):
        """One update from an all-reduce-SUMMED gradient: divided by the
        world size first (ref opt.py:738-746); pairs with `all_reduce`."""
        if self.world_size > 1:
            _put(grad, _raw(grad) / self.world_size)
        self.apply(param, grad)

    def all_reduce(self, tensor):
        """All-reduce-sum one Tensor in place (ref `synch`)."""
        _put(tensor, self.communicator.all_reduce(_raw(tensor)))

    def fused_all_reduce(self, tensors, send=True):
        """All-reduce a list of Tensors, one collective each (ref
        `fusedSynch`; no flat-buffer fusion). `send` is kept for the
        signature."""
        del send
        for t in tensors:
            self.all_reduce(t)

    def all_reduce_half(self, tensor):
        _put(tensor, self.communicator.all_reduce_half(_raw(tensor)))

    def fused_all_reduce_half(self, tensors, send=True):
        del send
        for t in tensors:
            self.all_reduce_half(t)

    def sparsification(self, tensor, accumulation, spars, topK):
        """Sparsified all-reduce of one Tensor, with an optional
        error-feedback accumulation Tensor (ref opt.py:786)."""
        x = _raw(tensor) if accumulation is None \
            else _raw(tensor) + _raw(accumulation)
        if topK:
            out, residual = self.communicator.sparse_all_reduce_topk(
                x, spars)
        else:
            out, residual = self.communicator.sparse_all_reduce_threshold(
                x, spars)
        if accumulation is not None:
            _put(accumulation, residual)
        _put(tensor, out)

    def fused_sparsification(self, tensors, accumulation, spars, topK):
        """Sparsified all-reduce over a list of Tensors; `accumulation` is
        a matching LIST of residual Tensors (or None): there is no fused
        buffer to slice."""
        if accumulation is not None and (
                not isinstance(accumulation, (list, tuple))
                or len(accumulation) != len(tensors)):
            raise TypeError(
                "accumulation must be a list of per-tensor residual "
                "Tensors matching `tensors` (no fused-buffer packing here)")
        for i, t in enumerate(tensors):
            acc = accumulation[i] if accumulation is not None else None
            self.sparsification(t, acc, spars, topK)

    def wait(self):
        """Stream fence (ref `wait`): every verb is ordered on the
        caller's stream already."""
        self.communicator.wait()

    # -- strategy 4: sparsified all-reduce with error feedback (ref :994) ----
    def _residual(self, raw):
        """The residual of a parameter, made at its first sparse update:
        the next restored one waiting (`set_states` before the residuals
        existed), else zeros."""
        pid = id(raw)
        if pid not in self._spars_residual:
            pend = self._pending_residuals
            if pend:
                r = torch.as_tensor(np.asarray(pend.pop(0))).to(
                    device=raw.device, dtype=raw.dtype, copy=True)
            else:
                r = torch.zeros_like(raw)
            self._spars_residual[pid] = r
            self._spars_order.append(pid)
        return self._spars_residual[pid]

    def backward_and_sparse_update(self, loss, spars: float = 0.05,
                                   topK: bool = True, corr: bool = True):
        """Strategy 4 (ref opt.py:994). On a model with tensor-parallel
        parameters those take the dense reduction (their gradients are
        shards already) and the replicated ones the packed sparse one;
        their residuals must exist from setup
        (`DistOpt(..., sparse_residuals=True)`), as in the JAX package."""
        by_id = self.opt._params_by_id
        sharded = {pid for pid, p in by_id.items()
                   if getattr(p, "spec", None) is not None}
        if corr and sharded and any(pid not in self._spars_residual
                                    for pid in by_id if pid not in sharded):
            raise RuntimeError(
                "error-feedback residuals on a model with sharded params "
                "must be pre-created: construct "
                "DistOpt(..., sparse_residuals=True)")
        t0 = time.perf_counter()
        pairs, residuals = [], []
        for p, g in autograd.backward(loss):
            raw, x = _raw(p), _raw(g)
            if id(raw) in sharded:
                pairs.append((p, self.communicator.all_reduce(x)
                              / self.world_size))
                continue
            if corr:
                r = self._residual(raw)
                x = x + r
            if topK:
                out, new = self.communicator.sparse_all_reduce_topk(x, spars)
            else:
                out, new = self.communicator.sparse_all_reduce_threshold(
                    x, spars)
            if corr:
                residuals.append((r, new))
            pairs.append((p, out / self.world_size))
        self._update(loss, pairs, "sparse", t0, residuals)


__all__ = ["AdaGrad", "Adam", "Constant", "DecayScheduler", "DistOpt",
           "ExponentialDecay", "Optimizer", "RMSProp", "SGD"]
