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
stale. `DistOpt` comes with distribution.

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
from .tensor import _raw


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
    device."""

    def __init__(self, lr):
        self.lr = _sched(lr)
        self.step_counter = torch.zeros((), dtype=torch.float32)
        self._states = {}       # id(param) -> {name: tensor}
        self._state_order = []  # ids in creation order (checkpoint order)

    def _state(self, param) -> dict:
        pid = id(param)
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
            for k, v in self._states[pid].items():
                out[f"p{j}.{k}"] = v.detach().to("cpu", copy=True).numpy()
        return out

    @torch.no_grad()
    def set_states(self, states: dict):
        if "step_counter" in states:
            self.step_counter.copy_(torch.as_tensor(
                np.asarray(states["step_counter"], np.float32)))
        for j, pid in enumerate(self._state_order):
            for k, v in self._states[pid].items():
                key = f"p{j}.{k}"
                if key in states:
                    v.copy_(torch.as_tensor(np.asarray(states[key])))

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


__all__ = ["AdaGrad", "Adam", "Constant", "DecayScheduler",
           "ExponentialDecay", "Optimizer", "RMSProp", "SGD"]
