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
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import autograd
from .tensor import Tensor


# ---- learning-rate schedules ---------------------------------------------

class DecayScheduler:
    def __init__(self, init_value: float):
        self.init_value = init_value

    def __call__(self, step):
        raise NotImplementedError


class Constant(DecayScheduler):
    def __call__(self, step):
        return float(np.float32(self.init_value))


class ExponentialDecay(DecayScheduler):
    def __init__(self, init_value, decay_steps, decay_rate, staircase=False):
        super().__init__(init_value)
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def __call__(self, step):
        s = np.float32(step) / np.float32(self.decay_steps)
        if self.staircase:
            s = np.floor(s)
        return float(np.float32(self.init_value)
                     * np.power(np.float32(self.decay_rate), s))


def _sched(lr) -> DecayScheduler:
    return lr if isinstance(lr, DecayScheduler) else Constant(float(lr))


# ---- base optimizer --------------------------------------------------------

class Optimizer:
    """Per-parameter state lives in `self._states[id(param)]` as dicts of
    tensors shaped like the parameter; `step_counter` counts applied
    steps (an fp32 value, as in the JAX package)."""

    def __init__(self, lr):
        self.lr = _sched(lr)
        self.step_counter = 0.0
        self._states = {}       # id(param) -> {name: tensor}
        self._state_order = []  # ids in creation order (checkpoint order)

    def _state(self, param) -> dict:
        pid = id(param)
        if pid not in self._states:
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
            self._state(p)

    def get_states(self) -> dict:
        """numpy copies under the JAX package's keys: `step_counter` and
        `p{j}.{k}` for state k of the j-th parameter."""
        out = {"step_counter": np.asarray(self.step_counter, np.float32)}
        for j, pid in enumerate(self._state_order):
            for k, v in self._states[pid].items():
                out[f"p{j}.{k}"] = v.detach().cpu().numpy()
        return out

    @torch.no_grad()
    def set_states(self, states: dict):
        if "step_counter" in states:
            self.step_counter = float(np.asarray(states["step_counter"]))
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
        at their first update. The updates run inside the profiler range
        `opt.apply_updates` (the JAX package's span name), which
        torch.profiler attributes the update kernels to; backward hands
        over every grad at once, so the range holds only the updates."""
        pairs = list(autograd.backward(loss))
        with torch.profiler.record_function("opt.apply_updates"):
            for p, g in pairs:
                if isinstance(p, Tensor):
                    p, g = p.data, g.data
                self.apply(p, g)
        self.step()

    def step(self):
        self.step_counter += 1.0

    def apply(self, param, grad):
        raise NotImplementedError

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
    def apply(self, param, grad):
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
    def apply(self, param, grad):
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
    def apply(self, param, grad):
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
    def apply(self, param, grad):
        g = self._decayed(param, grad, self.weight_decay)
        st = self._state(param)
        t = self.step_counter + 1.0
        m, v = st["m"], st["v"]
        m.mul_(self.beta_1).add_((1 - self.beta_1) * g)
        v.mul_(self.beta_2).add_((1 - self.beta_2) * g * g)
        mhat = m / float(np.float32(1 - math.pow(self.beta_1, t)))
        vhat = v / float(np.float32(1 - math.pow(self.beta_2, t)))
        param.sub_(self._lr() * mhat / (torch.sqrt(vhat) + self.epsilon))


__all__ = ["AdaGrad", "Adam", "Constant", "DecayScheduler",
           "ExponentialDecay", "Optimizer", "RMSProp", "SGD"]
