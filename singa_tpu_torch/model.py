"""The Model API (counterpart of singa_tpu/model.py): `compile`,
`train_one_batch` through `__call__`, train/eval, and `save_states` /
`load_states` in the JAX package's checkpoint format.

A `Model` is a `layer.Layer`. `compile` runs one forward on the example
inputs with no graph recorded (`autograd.training` off), which creates
the parameters of the layers that defer their init, and only then sets
up the optimizer, as the JAX package's compile does. Where the JAX
package traces the first `train_one_batch` into one jitted XLA program
(`use_graph=True`), the port runs eagerly: `use_graph` and `sequential`
are recorded and accepted, and a CUDA graph of the step, the port's
counterpart of graph mode, is a later change.

Checkpoints are a zip of `tensor_dict.npz` and `states_attr.json` keyed by
the JAX package's state names (`conv1.W`, `TransformerBlock_<i>.attn.Wq`,
...), so each package loads the other's.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch
from torch import nn

from . import autograd, layer
from . import device as device_module
from .tensor import Tensor


class Model(layer.Layer):
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
        nn.Module.train(self, False)

    # ---- configuration ----------------------------------------------------
    def set_optimizer(self, opt):
        self._optimizer = opt

    @property
    def optimizer(self):
        return self._optimizer

    def graph(self, mode=True, sequential=False):
        """Record the graph flags; the port runs every step eagerly."""
        self.graph_mode = mode
        self.sequential = sequential

    def compile(self, inputs, is_train=True, use_graph=False,
                sequential=False, amp=None):
        """Set the device, the graph flags and the amp dtype ("bfloat16":
        fp32 master weights, bf16 compute at the layers' cast points);
        create the deferred parameters with one forward on `inputs`, no
        graph recorded; set train or eval mode; set up the optimizer's
        state in the JAX package's parameter order.

        The device is the inputs' while some layer still defers its
        parameters: the model moves there (parameters drawn at
        construction included) before that forward. A model whose every
        parameter exists (the GPT, built with a device) keeps its
        parameters' device and moves its inputs there at each call."""
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
            self._optimizer.setup(self.get_params().values())

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
                return super().__call__(*args, **kwargs)
        finally:
            autograd.compute_dtype = prev

    # ---- checkpoints --------------------------------------------------------
    def save_states(self, fpath: str, aux_states: dict | None = None):
        """zip(tensor_dict.npz + states_attr.json) under the JAX names;
        `aux_states` go in as `aux.<key>`."""
        states = {k: t.detach().cpu().numpy()
                  for k, t in self.get_states().items()}
        for k, v in (aux_states or {}).items():
            if isinstance(v, Tensor):
                v = v.data
            states[f"aux.{k}"] = np.asarray(
                v.detach().cpu().numpy() if torch.is_tensor(v) else v)
        attrs = {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                 for k, v in states.items()}
        buf = io.BytesIO()
        np.savez(buf, **states)
        with zipfile.ZipFile(fpath, "w") as zf:
            zf.writestr("tensor_dict.npz", buf.getvalue())
            zf.writestr("states_attr.json", json.dumps(attrs))

    def load_states(self, fpath: str) -> dict:
        """Load a save_states zip (either package's); returns the aux
        states, without their `aux.` prefix."""
        with zipfile.ZipFile(fpath, "r") as zf:
            raw = zf.read("tensor_dict.npz")
        with np.load(io.BytesIO(raw)) as npz:
            loaded = {k: npz[k] for k in npz.files}
        self.set_states({k: v for k, v in loaded.items()
                         if not k.startswith("aux.")})
        return {k[len("aux."):]: v for k, v in loaded.items()
                if k.startswith("aux.")}


def _input_device(x) -> torch.device:
    """Where an example input lives: a Tensor's Device, a raw tensor's
    device, else (numpy) the default device."""
    if isinstance(x, Tensor):
        return x.device.torch_device
    if torch.is_tensor(x):
        return x.device
    return device_module.resolve(None)


__all__ = ["Model"]
