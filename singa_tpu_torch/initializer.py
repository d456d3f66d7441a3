"""Parameter initializers, in place (counterpart of singa_tpu/initializer.py).

Each takes a `tensor.Tensor` or a `torch.Tensor` (a layer's parameter)
and fills it with the JAX package's formula, drawing from the generator
of the tensor's `Device` (`Device.SetRandSeed` seeds it). The draws
differ from JAX's, so parity checks carry the weights over.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import device as device_module
from .tensor import Tensor, _raw


def _gen(t) -> torch.Generator:
    return t.device.generator if isinstance(t, Tensor) \
        else device_module.of(t.device).generator


def _fans(t):
    shape = tuple(t.shape)
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    elif len(shape) > 2:
        # conv kernels OIHW: receptive field = prod(spatial)
        receptive = int(np.prod(shape[2:]))
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    else:
        fan_in = fan_out = int(np.prod(shape)) if shape else 1
    return fan_in, fan_out


@torch.no_grad()
def _uniform(t, low, high):
    _raw(t).uniform_(low, high, generator=_gen(t))
    return t


@torch.no_grad()
def _normal(t, mean, std):
    _raw(t).normal_(mean, std, generator=_gen(t))
    return t


@torch.no_grad()
def eye(t):
    assert len(t.shape) == 2, "eye needs a 2D tensor"
    r = _raw(t)
    r.copy_(torch.eye(r.shape[0], r.shape[1], dtype=r.dtype))
    return t


@torch.no_grad()
def orthogonal(t, gain: float = 1.0):
    assert len(t.shape) >= 2
    r = _raw(t)
    rows, cols = r.shape[0], int(np.prod(r.shape[1:]))
    a = torch.empty((max(rows, cols), min(rows, cols)),
                    device=r.device).normal_(generator=_gen(t))
    q, rr = np.linalg.qr(a.cpu().double().numpy())
    q = q * np.sign(np.diag(rr))
    q = q.T if rows < cols else q
    r.copy_(torch.as_tensor(gain * q[:rows, :cols]).reshape(r.shape))
    return t


def _scaled_uniform(t, scale: float):
    limit = math.sqrt(scale)
    return _uniform(t, -limit, limit)


def _scaled_normal(t, scale: float):
    return _normal(t, 0.0, math.sqrt(scale))


def lecun_uniform(t):
    fan_in, _ = _fans(t)
    return _scaled_uniform(t, 3.0 / fan_in)


def lecun_normal(t):
    fan_in, _ = _fans(t)
    return _scaled_normal(t, 1.0 / fan_in)


def glorot_uniform(t):
    fan_in, fan_out = _fans(t)
    return _scaled_uniform(t, 6.0 / (fan_in + fan_out))


def glorot_normal(t):
    fan_in, fan_out = _fans(t)
    return _scaled_normal(t, 2.0 / (fan_in + fan_out))


def he_uniform(t):
    fan_in, _ = _fans(t)
    return _scaled_uniform(t, 6.0 / fan_in)


def he_normal(t):
    fan_in, _ = _fans(t)
    return _scaled_normal(t, 2.0 / fan_in)


# ---- legacy API ------------------------------------------------------------

def uniform(t, fan_in=0, fan_out=0):
    avg = 2.0
    if fan_in * fan_out == 0:
        avg, fan_out = 1.0, fan_in
    x = math.sqrt(3.0 * avg / max(fan_in + fan_out, 1))
    return _uniform(t, -x, x)


def gaussian(t, fan_in=0, fan_out=0):
    avg = 2.0
    if fan_in * fan_out == 0:
        avg, fan_out = 1.0, fan_in
    return _normal(t, 0.0, math.sqrt(avg / max(fan_in + fan_out, 1)))


def xavier(t):
    return glorot_uniform(t)


def msra(t):
    return he_normal(t)


@torch.no_grad()
def glorot(t):
    """Legacy: gaussian(0, 1) scaled by sqrt(2 / (rows + cols))."""
    scale = math.sqrt(2.0 / (t.shape[0] + t.shape[1]))
    _normal(t, 0.0, 1.0)
    _raw(t).mul_(scale)
    return t
