"""Tensor facade over torch.Tensor (counterpart of singa_tpu/tensor.py).

`Tensor.data` holds a `torch.Tensor` where the JAX package's holds a
`jax.Array`, on the `Device` in `.device`; `creator`, `requires_grad`
and `stores_grad` are the tape's hooks, as there. The module functions
and the operators here are NOT recorded for autograd (as in the JAX
package, tensor.py:9-11): they are the raw math layer, and the tape
lives in `autograd`.
"""

from __future__ import annotations

import builtins
import operator as _op

import numpy as np
import torch
import torch.nn.functional as F

from . import device as device_module
from .device import Device

# ---- dtypes (the JAX package's names) ----------------------------------
float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
bfloat16 = torch.bfloat16
int8 = torch.int8
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool

_DT = {
    "float16": float16, "float32": float32, "float64": float64,
    "bfloat16": bfloat16, "int8": int8, "int32": int32, "int64": int64,
    "uint8": uint8, "char": int8, "float": float32, "double": float64,
    "int": int32, "bool": bool_,
}
_NP_DT = {np.dtype(k): v for k, v in (
    ("float16", float16), ("float32", float32), ("float64", float64),
    ("int8", int8), ("int32", int32), ("int64", int64), ("uint8", uint8),
    ("bool", bool_))}


def _resolve_dtype(dt):
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str):
        return _DT[dt]
    return _NP_DT[np.dtype(dt)]


def _dev(device) -> Device:
    if device is None:
        return device_module.get_default_device()
    if isinstance(device, Device):
        return device
    return device_module.of(device)


def _raw(x):
    return x.data if isinstance(x, Tensor) else x


def _param_view(p: torch.Tensor) -> "Tensor":
    """The one Tensor over a layer's raw parameter or state `p`, made at
    first use and kept on `p`: `Layer.get_params()`/`get_states()` return
    it and `autograd.backward` yields it, so its identity is stable and a
    write through it (`set_value`, `copy_from_numpy`, `copy_from`, `+=`)
    reaches the layer's tensor in place."""
    t = getattr(p, "_singa_tensor", None)
    if t is None or t.data is not p:
        t = Tensor._wrap(p, device_module.of(p.device), p.requires_grad)
        t.stores_grad = p.requires_grad
        p._singa_tensor = t
    elif t.device.torch_device != p.device:
        t.device = device_module.of(p.device)
    return t


class Tensor:
    """nd-array on a Device, with autograd hooks (`creator`, the
    autograd Operator that produced it; `requires_grad`; `stores_grad`)."""

    __slots__ = ("data", "device", "creator", "requires_grad", "stores_grad",
                 "name")

    def __init__(self, shape=None, device=None, dtype=None, data=None,
                 requires_grad: bool = True, stores_grad: bool = False,
                 creator=None, name: str | None = None):
        dtype = _resolve_dtype(dtype)
        if isinstance(data, torch.Tensor):
            self.device = _dev(device) if device is not None \
                else device_module.of(data.device)
            if data.device != self.device.torch_device:
                data = data.to(self.device.torch_device)
            self.data = data if dtype is None else data.to(dtype)
        else:
            self.device = _dev(device)
            td = self.device.torch_device
            if data is None:
                self.data = torch.zeros(tuple(shape or ()),
                                        dtype=dtype or float32, device=td)
            elif isinstance(data, Tensor):
                self.data = data.data.to(device=td, dtype=dtype,
                                         copy=True)
            else:
                arr = np.asarray(data)
                if dtype is None and arr.dtype == np.float64:
                    dtype = float32   # never carry f64 onto the card
                self.data = torch.as_tensor(arr).to(device=td, dtype=dtype)
        self.creator = creator
        self.requires_grad = requires_grad
        self.stores_grad = stores_grad
        self.name = name

    @classmethod
    def _wrap(cls, data, device, requires_grad=False, creator=None):
        """A Tensor around `data` already on `device` (no checks)."""
        t = object.__new__(cls)
        t.data, t.device, t.creator = data, device, creator
        t.requires_grad, t.stores_grad, t.name = requires_grad, False, None
        return t

    def _new(self, data, requires_grad=True):
        """A result on this tensor's device; requires_grad defaults to
        True, as the JAX package's Tensor(data=...) does."""
        return Tensor._wrap(data, self.device, requires_grad)

    # ---- metadata -------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ndim(self):
        return self.data.dim()

    def size(self):
        return self.data.numel()

    def memsize(self):
        return self.size() * self.data.element_size()

    def is_empty(self):
        return self.size() == 0

    def is_transpose(self):
        return False

    # ---- conversions ----------------------------------------------------
    def numpy(self) -> np.ndarray:
        """A host copy; bf16 comes back as float32 (numpy has no bf16)."""
        d = self.data.detach()
        if d.dtype == bfloat16:
            d = d.float()
        return d.cpu().numpy()

    def item(self):
        return self.data.item()

    def as_type(self, dtype) -> "Tensor":
        return Tensor(data=self.data.detach().to(_resolve_dtype(dtype)),
                      device=self.device, requires_grad=self.requires_grad,
                      stores_grad=self.stores_grad)

    def to_device(self, device) -> "Tensor":
        self.device = _dev(device)
        self.data = self.data.to(self.device.torch_device)
        return self

    def to_host(self) -> "Tensor":
        return self.to_device(device_module.create_cpu_device())

    def clone(self) -> "Tensor":
        return Tensor(data=self.data.detach().clone(), device=self.device,
                      requires_grad=self.requires_grad,
                      stores_grad=self.stores_grad, name=self.name)

    copy = clone
    deepcopy = clone
    contiguous = clone

    def is_dummy(self) -> bool:
        from . import autograd
        return isinstance(self.creator, autograd.Dummy)

    def to_type(self, dtype):
        """In-place dtype change."""
        self.data = self.data.to(_resolve_dtype(dtype))
        return self

    def copy_data(self, t: "Tensor"):
        assert t.size() == self.size(), "tensor shape should be the same"
        self._set(t.data.reshape(self.shape))

    def _set(self, value):
        """Replace the values in place (the dtype and device stay)."""
        with torch.no_grad():
            self.data.copy_(torch.as_tensor(value).reshape(self.shape))

    def _replace(self, value):
        """Rebind `data` to `value`, as the JAX package's Tensor does; a
        view over a layer's parameter or state (`get_params()`,
        `get_states()`) writes in place instead, so the layer sees it."""
        if getattr(self.data, "_singa_tensor", None) is self:
            with torch.no_grad():
                self.data.copy_(value)
        else:
            self.data = value

    def add_column(self, v: "Tensor"):
        self._replace(self.data + v.data[:, None])

    def add_row(self, v: "Tensor"):
        self._replace(self.data + v.data[None, :])

    def div_column(self, v: "Tensor"):
        self._replace(self.data / v.data[:, None])

    def div_row(self, v: "Tensor"):
        self._replace(self.data / v.data[None, :])

    def mult_column(self, v: "Tensor"):
        self._replace(self.data * v.data[:, None])

    def mult_row(self, v: "Tensor"):
        self._replace(self.data * v.data[None, :])

    def copy_from(self, t: "Tensor"):
        self._replace(t.data.to(self.device.torch_device))

    def copy_from_numpy(self, arr):
        self._set(np.asarray(arr))

    def reset_like(self, t: "Tensor"):
        self.data = torch.zeros(t.shape, dtype=t.dtype,
                                device=self.device.torch_device)

    # ---- in-place init, drawing from the device's generator --------------
    def set_value(self, x):
        with torch.no_grad():
            self.data.fill_(x)
        return self

    def gaussian(self, mean=0.0, std=1.0):
        with torch.no_grad():
            self.data.normal_(mean, std, generator=self.device.generator)
        return self

    def uniform(self, low=0.0, high=1.0):
        with torch.no_grad():
            self.data.uniform_(low, high, generator=self.device.generator)
        return self

    def bernoulli(self, p):
        with torch.no_grad():
            self.data.copy_(torch.rand(self.shape, device=self.data.device,
                                       generator=self.device.generator) < p)
        return self

    # ---- shape ops ------------------------------------------------------
    def reshape(self, shape) -> "Tensor":
        return self._new(self.data.reshape(tuple(shape)), self.requires_grad)

    def transpose(self, axes=None) -> "Tensor":
        axes = tuple(axes) if axes is not None \
            else tuple(reversed(range(self.ndim)))
        return self._new(self.data.permute(axes), self.requires_grad)

    @property
    def T(self):
        return self.transpose()

    def repeat(self, repeats, axis=None) -> "Tensor":
        return self._new(torch.repeat_interleave(self.data, repeats,
                                                 dim=axis))

    # ---- reductions -----------------------------------------------------
    def sum(self, axis=None):
        return self._new(_reduce(torch.sum, self.data, axis))

    def l1(self):
        return float(self.data.abs().mean())

    def l2(self):
        """||x||_2 / sqrt(n), the reference's Tensor::L2."""
        return float(torch.linalg.vector_norm(self.data.float())
                     / np.sqrt(builtins.max(self.size(), 1)))

    # ---- operators ------------------------------------------------------
    def __add__(self, x):
        return self._new(self.data + _raw(x))

    __radd__ = __add__

    def __sub__(self, x):
        return self._new(self.data - _raw(x))

    def __rsub__(self, x):
        return self._new(_raw(x) - self.data)

    def __mul__(self, x):
        return self._new(self.data * _raw(x))

    __rmul__ = __mul__

    def __truediv__(self, x):
        return self._new(self.data / _raw(x))

    def __rtruediv__(self, x):
        return self._new(_raw(x) / self.data)

    def __pow__(self, x):
        return self._new(self.data ** _raw(x))

    def __neg__(self):
        return self._new(-self.data)

    def __matmul__(self, x):
        return self._new(self.data @ _raw(x))

    def __lt__(self, x):
        return self._new((self.data < _raw(x)).to(float32), False)

    def __le__(self, x):
        return self._new((self.data <= _raw(x)).to(float32), False)

    def __gt__(self, x):
        return self._new((self.data > _raw(x)).to(float32), False)

    def __ge__(self, x):
        return self._new((self.data >= _raw(x)).to(float32), False)

    def __iadd__(self, x):
        self._replace(self.data + _raw(x))
        return self

    def __isub__(self, x):
        self._replace(self.data - _raw(x))
        return self

    def __imul__(self, x):
        self._replace(self.data * _raw(x))
        return self

    def __itruediv__(self, x):
        self._replace(self.data / _raw(x))
        return self

    def __getitem__(self, idx):
        return self._new(self.data[idx])

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype={self.dtype}, "
                f"device={self.device.lang})")


def _reduce(fn, x, axis):
    return fn(x) if axis is None else fn(x, dim=axis)


# ======================= module-level functions ===========================

def from_numpy(arr, device=None, dtype=None,
               requires_grad: bool = False) -> Tensor:
    """Data tensors default to requires_grad=False; float64 becomes
    float32, integers keep their width."""
    arr = np.asarray(arr)
    if dtype is None and arr.dtype == np.float64:
        dtype = float32
    return Tensor(data=arr, device=device, dtype=dtype,
                  requires_grad=requires_grad)


def to_numpy(t: Tensor) -> np.ndarray:
    return t.numpy()


def from_raw(arr: torch.Tensor, device=None) -> Tensor:
    return Tensor(data=arr, device=device)


def zeros(shape, device=None, dtype=float32) -> Tensor:
    return Tensor(shape=shape, device=device, dtype=dtype)


def ones(shape, device=None, dtype=float32) -> Tensor:
    return Tensor(shape=shape, device=device, dtype=dtype).set_value(1)


def zeros_like(t: Tensor) -> Tensor:
    return t._new(torch.zeros_like(t.data))


def ones_like(t: Tensor) -> Tensor:
    return t._new(torch.ones_like(t.data))


def sizeof(dtype) -> int:
    return torch.empty((), dtype=_resolve_dtype(dtype)).element_size()


def reshape(t: Tensor, shape) -> Tensor:
    return t.reshape(shape)


def transpose(t: Tensor, axes=None) -> Tensor:
    return t.transpose(axes)


def copy_data_to_from(dst: Tensor, src: Tensor, size=None):
    if size is None:
        dst.copy_from(src)
    else:
        flat = torch.cat([src.data.reshape(-1)[:size],
                          dst.data.reshape(-1)[size:]])
        dst.data = flat.reshape(dst.shape)


def concatenate(tensors, axis=0) -> Tensor:
    return tensors[0]._new(torch.cat([t.data for t in tensors], dim=axis))


def repeat(t: Tensor, repeats, axis=None) -> Tensor:
    return t.repeat(repeats, axis)


# ---- elementwise unary ------------------------------------------------------

def _unary(fn):
    def wrapped(t: Tensor) -> Tensor:
        return t._new(fn(t.data))
    return wrapped


abs = _unary(torch.abs)  # noqa: A001 - parity with the reference's name
exp = _unary(torch.exp)
log = _unary(torch.log)
sign = _unary(torch.sign)
sqrt = _unary(torch.sqrt)
square = _unary(torch.square)
tanh = _unary(torch.tanh)
sigmoid = _unary(torch.sigmoid)
relu = _unary(torch.relu)
sin = _unary(torch.sin)
cos = _unary(torch.cos)
ceil = _unary(torch.ceil)
floor = _unary(torch.floor)
round = _unary(torch.round)  # noqa: A001  (half to even, as jnp.round)


def softmax(t: Tensor, axis: int = -1) -> Tensor:
    return t._new(torch.softmax(t.data, dim=axis))


def pow(base, exponent) -> Tensor:  # noqa: A001
    t = base if isinstance(base, Tensor) else exponent
    return t._new(torch.pow(_raw(base), _raw(exponent)))


def clip(t: Tensor, lo, hi) -> Tensor:
    return t._new(torch.clamp(t.data, lo, hi))


# ---- arithmetic ---------------------------------------------------------------

def add(lhs, rhs) -> Tensor:
    return lhs + rhs


def sub(lhs, rhs) -> Tensor:
    return lhs - rhs


def eltwise_mult(lhs: Tensor, rhs) -> Tensor:
    return lhs * rhs


def div(lhs, rhs) -> Tensor:
    if not isinstance(lhs, Tensor):
        return rhs._new(lhs / rhs.data)
    return lhs / rhs


def mult(A: Tensor, B: Tensor) -> Tensor:
    """Matrix multiply."""
    return A._new(A.data @ B.data)


def axpy(alpha, x: Tensor, y: Tensor):
    """y += alpha * x, in place on y."""
    y._replace(y.data + alpha * x.data)
    return y


def einsum(subscripts: str, *operands: Tensor) -> Tensor:
    return operands[0]._new(torch.einsum(subscripts,
                                         *[o.data for o in operands]))


def tensordot(a: Tensor, b: Tensor, axes=2) -> Tensor:
    return a._new(torch.tensordot(a.data, b.data, dims=axes))


# ---- comparison: float masks, as the reference's --------------------------

def lt(t: Tensor, x): return t < x
def le(t: Tensor, x): return t <= x
def gt(t: Tensor, x): return t > x
def ge(t: Tensor, x): return t >= x


def eq(t: Tensor, x) -> Tensor:
    return t._new((t.data == _raw(x)).to(float32), False)


# ---- reductions ------------------------------------------------------------------

def sum(t: Tensor, axis=None) -> Tensor:  # noqa: A001
    return t._new(_reduce(torch.sum, t.data, axis))


def mean(t: Tensor, axis=None) -> Tensor:
    return t._new(_reduce(torch.mean, t.data, axis))


def max(t: Tensor, axis=None) -> Tensor:  # noqa: A001
    return t._new(_reduce(torch.amax, t.data, axis))


def min(t: Tensor, axis=None) -> Tensor:  # noqa: A001
    return t._new(_reduce(torch.amin, t.data, axis))


def argmax(t: Tensor, axis=-1) -> Tensor:
    return t._new(torch.argmax(t.data, dim=axis), False)


# ---- row/col ops for 2-D matrices -------------------------------------------

def _colwise(op):
    def f(m: Tensor, v: Tensor) -> Tensor:  # v length = nrows
        return m._new(op(m.data, v.data[:, None]))
    return f


def _rowwise(op):
    def f(m: Tensor, v: Tensor) -> Tensor:  # v length = ncols
        return m._new(op(m.data, v.data[None, :]))
    return f


add_column = _colwise(_op.add)
sub_column = _colwise(_op.sub)
mult_column = _colwise(_op.mul)
div_column = _colwise(_op.truediv)
add_row = _rowwise(_op.add)
sub_row = _rowwise(_op.sub)
mult_row = _rowwise(_op.mul)
div_row = _rowwise(_op.truediv)


def sum_columns(m: Tensor) -> Tensor:
    return m._new(torch.sum(m.data, dim=1))


def sum_rows(m: Tensor) -> Tensor:
    return m._new(torch.sum(m.data, dim=0))


# ---- random, from the device's generator -------------------------------------

def gaussian(mean, std, shape, device=None, dtype=float32) -> Tensor:
    return Tensor(shape, device=device, dtype=dtype).gaussian(mean, std)


def uniform(low, high, shape, device=None, dtype=float32) -> Tensor:
    return Tensor(shape, device=device, dtype=dtype).uniform(low, high)


def bernoulli(p, shape, device=None, dtype=float32) -> Tensor:
    return Tensor(shape, device=device, dtype=dtype).bernoulli(p)


# ---- fused softmax cross-entropy, on raw tensors -------------------------------

def softmax_cross_entropy_fwd(logits, targets):
    """Per-row -log softmax(logits)[target]; targets are class indices
    (one dim fewer, or integer) or one-hot/soft rows."""
    logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    if targets.dim() == logits.dim() - 1 or not targets.is_floating_point():
        return -logp.gather(-1, targets.long()[..., None])[..., 0]
    return -(targets * logp).sum(-1)


def softmax_cross_entropy_bwd(logits, targets):
    """d(CE)/d(logits) = softmax(logits) - onehot(targets)."""
    p = torch.softmax(logits, dim=-1)
    if targets.dim() == logits.dim() - 1 or not targets.is_floating_point():
        onehot = F.one_hot(targets.long(), logits.shape[-1]).to(logits.dtype)
    else:
        onehot = targets
    return p - onehot


# ---- reference-name module functions -------------------------------------------

def from_raw_tensor(t):
    """Wrap a raw torch tensor (or numpy array) as a Tensor."""
    if isinstance(t, np.ndarray):
        return from_numpy(t)
    return from_raw(t)


def from_raw_tensors(tt):
    return [from_raw_tensor(t) for t in list(tt)]


def product(shape):
    out = 1
    for s in shape:
        out *= int(s)
    return out


def contiguous(t: Tensor) -> Tensor:
    return t.clone()


def to_host(t: Tensor) -> Tensor:
    """Copy to a host (CPU) tensor."""
    return from_numpy(t.numpy(), device=device_module.create_cpu_device())


def average(t: Tensor, axis=None):
    """Mean of all elements (a float) or along `axis` (a Tensor)."""
    if axis is None or t.ndim <= 1:
        return float(t.data.float().mean())
    return t._new(torch.mean(t.data, dim=axis))


def copy_from_numpy(data: Tensor, np_array):
    data.copy_from_numpy(np.asarray(np_array).reshape(data.shape))


def random(shape, device=None) -> Tensor:
    """Uniform [0, 1) tensor of `shape`."""
    return Tensor(shape, device=device).uniform(0.0, 1.0)
