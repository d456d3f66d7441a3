"""The tape operators (counterpart of singa_tpu/autograd.py).

Where the JAX package records a define-by-run tape of its own operators
and derives each backward with `jax.vjp`, the port records PyTorch's
autograd graph: each `Operator` runs torch ops on the `.data` of its
`tensor.Tensor` inputs, and the operators whose backward the JAX package
writes by hand (the softmax cross-entropy, the compute cast, flash
attention) are `torch.autograd.Function`s with the same rule. An
operator's outputs carry it as their `creator`; `src` holds one
`(creator, id, tensor, stores_grad)` entry per input in input order, its
`y_id2idx` maps each output's id to its index, and `_out_shapes` the
outputs' (shape, dtype), as in the JAX package: the ONNX exporter walks
them, and `backward` hands a `stores_grad` leaf its gradient as a Tensor.
A leaf Tensor gets a `Dummy` creator. A layer's parameters are
`nn.Parameter`s passed in raw; each raw input gets a `Dummy` leaf entry of
its own, which never stores a gradient (torch hands the parameter its
gradient).

Every operator also takes raw `torch.Tensor`s, as the GPT's layers pass
them: with no Tensor among its inputs it returns the raw result and
leaves torch's grad mode alone. With Tensors it records only in training
mode (`training`) and when an input requires grad, and runs under
`torch.no_grad()` otherwise.

`backward` is a generator of (param, grad), as in the JAX package. The
operators that only `sonnx` reaches (UpSample ... LessOrEqual) follow the
JAX package's forwards; integer outputs (ArgMax, TopK's indices, Shape,
Size, NonZero) are int32, as the JAX package's are with x64 off. NonZero
has a data-dependent shape: it runs eagerly and raises inside a CUDA-graph
capture.
"""

from __future__ import annotations

import builtins
from collections import deque

import numpy as np
import torch
import torch.nn.functional as F

from . import device as device_module
from .ops.attention import flash_attention
from .tensor import (Tensor, _param_view, _raw, _resolve_dtype,
                     softmax_cross_entropy_bwd, softmax_cross_entropy_fwd)

#: global train/eval switch (singa_tpu/autograd.py `training`); set by
#: Model.train()/eval()
training = False

#: the mixed-precision compute dtype ("bfloat16") or None; set by Model
#: around each call under `compile(amp=...)`. Parameters stay fp32 (the
#: master weights); layers cast at their matmul/conv boundaries through
#: compute_cast, normalizations and the loss upcast internally.
compute_dtype = None


class Operator:
    """Base op: subclasses implement `forward(self, *raw_tensors)` with
    torch ops; torch autograd records its backward."""

    #: class-level: the op never carries gradient (comparisons, casts)
    never_requires_grad = False

    def __init__(self, name: str | None = None):
        self.name = name or type(self).__name__
        self.src = []        # [(src_op, x_id, x, x_stores_grad)] per input
        self.y_id2idx = {}   # id(output Tensor) -> output index
        self.requires_grad = False
        self._n_out = 1
        self._out_shapes = []

    def __call__(self, *xs):
        return self._do_forward(*xs)

    def _do_forward(self, *xs):
        dev = next((x.device for x in xs if isinstance(x, Tensor)), None)
        raw = [x.data if isinstance(x, Tensor) else x for x in xs]
        if dev is None:
            return self.forward(*raw)
        self.requires_grad = (
            training and not self.never_requires_grad
            and builtins.any(x.requires_grad for x in xs
                             if isinstance(x, (Tensor, torch.Tensor))))
        if self.requires_grad:
            for x in xs:
                if not isinstance(x, Tensor):
                    # a raw input (a layer's nn.Parameter, a constant): a
                    # leaf entry that stores no gradient
                    self.src.append((Dummy(x), id(x), x, False))
                    continue
                if x.creator is None:
                    # a leaf: a stores_grad one gets its gradient from
                    # torch, so its data must require grad
                    if (x.stores_grad and x.requires_grad
                            and x.data.is_floating_point()
                            and not x.data.requires_grad):
                        x.data.requires_grad_(True)
                    x.creator = Dummy(x)
                self.src.append((x.creator, id(x), x, x.stores_grad))
            ys = self.forward(*raw)
        else:
            with torch.no_grad():
                ys = self.forward(*raw)
        single = not isinstance(ys, tuple)
        if single:
            ys = (ys,)
        self._n_out = len(ys)
        self._out_shapes = [(tuple(y.shape), y.dtype) for y in ys]
        creator = self if self.requires_grad else None
        outs = []
        for i, y in enumerate(ys):
            t = Tensor._wrap(y, dev, self.requires_grad, creator)
            self.y_id2idx[id(t)] = i
            outs.append(t)
        return outs[0] if single else tuple(outs)

    def forward(self, *xs):
        raise NotImplementedError


class Dummy(Operator):
    """Leaf placeholder: wraps a parameter or an input Tensor."""

    def __init__(self, tensor, name=None):
        super().__init__(name or "Dummy")
        self.tensor = tensor        # a Tensor, or a raw input
        self.y_id2idx = {id(tensor): 0}
        self.requires_grad = bool(getattr(tensor, "requires_grad", False))


def infer_dependency(op: Operator) -> dict:
    """{operator: pending consumer edges} over the tape's `src` records
    below `op`, counting only sources that require grad (the reference's
    autograd.py:71-102, as the JAX package's `infer_dependency`). The
    port's `backward` lets torch order the reverse pass; this is the
    reference's API over the same records."""
    counts = {op: 0}
    queue = deque([op])
    while queue:
        cur = queue.popleft()
        for src_op, _, _, _ in cur.src:
            if src_op.requires_grad:
                if src_op in counts:
                    counts[src_op] += 1
                else:
                    counts[src_op] = 1
                    queue.append(src_op)
    return counts


def _stored_leaves(y: Tensor) -> dict:
    """{id(leaf.data): leaf} of the stores_grad leaf Tensors behind y (a
    raw input's leaf is never one)."""
    out, seen, stack = {}, set(), [y.creator]
    while stack:
        op = stack.pop()
        if op is None or id(op) in seen:
            continue
        seen.add(id(op))
        if isinstance(op, Dummy):
            t = op.tensor
            if isinstance(t, Tensor) and t.stores_grad:
                out[id(t.data)] = t
        else:
            stack.extend(entry[0] for entry in op.src)
    return out


def backward(y, dy=None):
    """Reverse pass from `y` (a Tensor or a raw tensor); a GENERATOR of
    (param, grad) for every leaf that requires grad and was reached, so
    a distributed optimizer can start reducing as grads arrive. The
    grads come from one torch.autograd.grad call over the leaves of the
    graph, then are yielded in the leaves' order, as (Tensor, Tensor) for
    a Tensor `y` (a layer's nn.Parameter as its `get_params()` view,
    `tensor._param_view`) and as (parameter, grad) for a raw `y`, the
    GPT's path."""
    t = _raw(y)
    if t.grad_fn is None:
        raise RuntimeError("backward needs a loss computed in training "
                           "mode from parameters that require grad")
    stored = _stored_leaves(y) if isinstance(y, Tensor) else {}
    leaves, seen, stack = [], set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None:
            leaves.append(var)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    dy = torch.ones_like(t) if dy is None else _raw(dy)
    grads = torch.autograd.grad(t, leaves, dy, allow_unused=True)
    for p, g in zip(leaves, grads):
        if g is None:
            continue
        w = stored.get(id(p))
        if w is None and isinstance(y, Tensor):
            w = _param_view(p)
        if w is not None:
            yield w, Tensor._wrap(g, w.device)
        else:
            yield p, g


def gradients(y, dy=None):
    """Run the whole backward; return {param: grad}."""
    return dict(backward(y, dy))


# ======================= operator zoo =====================================
# Class names and functional wrappers follow the JAX package's.


def _functional(op_cls):
    def f(*xs, **kwargs):
        return op_cls(**kwargs)(*xs)
    f.__name__ = op_cls.__name__.lower()
    return f


# ---- arithmetic / logic --------------------------------------------------

class Add(Operator):
    def forward(self, a, b):
        return a + b


class Sub(Operator):
    def forward(self, a, b):
        return a - b


class Mul(Operator):
    def forward(self, a, b):
        return a * b


class Div(Operator):
    def forward(self, a, b):
        return a / b


class Pow(Operator):
    def forward(self, a, b):
        return torch.pow(a, b)


class Negative(Operator):
    def forward(self, x):
        return -x


class Reciprocal(Operator):
    def forward(self, x):
        return 1.0 / x


class Abs(Operator):
    def forward(self, x):
        return torch.abs(x)


class Sign(Operator):
    never_requires_grad = True

    def forward(self, x):
        return torch.sign(x)


class Exp(Operator):
    def forward(self, x):
        return torch.exp(x)


class Log(Operator):
    def forward(self, x):
        return torch.log(x)


class Sqrt(Operator):
    def forward(self, x):
        return torch.sqrt(x)


class _BoolBinary(Operator):
    never_requires_grad = True
    _fn = None

    def forward(self, a, b):
        return type(self)._fn(a.bool(), b.bool()).float()


class And(_BoolBinary):
    _fn = staticmethod(torch.logical_and)


class Or(_BoolBinary):
    _fn = staticmethod(torch.logical_or)


class Xor(_BoolBinary):
    _fn = staticmethod(torch.logical_xor)


class Not(Operator):
    never_requires_grad = True

    def forward(self, x):
        return torch.logical_not(x.bool()).float()


class _CmpBinary(Operator):
    never_requires_grad = True
    _fn = None

    def forward(self, a, b):
        return type(self)._fn(a, b).float()


class Less(_CmpBinary):
    _fn = staticmethod(torch.lt)


class Greater(_CmpBinary):
    _fn = staticmethod(torch.gt)


class Equal(_CmpBinary):
    _fn = staticmethod(torch.eq)


# ---- activations ---------------------------------------------------------

class _ReluFn(torch.autograd.Function):
    """relu with jax.nn.relu's gradient: g where x > 0, else 0. torch's
    own passes g where its output is not <= 0, so at a NaN input (output
    NaN) it passes g through, and a NaN batch poisons every upstream
    gradient where JAX's stops at the NaN entries."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x > 0, g, torch.zeros((), dtype=g.dtype,
                                                 device=g.device))


class ReLU(Operator):
    def forward(self, x):
        return _ReluFn.apply(x)


class LeakyRelu(Operator):
    def __init__(self, a=0.01):
        super().__init__()
        self.a = a

    def forward(self, x):
        # jax.nn.leaky_relu: x where x >= 0 (its gradient is 1 at 0)
        return torch.where(x >= 0, x, self.a * x)


class Elu(Operator):
    def __init__(self, alpha=1.0):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class SeLU(Operator):
    def __init__(self, alpha=1.67326, gamma=1.0507):
        super().__init__()
        self.alpha, self.gamma = alpha, gamma

    def forward(self, x):
        return self.gamma * torch.where(x > 0, x,
                                        self.alpha * (torch.exp(x) - 1.0))


class PRelu(Operator):
    def forward(self, x, slope):
        return torch.where(x > 0, x, slope * x)


class Sigmoid(Operator):
    def forward(self, x):
        return torch.sigmoid(x)


class HardSigmoid(Operator):
    def __init__(self, alpha=0.2, gamma=0.5):
        super().__init__()
        self.alpha, self.gamma = alpha, gamma

    def forward(self, x):
        return torch.clamp(self.alpha * x + self.gamma, 0.0, 1.0)


class SoftMax(Operator):
    def __init__(self, axis=1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return torch.softmax(x, dim=self.axis)


class SoftPlus(Operator):
    def forward(self, x):
        return F.softplus(x)


class SoftSign(Operator):
    def forward(self, x):
        return x / (1.0 + torch.abs(x))


class Tanh(Operator):
    def forward(self, x):
        return torch.tanh(x)


def _trig(name, fn):
    return type(name, (Operator,), {"forward": (lambda self, x, _f=fn: _f(x))})


Cos = _trig("Cos", torch.cos)
Cosh = _trig("Cosh", torch.cosh)
Acos = _trig("Acos", torch.acos)
Acosh = _trig("Acosh", torch.acosh)
Sin = _trig("Sin", torch.sin)
Sinh = _trig("Sinh", torch.sinh)
Asin = _trig("Asin", torch.asin)
Asinh = _trig("Asinh", torch.asinh)
Tan = _trig("Tan", torch.tan)
Atan = _trig("Atan", torch.atan)
Atanh = _trig("Atanh", torch.atanh)
Erf = _trig("Erf", torch.erf)


# ---- shape / indexing ----------------------------------------------------

class Reshape(Operator):
    def __init__(self, shape):
        super().__init__()
        self.shape = tuple(int(s) for s in shape)

    def forward(self, x):
        return x.reshape(self.shape)


class Flatten(Operator):
    def __init__(self, axis=1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        a = self.axis if self.axis >= 0 else x.dim() + self.axis
        lead = int(np.prod(x.shape[:a])) if a > 0 else 1
        return x.reshape(lead, -1)


class Squeeze(Operator):
    def __init__(self, axis=None):
        super().__init__()
        self.axis = tuple(axis) if isinstance(axis, (list, tuple)) else axis

    def forward(self, x):
        return x.squeeze() if self.axis is None else x.squeeze(self.axis)


class Unsqueeze(Operator):
    def __init__(self, axis):
        super().__init__()
        self.axis = axis if isinstance(axis, (list, tuple)) else [axis]

    def forward(self, x):
        for a in sorted(self.axis):
            x = x.unsqueeze(a)
        return x


class Flip(Operator):
    def __init__(self, axis=0):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return torch.flip(x, list(self.axis) if isinstance(
            self.axis, (list, tuple)) else [self.axis])


def flip(x, axis=0):
    return Flip(axis)(x)


class Transpose(Operator):
    def __init__(self, perm=None):
        super().__init__()
        self.perm = tuple(perm) if perm is not None else None

    def forward(self, x):
        perm = self.perm if self.perm is not None \
            else tuple(reversed(range(x.dim())))
        return x.permute(perm)


class Concat(Operator):
    def __init__(self, axis=0):
        super().__init__()
        self.axis = axis

    def forward(self, *xs):
        return torch.cat(xs, dim=self.axis)


class Slice(Operator):
    def __init__(self, starts, ends, axes=None, steps=None):
        super().__init__()
        self.starts, self.ends = list(starts), list(ends)
        self.axes = list(axes) if axes is not None \
            else list(range(len(starts)))
        self.steps = list(steps) if steps is not None else [1] * len(starts)

    def forward(self, x):
        for s, e, a, st in zip(self.starts, self.ends, self.axes,
                               self.steps):
            dim = x.shape[a]
            e = builtins.min(e, dim) if e >= 0 else e
            if st > 0:
                idx = [builtins.slice(None)] * x.dim()
                idx[a] = builtins.slice(s, e, st)
                x = x[tuple(idx)]
            else:
                # torch slicing takes no negative step: gather the indices
                keep = list(range(*builtins.slice(s, e, st).indices(dim)))
                x = x.index_select(a, torch.tensor(keep, dtype=torch.long,
                                                   device=x.device))
        return x


class Split(Operator):
    def __init__(self, axis, parts):
        super().__init__()
        self.axis, self.parts = axis, list(parts)

    def forward(self, x):
        return tuple(torch.split(x, self.parts, dim=self.axis))


class Gather(Operator):
    def __init__(self, axis, indices):
        super().__init__()
        self.axis = axis
        self.indices = np.asarray(indices, dtype=np.int64)

    def forward(self, x):
        a = self.axis % x.dim()
        idx = torch.as_tensor(self.indices % x.shape[a], device=x.device)
        y = x.index_select(a, idx.reshape(-1))
        return y.reshape(x.shape[:a] + idx.shape + x.shape[a + 1:])


class Tile(Operator):
    def __init__(self, repeats):
        super().__init__()
        self.repeats = tuple(repeats)

    def forward(self, x):
        return torch.tile(x, self.repeats)


class Expand(Operator):
    def __init__(self, shape):
        super().__init__()
        self.shape = tuple(shape)

    def forward(self, x):
        return torch.broadcast_to(
            x, torch.broadcast_shapes(tuple(x.shape), self.shape))


class Pad(Operator):
    """ONNX pads [begin_0, ..., begin_n-1, end_0, ..., end_n-1]."""

    _TORCH_MODE = {"constant": "constant", "reflect": "reflect",
                   "edge": "replicate"}

    def __init__(self, mode, pads, constant=0.0):
        super().__init__()
        if mode not in self._TORCH_MODE:
            raise KeyError(mode)
        self.mode = mode         # the ONNX name, which the exporter writes
        self.pads = [int(p) for p in pads]
        self.constant = constant

    def forward(self, x):
        n = x.dim()
        tp = []                  # torch order: last dim first
        for i in reversed(range(n)):
            tp += [self.pads[i], self.pads[i + n]]
        if self.mode == "constant":
            return F.pad(x, tp, value=self.constant)
        while len(tp) > 2 and tp[-1] == 0 and tp[-2] == 0:
            tp = tp[:-2]         # torch pads only trailing dims so
        return F.pad(x, tp, mode=self._TORCH_MODE[self.mode])


class Cast(Operator):
    never_requires_grad = True

    def __init__(self, to):
        super().__init__()
        self.to = to

    def forward(self, x):
        return x.to(_resolve_dtype(self.to))


class Where(Operator):
    def __init__(self, condition):
        super().__init__()
        self.condition = _raw(condition)

    def forward(self, a, b):
        cond = torch.as_tensor(self.condition, device=a.device).bool()
        return torch.where(cond, a, b)


class Ceil(Operator):
    never_requires_grad = True

    def forward(self, x):
        return torch.ceil(x)


class Floor(Operator):
    never_requires_grad = True

    def forward(self, x):
        return torch.floor(x)


class Round(Operator):
    never_requires_grad = True

    def forward(self, x):
        return torch.round(x)


class Rounde(Operator):
    """Round half to even (torch.round is half to even)."""
    never_requires_grad = True

    def forward(self, x):
        return torch.round(x)


class Clip(Operator):
    def __init__(self, min=None, max=None):  # noqa: A002
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return torch.clamp(x, self.min, self.max)


class Identity(Operator):
    def forward(self, x):
        return x


# ---- reductions ----------------------------------------------------------

class Mean(Operator):
    def forward(self, *xs):
        return builtins.sum(xs) / len(xs)


class Sum(Operator):
    def forward(self, *xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out


class Min(Operator):
    def forward(self, a, b):
        return torch.minimum(a, b)


class Max(Operator):
    def forward(self, a, b):
        return torch.maximum(a, b)


class ReduceSum(Operator):
    def __init__(self, axes=None, keepdims=True):
        super().__init__()
        self.axes = tuple(axes) if axes is not None else None
        self.keepdims = bool(keepdims)

    def forward(self, x):
        axes = self.axes if self.axes is not None else tuple(range(x.dim()))
        return torch.sum(x, dim=axes, keepdim=self.keepdims)


class ReduceMean(ReduceSum):
    def forward(self, x):
        axes = self.axes if self.axes is not None else tuple(range(x.dim()))
        return torch.mean(x, dim=axes, keepdim=self.keepdims)


# ---- linear algebra ------------------------------------------------------

class _MatmulF32(torch.autograd.Function):
    """x @ W accumulated and returned in fp32 whatever the inputs' dtype
    (the JAX package's `preferred_element_type=float32` on the loss
    head): on CUDA through `torch.mm(out_dtype=float32)`, on the CPU by
    upcasting both operands; both give the fp32 product of the same
    values. The gradients go back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, W):
        ctx.save_for_backward(x, W)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda and x.dtype != torch.float32:
            y = torch.mm(x2, W, out_dtype=torch.float32)
        else:
            y = x2.float() @ W.float()
        return y.reshape(*x.shape[:-1], W.shape[1])

    @staticmethod
    def backward(ctx, dy):
        x, W = ctx.saved_tensors
        g = dy.to(x.dtype).reshape(-1, dy.shape[-1])
        dx = (g @ W.t()).reshape(x.shape)
        dW = x.reshape(-1, x.shape[-1]).t() @ g
        return dx, dW


class Matmul(Operator):
    """a @ b; out_dtype="float32" with a 2-D b returns the product
    accumulated in fp32 whatever the inputs' dtype (loss heads under the
    amp policy)."""

    def __init__(self, out_dtype=None):
        super().__init__()
        self.out_dtype = out_dtype

    def forward(self, a, b):
        if self.out_dtype == "float32":
            return _MatmulF32.apply(a, b)
        return a @ b


class Gemm(Operator):
    def __init__(self, alpha=1.0, beta=1.0, transA=0, transB=0):
        super().__init__()
        self.alpha, self.beta = alpha, beta
        self.transA, self.transB = transA, transB

    def forward(self, A, B, C=None):
        if self.transA:
            A = A.t()
        if self.transB:
            B = B.t()
        y = self.alpha * (A @ B)
        if C is not None:
            y = y + self.beta * C
        return y


class AddBias(Operator):
    def __init__(self, axis=0):
        super().__init__()
        self.axis = axis

    def forward(self, x, b):
        if self.axis == 0:
            return x + b  # per-column bias (broadcast over rows)
        return x + b[:, None]


class CosSim(Operator):
    def forward(self, a, b):
        num = torch.sum(a * b, dim=-1)
        den = torch.linalg.vector_norm(a, dim=-1) \
            * torch.linalg.vector_norm(b, dim=-1)
        return num / den


# ---- losses --------------------------------------------------------------

class MeanSquareError(Operator):
    def forward(self, x, t):
        # 0.5 * ||x - t||^2 / batch
        return 0.5 * torch.sum(torch.square(x - t)) / x.shape[0]


class CrossEntropy(Operator):
    """CE on probabilities."""

    def forward(self, p, t):
        return -torch.sum(t * torch.log(p + 1e-10)) / p.shape[0]


class BinaryCrossEntropy(Operator):
    def forward(self, x, t):
        eps = 1e-10
        per = -(t * torch.log(x + eps) + (1 - t) * torch.log(1 - x + eps))
        return torch.sum(per) / x.shape[0]


class RankingLoss(Operator):
    def __init__(self, M=0.2):
        super().__init__()
        self.M = M

    def forward(self, pos, neg):
        return torch.mean(torch.clamp(self.M - (pos - neg), min=0.0))


class _SoftMaxCE(torch.autograd.Function):
    """Fused stable softmax cross-entropy, the mean over every leading
    dim, with the JAX package's hand backward: an fp32 island under the
    bf16 policy; dx = (softmax - onehot) * dy / n in the input's dtype."""

    @staticmethod
    def forward(ctx, x, t):
        x32 = x.float()
        ctx.save_for_backward(x32, t)
        ctx.in_dtype = x.dtype
        return softmax_cross_entropy_fwd(x32, t).mean()

    @staticmethod
    def backward(ctx, dy):
        x32, t = ctx.saved_tensors
        n = x32[..., 0].numel() if x32.dim() > 1 else 1
        dx = softmax_cross_entropy_bwd(x32, t) * (dy / n)
        return dx.to(ctx.in_dtype), None


class SoftMaxCrossEntropy(Operator):
    """Mean softmax cross-entropy of logits (..., V) against class
    indices (...) or one-hot rows; fp32 inside (`_SoftMaxCE`)."""

    def forward(self, x, t):
        return _SoftMaxCE.apply(x, t)


# ---- NN ops ------------------------------------------------------------------

def _odd_pads(padding, odd_padding):
    """(left, right, top, bottom) pads for F.pad: the symmetric padding
    plus the SAME modes' per-side extra."""
    ph, pw = padding
    l, r, t, b = odd_padding
    return (pw + l, pw + r, ph + t, ph + b)


class _Conv2d(Operator):
    """NCHW convolution (the JAX package's lax.conv_general_dilated):
    torch's conv takes only symmetric padding, so the SAME modes' odd,
    per-side padding is applied first with F.pad."""

    def __init__(self, stride=(1, 1), padding=(0, 0), group=1,
                 odd_padding=None, dilation=(1, 1)):
        super().__init__()
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.group = group
        self.odd_padding = odd_padding  # (l, r, t, b) extra pad for SAME
        self.dilation = tuple(dilation)

    def forward(self, x, W, b=None):
        pad = self.padding
        if self.odd_padding is not None:
            x = F.pad(x, _odd_pads(pad, self.odd_padding))
            pad = (0, 0)
        return F.conv2d(x, W, b, self.stride, pad, self.dilation, self.group)


class _BatchNorm2d(Operator):
    """Train-mode batch norm with the batch's statistics, gradients
    flowing through them. Batch-norm statistics: like the JAX package it
    normalizes with the BIASED batch variance, in fp32 whatever the
    input's dtype (torch computes a bf16 input's statistics and
    normalization in fp32 and rounds the output once). F.batch_norm gets
    no running stats, so it updates none: it would use the unbiased
    variance and the other sense of momentum; `batchnorm_2d` updates them
    as the JAX package does."""

    def __init__(self, eps=1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x, gamma, beta):
        return F.batch_norm(x, None, None, gamma, beta, training=True,
                            eps=self.eps)


class _BatchNorm2dInfer(Operator):
    def __init__(self, eps=1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x, gamma, beta, mean, var):
        shape = (1, -1, 1, 1) if x.dim() == 4 else (1, -1)
        xn = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                     + self.eps)
        return xn * gamma.reshape(shape) + beta.reshape(shape)


class _Pooling2d(Operator):
    """Max or average pooling. Average pooling divides by the number of
    the window's elements inside the input (count_include_pad=False, as
    the JAX package's reduce_window does; torch's avg_pool2d defaults to
    True). Symmetric padding of at most half the window is torch's own;
    the SAME modes' odd padding and wider padding, which torch's pooling
    does not take, are applied first with F.pad (-inf for max)."""

    def __init__(self, kernel, stride, padding=(0, 0), is_max=True,
                 count_include_pad=False, odd_padding=None):
        super().__init__()
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.is_max = is_max
        self.count_include_pad = count_include_pad
        self.odd_padding = odd_padding  # (l, r, t, b) extra for SAME modes

    def forward(self, x):
        ph, pw = self.padding
        kh, kw = self.kernel
        if self.odd_padding is None and 2 * ph <= kh and 2 * pw <= kw:
            # symmetric padding within half the window: torch's own
            # (max: -inf outside; avg: count_include_pad as given)
            if self.is_max:
                return F.max_pool2d(x, self.kernel, self.stride,
                                    self.padding)
            return F.avg_pool2d(x, self.kernel, self.stride, self.padding,
                                count_include_pad=self.count_include_pad)
        pads = _odd_pads(self.padding, self.odd_padding or (0, 0, 0, 0))
        if self.is_max:
            fill = float("-inf") if x.is_floating_point() \
                else torch.iinfo(x.dtype).min
            return F.max_pool2d(F.pad(x, pads, value=fill), self.kernel,
                                self.stride)
        s = F.avg_pool2d(F.pad(x, pads), self.kernel, self.stride,
                         divisor_override=1)
        if self.count_include_pad:
            return s / (kh * kw)
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        cnt = F.avg_pool2d(F.pad(ones, pads), self.kernel, self.stride,
                           divisor_override=1)
        return s / cnt


class GlobalAveragePool(Operator):
    def forward(self, x):
        return torch.mean(x, dim=tuple(range(2, x.dim())), keepdim=True)


class Dropout(Operator):
    """Train-mode dropout: keep each element with probability 1 - ratio
    (a draw from `generator`, the device's) and scale it by 1 / keep."""

    def __init__(self, ratio=0.5, generator=None):
        super().__init__()
        self.ratio = ratio
        self.generator = generator

    def forward(self, x):
        if not training or self.ratio == 0.0:
            return x
        keep = 1.0 - self.ratio
        mask = torch.rand(x.shape, device=x.device,
                          generator=self.generator) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Embedding(Operator):
    """Row gather; the table's gradient is a scatter-add."""

    def forward(self, ids, table):
        return table[ids.long()]


class LayerNorm(Operator):
    """Normalize over the last axis as an fp32 island (biased variance),
    output in the input's dtype: a variance in bf16 is lossy."""

    def __init__(self, eps=1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x, gamma, beta):
        return _layernorm(x, gamma, beta, self.eps)


def _layernorm(x, gamma, beta, eps=1e-5):
    """LayerNorm on raw tensors (the decode path calls it directly)."""
    x32 = x.float()
    m = x32.mean(dim=-1, keepdim=True)
    v = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - m) * torch.rsqrt(v + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)


def _top_k(x, k):
    """(values, indices) of the k largest along the last dim, ties to the
    lower index first, as lax.top_k orders them (torch.topk promises no
    order among equal values)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _gelu(x):
    """GELU with the tanh approximation, jax.nn.gelu's default."""
    return F.gelu(x, approximate="tanh")


class Gelu(Operator):
    def forward(self, x):
        return _gelu(x)


# ---- tensor and vocab parallelism (JAX autograd.py:1046-1226) --------------
# Each operator finds its bound axis at the forward (`parallel.mesh`: the
# graph-mode step binds its DistOpt's mesh, `Mesh.bind()` binds one
# explicitly) and runs its collectives over that axis's process group,
# as torch.autograd.Functions whose backwards are the JAX package's hand
# rules.


def axis_bound(name: str) -> bool:
    """True iff a mesh with axis `name` is bound (`Mesh.bind()`; the JAX
    package's: inside a shard_map over it)."""
    from .parallel.mesh import bound_mesh
    return bound_mesh(name) is not None


def _seq_offset(seq_axis, length: int) -> int:
    """The global position of this rank's first of `length` positions:
    axis_index * length while `seq_axis` is bound (a sequence-sharded
    block), else 0 (the JAX package's `lax.axis_index` with its
    NameError caught)."""
    if seq_axis is None or not axis_bound(seq_axis):
        return 0
    from .parallel.mesh import axis_index
    return axis_index(seq_axis) * length


class _TPCopy(Operator):
    """Megatron's `f`: identity forward, all-reduce backward over the TP
    axis, on the replicated input of a column-parallel matmul."""

    def __init__(self, axis):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        from .parallel.tp import megatron_f
        return megatron_f(x, self.axis)


class _TPReduce(Operator):
    """Megatron's `g`: all-reduce forward over the TP axis, identity
    backward, on the partial output of a row-parallel matmul."""

    def __init__(self, axis):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        from .parallel.tp import megatron_g
        return megatron_g(x, self.axis)


def tp_copy(x, axis):
    return _TPCopy(axis)(x)


def tp_reduce(x, axis):
    return _TPReduce(axis)(x)


class _VPEmbedding(torch.autograd.Function):
    """The masked gather of this rank's rows and the all-reduce that
    assembles the activations; backward: the hand rule, a local
    scatter-add of the masked rows into this rank's table shard (the
    cotangent is replicated already, so no second reduction)."""

    @staticmethod
    def forward(ctx, ids, table, ax):
        from .parallel.tp import _psum
        vp = table.shape[0]
        local = ids.long() - ax.index * vp
        ok = (local >= 0) & (local < vp)
        safe = local.clamp(0, vp - 1)
        out = table[safe]
        out = torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype,
                                                          device=out.device))
        ctx.save_for_backward(safe, ok)
        ctx.table_shape, ctx.table_dtype = tuple(table.shape), table.dtype
        return _psum(out, ax)

    @staticmethod
    def backward(ctx, dy):
        safe, ok = ctx.saved_tensors
        dyv = torch.where(ok[..., None], dy,
                          torch.zeros((), dtype=dy.dtype, device=dy.device))
        dtable = torch.zeros(ctx.table_shape, dtype=dy.dtype,
                             device=dy.device).index_add_(
            0, safe.reshape(-1), dyv.reshape(-1, dy.shape[-1]))
        return None, dtable.to(ctx.table_dtype), None


class _VocabParallelEmbedding(Operator):
    """Megatron vocab-parallel embedding: the (V, E) table is row-sharded
    over the TP axis (spec (tp_axis, None)); each rank gathers only the
    ids that land in its rows and one all-reduce assembles the
    activations. Embedding gradients never cross the axis."""

    def __init__(self, axis):
        super().__init__("VocabParallelEmbedding")
        self.axis = axis

    def forward(self, ids, table):
        from .parallel.tp import _axis
        return _VPEmbedding.apply(ids, table, _axis(self.axis))


class _VocabParallelSCE(Operator):
    """Fused softmax cross-entropy over vocab-sharded logits: x is this
    rank's (N, V/tp) slice, t the global target ids; one all-reduce of a
    value a row each for the max, the sum of exponentials and the
    target's logit, so the full (N, V) logits never exist on any rank.
    Columns at global index >= valid_vocab (padding) are masked out. The
    math is `parallel.tp.vp_ce_forward`/`vp_ce_backward`, fp32 residuals
    and gradient in x's dtype."""

    def __init__(self, axis, valid_vocab=None):
        super().__init__("VocabParallelSCE")
        self.axis = axis
        self.valid_vocab = valid_vocab

    def forward(self, x, t):
        from .parallel.tp import vocab_parallel_ce
        if x.dim() != 2:
            raise ValueError("flatten logits to (N, V/tp) first")
        return vocab_parallel_ce(x, t, self.axis, self.valid_vocab)


class _GatherLast(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ax):
        from .parallel.tp import _gather_dim
        ctx.ax, ctx.local = ax, x.shape[-1]
        return _gather_dim(x, ax, x.dim() - 1)

    @staticmethod
    def backward(ctx, dy):
        # the cotangent is replicated: each rank keeps its own slice
        return dy.narrow(dy.dim() - 1, ctx.ax.index * ctx.local,
                         ctx.local), None


class _GatherLastDim(Operator):
    """All-gather of the shards over `axis` onto the last dim (tiled): the
    full logits from a vocab-parallel head, for the caller. Backward: the
    rank's slice of the replicated cotangent."""

    def __init__(self, axis):
        super().__init__("GatherLastDim")
        self.axis = axis

    def forward(self, x):
        from .parallel.tp import _axis
        return _GatherLast.apply(x, _axis(self.axis))


class _VocabParallelArgmax(Operator):
    """Global argmax over vocab-sharded logits: each rank reduces its
    (..., V/tp) slice, a (tp, ...) all-gather of the per-shard winners
    picks the global one (int32). Ties go to the lowest global index, as
    in the JAX package: argmax keeps the first maximum in a slice and
    across the slices."""

    never_requires_grad = True

    def __init__(self, axis, valid_vocab=None):
        super().__init__("VocabParallelArgmax")
        self.axis = axis
        self.valid_vocab = valid_vocab

    def forward(self, x):
        from .parallel.tp import _axis, _stack
        ax = _axis(self.axis)
        vp = x.shape[-1]
        off = ax.index * vp
        if self.valid_vocab is not None:
            gcol = off + torch.arange(vp, device=x.device)
            x = torch.where(gcol < self.valid_vocab, x,
                            torch.full_like(x, -float("inf")))
        v = torch.max(x, dim=-1).values
        a = torch.argmax(x, dim=-1).to(torch.int32) + off
        vs, gs = _stack(v, ax), _stack(a, ax)         # (tp, ...)
        w = torch.argmax(vs, dim=0)
        return torch.gather(gs, 0, w[None].long())[0]


def vocab_parallel_embedding(ids, table, axis):
    return _VocabParallelEmbedding(axis)(ids, table)


def vocab_parallel_argmax(x, axis, valid_vocab=None):
    return _VocabParallelArgmax(axis, valid_vocab)(x)


def vocab_parallel_sce(x, t, axis, valid_vocab=None):
    return _VocabParallelSCE(axis, valid_vocab)(x, t)


def gather_last(x, axis):
    return _GatherLastDim(axis)(x)


class _FlashAttention(Operator):
    """Fused attention (B, H, S, D): forward K1, backward K2a or K2b + K2c
    (ops.attention.FlashAttention); the plain versions on CPU tensors or
    with use_kernel=False."""

    def __init__(self, causal=False, use_kernel=None):
        super().__init__()
        self.causal = causal
        self.use_kernel = use_kernel

    def forward(self, q, k, v):
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), self.causal,
                               use_kernel=self.use_kernel)


class _RingAttention(Operator):
    """Sequence-parallel attention over the mesh axis `axis_name`
    (ops.attention.ring_attention: K1 and K2 per hop) while the axis is
    bound; unbound (parameter init, a serial run), full attention
    through `_FlashAttention`'s path, which the ring equals there."""

    def __init__(self, axis_name, causal=False, use_kernel=None):
        super().__init__()
        self.axis_name = axis_name
        self.causal = causal
        self.use_kernel = use_kernel

    def forward(self, q, k, v):
        if not axis_bound(self.axis_name):
            return flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), self.causal,
                                   use_kernel=self.use_kernel)
        from .ops.attention import ring_attention
        return ring_attention(q, k, v, self.axis_name, self.causal,
                              use_kernel=self.use_kernel)


class ComputeCast(Operator):
    """Float -> float cast on the tape; its gradient is cast back to the
    input's dtype (torch's `to`), so a master weight's grad arrives fp32."""

    def __init__(self, to):
        super().__init__()
        self.to = to

    def forward(self, x):
        return x.to(self.to)


# ======================= functional wrappers ==============================

add = _functional(Add)
sub = _functional(Sub)
mul = _functional(Mul)
div = _functional(Div)
negative = _functional(Negative)
reciprocal = _functional(Reciprocal)
abs = _functional(Abs)  # noqa: A001
sign = _functional(Sign)
exp = _functional(Exp)
log = _functional(Log)
sqrt = _functional(Sqrt)
pow = _functional(Pow)  # noqa: A001
less = _functional(Less)
greater = _functional(Greater)
equal = _functional(Equal)

relu = _functional(ReLU)
sigmoid = _functional(Sigmoid)
tanh = _functional(Tanh)
softplus = _functional(SoftPlus)
softsign = _functional(SoftSign)
cos = _functional(Cos)
cosh = _functional(Cosh)
acos = _functional(Acos)
acosh = _functional(Acosh)
sin = _functional(Sin)
sinh = _functional(Sinh)
asin = _functional(Asin)
asinh = _functional(Asinh)
tan = _functional(Tan)
atan = _functional(Atan)
atanh = _functional(Atanh)
erf = _functional(Erf)
matmul = _functional(Matmul)
cossim = _functional(CosSim)
identity = _functional(Identity)
mean = _functional(Mean)


def elu(x, alpha=1.0):
    return Elu(alpha)(x)


def selu(x, alpha=1.67326, gamma=1.0507):
    return SeLU(alpha, gamma)(x)


def leakyrelu(x, a=0.01):
    return LeakyRelu(a)(x)


def prelu(x, slope):
    return PRelu()(x, slope)


def hardsigmoid(x, alpha=0.2, gamma=0.5):
    return HardSigmoid(alpha, gamma)(x)


def softmax(x, axis=1):
    return SoftMax(axis)(x)


def reshape(x, shape):
    return Reshape(shape)(x)


def flatten(x, axis=1):
    return Flatten(axis)(x)


def squeeze(x, axis=None):
    return Squeeze(axis)(x)


def unsqueeze(x, axis):
    return Unsqueeze(axis)(x)


def transpose(x, perm=None):
    return Transpose(perm)(x)


def cat(xs, axis=0):
    return Concat(axis)(*xs)


concat = cat


def slice(x, starts, ends, axes=None, steps=None):  # noqa: A001
    return Slice(starts, ends, axes, steps)(x)


def split(x, axis, parts):
    return Split(axis, parts)(x)


def gather(x, axis, indices):
    return Gather(axis, indices)(x)


def tile(x, repeats):
    return Tile(repeats)(x)


def expand(x, shape):
    return Expand(shape)(x)


def pad(x, mode, pads, constant=0.0):
    return Pad(mode, pads, constant)(x)


def clip(x, min=None, max=None):  # noqa: A002
    return Clip(min, max)(x)


def cast(x, to):
    return Cast(to)(x)


def where(condition, a, b):
    return Where(condition)(a, b)


def min(a, b):  # noqa: A001
    return Min()(a, b)


def max(a, b):  # noqa: A001
    return Max()(a, b)


def reduce_sum(x, axes=None, keepdims=True):
    return ReduceSum(axes, keepdims)(x)


def reduce_mean(x, axes=None, keepdims=True):
    return ReduceMean(axes, keepdims)(x)


def gemm(A, B, C=None, alpha=1.0, beta=1.0, transA=0, transB=0):
    op = Gemm(alpha, beta, transA, transB)
    return op(A, B) if C is None else op(A, B, C)


def add_bias(x, b, axis=0):
    return AddBias(axis)(x, b)


def mse_loss(x, t):
    return MeanSquareError()(x, t)


def cross_entropy(p, t):
    return CrossEntropy()(p, t)


def binary_cross_entropy(x, t):
    return BinaryCrossEntropy()(x, t)


def ranking_loss(pos, neg, M=0.2):
    return RankingLoss(M)(pos, neg)


def softmax_cross_entropy(x, t):
    return SoftMaxCrossEntropy()(x, t)


def conv2d(handle, x, W, b=None):
    """handle: a layer-owned geometry (stride, padding, group,
    odd_padding, dilation)."""
    op = _Conv2d(handle.stride, handle.padding, handle.group,
                 handle.odd_padding, getattr(handle, "dilation", (1, 1)))
    return op(x, W, b) if b is not None else op(x, W)


@torch.no_grad()
def _update_running(x, running_mean, running_var, momentum):
    """running = momentum * running + (1 - momentum) * batch statistic,
    with the BIASED batch variance and in fp32 (the JAX package's
    batchnorm_2d); in place."""
    xd = _raw(x).detach().to(running_mean.dtype)
    axes = (0, 2, 3) if xd.dim() == 4 else (0,)
    bv, bm = torch.var_mean(xd, dim=axes, correction=0)
    running_mean.mul_(momentum).add_((1 - momentum) * bm)
    running_var.mul_(momentum).add_((1 - momentum) * bv)


def batchnorm_2d(x, gamma, beta, running_mean, running_var, momentum=0.9,
                 eps=1e-5, train: bool = True):
    """Returns (y, running_mean, running_var). In training the running
    statistics (raw tensors, the layer's buffers) are updated in place
    as the JAX package updates them (`_update_running`); in eval y uses
    them."""
    rm, rv = _raw(running_mean), _raw(running_var)
    if train:
        op = _BatchNorm2d(eps)
        # the running statistics and momentum, for the ONNX exporter (its
        # BatchNormalization node takes all five inputs)
        op._bn_extras = (rm, rv)
        op._bn_momentum = momentum
        y = op(x, gamma, beta)
        _update_running(x, rm, rv, momentum)
        return y, rm, rv
    y = _BatchNorm2dInfer(eps)(x, gamma, beta, running_mean, running_var)
    return y, rm, rv


def pooling_2d(x, kernel, stride, padding=(0, 0), is_max=True,
               odd_padding=None):
    return _Pooling2d(kernel, stride, padding, is_max,
                      odd_padding=odd_padding)(x)


def globalaveragepool(x):
    return GlobalAveragePool()(x)


def dropout(x, ratio=0.5):
    gen = None
    if training and ratio > 0.0:
        gen = x.device.generator if isinstance(x, Tensor) \
            else device_module.of(x.device).generator
    return Dropout(ratio, gen)(x)


def embedding(indices, table):
    return Embedding()(indices, table)


def layernorm(x, gamma, beta, eps=1e-5):
    return LayerNorm(eps)(x, gamma, beta)


def gelu(x):
    """On a raw tensor (the decode loop's MLP) the function itself, with
    no operator made."""
    return Gelu()(x) if isinstance(x, Tensor) else _gelu(x)


def attention(q, k, v, causal=False, seq_axis=None, use_kernel=None):
    """Fused attention (B, H, S, D) through the flash kernels: K1 forward,
    its backward K2a or K2b + K2c. `seq_axis` names a mesh axis for ring
    (sequence-parallel) execution: q, k, v are then this rank's sequence
    shards while the axis is bound."""
    if seq_axis is not None:
        return _RingAttention(seq_axis, causal, use_kernel)(q, k, v)
    return _FlashAttention(causal, use_kernel)(q, k, v)


def compute_cast(*xs):
    """Cast floating tensors (Tensors or raw) to the active compute dtype;
    a no-op when the policy is off, for None, and for tensors already in
    it."""
    if compute_dtype is None:
        return xs if len(xs) > 1 else xs[0]
    tgt = getattr(torch, compute_dtype)
    out = tuple(ComputeCast(tgt)(x) if x is not None
                and _raw(x).is_floating_point() and _raw(x).dtype != tgt
                else x for x in xs)
    return out if len(out) > 1 else out[0]


def rope_tables(positions, dim, theta=10000.0):
    """(cos, sin) tables for NeoX-style rotary embeddings: positions (S,)
    -> (S, dim) fp32 with the two half-blocks duplicated (cos = [c | c])."""
    half = dim // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=positions.device) / half)
    ang = positions.to(torch.float32)[:, None] * inv[None, :]
    cos = torch.cat([torch.cos(ang), torch.cos(ang)], dim=-1)
    sin = torch.cat([torch.sin(ang), torch.sin(ang)], dim=-1)
    return cos, sin


def apply_rope(x, cos, sin):
    """Rotate (..., S, D) by per-position tables (S, D), NeoX halves:
    out = x*cos + rotate_half(x)*sin, rotate_half = [-x2 | x1]; fp32 math,
    result in x's dtype."""
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


# ---- reference-name functional parity ----------------------------------------

def axis_helper(y_shape, x_shape):
    """Axes along which x was broadcast to produce y."""
    res = []
    j = len(x_shape) - 1
    for i in range(len(y_shape) - 1, -1, -1):
        if j < 0 or x_shape[j] != y_shape[i]:
            res.append(i)
        j -= 1
    return tuple(res[::-1])


def back_broadcast(y_shape, x_shape, x):
    """Reduce a broadcast result back to x_shape."""
    if tuple(y_shape) == tuple(x_shape):
        return x
    y = reduce_sum(x, axes=axis_helper(y_shape, x_shape), keepdims=False)
    return reshape(y, x_shape)


def sum(*xs):  # noqa: A001  (name mandated by reference parity)
    """Element-wise sum of the input tensors."""
    return Sum()(*xs)


def add_all(*xs):
    assert len(xs) > 2
    y = add(xs[0], xs[1])
    for x in xs[2:]:
        y = add(y, x)
    return y


def ctensor2numpy(x):
    """Raw backing tensor -> numpy."""
    return x.detach().cpu().numpy()


def ceil(x):
    return Ceil()(x)


def floor(x):
    return Floor()(x)


def round(x):  # noqa: A001  (name mandated by reference parity)
    return Round()(x)


def rounde(x):
    return Rounde()(x)


# ======================= the operators only ONNX reaches ====================
# Counterparts of the JAX package's UpSample ... LessOrEqual and Rope
# (singa_tpu/autograd.py): the ONNX backend's handlers and the exporter
# reach them. Forwards are torch ops; torch autograd gives the gradients,
# which match the JAX vjps (TopK's values scatter back through the
# selected slots, as the JAX hand backward does).

_INDEX = torch.int32     # the JAX package's integer outputs with x64 off


def _axes(x, axes):
    return tuple(range(x.dim())) if axes is None else tuple(axes)


def _index_tensor(indices, x, axis):
    """Host indices as a long tensor on x's device, negatives wrapped."""
    idx = torch.as_tensor(np.asarray(indices, np.int64), device=x.device)
    return idx % x.shape[axis]


class UpSample(Operator):
    def __init__(self, scales, mode="nearest"):
        super().__init__()
        self.scales = [float(s) for s in scales]
        if mode != "nearest":
            raise ValueError("only nearest upsample is supported")

    def forward(self, x):
        for a, s in enumerate(self.scales):
            if s != 1.0:
                x = x.repeat_interleave(int(s), dim=a)
        return x


class DepthToSpace(Operator):
    def __init__(self, blocksize, mode="DCR"):
        super().__init__()
        self.b, self.mode = blocksize, mode

    def forward(self, x):
        n, c, h, w = x.shape
        b = self.b
        if self.mode == "DCR":
            y = x.reshape(n, b, b, c // (b * b), h, w)
            y = y.permute(0, 3, 4, 1, 5, 2)
        else:  # CRD
            y = x.reshape(n, c // (b * b), b, b, h, w)
            y = y.permute(0, 1, 4, 2, 5, 3)
        return y.reshape(n, c // (b * b), h * b, w * b)


class SpaceToDepth(Operator):
    def __init__(self, blocksize):
        super().__init__()
        self.b = blocksize

    def forward(self, x):
        n, c, h, w = x.shape
        b = self.b
        y = x.reshape(n, c, h // b, b, w // b, b)
        y = y.permute(0, 3, 5, 1, 2, 4)
        return y.reshape(n, c * b * b, h // b, w // b)


class Shape(Operator):
    never_requires_grad = True

    def forward(self, x):
        return torch.tensor(tuple(x.shape), dtype=_INDEX, device=x.device)


class NonZero(Operator):
    """Indices of the non-zero elements, (ndim, n): a data-dependent
    shape, so it runs eagerly (the JAX package computes it on the host)
    and raises inside a CUDA-graph capture."""
    never_requires_grad = True

    def forward(self, x):
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "NonZero has a data-dependent output shape and cannot be "
                "captured in a CUDA graph; run this graph eagerly "
                "(compile(..., use_graph=False))")
        return torch.stack(torch.nonzero(x, as_tuple=True)).to(_INDEX)


class OneHot(Operator):
    """jax.nn.one_hot: an index outside [0, depth) gives a row of `off`."""
    never_requires_grad = True

    def __init__(self, depth, values=(0.0, 1.0), axis=-1):
        super().__init__()
        self.depth, self.values, self.axis = depth, values, axis

    def forward(self, idx):
        off, on = (float(v) for v in self.values)
        classes = torch.arange(self.depth, device=idx.device)
        oh = (idx.long().unsqueeze(-1) == classes).float()
        if self.axis != -1:
            oh = torch.movedim(oh, -1, self.axis)
        return oh * (on - off) + off


class ConstantOfShape(Operator):
    never_requires_grad = True

    def __init__(self, value=0.0, dtype=torch.float32):
        super().__init__()
        self.value, self.dtype = value, _resolve_dtype(dtype)

    def forward(self, shape):
        return torch.full(tuple(int(s) for s in shape.tolist()), self.value,
                          dtype=self.dtype, device=shape.device)


class ScatterElements(Operator):
    def __init__(self, indices, axis=0):
        super().__init__()
        self.indices = np.asarray(indices, np.int64)
        self.axis = axis

    def forward(self, x, updates):
        a = self.axis % x.dim()
        return x.scatter(a, _index_tensor(self.indices, x, a), updates)


class Rope(Operator):
    """Rotary position embedding on (B, H, S, D) q or k (NeoX halves),
    positions 0..S-1. `seq_axis`: while that mesh axis is bound, x is
    this rank's sequence shard and its positions start at
    axis_index * S (the learned table's `_PosSlice` pattern)."""

    def __init__(self, theta=10000.0, seq_axis=None):
        super().__init__("Rope")
        self.theta = float(theta)
        self.seq_axis = seq_axis

    def forward(self, x):
        S = x.shape[-2]
        off = _seq_offset(self.seq_axis, S)
        cos, sin = rope_tables(torch.arange(off, off + S, device=x.device),
                               x.shape[-1], self.theta)
        return apply_rope(x, cos, sin)


class _ArgReduce(Operator):
    never_requires_grad = True
    _fn = None

    def __init__(self, axis=0, keepdims=True, select_last_index=False):
        super().__init__()
        self.axis, self.keepdims = int(axis), bool(keepdims)
        self.last = bool(select_last_index)

    def forward(self, x):
        # torch's argmax/argmin take the first of equal values
        fn = type(self)._fn
        if self.last:
            n = x.shape[self.axis]
            y = n - 1 - fn(torch.flip(x, (self.axis,)), dim=self.axis)
        else:
            y = fn(x, dim=self.axis)
        y = y.to(_INDEX)
        return y.unsqueeze(self.axis) if self.keepdims else y


class ArgMax(_ArgReduce):
    _fn = staticmethod(torch.argmax)


class ArgMin(_ArgReduce):
    _fn = staticmethod(torch.argmin)


def _prod(x, axes, keepdims):
    for a in sorted((a % x.dim() for a in axes), reverse=True):
        x = torch.prod(x, dim=a, keepdim=True)
    if not keepdims:
        x = x.squeeze(tuple(a % (x.dim()) for a in axes))
    return x


class _Reduce(Operator):
    """Shared shell for the ONNX Reduce* family."""
    _fn = None

    def __init__(self, axes=None, keepdims=True):
        super().__init__()
        self.axes = tuple(int(a) for a in axes) if axes is not None else None
        self.keepdims = bool(keepdims)

    def forward(self, x):
        return type(self)._fn(x, _axes(x, self.axes), self.keepdims)


class ReduceMax(_Reduce):
    _fn = staticmethod(lambda x, a, k: torch.amax(x, dim=a, keepdim=k))


class ReduceMin(_Reduce):
    _fn = staticmethod(lambda x, a, k: torch.amin(x, dim=a, keepdim=k))


class ReduceProd(_Reduce):
    _fn = staticmethod(_prod)


class ReduceL1(_Reduce):
    _fn = staticmethod(
        lambda x, a, k: torch.sum(torch.abs(x), dim=a, keepdim=k))


class ReduceL2(_Reduce):
    _fn = staticmethod(
        lambda x, a, k: torch.sqrt(torch.sum(x * x, dim=a, keepdim=k)))


class ReduceLogSum(_Reduce):
    _fn = staticmethod(
        lambda x, a, k: torch.log(torch.sum(x, dim=a, keepdim=k)))


class ReduceLogSumExp(_Reduce):
    _fn = staticmethod(lambda x, a, k: torch.logsumexp(x, dim=a, keepdim=k))


class ReduceSumSquare(_Reduce):
    _fn = staticmethod(lambda x, a, k: torch.sum(x * x, dim=a, keepdim=k))


class LogSoftmax(Operator):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = int(axis)

    def forward(self, x):
        return torch.log_softmax(x, dim=self.axis)


class Hardmax(Operator):
    """One-hot of the first maximum along `axis`."""
    never_requires_grad = True

    def __init__(self, axis=-1):
        super().__init__()
        self.axis = int(axis)

    def forward(self, x):
        idx = torch.argmax(x, dim=self.axis, keepdim=True)
        return torch.zeros_like(x).scatter(self.axis, idx, 1.0)


class HardSwish(Operator):
    def forward(self, x):
        return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


class Celu(Operator):
    def __init__(self, alpha=1.0):
        super().__init__()
        self.alpha = float(alpha)

    def forward(self, x):
        a = self.alpha
        return torch.clamp(x, min=0.0) + torch.clamp(
            a * (torch.exp(x / a) - 1.0), max=0.0)


class ThresholdedRelu(Operator):
    def __init__(self, alpha=1.0):
        super().__init__()
        self.alpha = float(alpha)

    def forward(self, x):
        return torch.where(x > self.alpha, x, torch.zeros_like(x))


class Shrink(Operator):
    def __init__(self, bias=0.0, lambd=0.5):
        super().__init__()
        self.bias, self.lambd = float(bias), float(lambd)

    def forward(self, x):
        zero = torch.zeros_like(x)
        return torch.where(x < -self.lambd, x + self.bias,
                           torch.where(x > self.lambd, x - self.bias, zero))


class Mod(Operator):
    """fmod=1: the sign of the dividend (C's fmod); fmod=0: the sign of
    the divisor (Python's %). Float operands carry gradient (1 for the
    dividend almost everywhere)."""

    def __init__(self, fmod=0):
        super().__init__()
        self.fmod = int(fmod)

    def forward(self, a, b):
        return torch.fmod(a, b) if self.fmod else torch.remainder(a, b)


class CumSum(Operator):
    def __init__(self, axis=0, exclusive=0, reverse=0):
        super().__init__()
        self.axis = int(axis)
        self.exclusive, self.reverse = int(exclusive), int(reverse)

    def forward(self, x):
        ax = self.axis % x.dim()
        if self.reverse:
            x = torch.flip(x, (ax,))
        y = torch.cumsum(x, dim=ax)
        if self.exclusive:
            # shift by one along the axis, a zero first
            y = torch.cat([torch.zeros_like(y.narrow(ax, 0, 1)),
                           y.narrow(ax, 0, y.shape[ax] - 1)], dim=ax)
        if self.reverse:
            y = torch.flip(y, (ax,))
        return y


class EyeLike(Operator):
    never_requires_grad = True

    def __init__(self, k=0, dtype=None):
        super().__init__()
        self.k = int(k)
        self.dtype = dtype

    def forward(self, x):
        n, m = x.shape[-2], x.shape[-1]
        dt = _resolve_dtype(self.dtype) or x.dtype
        ones = torch.ones((n, m), dtype=dt, device=x.device)
        return torch.triu(torch.tril(ones, self.k), self.k)


class Size(Operator):
    never_requires_grad = True

    def forward(self, x):
        return torch.tensor(x.numel(), dtype=_INDEX, device=x.device)


class IsNaN(Operator):
    never_requires_grad = True

    def forward(self, x):
        return torch.isnan(x).float()


class IsInf(Operator):
    never_requires_grad = True

    def __init__(self, detect_negative=1, detect_positive=1):
        super().__init__()
        self.neg, self.pos = bool(detect_negative), bool(detect_positive)

    def forward(self, x):
        hit = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        if self.pos:
            hit = hit | torch.isposinf(x)
        if self.neg:
            hit = hit | torch.isneginf(x)
        return hit.float()


class Trilu(Operator):
    def __init__(self, upper=1, k=0):
        super().__init__()
        self.upper, self.k = int(upper), int(k)

    def forward(self, x):
        return torch.triu(x, self.k) if self.upper else torch.tril(x, self.k)


class GatherElements(Operator):
    """torch.gather along `axis` (ONNX GatherElements)."""

    def __init__(self, axis, indices):
        super().__init__()
        self.axis = int(axis)
        self.indices = np.asarray(indices, np.int64)

    def forward(self, x):
        a = self.axis % x.dim()
        return torch.gather(x, a, _index_tensor(self.indices, x, a))


class TopK(Operator):
    """(values, indices) of the k largest (or smallest) along `axis`;
    equal values in index order, as lax.top_k gives them (`_top_k`). The
    values carry gradient, the int32 indices none."""

    def __init__(self, k, axis=-1, largest=True):
        super().__init__()
        self.k, self.axis, self.largest = int(k), int(axis), bool(largest)

    def forward(self, x):
        ax = self.axis % x.dim()
        xs = torch.movedim(x, ax, -1)
        v, i = _top_k(xs if self.largest else -xs, self.k)
        v = v if self.largest else -v
        return (torch.movedim(v, -1, ax),
                torch.movedim(i, -1, ax).to(_INDEX))


class LRN(Operator):
    """Local response normalization over channels; the ONNX window is
    [c - floor((size-1)/2), c + ceil((size-1)/2)]."""

    def __init__(self, size, alpha=1e-4, beta=0.75, bias=1.0):
        super().__init__()
        self.size = int(size)
        self.alpha, self.beta, self.bias = float(alpha), float(beta), \
            float(bias)

    def forward(self, x):
        half = (self.size - 1) // 2
        sq = F.pad(x * x, (0, 0, 0, 0, half, self.size - 1 - half))
        acc = builtins.sum(sq[:, i:i + x.shape[1]]
                           for i in range(self.size))
        return x / torch.pow(self.bias + self.alpha / self.size * acc,
                             self.beta)


class MeanVarianceNormalization(Operator):
    def __init__(self, axes=(0, 2, 3)):
        super().__init__()
        self.axes = tuple(int(a) for a in axes)

    def forward(self, x):
        v, m = torch.var_mean(x, dim=self.axes, keepdim=True, correction=0)
        return (x - m) / torch.sqrt(v + 1e-9)


class LpNormalization(Operator):
    def __init__(self, axis=-1, p=2):
        super().__init__()
        self.axis, self.p = int(axis), int(p)

    def forward(self, x):
        if self.p == 1:
            n = torch.sum(torch.abs(x), dim=self.axis, keepdim=True)
        else:
            n = torch.sqrt(torch.sum(x * x, dim=self.axis, keepdim=True))
        return x / torch.clamp(n, min=1e-12)


class InstanceNorm2d(Operator):
    """Per-sample, per-channel normalization over H and W (NCHW)."""

    def __init__(self, eps=1e-5):
        super().__init__()
        self.eps = float(eps)

    def forward(self, x, gamma, beta):
        v, m = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
        xhat = (x - m) * torch.rsqrt(v + self.eps)
        return xhat * gamma.reshape(1, -1, 1, 1) + beta.reshape(1, -1, 1, 1)


class _ConvTranspose2d(Operator):
    """Transposed convolution (NCHW) with ONNX's weight layout, (C_in,
    C_out / group, kH, kW), which is torch's; out = (in - 1) * stride -
    2 * pad + dilation * (k - 1) + output_padding + 1."""

    def __init__(self, stride=(1, 1), padding=(0, 0), output_padding=(0, 0),
                 dilation=(1, 1), group=1):
        super().__init__()
        self.stride = tuple(int(s) for s in stride)
        self.padding = tuple(int(p) for p in padding)
        self.output_padding = tuple(int(p) for p in output_padding)
        self.dilation = tuple(int(d) for d in dilation)
        self.group = int(group)

    def forward(self, x, W, b=None):
        return F.conv_transpose2d(x, W, b, self.stride, self.padding,
                                  self.output_padding, self.group,
                                  self.dilation)


class GlobalMaxPool(Operator):
    def forward(self, x):
        return torch.amax(x, dim=(2, 3), keepdim=True)


class Einsum(Operator):
    def __init__(self, equation):
        super().__init__()
        self.equation = equation

    def forward(self, *xs):
        return torch.einsum(self.equation, *xs)


class GreaterOrEqual(_CmpBinary):
    _fn = staticmethod(torch.ge)


class LessOrEqual(_CmpBinary):
    _fn = staticmethod(torch.le)


argmax = _functional(ArgMax)
argmin = _functional(ArgMin)
reduce_max = _functional(ReduceMax)
reduce_min = _functional(ReduceMin)
reduce_prod = _functional(ReduceProd)
log_softmax = _functional(LogSoftmax)
hardswish = _functional(HardSwish)
celu = _functional(Celu)
cumsum = _functional(CumSum)
trilu = _functional(Trilu)
topk = _functional(TopK)
lrn = _functional(LRN)
einsum = _functional(Einsum)
global_max_pool = _functional(GlobalMaxPool)


def upsample(x, mode="nearest", scales=None):
    return UpSample(scales, mode)(x)


def depth_to_space(x, blocksize, mode="DCR"):
    return DepthToSpace(blocksize, mode)(x)


def space_to_depth(x, blocksize):
    return SpaceToDepth(blocksize)(x)


def onehot(depth, indices, values=(0.0, 1.0), axis=-1):
    return OneHot(depth, values, axis)(indices)


def instance_norm(x, gamma, beta, eps=1e-5):
    return InstanceNorm2d(eps)(x, gamma, beta)


def conv_transpose2d(x, W, b=None, stride=(1, 1), padding=(0, 0),
                     output_padding=(0, 0), dilation=(1, 1), group=1):
    op = _ConvTranspose2d(stride, padding, output_padding, dilation, group)
    return op(x, W, b) if b is not None else op(x, W)


def scatter_elements(x, indices, updates, axis=0):
    idx = _raw(indices)
    if torch.is_tensor(idx):
        idx = idx.detach().cpu().numpy()
    return ScatterElements(idx, axis)(x, updates)


def shape(x):
    return Shape()(x)


def constant_of_shape(x, value=0):
    return ConstantOfShape(value)(x)


def nonzero(x):
    return NonZero()(x)
