"""The SINGA layers (counterpart of singa_tpu/layer.py).

A `Layer` is an `nn.Module` with the JAX package's deferred init:
`LayerMeta` wraps `forward` so `initialize(x)` runs once, with the real
input, and creates the parameters (`nn.Parameter`s, fp32 master weights)
and states (buffers) on the input's device, drawn from its `Device`'s
generator with the JAX initializers' formulas. The draws differ from
JAX's, so parity checks carry the weights over (`set_params`,
`set_states`, `Model.load_states`).

Names and order are the JAX package's: `get_params` keys are attribute
paths joined by "." (nn.Module's own naming, in registration order), and
`register_layers` names the stages it registers `<Class>_<i>`, appending
"_" on a clash, so the port registers the same modules under the same
names and a checkpoint crosses between the packages.

Legacy call styles: `Conv2d(in, out, k[, stride[, pad]])` and
`BatchNorm2d(num_features[, momentum])` re-derive the input width at the
first call, as in the JAX package. `Linear(in, out, generator=g)` (and
`Embedding(num, dim, generator=g)`), the GPT's style, draw the weights at
construction from `g`; without a generator they defer like `Linear(out)`.

Under the bf16 policy (`autograd.compute_dtype`) each layer casts where
the JAX layer does: Conv2d and Linear their input, weight and bias;
Embedding the looked-up rows; MultiHeadAttention its input, the four
projections and each bias. Batch norm, LayerNorm and the losses are fp32
islands.

The transformer layers (LayerNorm, MultiHeadAttention, TransformerBlock)
take the JAX package's signatures and defaults and defer their widths to
the first input; the GPT builds them with `dim=` and `generator=`, which
draws the weights at construction. Every step of their forwards is an
autograd operator, so a Tensor input records on the tape (and the ONNX
exporter can write it), while raw torch tensors, the GPT's training and
serving path, take the same torch ops with nothing recorded.
"""

from __future__ import annotations

import functools
import math
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from . import autograd, initializer
from . import device as device_module
from .autograd import _layernorm as layernorm
from .tensor import Tensor, _param_view, _raw


def _uniform(shape, limit, gen):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


def he_uniform(fan_in, fan_out, gen):
    return _uniform((fan_in, fan_out), math.sqrt(6.0 / fan_in), gen)


def glorot_uniform(fan_in, fan_out, gen):
    return _uniform((fan_in, fan_out),
                    math.sqrt(6.0 / (fan_in + fan_out)), gen)


class LayerMeta(type):
    """Wraps forward so initialize() runs once with the real inputs."""

    def __new__(mcs, name, bases, attrs):
        if "forward" in attrs:
            inner = attrs["forward"]

            @functools.wraps(inner)
            def forward(self, *args, **kwargs):
                if not self._initialized:
                    self.initialize(*args, **kwargs)
                    self._initialized = True
                return inner(self, *args, **kwargs)

            attrs["forward"] = forward
        return super().__new__(mcs, name, bases, attrs)


class Layer(nn.Module, metaclass=LayerMeta):
    """A SINGA layer as an nn.Module. The names of its sublayers live in
    nn.Module's registry, so a class attribute would shadow a sublayer
    of the same name: the JAX Layer's `sep` is not carried over (the
    separator is nn.Module's ".")."""

    def __init__(self, name: str | None = None):
        super().__init__()
        self._initialized = False
        self.name = name or type(self).__name__

    # ---- parameters and states, created by initialize() --------------------
    def _new_param(self, attr, shape, like, init=None, value=0.0):
        """An nn.Parameter `attr` of `shape` on `like`'s device, in its
        dtype when floating (else fp32), filled by `init` (an
        initializer, drawing from the input's Device) or with `value`."""
        t = self._new_tensor(shape, like, init, value)
        self.register_parameter(attr, nn.Parameter(t))

    def _new_state(self, attr, shape, like, value):
        self.register_buffer(attr, self._new_tensor(shape, like, None, value))

    @staticmethod
    def _new_tensor(shape, like, init, value):
        x = _raw(like)
        dev = like.device if isinstance(like, Tensor) \
            else device_module.of(x.device)
        dt = x.dtype if x.is_floating_point() else torch.float32
        t = Tensor._wrap(torch.empty(shape, dtype=dt, device=x.device), dev)
        if init is not None:
            init(t)
        else:
            t.set_value(value)
        return t.data

    # ---- lifecycle -----------------------------------------------------------
    def initialize(self, *args, **kwargs):
        pass

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def _deferred(self) -> bool:
        """True while a layer below has parameters still to create."""
        return any(isinstance(m, Layer) and not m._initialized
                   and type(m).initialize is not Layer.initialize
                   for m in self.modules())

    # ---- params / states, under the JAX package's names and order ----------
    def dtype_check(self, *inputs):
        """Coerce all inputs to the first input's dtype, in place."""
        x_dtype = inputs[0].dtype
        for inp in inputs[1:]:
            if inp.dtype != x_dtype:
                inp.to_type(x_dtype)

    def _raw_params(self) -> "OrderedDict[str, torch.Tensor]":
        """{attribute path: nn.Parameter}, own parameters first, then each
        sublayer's in registration order: what the port's internals
        (the optimizer, checkpoints, the exporter) work on."""
        return OrderedDict(self.named_parameters())

    def _raw_states(self) -> "OrderedDict[str, torch.Tensor]":
        """Parameters, then states (buffers), raw."""
        out = self._raw_params()
        out.update(self.named_buffers())
        return out

    def get_params(self) -> "OrderedDict[str, Tensor]":
        """{attribute path: Tensor} in `_raw_params`' order, as the JAX
        package's: each Tensor is a view over the parameter's storage
        (`tensor._param_view`), so `t.numpy()` reads it and
        `t.copy_from_numpy(a)` or `t.set_value(v)` writes it."""
        return OrderedDict((k, _param_view(v))
                           for k, v in self._raw_params().items())

    def get_states(self) -> "OrderedDict[str, Tensor]":
        """Parameters, then states (buffers), as Tensor views."""
        return OrderedDict((k, _param_view(v))
                           for k, v in self._raw_states().items())

    @torch.no_grad()
    def _copy_into(self, own, states, strict):
        for n, v in states.items():
            if n not in own:
                if strict:
                    raise KeyError(f"unknown param {n}; have {list(own)}")
                continue
            src = _raw(v).detach() if isinstance(v, (Tensor, torch.Tensor)) \
                else torch.as_tensor(np.array(v))
            if tuple(src.shape) != tuple(own[n].shape):
                raise ValueError(f"{n}: shape {tuple(src.shape)}, model has "
                                 f"{tuple(own[n].shape)}")
            own[n].copy_(src)

    def set_params(self, params: dict):
        """Copy numpy arrays, Tensors or tensors into the parameters of the
        same name, in place; an unknown name raises."""
        self._copy_into(self._raw_params(), params, strict=True)

    def set_states(self, states: dict):
        """Copy into the states of the same name, in place (so version
        counters move); unknown names are ignored, as in the JAX package;
        a shape mismatch raises."""
        self._copy_into(self._raw_states(), states, strict=False)

    def register_layers(self, *args):
        """Register sublayers held in lists or closures rather than
        attributes (resnet's _make_layer stages): named `<Class>_<i>`, and
        on a clash with an earlier call's names "_" is appended."""
        if len(args) == 1 and isinstance(args[0], OrderedDict):
            items = list(args[0].items())
        else:
            items = [(f"{v.__class__.__name__}_{i}", v)
                     for i, v in enumerate(args)]
        for name, value in items:
            if isinstance(value, Layer):
                while name in self._modules:
                    name += "_"
                self.add_module(name, value)
                value.name = name

    def sublayers(self):
        return dict(self._modules)

    def device_check(self, *xs):
        pass


# ======================= core layers ======================================


class Linear(Layer):
    """y = x W + b, W (in, out). `Linear(out)` draws W at the first call
    (he_uniform); `Linear(in, out, generator=g)`, the GPT's style, at
    construction. `out_dtype="float32"` returns the product accumulated
    in fp32 whatever the input dtype (the GPT head under the bf16
    policy).

    Tensor parallelism: `tp_axis` names the mesh axis W is split over.
    `tp_mode="column"` splits the output features (W and b carry the spec
    (None, tp_axis) and (tp_axis,); the input goes through Megatron's
    `f`); `tp_mode="row"` splits the input features (W (tp_axis, None);
    one all-reduce of the output, Megatron's `g`, then the whole bias).
    The spec rides on the parameter as `.spec`; a model trained on a
    mesh with that axis holds this rank's shard (`Model`). While the
    axis is not bound (`autograd.axis_bound`) the layer runs the dense
    math on the full weight."""

    def __init__(self, out_features, *args, bias=True, name=None,
                 tp_axis=None, tp_mode="column", out_dtype=None,
                 generator=None, **kwargs):
        super().__init__(name)
        self.in_features = None
        if args and isinstance(args[0], int):
            self.in_features, out_features = out_features, args[0]
        self.out_features = out_features
        self.bias = bias
        if tp_mode not in ("column", "row"):
            raise ValueError(f"tp_mode {tp_mode!r}: 'column' or 'row'")
        self.tp_axis = tp_axis
        self.tp_mode = tp_mode
        self.out_dtype = out_dtype
        if generator is not None:
            if self.in_features is None:
                raise ValueError("Linear(in, out, generator=...) draws at "
                                 "construction and needs both widths")
            self.W = nn.Parameter(he_uniform(self.in_features, out_features,
                                             generator))
            self.b = nn.Parameter(torch.zeros(out_features)) \
                if bias else None
            self._set_specs()
            self._initialized = True

    def _set_specs(self):
        if self.tp_axis is None:
            return
        column = self.tp_mode == "column"
        self.W.spec = (None, self.tp_axis) if column else (self.tp_axis, None)
        if self.bias and column:
            self.b.spec = (self.tp_axis,)

    def initialize(self, x):
        fan_in = x.shape[-1]
        if self.in_features not in (None, fan_in):
            raise ValueError(f"Linear({self.in_features}, "
                             f"{self.out_features}) called on width {fan_in}")
        self._new_param("W", (fan_in, self.out_features), x,
                        initializer.he_uniform)
        if self.bias:
            self._new_param("b", (self.out_features,), x)
        self._set_specs()

    def forward(self, x):
        tp = self.tp_axis is not None and autograd.axis_bound(self.tp_axis)
        if tp and self.tp_mode == "column":
            x = autograd.tp_copy(x, self.tp_axis)
        b = self.b if self.bias else None
        x, W, b = autograd.compute_cast(x, self.W, b)
        y = autograd.matmul(x, W, out_dtype=self.out_dtype)
        if tp and self.tp_mode == "row":
            y = autograd.tp_reduce(y, self.tp_axis)
        return autograd.add_bias(y, b) if b is not None else y


class Gemm(Layer):
    """alpha * A'B' + beta * C with optional transposes."""

    def __init__(self, nb_kernels, alpha=1.0, beta=1.0, transA=False,
                 transB=True, bias=True, bias_shape=None, name=None):
        super().__init__(name)
        self.nb_kernels = nb_kernels
        self.alpha, self.beta = alpha, beta
        self.transA, self.transB = int(transA), int(transB)
        self.bias = bias
        self.bias_shape = bias_shape

    def initialize(self, x):
        fan_in = x.shape[-1] if not self.transA else x.shape[0]
        # drawn in (in, out) so he_uniform sees the true fan_in, then laid
        # out (out, in) when transB
        W = self._new_tensor((fan_in, self.nb_kernels), x,
                             initializer.he_uniform, 0.0)
        self.register_parameter("W", nn.Parameter(
            W.t().contiguous() if self.transB else W))
        if self.bias:
            self._new_param("b", self.bias_shape or (1, self.nb_kernels), x)

    def forward(self, x):
        return autograd.gemm(x, self.W, self.b if self.bias else None,
                             self.alpha, self.beta, self.transA, self.transB)


class Embedding(Layer):
    """Token id -> row of a (V, E) table; under the bf16 policy the
    looked-up rows are cast, not the table. With a `generator` the table
    is drawn at construction (glorot_uniform, the GPT's style), else at
    the first call with `initializer_fn` (default glorot_uniform).

    `tp_axis` row-shards the table over that mesh axis (Megatron's
    vocab-parallel embedding, spec (tp_axis, None)): while the axis is
    bound each rank gathers only the ids in its rows and one all-reduce
    assembles the activations. V must divide by the axis size (the GPT's
    `vocab_tp` pads it)."""

    def __init__(self, input_dim, output_dim, initializer_fn=None, name=None,
                 tp_axis=None, generator=None):
        super().__init__(name)
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.initializer_fn = initializer_fn
        self.tp_axis = tp_axis
        if generator is not None:
            self.W = nn.Parameter(glorot_uniform(input_dim, output_dim,
                                                 generator))
            self._set_specs()
            self._initialized = True

    def _set_specs(self):
        if self.tp_axis is not None:
            self.W.spec = (self.tp_axis, None)

    def initialize(self, x):
        # the ids are integers: the table is fp32
        self._new_param("W", (self.input_dim, self.output_dim), x,
                        self.initializer_fn or initializer.glorot_uniform)
        self._set_specs()

    def forward(self, x):
        if self.tp_axis is not None and autograd.axis_bound(self.tp_axis):
            return autograd.compute_cast(autograd.vocab_parallel_embedding(
                x, self.W, self.tp_axis))
        return autograd.compute_cast(autograd.embedding(x, self.W))


class _ConvGeometry:
    """Carries conv geometry (the role of the reference's ConvHandle)."""

    def __init__(self, stride, padding, group, odd_padding=None,
                 dilation=(1, 1)):
        self.stride = stride
        self.padding = padding
        self.group = group
        self.odd_padding = odd_padding
        self.dilation = dilation


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _same_pads(mode, size, kernel, stride):
    """SAME padding: ONNX SAME_UPPER/SAME_LOWER per-side pads (l, r, t, b)
    of an (h, w) input for an effective (dilated) kernel; odd totals put
    the extra on the right/bottom (UPPER) or left/top (LOWER)."""
    (ih, iw), (kh, kw), (sh, sw) = size, kernel, stride
    ph = max((-(-ih // sh) - 1) * sh + kh - ih, 0)
    pw = max((-(-iw // sw) - 1) * sw + kw - iw, 0)
    if mode == "SAME_UPPER":
        return (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)
    return (pw - pw // 2, pw // 2, ph - ph // 2, ph // 2)


class Conv2d(Layer):
    """NCHW convolution with an optional fused relu (`activation`);
    `pad_mode` SAME_UPPER/SAME_LOWER pads per side (odd totals too)."""

    def __init__(self, nb_kernels, kernel_size, *args, stride=1, padding=0,
                 dilation=1, group=1, bias=True, pad_mode="NOTSET",
                 activation="NONE", name=None, **kwargs):
        super().__init__(name)
        # legacy call style Conv2d(in_ch, out_ch, k[, stride[, padding]]);
        # in_ch is re-derived from the input
        if len(args) > 0:
            nb_kernels = kernel_size
            kernel_size = args[0]
        if len(args) > 1:
            stride = args[1]
        if len(args) > 2:
            padding = args[2]
        self.nb_kernels = nb_kernels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.group = group
        self.bias = bias
        self.pad_mode = pad_mode
        self.activation = activation

    def initialize(self, x):
        in_channels = x.shape[1]
        if in_channels % self.group:
            raise ValueError(f"{in_channels} input channels do not divide "
                             f"into {self.group} groups")
        self._new_param("W", (self.nb_kernels, in_channels // self.group,
                              *self.kernel_size), x, initializer.he_normal)
        if self.bias:
            self._new_param("b", (self.nb_kernels,), x)
        odd = None
        if self.pad_mode in ("SAME_UPPER", "SAME_LOWER"):
            eff = tuple((k - 1) * d + 1 for k, d in zip(self.kernel_size,
                                                         self.dilation))
            odd = _same_pads(self.pad_mode, x.shape[2:4], eff, self.stride)
        self.handle = _ConvGeometry(self.stride, self.padding, self.group,
                                    odd, self.dilation)
        self.handle.kernel = self.kernel_size

    def forward(self, x):
        b = self.b if self.bias else None
        x, W, b = autograd.compute_cast(x, self.W, b)
        y = autograd.conv2d(self.handle, x, W, b)
        if self.activation in ("RELU", "relu"):
            y = autograd.relu(y)
        return y


class SeparableConv2d(Layer):
    """Depthwise + pointwise conv."""

    def __init__(self, nb_kernels, kernel_size, *args, stride=1, padding=0,
                 bias=False, name=None, **kwargs):
        super().__init__(name)
        # legacy call style SeparableConv2d(in_ch, out_ch, k[, stride[, pad]])
        if len(args) > 0:
            nb_kernels = kernel_size
            kernel_size = args[0]
        if len(args) > 1:
            stride = args[1]
        if len(args) > 2:
            padding = args[2]
        self.nb_kernels = nb_kernels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.bias = bias

    def initialize(self, x):
        in_channels = x.shape[1]
        # nb_kernels None keeps the channel count
        nb = self.nb_kernels if self.nb_kernels is not None else in_channels
        self.depthwise = Conv2d(in_channels, self.kernel_size,
                                stride=self.stride, padding=self.padding,
                                group=in_channels, bias=self.bias)
        self.pointwise = Conv2d(nb, 1, bias=self.bias)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class BatchNorm2d(Layer):
    """Batch norm over the channel dim of NCHW (or (N, C)) input: `scale`
    and `bias` parameters, `running_mean` and `running_var` states,
    updated in training as the JAX package does (autograd.batchnorm_2d:
    momentum 0.9 keeps 0.9 of the old value, biased batch variance)."""

    def __init__(self, *args, momentum=0.9, eps=1e-5, name=None, **kwargs):
        super().__init__(name)
        # legacy call style BatchNorm2d(num_features[, momentum]); the
        # channel count is re-derived from the input
        if len(args) > 1:
            momentum = args[1]
        self.momentum = momentum
        self.eps = eps

    def initialize(self, x):
        c = (x.shape[1],)
        self._new_param("scale", c, x, value=1.0)
        self._new_param("bias", c, x, value=0.0)
        self._new_state("running_mean", c, x, 0.0)
        self._new_state("running_var", c, x, 1.0)

    def forward(self, x):
        return autograd.batchnorm_2d(
            x, self.scale, self.bias, self.running_mean, self.running_var,
            self.momentum, self.eps, train=autograd.training)[0]


class Pooling2d(Layer):

    def __init__(self, kernel_size, stride=None, padding=0, is_max=True,
                 pad_mode="NOTSET", name=None):
        super().__init__(name)
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride) if stride is not None \
            else self.kernel_size
        self.padding = _pair(padding)
        self.is_max = is_max
        self.pad_mode = pad_mode

    def forward(self, x):
        odd = None
        if self.pad_mode in ("SAME_UPPER", "SAME_LOWER"):
            odd = _same_pads(self.pad_mode, x.shape[2:4], self.kernel_size,
                             self.stride)
        return autograd.pooling_2d(x, self.kernel_size, self.stride,
                                   self.padding, self.is_max, odd_padding=odd)


class MaxPool2d(Pooling2d):
    def __init__(self, kernel_size, stride=None, padding=0, name=None):
        super().__init__(kernel_size, stride, padding, True, name=name)


class AvgPool2d(Pooling2d):
    def __init__(self, kernel_size, stride=None, padding=0, name=None):
        super().__init__(kernel_size, stride, padding, False, name=name)


class _Pool1dMixin:
    def forward(self, x):  # N, C, L -> N, C, L, 1
        x4 = autograd.unsqueeze(x, [3])
        y = autograd.pooling_2d(x4, (self.kernel_size[0], 1),
                                (self.stride[0], 1), (self.padding[0], 0),
                                self.is_max)
        return autograd.squeeze(y, 3)


class MaxPool1d(_Pool1dMixin, Pooling2d):
    def __init__(self, kernel_size, stride=None, padding=0, name=None):
        Pooling2d.__init__(self, (kernel_size, 1),
                           (stride, 1) if stride else (kernel_size, 1),
                           (padding, 0), True, name=name)


class AvgPool1d(_Pool1dMixin, Pooling2d):
    def __init__(self, kernel_size, stride=None, padding=0, name=None):
        Pooling2d.__init__(self, (kernel_size, 1),
                           (stride, 1) if stride else (kernel_size, 1),
                           (padding, 0), False, name=name)


class GlobalAvgPool2d(Layer):
    def forward(self, x):
        return autograd.flatten(autograd.globalaveragepool(x), 1)


# ---- stateless wrappers -------------------------------------------------------


class ReLU(Layer):
    def forward(self, x):
        return autograd.relu(x)


class Sigmoid(Layer):
    def forward(self, x):
        return autograd.sigmoid(x)


class Tanh(Layer):
    def forward(self, x):
        return autograd.tanh(x)


class Add(Layer):
    def forward(self, a, b):
        return autograd.add(a, b)


class Flatten(Layer):
    def __init__(self, axis=1, name=None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        return autograd.flatten(x, self.axis)


class Reshape(Layer):
    def __init__(self, shape, name=None):
        super().__init__(name)
        self.shape = shape

    def forward(self, x):
        return autograd.reshape(x, self.shape)


class Cat(Layer):
    def __init__(self, axis=0, name=None):
        super().__init__(name)
        self.axis = axis

    def forward(self, xs):
        return autograd.cat(xs, self.axis)


class Dropout(Layer):
    def __init__(self, ratio=0.5, name=None):
        super().__init__(name)
        self.ratio = ratio

    def forward(self, x):
        return autograd.dropout(x, self.ratio)


class SoftMax(Layer):
    def __init__(self, axis=1, name=None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        return autograd.softmax(x, self.axis)


class SoftMaxCrossEntropy(Layer):
    """Mean softmax cross-entropy of logits (..., V) against integer
    targets (...), fp32 inside (autograd.softmax_cross_entropy)."""

    def forward(self, x, t):
        return autograd.softmax_cross_entropy(x, t)


class MeanSquareError(Layer):
    def forward(self, x, t):
        return autograd.mse_loss(x, t)


class CrossEntropy(Layer):
    def forward(self, p, t):
        return autograd.cross_entropy(p, t)


class BinaryCrossEntropy(Layer):
    def forward(self, x, t):
        return autograd.binary_cross_entropy(x, t)


# ---- recurrent (JAX layer.py:887-1057) ------------------------------------


class RNN_Base(Layer):
    pass


def _zeros_like_rows(x, batch, hidden):
    """A zero (batch, hidden) state on x's device in x's dtype: a Tensor
    for a Tensor x."""
    t = torch.zeros((batch, hidden), dtype=_raw(x).dtype,
                    device=_raw(x).device)
    return Tensor._wrap(t, x.device) if isinstance(x, Tensor) else t


class RNN(RNN_Base):
    """Elman RNN from the tape operators, a Python loop over time
    (x: (seq, batch, feature)); forward returns (list of the per-step
    h, last h). Wx glorot-uniform, Wh orthogonal, b zero."""

    def __init__(self, hidden_size, activation="tanh", name=None):
        super().__init__(name)
        self.hidden_size = hidden_size
        self.activation = activation

    def initialize(self, x, hx=None):
        H = self.hidden_size
        self._new_param("Wx", (x.shape[2], H), x, initializer.glorot_uniform)
        self._new_param("Wh", (H, H), x, initializer.orthogonal)
        self._new_param("b", (H,), x)

    def step(self, xt, h):
        z = autograd.add(autograd.matmul(xt, self.Wx),
                         autograd.matmul(h, self.Wh))
        z = autograd.add_bias(z, self.b, axis=0)
        return autograd.tanh(z) if self.activation == "tanh" \
            else autograd.relu(z)

    def forward(self, x, hx=None):
        h = hx if hx is not None \
            else _zeros_like_rows(x, x.shape[1], self.hidden_size)
        ys = []
        for t in range(x.shape[0]):
            h = self.step(x[t], h)
            ys.append(h)
        return ys, h


class LSTM(RNN_Base):
    """LSTM with fused gates (i, f, g, o) over ops.rnn.lstm_scan, one tape
    operator for the sequence; forward returns (list of the per-step h,
    (h, c)). Wx and Wh glorot-uniform, b zero."""

    def __init__(self, hidden_size, name=None):
        super().__init__(name)
        self.hidden_size = hidden_size

    def initialize(self, x, hx_cx=None):
        H = self.hidden_size
        self._new_param("Wx", (x.shape[2], 4 * H), x,
                        initializer.glorot_uniform)
        self._new_param("Wh", (H, 4 * H), x, initializer.glorot_uniform)
        self._new_param("b", (4 * H,), x)

    def step(self, xt, h, c):
        """One step on xt (batch, feature): the new (h, c)."""
        from .ops.rnn import lstm_scan
        _, h, c = lstm_scan(autograd.unsqueeze(xt, 0), h, c, self.Wx,
                            self.Wh, self.b)
        return h, c

    def forward(self, x, hx_cx=None):
        from .ops.rnn import lstm_scan
        if hx_cx is None:
            h = _zeros_like_rows(x, x.shape[1], self.hidden_size)
            c = _zeros_like_rows(x, x.shape[1], self.hidden_size)
        else:
            h, c = hx_cx
        ys, h, c = lstm_scan(x, h, c, self.Wx, self.Wh, self.b)
        ys = autograd.split(ys, 0, [1] * x.shape[0])
        return [autograd.squeeze(y, 0) for y in ys], (h, c)


class CudnnRNN(Layer):
    """Multi-step LSTM as one operator (ops.rnn.lstm_scan), the name kept
    from the JAX package (which kept SINGA's); `FusedRNN` is the same
    class. Parameters from ops.rnn.init_lstm_params (Wx, Wh, b; with
    `bidirectional` also Wx_r, Wh_r, b_r). Forward takes x (seq, batch,
    feature), or (batch, seq, feature) with `batch_first`, and returns
    (ys, hy, cy), ys (seq, batch, H) (2H when bidirectional, batch first
    with `batch_first`), or (hy, hy, cy) with `return_sequences=False`.
    `seq_lengths` (batch,) runs the variable-length operator: hy and cy
    are each sample's state at its last step, padded outputs are zero,
    and the backward direction reverses each sample's own prefix."""

    def __init__(self, hidden_size, batch_first=False, name=None,
                 return_sequences=True, bidirectional=False):
        super().__init__(name)
        self.hidden_size = hidden_size
        self.batch_first = batch_first
        self.return_sequences = return_sequences
        self.bidirectional = bidirectional

    def initialize(self, x, hx=None, cx=None, **kwargs):
        from .ops.rnn import init_lstm_params
        dev = x.device if isinstance(x, Tensor) \
            else device_module.of(x.device)
        # the feature axis is 2 in both layouts
        for sfx in ("", "_r") if self.bidirectional else ("",):
            for n, t in zip(("Wx", "Wh", "b"), init_lstm_params(
                    x.shape[2], self.hidden_size, dev, _raw(x).dtype)):
                self.register_parameter(n + sfx, nn.Parameter(t.data))

    def forward(self, x, hx=None, cx=None, seq_lengths=None):
        from .ops.rnn import lstm_scan, lstm_scan_ex, reverse_padded
        if self.batch_first:
            x = autograd.transpose(x, (1, 0, 2))
        batch, H = x.shape[1], self.hidden_size
        if hx is None:
            hx = _zeros_like_rows(x, batch, H)
        if cx is None:
            cx = _zeros_like_rows(x, batch, H)
        if seq_lengths is not None and not isinstance(
                seq_lengths, (Tensor, torch.Tensor)):
            seq_lengths = torch.as_tensor(np.asarray(seq_lengths, np.int32),
                                          device=_raw(x).device)

        def run(xs, Wx, Wh, b):
            if seq_lengths is not None:
                return lstm_scan_ex(xs, seq_lengths, hx, cx, Wx, Wh, b)
            return lstm_scan(xs, hx, cx, Wx, Wh, b)

        def rev(v):
            return reverse_padded(v, seq_lengths) \
                if seq_lengths is not None else autograd.flip(v, axis=0)

        ys, hy, cy = run(x, self.Wx, self.Wh, self.b)
        if self.bidirectional:
            ys_r, hy_r, cy_r = run(rev(x), self.Wx_r, self.Wh_r, self.b_r)
            ys = autograd.cat((ys, rev(ys_r)), axis=2)
            hy = autograd.cat((hy, hy_r), axis=1)
            cy = autograd.cat((cy, cy_r), axis=1)
        if self.batch_first:
            ys = autograd.transpose(ys, (1, 0, 2))
        if self.return_sequences:
            return ys, hy, cy
        return hy, hy, cy


FusedRNN = CudnnRNN


# ---- the transformer stack (JAX layer.py:611-783) ---------------------------


def _no_seq_axis(seq_axis):
    if seq_axis is not None:
        raise NotImplementedError(
            "seq_axis (ring attention) comes with model-parallel "
            "distribution: sequence parallelism, ROADMAP.md Queue 1 item 5b")


class LayerNorm(Layer):
    """LayerNorm over the last axis as an fp32 island (biased variance),
    output in the input dtype: variance in bf16 is lossy. gamma and beta
    are made at the first call, of the input's width, or at construction
    with `dim`."""

    def __init__(self, eps=1e-5, name=None, dim=None):
        super().__init__(name)
        self.eps = eps
        if dim is not None:
            self.gamma = nn.Parameter(torch.ones(dim))
            self.beta = nn.Parameter(torch.zeros(dim))
            self._initialized = True

    def initialize(self, x):
        d = (x.shape[-1],)
        self._new_param("gamma", d, x, value=1.0)
        self._new_param("beta", d, x, value=0.0)

    def forward(self, x):
        return autograd.layernorm(x, self.gamma, self.beta, self.eps)


class MultiHeadAttention(Layer):
    """Self-attention over (B, S, E) through the flash-attention kernel
    (autograd.attention: K1 forward, K2 backward). `num_kv_heads` <
    num_heads is GQA (each kv head serves num_heads / num_kv_heads
    consecutive query heads), `rope` rotates q and k. Wq, Wk, Wv, Wo
    (and with `bias` bq, bk, bv, bo) are glorot-uniform, made at the
    first call from the input's width, or at construction with `dim`
    (drawn from `generator`).

    `tp_axis` shards the heads Megatron-style: Wq, Wk, Wv (and bq, bk,
    bv) column-parallel, so each rank computes num_heads / tp query heads
    and num_kv_heads / tp kv heads with no collective, Wo row-parallel
    (one all-reduce), bo whole and added after it. Both head counts must
    divide by tp."""

    def __init__(self, num_heads, causal=False, seq_axis=None, tp_axis=None,
                 bias=False, num_kv_heads=None, rope=False,
                 rope_theta=10000.0, name=None, dim=None, generator=None):
        super().__init__(name)
        _no_seq_axis(seq_axis)
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError(f"{num_heads} heads, {self.num_kv_heads} kv "
                             "heads do not divide")
        self.causal = causal
        self.tp_axis = tp_axis
        self.rope = bool(rope)
        self.rope_theta = float(rope_theta)
        self.use_bias = bias
        if dim is not None:
            def make(attr, shape, glorot):
                setattr(self, attr, nn.Parameter(
                    glorot_uniform(*shape, generator) if glorot
                    else torch.zeros(shape)))
            self._make_params(dim, make)
            self._initialized = True

    def _make_params(self, e, make):
        """Wq, bq, Wk, bk, Wv, bv, Wo, bo for width `e`, in that order:
        `make(attr, shape, glorot)` makes one (glorot-uniform, else
        zeros); then their tensor-parallel specs."""
        if e % self.num_heads:
            raise ValueError(f"width {e} does not divide into "
                             f"{self.num_heads} heads")
        kv_e = self.num_kv_heads * (e // self.num_heads)
        ax = self.tp_axis
        for attr in ("Wq", "Wk", "Wv", "Wo"):
            out_e = kv_e if attr in ("Wk", "Wv") else e
            make(attr, (e, out_e), True)
            if ax is not None:
                getattr(self, attr).spec = (ax, None) if attr == "Wo" \
                    else (None, ax)
            if self.use_bias:
                b = "b" + attr[1].lower()
                make(b, (out_e,), False)
                if ax is not None and attr != "Wo":
                    getattr(self, b).spec = (ax,)

    def initialize(self, x):
        self._make_params(x.shape[-1], lambda attr, shape, glorot: (
            self._new_param(attr, shape, x, initializer.glorot_uniform
                            if glorot else None)))

    def forward(self, x):
        B, S, E = x.shape
        heads, kv_heads = self.num_heads, self.num_kv_heads
        tp = self.tp_axis is not None and autograd.axis_bound(self.tp_axis)
        if tp:
            from .parallel.mesh import axis_size
            n = axis_size(self.tp_axis)
            if heads % n:
                raise ValueError(f"{heads} heads not divisible by tp={n}")
            if kv_heads % n:
                raise ValueError(f"{kv_heads} kv heads not divisible by "
                                 f"tp={n}")
            heads, kv_heads = heads // n, kv_heads // n
            x = autograd.tp_copy(x, self.tp_axis)
        x, Wq, Wk, Wv, Wo = autograd.compute_cast(
            x, self.Wq, self.Wk, self.Wv, self.Wo)
        bq, bk, bv, bo = (self.bq, self.bk, self.bv, self.bo) \
            if self.use_bias else (None,) * 4

        def proj(W, b, heads):
            y = autograd.matmul(x, W)
            if b is not None:
                y = autograd.add_bias(y, autograd.compute_cast(b), axis=0)
            y = autograd.reshape(y, (B, S, heads, -1))
            return autograd.transpose(y, (0, 2, 1, 3))    # (B, H, S, D)

        q = proj(Wq, bq, heads)
        k = proj(Wk, bk, kv_heads)
        v = proj(Wv, bv, kv_heads)
        if self.rope:
            # rotate before the kv-head repeat, as the JAX layer does
            q = autograd.Rope(self.rope_theta)(q)
            k = autograd.Rope(self.rope_theta)(k)
        grp = self.num_heads // self.num_kv_heads
        if grp > 1:
            # GQA: each kv head serves `grp` consecutive query heads; the
            # repeat's gradient sums over the group
            k = autograd.UpSample([1, grp, 1, 1])(k)
            v = autograd.UpSample([1, grp, 1, 1])(v)
        o = autograd.attention(q, k, v, causal=self.causal)
        o = autograd.reshape(autograd.transpose(o, (0, 2, 1, 3)),
                             (B, S, -1))
        y = autograd.matmul(o, Wo)
        if tp:
            y = autograd.tp_reduce(y, self.tp_axis)
        if bo is not None:
            y = autograd.add_bias(y, autograd.compute_cast(bo), axis=0)
        return y


class TransformerBlock(Layer):
    """Pre-LN block: x + MHA(LN(x)); x + MLP(LN(x)), tanh-GELU MLP.
    `moe_experts` > 0 replaces the MLP by a top-`moe_k` MoE FFN
    (`self.moe`, no fc1/fc2): x + MoE(LN(x)), its router losses on
    `self.moe` after each forward. fc1/fc2 (or the experts' width) follow
    the first input's width, or `dim` at construction, drawn from
    `generator`. `ep_axis` is accepted and runs on one device, as the
    JAX layer does outside a mesh. `tp_axis` makes the attention
    head-parallel and the MLP column (fc1) then row (fc2) parallel: two
    all-reduces a block, the Megatron layout (an MoE block's experts stay
    whole, as in the JAX layer)."""

    def __init__(self, num_heads, mlp_ratio=4, causal=True, seq_axis=None,
                 tp_axis=None, attn_bias=False, moe_experts=0, moe_k=1,
                 ep_axis=None, moe_capacity_factor=1.25, num_kv_heads=None,
                 rope=False, rope_theta=10000.0, name=None, dim=None,
                 generator=None):
        super().__init__(name)
        _no_seq_axis(seq_axis)
        self.ln1 = LayerNorm(dim=dim)
        self.attn = MultiHeadAttention(
            num_heads, causal=causal, tp_axis=tp_axis, bias=attn_bias,
            num_kv_heads=num_kv_heads, rope=rope, rope_theta=rope_theta,
            dim=dim, generator=generator)
        self.ln2 = LayerNorm(dim=dim)
        self.mlp_ratio = mlp_ratio
        self.tp_axis = tp_axis
        self.moe_experts = moe_experts
        if moe_experts:
            self.moe = MoE(moe_experts, hidden=dim * mlp_ratio if dim
                           else None, capacity_factor=moe_capacity_factor,
                           ep_axis=ep_axis, k=moe_k, dim=dim,
                           generator=generator)
        if dim is not None:
            if not moe_experts:
                self._make_mlp(dim, generator)
            self._initialized = True

    def _make_mlp(self, e, generator=None):
        """fc1 (e -> mlp_ratio * e) and fc2 back, drawn now from
        `generator`, else at their first call."""
        h = e * self.mlp_ratio
        self.fc1 = Linear(e, h, tp_axis=self.tp_axis, tp_mode="column",
                          generator=generator)
        self.fc2 = Linear(h, e, tp_axis=self.tp_axis, tp_mode="row",
                          generator=generator)

    def initialize(self, x):
        e = x.shape[-1]
        if self.moe_experts:
            self.moe.hidden = e * self.mlp_ratio
            return
        self._make_mlp(e)

    def forward(self, x):
        x = autograd.add(x, self.attn(self.ln1(x)))
        if self.moe_experts:
            return autograd.add(x, self.moe(self.ln2(x)))
        return autograd.add(x, self.fc2(autograd.gelu(self.fc1(
            self.ln2(x)))))


class MoE(Layer):
    """Mixture-of-experts FFN over (..., D) activations
    (parallel.moe.moe_ffn): top-`k` routing with renormalized gates and
    a batch-global capacity, max(1, int(T * k * capacity_factor / E))
    over the T rows of the call. Parameters: Wg (D, E) glorot-uniform,
    W1 (E, D, H) and W2 (E, H, D) Gaussian with std sqrt(2/D) and
    sqrt(2/H), zero biases b1 (E, H) and b2 (E, D); H = `hidden` or 4D.
    Drawn at the first call from the input's Device, or at construction
    from `generator` when `dim` is given (the GPT's style).

    After each forward `aux_loss` (load balance), `z_loss` (router
    z-loss) and `overflow` (dropped-route fraction) are set on the
    layer: tape Tensors for a Tensor input, tensors for a raw one. A
    training step folds the losses into its loss (the GPT's
    `moe_aux_weight`, `moe_z_weight`). No compute cast: under the bf16
    policy the router and the experts run in the promoted dtype of the
    input and the fp32 weights, as in the JAX package. `ep_axis` (expert
    parallelism) is accepted and runs the single-device path, as the
    JAX layer does outside a mesh."""

    def __init__(self, num_experts, hidden=None, capacity_factor=1.25,
                 ep_axis=None, k=1, name=None, dim=None, generator=None):
        super().__init__(name)
        self.num_experts = num_experts
        self.hidden = hidden
        self.capacity_factor = capacity_factor
        self.ep_axis = ep_axis
        self.k = k
        self.aux_loss = self.z_loss = self.overflow = None
        if generator is not None:
            if dim is None:
                raise ValueError("MoE(..., generator=g) draws at "
                                 "construction and needs dim")
            d, h, E = dim, hidden or 4 * dim, num_experts
            self.Wg = nn.Parameter(glorot_uniform(d, E, generator))
            self.W1 = nn.Parameter(
                torch.randn((E, d, h), generator=generator)
                * math.sqrt(2.0 / d))
            self.b1 = nn.Parameter(torch.zeros(E, h))
            self.W2 = nn.Parameter(
                torch.randn((E, h, d), generator=generator)
                * math.sqrt(2.0 / h))
            self.b2 = nn.Parameter(torch.zeros(E, d))
            self._initialized = True

    def initialize(self, x):
        d = x.shape[-1]
        h = self.hidden or 4 * d
        E = self.num_experts

        def gauss(std):
            return lambda t: t.gaussian(0.0, std)

        self._new_param("Wg", (d, E), x, initializer.glorot_uniform)
        self._new_param("W1", (E, d, h), x, gauss(math.sqrt(2.0 / d)))
        self._new_param("b1", (E, h), x)
        self._new_param("W2", (E, h, d), x, gauss(math.sqrt(2.0 / h)))
        self._new_param("b2", (E, d), x)

    def forward(self, x):
        y, aux, z, ovf = _MoEOp(self.capacity_factor, self.k)(
            x, self.Wg, self.W1, self.b1, self.W2, self.b2)
        self.aux_loss, self.z_loss, self.overflow = aux, z, ovf
        return y


class _MoEOp(autograd.Operator):
    """The MoE FFN as one tape node: (y, aux, z_loss, overflow)."""

    def __init__(self, capacity_factor, k):
        super().__init__("MoE")
        self.capacity_factor = capacity_factor
        self.k = k

    def forward(self, x, Wg, W1, b1, W2, b2):
        from .parallel.moe import moe_ffn
        shape = x.shape
        y, aux, (z, ovf) = moe_ffn(x.reshape(-1, shape[-1]), Wg, W1, b1,
                                   W2, b2, self.capacity_factor, k=self.k)
        return y.reshape(*shape[:-1], y.shape[-1]), aux, z, ovf


__all__ = ["Add", "AvgPool1d", "AvgPool2d", "BatchNorm2d",
           "BinaryCrossEntropy", "Cat", "Conv2d", "CrossEntropy", "CudnnRNN",
           "Dropout", "Embedding", "Flatten", "FusedRNN", "Gemm",
           "GlobalAvgPool2d", "LSTM", "Layer", "LayerNorm", "Linear",
           "MaxPool1d", "MaxPool2d", "MeanSquareError", "MoE",
           "MultiHeadAttention", "Pooling2d", "RNN", "RNN_Base", "ReLU",
           "Reshape", "SeparableConv2d", "Sigmoid", "SoftMax",
           "SoftMaxCrossEntropy", "Tanh", "TransformerBlock", "layernorm"]
