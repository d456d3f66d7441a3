"""ONNX import (counterpart of singa_tpu/sonnx/backend.py): ModelProto ->
a runnable and retrainable graph of the port's tape operators.

Reference parity: SingaBackend (python/singa/sonnx.py:1037-1951) maps ONNX
nodes through `_rename_operators`/`_special_operators` onto autograd ops and
layers; `SingaRep.run(inputs)` executes them; `SONNXModel` (sonnx.py:2196)
wraps an import for re-training.

Each node handler is a closure over the port's functional operators, so an
imported graph records on the tape (trainable) like hand-written layers and
runs inside a CUDA-graph capture (`Model.compile(use_graph=True)`). The
floating initializers become `nn.Parameter`s on the backend's device (the
card by default), handed to the operators as `stores_grad` Tensors around
them; batch norm's running statistics become state tensors, updated in
place. Constant-foldable inputs (shapes, axes, starts, ends, k, pads) are
numpy on the host and fold there (`_NP_FOLD`), so running the graph reads
nothing back from the card; `Shape`, `Size`, `Range` and `ConstantOfShape`
are host values too. A host value that feeds a device op (a Constant, a
folded result, an integer initializer) is uploaded at its first use and
kept, so later runs and a CUDA-graph capture copy nothing from the host. `NonZero` has a data-dependent shape: it runs
eagerly and raises inside a capture. Integer inputs keep their width
(ONNX indices are int64; the JAX package's become int32).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import autograd
from ..tensor import Tensor, _dev, from_numpy
from . import onnx_pb as pb


def _attr(node, name, default=None):
    a = node.attrs()
    return a.get(name, default)


class OnnxNode:
    def __init__(self, node: pb.NodeProto):
        self.proto = node
        self.op_type = node.op_type
        self.name = node.name or (node.output[0] + "_" + node.op_type)
        self.inputs = list(node.input)
        self.outputs = list(node.output)
        self.attrs = node.attrs()


def _np_const(env, name):
    """Host-side value of a constant-foldable input, else None."""
    v = env.get(name)
    if isinstance(v, np.ndarray):
        return v
    return None


def _np_div(a, b):
    """ONNX Div on ints truncates toward zero (C semantics)."""
    if np.issubdtype(np.asarray(a).dtype, np.integer):
        return np.trunc(np.true_divide(a, b)).astype(np.asarray(a).dtype)
    return np.true_divide(a, b)


def _np_slice(node, ins):
    data = ins[0]
    if len(ins) < 3:  # opset<10: starts/ends/axes are attributes
        starts = np.atleast_1d(node.attrs["starts"])
        ends = np.atleast_1d(node.attrs["ends"])
        axes = np.atleast_1d(node.attrs["axes"]) \
            if "axes" in node.attrs else range(len(starts))
        steps = [1] * len(starts)
    else:
        starts, ends = np.atleast_1d(ins[1]), np.atleast_1d(ins[2])
        axes = np.atleast_1d(ins[3]) if len(ins) > 3 and ins[3] is not None \
            else range(len(starts))
        steps = np.atleast_1d(ins[4]) if len(ins) > 4 and ins[4] is not None \
            else [1] * len(starts)
    sl = [slice(None)] * data.ndim
    for s, e, a, st in zip(starts, ends, axes, steps):
        sl[int(a)] = slice(int(s), int(min(e, np.iinfo(np.int64).max)),
                           int(st))
    return data[tuple(sl)]


def _np_unsqueeze(node, ins):
    y = ins[0]
    axes = np.atleast_1d(ins[1]) if len(ins) > 1 and ins[1] is not None \
        else np.atleast_1d(node.attrs["axes"])
    for a in sorted(int(a) for a in axes):
        y = np.expand_dims(y, a)
    return y


def _np_squeeze(node, ins):
    axes = None
    if len(ins) > 1 and ins[1] is not None:      # opset 13: input
        axes = ins[1]
    elif "axes" in node.attrs:                   # opset <13: attribute
        axes = node.attrs["axes"]
    return np.squeeze(ins[0], tuple(int(a) for a in np.atleast_1d(axes))
                      if axes is not None else None)


def _np_reshape(node, ins):
    # ONNX: a 0 in the target shape copies the input dim at that position
    shape = [int(s) if s != 0 else ins[0].shape[i]
             for i, s in enumerate(np.atleast_1d(ins[1]).tolist())]
    return ins[0].reshape(shape)


#: Shape-arithmetic chains exported by torch (Shape->Gather->Add->Div->
#: Concat->Reshape/Slice...) must fold on host with INTEGER semantics, not
#: get traced as float device ops. Applied when every input is a host
#: ndarray (initializer consts / Shape outputs), never to tape Tensors.
_NP_FOLD = {
    "Add": lambda n, i: i[0] + i[1],
    "Sub": lambda n, i: i[0] - i[1],
    "Mul": lambda n, i: i[0] * i[1],
    "Div": lambda n, i: _np_div(i[0], i[1]),
    "Mod": lambda n, i: np.fmod(i[0], i[1]) if n.attrs.get("fmod")
    else np.mod(i[0], i[1]),
    "Neg": lambda n, i: -i[0],
    "Abs": lambda n, i: np.abs(i[0]),
    "Floor": lambda n, i: np.floor(i[0]),
    "Ceil": lambda n, i: np.ceil(i[0]),
    "Gather": lambda n, i: np.take(i[0], i[1].astype(np.int64),
                                   axis=int(n.attrs.get("axis", 0))),
    "Concat": lambda n, i: np.concatenate(i, axis=int(n.attrs.get("axis",
                                                                  0))),
    "Unsqueeze": _np_unsqueeze,
    "Squeeze": _np_squeeze,
    "Cast": lambda n, i: i[0].astype(
        pb._ONNX2NP.get(int(n.attrs["to"]), np.float32)),
    "Slice": _np_slice,
    "Range": lambda n, i: np.arange(np.asarray(i[0]).ravel()[0],
                                    np.asarray(i[1]).ravel()[0],
                                    np.asarray(i[2]).ravel()[0]),
    "Min": lambda n, i: np.minimum.reduce(i),
    "Max": lambda n, i: np.maximum.reduce(i),
    "Equal": lambda n, i: i[0] == i[1],
    "Less": lambda n, i: i[0] < i[1],
    "Greater": lambda n, i: i[0] > i[1],
    "Where": lambda n, i: np.where(i[0], i[1], i[2]),
    "ReduceProd": lambda n, i: np.prod(
        i[0], axis=tuple(n.attrs["axes"]) if "axes" in n.attrs else None,
        keepdims=bool(n.attrs.get("keepdims", 1))),
    "Identity": lambda n, i: i[0],
    "Reshape": _np_reshape,
    "Expand": lambda n, i: np.broadcast_to(
        i[0], np.broadcast_shapes(i[0].shape,
                                  tuple(int(s) for s in i[1]))),
    "Transpose": lambda n, i: np.transpose(i[0], n.attrs.get("perm")),
}


class SingaBackend:
    """Builds an executable op list from a ModelProto."""

    def __init__(self, model: pb.ModelProto, device=None):
        self.device = _dev(device)
        self.graph = model.graph
        self.params = {}      # name -> Tensor (trainable weights)
        self.consts = {}      # name -> np.ndarray (non-trainable constants)
        self.nodes = [OnnxNode(n) for n in self.graph.node]
        self.input_names = []
        init_names = {t.name for t in self.graph.initializer}
        for vi in self.graph.input:
            if vi.name not in init_names:
                self.input_names.append(vi.name)
        self.output_names = [vi.name for vi in self.graph.output]
        # BN running stats are state, not trainable weights
        bn_stats = set()
        for n in self.nodes:
            if n.op_type == "BatchNormalization" and len(n.inputs) >= 5:
                bn_stats.update(n.inputs[3:5])
        self.states = {}      # name -> Tensor (mutable, non-trainable)
        self._host = {}       # name -> the initializer's numpy array
        self._rnn_weights = {}  # node name -> converted RNN weights
        self._uploads = {}    # name -> (host value, its Tensor)
        td = self.device.torch_device
        for t in self.graph.initializer:
            arr = pb.tensor_to_numpy(t)
            if not np.issubdtype(arr.dtype, np.floating):
                self.consts[t.name] = arr
                continue
            arr = arr.astype(np.float32)
            self._host[t.name] = arr
            data = torch.from_numpy(arr).to(td)
            if t.name in bn_stats:
                s = Tensor._wrap(data, self.device)
                s.name = t.name
                self.states[t.name] = s
            else:
                p = Tensor._wrap(nn.Parameter(data), self.device, True)
                p.stores_grad = True
                p.name = t.name
                self.params[t.name] = p

    # -- execution ---------------------------------------------------------
    def run(self, inputs, env=None, last_layers=None):
        """inputs: list of Tensors aligned with graph inputs (or dict).
        last_layers: execute only that many nodes (negative = from the
        end) and return the last executed node's outputs."""
        env = dict(env or {})
        env.update(self.consts)
        env.update(self.params)
        env.update(self.states)
        if isinstance(inputs, dict):
            env.update(inputs)
        else:
            for name, t in zip(self.input_names, inputs):
                env[name] = t
        nodes = self.nodes
        out_names = self.output_names
        if last_layers is not None and last_layers != len(self.nodes):
            if not -len(self.nodes) < last_layers <= len(self.nodes) \
                    or last_layers == 0:
                raise ValueError(
                    f"last_layers={last_layers} out of range for a "
                    f"{len(self.nodes)}-node graph")
            nodes = self.nodes[:last_layers]
            out_names = list(nodes[-1].outputs)
        for node in nodes:
            fold = _NP_FOLD.get(node.op_type)
            if fold is not None and node.inputs and any(
                    nm for nm in node.inputs) and all(
                    isinstance(env.get(nm), np.ndarray)
                    for nm in node.inputs if nm):
                # keep positions: '' optional-input placeholders become None
                ins = [env[nm] if nm else None for nm in node.inputs]
                env[node.outputs[0]] = np.asarray(fold(node, ins))
                continue
            handler = getattr(self, "op_" + node.op_type, None)
            if handler is None:
                raise NotImplementedError(
                    f"ONNX op {node.op_type} not supported "
                    f"(node {node.name})")
            outs = handler(node, env)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for name, v in zip(node.outputs, outs):
                env[name] = v
        return [env[n] for n in out_names]

    # -- helpers -----------------------------------------------------------
    def _t(self, env, name):
        """Fetch an input as a Tensor. A host value (an integer
        initializer, a Constant, a folded result) is uploaded at its first
        use and kept by name while its value stays the same, so a later
        run, a CUDA-graph capture too, copies nothing from the host."""
        v = env[name]
        if isinstance(v, np.ndarray):
            hit = self._uploads.get(name)
            if hit is None or not (hit[0] is v or (
                    hit[0].dtype == v.dtype and hit[0].shape == v.shape
                    and hit[0].tobytes() == v.tobytes())):
                hit = self._uploads[name] = (v, from_numpy(
                    v, device=self.device))
            v = env[name] = hit[1]
        return v

    def _uploaded(self, name, v):
        """The host value behind `v` when `_t` uploaded it, else None."""
        hit = self._uploads.get(name)
        return hit[0] if hit is not None and hit[1] is v else None

    def _const(self, env, node, idx, attr=None, default=None):
        """Constant-foldable operand: from attrs (old opsets) or inputs."""
        if attr is not None and attr in node.attrs:
            return np.asarray(node.attrs[attr])
        if idx < len(node.inputs) and node.inputs[idx]:
            name = node.inputs[idx]
            v = env[name]
            if isinstance(v, np.ndarray):
                return v
            if isinstance(v, Tensor):
                host = self._uploaded(name, v)
                # a value computed on the card is read back (syncs)
                return host if host is not None else v.numpy()
        return default

    def _host_value(self, env, name):
        """numpy value of an input: the initializer's or the uploaded
        host copy when it is one, else read back from the card."""
        if name in self._host:
            return self._host[name]
        v = env[name]
        if isinstance(v, np.ndarray):
            return v
        host = self._uploaded(name, v)
        return host if host is not None else v.numpy()

    # ==== elementwise / unary ============================================
    def _unary(fn):  # noqa: N805
        def h(self, node, env):
            return fn(self._t(env, node.inputs[0]))
        return h

    op_Relu = _unary(autograd.relu)
    op_Sigmoid = _unary(autograd.sigmoid)
    op_Tanh = _unary(autograd.tanh)
    op_Softplus = _unary(autograd.softplus)
    op_Softsign = _unary(autograd.softsign)
    op_Exp = _unary(autograd.exp)
    op_Log = _unary(autograd.log)
    op_Sqrt = _unary(autograd.sqrt)
    op_Abs = _unary(autograd.abs)
    op_Neg = _unary(autograd.negative)
    op_Reciprocal = _unary(autograd.reciprocal)
    op_Sign = _unary(autograd.sign)
    op_Erf = _unary(autograd.erf)
    op_Identity = _unary(autograd.identity)
    op_Sin = _unary(autograd.sin)
    op_Sinh = _unary(autograd.sinh)
    op_Asin = _unary(autograd.asin)
    op_Asinh = _unary(autograd.asinh)
    op_Cos = _unary(autograd.cos)
    op_Cosh = _unary(autograd.cosh)
    op_Acos = _unary(autograd.acos)
    op_Acosh = _unary(autograd.acosh)
    op_Tan = _unary(autograd.tan)
    op_Atan = _unary(autograd.atan)
    op_Atanh = _unary(autograd.atanh)
    op_Ceil = _unary(lambda x: autograd.Ceil()(x))
    op_Floor = _unary(lambda x: autograd.Floor()(x))
    op_Round = _unary(lambda x: autograd.Round()(x))
    op_Not = _unary(lambda x: autograd.Not()(x))

    def op_LeakyRelu(self, node, env):
        return autograd.leakyrelu(self._t(env, node.inputs[0]),
                                  _attr(node.proto, "alpha", 0.01))

    def op_Elu(self, node, env):
        return autograd.elu(self._t(env, node.inputs[0]),
                            _attr(node.proto, "alpha", 1.0))

    def op_Selu(self, node, env):
        return autograd.selu(self._t(env, node.inputs[0]),
                             _attr(node.proto, "alpha", 1.67326),
                             _attr(node.proto, "gamma", 1.0507))

    def op_HardSigmoid(self, node, env):
        return autograd.hardsigmoid(self._t(env, node.inputs[0]),
                                    _attr(node.proto, "alpha", 0.2),
                                    _attr(node.proto, "beta", 0.5))

    def op_PRelu(self, node, env):
        return autograd.prelu(self._t(env, node.inputs[0]),
                              self._t(env, node.inputs[1]))

    def op_Softmax(self, node, env):
        return autograd.softmax(self._t(env, node.inputs[0]),
                                int(_attr(node.proto, "axis", -1)))

    def op_LayerNormalization(self, node, env):
        # opset 17; this framework's LayerNorm normalizes the last axis
        axis = int(_attr(node.proto, "axis", -1))
        x = self._t(env, node.inputs[0])
        assert axis in (-1, len(x.shape) - 1), \
            f"LayerNormalization axis {axis} unsupported (last axis only)"
        if len(node.outputs) > 1:
            raise NotImplementedError(
                "LayerNormalization Mean/InvStdDev outputs not supported")
        gamma = self._t(env, node.inputs[1])
        if len(node.inputs) > 2 and node.inputs[2]:
            beta = self._t(env, node.inputs[2])
        else:  # bias input B is OPTIONAL in the ONNX spec
            beta = from_numpy(
                np.zeros(gamma.shape, np.float32), device=x.device)
        return autograd.layernorm(x, gamma, beta,
                                  float(_attr(node.proto, "epsilon", 1e-5)))

    def op_Clip(self, node, env):
        lo = self._const(env, node, 1, attr="min")
        hi = self._const(env, node, 2, attr="max")
        return autograd.clip(self._t(env, node.inputs[0]),
                             None if lo is None else float(lo),
                             None if hi is None else float(hi))

    def op_Cast(self, node, env):
        to = int(node.attrs["to"])
        np_dt = pb._ONNX2NP.get(to, np.float32)
        return autograd.cast(self._t(env, node.inputs[0]), np.dtype(np_dt).name)

    # ==== binary =========================================================
    def _binary(fn):  # noqa: N805
        def h(self, node, env):
            return fn(self._t(env, node.inputs[0]),
                      self._t(env, node.inputs[1]))
        return h

    op_Add = _binary(autograd.add)
    op_Sub = _binary(autograd.sub)
    op_Mul = _binary(autograd.mul)
    op_Div = _binary(autograd.div)
    op_MatMul = _binary(autograd.matmul)
    op_Pow = _binary(autograd.pow)
    op_Less = _binary(autograd.less)
    op_Greater = _binary(autograd.greater)
    op_Equal = _binary(autograd.equal)
    op_Min = _binary(autograd.min)
    op_Max = _binary(autograd.max)
    op_And = _binary(lambda a, b: autograd.And()(a, b))
    op_Or = _binary(lambda a, b: autograd.Or()(a, b))
    op_Xor = _binary(lambda a, b: autograd.Xor()(a, b))

    def op_Sum(self, node, env):
        return autograd.Sum()(*[self._t(env, n) for n in node.inputs])

    def op_Mean(self, node, env):
        return autograd.mean(*[self._t(env, n) for n in node.inputs])

    def op_Where(self, node, env):
        cond = self._t(env, node.inputs[0])
        return autograd.where(cond, self._t(env, node.inputs[1]),
                              self._t(env, node.inputs[2]))

    def op_Gemm(self, node, env):
        A = self._t(env, node.inputs[0])
        B = self._t(env, node.inputs[1])
        C = self._t(env, node.inputs[2]) if len(node.inputs) > 2 else None
        return autograd.gemm(A, B, C,
                             _attr(node.proto, "alpha", 1.0),
                             _attr(node.proto, "beta", 1.0),
                             int(_attr(node.proto, "transA", 0)),
                             int(_attr(node.proto, "transB", 0)))

    # ==== shape ==========================================================
    def op_Reshape(self, node, env):
        shape = self._const(env, node, 1, attr="shape")
        x = self._t(env, node.inputs[0])
        shape = [int(s) if s != 0 else x.shape[i]
                 for i, s in enumerate(np.asarray(shape).tolist())]
        return autograd.reshape(x, shape)

    def op_Flatten(self, node, env):
        return autograd.flatten(self._t(env, node.inputs[0]),
                                int(_attr(node.proto, "axis", 1)))

    def op_Transpose(self, node, env):
        return autograd.transpose(self._t(env, node.inputs[0]),
                                  _attr(node.proto, "perm"))

    def op_Squeeze(self, node, env):
        axes = self._const(env, node, 1, attr="axes")
        axes = tuple(int(a) for a in np.atleast_1d(axes)) if axes is not None \
            else None
        return autograd.squeeze(self._t(env, node.inputs[0]), axes)

    def op_Unsqueeze(self, node, env):
        axes = self._const(env, node, 1, attr="axes")
        return autograd.unsqueeze(self._t(env, node.inputs[0]),
                                  [int(a) for a in np.atleast_1d(axes)])

    def op_Concat(self, node, env):
        return autograd.cat([self._t(env, n) for n in node.inputs],
                            int(_attr(node.proto, "axis", 0)))

    def op_Slice(self, node, env):
        starts = self._const(env, node, 1, attr="starts")
        ends = self._const(env, node, 2, attr="ends")
        axes = self._const(env, node, 3, attr="axes")
        steps = self._const(env, node, 4)
        x = self._t(env, node.inputs[0])
        starts = [int(v) for v in np.atleast_1d(starts)]
        ends = [int(min(v, np.iinfo(np.int32).max)) for v in np.atleast_1d(ends)]
        axes = [int(v) for v in np.atleast_1d(axes)] if axes is not None \
            else list(range(len(starts)))
        steps = [int(v) for v in np.atleast_1d(steps)] if steps is not None \
            else None
        return autograd.slice(x, starts, ends, axes, steps)

    def op_Split(self, node, env):
        x = self._t(env, node.inputs[0])
        axis = int(_attr(node.proto, "axis", 0))
        parts = self._const(env, node, 1, attr="split")
        if parts is None:
            n = len(node.outputs)
            d = x.shape[axis] // n
            parts = [d] * n
        else:
            parts = [int(p) for p in np.atleast_1d(parts)]
        return autograd.split(x, axis, parts)

    def op_Gather(self, node, env):
        idx = self._const(env, node, 1)
        x = self._t(env, node.inputs[0])
        axis = int(_attr(node.proto, "axis", 0))
        if idx is not None:
            return autograd.gather(x, axis, idx.astype(np.int32))
        # dynamic indices (e.g. token ids at runtime): embedding-style gather
        ids = self._t(env, node.inputs[1])
        if axis == 0:
            return autograd.embedding(ids, x)
        return autograd.Gather(axis, ids.numpy())(x)

    def op_Tile(self, node, env):
        reps = self._const(env, node, 1, attr="repeats")
        return autograd.tile(self._t(env, node.inputs[0]),
                             [int(r) for r in np.atleast_1d(reps)])

    def op_Expand(self, node, env):
        shape = self._const(env, node, 1)
        return autograd.expand(self._t(env, node.inputs[0]),
                               [int(s) for s in np.atleast_1d(shape)])

    def op_Pad(self, node, env):
        mode = _attr(node.proto, "mode", "constant")
        if isinstance(mode, bytes):
            mode = mode.decode()
        pads = self._const(env, node, 1, attr="pads")
        cval = self._const(env, node, 2, attr="value", default=0.0)
        return autograd.pad(self._t(env, node.inputs[0]), mode,
                            [int(p) for p in np.atleast_1d(pads)],
                            float(np.asarray(cval).ravel()[0]))

    def op_Shape(self, node, env):
        x = env[node.inputs[0]]
        shape = x.shape if isinstance(x, (Tensor, np.ndarray)) else ()
        return np.asarray(shape, np.int64)  # host constant, foldable

    def op_ConstantOfShape(self, node, env):
        shape = self._const(env, node, 0)
        val = node.attrs.get("value", np.zeros(1, np.float32))
        arr = np.full([int(s) for s in np.atleast_1d(shape)],
                      np.asarray(val).ravel()[0])
        return arr.astype(np.asarray(val).dtype)

    def op_Constant(self, node, env):
        return node.attrs["value"]

    def op_OneHot(self, node, env):
        depth = int(np.asarray(self._const(env, node, 1)).ravel()[0])
        values = self._const(env, node, 2, default=np.array([0.0, 1.0]))
        ids = self._t(env, node.inputs[0])
        return autograd.onehot(depth, ids, tuple(np.asarray(values).tolist()),
                               int(_attr(node.proto, "axis", -1)))

    def op_DepthToSpace(self, node, env):
        mode = _attr(node.proto, "mode", "DCR")
        if isinstance(mode, bytes):
            mode = mode.decode()
        return autograd.depth_to_space(self._t(env, node.inputs[0]),
                                       int(node.attrs["blocksize"]), mode)

    def op_SpaceToDepth(self, node, env):
        return autograd.space_to_depth(self._t(env, node.inputs[0]),
                                       int(node.attrs["blocksize"]))

    def op_Upsample(self, node, env):
        scales = self._const(env, node, 1, attr="scales")
        return autograd.upsample(self._t(env, node.inputs[0]), "nearest",
                                 [float(s) for s in np.atleast_1d(scales)])

    def op_Resize(self, node, env):
        # nearest-neighbor integer upscaling only (covers yolo-style usage)
        scales = self._const(env, node, 2)
        if scales is None or len(np.atleast_1d(scales)) == 0:
            sizes = np.atleast_1d(self._const(env, node, 3))
            x = self._t(env, node.inputs[0])
            scales = [s / d for s, d in zip(sizes, x.shape)]
        return autograd.upsample(self._t(env, node.inputs[0]), "nearest",
                                 [float(s) for s in np.atleast_1d(scales)])

    # ==== reductions =====================================================
    def op_ReduceSum(self, node, env):
        axes = self._const(env, node, 1, attr="axes")
        axes = tuple(int(a) for a in np.atleast_1d(axes)) if axes is not None \
            else None
        return autograd.reduce_sum(self._t(env, node.inputs[0]), axes,
                                   bool(_attr(node.proto, "keepdims", 1)))

    def op_ReduceMean(self, node, env):
        axes = self._const(env, node, 1, attr="axes")
        axes = tuple(int(a) for a in np.atleast_1d(axes)) if axes is not None \
            else None
        return autograd.reduce_mean(self._t(env, node.inputs[0]), axes,
                                    bool(_attr(node.proto, "keepdims", 1)))

    # ==== NN =============================================================
    def op_Conv(self, node, env):
        x = self._t(env, node.inputs[0])
        W = self._t(env, node.inputs[1])
        b = self._t(env, node.inputs[2]) if len(node.inputs) > 2 else None
        strides = _attr(node.proto, "strides", [1, 1])
        pads = _attr(node.proto, "pads", [0, 0, 0, 0])
        group = int(_attr(node.proto, "group", 1))
        dil = _attr(node.proto, "dilations", [1, 1])
        auto_pad = _attr(node.proto, "auto_pad", "NOTSET")
        if isinstance(auto_pad, bytes):
            auto_pad = auto_pad.decode()
        dil = [int(d) for d in dil]
        if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
            from ..utils import get_padding_shape
            # SAME pads follow the effective (dilated) kernel extent
            k_eff = [(int(k) - 1) * d + 1
                     for k, d in zip(W.shape[2:], dil)]
            pp = get_padding_shape(auto_pad, x.shape[2:], k_eff, strides)
            pad, odd = (pp[0][0], pp[1][0]), None
            if pp[0][0] != pp[0][1] or pp[1][0] != pp[1][1]:
                pad = (0, 0)
                odd = (pp[1][0], pp[1][1], pp[0][0], pp[0][1])  # l r t b
        else:
            assert pads[0] == pads[2] and pads[1] == pads[3], \
                "asymmetric explicit pads unsupported"
            pad, odd = (int(pads[0]), int(pads[1])), None

        class H:  # geometry carrier, see layer._ConvGeometry
            pass
        h = H()
        h.stride = tuple(int(s) for s in strides)
        h.padding = pad
        h.group = group
        h.odd_padding = odd
        h.dilation = tuple(dil)
        return autograd.conv2d(h, x, W, b)

    def op_BatchNormalization(self, node, env):
        x = self._t(env, node.inputs[0])
        gamma = self._t(env, node.inputs[1])
        beta = self._t(env, node.inputs[2])
        mean = self._t(env, node.inputs[3])
        var = self._t(env, node.inputs[4])
        eps = _attr(node.proto, "epsilon", 1e-5)
        momentum = _attr(node.proto, "momentum", 0.9)
        # in training the running statistics update in place
        return autograd.batchnorm_2d(x, gamma, beta, mean, var, momentum,
                                     eps, train=autograd.training)[0]

    def _pool(self, node, env, is_max):
        x = self._t(env, node.inputs[0])
        kernel = [int(k) for k in node.attrs["kernel_shape"]]
        strides = [int(s) for s in _attr(node.proto, "strides", [1, 1])]
        pads = _attr(node.proto, "pads", [0, 0, 0, 0])
        auto_pad = _attr(node.proto, "auto_pad", "NOTSET")
        if isinstance(auto_pad, bytes):
            auto_pad = auto_pad.decode()
        odd = None
        if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
            from ..utils import get_padding_shape
            pp = get_padding_shape(auto_pad, x.shape[2:], kernel, strides)
            pad = (0, 0)
            odd = (pp[1][0], pp[1][1], pp[0][0], pp[0][1])
        else:
            pad = (int(pads[0]), int(pads[1]))
        return autograd.pooling_2d(x, tuple(kernel), tuple(strides), pad,
                                   is_max, odd_padding=odd)

    def op_MaxPool(self, node, env):
        return self._pool(node, env, True)

    def op_AveragePool(self, node, env):
        return self._pool(node, env, False)

    def op_GlobalAveragePool(self, node, env):
        return autograd.globalaveragepool(self._t(env, node.inputs[0]))

    def op_Dropout(self, node, env):
        ratio = self._const(env, node, 1, attr="ratio", default=0.5)
        out = autograd.dropout(self._t(env, node.inputs[0]),
                               float(np.asarray(ratio).ravel()[0]))
        if len(node.outputs) > 1:
            return out, out  # mask output unused downstream in real models
        return out

    def op_ReduceMax(self, node, env):
        return self._reduce(node, env, autograd.ReduceMax)

    def op_ReduceMin(self, node, env):
        return self._reduce(node, env, autograd.ReduceMin)

    def op_ReduceProd(self, node, env):
        return self._reduce(node, env, autograd.ReduceProd)

    def op_ReduceL1(self, node, env):
        return self._reduce(node, env, autograd.ReduceL1)

    def op_ReduceL2(self, node, env):
        return self._reduce(node, env, autograd.ReduceL2)

    def op_ReduceLogSum(self, node, env):
        return self._reduce(node, env, autograd.ReduceLogSum)

    def op_ReduceLogSumExp(self, node, env):
        return self._reduce(node, env, autograd.ReduceLogSumExp)

    def op_ReduceSumSquare(self, node, env):
        return self._reduce(node, env, autograd.ReduceSumSquare)

    def _reduce(self, node, env, cls):
        axes = self._const(env, node, 1, attr="axes")
        axes = tuple(int(a) for a in np.atleast_1d(axes)) if axes is not None \
            else None
        return cls(axes, bool(_attr(node.proto, "keepdims", 1)))(
            self._t(env, node.inputs[0]))

    def op_ArgMax(self, node, env):
        return autograd.ArgMax(
            int(_attr(node.proto, "axis", 0)),
            int(_attr(node.proto, "keepdims", 1)),
            int(_attr(node.proto, "select_last_index", 0)))(
            self._t(env, node.inputs[0]))

    def op_ArgMin(self, node, env):
        return autograd.ArgMin(
            int(_attr(node.proto, "axis", 0)),
            int(_attr(node.proto, "keepdims", 1)),
            int(_attr(node.proto, "select_last_index", 0)))(
            self._t(env, node.inputs[0]))

    def op_LogSoftmax(self, node, env):
        return autograd.log_softmax(self._t(env, node.inputs[0]),
                                    axis=int(_attr(node.proto, "axis", -1)))

    def op_Hardmax(self, node, env):
        return autograd.Hardmax(int(_attr(node.proto, "axis", -1)))(
            self._t(env, node.inputs[0]))

    def op_HardSwish(self, node, env):
        return autograd.hardswish(self._t(env, node.inputs[0]))

    def op_Celu(self, node, env):
        return autograd.celu(self._t(env, node.inputs[0]),
                             alpha=_attr(node.proto, "alpha", 1.0))

    def op_ThresholdedRelu(self, node, env):
        return autograd.ThresholdedRelu(_attr(node.proto, "alpha", 1.0))(
            self._t(env, node.inputs[0]))

    def op_Shrink(self, node, env):
        return autograd.Shrink(_attr(node.proto, "bias", 0.0),
                               _attr(node.proto, "lambd", 0.5))(
            self._t(env, node.inputs[0]))

    def op_Mod(self, node, env):
        return autograd.Mod(int(_attr(node.proto, "fmod", 0)))(
            self._t(env, node.inputs[0]), self._t(env, node.inputs[1]))

    def op_CumSum(self, node, env):
        axis = int(np.asarray(self._const(env, node, 1)).ravel()[0])
        return autograd.cumsum(self._t(env, node.inputs[0]), axis=axis,
                               exclusive=int(_attr(node.proto, "exclusive", 0)),
                               reverse=int(_attr(node.proto, "reverse", 0)))

    def op_Range(self, node, env):
        start, limit, delta = (np.asarray(self._const(env, node, i)).ravel()[0]
                               for i in range(3))
        return np.arange(start, limit, delta)  # host constant, foldable

    def op_EyeLike(self, node, env):
        dt = node.attrs.get("dtype")
        np_dt = pb._ONNX2NP.get(int(dt)) if dt is not None else None
        return autograd.EyeLike(int(_attr(node.proto, "k", 0)), np_dt)(
            self._t(env, node.inputs[0]))

    def op_Size(self, node, env):
        x = env[node.inputs[0]]
        return np.asarray(np.prod(x.shape), np.int64)  # host constant

    def op_IsNaN(self, node, env):
        return autograd.IsNaN()(self._t(env, node.inputs[0]))

    def op_IsInf(self, node, env):
        return autograd.IsInf(
            int(_attr(node.proto, "detect_negative", 1)),
            int(_attr(node.proto, "detect_positive", 1)))(
            self._t(env, node.inputs[0]))

    def op_Trilu(self, node, env):
        k = self._const(env, node, 1, default=0)
        return autograd.trilu(self._t(env, node.inputs[0]),
                              upper=int(_attr(node.proto, "upper", 1)),
                              k=int(np.asarray(k).ravel()[0]))

    def op_GatherElements(self, node, env):
        idx = self._const(env, node, 1)
        return autograd.GatherElements(
            int(_attr(node.proto, "axis", 0)), idx)(
            self._t(env, node.inputs[0]))

    def op_TopK(self, node, env):
        k = int(np.asarray(self._const(env, node, 1, attr="k")).ravel()[0])
        return autograd.TopK(k, int(_attr(node.proto, "axis", -1)),
                             bool(_attr(node.proto, "largest", 1)))(
            self._t(env, node.inputs[0]))

    def op_LRN(self, node, env):
        return autograd.LRN(int(node.attrs["size"]),
                            _attr(node.proto, "alpha", 1e-4),
                            _attr(node.proto, "beta", 0.75),
                            _attr(node.proto, "bias", 1.0))(
            self._t(env, node.inputs[0]))

    def op_MeanVarianceNormalization(self, node, env):
        axes = _attr(node.proto, "axes", [0, 2, 3])
        return autograd.MeanVarianceNormalization(tuple(axes))(
            self._t(env, node.inputs[0]))

    def op_LpNormalization(self, node, env):
        return autograd.LpNormalization(int(_attr(node.proto, "axis", -1)),
                                        int(_attr(node.proto, "p", 2)))(
            self._t(env, node.inputs[0]))

    def op_InstanceNormalization(self, node, env):
        return autograd.instance_norm(
            self._t(env, node.inputs[0]), self._t(env, node.inputs[1]),
            self._t(env, node.inputs[2]),
            eps=_attr(node.proto, "epsilon", 1e-5))

    def op_ConvTranspose(self, node, env):
        x = self._t(env, node.inputs[0])
        W = self._t(env, node.inputs[1])
        b = self._t(env, node.inputs[2]) if len(node.inputs) > 2 else None
        auto_pad = _attr(node.proto, "auto_pad", "NOTSET")
        if isinstance(auto_pad, bytes):
            auto_pad = auto_pad.decode()
        if auto_pad != "NOTSET" or "output_shape" in node.attrs:
            raise NotImplementedError(
                "ConvTranspose auto_pad/output_shape unsupported; "
                "re-export with explicit pads")
        pads = _attr(node.proto, "pads", [0, 0, 0, 0])
        assert pads[0] == pads[2] and pads[1] == pads[3], \
            "asymmetric ConvTranspose pads unsupported"
        return autograd.conv_transpose2d(
            x, W, b,
            stride=tuple(_attr(node.proto, "strides", [1, 1])),
            padding=(int(pads[0]), int(pads[1])),
            output_padding=tuple(_attr(node.proto, "output_padding", [0, 0])),
            dilation=tuple(_attr(node.proto, "dilations", [1, 1])),
            group=int(_attr(node.proto, "group", 1)))

    def op_GlobalMaxPool(self, node, env):
        return autograd.global_max_pool(self._t(env, node.inputs[0]))

    def op_Einsum(self, node, env):
        eq = node.attrs["equation"]
        if isinstance(eq, bytes):
            eq = eq.decode()
        return autograd.einsum(*[self._t(env, n) for n in node.inputs],
                               equation=eq)

    op_GreaterOrEqual = _binary(lambda a, b: autograd.GreaterOrEqual()(a, b))
    op_LessOrEqual = _binary(lambda a, b: autograd.LessOrEqual()(a, b))

    def _rnn_host(self, node, env):
        """(W, R, B or None) of an LSTM/GRU node as numpy: the
        initializers' host copies (the JAX package reads them back each
        run; they take no gradient there either)."""
        W = self._host_value(env, node.inputs[1])
        R = self._host_value(env, node.inputs[2])
        B = None
        if len(node.inputs) > 3 and node.inputs[3]:
            B = self._host_value(env, node.inputs[3])
        return W, R, B

    def _rnn_param(self, node, key, arr):
        """A converted RNN weight as a Tensor on the device, made once
        per node (a later run, a CUDA-graph capture too, reuses it)."""
        cache = self._rnn_weights.setdefault(node.name, {})
        if key not in cache:
            cache[key] = from_numpy(np.ascontiguousarray(arr, np.float32),
                                    device=self.device)
        return cache[key]

    def op_LSTM(self, node, env):
        """Single-layer uni/bidirectional ONNX LSTM mapped onto the fused
        scan (ops/rnn.py). ONNX gate order iofc, W (dirs, 4H, I),
        R (dirs, 4H, H), B (dirs, 8H); scan expects ifgo with
        Wx (I, 4H)."""
        from ..ops import rnn as rnn_ops
        x = self._t(env, node.inputs[0])       # (seq, batch, input)
        W, R, B = self._rnn_host(node, env)
        seq_lens = None
        if len(node.inputs) > 4 and node.inputs[4]:
            seq_lens = self._t(env, node.inputs[4])
        hidden = int(node.attrs["hidden_size"])
        direction = _attr(node.proto, "direction", "forward")
        if isinstance(direction, bytes):
            direction = direction.decode()

        def _dir(d):
            # iofc -> ifgo (our scan's gate layout: i, f, g(=c), o)
            perm = np.concatenate([np.arange(hidden),              # i
                                   np.arange(2 * hidden, 3 * hidden),  # f
                                   np.arange(3 * hidden, 4 * hidden),  # c->g
                                   np.arange(hidden, 2 * hidden)])     # o
            Wx = self._rnn_param(node, ("Wx", d), W[d][perm].T)
            Wh = self._rnn_param(node, ("Wh", d), R[d][perm].T)
            if B is not None:
                bb = (B[d][:4 * hidden] + B[d][4 * hidden:])[perm]
            else:
                bb = np.zeros(4 * hidden, np.float32)
            b = self._rnn_param(node, ("b", d), bb)
            return Wx, Wh, b

        batch = x.shape[1]
        init_h = self._t(env, node.inputs[5]) \
            if len(node.inputs) > 5 and node.inputs[5] else None
        init_c = self._t(env, node.inputs[6]) \
            if len(node.inputs) > 6 and node.inputs[6] else None
        zeros = self._rnn_param(node, ("zeros", batch),
                                np.zeros((batch, hidden), np.float32))
        outs = []
        dirs = ["forward", "reverse"] if direction == "bidirectional" \
            else [direction]
        for d, dname in enumerate(dirs):
            Wx, Wh, b = _dir(d)
            # initial_h/initial_c: (num_dirs, batch, hidden)
            h0 = autograd.squeeze(autograd.slice(init_h, [d], [d + 1], [0]),
                                  (0,)) if init_h is not None else zeros
            c0 = autograd.squeeze(autograd.slice(init_c, [d], [d + 1], [0]),
                                  (0,)) if init_c is not None else zeros
            xd = x
            if dname == "reverse":
                xd = rnn_ops.reverse_padded(x, seq_lens) if seq_lens is not None \
                    else autograd.flip(x, 0)
            if seq_lens is not None:
                ys, hy, cy = rnn_ops.lstm_scan_ex(xd, seq_lens, h0, c0,
                                                  Wx, Wh, b)
            else:
                ys, hy, cy = rnn_ops.lstm_scan(xd, h0, c0, Wx, Wh, b)
            if dname == "reverse":
                ys = rnn_ops.reverse_padded(ys, seq_lens) \
                    if seq_lens is not None else autograd.flip(ys, 0)
            outs.append((ys, hy, cy))
        if len(outs) == 1:
            ys, hy, cy = outs[0]
            # ONNX Y: (seq, dirs, batch, hidden); Y_h/Y_c: (dirs, batch, H)
            return (autograd.unsqueeze(ys, [1]), autograd.unsqueeze(hy, [0]),
                    autograd.unsqueeze(cy, [0]))
        ys = autograd.cat([autograd.unsqueeze(o[0], [1]) for o in outs], 1)
        hy = autograd.cat([autograd.unsqueeze(o[1], [0]) for o in outs], 0)
        cy = autograd.cat([autograd.unsqueeze(o[2], [0]) for o in outs], 0)
        return ys, hy, cy

    def op_GRU(self, node, env):
        """Single-layer uni/bidirectional ONNX GRU (gate order z|r|h) onto
        the fused GRU scan; honors linear_before_reset and initial_h."""
        from ..ops import rnn as rnn_ops
        x = self._t(env, node.inputs[0])
        W, R, B = self._rnn_host(node, env)
        if len(node.inputs) > 4 and node.inputs[4]:
            raise NotImplementedError(
                "GRU sequence_lens not supported (pad or use LSTM)")
        init_h = self._t(env, node.inputs[5]) \
            if len(node.inputs) > 5 and node.inputs[5] else None
        hidden = int(node.attrs["hidden_size"])
        lbr = bool(_attr(node.proto, "linear_before_reset", 0))
        direction = _attr(node.proto, "direction", "forward")
        if isinstance(direction, bytes):
            direction = direction.decode()
        # ONNX gate order z|r|h -> scan's r|z|h
        perm = np.concatenate([np.arange(hidden, 2 * hidden),
                               np.arange(hidden),
                               np.arange(2 * hidden, 3 * hidden)])
        zeros = self._rnn_param(node, ("zeros", x.shape[1]),
                                np.zeros((x.shape[1], hidden), np.float32))
        dirs = ["forward", "reverse"] if direction == "bidirectional" \
            else [direction]
        outs = []
        for d, dname in enumerate(dirs):
            Wx = self._rnn_param(node, ("Wx", d), W[d][perm].T)
            Wh = self._rnn_param(node, ("Wh", d), R[d][perm].T)
            wb = B[d][:3 * hidden][perm] if B is not None \
                else np.zeros(3 * hidden, np.float32)
            rbv = B[d][3 * hidden:][perm] if B is not None \
                else np.zeros(3 * hidden, np.float32)
            b = self._rnn_param(node, ("b", d), wb)
            rb = self._rnn_param(node, ("rb", d), rbv)
            h0 = autograd.squeeze(autograd.slice(init_h, [d], [d + 1], [0]),
                                  (0,)) if init_h is not None else zeros
            xd = autograd.flip(x, 0) if dname == "reverse" else x
            ys, hy = rnn_ops.gru_scan(xd, h0, Wx, Wh, b, rb,
                                      linear_before_reset=lbr)
            if dname == "reverse":
                ys = autograd.flip(ys, 0)
            outs.append((ys, hy))
        if len(outs) == 1:
            ys, hy = outs[0]
            return autograd.unsqueeze(ys, [1]), autograd.unsqueeze(hy, [0])
        ys = autograd.cat([autograd.unsqueeze(o[0], [1]) for o in outs], 1)
        hy = autograd.cat([autograd.unsqueeze(o[1], [0]) for o in outs], 0)
        return ys, hy

    def op_ScatterElements(self, node, env):
        idx = self._const(env, node, 1)
        axis = int(_attr(node.proto, "axis", 0))
        return autograd.ScatterElements(idx, axis)(
            self._t(env, node.inputs[0]), self._t(env, node.inputs[2]))

    def op_NonZero(self, node, env):
        return autograd.NonZero()(self._t(env, node.inputs[0]))


class SingaRep:
    """Executable representation (ref sonnx.py:1951)."""

    def __init__(self, backend: SingaBackend):
        self.backend = backend
        self.params = backend.params

    def run(self, inputs):
        outs = self.backend.run(inputs)
        return outs


def prepare(model: pb.ModelProto, device=None) -> SingaRep:
    return SingaRep(SingaBackend(model, device))
