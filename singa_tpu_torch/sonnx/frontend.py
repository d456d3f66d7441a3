"""ONNX export (counterpart of singa_tpu/sonnx/frontend.py): trace the
tape of one training-mode forward into a ModelProto.

Reference parity: SingaFrontend (python/singa/sonnx.py:86-1035) walks the
buffered op list and renames ops to ONNX. Here the source of truth is the
creator graph recorded by one training-mode forward: each Operator maps to
one ONNX node or a few (plus initializers for parameters and attribute
tensors). The fused attention (`_FlashAttention`, kernel K1 on the card)
decomposes into MatMul/Softmax with a baked causal mask, the rotary
embedding into baked cos/sin tables and Slice/Neg/Concat.

A layer's parameters enter the tape raw (`nn.Parameter`s) and a leaf
Tensor's `.data` is its storage, so leaves are named by `id` of the raw
tensor: `export` maps the model's `get_states()` names onto them, and the
two packages' exporters write the same initializer names.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from ..tensor import Tensor, _raw
from . import onnx_pb as pb

OPSET_VERSION = 17  # LayerNormalization needs 17; everything else <= 13


class _Ctx:
    def __init__(self, param_names=None):
        self.names = {}        # (op, out_idx) -> tensor name
        self.nodes = []        # NodeProto list (topo order)
        self.initializers = []  # TensorProto list
        self.graph_inputs = []  # ValueInfoProto
        self.counter = 0
        self._init_names = set()
        self.param_names = param_names or {}  # id(Tensor) -> scoped name
        self._tensor_names = {}               # id(Tensor) -> init name

    def fresh(self, hint="t"):
        self.counter += 1
        return f"{hint}_{self.counter}"

    def add_initializer(self, name, arr):
        if name in self._init_names:
            return name
        self._init_names.add(name)
        self.initializers.append(pb.numpy_to_tensor(np.asarray(arr), name))
        return name

    def init_name_for(self, t, hint="param"):
        """Stable unique initializer name for a leaf (a Tensor or a raw
        parameter; the scoped model name preferred; collisions like two
        layers both naming their weight 'W' get a numeric suffix)."""
        key = id(_raw(t))
        if key in self._tensor_names:
            return self._tensor_names[key]
        name = self.param_names.get(key) \
            or (t.name if isinstance(t, Tensor) else None) or hint
        while name in self._init_names:
            name = self.fresh(name)
        self._tensor_names[key] = name
        self.add_initializer(name, _to_numpy(t))
        return name


_TORCH2NP = {torch.float32: np.float32, torch.float16: np.float16,
             torch.float64: np.float64, torch.int8: np.int8,
             torch.uint8: np.uint8, torch.int16: np.int16,
             torch.int32: np.int32, torch.int64: np.int64,
             torch.bool: np.bool_}


def _np_dtype(dt):
    """numpy dtype of a torch dtype (None for one numpy lacks: bf16)."""
    dt = autograd._resolve_dtype(dt)
    return np.dtype(_TORCH2NP[dt]) if dt in _TORCH2NP else None


def _to_numpy(t) -> np.ndarray:
    """Host copy of a Tensor, a raw tensor or an array (bf16 as fp32)."""
    if isinstance(t, Tensor):
        return t.numpy()
    if torch.is_tensor(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(t)


def _input_name(ctx: _Ctx, op, idx, input_ids):
    """Name of the idx-th input of `op` (follows the tape edge)."""
    src_op, x_id, x_tensor, _ = op.src[idx]
    if isinstance(src_op, autograd.Dummy):
        key = (src_op, 0)
        if key not in ctx.names:
            if x_id in input_ids:
                name = f"input_{input_ids[x_id]}"
                dt = pb._NP2ONNX.get(_np_dtype(x_tensor.dtype),
                                     pb.TensorProto.FLOAT)
                ctx.graph_inputs.append(pb.make_value_info(
                    name, dt, tuple(x_tensor.shape)))
            else:
                name = ctx.init_name_for(x_tensor)
            ctx.names[key] = name
        return ctx.names[key]
    y_idx = src_op.y_id2idx[x_id]
    return ctx.names[(src_op, y_idx)]


def _out_names(ctx: _Ctx, op):
    return [ctx.names.setdefault((op, i), ctx.fresh(op.name))
            for i in range(op._n_out)]


def _emit(ctx, op, ins, outs):
    """Map one Operator instance to ONNX node(s)."""
    t = type(op).__name__
    mk = pb.make_node

    simple = {
        "Add": "Add", "Sub": "Sub", "Mul": "Mul", "Div": "Div", "Pow": "Pow",
        "Matmul": "MatMul", "ReLU": "Relu", "Sigmoid": "Sigmoid",
        "Tanh": "Tanh", "SoftPlus": "Softplus", "SoftSign": "Softsign",
        "Exp": "Exp", "Log": "Log", "Sqrt": "Sqrt", "Abs": "Abs",
        "Negative": "Neg", "Reciprocal": "Reciprocal", "Sign": "Sign",
        "Erf": "Erf", "Identity": "Identity", "Less": "Less",
        "Greater": "Greater", "Equal": "Equal", "Min": "Min", "Max": "Max",
        "And": "And", "Or": "Or", "Xor": "Xor", "Not": "Not",
        "Cos": "Cos", "Cosh": "Cosh", "Sin": "Sin", "Sinh": "Sinh",
        "Tan": "Tan", "Atan": "Atan", "Atanh": "Atanh", "Acos": "Acos",
        "Acosh": "Acosh", "Asin": "Asin", "Asinh": "Asinh",
        "Ceil": "Ceil", "Floor": "Floor", "Round": "Round",
        "GlobalAveragePool": "GlobalAveragePool", "PRelu": "PRelu",
        "Sum": "Sum", "Mean": "Mean", "GlobalMaxPool": "GlobalMaxPool",
        "GreaterOrEqual": "GreaterOrEqual", "LessOrEqual": "LessOrEqual",
        "HardSwish": "HardSwish", "IsNaN": "IsNaN", "Size": "Size",
        "Rounde": "Round",  # ONNX Round IS round-half-to-even
    }
    if t in simple:
        return [mk(simple[t], ins, outs)]
    if t == "AddBias":
        return [mk("Add", ins, outs)]
    if t == "SoftMax":
        return [mk("Softmax", ins, outs, axis=op.axis)]
    if t == "LeakyRelu":
        return [mk("LeakyRelu", ins, outs, alpha=op.a)]
    if t == "Elu":
        return [mk("Elu", ins, outs, alpha=op.alpha)]
    if t == "SeLU":
        return [mk("Selu", ins, outs, alpha=op.alpha, gamma=op.gamma)]
    if t == "HardSigmoid":
        return [mk("HardSigmoid", ins, outs, alpha=op.alpha, beta=op.gamma)]
    if t == "Clip":
        extra = []
        for v, nm in ((op.min, "min"), (op.max, "max")):
            if v is None:
                extra.append("")
            else:
                extra.append(_const_input(ctx, nm, np.float32(v)))
        return [mk("Clip", ins + extra, outs)]
    if t == "Reshape":
        shape_in = _const_input(ctx, "shape", np.asarray(op.shape, np.int64))
        return [mk("Reshape", ins + [shape_in], outs)]
    if t == "Flatten":
        return [mk("Flatten", ins, outs, axis=op.axis)]
    if t == "Squeeze":
        axes = op.axis if op.axis is not None else []
        axes = list(axes) if isinstance(axes, (list, tuple)) else [axes]
        return [mk("Squeeze",
                   ins + [_const_input(ctx, "axes",
                                       np.asarray(axes, np.int64))], outs)]
    if t == "Unsqueeze":
        return [mk("Unsqueeze",
                   ins + [_const_input(ctx, "axes",
                                       np.asarray(op.axis, np.int64))], outs)]
    if t == "Transpose":
        return [mk("Transpose", ins, outs, perm=list(op.perm)
                   if op.perm else None)]
    if t == "Concat":
        return [mk("Concat", ins, outs, axis=op.axis)]
    if t == "Slice":
        return [mk("Slice", ins + [
            _const_input(ctx, "starts", np.asarray(op.starts, np.int64)),
            _const_input(ctx, "ends", np.asarray(op.ends, np.int64)),
            _const_input(ctx, "axes", np.asarray(op.axes, np.int64)),
            _const_input(ctx, "steps", np.asarray(op.steps, np.int64)),
        ], outs)]
    if t == "Split":
        return [mk("Split", ins + [
            _const_input(ctx, "split", np.asarray(op.parts, np.int64))],
            outs, axis=op.axis)]
    if t == "Gather":
        idx_in = _const_input(ctx, "indices",
                              np.asarray(op.indices, np.int64))
        return [mk("Gather", ins + [idx_in], outs, axis=op.axis)]
    if t == "Embedding":
        # tape edges are (ids, table); ONNX Gather wants (data, indices) —
        # the ids stay a real graph edge (graph input for model inputs),
        # NOT a baked constant, so the exported model consumes its ids
        return [mk("Gather", [ins[1], ins[0]], outs, axis=0)]
    if t == "Tile":
        return [mk("Tile", ins + [
            _const_input(ctx, "repeats",
                         np.asarray(op.repeats, np.int64))], outs)]
    if t == "Expand":
        return [mk("Expand", ins + [
            _const_input(ctx, "shape", np.asarray(op.shape, np.int64))], outs)]
    if t == "Gemm":
        return [mk("Gemm", ins, outs, alpha=op.alpha, beta=op.beta,
                   transA=op.transA, transB=op.transB)]
    if t == "ReduceSum":
        axes = np.asarray(op.axes if op.axes is not None else [], np.int64)
        return [mk("ReduceSum", ins + [_const_input(ctx, "axes", axes)],
                   outs, keepdims=int(op.keepdims))]
    if t == "ReduceMean":
        return [mk("ReduceMean", ins, outs,
                   axes=list(op.axes) if op.axes else None,
                   keepdims=int(op.keepdims))]
    if t == "_Conv2d":
        ph, pw = op.padding
        pads = [ph, pw, ph, pw]
        if op.odd_padding is not None:
            l, r, tt, b = op.odd_padding
            pads = [ph + tt, pw + l, ph + b, pw + r]
        return [mk("Conv", ins, outs, strides=list(op.stride), pads=pads,
                   group=op.group,
                   dilations=list(getattr(op, "dilation", (1, 1))))]
    if t == "_Pooling2d":
        ph, pw = op.padding
        pads = [ph, pw, ph, pw]
        if op.odd_padding is not None:
            l, r, tt, b = op.odd_padding
            pads = [ph + tt, pw + l, ph + b, pw + r]
        return [mk("MaxPool" if op.is_max else "AveragePool", ins, outs,
                   kernel_shape=list(op.kernel), strides=list(op.stride),
                   pads=pads)]
    if t in ("_BatchNorm2d", "_BatchNorm2dInfer"):
        if t == "_BatchNorm2d":
            rm, rv = op._bn_extras
            mean_in = ctx.init_name_for(rm, "bn_mean")
            var_in = ctx.init_name_for(rv, "bn_var")
            ins = ins + [mean_in, var_in]
            momentum = op._bn_momentum
        else:
            momentum = 0.9
        return [mk("BatchNormalization", ins, outs, epsilon=op.eps,
                   momentum=momentum)]
    if t == "SoftMaxCrossEntropy":
        # opset-12 SoftmaxCrossEntropyLoss; targets exported as int64 input
        return [mk("SoftmaxCrossEntropyLoss", ins, outs, reduction="mean")]
    if t == "Dropout":
        # opset >= 12: ratio is an input, not an attribute
        ratio_in = _const_input(ctx, "ratio", np.float32(op.ratio))
        return [mk("Dropout", ins[:1] + [ratio_in], outs)]
    if t == "Cast":
        to = pb._NP2ONNX[_np_dtype(op.to)]
        return [mk("Cast", ins, outs, to=to)]
    if t == "Gelu":
        # the tanh approximation (the layers' GELU); opset<20 has no
        # Gelu node, so emit the exact same formula:
        # 0.5*x*(1+tanh(sqrt(2/pi)*(x+0.044715*x^3)))
        x = ins[0]
        c = lambda nm, v: _const_input(ctx, nm, np.float32(v))
        n = lambda: ctx.fresh("gelu")
        x3, xm, xa, xs, th, t1, hf = n(), n(), n(), n(), n(), n(), n()
        return [
            mk("Pow", [x, c("three", 3.0)], [x3]),
            mk("Mul", [x3, c("k0", 0.044715)], [xm]),
            mk("Add", [x, xm], [xa]),
            mk("Mul", [xa, c("k1", 0.7978845608028654)], [xs]),
            mk("Tanh", [xs], [th]),
            mk("Add", [th, c("one", 1.0)], [t1]),
            mk("Mul", [x, t1], [hf]),
            mk("Mul", [hf, c("half", 0.5)], outs),
        ]
    if t == "LayerNorm":
        # ONNX LayerNormalization (opset 17), normalize last axis
        return [mk("LayerNormalization", ins, outs, axis=-1,
                   epsilon=float(op.eps))]
    if t == "_PosSlice":
        # export path is single-device (offset 0): rows [0, len)
        return [mk("Slice", ins + [
            _const_input(ctx, "starts", np.asarray([0], np.int64)),
            _const_input(ctx, "ends", np.asarray([op.length], np.int64)),
            _const_input(ctx, "axes", np.asarray([0], np.int64)),
        ], outs)]
    if t == "_FlashAttention":
        # decompose the fused kernel to the ONNX math it implements:
        # softmax(q k^T * d^-0.5 [+ causal mask]) v ; q,k,v are (B,H,S,D)
        q, k, v = ins
        shape, _ = op._out_shapes[0]
        S, D = shape[-2], shape[-1]
        n = lambda: ctx.fresh("attn")
        kt, sc, sm = n(), n(), n()
        nodes = [
            mk("Transpose", [k], [kt], perm=[0, 1, 3, 2]),
            mk("MatMul", [q, kt], [sc]),
            mk("Mul", [sc, _const_input(ctx, "scale",
                                        np.float32(D ** -0.5))], [sm]),
        ]
        cur = sm
        if op.causal:
            mask = np.triu(np.full((S, S), -1e9, np.float32), k=1)
            ms = n()
            nodes.append(mk("Add", [cur, _const_input(ctx, "causal_mask",
                                                      mask)], [ms]))
            cur = ms
        pr = n()
        nodes.append(mk("Softmax", [cur], [pr], axis=-1))
        nodes.append(mk("MatMul", [pr, v], outs))
        return nodes
    if t == "Einsum":
        return [mk("Einsum", ins, outs, equation=op.equation)]
    if t in ("ArgMax", "ArgMin"):
        return [mk(t, ins, outs, axis=op.axis,
                   keepdims=int(op.keepdims))]
    if t in ("ReduceMax", "ReduceMin", "ReduceProd", "ReduceL1",
             "ReduceL2", "ReduceLogSum", "ReduceLogSumExp",
             "ReduceSumSquare"):
        return [mk(t, ins, outs,
                   axes=list(op.axes) if op.axes else None,
                   keepdims=int(op.keepdims))]
    if t == "LogSoftmax":
        return [mk("LogSoftmax", ins, outs, axis=op.axis)]
    if t == "Hardmax":
        return [mk("Hardmax", ins, outs, axis=op.axis)]
    if t == "Celu":
        return [mk("Celu", ins, outs, alpha=op.alpha)]
    if t == "ThresholdedRelu":
        return [mk("ThresholdedRelu", ins, outs, alpha=op.alpha)]
    if t == "Shrink":
        return [mk("Shrink", ins, outs, bias=op.bias, lambd=op.lambd)]
    if t == "Mod":
        return [mk("Mod", ins, outs, fmod=op.fmod)]
    if t == "CumSum":
        ax = _const_input(ctx, "axis", np.asarray(op.axis, np.int64))
        return [mk("CumSum", ins + [ax], outs, exclusive=op.exclusive,
                   reverse=op.reverse)]
    if t == "TopK":
        kin = _const_input(ctx, "k", np.asarray([op.k], np.int64))
        return [mk("TopK", ins + [kin], outs, axis=op.axis,
                   largest=int(op.largest))]
    if t == "Trilu":
        kin = _const_input(ctx, "k", np.asarray(op.k, np.int64))
        return [mk("Trilu", ins + [kin], outs, upper=op.upper)]
    if t == "GatherElements":
        idx = _const_input(ctx, "indices",
                           np.asarray(op.indices, np.int64))
        return [mk("GatherElements", ins + [idx], outs, axis=op.axis)]
    if t == "ScatterElements":
        idx = _const_input(ctx, "indices",
                           np.asarray(op.indices, np.int64))
        return [mk("ScatterElements", [ins[0], idx, ins[1]], outs,
                   axis=op.axis)]
    if t == "OneHot":
        depth = _const_input(ctx, "depth", np.asarray(op.depth, np.int64))
        vals = _const_input(ctx, "values",
                            np.asarray(op.values, np.float32))
        return [mk("OneHot", ins + [depth, vals], outs, axis=op.axis)]
    if t == "IsInf":
        return [mk("IsInf", ins, outs, detect_negative=int(op.neg),
                   detect_positive=int(op.pos))]
    if t == "LRN":
        return [mk("LRN", ins, outs, size=op.size, alpha=op.alpha,
                   beta=op.beta, bias=op.bias)]
    if t == "LpNormalization":
        return [mk("LpNormalization", ins, outs, axis=op.axis, p=op.p)]
    if t == "MeanVarianceNormalization":
        return [mk("MeanVarianceNormalization", ins, outs,
                   axes=list(op.axes))]
    if t == "InstanceNorm2d":
        # our op has no scale/bias params; ONNX InstanceNormalization
        # requires them — bake identity scale/zero bias for channel C
        C = op.src[0][2].shape[1]
        return [mk("InstanceNormalization", ins + [
            _const_input(ctx, "scale", np.ones(C, np.float32)),
            _const_input(ctx, "bias", np.zeros(C, np.float32)),
        ], outs, epsilon=op.eps)]
    if t == "Where":
        cond = _const_input(ctx, "cond",
                            np.asarray(_to_numpy(op.condition), np.bool_))
        return [mk("Where", [cond] + ins, outs)]
    if t == "ComputeCast":
        # amp-internal float cast; exported graphs are fp32, so the ONNX
        # side is an explicit Cast (or identity when the dtype is one
        # ONNX doesn't carry, e.g. bfloat16 traced under amp)
        to = pb._NP2ONNX.get(_np_dtype(op.to)) if op.to else None
        if to is None:
            return [mk("Identity", ins, outs)]
        return [mk("Cast", ins, outs, to=to)]
    if t == "Rope":
        # rotary embedding decomposed to baked cos/sin + rotate-half
        # (Slice/Neg/Concat): export traces are single-device (offset 0)
        # with static S, so the tables are constants
        shape, _ = op._out_shapes[0]
        S, D = shape[-2], shape[-1]
        inv = (op.theta ** (-np.arange(0, D // 2, dtype=np.float32)
                            / (D // 2)))
        ang = np.arange(S, dtype=np.float32)[:, None] * inv[None, :]
        cos = np.concatenate([np.cos(ang), np.cos(ang)], -1)
        sin = np.concatenate([np.sin(ang), np.sin(ang)], -1)
        x = ins[0]
        n = lambda: ctx.fresh("rope")
        x1, x2, nx2, rot, xc, rs = (n() for _ in range(6))
        ax = _const_input(ctx, "axes", np.asarray([-1], np.int64))
        half = _const_input(ctx, "half", np.asarray([D // 2], np.int64))
        zero = _const_input(ctx, "zero", np.asarray([0], np.int64))
        end = _const_input(ctx, "end", np.asarray([D], np.int64))
        return [
            mk("Slice", [x, zero, half, ax], [x1]),
            mk("Slice", [x, half, end, ax], [x2]),
            mk("Neg", [x2], [nx2]),
            mk("Concat", [nx2, x1], [rot], axis=-1),
            mk("Mul", [x, _const_input(ctx, "cos", cos)], [xc]),
            mk("Mul", [rot, _const_input(ctx, "sin", sin)], [rs]),
            mk("Add", [xc, rs], outs),
        ]
    if t == "CosSim":
        # no ONNX CosineSimilarity node: decompose (like Gelu)
        a, b = ins
        n = lambda: ctx.fresh("cossim")
        ab, sab, aa, saa, ra, bb2, sbb, rb2, den = (n() for _ in range(9))
        ax = _const_input(ctx, "axes", np.asarray([-1], np.int64))
        return [
            mk("Mul", [a, b], [ab]),
            mk("ReduceSum", [ab, ax], [sab], keepdims=0),
            mk("Mul", [a, a], [aa]),
            mk("ReduceSum", [aa, ax], [saa], keepdims=0),
            mk("Sqrt", [saa], [ra]),
            mk("Mul", [b, b], [bb2]),
            mk("ReduceSum", [bb2, ax], [sbb], keepdims=0),
            mk("Sqrt", [sbb], [rb2]),
            mk("Mul", [ra, rb2], [den]),
            mk("Div", [sab, den], outs),
        ]
    if t == "Flip":
        ax = int(op.axis if not isinstance(op.axis, (list, tuple))
                 else op.axis[0])
        return [mk("Slice", ins + [
            _const_input(ctx, "starts", np.asarray([-1], np.int64)),
            _const_input(ctx, "ends",
                         np.asarray([np.iinfo(np.int64).min], np.int64)),
            _const_input(ctx, "axes", np.asarray([ax], np.int64)),
            _const_input(ctx, "steps", np.asarray([-1], np.int64)),
        ], outs)]
    if t == "Pad":
        extra = [_const_input(ctx, "pads", np.asarray(op.pads, np.int64))]
        if op.mode == "constant":
            extra.append(_const_input(ctx, "value",
                                      np.float32(op.constant)))
        return [mk("Pad", ins + extra, outs, mode=op.mode)]
    if t == "UpSample":
        # a repeat per axis == nearest with floor/asymmetric coordinates
        return [mk("Resize", ins + [
            "", _const_input(ctx, "scales",
                             np.asarray(op.scales, np.float32))], outs,
            mode="nearest", nearest_mode="floor",
            coordinate_transformation_mode="asymmetric")]
    if t == "DepthToSpace":
        return [mk("DepthToSpace", ins, outs, blocksize=op.b,
                   mode=op.mode)]
    if t == "SpaceToDepth":
        return [mk("SpaceToDepth", ins, outs, blocksize=op.b)]
    if t == "_ConvTranspose2d":
        ph, pw = op.padding
        return [mk("ConvTranspose", ins, outs,
                   strides=list(op.stride), pads=[ph, pw, ph, pw],
                   output_padding=list(op.output_padding),
                   dilations=list(op.dilation), group=op.group)]
    if t in ("_LSTMScan", "_LSTMScanEx"):
        return _emit_lstm(ctx, op, ins, outs, t == "_LSTMScanEx")
    if t == "_GRUScan":
        return _emit_gru(ctx, op, ins, outs)
    raise NotImplementedError(
        f"export of op {t} not supported yet"
        + (f" (deliberately: {UNEXPORTABLE[t]})" if t in UNEXPORTABLE
           else ""))


def _leaf_numpy(op, idx, what):
    """Weight tensors of fused RNN nodes must be tape LEAVES so their
    layout can be converted statically into the ONNX gate order."""
    src_op, _, x_tensor, _ = op.src[idx]
    if not isinstance(src_op, autograd.Dummy):
        raise NotImplementedError(
            f"ONNX {what} export needs leaf weight tensors; input {idx} "
            "is a computed value")
    return np.asarray(_to_numpy(x_tensor), np.float32)


def _emit_lstm(ctx, op, ins, outs, has_lengths):
    """_LSTMScan(x, hx, cx, Wx, Wh, b) / _LSTMScanEx(x, lengths, hx, cx,
    Wx, Wh, b) -> ONNX LSTM. Our scan's fused gate order is i|f|g|o on
    (I, 4H) columns; ONNX wants i|o|f|c rows of (1, 4H, I)."""
    mk = pb.make_node
    H = op.hidden
    off = 1 if has_lengths else 0
    Wx = _leaf_numpy(op, 3 + off, "LSTM")
    Wh = _leaf_numpy(op, 4 + off, "LSTM")
    b = _leaf_numpy(op, 5 + off, "LSTM")
    perm = np.concatenate([np.arange(0, H),            # i
                           np.arange(3 * H, 4 * H),    # o
                           np.arange(1 * H, 2 * H),    # f
                           np.arange(2 * H, 3 * H)])   # g -> c
    W = Wx.T[perm][None]                               # (1, 4H, I)
    R = Wh.T[perm][None]
    B = np.concatenate([b[perm], np.zeros(4 * H, np.float32)])[None]
    n = lambda: ctx.fresh("lstm")
    h0u, c0u, Y, Yh, Yc = n(), n(), n(), n(), n()
    ax0 = _const_input(ctx, "axes0", np.asarray([0], np.int64))
    if has_lengths:
        x_in, len_in = ins[0], ins[1]
        h_in, c_in = ins[2], ins[3]
        len32 = n()
        pre = [mk("Cast", [len_in], [len32], to=pb.TensorProto.INT32)]
        seq_in = len32
    else:
        x_in, (h_in, c_in) = ins[0], (ins[1], ins[2])
        pre, seq_in = [], ""
    nodes = pre + [
        mk("Unsqueeze", [h_in, ax0], [h0u]),
        mk("Unsqueeze", [c_in, ax0], [c0u]),
        mk("LSTM", [x_in,
                    _const_input(ctx, "W", W),
                    _const_input(ctx, "R", R),
                    _const_input(ctx, "B", B),
                    seq_in, h0u, c0u], [Y, Yh, Yc], hidden_size=H),
        # Y (seq, 1, batch, H) -> ys (seq, batch, H); Y_h/Y_c drop dirs
        mk("Squeeze", [Y, _const_input(
            ctx, "axes1", np.asarray([1], np.int64))], [outs[0]]),
        mk("Squeeze", [Yh, ax0], [outs[1]]),
        mk("Squeeze", [Yc, ax0], [outs[2]]),
    ]
    return nodes


def _emit_gru(ctx, op, ins, outs):
    """_GRUScan(x, hx, Wx, Wh, b[, rb]) -> ONNX GRU. Our fused gate order
    is r|u|n columns; ONNX wants z|r|h rows (z=u, h=n)."""
    mk = pb.make_node
    H = op.hidden
    Wx = _leaf_numpy(op, 2, "GRU")
    Wh = _leaf_numpy(op, 3, "GRU")
    b = _leaf_numpy(op, 4, "GRU")
    rb = _leaf_numpy(op, 5, "GRU") if len(op.src) > 5 \
        else np.zeros(3 * H, np.float32)
    perm = np.concatenate([np.arange(1 * H, 2 * H),    # u -> z
                           np.arange(0, H),            # r
                           np.arange(2 * H, 3 * H)])   # n -> h
    W = Wx.T[perm][None]
    R = Wh.T[perm][None]
    B = np.concatenate([b[perm], rb[perm]])[None]
    n = lambda: ctx.fresh("gru")
    h0u, Y, Yh = n(), n(), n()
    ax0 = _const_input(ctx, "axes0", np.asarray([0], np.int64))
    return [
        mk("Unsqueeze", [ins[1], ax0], [h0u]),
        mk("GRU", [ins[0],
                   _const_input(ctx, "W", W),
                   _const_input(ctx, "R", R),
                   _const_input(ctx, "B", B),
                   "", h0u], [Y, Yh], hidden_size=H,
           linear_before_reset=int(op.lbr)),
        mk("Squeeze", [Y, _const_input(
            ctx, "axes1", np.asarray([1], np.int64))], [outs[0]]),
        mk("Squeeze", [Yh, ax0], [outs[1]]),
    ]


# ---- the export inventory (tests/test_onnx_inventory.py walks this) -------
# Operator class names the frontend exports (the _emit dispatch above):
EXPORTABLE = frozenset([
    "Add", "Sub", "Mul", "Div", "Pow", "Matmul", "ReLU", "Sigmoid", "Tanh",
    "SoftPlus", "SoftSign", "Exp", "Log", "Sqrt", "Abs", "Negative",
    "Reciprocal", "Sign", "Erf", "Identity", "Less", "Greater", "Equal",
    "Min", "Max", "And", "Or", "Xor", "Not", "Cos", "Cosh", "Sin", "Sinh",
    "Tan", "Atan", "Atanh", "Acos", "Acosh", "Asin", "Asinh", "Ceil",
    "Floor", "Round", "Rounde", "GlobalAveragePool", "GlobalMaxPool",
    "PRelu", "Sum", "Mean", "AddBias", "SoftMax", "LeakyRelu", "Elu",
    "SeLU", "HardSigmoid", "Clip", "Reshape", "Flatten", "Squeeze",
    "Unsqueeze", "Transpose", "Concat", "Slice", "Split", "Gather",
    "Embedding", "Tile", "Expand", "Gemm", "ReduceSum", "ReduceMean",
    "_Conv2d", "_Pooling2d", "_BatchNorm2d", "_BatchNorm2dInfer",
    "SoftMaxCrossEntropy", "Dropout", "Cast", "Gelu", "LayerNorm",
    "_PosSlice", "_FlashAttention", "Einsum", "Flip", "Pad", "UpSample",
    "DepthToSpace", "SpaceToDepth", "_ConvTranspose2d", "_LSTMScan",
    "_LSTMScanEx", "_GRUScan",
    "ArgMax", "ArgMin", "ReduceMax", "ReduceMin", "ReduceProd",
    "ReduceL1", "ReduceL2", "ReduceLogSum", "ReduceLogSumExp",
    "ReduceSumSquare", "LogSoftmax", "Hardmax", "Celu", "ThresholdedRelu",
    "Shrink", "Mod", "CumSum", "TopK", "Trilu", "GatherElements",
    "ScatterElements", "OneHot", "IsInf", "IsNaN", "LRN",
    "LpNormalization", "MeanVarianceNormalization", "InstanceNorm2d",
    "Where", "ComputeCast", "CosSim", "GreaterOrEqual", "LessOrEqual",
    "HardSwish", "Size", "Rope",
])

# Operator class names DELIBERATELY not exported, with the reason — the
# inventory test fails on any op that is in neither set, so a new op is a
# conscious decision, not a silent gap.
UNEXPORTABLE = {
    # tape infrastructure
    "Dummy": "tape leaf, not an op",
    "_ArgReduce": "abstract base (ArgMax/ArgMin are classified)",
    "_Reduce": "abstract base (the Reduce* family is classified)",
    "_BoolBinary": "abstract base (And/Or/Xor/Not are classified)",
    "_CmpBinary": "abstract base (Less/Greater/... are classified)",
    # training-loss ops: ONNX inference graphs export the model body;
    # SoftmaxCrossEntropyLoss covers the exported loss path (SONNXModel)
    "CrossEntropy": "loss on probabilities; no ONNX inference semantics",
    "BinaryCrossEntropy": "training loss (see CrossEntropy)",
    "MeanSquareError": "training loss (see CrossEntropy)",
    "RankingLoss": "training loss (see CrossEntropy)",
    # distributed-only constructs: exports are single-device — transfer
    # the weights into the serial model (set_params) and export that
    "_TPCopy": "tensor-parallel collective (psum vjp)",
    "_TPReduce": "tensor-parallel collective (Megatron g)",
    "_GatherLastDim": "tensor-parallel all-gather on the logits edge",
    "_VocabParallelEmbedding": "vocab-sharded table; export gathered",
    "_VocabParallelSCE": "sharded-logits loss; export the gathered model",
    "_VocabParallelArgmax": "sharded-logits argmax; export gathered",
    "_RingAttention": "sequence-parallel ring over a mesh axis; export "
                      "the single-device flash path",
    "_PipelineBlocks": "pipeline schedule over a mesh axis; export the "
                       "serial model (same weights via set_params)",
    "_Pipeline1F1B": "fused pipeline train step (loss in-schedule)",
    "_MoEOp": "expert routing is data-dependent top-k dispatch; ONNX has "
              "no MoE op and a Scatter decomposition would be quadratic "
              "— serve MoE through generate()/native checkpoints",
    "_ReversePadded": "internal helper of the bidirectional fused RNN; "
                      "the LSTM node's direction attr covers it on the "
                      "ONNX side",
    # shape/constant generators with no stable inference mapping
    "NonZero": "data-dependent output shape (host fallback op)",
    "Shape": "exported models carry static shapes",
    "ConstantOfShape": "constant generator; exported graphs bake "
                       "constants as initializers",
    "EyeLike": "constant generator (see ConstantOfShape)",
}


def _const_input(ctx: _Ctx, hint, arr):
    name = ctx.fresh(hint)
    ctx.add_initializer(name, arr)
    return name


def to_onnx_model(inputs, outputs, model_name="singa_tpu",
                  param_names=None) -> pb.ModelProto:
    """Build a ModelProto from traced outputs.

    inputs: list[Tensor] fed to forward (tape leaves -> graph inputs);
    outputs: list[Tensor] produced by a training-mode forward (so .creator
    chains exist); param_names: optional {id(raw tensor): scoped name}.
    """
    if isinstance(outputs, Tensor):
        outputs = [outputs]
    input_ids = {id(t): i for i, t in enumerate(inputs)}
    ctx = _Ctx(param_names)

    # topo order: DFS postorder over creator edges
    order, seen = [], set()

    def visit(op):
        if op is None or id(op) in seen or isinstance(op, autograd.Dummy):
            return
        seen.add(id(op))
        for src_op, _, _, _ in op.src:
            visit(src_op)
        order.append(op)

    for y in outputs:
        assert y.creator is not None, \
            "trace with autograd.training=True before export"
        visit(y.creator)

    for op in order:
        outs = _out_names(ctx, op)
        ins = [_input_name(ctx, op, i, input_ids) for i in range(len(op.src))]
        ctx.nodes.extend(_emit(ctx, op, ins, outs))

    graph_outputs = []
    for i, y in enumerate(outputs):
        name = ctx.names[(y.creator, y.creator.y_id2idx[id(y)])]
        graph_outputs.append(pb.make_value_info(
            name, pb.TensorProto.FLOAT, y.shape))

    graph = pb.GraphProto(name=model_name, node=ctx.nodes,
                          initializer=ctx.initializers,
                          input=ctx.graph_inputs, output=graph_outputs)
    return pb.ModelProto(
        ir_version=8, producer_name="singa_tpu_torch",
        producer_version="0.1.0",
        graph=graph,
        opset_import=[pb.OperatorSetIdProto(domain="", version=OPSET_VERSION)])


def export(model, inputs, fpath: str, model_name="singa_tpu"):
    """Trace `model.forward(*inputs)` (Tensors) and write an .onnx file.
    The trace runs in training mode with torch's grad off: the tape
    records, torch keeps no graph."""
    # snapshot states: the training-mode trace mutates BN running stats,
    # which must neither leak into the exported initializers nor corrupt
    # the live model
    snapshot = None
    if hasattr(model, "get_states"):
        snapshot = {k: _to_numpy(t).copy()
                    for k, t in model.get_states().items()}
    prev = autograd.training
    autograd.training = True
    try:
        with torch.no_grad():
            out = model.forward(*inputs)
    finally:
        autograd.training = prev
        if snapshot is not None:
            model.set_states(snapshot)
    if isinstance(out, Tensor):
        out = [out]
    param_names = None
    if hasattr(model, "get_states"):
        param_names = {id(_raw(t)): k
                       for k, t in model.get_states().items()}
    m = to_onnx_model(list(inputs), list(out), model_name, param_names)
    pb.save_model(m, fpath)
    return m
