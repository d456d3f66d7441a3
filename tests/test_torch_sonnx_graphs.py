"""Port parity, the ONNX backend on handcrafted graphs and the codec:
every graph of tests/test_onnx_extended.py and the handcrafted graphs of
tests/test_sonnx.py, built once with the codec, run through
`singa_tpu.sonnx.prepare` and `singa_tpu_torch.sonnx.prepare` on the same
numpy inputs. Each output is held to the JAX backend's (rtol 1e-5, atol
1e-6; integer outputs exactly) and to the reference the JAX test uses
(numpy or torch). Then the codec: the port's `onnx_pb` writes the same
bytes as the JAX package's for the same messages, and each reads the
other's."""

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jag
from singa_tpu import device as jdevice
from singa_tpu import sonnx as jsonnx
from singa_tpu import tensor as jt
from singa_tpu.sonnx import onnx_pb as jpb
from singa_tpu_torch import autograd as tag
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import sonnx as tsonnx
from singa_tpu_torch import tensor as tt
from singa_tpu_torch.sonnx import backend as tbackend
from singa_tpu_torch.sonnx import onnx_pb as pb

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6
RS = np.random.RandomState(3)
X34 = RS.randn(3, 4).astype(np.float32)


def _model(nodes, inputs, n_outputs, initializers, opset=13):
    in_vis = [pb.make_value_info(k, pb.TensorProto.FLOAT, v.shape)
              for k, v in inputs.items()]
    outs = [o for n in nodes for o in n.output][-n_outputs:]
    graph = pb.GraphProto(
        name="g", node=list(nodes),
        initializer=[pb.numpy_to_tensor(a, nm) for nm, a in initializers],
        input=in_vis,
        output=[pb.make_value_info(o, pb.TensorProto.FLOAT, ())
                for o in outs])
    return pb.ModelProto(ir_version=8, producer_name="t", graph=graph,
                         opset_import=[pb.OperatorSetIdProto(
                             domain="", version=opset)])


def _run(pkg, model_bytes, inputs, train=False):
    """Run the serialized model through one package's backend in eval
    mode; outputs as numpy."""
    if pkg == "jax":
        sonnx, tm, ag, dev = jsonnx, jt, jag, jdevice.best_device()
    else:
        sonnx, tm, ag = tsonnx, tt, tag
        dev = tdevice.create_cpu_device()
    m = sonnx.onnx_pb.ModelProto.FromString(model_bytes)
    rep = sonnx.prepare(m, dev)
    prev = ag.training
    ag.training = train
    try:
        res = rep.run([tm.from_numpy(v, device=dev) for v in inputs.values()])
    finally:
        ag.training = prev
    return [np.asarray(r.numpy() if hasattr(r, "numpy") else r)
            for r in res]


def _lstm_onnx(m, H, I):
    """torch.nn.LSTM's weights in ONNX's layout (gates i|o|f|c)."""
    wi, wf, wg, wo = m.weight_ih_l0.detach().numpy().reshape(4, H, I)
    ri, rf, rg, ro = m.weight_hh_l0.detach().numpy().reshape(4, H, H)
    bwi, bwf, bwg, bwo = m.bias_ih_l0.detach().numpy().reshape(4, H)
    bri, brf, brg, bro = m.bias_hh_l0.detach().numpy().reshape(4, H)
    W = np.concatenate([wi, wo, wf, wg])[None]
    R = np.concatenate([ri, ro, rf, rg])[None]
    B = np.concatenate([np.concatenate([bwi, bwo, bwf, bwg]),
                        np.concatenate([bri, bro, brf, brg])])[None]
    return W, R, B


def _case_reduce(op):
    refs = {"ReduceMax": lambda x: x.max(1, keepdims=True),
            "ReduceMin": lambda x: x.min(1, keepdims=True),
            "ReduceProd": lambda x: x.prod(1, keepdims=True),
            "ReduceL1": lambda x: np.abs(x).sum(1, keepdims=True),
            "ReduceL2": lambda x: np.sqrt((x * x).sum(1, keepdims=True)),
            "ReduceSumSquare": lambda x: (x * x).sum(1, keepdims=True),
            "ReduceLogSumExp":
                lambda x: np.log(np.exp(x).sum(1, keepdims=True))}
    return ([pb.make_node(op, ["x"], ["y"], axes=[1], keepdims=1)],
            {"x": X34}, [], 1, [refs[op](X34)])


def _case_reduce_logsum():
    x = np.abs(X34) + 0.1
    return ([pb.make_node("ReduceLogSum", ["x"], ["y"], axes=[1],
                          keepdims=1)], {"x": x}, [], 1,
            [np.log(x.sum(1, keepdims=True))])


def _case_arg(op, fn):
    return ([pb.make_node(op, ["x"], ["y"], axis=1, keepdims=0)],
            {"x": X34}, [], 1, [fn(X34, 1)])


def _case_logsoftmax():
    e = np.exp(X34 - X34.max(-1, keepdims=True))
    return ([pb.make_node("LogSoftmax", ["x"], ["y"], axis=-1)], {"x": X34},
            [], 1, [np.log(e / e.sum(-1, keepdims=True))])


def _case_hardmax():
    return ([pb.make_node("Hardmax", ["x"], ["y"], axis=-1)], {"x": X34}, [],
            1, [np.eye(4, dtype=np.float32)[X34.argmax(-1)]])


def _case_pointwise(op):
    x = X34
    refs = {"HardSwish": x * np.clip(x / 6 + 0.5, 0, 1),
            "Celu": np.maximum(x, 0) + np.minimum(0, np.exp(x) - 1),
            "ThresholdedRelu": np.where(x > 1.0, x, 0),
            "IsNaN": np.zeros_like(x)}
    return ([pb.make_node(op, ["x"], ["y"])], {"x": x}, [], 1, [refs[op]])


def _case_shrink():
    ref = np.where(X34 < -0.5, X34 + 0.1, np.where(X34 > 0.5, X34 - 0.1, 0))
    return ([pb.make_node("Shrink", ["x"], ["y"], bias=0.1, lambd=0.5)],
            {"x": X34}, [], 1, [ref])


def _case_mod(fmod):
    a = np.array([[5.0, -7.0, 9.0, -4.5]], np.float32)
    b = np.array([[3.0, 3.0, -4.0, -2.0]], np.float32)
    ref = np.fmod(a, b) if fmod else np.mod(a, b)
    return ([pb.make_node("Mod", ["a", "b"], ["y"], fmod=fmod)],
            {"a": a, "b": b}, [], 1, [ref])


def _case_trilu():
    sq = RS.randn(4, 4).astype(np.float32)
    return ([pb.make_node("Trilu", ["x"], ["y"], upper=0)], {"x": sq}, [], 1,
            [np.tril(sq)])


def _case_cumsum():
    return ([pb.make_node("CumSum", ["x", "ax"], ["y"])], {"x": X34},
            [("ax", np.array(1, np.int64))], 1, [np.cumsum(X34, 1)])


def _case_cumsum_reverse():
    return ([pb.make_node("CumSum", ["x", "ax"], ["y"], reverse=1)],
            {"x": X34}, [("ax", np.array(0, np.int64))], 1,
            [np.flip(np.cumsum(np.flip(X34, 0), 0), 0)])


def _case_gather_elements():
    idx = np.array([[0, 2, 1, 3], [3, 1, 0, 2], [1, 1, 2, 0]], np.int64)
    return ([pb.make_node("GatherElements", ["x", "i"], ["y"], axis=1)],
            {"x": X34}, [("i", idx)], 1, [np.take_along_axis(X34, idx, 1)])


def _case_topk():
    order = np.argsort(-X34, -1, kind="stable")[:, :2]
    return ([pb.make_node("TopK", ["x", "k"], ["v", "i"], axis=-1)],
            {"x": X34}, [("k", np.array([2], np.int64))], 2,
            [np.take_along_axis(X34, order, -1), order])


def _case_instance_norm():
    x = RS.randn(2, 3, 5, 5).astype(np.float32)
    g = RS.rand(3).astype(np.float32) + 0.5
    b = RS.randn(3).astype(np.float32)
    m, v = x.mean((2, 3), keepdims=True), x.var((2, 3), keepdims=True)
    ref = (x - m) / np.sqrt(v + 1e-5) * g.reshape(1, 3, 1, 1) \
        + b.reshape(1, 3, 1, 1)
    return ([pb.make_node("InstanceNormalization", ["x", "g", "b"], ["y"],
                          epsilon=1e-5)],
            {"x": x}, [("g", g), ("b", b)], 1, [ref])


def _case_conv_transpose(stride, padding, opad):
    x = RS.randn(2, 3, 7, 7).astype(np.float32)
    W = (RS.randn(3, 4, 3, 3) * 0.2).astype(np.float32)
    b = RS.randn(4).astype(np.float32)
    ref = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(b),
        stride=stride, padding=padding, output_padding=opad).numpy()
    return ([pb.make_node("ConvTranspose", ["x", "w", "b"], ["y"],
                          strides=[stride, stride], pads=[padding] * 4,
                          output_padding=[opad, opad])],
            {"x": x}, [("w", W), ("b", b)], 1, [ref])


def _case_conv_transpose_grouped():
    x = RS.randn(1, 4, 6, 6).astype(np.float32)
    W = (RS.randn(4, 2, 3, 3) * 0.2).astype(np.float32)
    ref = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x), torch.from_numpy(W), stride=2, padding=1,
        groups=2).numpy()
    return ([pb.make_node("ConvTranspose", ["x", "w"], ["y"],
                          strides=[2, 2], pads=[1, 1, 1, 1], group=2)],
            {"x": x}, [("w", W)], 1, [ref])


def _case_global_max_pool():
    x = RS.randn(2, 5, 6, 6).astype(np.float32)
    return ([pb.make_node("GlobalMaxPool", ["x"], ["y"])], {"x": x}, [], 1,
            [x.max((2, 3), keepdims=True)])


def _case_lrn(size, alpha):
    x = RS.randn(2, 6, 4, 4).astype(np.float32)
    ref = torch.nn.functional.local_response_norm(
        torch.from_numpy(x), size, alpha=alpha, beta=0.75, k=1.0).numpy()
    if size % 2 == 0:
        # ONNX's even window, [c - 1, c + 2] for size 4 (torch centres it
        # the other way)
        ref = np.empty_like(x)
        for c in range(6):
            lo, hi = max(0, c - 1), min(6, c + 3)
            acc = (x[:, lo:hi] ** 2).sum(1)
            ref[:, c] = x[:, c] / (1.0 + alpha / size * acc) ** 0.75
    return ([pb.make_node("LRN", ["x"], ["y"], size=size, alpha=alpha,
                          beta=0.75, bias=1.0)], {"x": x}, [], 1, [ref])


def _case_einsum():
    a = RS.randn(3, 4).astype(np.float32)
    b = RS.randn(4, 5).astype(np.float32)
    return ([pb.make_node("Einsum", ["a", "b"], ["y"],
                          equation="ij,jk->ik")],
            {"a": a, "b": b}, [], 1, [a @ b])


def _case_geq():
    a = RS.randn(3, 4).astype(np.float32)
    return ([pb.make_node("GreaterOrEqual", ["a", "c"], ["y"])],
            {"a": a, "c": np.zeros_like(a)}, [], 1,
            [(a >= 0).astype(np.float32)])


def _case_lstm(initial=False):
    S, B, I, H = 5, 2, 3, 4
    x = RS.randn(S, B, I).astype(np.float32)
    m = torch.nn.LSTM(I, H)
    W, R, Bb = _lstm_onnx(m, H, I)
    inits = [("w", W), ("r", R), ("b", Bb)]
    ins = ["x", "w", "r", "b"]
    state = None
    if initial:
        h0 = RS.randn(1, B, H).astype(np.float32)
        c0 = RS.randn(1, B, H).astype(np.float32)
        inits += [("h0", h0), ("c0", c0)]
        ins += ["", "h0", "c0"]
        state = (torch.from_numpy(h0), torch.from_numpy(c0))
    with torch.no_grad():
        ref, (hn, cn) = m(torch.from_numpy(x), state)
    return ([pb.make_node("LSTM", ins, ["Y", "Yh", "Yc"], hidden_size=H)],
            {"x": x}, inits, 3,
            [ref.numpy()[:, None], hn.numpy(), cn.numpy()])


def _case_gru():
    S, B, I, H = 5, 2, 3, 4
    x = RS.randn(S, B, I).astype(np.float32)
    m = torch.nn.GRU(I, H)
    with torch.no_grad():
        ref, hn = m(torch.from_numpy(x))
    wr, wz, wn = m.weight_ih_l0.detach().numpy().reshape(3, H, I)
    rr, rz, rn = m.weight_hh_l0.detach().numpy().reshape(3, H, H)
    bwr, bwz, bwn = m.bias_ih_l0.detach().numpy().reshape(3, H)
    brr, brz, brn = m.bias_hh_l0.detach().numpy().reshape(3, H)
    W = np.concatenate([wz, wr, wn])[None]
    R = np.concatenate([rz, rr, rn])[None]
    Bb = np.concatenate([np.concatenate([bwz, bwr, bwn]),
                         np.concatenate([brz, brr, brn])])[None]
    return ([pb.make_node("GRU", ["x", "w", "r", "b"], ["Y", "Yh"],
                          hidden_size=H, linear_before_reset=1)],
            {"x": x}, [("w", W), ("r", R), ("b", Bb)], 2,
            [ref.numpy()[:, None], hn.numpy()])


def _case_bidirectional(op):
    S, B, I, H = 4, 2, 3, 4
    g = 4 if op == "LSTM" else 3
    x = RS.randn(S, B, I).astype(np.float32)
    W = (RS.randn(2, g * H, I) * 0.1).astype(np.float32)
    R = (RS.randn(2, g * H, H) * 0.1).astype(np.float32)
    outs = ["Y", "Yh", "Yc"] if op == "LSTM" else ["Y", "Yh"]
    extra = {} if op == "LSTM" else {"linear_before_reset": 1}
    return ([pb.make_node(op, ["x", "w", "r"], outs, hidden_size=H,
                          direction="bidirectional", **extra)],
            {"x": x}, [("w", W), ("r", R)], len(outs), None)


def _case_gru_lbr0():
    S, B, I, H = 4, 2, 3, 4
    x = RS.randn(S, B, I).astype(np.float32)
    W = (RS.randn(1, 3 * H, I) * 0.3).astype(np.float32)
    R = (RS.randn(1, 3 * H, H) * 0.3).astype(np.float32)
    Bb = (RS.randn(1, 6 * H) * 0.3).astype(np.float32)

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    Wz, Wr, Wn = W[0].reshape(3, H, I)
    Rz, Rr, Rn = R[0].reshape(3, H, H)
    bwz, bwr, bwn = Bb[0][:3 * H].reshape(3, H)
    brz, brr, brn = Bb[0][3 * H:].reshape(3, H)
    h = np.zeros((B, H), np.float32)
    ref = []
    for t in range(S):
        z = sig(x[t] @ Wz.T + bwz + h @ Rz.T + brz)
        r = sig(x[t] @ Wr.T + bwr + h @ Rr.T + brr)
        n = np.tanh(x[t] @ Wn.T + bwn + (r * h) @ Rn.T + brn)
        h = (1 - z) * n + z * h
        ref.append(h)
    return ([pb.make_node("GRU", ["x", "w", "r", "b"], ["Y", "Yh"],
                          hidden_size=H, linear_before_reset=0)],
            {"x": x}, [("w", W), ("r", R), ("b", Bb)], 2,
            [np.stack(ref)[:, None], h[None]])


def _case_argmax_last(last):
    x = np.array([[5.0, 5.0, 1.0]], np.float32)
    return ([pb.make_node("ArgMax", ["x"], ["y"], axis=1, keepdims=0,
                          select_last_index=last)], {"x": x}, [], 1,
            [np.array([1 if last else 0])])


def _case_opset9_slice():
    x = RS.randn(2, 3, 4).astype(np.float32)
    return ([pb.make_node("Shape", ["x"], ["s"]),
             pb.make_node("Slice", ["s"], ["s2"], starts=[1], ends=[3]),
             pb.make_node("Cast", ["s2"], ["s3"], to=pb.TensorProto.FLOAT)],
            {"x": x}, [], 1, [np.array([3.0, 4.0])])


def _case_mlp_relu():
    rng = np.random.RandomState(0)
    W = rng.randn(3, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    x = rng.randn(2, 3).astype(np.float32)
    return ([pb.make_node("MatMul", ["x", "W"], ["xw"]),
             pb.make_node("Add", ["xw", "b"], ["z"]),
             pb.make_node("Relu", ["z"], ["y"])],
            {"x": x}, [("W", W), ("b", b)], 1, [np.maximum(x @ W + b, 0)])


CASES = {
    **{f"reduce_{op[6:].lower()}": (lambda op=op: _case_reduce(op))
       for op in ("ReduceMax", "ReduceMin", "ReduceProd", "ReduceL1",
                  "ReduceL2", "ReduceSumSquare", "ReduceLogSumExp")},
    "reduce_logsum": _case_reduce_logsum,
    "argmax": lambda: _case_arg("ArgMax", np.argmax),
    "argmin": lambda: _case_arg("ArgMin", np.argmin),
    "logsoftmax": _case_logsoftmax,
    "hardmax": _case_hardmax,
    **{f"pointwise_{op.lower()}": (lambda op=op: _case_pointwise(op))
       for op in ("HardSwish", "Celu", "ThresholdedRelu", "IsNaN")},
    "shrink": _case_shrink,
    "mod_fmod": lambda: _case_mod(1),
    "mod": lambda: _case_mod(0),
    "trilu": _case_trilu,
    "cumsum": _case_cumsum,
    "cumsum_reverse": _case_cumsum_reverse,
    "gather_elements": _case_gather_elements,
    "topk": _case_topk,
    "instance_norm": _case_instance_norm,
    "conv_transpose_s1": lambda: _case_conv_transpose(1, 0, 0),
    "conv_transpose_s2_pad_opad": lambda: _case_conv_transpose(2, 1, 1),
    "conv_transpose_s2": lambda: _case_conv_transpose(2, 0, 0),
    "conv_transpose_grouped": _case_conv_transpose_grouped,
    "global_max_pool": _case_global_max_pool,
    "lrn": lambda: _case_lrn(3, 1e-3),
    "lrn_even_size_window": lambda: _case_lrn(4, 0.3),
    "einsum": _case_einsum,
    "greater_or_equal": _case_geq,
    "lstm": _case_lstm,
    "lstm_initial_state": lambda: _case_lstm(True),
    "gru": _case_gru,
    "gru_lbr0": _case_gru_lbr0,
    "bidirectional_lstm": lambda: _case_bidirectional("LSTM"),
    "bidirectional_gru": lambda: _case_bidirectional("GRU"),
    "argmax_select_last_index": lambda: _case_argmax_last(1),
    "argmax_first_index": lambda: _case_argmax_last(0),
    "opset9_attr_slice_folds": _case_opset9_slice,
    "matmul_add_relu": _case_mlp_relu,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_graph_matches_jax_backend(name):
    torch.manual_seed(0)
    nodes, inputs, inits, n_out, refs = CASES[name]()
    data = _model(nodes, inputs, n_out, inits).SerializeToString()
    jys = _run("jax", data, inputs)
    tys = _run("port", data, inputs)
    assert len(tys) == len(jys) == n_out
    for i, (a, b) in enumerate(zip(tys, jys)):
        assert a.shape == b.shape, (name, i, a.shape, b.shape)
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} output {i}")
        else:
            assert a.dtype == b.dtype, (name, i, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {i}")
    if refs is None:     # bidirectional: the shapes the JAX test checks
        S, B = inputs["x"].shape[:2]
        assert tys[0].shape == (S, 2, B, 4)
        assert all(t.shape == (2, B, 4) for t in tys[1:])
        return
    for i, (a, r) in enumerate(zip(tys, refs)):
        np.testing.assert_allclose(a, np.asarray(r).reshape(a.shape),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name} against its reference")


def test_backend_raises_on_unknown_op():
    node = pb.make_node("TotallyFakeOp", ["x"], ["y"])
    m = _model([node], {"x": np.zeros(1, np.float32)}, 1, [])
    cpu = tdevice.create_cpu_device()
    rep = tsonnx.prepare(m, cpu)
    with pytest.raises(NotImplementedError, match="TotallyFakeOp"):
        rep.run([tt.from_numpy(np.zeros(1, np.float32), device=cpu)])


def test_host_values_upload_once():
    """A Constant and a folded shape feeding device ops are uploaded at
    the first run and the same Tensors serve the second (what lets a
    CUDA-graph capture run the graph without a host copy); a changed
    folded value is uploaded anew."""
    scale = np.array(0.125, np.float32)
    nodes = [pb.make_node("Constant", [], ["c"], value=scale),
             pb.make_node("Mul", ["x", "c"], ["y"]),
             pb.make_node("Shape", ["x"], ["s"]),
             pb.make_node("Reshape", ["y", "s"], ["z"])]
    m = _model(nodes, {"x": X34}, 1, [])
    cpu = tdevice.create_cpu_device()
    rep = tsonnx.prepare(m, cpu)
    be = rep.backend
    out = rep.run([tt.from_numpy(X34, device=cpu)])
    first = dict(be._uploads)
    assert set(first) == {"c"}
    out2 = rep.run([tt.from_numpy(X34, device=cpu)])
    assert be._uploads["c"][1] is first["c"][1]
    np.testing.assert_array_equal(out[0].numpy(), X34 * scale)
    np.testing.assert_array_equal(out2[0].numpy(), out[0].numpy())
    env = {"c": first["c"][1]}
    node = tbackend.OnnxNode(pb.make_node("Tile", ["x", "c"], ["t"]))
    assert be._const(env, node, 1) is first["c"][0]
    env = {"k": np.array([2], np.int64)}
    t1 = be._t(env, "k")
    env = {"k": np.array([2], np.int64)}
    assert be._t(env, "k") is t1
    env = {"k": np.array([3], np.int64)}
    assert be._t(env, "k") is not t1


def test_last_layers_bounds():
    m = _model([pb.make_node("Relu", ["x"], ["y"])],
               {"x": np.ones(2, np.float32)}, 1, [])
    cpu = tdevice.create_cpu_device()
    rep = tsonnx.prepare(m, cpu)
    x = tt.from_numpy(np.ones(2, np.float32), device=cpu)
    with pytest.raises(ValueError, match="last_layers"):
        rep.backend.run([x], last_layers=0)
    with pytest.raises(ValueError, match="last_layers"):
        rep.backend.run([x], last_layers=-5)


def test_sonnx_model_last_layers():
    """Truncated-backbone hook: last_layers=-1 returns the penultimate
    node's output, in both packages."""
    w1 = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    w2 = np.random.RandomState(1).randn(8, 3).astype(np.float32)
    nodes = [pb.make_node("MatMul", ["x", "w1"], ["h"]),
             pb.make_node("Relu", ["h"], ["hr"]),
             pb.make_node("MatMul", ["hr", "w2"], ["y"])]
    m = _model(nodes, {"x": np.zeros((2, 4), np.float32)}, 1,
               [("w1", w1), ("w2", w2)])
    x = np.random.RandomState(2).randn(2, 4).astype(np.float32)
    cpu = tdevice.create_cpu_device()
    sm = tsonnx.SONNXModel(m, device=cpu)
    full = sm.forward(tt.from_numpy(x, device=cpu))
    trunc = sm.forward(tt.from_numpy(x, device=cpu), last_layers=-1)
    np.testing.assert_allclose(full.numpy(), np.maximum(x @ w1, 0) @ w2,
                               rtol=1e-5)
    np.testing.assert_allclose(trunc.numpy(), np.maximum(x @ w1, 0),
                               rtol=1e-5)
    jm = jsonnx.SONNXModel(jpb.ModelProto.FromString(m.SerializeToString()),
                           device=jdevice.best_device())
    jtrunc = jm.forward(jt.from_numpy(x, device=jdevice.best_device()),
                        last_layers=-1)
    np.testing.assert_allclose(trunc.numpy(), jtrunc.numpy(), rtol=RTOL,
                               atol=ATOL)


def _codec_model(mod):
    w = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    node = mod.make_node("Gemm", ["x", "w"], ["y"], alpha=1.0, transB=1,
                         pads=[1, -1], mode="constant", scales=[0.5, 2.0])
    graph = mod.GraphProto(
        name="g", node=[node],
        initializer=[mod.numpy_to_tensor(w, "w"),
                     mod.numpy_to_tensor(np.array([-5, 7], np.int64), "i"),
                     mod.numpy_to_tensor(np.arange(6, dtype=np.int32)
                                         .reshape(2, 3), "j")],
        input=[mod.make_value_info("x", mod.TensorProto.FLOAT, (2, 3))],
        output=[mod.make_value_info("y", mod.TensorProto.FLOAT, (2, 4))])
    return mod.ModelProto(ir_version=8, producer_name="t", graph=graph,
                          opset_import=[mod.OperatorSetIdProto(
                              domain="", version=13)])


def test_codec_bytes_equal_jax():
    """The same ModelProto serializes to the same bytes in both codecs,
    and each parses the other's."""
    tb = _codec_model(pb).SerializeToString()
    jb = _codec_model(jpb).SerializeToString()
    assert tb == jb
    back = pb.ModelProto.FromString(jb)
    assert back.SerializeToString() == jb
    assert jpb.ModelProto.FromString(tb).SerializeToString() == tb


def test_codec_roundtrip():
    m2 = pb.ModelProto.FromString(_codec_model(pb).SerializeToString())
    assert m2.ir_version == 8
    assert m2.graph.node[0].op_type == "Gemm"
    attrs = m2.graph.node[0].attrs()
    assert attrs["alpha"] == 1.0 and attrs["transB"] == 1
    assert attrs["pads"] == [1, -1] and attrs["mode"] == "constant"
    np.testing.assert_array_equal(
        pb.tensor_to_numpy(m2.graph.initializer[0]),
        np.random.RandomState(0).randn(4, 3).astype(np.float32))
    vi = m2.graph.input[0]
    assert vi.name == "x"
    assert [d.dim_value for d in vi.type.tensor_type.shape.dim] == [2, 3]


def test_codec_negative_and_dtypes():
    t = pb.numpy_to_tensor(np.array([-5, 7], np.int64), "i")
    t2 = pb.TensorProto.FromString(t.SerializeToString())
    np.testing.assert_array_equal(pb.tensor_to_numpy(t2),
                                  np.array([-5, 7], np.int64))
    a = pb.make_attribute("axis", -1)
    assert pb.AttributeProto.FromString(a.SerializeToString()).value() == -1
