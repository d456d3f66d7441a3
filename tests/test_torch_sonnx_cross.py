"""Port parity, ONNX files crossing the packages: the same model (weights
carried over with `load_singa_params` or `set_params`) exported by
`singa_tpu.sonnx.export` and by `singa_tpu_torch.sonnx.export`. The two
files hold equal initializers (names in order, values bit for bit) and
the same multiset of node op_types; the JAX file runs in the port and the
port's file in JAX, each matching the exporting model's eval forward
(rtol 2e-4, as tests/test_sonnx.py:146), and each package's own file in
itself. Models: the MLP, the CNN, the fused LSTM (CudnnRNN) and GRU, the
ConvTranspose superres step and the Pad/UpSample/DepthToSpace chain; the
GPT is in test_torch_sonnx_cross_gpt.py, which shares this harness."""

import collections

import numpy as np
import torch

from singa_tpu import autograd as jag
from singa_tpu import device as jdevice
from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu import models as jmodels
from singa_tpu import sonnx as jsonnx
from singa_tpu import tensor as jt
from singa_tpu.ops import rnn as jrnn
from singa_tpu_torch import autograd as tag
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import models as tmodels
from singa_tpu_torch import sonnx as tsonnx
from singa_tpu_torch import tensor as tt
from singa_tpu_torch.ops import rnn as trnn

torch.set_num_threads(2)
RTOL = ATOL = 2e-4
JDEV = jdevice.best_device()
CPU = tdevice.create_cpu_device()


def _pkg(name):
    if name == "jax":
        return dict(ag=jag, tm=jt, sonnx=jsonnx, dev=JDEV, Model=jmodel.Model)
    return dict(ag=tag, tm=tt, sonnx=tsonnx, dev=CPU, Model=tmodel.Model)


def _tensors(p, arrays):
    return [p["tm"].Tensor(data=a, device=p["dev"]) if a.dtype == np.float32
            else p["tm"].from_numpy(a, device=p["dev"]) for a in arrays]


def _wrap(p, fn):
    class Wrap(p["Model"]):
        def forward(self, *xs):
            return fn(*xs)

        def train_one_batch(self, *a):
            raise NotImplementedError
    return Wrap()


def _first(out):
    out = out[0] if isinstance(out, (tuple, list)) else out
    return out.numpy() if isinstance(out, jt.Tensor) \
        or isinstance(out, tt.Tensor) else out.detach().numpy()


def _eval_ref(p, m, arrays):
    xs = _tensors(p, arrays)
    m.compile(xs, is_train=False, use_graph=False)
    m.eval()
    with torch.no_grad():
        return _first(m.forward(*_tensors(p, arrays)))


def _run_file(p, path, arrays):
    rep = p["sonnx"].prepare(p["sonnx"].load_model(path), p["dev"])
    prev = p["ag"].training
    p["ag"].training = False
    try:
        return _first(rep.run(_tensors(p, arrays)))
    finally:
        p["ag"].training = prev


def _cross(models, arrays, tmp_path):
    """models: {"jax": model, "port": model} with equal weights (built
    by the caller). Exports both, compares the files, runs each in
    both packages."""
    refs, files, protos = {}, {}, {}
    for name, m in models.items():
        p = _pkg(name)
        refs[name] = _eval_ref(p, m, arrays)
        files[name] = str(tmp_path / f"{name}.onnx")
        protos[name] = p["sonnx"].export(m, _tensors(p, arrays),
                                         files[name])
    np.testing.assert_allclose(refs["port"], refs["jax"], rtol=RTOL,
                               atol=ATOL)
    j, t = protos["jax"].graph, protos["port"].graph
    assert [i.name for i in t.initializer] == [i.name for i in j.initializer]
    for a, b in zip(t.initializer, j.initializer):
        np.testing.assert_array_equal(
            tsonnx.onnx_pb.tensor_to_numpy(a),
            jsonnx.onnx_pb.tensor_to_numpy(b), err_msg=a.name)
    assert collections.Counter(n.op_type for n in t.node) \
        == collections.Counter(n.op_type for n in j.node)
    assert [(i.name, i.type.tensor_type.elem_type) for i in t.input] \
        == [(i.name, i.type.tensor_type.elem_type) for i in j.input]
    for runner in ("jax", "port"):
        for maker in ("jax", "port"):
            got = _run_file(_pkg(runner), files[maker], arrays)
            np.testing.assert_allclose(
                got, refs[maker], rtol=RTOL, atol=ATOL,
                err_msg=f"{maker}'s file run by {runner}")
    return protos


def _carry(jm, tm_, arrays):
    """Compile both on `arrays` (deferred params made), then copy JAX's
    parameters into the port's by name."""
    jm.compile(_tensors(_pkg("jax"), arrays), is_train=False,
               use_graph=False)
    tm_.compile(_tensors(_pkg("port"), arrays), is_train=False,
                use_graph=False)
    tm_.set_params({k: jt.to_numpy(v) for k, v in jm.get_params().items()})


def test_mlp_crosses(tmp_path):
    x = np.random.RandomState(0).randn(4, 10).astype(np.float32)
    jm = jmodels.create_model("mlp", data_size=10, num_classes=3)
    tm_ = tmodels.create_model("mlp", data_size=10, num_classes=3)
    _carry(jm, tm_, [x])
    protos = _cross({"jax": jm, "port": tm_}, [x], tmp_path)
    assert len(protos["port"].graph.input) == 1


def test_cnn_crosses(tmp_path):
    x = np.random.RandomState(0).randn(2, 1, 28, 28).astype(np.float32)
    jm = jmodels.create_model("cnn")
    tm_ = tmodels.create_model("cnn")
    _carry(jm, tm_, [x])
    _cross({"jax": jm, "port": tm_}, [x], tmp_path)


def test_fused_lstm_crosses(tmp_path):
    """CudnnRNN's _LSTMScan exports as an ONNX LSTM node (gate order
    ifgo -> iofc) and re-imports through op_LSTM."""
    x = np.random.RandomState(2).randn(5, 3, 4).astype(np.float32)
    built = {}
    for name, lay in (("jax", jlayer), ("port", tlayer)):
        m = _wrap(_pkg(name), None)
        m.rnn = lay.CudnnRNN(hidden_size=6)
        m.forward = (lambda mm: (lambda xx: mm.rnn(xx)))(m)
        built[name] = m
    _carry(built["jax"], built["port"], [x])
    protos = _cross(built, [x], tmp_path)
    assert "LSTM" in {n.op_type for n in protos["port"].graph.node}


def _leaves(p, arrays):
    return [p["tm"].Tensor(data=a, device=p["dev"]) for a in arrays]


def test_fused_gru_crosses(tmp_path):
    """_GRUScan -> ONNX GRU (gate order r|u|n -> z|r|h, with the
    recurrent bias and linear_before_reset)."""
    rng = np.random.RandomState(3)
    H, I = 5, 4
    ws = [(rng.randn(I, 3 * H) * 0.3).astype(np.float32),
          (rng.randn(H, 3 * H) * 0.3).astype(np.float32),
          (rng.randn(3 * H) * 0.1).astype(np.float32),
          (rng.randn(3 * H) * 0.1).astype(np.float32),
          np.zeros((3, H), np.float32)]
    x = rng.randn(6, 3, I).astype(np.float32)
    built = {}
    for name, rnn in (("jax", jrnn), ("port", trnn)):
        Wx, Wh, b, rb, h0 = _leaves(_pkg(name), ws)
        built[name] = _wrap(_pkg(name), (
            lambda rnn, Wx, Wh, b, rb, h0: lambda xx: rnn.gru_scan(
                xx, h0, Wx, Wh, b, rb)[0])(rnn, Wx, Wh, b, rb, h0))
    protos = _cross(built, [x], tmp_path)
    assert "GRU" in {n.op_type for n in protos["port"].graph.node}


def test_conv_transpose_superres_crosses(tmp_path):
    """The superres upscaling step: ConvTranspose with stride 2, pads 1
    and output_padding 1."""
    rng = np.random.RandomState(1)
    W = (rng.randn(4, 3, 3, 3) * 0.2).astype(np.float32)
    b = (rng.randn(3) * 0.1).astype(np.float32)
    x = rng.randn(2, 4, 7, 7).astype(np.float32)
    built = {}
    for name in ("jax", "port"):
        p = _pkg(name)
        tW, tb = _leaves(p, [W, b])
        built[name] = _wrap(p, (lambda ag, tW, tb: lambda xx:
                                ag.conv_transpose2d(
                                    xx, tW, tb, stride=(2, 2),
                                    padding=(1, 1), output_padding=(1, 1)))(
            p["ag"], tW, tb))
    _cross(built, [x], tmp_path)


def test_pad_upsample_space_ops_cross(tmp_path):
    """Pad (constant, reflect, edge) -> UpSample (Resize) ->
    SpaceToDepth -> DepthToSpace."""
    def fn(ag):
        def f(x):
            y = ag.Pad("constant", [0, 0, 1, 1, 0, 0, 1, 1], 0.5)(x)
            y = ag.Pad("reflect", [0, 0, 1, 1, 0, 0, 1, 1])(y)
            y = ag.Pad("edge", [0, 0, 0, 1, 0, 0, 1, 0])(y)
            y = ag.UpSample([1, 1, 2, 2])(y)
            y = ag.SpaceToDepth(2)(y)
            return ag.DepthToSpace(2, "DCR")(y)
        return f

    x = np.random.RandomState(0).randn(2, 4, 5, 5).astype(np.float32)
    _cross({"jax": _wrap(_pkg("jax"), fn(jag)),
            "port": _wrap(_pkg("port"), fn(tag))}, [x], tmp_path)


def test_flip_einsum_globalmaxpool_roundtrip(tmp_path):
    def fn(x):
        y = tag.Flip(0)(x)
        y = tag.Einsum("nchw->nhwc")(y)
        y = tag.Einsum("nhwc->nchw")(y)
        return tag.GlobalMaxPool()(y)

    x = np.random.RandomState(4).randn(2, 3, 4, 4).astype(np.float32)
    p = _pkg("port")
    ref = _eval_ref(p, _wrap(p, fn), [x])
    tsonnx.export(_wrap(p, fn), _tensors(p, [x]), str(tmp_path / "f.onnx"))
    for runner in ("port", "jax"):
        got = _run_file(_pkg(runner), str(tmp_path / "f.onnx"), [x])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
