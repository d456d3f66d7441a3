"""Port parity: the export inventory, the SINGA-form transformer layers
and SONNXModel retraining.

- Every Operator subclass of the port is classified by
  `sonnx.frontend.EXPORTABLE` or `UNEXPORTABLE`, and both sets equal the
  JAX package's, entry for entry; the names with no port class yet are
  exactly the distributed operators, which come with distribution.
- `layer.LayerNorm()`, `layer.MultiHeadAttention(num_heads, ...)` and
  `layer.TransformerBlock(num_heads, ...)` with the JAX package's
  signatures and defaults, widths deferred to the first Tensor input:
  parameter names in JAX's order, forward and gradients on the tape
  against JAX from JAX's weights (rtol 1e-4, atol 1e-5), and the raw
  path equal to the tape path.
- A `SONNXModel` on a JAX-exported file retrained 3 SGD steps in both
  packages, in graph mode: losses within rtol 1e-4, the parameters and
  running statistics after, and the `onnx__`/`onnxs__` state names."""

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jag
from singa_tpu import device as jdevice
from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu import opt as jopt
from singa_tpu import sonnx as jsonnx
from singa_tpu import tensor as jt
from singa_tpu.sonnx import frontend as jfrontend
from singa_tpu_torch import autograd as tag
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import opt as topt
from singa_tpu_torch import sonnx as tsonnx
from singa_tpu_torch import tensor as tt
from singa_tpu_torch.sonnx import frontend as tfrontend

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5
JDEV = jdevice.best_device()
CPU = tdevice.create_cpu_device()
#: JAX operators that come with the port's pipeline slice (ROADMAP.md
#: Queue 1 item 5c; the tensor-parallel ones came with 5a, the ring with
#: 5b)
DISTRIBUTED = {"_PipelineBlocks", "_Pipeline1F1B"}


def _operator_classes():
    import singa_tpu_torch.layer            # noqa: F401
    import singa_tpu_torch.models.transformer  # noqa: F401
    import singa_tpu_torch.ops.rnn          # noqa: F401
    seen = {}

    def walk(cls):
        for sub in cls.__subclasses__():
            seen.setdefault(sub.__name__, sub)
            walk(sub)

    walk(tag.Operator)
    return seen


def test_every_operator_is_classified():
    classes = _operator_classes()
    missing = sorted(n for n in classes if n not in tfrontend.EXPORTABLE
                     and n not in tfrontend.UNEXPORTABLE)
    assert not missing, f"operators with no export decision: {missing}"
    assert tfrontend.EXPORTABLE == jfrontend.EXPORTABLE
    assert tfrontend.UNEXPORTABLE == jfrontend.UNEXPORTABLE
    assert not set(tfrontend.EXPORTABLE) & set(tfrontend.UNEXPORTABLE)
    stale = (set(tfrontend.EXPORTABLE) | set(tfrontend.UNEXPORTABLE)) \
        - set(classes)
    assert stale == DISTRIBUTED


def test_unexportable_raises_with_reason():
    x = tt.Tensor(data=np.full((2, 2), 0.25, np.float32), device=CPU,
                  stores_grad=True)
    t = tt.Tensor(data=np.full((2, 2), 0.25, np.float32), device=CPU)
    prev = tag.training
    tag.training = True
    try:
        y = tag.CrossEntropy()(x, t)
    finally:
        tag.training = prev
    with pytest.raises(NotImplementedError, match="deliberately"):
        tfrontend.to_onnx_model([x], [y])


LAYERS = {
    "layernorm": lambda L: L.LayerNorm(),
    "layernorm_eps": lambda L: L.LayerNorm(1e-3),
    "mha": lambda L: L.MultiHeadAttention(4),
    "mha_causal_gqa_rope_bias": lambda L: L.MultiHeadAttention(
        4, causal=True, bias=True, num_kv_heads=2, rope=True,
        rope_theta=500.0),
    "block": lambda L: L.TransformerBlock(4),
    "block_bias_rope_gqa": lambda L: L.TransformerBlock(
        4, mlp_ratio=2, attn_bias=True, num_kv_heads=2, rope=True),
    "block_not_causal": lambda L: L.TransformerBlock(2, causal=False),
}


def _grads(ag, loss, named):
    g = ag.gradients(loss)
    return {n: (g[p].numpy() if isinstance(g[p], (jt.Tensor, tt.Tensor))
                else g[p].detach().numpy())
            for n, p in named.items() if p in g}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_singa_form_layer_matches_jax(name):
    """Deferred widths from the first call, JAX's names and order; the
    tape forward and every parameter's gradient (and the input's) equal
    JAX's from the same weights; the raw path equals the tape path."""
    rng = np.random.RandomState(len(name))
    x = rng.randn(2, 16, 32).astype(np.float32)
    w = rng.randn(2, 16, 32).astype(np.float32)
    jl, tl = LAYERS[name](jlayer), LAYERS[name](tlayer)
    assert not tl._initialized
    prev = jag.training, tag.training
    jag.training = tag.training = True
    try:
        jl(jt.from_numpy(x, device=JDEV))
        tl(tt.from_numpy(x, device=CPU))
        jp, tp = jl.get_params(), tl.get_params()
        assert list(tp) == list(jp)
        assert all(tuple(tp[k].shape) == tuple(jp[k].shape) for k in jp)
        tl.set_params({k: jt.to_numpy(v) for k, v in jp.items()})
        out = {}
        for pkg, ag, tm, lay, dev in (("jax", jag, jt, jl, JDEV),
                                      ("port", tag, tt, tl, CPU)):
            tx = tm.Tensor(data=x, device=dev, stores_grad=True)
            y = lay(tx)
            loss = ag.reduce_sum(ag.mul(y, tm.from_numpy(w, device=dev)),
                                 None, False)
            params = dict(lay.get_params(), x=tx)
            out[pkg] = (y.numpy(), _grads(ag, loss, params))
    finally:
        jag.training, tag.training = prev
    (jy, jg), (ty, tg) = out["jax"], out["port"]
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    assert sorted(tg) == sorted(jg) and "x" in tg
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    raw = tl(torch.from_numpy(x))
    assert type(raw) is torch.Tensor
    np.testing.assert_array_equal(raw.detach().numpy(), ty)


def _small_cnn(L):
    class Net(L["Model"]):
        def __init__(self):
            super().__init__()
            self.conv = L["layer"].Conv2d(4, 3, padding=1)
            self.bn = L["layer"].BatchNorm2d(4)
            self.relu = L["layer"].ReLU()
            self.flat = L["layer"].Flatten()
            self.fc = L["layer"].Linear(3)

        def forward(self, x):
            return self.fc(self.flat(self.relu(self.bn(self.conv(x)))))

        def train_one_batch(self, *a):
            raise NotImplementedError
    return Net()


def _retrainer(sonnx, layer, proto, dev):
    class Retrain(sonnx.SONNXModel):
        def __init__(self):
            super().__init__(proto, dev)
            self.sce = layer.SoftMaxCrossEntropy()

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.sce(out, y)
            self.optimizer(loss)
            return out, loss
    return Retrain()


def test_sonnx_model_retrains_like_jax(tmp_path):
    """A small conv net with batch norm, exported by the JAX package;
    SONNXModel subclasses in both packages retrain it 3 SGD steps (graph
    mode) from that file: the losses, the parameters and the running
    statistics agree, and the loss falls."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 2, 6, 6).astype(np.float32)
    y = rng.randint(0, 3, 8).astype(np.int32)
    net = _small_cnn({"Model": jmodel.Model, "layer": jlayer})
    tx = jt.from_numpy(x, device=JDEV)
    net.compile([tx], is_train=False, use_graph=False)
    jsonnx.export(net, [tx], str(tmp_path / "net.onnx"))
    got = {}
    for pkg, sonnx, layer, opt, tm, dev in (
            ("jax", jsonnx, jlayer, jopt, jt, JDEV),
            ("port", tsonnx, tlayer, topt, tt, CPU)):
        m = _retrainer(sonnx, layer, sonnx.load_model(
            str(tmp_path / "net.onnx")), dev)
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
        bx, by = tm.from_numpy(x, device=dev), tm.from_numpy(y, device=dev)
        m.compile([bx], is_train=True, use_graph=True)
        losses = [float(m(bx, by)[1].numpy()) for _ in range(3)]
        got[pkg] = (losses, {k: np.asarray(tm.to_numpy(v) if isinstance(
            v, tm.Tensor) else v.detach().numpy())
            for k, v in m.get_states().items()})
    (jl, js), (tl, ts) = got["jax"], got["port"]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    assert list(ts) == list(js)
    assert any(k.startswith("onnxs__") for k in ts)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_sonnx_model_states_round_trip(tmp_path):
    """The imported weights are the Model's nn.Parameters and buffers:
    parameters() sees them, save_states/load_states round-trip them and
    the graph's run reads the loaded values."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 2, 6, 6).astype(np.float32)
    net = _small_cnn({"Model": tmodel.Model, "layer": tlayer})
    tx = tt.from_numpy(x, device=CPU)
    net.compile([tx], is_train=False, use_graph=False)
    proto = tsonnx.export(net, [tx], str(tmp_path / "net.onnx"))
    a = tsonnx.SONNXModel(proto, CPU)
    names = [n for n, _ in a.named_parameters()]
    assert names == ["onnx__" + i.name.replace(".", "_")
                     for i in proto.graph.initializer
                     if "running" not in i.name]
    assert sorted(n for n, _ in a.named_buffers()) == [
        "onnxs__bn_running_mean", "onnxs__bn_running_var"]
    with torch.no_grad():
        for p in a.parameters():
            p.mul_(0.5)
    a.save_states(str(tmp_path / "a.zip"))
    b = tsonnx.SONNXModel(proto, CPU)
    b.load_states(str(tmp_path / "a.zip"))
    for (k, p), (_, q) in zip(a.get_states().items(),
                              b.get_states().items()):
        np.testing.assert_array_equal(p.numpy(), q.numpy(), err_msg=k)
    np.testing.assert_array_equal(a(tx).numpy(), b(tx).numpy())
