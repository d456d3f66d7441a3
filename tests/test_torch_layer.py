"""Port parity, the SINGA layers: `singa_tpu_torch.layer` against
`singa_tpu.layer` on seeded numpy inputs. Deferred init creates the
parameters at the first call with JAX's shapes; the legacy call styles;
state names and order equal to JAX's (sublayers made at init and
`register_layers` clashes included); each layer's output, with JAX's
weights carried over, in training and eval (fp32, rtol 1e-4, atol 1e-5);
batch norm's running statistics after two training steps (biased
variance, momentum 0.9 keeping the old value); average pooling at a
padded border (count_include_pad=False); train-mode dropout by its keep
rate and its 1/keep scale."""

from collections import OrderedDict

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jag
from singa_tpu import device as jdevice
from singa_tpu import layer as jl
from singa_tpu import tensor as jt
from singa_tpu_torch import autograd as tag
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tl
from singa_tpu_torch import tensor as tt

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jt(x):
    return jt.from_numpy(x, device=jdevice.best_device())


def _tt(x):
    return tt.from_numpy(x, device=tdevice.create_cpu_device())


class _Train:
    """Both packages' global training switch, restored on exit."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        self.prev = (jag.training, tag.training)
        jag.training = tag.training = self.mode

    def __exit__(self, *exc):
        jag.training, tag.training = self.prev


def _carried(mk_j, mk_t, x):
    """A JAX layer and a port layer, both initialized on x (eval), the
    port's states set from JAX's."""
    j, t = mk_j(), mk_t()
    with _Train(False):
        j(_jt(x))
        t(_tt(x))
    t.set_states({k: jt.to_numpy(v) for k, v in j.get_states().items()})
    return j, t


LAYERS = {
    "linear": (lambda m: m.Linear(5), (3, 4)),
    "linear_legacy": (lambda m: m.Linear(4, 5), (3, 4)),
    "linear_nobias": (lambda m: m.Linear(5, bias=False), (2, 3, 4)),
    "gemm": (lambda m: m.Gemm(5, 0.5, 2.0), (3, 4)),
    "gemm_transA": (lambda m: m.Gemm(5, transA=True, transB=False), (3, 4)),
    "conv": (lambda m: m.Conv2d(4, 3, stride=2, padding=1), (2, 3, 7, 7)),
    "conv_legacy": (lambda m: m.Conv2d(3, 4, 3, 2, 1), (2, 3, 7, 7)),
    "conv_relu_nobias": (lambda m: m.Conv2d(4, (3, 2), bias=False,
                                            activation="RELU"),
                         (2, 3, 6, 6)),
    "conv_same_upper": (lambda m: m.Conv2d(4, 3, stride=2,
                                           pad_mode="SAME_UPPER"),
                        (2, 3, 6, 6)),
    "conv_same_lower_dilated": (lambda m: m.Conv2d(4, 2, dilation=2,
                                                   pad_mode="SAME_LOWER"),
                                (2, 3, 5, 5)),
    "conv_group": (lambda m: m.Conv2d(6, 3, padding=1, group=3),
                   (2, 3, 5, 5)),
    "separable": (lambda m: m.SeparableConv2d(5, 3, padding=1), (2, 3, 6, 6)),
    "separable_legacy": (lambda m: m.SeparableConv2d(3, 5, 3, 2, 1),
                         (2, 3, 6, 6)),
    "batchnorm": (lambda m: m.BatchNorm2d(3), (4, 3, 5, 5)),
    "batchnorm_legacy": (lambda m: m.BatchNorm2d(3, 0.7), (4, 3, 5, 5)),
    "maxpool": (lambda m: m.MaxPool2d(3, 2, 1), (2, 3, 7, 7)),
    "maxpool_same": (lambda m: m.Pooling2d(3, 2, pad_mode="SAME_UPPER"),
                     (2, 3, 6, 6)),
    "avgpool": (lambda m: m.AvgPool2d(3, 2, 1), (2, 3, 7, 7)),
    "avgpool_same_lower": (lambda m: m.Pooling2d(2, 2, is_max=False,
                                                 pad_mode="SAME_LOWER"),
                           (2, 3, 5, 5)),
    "maxpool1d": (lambda m: m.MaxPool1d(3, 2, 1), (2, 3, 9)),
    "avgpool1d": (lambda m: m.AvgPool1d(2), (2, 3, 8)),
    "globalavgpool": (lambda m: m.GlobalAvgPool2d(), (2, 3, 4, 5)),
    "relu": (lambda m: m.ReLU(), (3, 4)),
    "sigmoid": (lambda m: m.Sigmoid(), (3, 4)),
    "tanh": (lambda m: m.Tanh(), (3, 4)),
    "flatten": (lambda m: m.Flatten(2), (2, 3, 4)),
    "reshape": (lambda m: m.Reshape((6, -1)), (2, 3, 4)),
    "softmax": (lambda m: m.SoftMax(), (3, 4)),
    "dropout_eval_or_zero": (lambda m: m.Dropout(0.0), (3, 4)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    """Deferred shapes and names equal JAX's; with JAX's weights carried
    over the output matches in eval and in training (two calls: the
    second sees the running statistics the first updated)."""
    mk, shape = LAYERS[name]
    x = _x(shape)
    fresh = mk(tl)
    assert not dict(fresh.named_parameters()), "parameters before the call"
    j, t = _carried(lambda: mk(jl), lambda: mk(tl), x)
    js, ts = j.get_states(), t.get_states()
    assert list(ts) == list(js)
    assert [tuple(v.shape) for v in ts.values()] \
        == [tuple(v.shape) for v in js.values()]
    for mode in (False, True, True):
        with _Train(mode):
            want, got = j(_jt(x)), t(_tt(x))
        np.testing.assert_allclose(got.numpy(), jt.to_numpy(want),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} training={mode}")
    for k, v in j.get_states().items():
        np.testing.assert_allclose(t.get_states()[k].numpy(),
                                   jt.to_numpy(v), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_embedding_and_losses_match_jax():
    """Embedding (deferred table) and the loss layers on the same
    inputs."""
    ids = np.random.RandomState(1).randint(0, 7, (2, 3)).astype(np.int32)
    j, t = _carried(lambda: jl.Embedding(7, 4), lambda: tl.Embedding(7, 4),
                    ids)
    assert tuple(t.W.shape) == (7, 4) and t.W.dtype == torch.float32
    np.testing.assert_array_equal(t(_tt(ids)).numpy(),
                                  jt.to_numpy(j(_jt(ids))))
    x, p = _x((4, 5)), np.random.RandomState(2).rand(4, 5).astype(np.float32)
    lab = np.array([0, 3, 4, 1], np.int32)
    for jlay, tlay, a, b in (
            (jl.SoftMaxCrossEntropy(), tl.SoftMaxCrossEntropy(), x, lab),
            (jl.MeanSquareError(), tl.MeanSquareError(), x, p),
            (jl.CrossEntropy(), tl.CrossEntropy(), p, p),
            (jl.BinaryCrossEntropy(), tl.BinaryCrossEntropy(), p, p)):
        np.testing.assert_allclose(tlay(_tt(a), _tt(b)).numpy(),
                                   jt.to_numpy(jlay(_jt(a), _jt(b))),
                                   rtol=RTOL, atol=ATOL)
    xs = [_x((2, 3)), _x((2, 2), 1)]
    np.testing.assert_array_equal(
        tl.Cat(1)([_tt(a) for a in xs]).numpy(),
        jt.to_numpy(jl.Cat(1)([_jt(a) for a in xs])))
    np.testing.assert_array_equal(
        tl.Add()(_tt(xs[0]), _tt(xs[0])).numpy(), 2 * xs[0])


def test_legacy_call_styles():
    """Conv2d(in, out, k[, stride[, pad]]) and BatchNorm2d(num[,
    momentum]) re-derive the input width; Linear(in, out) checks it, and
    with a generator draws at construction (the GPT's style)."""
    c = tl.Conv2d(99, 4, 3, 2, 1)
    assert (c.nb_kernels, c.kernel_size, c.stride, c.padding) \
        == (4, (3, 3), (2, 2), (1, 1))
    c(_tt(_x((1, 2, 5, 5))))
    assert tuple(c.W.shape) == (4, 2, 3, 3)
    assert tl.BatchNorm2d(8, 0.5).momentum == 0.5
    lin = tl.Linear(4, 5)
    assert lin.in_features == 4 and not dict(lin.named_parameters())
    with pytest.raises(ValueError, match="width 3"):
        lin(_tt(_x((2, 3))))
    g = tl.Linear(4, 5, generator=torch.Generator().manual_seed(0))
    assert tuple(g.W.shape) == (4, 5) and g._initialized
    with pytest.raises(ValueError, match="both widths"):
        tl.Linear(5, generator=torch.Generator())
    e = tl.Embedding(7, 4, generator=torch.Generator().manual_seed(0))
    assert tuple(e.W.shape) == (7, 4)


class _JNet(jl.Layer):
    def __init__(self):
        super().__init__()
        self.conv = jl.Conv2d(4, 3, padding=1)
        self.sepconv = jl.SeparableConv2d(5, 3, padding=1)
        self.bn = jl.BatchNorm2d(5)
        self.register_layers(jl.Conv2d(5, 1), jl.BatchNorm2d(5))
        self.register_layers(jl.Conv2d(5, 1), jl.ReLU())
        self.fc = jl.Linear(3)

    def forward(self, x):
        y = self.bn(self.sepconv(self.conv(x)))
        for k in ("Conv2d_0", "BatchNorm2d_1", "Conv2d_0_", "ReLU_1"):
            y = self._layers[k](y)
        return self.fc(jag.flatten(y))


class _TNet(tl.Layer):
    def __init__(self):
        super().__init__()
        self.conv = tl.Conv2d(4, 3, padding=1)
        self.sepconv = tl.SeparableConv2d(5, 3, padding=1)
        self.bn = tl.BatchNorm2d(5)
        self.register_layers(tl.Conv2d(5, 1), tl.BatchNorm2d(5))
        self.register_layers(tl.Conv2d(5, 1), tl.ReLU())
        self.fc = tl.Linear(3)

    def forward(self, x):
        y = self.bn(self.sepconv(self.conv(x)))
        for k in ("Conv2d_0", "BatchNorm2d_1", "Conv2d_0_", "ReLU_1"):
            y = self._modules[k](y)
        return self.fc(tag.flatten(y))


def test_state_names_and_order_equal_jax():
    """get_params/get_states keys, in order: attribute paths, sublayers
    made at initialize (SeparableConv2d's depthwise/pointwise) and
    register_layers names with their "_" on a clash; set_params rejects
    an unknown name, set_states ignores one and rejects a wrong shape."""
    x = _x((2, 3, 4, 4))
    j, t = _carried(_JNet, _TNet, x)
    assert list(t.get_params()) == list(j.get_params())
    assert list(t.get_states()) == list(j.get_states())
    assert "Conv2d_0_.W" in t.get_params() and "sepconv.depthwise.W" \
        in t.get_params()
    assert isinstance(t.get_params(), OrderedDict)
    assert t._modules["Conv2d_0_"].name == "Conv2d_0_"
    with _Train(True):
        np.testing.assert_allclose(t(_tt(x)).numpy(), jt.to_numpy(j(_jt(x))),
                                   rtol=RTOL, atol=ATOL)
    with pytest.raises(KeyError, match="unknown param"):
        t.set_params({"nope": np.zeros(3)})
    t.set_states({"nope": np.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        t.set_states({"fc.W": np.zeros((2, 2), np.float32)})
    t.set_params({"fc.b": np.ones(3, np.float32)})
    np.testing.assert_array_equal(t.fc.b.detach().numpy(), np.ones(3))


def test_batchnorm_running_stats_two_steps_and_eval():
    """Two training calls update running_mean/var as JAX does (biased
    batch variance, new = 0.9 old + 0.1 batch: at n = 32 the unbiased
    variance would differ by 3%); eval then normalizes with them."""
    x1, x2 = _x((2, 3, 4, 4), 1) * 2 + 1, _x((2, 3, 4, 4), 2) * 3 - 1
    j, t = _carried(lambda: jl.BatchNorm2d(3), lambda: tl.BatchNorm2d(3), x1)
    with _Train(True):
        for x in (x1, x2):
            j(_jt(x))
            t(_tt(x))
    rm, rv = np.zeros(3), np.ones(3)
    for x in (x1, x2):
        rm = 0.9 * rm + 0.1 * x.mean(axis=(0, 2, 3))
        rv = 0.9 * rv + 0.1 * x.var(axis=(0, 2, 3))
    for name, want in (("running_mean", rm), ("running_var", rv)):
        got = getattr(t, name).numpy()
        np.testing.assert_allclose(got, jt.to_numpy(getattr(j, name)),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with _Train(False):
        np.testing.assert_allclose(t(_tt(x1)).numpy(),
                                   jt.to_numpy(j(_jt(x1))),
                                   rtol=RTOL, atol=ATOL)
        before = t.running_var.clone()
        t(_tt(x2))
    assert torch.equal(before, t.running_var)


def test_avgpool_divides_by_the_window_inside_the_input():
    """At a padded corner a 3x3 window holds 4 input elements: the
    average is their mean (count_include_pad=False), as in JAX."""
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    got = tl.AvgPool2d(3, 2, 1)(_tt(x)).numpy()
    assert got[0, 0, 0, 0] == pytest.approx(np.mean([0, 1, 4, 5]))
    np.testing.assert_allclose(
        got, jt.to_numpy(jl.AvgPool2d(3, 2, 1)(_jt(x))), rtol=1e-6)


def test_dropout_in_training_by_statistics():
    """Train-mode dropout keeps each element with probability 1 - ratio
    (draws from the device's generator, which differ from JAX's) and
    scales what it keeps by 1 / keep; in eval it is the identity."""
    cpu = tdevice.create_cpu_device()
    cpu.SetRandSeed(3)
    x = np.full((200, 100), 2.0, np.float32)
    d = tl.Dropout(0.3)
    with _Train(True):
        y = d(tt.from_numpy(x, device=cpu)).numpy()
        cpu.SetRandSeed(3)
        y2 = d(tt.from_numpy(x, device=cpu)).numpy()
    kept = y != 0
    assert abs(kept.mean() - 0.7) < 0.01
    np.testing.assert_allclose(y[kept], 2.0 / 0.7, rtol=1e-6)
    np.testing.assert_array_equal(y, y2)
    with _Train(False):
        np.testing.assert_array_equal(d(tt.from_numpy(x, device=cpu)).numpy(),
                                      x)
