"""Port parity, the model zoo through tensor -> layer -> model -> opt:
each `singa_tpu_torch.models` model against the JAX package's on seeded
numpy inputs, on the CPU.

- `get_states()` keys (in order) and shapes equal JAX's for mlp, cnn, a
  small ResNet with Bottleneck and Downsample, resnet18, AlexNet and
  xceptionnet.
- Training: JAX's initial states are carried into the port, then both
  take three SGD steps (lr 0.01, momentum 0.9, weight decay 1e-5) on the
  same batch: losses within rtol 1e-4, parameters and running statistics
  within atol 1e-4; the worst errors are printed. lr 0.1 diverges on a
  batch of two, which would only compare float noise blown up.
- The ResNets run at 64x64, not 32x32: at 32x32 their last stage is
  1x1, and batch norm then normalizes two values per channel, whose
  1/sqrt(eps) gain turns fp32 rounding into O(1) differences: JAX's own
  run, its weights perturbed in the sixth digit, leaves the tolerance
  there, and stays well inside it at 64x64.
- Xception on a batch of two is chaotic in the same way past its first
  step, at every size and learning rate tried, in JAX alone. Its first
  step is deterministic enough, so it takes one step (lr 0.001), held to
  the same tolerances; its first-step gradients part from JAX's only
  where a relu input lies within rounding of zero.
- AlexNet (dropout) is compared in eval mode.
- `save_states` zips cross both ways; resnet50 with 1000 classes counts
  25,557,032 parameters; the README's Quick start runs on the port with
  a CPU device and gives JAX's losses."""

import os

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import layer as jl
from singa_tpu import model as jmodel
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jt
from singa_tpu.models import resnet as jresnet
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tl
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import models as tmodels
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as tt
from singa_tpu_torch.models import resnet as tresnet

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-4

# name -> (make(models package, resnet module), input shape, classes)
ZOO = {
    "mlp": (lambda m, r: m.create_model("mlp", data_size=10), (4, 10), 10),
    "cnn": (lambda m, r: m.create_model("cnn"), (2, 1, 28, 28), 10),
    "resnet_bottleneck": (lambda m, r: r.ResNet(r.Bottleneck, [1, 1, 1, 1]),
                          (2, 3, 64, 64), 10),
    "resnet18": (lambda m, r: m.create_model("resnet18"), (2, 3, 64, 64), 10),
    "alexnet": (lambda m, r: m.create_model("alexnet", num_channels=3),
                (2, 3, 128, 128), 10),
    "xceptionnet": (lambda m, r: m.create_model("xceptionnet"),
                    (2, 3, 64, 64), 10),
}
STEPS = {"mlp": 3, "cnn": 3, "resnet_bottleneck": 3, "resnet18": 3,
         "xceptionnet": 1}
LR = {"xceptionnet": 0.001}


def _data(shape, classes, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randint(0, classes, shape[0]).astype(np.int32))


def _built(name, is_train, lr=0.01):
    """The JAX model and the port's, both compiled on the same batch, the
    port holding JAX's initial states."""
    build, shape, classes = ZOO[name]
    x, y = _data(shape, classes)
    jdev = jdevice.best_device()
    jdev.SetRandSeed(0)
    cpu = tdevice.create_cpu_device()
    jm, tm = build(jmodels, jresnet), build(tmodels, tresnet)
    jm.set_optimizer(jopt.SGD(lr=lr, momentum=0.9, weight_decay=1e-5))
    tm.set_optimizer(topt.SGD(lr=lr, momentum=0.9, weight_decay=1e-5))
    jx, jy = jt.from_numpy(x, device=jdev), jt.from_numpy(y, device=jdev)
    tx, ty = tt.from_numpy(x, device=cpu), tt.from_numpy(y, device=cpu)
    jm.compile([jx], is_train=is_train, use_graph=True)
    tm.compile([tx], is_train=is_train, use_graph=True)
    tm.set_states({k: jt.to_numpy(v) for k, v in jm.get_states().items()})
    return jm, tm, (jx, jy), (tx, ty)


# the deeper models, whose JAX builds take the longest, run from
# test_torch_zoo_deep.py and test_torch_zoo_xception.py, so the test
# runner can spread them over its workers
@pytest.mark.parametrize("name", ["cnn", "mlp", "resnet_bottleneck"])
def test_zoo_model_matches_jax(name):
    check_zoo_model(name)


def check_zoo_model(name):
    """State names (in order), shapes and dtypes equal JAX's; then the
    SGD steps (AlexNet: the eval-mode logits) from JAX's states."""
    jm, tm, (jx, jy), (tx, ty) = _built(name, name in STEPS,
                                        LR.get(name, 0.01))
    js, ts = jm.get_states(), tm.get_states()
    assert list(ts) == list(js)
    for k in js:
        assert tuple(ts[k].shape) == tuple(js[k].shape), k
        assert ts[k].dtype == torch.float32, k
    if name not in STEPS:
        # eval mode (dropout off): the logits with JAX's weights
        want, got = jt.to_numpy(jm(jx)), tm(tx)
        assert isinstance(got, tt.Tensor) and got.data.grad_fn is None
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        return
    jl_, tl_ = [], []
    for _ in range(STEPS[name]):
        jl_.append(float(jt.to_numpy(jm(jx, jy)[1])))
        out, loss = tm(tx, ty)
        assert isinstance(out, tt.Tensor) and isinstance(loss, tt.Tensor)
        tl_.append(loss.item())
    rel = max(abs(a - b) / abs(a) for a, b in zip(jl_, tl_))
    js = jm.get_states()
    err = {k: float(np.abs(ts[k].numpy() - jt.to_numpy(v)).max())
           for k, v in js.items()}
    worst = max(err, key=err.get)
    print(f"{name}: losses JAX {jl_} port {tl_}, worst relative loss "
          f"difference {rel:.3e}; worst state difference {err[worst]:.3e} "
          f"({worst})")
    assert np.isfinite(tl_).all()
    assert rel <= RTOL, (jl_, tl_)
    assert err[worst] <= ATOL, (worst, err[worst])


def test_checkpoints_cross_both_ways(tmp_path):
    """A port save_states zip loads into the JAX model and a JAX zip into
    the port's, states equal bit for bit, aux states included."""
    jm, tm, (jx, jy), (tx, ty) = _built("resnet_bottleneck", True)
    tm(tx, ty)
    port_zip = os.path.join(tmp_path, "port.zip")
    tm.save_states(port_zip, aux_states={"epoch": np.int32(3)})
    assert int(jm.load_states(port_zip)["epoch"]) == 3
    for k, v in jm.get_states().items():
        np.testing.assert_array_equal(jt.to_numpy(v),
                                      tm.get_states()[k].numpy(), k)
    jm(jx, jy)
    jax_zip = os.path.join(tmp_path, "jax.zip")
    jm.save_states(jax_zip)
    fresh = tresnet.ResNet(tresnet.Bottleneck, [1, 1, 1, 1])
    fresh.compile([tx], is_train=False)
    assert fresh.load_states(jax_zip) == {}
    for k, v in jm.get_states().items():
        np.testing.assert_array_equal(fresh.get_states()[k].numpy(),
                                      jt.to_numpy(v), k)


def test_resnet50_parameter_count():
    """ResNet-50 with 1000 classes has 25,557,032 parameters, as the JAX
    package's test requires of its own."""
    m = tmodels.create_model("resnet50", num_classes=1000)
    m.compile([tt.from_numpy(np.zeros((1, 3, 32, 32), np.float32),
                             device=tdevice.create_cpu_device())],
              is_train=False)
    assert sum(p.numel() for p in m._raw_params().values()) == 25_557_032
    assert tmodels.create_model("resnet").__class__ is tresnet.ResNet
    with pytest.raises(ValueError, match="unknown model"):
        tmodels.create_model("nope")


def _quick_start(model, layer, opt, tensor, dev, x, y):
    """The README's Quick start, for either package, up to its compile:
    returns the model and a function that takes one step (the loss)."""

    class Net(model.Model):
        def __init__(self):
            super().__init__()
            self.conv = layer.Conv2d(32, 3, padding=1, activation="RELU")
            self.pool = layer.MaxPool2d(2, 2)
            self.flat = layer.Flatten()
            self.fc = layer.Linear(10)
            self.sce = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc(self.flat(self.pool(self.conv(x))))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.sce(out, y)
            self.optimizer(loss)
            return out, loss

    m = Net()
    m.set_optimizer(opt.SGD(lr=0.05, momentum=0.9))
    tx = tensor.Tensor(data=x, device=dev)
    ty = tensor.from_numpy(y, device=dev)
    m.compile([tx], is_train=True, use_graph=True)
    return m, lambda: float(tensor.to_numpy(m(tx, ty)[1]))


def test_readme_quick_start_matches_jax():
    """The Quick start on the port (a CPU device) gives JAX's losses over
    three steps: on the README's zeros, and on seeded data with JAX's
    initial weights carried over."""
    cpu = tdevice.create_cpu_device()
    jdev = jdevice.best_device()
    for x, y in ((np.zeros((64, 3, 32, 32), np.float32),
                  np.zeros(64, np.int32)), _data((8, 3, 32, 32), 10, 5)):
        jm, jstep = _quick_start(jmodel, jl, jopt, jt, jdev, x, y)
        tm, tstep = _quick_start(tmodel, tl, topt, tt, cpu, x, y)
        assert list(tm.get_states()) == ["conv.W", "conv.b", "fc.W", "fc.b"]
        tm.set_states({k: jt.to_numpy(v) for k, v in jm.get_states().items()})
        jls = [jstep() for _ in range(3)]
        tls = [tstep() for _ in range(3)]
        print(f"quick start losses JAX {jls} port {tls}")
        np.testing.assert_allclose(tls, jls, rtol=1e-4)
