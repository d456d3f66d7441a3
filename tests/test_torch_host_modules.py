"""The SINGA API's small leftovers on the port, against `singa_tpu`:
`device`'s reference calls and profiling switches, `config`'s flags,
`channel`, `image_tool` (a seeded 32x32 image through every transform,
equal arrays) and `autograd.infer_dependency` (the same counts on a
diamond graph and on a two-layer MLP)."""

import os
import random

import numpy as np
import pytest
import torch
from PIL import Image as PIL

from singa_tpu import autograd as jag
from singa_tpu import channel as jchannel
from singa_tpu import device as jdevice
from singa_tpu import image_tool as jimg
from singa_tpu import tensor as jt
from singa_tpu_torch import autograd as tag
from singa_tpu_torch import channel as tchannel
from singa_tpu_torch import config as tconfig
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import image_tool as timg
from singa_tpu_torch import tensor as tt

JDEV = jdevice.get_default_device()
TDEV = tdevice.create_cpu_device()


# ---- device ----------------------------------------------------------------

def test_device_reference_calls():
    assert tdevice.create_tpu_device is tdevice.create_cuda_gpu
    assert tdevice.create_tpu_devices is tdevice.create_cuda_gpus
    assert tdevice.get_gpu_ids() == list(range(tdevice.get_num_gpus()))
    assert tdevice.enable_lazy_alloc(True) is None
    for fn in ("get_num_opencl_platforms", "get_num_opencl_devices",
               "create_opencl_device"):
        for mod in (jdevice, tdevice):
            with pytest.raises(AssertionError, match="OpenCL"):
                getattr(mod, fn)()
    if not torch.cuda.is_available():
        for call in (tdevice.create_cuda_gpu, lambda: tdevice.device_query(0)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_device_graph_and_profiling_switches(capsys):
    saved = [(d, d.verbosity, d.skip_iteration, list(d.step_times),
              d.graph_enabled) for d in (JDEV, TDEV)]
    try:
        for d in (JDEV, TDEV):
            d.EnableGraph(False)
            assert d.graph_enabled is False
            d.EnableGraph(True)
            d.ResetGraph()
            d.SetSkipIteration(2)
            assert d.skip_iteration == 2
        # the summary of the same step times prints the same lines
        outs = []
        for d in (JDEV, TDEV):
            d.SetVerbosity(1)
            d.step_times[:] = []
            d.PrintTimeProfiling()
            d.step_times[:] = [0.010, 0.012, 0.011]
            d.PrintTimeProfiling()
            outs.append(capsys.readouterr().out)
        assert outs[1] == outs[0]
        assert "3 steps, mean 11.000 ms" in outs[1]
        TDEV.SetVerbosity(2)
        TDEV.PrintTimeProfiling()
        assert "introspect" in capsys.readouterr().out
    finally:
        for d, v, k, times, g in saved:
            d.verbosity, d.skip_iteration, d.graph_enabled = v, k, g
            d.step_times[:] = times


def test_device_rand_key_draws_from_the_stream():
    d = tdevice.create_cpu_device()
    d.SetRandSeed(7)
    a, b = d.rand_key(), d.rand_key()
    d.SetRandSeed(7)
    assert (d.rand_key(), d.rand_key()) == (a, b) and a != b


def test_device_copies_are_the_process_device():
    import copy
    import pickle
    assert copy.deepcopy(TDEV) is TDEV
    assert pickle.loads(pickle.dumps(TDEV)) is TDEV


# ---- config ----------------------------------------------------------------

def test_config_flags_state_what_the_port_does():
    assert tconfig.USE_CUDA is True
    assert tconfig.USE_DIST is False
    assert tconfig.USE_OPENCL is False and tconfig.USE_DNNL is False
    assert tconfig.USE_ONNX is True
    assert tconfig.CUDNN_VERSION == (torch.backends.cudnn.version() or 0)
    assert tconfig.use_tpu() is False and tconfig.USE_TPU is False
    with pytest.raises(AttributeError):
        tconfig.NO_SUCH_FLAG  # noqa: B018


# ---- channel ---------------------------------------------------------------

def test_channel_writes_the_same_lines(tmp_path, capsys):
    files = {}
    for name, mod in (("jax", jchannel), ("port", tchannel)):
        d = str(tmp_path / name)
        mod.InitChannel(d)
        ch = mod.GetChannel("train_log")
        assert mod.GetChannel("train_log") is ch
        ch.EnableDestFile(True)
        ch.Send("step 1 loss 0.5")
        ch("step 2 loss 0.25")
        ch.EnableDestStderr(False)
        ch.Send("quiet")
        ch.EnableDestFile(False)
        mod._channels.clear()
        mod.InitChannel(".")
        with open(os.path.join(d, "train_log")) as f:
            files[name] = [line.split("] ", 1)[1] for line in f]
    assert files["port"] == files["jax"] == [
        "train_log: step 1 loss 0.5\n", "train_log: step 2 loss 0.25\n",
        "train_log: quiet\n"]
    err = [line.split("] ", 1)[1]
           for line in capsys.readouterr().err.splitlines()]
    assert err == ["train_log: step 1 loss 0.5",
                   "train_log: step 2 loss 0.25"] * 2


# ---- image_tool ------------------------------------------------------------

def _image():
    rng = np.random.RandomState(0)
    return PIL.fromarray(rng.randint(0, 256, (32, 32, 3)).astype(np.uint8))


def _seeded(fn):
    random.seed(3)
    np.random.seed(3)
    return fn()


TRANSFORMS = {
    "crop": lambda m, im: m.crop(im, (16, 20), "right_bottom"),
    "crop_center": lambda m, im: m.crop(im, (8, 8), "center"),
    "crop_and_resize": lambda m, im: m.crop_and_resize(im, (16, 16),
                                                       "center"),
    "resize": lambda m, im: m.resize(im, 20),
    "resize_by_hw": lambda m, im: m.resize_by_hw(im, (12, 24)),
    "color_cast": lambda m, im: m.color_cast(im, 20),
    "enhance": lambda m, im: m.enhance(im, 0.2),
    "flip": lambda m, im: m.flip(im),
    "flip_down": lambda m, im: m.flip_down(im),
    "chain": lambda m, im: m.ImageTool().set([im]).resize_by_range(
        (24, 40)).rotate_by_range((-10, 10)).random_crop((16, 16))
    .crop5((8, 8), 2, inplace=False),
    "chain_lists": lambda m, im: m.ImageTool().set([im]).resize_by_list(
        [16, 24], 2).crop3((12, 12), 2).flip().color_cast(10)
    .enhance(0.1).get(),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_image_tool_transforms_match_jax(name):
    im = _image()
    got = _seeded(lambda: TRANSFORMS[name](timg, im))
    want = _seeded(lambda: TRANSFORMS[name](jimg, im))
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_image_tool_load(tmp_path):
    p = str(tmp_path / "im.png")
    _image().save(p)
    for gray in (False, True):
        np.testing.assert_array_equal(
            np.asarray(timg.load_img(p, gray)), np.asarray(jimg.load_img(p,
                                                                         gray)))
    assert timg.ImageTool().load(p).num_augmentation() == 1


# ---- autograd.infer_dependency ----------------------------------------------

def _counts(counts):
    return sorted((type(op).__name__, n) for op, n in counts.items())


def _diamond(t, ag, dev):
    x = t.Tensor(data=np.ones((2, 3), np.float32), device=dev,
                 requires_grad=True, stores_grad=True)
    a = ag.relu(x)
    b = ag.tanh(x)
    return ag.reduce_sum(ag.mul(ag.add(a, b), a), None, False)


def _mlp(t, ag, dev):
    rng = np.random.RandomState(0)
    x = t.from_numpy(rng.randn(4, 2).astype(np.float32), device=dev)
    ps = [t.Tensor(data=rng.randn(*s).astype(np.float32), device=dev,
                   requires_grad=True, stores_grad=True)
          for s in ((2, 3), (3,), (3, 2), (2,))]
    h = ag.relu(ag.add_bias(ag.matmul(x, ps[0]), ps[1], axis=0))
    out = ag.add_bias(ag.matmul(h, ps[2]), ps[3], axis=0)
    y = t.from_numpy(np.array([0, 1, 1, 0], np.int32), device=dev)
    return ag.softmax_cross_entropy(out, y)


@pytest.mark.parametrize("graph", [_diamond, _mlp],
                         ids=["diamond", "mlp"])
def test_infer_dependency_matches_jax(graph):
    prev = (jag.training, tag.training)
    jag.training = tag.training = True
    try:
        jy = graph(jt, jag, JDEV)
        ty = graph(tt, tag, TDEV)
    finally:
        jag.training, tag.training = prev
    want = _counts(jag.infer_dependency(jy.creator))
    got = _counts(tag.infer_dependency(ty.creator))
    assert got == want
    assert len(got) > 3
