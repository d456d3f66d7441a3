"""The port's API faults (ROADMAP.md Queue 3, faults 1-5), each held to
`singa_tpu` on the same seeded numpy inputs:

1. `opt.Optimizer.apply` takes SINGA Tensors: three steps of
   `for p, g in autograd.backward(loss): opt.apply(p, g)`
   (`examples/mlp/native.py:65`) with SGD (momentum, nesterov) and Adam;
   parameters within atol 1e-5 (fp32).
2. `Layer.get_params()`/`get_states()` return Tensor views over the
   layer's storage: `t.numpy()`, `tensor.to_numpy(t)`, `copy_from_numpy`,
   `set_value` and `+=` read and write the parameter itself.
3. Graph-mode eval of a time-major model (input (T, B, F), T == B == 4,
   output (B, 2)): the auto-bucket probe counts it as not per-sample, as
   JAX does, and the outputs agree within 1e-5.
4. `serving.build_decode(m, 4, 16, 8, 0.0, None, None, None, "int8")`
   (JAX's positional order: moe_capacity_factor, then kv_dtype) builds
   an int8 cache in both packages, with identical fp32 tokens.
5. `autograd.relu`'s gradient at a NaN input is 0, as jax.nn.relu's
   (torch's own relu passes the gradient through there): a tape with a
   NaN entry gives equal gradients, NaN at the same entries.

Faults 11-13:

11. The resilience CLI's kill lands at a step the run reports: an A/B
    with little left after the first checkpoint (2 ranks, 6 steps, a
    save every 3) is preempted at step 4 and resumed there, every time
    (a kill timed on the wall clock let that run complete first).
12. `data.ImageBatchIter.end` joins its worker: a worker that ignores
    the stop flag past the 1 s join, and takes 1 s to die on SIGTERM,
    is gone when `end()` returns.
13. `Model.compile` binds JAX's positional call: the fifth to seventh
    positions are the pipeline parameters, the eighth the amp dtype, in
    both packages; a pipeline axis raises, naming item 5c.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jag
from singa_tpu import device as jdevice
from singa_tpu import layer as jl
from singa_tpu import model as jmodel
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import serving as jserving
from singa_tpu import tensor as jt
from singa_tpu_torch import autograd as tag
from singa_tpu_torch import data as tdata
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tl
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import opt as topt
from singa_tpu_torch import serving as tserving
from singa_tpu_torch import tensor as tt
from singa_tpu_torch.models import transformer as ttr

JDEV = jdevice.get_default_device()
TDEV = tdevice.create_cpu_device()


class _Training:
    def __enter__(self):
        self.prev = (jag.training, tag.training)
        jag.training = tag.training = True

    def __exit__(self, *exc):
        jag.training, tag.training = self.prev


# ---- fault 1: Optimizer.apply on Tensors -----------------------------------

OPTS = {
    "sgd_momentum": lambda o: o.SGD(0.05, momentum=0.9, weight_decay=1e-3),
    "sgd_nesterov": lambda o: o.SGD(0.05, momentum=0.9, nesterov=True),
    "adam": lambda o: o.Adam(0.01),
}


def _native_mlp(t, ag, o, dev, name):
    """examples/mlp/native.py's bare-Tensor MLP, three apply steps."""
    rng = np.random.RandomState(0)
    data = rng.uniform(-1, 1, (16, 2)).astype(np.float32)
    label = (rng.rand(16) > 0.5).astype(np.int32)
    init = [rng.normal(0, 0.1, s).astype(np.float32)
            for s in ((2, 3), (3,), (3, 2), (2,))]
    ps = [t.Tensor(data=a, device=dev, requires_grad=True, stores_grad=True)
          for a in init]
    x, y = t.from_numpy(data, device=dev), t.from_numpy(label, device=dev)
    opt = OPTS[name](o)
    losses = []
    for _ in range(3):
        h = ag.relu(ag.add_bias(ag.matmul(x, ps[0]), ps[1], axis=0))
        out = ag.add_bias(ag.matmul(h, ps[2]), ps[3], axis=0)
        loss = ag.softmax_cross_entropy(out, y)
        for p, g in ag.backward(loss):
            opt.apply(p, g)
        opt.step()
        losses.append(float(np.asarray(t.to_numpy(loss))))
    return losses, [np.asarray(t.to_numpy(p)) for p in ps]


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_apply_takes_tensors(name):
    with _Training():
        jl_, jp = _native_mlp(jt, jag, jopt, JDEV, name)
        tl_, tp = _native_mlp(tt, tag, topt, TDEV, name)
    np.testing.assert_allclose(tl_, jl_, rtol=1e-5)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_optimizer_apply_takes_layer_views():
    """The pairs backward yields for a layer's parameters are its
    get_params() views; apply updates the parameter through them."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 5).astype(np.float32)
    res = {}
    for pkg, t, ag, layer, o, dev in (("jax", jt, jag, jl, jopt, JDEV),
                                      ("port", tt, tag, tl, topt, TDEV)):
        lin = layer.Linear(3)
        tx = t.from_numpy(x, device=dev)
        lin(tx)
        lin.set_params({"W": np.full((5, 3), 0.1, np.float32),
                        "b": np.zeros(3, np.float32)})
        sgd = OPTS["sgd_momentum"](o)
        with _Training():
            for _ in range(3):
                loss = ag.reduce_sum(ag.mul(lin(tx), lin(tx)), None, False)
                pairs = list(ag.backward(loss))
                for p, g in pairs:
                    sgd.apply(p, g)
                sgd.step()
        res[pkg] = {k: np.asarray(t.to_numpy(v))
                    for k, v in lin.get_params().items()}
        if pkg == "port":
            views = {id(v) for v in lin.get_params().values()}
            assert {id(p) for p, _ in pairs} == views
    for k in res["jax"]:
        np.testing.assert_allclose(res["port"][k], res["jax"][k], atol=1e-5,
                                   rtol=0, err_msg=k)


# ---- fault 2: get_params / get_states views --------------------------------

def test_get_params_are_tensor_views_over_the_layer():
    rng = np.random.RandomState(2)
    x = rng.randn(6, 4).astype(np.float32)
    jlin, tlin = jl.Linear(3), tl.Linear(3)
    jlin(jt.from_numpy(x, device=JDEV))
    tlin(tt.from_numpy(x, device=TDEV))
    w = rng.randn(4, 3).astype(np.float32)
    for lin, t in ((jlin, jt), (tlin, tt)):
        params = lin.get_params()
        assert list(params) == ["W", "b"]
        assert all(isinstance(v, t.Tensor) for v in params.values())
        params["W"].copy_from_numpy(w)
        params["b"].set_value(0.5)
    tp = tlin.get_params()
    assert tp["W"] is tlin.get_params()["W"]          # one view per param
    assert tp["W"].data is tlin.W                      # over its storage
    np.testing.assert_array_equal(tp["W"].numpy(), w)
    np.testing.assert_array_equal(tt.to_numpy(tp["b"]), np.full(3, 0.5))
    want = jt.to_numpy(jlin(jt.from_numpy(x, device=JDEV)))
    got = tlin(tt.from_numpy(x, device=TDEV)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    tp["b"] += tt.from_numpy(np.ones(3, np.float32), device=TDEV)
    np.testing.assert_array_equal(tlin.b.detach().numpy(), np.full(3, 1.5))
    tp["W"].copy_from(tt.from_numpy(2 * w, device=TDEV))
    np.testing.assert_array_equal(tlin.W.detach().numpy(), 2 * w)


def test_get_states_views_cover_buffers():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 3, 5, 5).astype(np.float32)
    jbn, tbn = jl.BatchNorm2d(3), tl.BatchNorm2d(3)
    with _Training():
        jbn(jt.from_numpy(x, device=JDEV))
        tbn(tt.from_numpy(x, device=TDEV))
    js, ts = jbn.get_states(), tbn.get_states()
    assert list(ts) == list(js)
    for k, v in js.items():
        assert isinstance(ts[k], tt.Tensor)
        np.testing.assert_allclose(ts[k].numpy(), jt.to_numpy(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    ts["running_mean"].set_value(0.25)
    np.testing.assert_array_equal(tbn.running_mean.numpy(), np.full(3, 0.25))


# ---- fault 3: graph-mode eval of a time-major model ------------------------

def _time_major(pkg):
    layer, ag, model = (jl, jag, jmodel) if pkg == "jax" else \
        (tl, tag, tmodel)

    class TimeMajor(model.Model):
        """(T, B, F) -> mean over time -> (B, 2)."""

        def __init__(self):
            super().__init__()
            self.fc = layer.Linear(2)

        def forward(self, x):
            return self.fc(ag.reduce_mean(x, axes=[0], keepdims=False))

    return TimeMajor()


def test_graph_eval_of_a_time_major_model():
    rng = np.random.RandomState(4)
    x = rng.randn(4, 4, 3).astype(np.float32)
    w = rng.randn(3, 2).astype(np.float32)
    outs = {}
    for pkg, t, dev in (("jax", jt, JDEV), ("port", tt, TDEV)):
        m = _time_major(pkg)
        tx = t.from_numpy(x, device=dev)
        m.compile([tx], is_train=False, use_graph=True)
        m.set_params({"fc.W": w, "fc.b": np.zeros(2, np.float32)})
        m.eval()
        out = m(tx)
        assert tuple(out.shape) == (4, 2)
        assert m._eval_per_sample is False
        outs[pkg] = np.asarray(t.to_numpy(out))
    np.testing.assert_allclose(outs["port"], outs["jax"], atol=1e-5, rtol=0)


# ---- fault 4: serving.build_*'s positional order ---------------------------

CFG = dict(vocab_size=61, max_seq=32, dim=32, num_heads=4, num_layers=2)


def test_build_decode_takes_kv_dtype_last(monkeypatch):
    jm = jmodels.create_model("gpt", **CFG)
    ids = np.random.RandomState(5).randint(0, 61, (4, 16)).astype(np.int32)
    jm.compile([jt.from_numpy(ids, device=JDEV)], is_train=False,
               use_graph=False)
    jm.eval()
    tm = ttr.GPT(**CFG, device="cpu")
    ttr.load_singa_params(tm, {k: jt.to_numpy(v)
                               for k, v in jm.get_params().items()})
    seen = {}
    for name, mod in (("jax", jserving), ("port", tserving)):
        real = mod._decode_core

        def spy(m, S0, max_new, moe_capacity_factor=None, kv_dtype=None,
                _real=real, _name=name):
            seen[_name] = (moe_capacity_factor, kv_dtype)
            return _real(m, S0, max_new, moe_capacity_factor,
                         kv_dtype=kv_dtype)

        monkeypatch.setattr(mod, "_decode_core", spy)
    jfn = jserving.build_decode(jm, 4, 16, 8, 0.0, None, None, None, "int8")
    tfn = tserving.build_decode(tm, 4, 16, 8, 0.0, None, None, None, "int8")
    assert seen == {"jax": (None, "int8"), "port": (None, "int8")}
    want = np.asarray(jax.device_get(jfn(jm._decode_state(None), ids,
                                         jax.random.PRNGKey(0))))
    got = tfn(tserving.decode_state(tm, None), torch.from_numpy(
        ids.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


def test_gpt_takes_the_jax_positional_order():
    """GPT's parameters in JAX's order, with `name=`; `tp_axis` and
    `vocab_tp` (positions 8 and 10) build the tensor-parallel model, and
    `seq_axis` (position 7) builds the sequence-parallel one, whose
    forward with the axis unbound equals the model's without it."""
    m = ttr.GPT(61, 32, 32, 4, 2, 4, None, None, True, device="cpu",
                name="lm")
    assert m.name == "lm" and m.blocks[0].attn.use_bias
    m = ttr.GPT(61, 32, 32, 4, 2, 4, None, "tp", False, True, 8,
                device="cpu")
    assert m.tp_axis == "tp" and m.vocab_tp and m.head is None
    assert tuple(m.tok_embed.W.shape) == (64, 32)
    m = ttr.GPT(61, 32, 32, 4, 2, 4, "sp", device="cpu")
    assert m.seq_axis == "sp" and m.blocks[0].attn.seq_axis == "sp"
    ids = np.random.RandomState(2).randint(0, 61, (2, 32))
    assert torch.equal(m(ids), ttr.GPT(61, 32, 32, 4, 2, 4,
                                       device="cpu")(ids))


# ---- fault 5: relu's gradient at NaN ----------------------------------------

def test_relu_gradient_at_nan_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(4, 6).astype(np.float32)
    x[1, 2] = np.nan
    x[2, 3] = 0.0
    w = rng.randn(6, 3).astype(np.float32)
    grads = {}
    for name, t, ag, dev in (("jax", jt, jag, JDEV), ("port", tt, tag, TDEV)):
        with _Training():
            xt = t.Tensor(data=x, device=dev, requires_grad=True,
                          stores_grad=True)
            wt = t.Tensor(data=w, device=dev, requires_grad=True,
                          stores_grad=True)
            y = ag.matmul(ag.relu(xt), wt)
            loss = ag.sum(ag.mul(y, y))
            grads[name] = {id(p): np.asarray(t.to_numpy(g))
                           for p, g in ag.backward(loss)}
            grads[name] = [grads[name][id(xt)], grads[name][id(wt)]]
    for got, want in zip(grads["port"], grads["jax"]):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---- fault 11: the resilience CLI's kill waits for a state ------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_resilience_kill_lands_at_a_reported_step(tmp_path):
    out = tmp_path / "ab.json"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.resilience", "--ab",
         "--device", "cpu", "--devices-a", "2", "--devices-b", "1",
         "--steps", "6", "--save-every", "3", "--timeout", "100",
         "--out", str(out)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=240)
    rec = json.loads(out.read_text())
    assert rec["killed_status"] == "preempted", \
        proc.stdout[-3000:] + proc.stderr[-3000:]
    assert rec["killed_final_step"] == 4 and rec["resumed_step"] == 4
    assert rec["ok"] and proc.returncode == 0 and rec["compared_steps"] == 2


# ---- fault 12: ImageBatchIter.end joins its worker --------------------------

def _die_slowly(*_):
    time.sleep(1.0)
    os._exit(0)


class _StubbornIter(tdata.ImageBatchIter):
    """A worker that ignores the stop flag and takes 1 s to die on
    SIGTERM."""

    def run(self):
        signal.signal(signal.SIGTERM, _die_slowly)
        time.sleep(60)


def test_image_batch_iter_end_joins_a_stubborn_worker(tmp_path):
    lst = tmp_path / "list.txt"
    lst.write_text("a.png 0\nb.png 1\n")
    it = _StubbornIter(str(lst), 2, None)
    it.start()
    first = it.p
    time.sleep(0.2)               # the worker has installed its handler
    it.end()
    assert not first.is_alive()
    it.start()                    # a restart runs one worker, not two
    second = it.p
    it.end()
    assert second is not first and not second.is_alive()


# ---- fault 13: Model.compile's positional order -----------------------------

def test_compile_binds_the_jax_positional_call():
    import inspect
    names = [list(inspect.signature(m.compile).parameters)
             for m in (jmodel.Model, tmodel.Model)]
    assert names[0] == names[1], names
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    args = (True, False, False, None, 1, "gpipe", "bfloat16", False)
    got = []
    for t, layer_mod, model_mod, dev in ((jt, jl, jmodel, JDEV),
                                         (tt, tl, tmodel, TDEV)):
        class Net(model_mod.Model):
            def __init__(self):
                super().__init__()
                self.fc = layer_mod.Linear(2)

            def forward(self, x):
                return self.fc(x)

        m = Net()
        m.compile([t.from_numpy(x, dev)], *args)
        got.append((m.amp, m.eval_buckets, m.graph_mode, m.training))
    assert got[0] == got[1] == ("bfloat16", False, False, True)
    with pytest.raises(NotImplementedError, match="item 5c"):
        Net().compile([tt.from_numpy(x, TDEV)], True, False, False, "pp")
