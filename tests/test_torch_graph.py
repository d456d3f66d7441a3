"""Port parity, the buffered graph (`Model.compile(use_graph=True)`) on the
CPU, where graph mode runs the step function with the graph's
bookkeeping and no capture (CUDA graphs exist only on the card, where
`chip_smoke.py` phase 8 holds the captured steps to the eager ones):

- graph mode against eager mode: the same losses and states bit for bit
  (a 2-layer GPT of width 64 and an MLP), and against the JAX package's
  graph mode from the same weights (losses rtol 1e-5, parameters atol
  1e-5, the tolerances of test_torch_train.py);
- one build per input signature, counted as the JAX package counts its
  step variants; a changed non-tensor argument raises with the JAX
  package's message;
- outputs are fresh tensors, cut from the spent autograd graph: a loss
  kept from step k still reads step k's value;
- the optimizer's step counter is a 0-d fp32 tensor on the parameters'
  device, and ExponentialDecay (plain and staircase) and the step
  counter agree with JAX within 1e-6 relative, in training too;
- eval buckets: for "auto", True and False the port builds as many eval
  graphs as the JAX package traces eval programs over the same batch
  sizes, with the same outputs; True on an output that is not
  per-sample raises in both packages;
- health monitors and the graph flags."""

import os

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jag
from singa_tpu import device as jdevice
from singa_tpu import layer as jl
from singa_tpu import model as jmodel
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jt
from singa_tpu_torch import autograd as tag
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import health
from singa_tpu_torch import layer as tl
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import models as tmodels
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as tt
from singa_tpu_torch.models import transformer as ttr

torch.set_num_threads(2)
GPT_CFG = dict(vocab_size=97, max_seq=32, dim=64, num_heads=4, num_layers=2)
B, S, STEPS = 2, 16, 4


def _jdev():
    return jdevice.best_device()


def _cpu():
    return tdevice.create_cpu_device()


def _gpt_batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, GPT_CFG["vocab_size"], (B, S)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def _gpt_pair():
    """A JAX GPT in graph mode and two port GPTs (eager, graph) holding
    its initial parameters, SGD with momentum and weight decay."""
    ids, _ = _gpt_batch()
    _jdev().SetRandSeed(0)
    jm = jmodels.create_model("gpt", **GPT_CFG)
    jm.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    jm.compile([jt.from_numpy(ids, device=_jdev())], is_train=True,
               use_graph=True)
    params = {k: jt.to_numpy(v) for k, v in jm.get_params().items()}
    ports = []
    for graph in (False, True):
        tm = ttr.GPT(**GPT_CFG, device="cpu")
        ttr.load_singa_params(tm, params)
        tm.set_optimizer(topt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        tm.compile([torch.from_numpy(ids)], is_train=True, use_graph=graph)
        ports.append(tm)
    return jm, ports


def _mlp_pair(opt_j=None, opt_t=None, x=None):
    """A JAX MLP in graph mode and two port MLPs (eager, graph) holding
    its initial states."""
    rng = np.random.RandomState(1)
    x = rng.randn(8, 10).astype(np.float32) if x is None else x
    _jdev().SetRandSeed(0)
    jm = jmodels.create_model("mlp", data_size=10)
    jm.set_optimizer(opt_j or jopt.SGD(lr=0.05, momentum=0.9))
    jm.compile([jt.from_numpy(x, device=_jdev())], is_train=True,
               use_graph=True)
    ports = []
    for graph in (False, True):
        tm = tmodels.create_model("mlp", data_size=10)
        tm.set_optimizer(opt_t() if opt_t else
                         topt.SGD(lr=0.05, momentum=0.9))
        tm.compile([tt.from_numpy(x, device=_cpu())], is_train=True,
                   use_graph=graph)
        tm.set_states({k: jt.to_numpy(v)
                       for k, v in jm.get_states().items()})
        ports.append(tm)
    return jm, ports


def _mlp_batch(seed=2, n=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 10).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


def _states(m):
    return {k: v.detach().clone() for k, v in m._raw_states().items()}


@pytest.mark.parametrize("model", ["gpt", "mlp"])
def test_graph_matches_eager_and_jax(model):
    """Graph mode = eager mode bit for bit on the CPU, both within the
    parity tolerances of JAX's graph mode, the optimizer's states too."""
    if model == "gpt":
        jm, (te, tg) = _gpt_pair()
        ids, tgt = _gpt_batch()
        jargs = (jt.from_numpy(ids, device=_jdev()),
                 jt.from_numpy(tgt, device=_jdev()))
        targs = (torch.from_numpy(ids), torch.from_numpy(tgt))
    else:
        jm, (te, tg) = _mlp_pair()
        x, y = _mlp_batch()
        jargs = (jt.from_numpy(x, device=_jdev()),
                 jt.from_numpy(y, device=_jdev()))
        targs = (tt.from_numpy(x, device=_cpu()),
                 tt.from_numpy(y, device=_cpu()))
    jl_ = [float(jt.to_numpy(jm(*jargs)[1])) for _ in range(STEPS)]
    le = [float(tt._raw(te(*targs)[1]).detach()) for _ in range(STEPS)]
    lg = [float(tt._raw(tg(*targs)[1])) for _ in range(STEPS)]
    assert tg.graph_backend == "eager" and te.graph_backend is None
    assert le == lg
    se, sg = _states(te), _states(tg)
    assert all(torch.equal(se[k], sg[k]) for k in se)
    oe, og = te.optimizer.get_states(), tg.optimizer.get_states()
    assert all(np.array_equal(oe[k], og[k]) for k in oe)
    np.testing.assert_allclose(lg, jl_, rtol=1e-5)
    js = jm.get_states()
    worst = max(float(np.abs(sg[k].numpy() - jt.to_numpy(js[k])).max())
                for k in js)
    assert worst <= 1e-5, worst
    jo = jm.optimizer.get_states()
    assert sorted(og) == sorted(jo)
    assert float(og["step_counter"]) == float(jo["step_counter"]) == STEPS


def test_one_build_per_signature():
    """A step variant per input signature, as the JAX package's dispatch
    cache counts them; repeats reuse it."""
    jm, (_, tg) = _mlp_pair()
    for n in (8, 8, 4, 8, 4, 8):
        x, y = _mlp_batch(n=n)
        jm(jt.from_numpy(x, device=_jdev()), jt.from_numpy(y, device=_jdev()))
        tg(tt.from_numpy(x, device=_cpu()), tt.from_numpy(y, device=_cpu()))
    assert tg._build_count == len(jm._dispatch_cache) == 2
    assert len(tg._train_steps) == 2


def _with_flag(model_mod, layer_mod):
    """The JAX test's model with a static flag argument, in a package."""

    class WithFlag(model_mod.Model):
        def __init__(self):
            super().__init__()
            self.l1 = layer_mod.Linear(10)
            self.loss_fn = layer_mod.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.l1(x)

        def train_one_batch(self, x, y, flag):
            loss = self.loss_fn(self.forward(x), y)
            self._optimizer(loss)
            return loss

    return WithFlag()


def test_changed_static_argument_raises_like_jax():
    x, y = _mlp_batch()
    msgs = []
    for mm, lm, om, t, dev in ((jmodel, jl, jopt, jt, _jdev()),
                               (tmodel, tl, topt, tt, _cpu())):
        m = _with_flag(mm, lm)
        m.set_optimizer(om.SGD(lr=0.1))
        tx, ty = t.from_numpy(x, device=dev), t.from_numpy(y, device=dev)
        m.compile([tx], is_train=True, use_graph=True)
        m(tx, ty, 1)
        m(tx, ty, 1)
        with pytest.raises(ValueError, match="static args") as e:
            m(tx, ty, 2)
        msgs.append(str(e.value))
        with pytest.raises(ValueError, match="static args"):
            m(tx, ty)
        # a direct train_one_batch call takes the same path
        with pytest.raises(ValueError, match="static args"):
            m.train_one_batch(tx, ty, 3)
    assert msgs[0] == msgs[1]


def test_outputs_are_fresh_across_steps():
    """Each step's outputs are new tensors without a tape: the losses
    kept from every step read their own step's values."""
    _, (te, tg) = _gpt_pair()
    ids, tgt = (torch.from_numpy(a) for a in _gpt_batch())
    kept, read = [], []
    for _ in range(STEPS):
        logits, loss = tg(ids, tgt)
        assert loss.grad_fn is None and not loss.requires_grad
        kept.append(loss)
        read.append(float(loss))
    assert [float(v) for v in kept] == read
    assert len(set(read)) == STEPS
    _, (_, mg) = _mlp_pair()
    x, y = (tt.from_numpy(a, device=_cpu()) for a in _mlp_batch())
    outs = [mg(x, y) for _ in range(3)]
    for out, loss in outs:
        assert out.creator is None and loss.creator is None
        assert out.data.grad_fn is None
    assert len({float(loss.data) for _, loss in outs}) == 3


@pytest.mark.parametrize("staircase", [False, True])
def test_step_counter_and_exponential_decay_match_jax(staircase):
    """The counter is a 0-d fp32 tensor on the parameters' device; the
    schedule is an fp32 torch op on it; both agree with JAX within 1e-6,
    alone and over graph-mode training."""
    import jax.numpy as jnp
    tsch = topt.ExponentialDecay(0.1, 3, 0.7, staircase=staircase)
    jsch = jopt.ExponentialDecay(0.1, 3, 0.7, staircase=staircase)
    for step in range(12):
        got = tsch(torch.tensor(float(step)))
        assert got.dtype == torch.float32 and got.dim() == 0
        want = float(jsch(jnp.asarray(float(step), jnp.float32)))
        assert abs(float(got) - want) <= 1e-6 * abs(want), (step, got, want)
    c = topt.Constant(0.1)(torch.tensor(0.0))
    assert c.dtype == torch.float32 and float(c) == float(np.float32(0.1))

    jm, (_, tg) = _mlp_pair(
        jopt.SGD(lr=jopt.ExponentialDecay(0.1, 2, 0.5, staircase=staircase),
                 momentum=0.9),
        lambda: topt.SGD(lr=topt.ExponentialDecay(0.1, 2, 0.5,
                                                  staircase=staircase),
                         momentum=0.9))
    counter = tg.optimizer.step_counter
    assert counter.dtype == torch.float32 and counter.dim() == 0
    assert counter.device == next(tg.parameters()).device
    x, y = _mlp_batch()
    jargs = (jt.from_numpy(x, device=_jdev()), jt.from_numpy(y, device=_jdev()))
    targs = (tt.from_numpy(x, device=_cpu()), tt.from_numpy(y, device=_cpu()))
    jl_ = [float(jt.to_numpy(jm(*jargs)[1])) for _ in range(5)]
    tl_ = [float(tg(*targs)[1].data) for _ in range(5)]
    np.testing.assert_allclose(tl_, jl_, rtol=1e-5)
    assert tg.optimizer.step_counter is counter    # stepped in place
    assert float(counter) == float(jm.optimizer.get_states()["step_counter"])
    got = tg.optimizer.lr(counter)
    want = float(jm.optimizer.lr(jnp.asarray(float(counter), jnp.float32)))
    assert abs(float(got) - want) <= 1e-6 * want


def _linear_model(model_mod, layer_mod, reduce=None):
    class N(model_mod.Model):
        def __init__(self):
            super().__init__()
            self.fc = layer_mod.Linear(3)

        def forward(self, x):
            y = self.fc(x)
            return y if reduce is None else reduce(y, axes=[0],
                                                   keepdims=False)

    return N()


@pytest.mark.parametrize("mode", ["auto", True, False])
def test_eval_buckets_match_jax_trace_counts(mode):
    """The port builds one eval graph where the JAX package traces one
    eval program, over batch sizes that cross buckets, with the JAX
    package's outputs."""
    rng = np.random.RandomState(3)
    x16 = rng.rand(16, 5).astype(np.float32)
    sizes = (16, 13, 7, 16, 3, 9, 1)
    counts, outs = [], []
    for mm, lm, t, dev in ((jmodel, jl, jt, _jdev()),
                           (tmodel, tl, tt, _cpu())):
        m = _linear_model(mm, lm)
        m.compile([t.from_numpy(x16, device=dev)], is_train=False,
                  use_graph=True, eval_buckets=mode)
        if t is tt:
            m.set_states(states)
        else:
            states = {k: jt.to_numpy(v) for k, v in m.get_states().items()}
        m.eval()
        got = []
        for n in sizes:
            out = m(t.from_numpy(x16[:n], device=dev))
            assert tuple(out.shape) == (n, 3)
            got.append(np.asarray(t.to_numpy(out)))
        counts.append(m._eval_trace_count)
        outs.append(got)
    assert counts[0] == counts[1], counts
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_eval_buckets_refuse_outputs_not_per_sample():
    """"auto" leaves a batch-reducing forward unbucketed (its mean over
    10 rows is exact); True raises on it, as in the JAX package."""
    rng = np.random.RandomState(2)
    x16 = rng.rand(16, 5).astype(np.float32)
    for mm, lm, ag, t, dev in ((jmodel, jl, jag, jt, _jdev()),
                               (tmodel, tl, tag, tt, _cpu())):
        m = _linear_model(mm, lm, reduce=ag.reduce_mean)
        m.compile([t.from_numpy(x16, device=dev)], is_train=False,
                  use_graph=True)
        m.eval()
        m(t.from_numpy(x16, device=dev))
        assert m._eval_per_sample is False
        out = np.asarray(t.to_numpy(m(t.from_numpy(x16[:10], device=dev))))
        p = m.get_params()
        W, b = (np.asarray(t.to_numpy(p[k]) if t is jt
                           else p[k].numpy())
                for k in ("fc.W", "fc.b"))
        np.testing.assert_allclose(out, (x16[:10] @ W + b).mean(0),
                                   rtol=1e-5, atol=1e-6)
        m2 = _linear_model(mm, lm, reduce=ag.reduce_mean)
        m2.compile([t.from_numpy(x16, device=dev)], is_train=False,
                   use_graph=True, eval_buckets=True)
        m2.eval()
        with pytest.raises(ValueError, match="per-sample"):
            m2(t.from_numpy(x16[:10], device=dev))


def test_graph_flags_backend_and_health():
    """graph() with changed flags drops the built steps; sequential runs
    eagerly; attaching a health monitor (set_health_monitor, or
    compile(health=True) for a default warn one) drops them too."""
    _, (_, tg) = _mlp_pair()
    x, y = (tt.from_numpy(a, device=_cpu()) for a in _mlp_batch())
    tg(x, y)
    assert tg.graph_backend == "eager" and len(tg._train_steps) == 1
    tg.graph(True, False)              # unchanged flags keep the steps
    assert len(tg._train_steps) == 1
    tg.graph(True, sequential=True)
    assert len(tg._train_steps) == 0 and tg.sequential
    tg(x, y)
    assert tg.graph_backend == "eager"
    mon = health.HealthMonitor(out_dir=os.environ.get("TMPDIR", "/tmp"))
    tg.set_health_monitor(mon)
    assert len(tg._train_steps) == 0 and tg._health_monitor is mon
    tg.set_health_monitor(None)
    m = tmodels.create_model("mlp", data_size=10)
    m.set_optimizer(topt.SGD(lr=0.1))
    m.compile([x], is_train=True, use_graph=True, health=True)
    assert m._health_monitor.policy == "warn"
    m.set_health_monitor(None)
    # training before compile raises, whichever way the step is called
    m2 = tmodels.create_model("mlp", data_size=10)
    with pytest.raises(RuntimeError, match="compile"):
        m2.train_one_batch(x, y)
