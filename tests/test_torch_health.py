"""Port parity, training health: singa_tpu_torch.health against
singa_tpu.health on the MLP of tests/test_health.py (fp32, CPU), with the
same weights (copied from the JAX model) and the same numpy batches.

- Three steps under `warn` (clean, clean, a NaN batch), eager and in
  graph mode: every recorded stat equal to JAX's at rtol 1e-5, and the
  `singa_health_*` counters exact.
- `skip_step` with a NaN batch keeps the parameters, the optimizer slots
  and `step_counter` bitwise, in both packages.
- `halt` raises with a flight bundle; each package loads the other's,
  equal but for `ts` and `executables`.
- The host-side monitor (spike, grad-norm limit, dump cooldown), the
  compile(health=False), recompile and detach cases of
  tests/test_health.py, `apply_skip`, `fit`'s partial progress on halt.
- `resilience.FaultPlan` (fail, delay and nth rules, `fired`, the
  counter) against JAX's on the same arrivals.
- The non-finite logit count of `generate` with a poisoned `head`
  element, observe enabled, against JAX's.

The mesh cases of tests/test_health.py (the policy on every shard, the
count not inflated across shards) run across gloo ranks in
test_torch_dist_dryrun.py, and `Communicator.agree_any` in
test_torch_dist.py.
"""

import math
import os

import numpy as np
import pytest
import torch

from singa_tpu import health as jhealth
from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu import models as jmodels
from singa_tpu import observe as jobserve
from singa_tpu import opt as jopt
from singa_tpu import resilience as jres
from singa_tpu import tensor as jtensor
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import (health, introspect, layer, model, observe, opt,
                             resilience)
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.models import transformer as tt

torch.set_num_threads(2)
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _port_state():
    observe.get_registry().reset()
    observe.enable(True)
    introspect.reset()
    health.set_active_monitor(None)
    resilience.clear_fault_plan()
    yield
    health.set_active_monitor(None)
    resilience.clear_fault_plan()
    jres.clear_fault_plan()
    observe.enable(True)


class JMLP(jmodel.Model):
    def __init__(self):
        super().__init__()
        self.l1 = jlayer.Linear(16)
        self.relu = jlayer.ReLU()
        self.l2 = jlayer.Linear(4)
        self.loss_fn = jlayer.SoftMaxCrossEntropy()

    def forward(self, x):
        return self.l2(self.relu(self.l1(x)))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = self.loss_fn(out, y)
        self._optimizer(loss)
        return out, loss


class TMLP(model.Model):
    def __init__(self):
        super().__init__()
        self.l1 = layer.Linear(16)
        self.relu = layer.ReLU()
        self.l2 = layer.Linear(4)
        self.loss_fn = layer.SoftMaxCrossEntropy()

    def forward(self, x):
        return self.l2(self.relu(self.l1(x)))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = self.loss_fn(out, y)
        self._optimizer(loss)
        return out, loss


@pytest.fixture
def data():
    rng = np.random.RandomState(0)
    X = rng.randn(32, 10).astype(np.float32)
    Y = np.argmax(X @ rng.randn(10, 4).astype(np.float32), 1) \
        .astype(np.int32)
    Xn = X.copy()
    Xn[0, 0] = np.nan
    return X, Y, Xn


def _pair(X, jmon, tmon, use_graph=True, amp=None):
    """The JAX MLP and the port's with the JAX one's weights, each
    compiled with its monitor (SGD, lr 0.2, momentum 0.9)."""
    from singa_tpu import device as jdevice
    jdev = jdevice.best_device()
    jm = JMLP()
    jm.set_optimizer(jopt.SGD(lr=0.2, momentum=0.9))
    jm.compile([jtensor.from_numpy(X, jdev)], is_train=True,
               use_graph=use_graph, amp=amp, health=jmon)
    tdev = tdevice.create_cpu_device()
    tm = TMLP()
    tm.set_optimizer(opt.SGD(lr=0.2, momentum=0.9))
    tm.compile([ttensor.from_numpy(X, tdev)], is_train=True,
               use_graph=use_graph, amp=amp, health=tmon)
    for k, v in jm.get_params().items():
        tm.get_params()[k].copy_from_numpy(jtensor.to_numpy(v))
    return (jm, jdev), (tm, tdev)


def _step(pair, x, y):
    m, dev = pair
    mod = jtensor if isinstance(m, jmodel.Model) else ttensor
    return m(mod.from_numpy(x, dev), mod.from_numpy(y, dev))


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, float):
        assert (math.isnan(a) and math.isnan(b)) or \
            b == pytest.approx(a, rel=RTOL, abs=1e-7), (a, b)
    else:
        assert a == b


STAT_KEYS = ("step", "loss", "grad_norm", "nonfinite_grads",
             "nonfinite_loss", "groups", "anomaly_kinds")


def _health_metrics(reg):
    """{(name, labels): value} of every singa_health_* series."""
    out = {}
    for name in reg.names():
        if name.startswith("singa_health_"):
            for _, k, v in reg.get(name).samples():
                out[(name, k)] = v
    return out


@pytest.mark.parametrize("use_graph", [False, True], ids=["eager", "graph"])
def test_warn_stats_and_counts_match_jax(data, tmp_path, use_graph):
    X, Y, Xn = data
    jmon = jhealth.HealthMonitor(policy="warn", out_dir=str(tmp_path / "j"))
    tmon = health.HealthMonitor(policy="warn", out_dir=str(tmp_path / "t"))
    jp, tp = _pair(X, jmon, tmon, use_graph)
    for x in (X, X, Xn):
        _step(jp, x, Y)
        _step(tp, x, Y)
    assert jmon.last_action == tmon.last_action == "warn"
    jr, tr = list(jmon.recorder.ring), list(tmon.recorder.ring)
    assert len(jr) == len(tr) == 3
    for a, b in zip(jr, tr):
        _close({k: a[k] for k in STAT_KEYS}, {k: b[k] for k in STAT_KEYS})
    assert tr[2]["nonfinite_grads"] > 0
    jm_, tm_ = (_health_metrics(jobserve.get_registry()),
                _health_metrics(observe.get_registry()))
    assert jm_.keys() == tm_.keys()
    for k in jm_:
        if k[0].endswith("_total"):
            assert jm_[k] == tm_[k], k
        else:
            _close(float(jm_[k]), float(tm_[k]))


def _states(m):
    return {k: v.detach().clone() for k, v in m._raw_states().items()}


def test_skip_step_keeps_state_bitwise_in_both(data, tmp_path):
    X, Y, Xn = data
    jmon = jhealth.HealthMonitor(policy="skip_step",
                                 out_dir=str(tmp_path / "j"))
    tmon = health.HealthMonitor(policy="skip_step",
                                out_dir=str(tmp_path / "t"))
    jp, tp = _pair(X, jmon, tmon)
    _step(jp, X, Y)
    _step(tp, X, Y)
    jbefore = {k: jtensor.to_numpy(v).copy()
               for k, v in jp[0].get_params().items()}
    jopt_before = jp[0]._optimizer.get_states()
    jopt_before = {k: np.asarray(v).copy() for k, v in jopt_before.items()}
    tbefore = _states(tp[0])
    topt_before = tp[0]._optimizer.get_states()
    _step(jp, Xn, Y)
    _step(tp, Xn, Y)
    assert jmon.last_action == tmon.last_action == "skip"
    for k, v in jp[0].get_params().items():
        assert np.array_equal(jbefore[k], jtensor.to_numpy(v)), k
    for k, v in jp[0]._optimizer.get_states().items():
        assert np.array_equal(jopt_before[k], np.asarray(v)), k
    after = tp[0]._raw_states()
    for k in tbefore:
        assert torch.equal(tbefore[k], after[k]), k
    topt_after = tp[0]._optimizer.get_states()
    assert topt_before.keys() == topt_after.keys()
    for k in topt_before:
        assert np.array_equal(topt_before[k], topt_after[k]), k
    assert float(topt_after["step_counter"]) == 1.0
    # training resumes: the next clean step commits and steps the counter
    _step(jp, X, Y)
    _, loss = _step(tp, X, Y)
    assert tmon.last_action == jmon.last_action == "ok"
    assert math.isfinite(float(ttensor.to_numpy(loss)))
    assert float(tp[0]._optimizer.get_states()["step_counter"]) == 2.0
    # the holds are off the tape: no buffer keeps a parameter's
    # gradient accumulator alive into the next step (or a capture)
    bufs = [b for sc in tp[0]._health_scratch for b in sc._bufs.values()]
    assert bufs and not any(b.requires_grad or b.grad_fn for b in bufs)
    for reg in (jobserve.get_registry(), observe.get_registry()):
        assert reg.get("singa_health_skipped_steps_total").value() == 1
    # the params after the resumed step: the two packages still agree
    for k, v in jp[0].get_params().items():
        np.testing.assert_allclose(
            tp[0]._raw_params()[k].detach().numpy(), jtensor.to_numpy(v),
            rtol=RTOL, atol=1e-6)


def test_skip_step_rolls_back_batchnorm_buffers(tmp_path):
    """The select covers the model's buffers too (JAX's step selects
    every state array): a BatchNorm's running statistics after a flagged
    step equal those before it."""

    class BN(model.Model):
        def __init__(self):
            super().__init__()
            self.l1 = layer.Linear(8)
            self.bn = layer.BatchNorm2d(8)
            self.l2 = layer.Linear(3)
            self.loss_fn = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            h = self.l1(x)
            h = self.bn(h.reshape((h.shape[0], 8, 1, 1)))
            return self.l2(h.reshape((h.shape[0], 8)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            self._optimizer(loss)
            return out, loss

    rng = np.random.RandomState(3)
    X = rng.randn(16, 5).astype(np.float32)
    Y = rng.randint(0, 3, 16).astype(np.int32)
    dev = tdevice.create_cpu_device()
    m = BN()
    m.set_optimizer(opt.Adam(lr=0.01))
    mon = health.HealthMonitor(policy="skip_step", out_dir=str(tmp_path))
    m.compile([ttensor.from_numpy(X, dev)], is_train=True, use_graph=True,
              health=mon)
    m(ttensor.from_numpy(X, dev), ttensor.from_numpy(Y, dev))
    before = _states(m)
    ob = m._optimizer.get_states()
    Xn = X.copy()
    Xn[3, 2] = np.inf
    m(ttensor.from_numpy(Xn, dev), ttensor.from_numpy(Y, dev))
    assert mon.last_action == "skip"
    assert any("running" in k or "mean" in k for k in before)
    after = m._raw_states()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    for k, v in m._optimizer.get_states().items():
        assert np.array_equal(ob[k], v), k


def _bundle_core(b):
    h = {k: v for k, v in b["header"].items()
         if k not in ("ts", "executables", "batch_snapshot", "n_events")}
    return h, [{k: s[k] for k in STAT_KEYS} for s in b["steps"]]


def test_halt_bundles_load_across_packages(data, tmp_path):
    X, Y, Xn = data
    jmon = jhealth.HealthMonitor(policy="halt", out_dir=str(tmp_path / "j"),
                                 snapshot_batch=True)
    tmon = health.HealthMonitor(policy="halt", out_dir=str(tmp_path / "t"),
                                snapshot_batch=True)
    jp, tp = _pair(X, jmon, tmon)
    _step(jp, X, Y)
    _step(tp, X, Y)
    with pytest.raises(jhealth.HealthError) as je:
        _step(jp, Xn, Y)
    with pytest.raises(health.HealthError) as te:
        _step(tp, Xn, Y)
    assert os.path.exists(te.value.bundle_path)
    assert observe.get_registry().get("singa_health_halt_total").value() == 1
    jb, tb = je.value.bundle_path, te.value.bundle_path
    assert os.path.basename(jb) == os.path.basename(tb)
    loads = {"jax->port": health.load_flight_bundle(jb),
             "port->jax": jhealth.load_flight_bundle(tb),
             "jax": jhealth.load_flight_bundle(jb),
             "port": health.load_flight_bundle(tb)}
    # the bundle pins the builds made so far (none: eager steps)
    assert loads["port"]["header"]["executables"] == (
        introspect.executable_manifest()[-8:] or None)
    ref_h, ref_s = _bundle_core(loads["jax"])
    for name, b in loads.items():
        h, steps = _bundle_core(b)
        assert h == ref_h, name
        assert len(steps) == len(ref_s) == 2
        for a, c in zip(ref_s, steps):
            _close(a, c)
        assert b["batch"] is not None and b["batch"].keys() == {"input0",
                                                                "input1"}
        np.testing.assert_array_equal(b["batch"]["input0"], Xn)
        np.testing.assert_array_equal(b["batch"]["input1"], Y)
    ev = [e for e in loads["port->jax"]["events"] if e.get("kind") == "health"]
    assert ev == [] or all("anomaly" in e for e in ev)


def _stats(loss=1.0, gn=1.0, nfg=0, nfl=0):
    return {"loss": loss, "grad_norm": gn, "nonfinite_grads": nfg,
            "nonfinite_loss": nfl,
            "groups": {"l1": {"param_norm": 2.0, "update_norm": 0.01,
                              "update_ratio": 0.005}}}


def _monitor_run(mod, tmp, seq, **kw):
    mon = mod.HealthMonitor(out_dir=str(tmp), **kw)
    acts = []
    for i, st in enumerate(seq, 1):
        try:
            acts.append(mon.on_step(st, step=i))
        except (jhealth.HealthError, health.HealthError):
            acts.append("raised")
    files = sorted(f for f in os.listdir(tmp) if f.endswith(".jsonl")) \
        if os.path.isdir(tmp) else []
    return acts, files, [r["anomaly_kinds"] for r in mon.recorder.ring], \
        mon.verdict()["status"]


_SPIKE = [_stats(loss=1.0 + 0.01 * (i % 3)) for i in range(12)] \
    + [_stats(loss=50.0), _stats(loss=1.0)]
MONITOR_CASES = {
    "loss_spike": (_SPIKE, dict(policy="warn", warmup_steps=5)),
    "spike_under_skip_downgrades": (_SPIKE, dict(policy="skip_step",
                                                 warmup_steps=5)),
    "grad_norm_limit": ([_stats(gn=1.0), _stats(gn=100.0), _stats(gn=2.0)],
                        dict(policy="warn", grad_norm_limit=10.0)),
    "grad_norm_limit_halts": ([_stats(gn=1.0), _stats(gn=100.0)],
                              dict(policy="halt", grad_norm_limit=10.0)),
    "dump_cooldown": ([_stats(loss=float("nan"), nfl=1)] * 6 + [_stats()]
                      + [_stats(loss=float("nan"), nfl=1)] * 9,
                      dict(policy="warn", window=8, dump_cooldown=8)),
    "nonfinite_loss_alone": ([_stats(loss=float("nan"), nfl=1)],
                             dict(policy="warn")),
}


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_host_monitor_matches_jax(tmp_path, case):
    seq, kw = MONITOR_CASES[case]
    got = _monitor_run(health, tmp_path / "t", seq, **kw)
    want = _monitor_run(jhealth, tmp_path / "j", seq, **kw)
    assert got == want
    jm_, tm_ = (_health_metrics(jobserve.get_registry()),
                _health_metrics(observe.get_registry()))
    assert {k: v for k, v in jm_.items() if k[0].endswith("_total")} == \
        {k: v for k, v in tm_.items() if k[0].endswith("_total")}


def test_note_external_and_bad_policy_match_jax():
    for mod in (jhealth, health):
        with pytest.raises(ValueError):
            mod.HealthMonitor(policy="nope")
    outs = []
    for mod, obs_mod in ((jhealth, jobserve), (health, observe)):
        mon = mod.HealthMonitor(policy="halt")
        a = mon.note_external(mod.KIND_SLO, detail={"objective": "ttft_p99"})
        b = mon.note_external(mod.KIND_SLO, action="warn")
        c = obs_mod.get_registry().get("singa_health_anomaly_total")
        outs.append((a, b, c.value(kind="slo"),
                     obs_mod.get_registry().get(
                         "singa_health_halt_total").value(),
                     mon.verdict()["status"]))
    assert outs[0] == outs[1] == ("halt", "warn", 2.0, 1.0, "warn")


def test_recompile_with_health_drops_stale_graphs(data, tmp_path):
    X, Y, Xn = data
    _, (tm, dev) = _pair(X, None, None)
    tm(ttensor.from_numpy(X, dev), ttensor.from_numpy(Y, dev))
    assert tm._train_steps
    before = _states(tm)
    mon = health.HealthMonitor(policy="skip_step", out_dir=str(tmp_path))
    tm.compile([ttensor.from_numpy(X, dev)], is_train=True, use_graph=True,
               health=mon)
    assert not tm._train_steps
    tm(ttensor.from_numpy(Xn, dev), ttensor.from_numpy(Y, dev))
    assert mon.last_action == "skip"
    after = tm._raw_states()
    for k in before:
        assert torch.equal(before[k], after[k]), k


def test_compile_health_false_and_detach(data):
    X, Y, _ = data
    _, (tm, dev) = _pair(X, True, True)
    assert isinstance(tm._health_monitor, health.HealthMonitor)
    assert tm._health_monitor.policy == "warn"
    tm.compile([ttensor.from_numpy(X, dev)], is_train=True, use_graph=True,
               health=False)
    assert tm._health_monitor is None
    tm(ttensor.from_numpy(X, dev), ttensor.from_numpy(Y, dev))
    with pytest.raises(TypeError):
        tm.compile([ttensor.from_numpy(X, dev)], is_train=True,
                   use_graph=True, health="warn")
    a, b = TMLP(), TMLP()
    mon = health.HealthMonitor()
    a.set_health_monitor(mon)
    assert health.active_monitor() is mon
    b.set_health_monitor(None)
    assert health.active_monitor() is mon
    a.set_health_monitor(None)
    assert health.active_monitor() is None


def test_eager_skip_policy_books_warn_and_amp_overflow(data, tmp_path):
    """Eagerly a skip_step anomaly is booked as warn (the rollback is the
    graph-mode step's), in both packages; under amp a non-finite grad
    counts singa_health_overflow_total."""
    X, Y, Xn = data
    jmon = jhealth.HealthMonitor(policy="skip_step",
                                 out_dir=str(tmp_path / "j"))
    tmon = health.HealthMonitor(policy="skip_step",
                                out_dir=str(tmp_path / "t"))
    jp, tp = _pair(X, jmon, tmon, use_graph=False)
    for x in (X, Xn):
        _step(jp, x, Y)
        _step(tp, x, Y)
    assert jmon.last_action == tmon.last_action == "warn"
    mon = health.HealthMonitor(policy="skip_step", out_dir=str(tmp_path))
    _, (tm, dev) = _pair(X, None, mon, amp="bfloat16")
    tm(ttensor.from_numpy(X, dev), ttensor.from_numpy(Y, dev))
    tm(ttensor.from_numpy(Xn, dev), ttensor.from_numpy(Y, dev))
    assert mon.last_action == "skip"
    assert observe.get_registry().get(
        "singa_health_overflow_total").value() == 1


def test_apply_skip_matches_jax():
    import jax.numpy as jnp
    old = [np.ones(3, np.float32)]
    new = [np.full(3, 2.0, np.float32), np.full(2, 5.0, np.float32)]
    for flag in (1, 0):
        want = jhealth.apply_skip({"anomaly": jnp.int32(flag)},
                                  [jnp.asarray(a) for a in old],
                                  [jnp.asarray(a) for a in new])
        got = health.apply_skip({"anomaly": torch.tensor(flag)},
                                [torch.from_numpy(a) for a in old],
                                [torch.from_numpy(a) for a in new])
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_collector_packs_one_tensor_and_splits_large_counts():
    """finalize packs every scalar into one fp32 tensor; a count past
    2^24 (where fp32 stops holding integers) comes back exact."""
    col = health.StepStatsCollector({})
    col.observe_loss(torch.tensor(1.5))
    p = torch.zeros(3)
    g = torch.full((3,), float("nan"))
    col.observe(p, g, p, p + 1.0)
    col._nonfinite.append(torch.tensor((1 << 24) + 5))
    stats = col.finalize()
    assert col.packed.dtype == torch.float32 and col.packed.dim() == 1
    host = health.unpack(col.packed.tolist(), col.layout)
    assert host["nonfinite_grads"] == (1 << 24) + 8
    assert host["anomaly"] == 1 and host["nonfinite_loss"] == 0
    assert int(stats["nonfinite_grads"]) == (1 << 24) + 8
    assert host["groups"]["other"]["update_norm"] == pytest.approx(
        math.sqrt(3.0))
    # a communicator without a process group (world size 1) reduces
    # nothing: the same packed stats
    from singa_tpu_torch.parallel import Communicator
    comm = Communicator()
    again = health.StepStatsCollector({}, comm=comm)
    again.observe_loss(torch.tensor(1.5))
    again.observe(p, g, p, p + 1.0)
    again._nonfinite.append(torch.tensor((1 << 24) + 5))
    again.finalize(comm=comm)
    torch.testing.assert_close(again.packed, col.packed, rtol=0, atol=0,
                               equal_nan=True)
    # the collector has one communicator: finalize may not name another
    with pytest.raises(ValueError, match="another communicator"):
        again.finalize(comm=Communicator())


def test_fit_halt_attaches_partial_progress(data, tmp_path):
    X, Y, Xn = data
    mon = health.HealthMonitor(policy="halt", out_dir=str(tmp_path))
    _, (tm, dev) = _pair(X, None, mon)
    batches = [(ttensor.from_numpy(x, dev), ttensor.from_numpy(Y, dev))
               for x in (X, X, Xn, X)]
    with pytest.raises(health.HealthError) as ei:
        tm.fit(batches, epochs=1)
    part = ei.value.partial
    assert part["epoch"] == 0 and part["steps_completed"] == 2
    assert len(part["losses"]) == 2 and part["last_loss"] == part["losses"][1]


# ---- resilience: fault injection ----------------------------------------

def _drive(mod, plan_fn, arrivals):
    plan = plan_fn(mod.FaultPlan())
    mod.install_fault_plan(plan)
    out = []
    try:
        for point, ctx in arrivals:
            try:
                mod.fault_point(point, **ctx)
                out.append("ok")
            except RuntimeError as e:
                out.append(f"raised {e}")
    finally:
        mod.clear_fault_plan()
    return out, list(plan.fired), {p: plan.count(p) for p, _ in arrivals}


def test_fault_plan_rules_match_jax():
    arrivals = ([("ckpt.save", {"step": s}) for s in range(1, 6)]
                + [("data.next", {})] * 4
                + [("serving.engine_step", {"slots": 2})] * 2)

    def plan_fn(p):
        return (p.fail("ckpt.save", nth=2)
                .fail("ckpt.save", step=4)
                .fail("data.next", times=2)
                .delay("serving.engine_step", 0.01, times=1))

    got = _drive(resilience, plan_fn, arrivals)
    want = _drive(jres, plan_fn, arrivals)
    assert got == want
    assert got[1] == [("ckpt.save", 2, "fail"), ("ckpt.save", 4, "fail"),
                      ("data.next", 1, "fail"), ("data.next", 2, "fail"),
                      ("serving.engine_step", 1, "delay")]
    c = observe.get_registry().get("singa_resilience_faults_injected_total")
    assert c.value(kind="fail") == 4 and c.value(kind="delay") == 1
    assert jobserve.get_registry().get(
        "singa_resilience_faults_injected_total").value(kind="fail") == 4
    ev = [e for e in observe.get_registry().recent
          if e.get("event") == "fault_injected"]
    assert len(ev) == 5 and ev[0]["point"] == "ckpt.save"
    # no plan: every point is a no-op
    resilience.fault_point("data.next")


def test_fault_points_are_wired(data, tmp_path):
    """data.next fires once per fetch in fit (and in the data iterator
    and the prefetcher it wraps), ckpt.wait once per pending write, and
    a custom exception passes through."""
    from singa_tpu_torch import data as tdata, overlap
    X, Y, _ = data
    _, (tm, dev) = _pair(X, None, None)
    plan = resilience.install_fault_plan(resilience.FaultPlan())
    batches = [(ttensor.from_numpy(X[i:i + 8], dev),
                ttensor.from_numpy(Y[i:i + 8], dev)) for i in (0, 8, 16)]
    tm.fit(batches, epochs=1)
    # fit's fetches: 3 batches and the end
    assert plan.count("data.next") == 4
    it = tdata.NumpyBatchIter(X, Y, 8, shuffle=False)
    tm.fit(it, epochs=1, prefetch_to_device=2)
    # and over the prefetcher: fit's 5, the prefetcher's 5, the
    # iterator's 4 (one per batch)
    assert plan.count("data.next") == 4 + 5 + 5 + 4
    tm.save_checkpoint(str(tmp_path), step=1)
    overlap.wait_for_checkpoints()
    assert plan.count("ckpt.wait") == 1
    plan.fail("data.next", exc=KeyError("boom"))
    with pytest.raises(KeyError):
        tm.fit(batches, epochs=1)


# ---- serving: the non-finite logit watch -----------------------------------

TINY = dict(vocab_size=64, max_seq=16, dim=32, num_heads=4, num_layers=1)


def test_generate_nan_logit_count_matches_jax():
    from singa_tpu import device as jdevice
    jm = jmodels.create_model("gpt", **TINY)
    ids = np.random.RandomState(0).randint(0, 64, (2, 4)).astype(np.int32)
    jdev = jdevice.best_device()
    jm.compile([jtensor.from_numpy(ids, device=jdev)], is_train=False,
               use_graph=False)
    tm = tt.GPT(**TINY, device="cpu")
    tt.load_singa_params(
        tm, {k: jtensor.to_numpy(v) for k, v in jm.get_params().items()})
    for m, reg in ((jm, jobserve.get_registry()),
                   (tm, observe.get_registry())):
        m.generate(ids, 3)
        assert reg.get("singa_health_nan_logits_total") is None
    # one poisoned element of the output head: its logit column is
    # non-finite in every row
    W = jtensor.to_numpy(jm.head.W).copy()
    W[5, 7] = np.inf
    jm.head.W.copy_from_numpy(W)
    jm._param_cache = None
    with torch.no_grad():
        tm.head.W[5, 7] = float("inf")
    want = jm.generate(ids, 3)
    got = tm.generate(ids, 3)
    np.testing.assert_array_equal(got, want)
    jc = jobserve.get_registry().get("singa_health_nan_logits_total")
    tc = observe.get_registry().get("singa_health_nan_logits_total")
    assert tc.value(kind="greedy") == jc.value(kind="greedy") > 0
    # observe disabled: nothing is counted or booked
    observe.enable(False)
    tm.generate(ids, 3)
    observe.enable(True)
    assert tc.value(kind="greedy") == jc.value(kind="greedy")
    # beam and speculative decoding book under their own kinds
    tm.generate_beam(ids, 3, num_beams=2)
    assert tc.value(kind="beam") > 0
    tm.generate(ids, 3, draft_model=tm, spec_k=2)
    assert tc.value(kind="spec") > 0


def test_engine_nan_logit_count_matches_jax():
    """The engine counts the non-finite logits of each prefill and sync
    (active slots only) beside the tokens: with a poisoned head element
    and the same requests queued before `start()`, the port books what
    the JAX engine books."""
    from singa_tpu import device as jdevice
    from singa_tpu import engine as jengine
    from singa_tpu_torch import engine as tengine
    cfg = dict(TINY, max_seq=32)
    jm = jmodels.create_model("gpt", **cfg)
    ids = np.random.RandomState(0).randint(0, 64, (2, 4)).astype(np.int32)
    jm.compile([jtensor.from_numpy(ids, device=jdevice.best_device())],
               is_train=False, use_graph=False)
    tm = tt.GPT(**cfg, device="cpu")
    W = jtensor.to_numpy(jm.head.W).copy()
    W[3, 11] = np.inf
    jm.head.W.copy_from_numpy(W)
    jm._param_cache = None
    tt.load_singa_params(
        tm, {k: jtensor.to_numpy(v) for k, v in jm.get_params().items()})
    rng = np.random.RandomState(2)
    specs = [(rng.randint(0, 64, (s0,)).astype(np.int32), mn)
             for s0, mn in ((5, 6), (9, 3), (3, 1), (7, 8))]
    got = {}
    for name, mod, m, obs in (("jax", jengine, jm, jobserve),
                              ("port", tengine, tm, observe)):
        e = mod.ServingEngine(m, max_slots=2, page_size=8, max_ctx=32,
                              steps_per_sync=3)
        reqs = [mod.EngineRequest(i, p, mn, None, None)
                for i, (p, mn) in enumerate(specs)]
        e._queue.extend(reqs)
        e.start()
        try:
            for r in reqs:
                assert r.wait(300)
        finally:
            e.stop()
        got[name] = (obs.get_registry().get("singa_health_nan_logits_total")
                     .value(kind="engine"), [r.tokens for r in reqs])
    assert got["port"] == got["jax"]
    assert got["port"][0] > 0
