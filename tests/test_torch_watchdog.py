"""Port parity, operation deadlines and hang forensics:
singa_tpu_torch.watchdog against singa_tpu.watchdog.

- `calibrated_deadline` and `OpDeadline` give equal deadlines for the
  same seeded samples in both packages (rtol 1e-12).
- The cases of tests/test_watchdog.py that need no controller, fleet or
  collective, run on both packages: the guard is a no-op without a
  watchdog, nested same-op guards count once, a build span taints, the
  warn/dump/abort ladder (driven by a FaultPlan delay under a static
  deadline) with equal singa_watchdog_* counts, HangError at the guard's
  exit (through `Model.fit`'s data wait too), the async abort of a
  thread spinning in Python, no stale abort inherited, and an unknown op
  raising.
- The port's kernel-build span (`ops._build`, stubbed: no nvcc here)
  taints a guard, so a first build never breaches.
- The serving engine's decode loop dies on HangError with every request
  evicted and the error in each detail; `generate`'s decode guard.
- Hang bundles load across the packages with equal line kinds and header
  keys.
- One `watchdog --ab --device cpu` run at the CLI's defaults (3 worker
  processes, one wedged), kept on two cores, holds its record's `ok`; a
  `cuda` run without a card raises.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from singa_tpu import health as jhealth
from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu import observe as jobserve
from singa_tpu import opt as jopt
from singa_tpu import resilience as jres
from singa_tpu import tensor as jtensor
from singa_tpu import watchdog as jwatchdog
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import engine as tengine
from singa_tpu_torch import (goodput, health, introspect, layer, memory,
                             model, observe)
from singa_tpu_torch import opt, resilience, watchdog
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.models import transformer as tt
from singa_tpu_torch.ops import _build

import torch_ab

torch.set_num_threads(2)
TDEV = tdevice.create_cpu_device()


@pytest.fixture(autouse=True)
def _port_state():
    """Each test starts and ends with no port watchdog, ledger, tracker,
    monitor or fault plan (tests/conftest.py resets only the JAX
    package's), and the JAX package's watchdog and fault plan cleared
    before tests/conftest.py's thread-leak check."""
    def clean():
        watchdog.uninstall_watchdog()
        jwatchdog.uninstall_watchdog()
        goodput.uninstall()
        memory.reset()
        tengine.reset()
        health.set_active_monitor(None)
        resilience.clear_fault_plan()
        jres.clear_fault_plan()
        observe.get_registry().reset()
        observe.enable(True)
        introspect.reset()
    clean()
    yield
    clean()


PKGS = {
    "jax": (jwatchdog, jobserve, jres, jhealth),
    "port": (watchdog, observe, resilience, health),
}


def _install(wd_mod, out_dir, **kw):
    cfg = dict(action="abort", dump_at=1.5, abort_at=2.0, hard_at=100.0,
               poll_interval_s=0.005, out_dir=str(out_dir))
    cfg.update(kw)
    return wd_mod.install_watchdog(**cfg)


def _counts(obs):
    """{(metric, op): value} of the singa_watchdog_* counters."""
    reg = obs.get_registry()
    out = {}
    for name in ("singa_watchdog_breach_total", "singa_watchdog_dump_total",
                 "singa_watchdog_abort_total",
                 "singa_watchdog_hard_abort_total"):
        c = reg.get(name)
        if c is not None:
            for _, k, v in c.samples():
                out[(name, k)] = v
    return out


# ---- deadlines --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibrated_deadline_and_op_deadline_match_jax(seed):
    rng = np.random.RandomState(seed)
    samples = list(rng.lognormal(-3.0, 1.0, 300))
    kw = dict(multiplier=7.5, floor_s=0.01, ceiling_s=2.0, min_samples=8)
    for n in (3, 8, 9, 50, 300):
        a = jwatchdog.calibrated_deadline(samples[:n], **kw)
        b = watchdog.calibrated_deadline(samples[:n], **kw)
        assert (a is None and b is None) or \
            b == pytest.approx(a, rel=1e-12), (n, a, b)
    ja = jwatchdog.OpDeadline("decode", window=64, **kw)
    ta = watchdog.OpDeadline("decode", window=64, **kw)
    for x in samples:
        ja.add_sample(x)
        ta.add_sample(x)
        a, b = ja.deadline(), ta.deadline()
        assert (a is None and b is None) or b == pytest.approx(a, rel=1e-12)
    js = jwatchdog.OpDeadline("step", static=0.25)
    ts = watchdog.OpDeadline("step", static=0.25)
    js.add_sample(10.0)
    ts.add_sample(10.0)
    assert js.deadline() == ts.deadline() == 0.25


def test_constants_and_names_match_jax():
    assert watchdog.DEADLINE_OPS == jwatchdog.DEADLINE_OPS
    assert watchdog.ESCALATION == jwatchdog.ESCALATION
    assert watchdog._BUILD_SPAN_LEAVES == jwatchdog._BUILD_SPAN_LEAVES
    assert watchdog.__all__ == jwatchdog.__all__
    assert issubclass(watchdog.HangError, health.HealthError)
    e = watchdog.HangError("x", op="step", seconds=1.5, bundle_path="b")
    assert (e.op, e.seconds, e.bundle_path, e.hosts) == ("step", 1.5, "b",
                                                         ())


# ---- guard semantics, on both packages ------------------------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_guard_noop_and_unknown_op(pkg, tmp_path):
    wd_mod, obs, _, _ = PKGS[pkg]
    assert wd_mod.get_watchdog() is None
    with wd_mod.guard("step"):
        pass
    assert not [t for t in threading.enumerate()
                if t.name.startswith("singa-watchdog")]
    _install(wd_mod, tmp_path)
    with pytest.raises(ValueError, match="DEADLINE_OPS"):
        with wd_mod.guard("bogus"):
            pass
    with pytest.raises(ValueError, match="not in"):
        wd_mod.Watchdog(deadlines={"bogus": 1.0}).close()
    with pytest.raises(ValueError, match="warn"):
        wd_mod.Watchdog(action="explode")


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_nested_guard_counts_once_and_build_span_taints(pkg, tmp_path):
    wd_mod, obs, _, _ = PKGS[pkg]
    wd = _install(wd_mod, tmp_path, min_samples=2, floor_s=0.001,
                  ceiling_s=10.0)
    with wd_mod.guard("step"):
        with wd_mod.guard("step"):
            pass
        assert len(wd.armed()) == 1
    assert len(wd.op_state("step").samples) == 1
    with wd_mod.guard("step"):
        with obs.span("introspect.build"):
            assert wd.armed()[0]["tainted"]
    assert len(wd.op_state("step").samples) == 1    # tainted: excluded
    with wd_mod.guard("step"):
        pass
    assert wd.op_state("step").deadline() is not None
    assert obs.get_registry().get(
        "singa_watchdog_deadline_seconds").value(op="step") \
        == wd.op_state("step").deadline()


def _ladder(pkg, tmp_path):
    """A data wait wedged by a FaultPlan delay (0.4 s) under a static
    0.05 s deadline: warn, dump and abort, then HangError at the guard's
    exit."""
    wd_mod, obs, res, hl = PKGS[pkg]
    mon = hl.HealthMonitor(policy="warn", out_dir=str(tmp_path / "flight"))
    hl.set_active_monitor(mon)
    wd = _install(wd_mod, tmp_path, deadlines={"data_wait": 0.05})
    res.install_fault_plan(res.FaultPlan().delay("data.next", 0.4))
    try:
        with pytest.raises(wd_mod.HangError) as ei:
            with wd_mod.guard("data_wait"):
                res.fault_point("data.next")
    finally:
        hl.set_active_monitor(None)
    kinds = obs.get_registry().get("singa_health_anomaly_total")
    return wd, ei.value, mon, kinds.value(kind=hl.KIND_HANG)


def test_ladder_counts_and_hangerror_match_jax(tmp_path):
    out = {p: _ladder(p, tmp_path / p) for p in sorted(PKGS)}
    jc, tc = _counts(jobserve), _counts(observe)
    assert jc == tc
    assert tc == {(n, (("op", "data_wait"),)): 1.0 for n in (
        "singa_watchdog_breach_total", "singa_watchdog_dump_total",
        "singa_watchdog_abort_total")}
    for p, (wd, e, mon, hangs) in out.items():
        assert e.op == "data_wait" and e.seconds >= 0.1
        assert e.bundle_path == wd.last_bundle and os.path.exists(
            e.bundle_path) and os.path.exists(e.bundle_path + ".stacks.txt")
        assert hangs == 1
        assert any(r.get("anomaly_kinds") == ["hang"]
                   for r in mon.recorder.ring)
        assert wd.hang_report()["stage"] == "abort"
    j, t = out["jax"][0].last_breach, out["port"][0].last_breach
    assert {k for k in j} == {k for k in t}
    assert (j["op"], j["stage"], j["deadline"], j["id"]) \
        == (t["op"], t["stage"], t["deadline"], t["id"])


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_async_abort_of_a_spinning_thread(pkg, tmp_path):
    wd_mod, obs, _, _ = PKGS[pkg]
    _install(wd_mod, tmp_path, deadlines={"step": 0.05}, abort_at=1.5,
             hard_at=2.5)
    caught = []

    def wedged():
        try:
            with wd_mod.guard("step"):
                for _ in range(600):        # ~6 s: never exits in time
                    time.sleep(0.01)
        except wd_mod.HangError as e:
            caught.append(e)

    t = threading.Thread(target=wedged, name="wedge-victim")
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert caught and isinstance(caught[0], wd_mod.HangError)
    assert obs.get_registry().get(
        "singa_watchdog_hard_abort_total").value(op="step") == 1


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_operation_error_outranks_abort_and_none_inherited(pkg, tmp_path):
    wd_mod, obs, _, _ = PKGS[pkg]
    wd = _install(wd_mod, tmp_path, deadlines={"decode": 0.03})

    class Boom(RuntimeError):
        pass

    with pytest.raises(Boom):
        with wd_mod.guard("decode"):
            time.sleep(0.12)
            raise Boom("the op's own failure")
    with wd_mod.guard("decode"):     # no stale abort
        pass
    g = wd_mod.guard("decode")
    g.__enter__()
    g._entry.stage = 3               # the checker mid-abort
    with pytest.raises(wd_mod.HangError):
        g.__exit__(None, None, None)
    with wd_mod.guard("decode") as g2:
        entry = g2._entry
    wd._escalate(entry, 5.0)         # a disarmed entry is never escalated
    assert entry.stage == 0 and entry.abort_s is None


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_report_and_uninstall(pkg, tmp_path):
    wd_mod, obs, _, _ = PKGS[pkg]
    wd = _install(wd_mod, tmp_path, deadlines={"step": 0.5})
    rep = wd_mod.watchdog_report()
    assert "== watchdog ==" in rep and "static" in rep and "warming" in rep
    assert "last breach: none" in rep
    name = wd._thread.name
    assert name == f"singa-watchdog-{os.getpid()}"
    wd_mod.uninstall_watchdog()
    assert not any(t.name == name and t.is_alive()
                   for t in threading.enumerate())
    assert "not installed" in wd_mod.watchdog_report()
    assert wd_mod.hang_report() is None
    wd_mod.uninstall_watchdog()      # idempotent


# ---- the port's sites -------------------------------------------------------

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
        loss = self.loss_fn(self.forward(x), y)
        self._optimizer(loss)
        return loss


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
        loss = self.loss_fn(self.forward(x), y)
        self._optimizer(loss)
        return loss


def _batches(pkg, n=3, monitor=None):
    rng = np.random.RandomState(7)
    X = rng.randn(16, 8).astype(np.float32)
    Y = rng.randint(0, 4, 16).astype(np.int32)
    if pkg == "jax":
        from singa_tpu import device as jdevice
        dev, m, mod, o = jdevice.best_device(), JMLP(), jtensor, jopt
    else:
        dev, m, mod, o = TDEV, TMLP(), ttensor, opt
    m.set_optimizer(o.SGD(lr=0.1, momentum=0.9))
    tx, ty = mod.from_numpy(X, dev), mod.from_numpy(Y, dev)
    m.compile([tx], is_train=True, use_graph=True, health=monitor)
    return m, [(tx, ty)] * n


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_fit_data_wait_abort_raises_hangerror(pkg, tmp_path):
    wd_mod, obs, res, hl = PKGS[pkg]
    mon = hl.HealthMonitor(policy="warn", out_dir=str(tmp_path))
    m, data = _batches(pkg, monitor=mon)
    _install(wd_mod, tmp_path, deadlines={"data_wait": 0.05})
    res.install_fault_plan(res.FaultPlan().delay("data.next", 0.4, nth=2))
    with pytest.raises(wd_mod.HangError) as ei:
        m.fit(data, epochs=1)
    assert ei.value.op == "data_wait"
    assert ei.value.partial["steps_completed"] == 1
    assert obs.get_registry().get("singa_health_anomaly_total").value(
        kind=hl.KIND_HANG) == 1


def test_step_guard_calibrates_and_build_taints_first_call(tmp_path):
    """The graph-mode step's guard: the first call (under model.build) is
    tainted, the later ones calibrate; the build count stays 1."""
    wd = _install(watchdog, tmp_path, min_samples=2, floor_s=600.0)
    m, data = _batches("port")
    for x, y in data:
        m(x, y)
    st = wd.op_state("step")
    assert len(st.samples) == len(data) - 1
    assert st.deadline() == 600.0
    assert m._build_count == 1


def test_kernel_build_span_taints_the_guard(tmp_path, monkeypatch):
    """A kernel library's first build inside a guarded operation (stubbed
    build: 0.3 s against a 0.05 s static deadline) taints the guard: no
    breach, no HangError, no calibration sample."""
    wd = _install(watchdog, tmp_path, deadlines={"step": 0.05})
    monkeypatch.setattr(_build, "_libs", {})

    class Job(_build._Job):
        """nvcc's process stubbed by a 0.3 s sleep."""

        def __init__(self, name, warm=None):
            self.name, self.proc = name, None

        def finish(self):
            time.sleep(0.3)
            return object()
    monkeypatch.setattr(_build, "_Job", Job)
    with watchdog.guard("step"):
        _build.lib("wgmma_probe")
    assert wd.op_state("step").breaches == 0
    assert _counts(observe) == {}
    # the same wait without the build span breaches and aborts
    with pytest.raises(watchdog.HangError):
        with watchdog.guard("step"):
            time.sleep(0.3)


def _tiny_gpt():
    torch.manual_seed(0)
    return tt.GPT(vocab_size=61, max_seq=64, dim=32, num_heads=2,
                  num_layers=2, device="cpu")


def test_engine_dies_on_hangerror_with_every_request_evicted(tmp_path):
    m = _tiny_gpt()
    mon = health.HealthMonitor(policy="warn", out_dir=str(tmp_path))
    health.set_active_monitor(mon)
    e = tengine.ServingEngine(m, max_slots=2, page_size=8, steps_per_sync=2)
    rng = np.random.RandomState(3)
    reqs = []
    for i in range(4):
        r = tengine.EngineRequest(i, rng.randint(0, 61, 5 + i).astype(
            np.int32), 8, None, None)
        e._queue.append(r)
        reqs.append(r)
    wd = _install(watchdog, tmp_path, deadlines={"decode": 0.1})
    resilience.install_fault_plan(
        resilience.FaultPlan().delay("serving.engine_step", 0.5))
    e.start()
    try:
        assert all(r.wait(30) for r in reqs)
    finally:
        e.stop()
    assert [r.outcome for r in reqs] == ["evicted"] * 4
    assert all("HangError" in r.detail for r in reqs)
    assert any(ev.get("event") == "loop_error"
               and "HangError" in ev.get("detail", "")
               for ev in observe.get_registry().recent)
    assert wd.last_breach["op"] == "decode"
    b = watchdog.load_hang_bundle(wd.last_bundle)
    wedged = [t for t in b["threads"] if t["wedged"]]
    assert len(wedged) == 1 and wedged[0]["name"].startswith("torch-serve-")
    assert wedged[0]["frames"][-1]["func"] == "fire"
    assert observe.get_registry().get("singa_health_anomaly_total").value(
        kind=health.KIND_HANG) == 1


def test_generate_decode_guard_breaches(tmp_path):
    m = _tiny_gpt()
    prompt = np.random.RandomState(1).randint(0, 61, (1, 4))
    _install(watchdog, tmp_path, deadlines={"decode": 0.05}, action="warn")
    resilience.install_fault_plan(
        resilience.FaultPlan().delay("serving.decode", 0.15, nth=2))
    m.generate(prompt, 2, temperature=0.0)
    m.generate(prompt, 2, temperature=0.0)
    assert observe.get_registry().get(
        "singa_watchdog_breach_total").value(op="decode") >= 1


# ---- bundles across the packages ------------------------------------------

def _dump(pkg, tmp_path):
    wd_mod = PKGS[pkg][0]
    wd = _install(wd_mod, tmp_path, deadlines={"step": 0.05},
                  action="dump")
    with wd_mod.guard("step") as g:
        path = wd.dump_hang_bundle("step", 0.07, entry=g._entry)
    wd_mod.uninstall_watchdog()
    return path


def test_hang_bundles_load_across_packages(tmp_path):
    memory.install_ledger(device="cpu").snapshot()
    goodput.install()
    jp = _dump("jax", tmp_path / "j")
    tp = _dump("port", tmp_path / "t")
    for path in (jp, tp):
        a, b = jwatchdog.load_hang_bundle(path), watchdog.load_hang_bundle(
            path)
        assert a == b
    j, t = watchdog.load_hang_bundle(jp), jwatchdog.load_hang_bundle(tp)
    assert j["header"].keys() == t["header"].keys()
    assert {r["kind"] for r in j["threads"]} \
        == {r["kind"] for r in t["threads"]} == {"hang_thread"}
    assert j["threads"][0].keys() == t["threads"][0].keys()
    # the bundle pins the builds made so far
    assert t["header"]["executables"] == (
        introspect.executable_manifest()[-8:] or None)
    assert t["header"]["op"] == j["header"]["op"] == "step"
    assert sum(1 for r in t["threads"] if r["wedged"]) == 1
    assert t["memory"]["regions"].keys() == set(memory.MEM_REGIONS)
    assert t["goodput"]["buckets"].keys() == set(goodput.GOODPUT_BUCKETS)
    assert t["fleet"] is None


# ---- the command line --------------------------------------------------------

def test_hang_ab_on_cpu(tmp_path, tmp_path_factory, monkeypatch):
    """`watchdog --ab --device cpu` at the CLI's defaults: the hang op is
    `collective`, the wedged worker aborted, restored and completed, every
    peer restored with it, /fleetz marked the wedged host and then
    cleared it, and the loss curves agree within 1e-4. The coordinator
    and its worker processes (which inherit its affinity) share two
    cores, one subprocess A/B at a time (`torch_ab.two_cores`)."""
    out = str(tmp_path / "HANG_test.json")
    with torch_ab.two_cores(tmp_path_factory, monkeypatch):
        rc = watchdog.main(["--ab", "--device", "cpu", "--timeout", "120",
                            "--out", out])
    with open(out, encoding="utf-8") as f:
        rec = json.load(f)
    assert rc == 0 and rec["ok"] is True, rec
    assert rec["device"] == "cpu" and rec["worker_rcs"] == [0, 0, 0]
    assert rec["hang_op"] == "collective" and rec["wedged_restarts"] >= 1
    assert rec["coordinated"] and rec["max_abs_loss_delta"] < 1e-4
    assert rec["fleetz_marks_wedged"] and rec["fleetz_wedged_cleared"]
    assert watchdog.get_watchdog() is None


def test_hang_ab_needs_the_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        watchdog.main(["--ab", "--out", str(tmp_path / "h.json")])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        watchdog.main(["--worker", "--fleet-dir", str(tmp_path),
                       "--ckpt-dir", str(tmp_path)])
