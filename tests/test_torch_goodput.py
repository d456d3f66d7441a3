"""Port parity, goodput accounting: singa_tpu_torch.goodput against
singa_tpu.goodput (the module is the JAX package's, over the port's
observe).

- Scripted span streams (listener calls with fixed seconds, on a fake
  clock patched into both modules) fed to both trackers give equal
  bucket totals, snapshots and windows at rtol 1e-9: nesting, the
  pending `model.step` hold, `mark_step_skipped`, the mid-span
  reservation, a serving thread's commits, the window's tick and prune.
- `fit` on the MLP of tests/test_goodput.py with `skip_step` and a NaN
  batch: the same non-empty buckets and the same number of steps moved
  into `health_skip` as JAX.
- A slow iterator shifts time into `data_wait`; a kernel build's
  `introspect.build` span books `compile`; the save/load states path
  books `checkpoint`; the build count stays 1.
- `data.NumpyBatchIter`'s batch waits are `data.wait` spans, as the JAX
  iterator's are (ROADMAP.md Queue 3, fault 7).
"""

import threading
import time

import numpy as np
import pytest
import torch

from singa_tpu import goodput as jgoodput
from singa_tpu import health as jhealth
from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu import observe as jobserve
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import goodput, health, layer, model, observe, opt
from singa_tpu_torch import memory, resilience, watchdog
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.ops import _build

torch.set_num_threads(2)
RTOL = 1e-9
TDEV = tdevice.create_cpu_device()


@pytest.fixture(autouse=True)
def _port_state():
    """The port's tracker, watchdog, ledger, monitor, fault plan and
    registry are reset around each test (tests/conftest.py resets only
    the JAX package's)."""
    def clean():
        goodput.uninstall()
        watchdog.uninstall_watchdog()
        memory.reset()
        health.set_active_monitor(None)
        resilience.clear_fault_plan()
        observe.get_registry().reset()
        observe.enable(True)
    clean()
    yield
    clean()


class FakeTime:
    """A module stand-in with a scripted clock: `monotonic()` and
    `time()` read `now`, which the script advances."""

    def __init__(self, t0=100.0):
        self.now = float(t0)

    def monotonic(self):
        return self.now

    def time(self):
        return self.now

    def perf_counter(self):
        return self.now


# ---- scripted span streams --------------------------------------------------

def _span(clock, trk, path, seconds):
    """One mapped or unmapped span of `seconds` on the calling thread,
    entered and exited through the listener pair."""
    trk.on_span_enter(path)
    clock.now += seconds
    trk.on_span(path, seconds, {})


def script_nesting(mod, clock, trk):
    trk.on_span_enter("model.eval")
    clock.now += 0.01
    _span(clock, trk, "model.eval/introspect.build", 0.03)
    clock.now += 0.005
    trk.on_span("model.eval", 0.045, {})
    # same-bucket nesting: only the outer span's gross time lands
    trk.on_span_enter("data.wait")
    _span(clock, trk, "data.wait/data.wait", 0.02)
    clock.now += 0.01
    trk.on_span("data.wait", 0.03, {})
    _span(clock, trk, "unmapped.thing", 0.007)
    clock.now += 0.03        # unattributed: `other` at the snapshot


def script_pending_and_skip(mod, clock, trk):
    trk.on_span_enter("model.step")
    _span(clock, trk, "model.step/model.build", 0.5)
    clock.now += 0.1
    trk.on_span("model.step", 0.6, {})
    trk.mark_step_skipped()             # the first step was discarded
    _span(clock, trk, "model.step", 0.2)
    mid = trk.snapshot()                # a scrape in the verdict window
    trk.mark_step_skipped()
    _span(clock, trk, "model.step", 0.25)
    clock.now += 0.04
    return mid


def script_midspan_reservation(mod, clock, trk):
    trk.on_span_enter("model.eval")
    _span(clock, trk, "model.eval/introspect.build", 0.06)
    clock.now += 0.01
    mid = trk.snapshot()                # eval still open
    clock.now += 0.02
    trk.on_span("model.eval", 0.09, {})
    trk.add("checkpoint", 0.25)
    clock.now += 0.25
    return mid


def script_serving_thread(mod, clock, trk):
    _span(clock, trk, "model.step", 0.03)
    out = {}

    def serve():
        _span(clock, trk, "serving.decode", 0.01)
        _span(clock, trk, "serving.engine_step", 0.004)   # unmapped leaf
        out["ok"] = True

    th = threading.Thread(target=serve)
    th.start()
    th.join()
    trk.mark_step_skipped()             # the training thread's verdict
    return out


def script_window(mod, clock, trk):
    for i in range(400):
        clock.now += 1e-4 if i % 7 else 0.3    # ticks and gaps
        trk.add("step" if i % 11 else "data_wait", 1e-5 * (i % 5 + 1))
    clock.now += 0.5
    mid = trk.snapshot()
    clock.now += 5.0                    # the committed entries age out
    return mid


SCRIPTS = {"nesting": script_nesting, "pending_skip": script_pending_and_skip,
           "midspan": script_midspan_reservation,
           "serving_thread": script_serving_thread, "window": script_window}


def _close(a, b, path="out"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=RTOL, abs=1e-12), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _run_script(mod, reg, name, monkeypatch):
    clock = FakeTime()
    monkeypatch.setattr(mod, "time", clock)
    reg.reset()
    window_s = 2.0 if name == "window" else 300.0
    trk = mod.GoodputTracker(window_s=window_s, pending_grace_s=30.0)
    mid = SCRIPTS[name](mod, clock, trk)
    final = trk.snapshot(final=True)
    c = reg.get("singa_time_seconds_total")
    counters = {b: c.value(bucket=b) for b in mod.GOODPUT_BUCKETS}
    ratio = reg.get("singa_goodput_ratio")
    return {"mid": mid if isinstance(mid, dict) and "wall_s" in mid
            else None, "final": final, "totals": dict(trk._totals),
            "counters": counters, "window": list(trk._window),
            "ratio": ratio.value() if ratio is not None else None}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripted_span_stream_matches_jax(name, monkeypatch):
    j = _run_script(jgoodput, jobserve.get_registry(), name, monkeypatch)
    t = _run_script(goodput, observe.get_registry(), name, monkeypatch)
    assert len(j["window"]) == len(t["window"])
    for a, b in zip(j["window"], t["window"]):
        assert a[1] == b[1]
        assert b[0] == pytest.approx(a[0], rel=RTOL)
        assert b[2] == pytest.approx(a[2], rel=RTOL, abs=1e-15)
    del j["window"], t["window"]
    _close(j, t)
    assert any(v > 0 for v in t["final"]["buckets"].values())


def test_enum_names_and_span_table_match_jax():
    assert goodput.GOODPUT_BUCKETS == jgoodput.GOODPUT_BUCKETS
    assert goodput.SPAN_BUCKETS == jgoodput.SPAN_BUCKETS
    assert goodput.__all__ == jgoodput.__all__
    for n in jgoodput.__all__:
        if n.startswith("BUCKET_"):
            assert getattr(goodput, n) == getattr(jgoodput, n)
    with pytest.raises(ValueError):
        goodput.GoodputTracker().add("coffee_break", 1.0)


def test_install_exports_every_bucket_and_report():
    t = goodput.install()
    assert goodput.install() is t and goodput.get_tracker() is t
    txt = observe.to_prometheus_text()
    for b in goodput.GOODPUT_BUCKETS:
        assert f'singa_time_seconds_total{{bucket="{b}"}}' in txt, b
    rep = goodput.goodput_report()
    assert "== goodput ==" in rep and all(b in rep for b in
                                          goodput.GOODPUT_BUCKETS)
    goodput.uninstall()
    assert "not installed" in goodput.goodput_report()
    with observe.span("data.wait"):
        time.sleep(0.01)
    assert t.snapshot()["buckets"]["data_wait"] == 0.0  # detached
    goodput.mark_step_skipped()                          # no-op


# ---- the train loop ---------------------------------------------------------

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


def _data():
    rng = np.random.RandomState(0)
    X = rng.randn(32, 10).astype(np.float32)
    Y = rng.randint(0, 4, 32).astype(np.int32)
    Xn = X.copy()
    Xn[0, 0] = np.nan
    return X, Y, Xn


def _port_mlp(X, health_mon=None):
    m = TMLP()
    m.set_optimizer(opt.SGD(lr=0.1))
    m.compile([ttensor.from_numpy(X, TDEV)], is_train=True, use_graph=True,
              health=health_mon)
    return m


def _count_skips(trk):
    calls = []
    real = trk.mark_step_skipped

    def spy():
        calls.append(1)
        real()
    trk.mark_step_skipped = spy
    return calls


def test_fit_skip_step_buckets_match_jax(tmp_path):
    X, Y, Xn = _data()
    from singa_tpu import device as jdevice
    jdev = jdevice.best_device()
    jtr = jgoodput.install()
    jcalls = _count_skips(jtr)
    jm = JMLP()
    jm.set_optimizer(jopt.SGD(lr=0.1))
    jm.compile([jtensor.from_numpy(X, jdev)], is_train=True, use_graph=True,
               health=jhealth.HealthMonitor(policy="skip_step",
                                            out_dir=str(tmp_path / "j")))
    jb = [(jtensor.from_numpy(x, jdev), jtensor.from_numpy(Y, jdev))
          for x in (X, Xn, X, X)]
    jm.fit(jb, epochs=1)
    js = jtr.snapshot(final=True)
    jgoodput.uninstall()

    ttr = goodput.install()
    tcalls = _count_skips(ttr)
    tm = _port_mlp(X, health.HealthMonitor(policy="skip_step",
                                           out_dir=str(tmp_path / "t")))
    tb = [(ttensor.from_numpy(x, TDEV), ttensor.from_numpy(Y, TDEV))
          for x in (X, Xn, X, X)]
    tm.fit(tb, epochs=1)
    ts = ttr.snapshot(final=True)
    nonempty = {k for k, v in js["buckets"].items() if v > 0}
    assert {k for k, v in ts["buckets"].items() if v > 0} == nonempty
    assert {"step", "compile", "data_wait", "health_skip"} <= nonempty
    assert len(jcalls) == len(tcalls) == 1
    assert abs(sum(ts["buckets"].values()) - ts["wall_s"]) \
        <= 1e-6 * ts["wall_s"] and ts["overlap_s"] == 0.0


def test_slow_iterator_shifts_time_into_data_wait():
    X, Y, _ = _data()
    t = goodput.install()
    m = _port_mlp(X)
    tx, ty = ttensor.from_numpy(X, TDEV), ttensor.from_numpy(Y, TDEV)
    m(tx, ty)   # the build, outside the measured epoch
    resilience.install_fault_plan(
        resilience.FaultPlan().delay("data.next", 0.03, times=3))
    before = t.snapshot()["buckets"]["data_wait"]
    m.fit([(tx, ty)] * 3, epochs=1)
    snap = t.snapshot()
    gained = snap["buckets"]["data_wait"] - before
    assert gained >= 0.09, snap["buckets"]
    assert gained > snap["buckets"]["step"] * 0.5


def test_train_buckets_build_count_and_checkpoint(tmp_path):
    X, Y, _ = _data()
    t = goodput.install()
    m = _port_mlp(X)
    tx, ty = ttensor.from_numpy(X, TDEV), ttensor.from_numpy(Y, TDEV)
    for _ in range(3):
        m(tx, ty)
    p = str(tmp_path / "states.zip")
    m.save_states(p)
    m.load_states(p)
    snap = t.snapshot()
    for b in ("compile", "step", "checkpoint"):
        assert snap["buckets"][b] > 0.0, b
    assert m._build_count == 1
    c = observe.get_registry().get("singa_model_compile_total")
    assert sum(v for _n, _k, v in c.samples()) == 1
    assert abs(sum(snap["buckets"].values()) - snap["wall_s"]) \
        <= 1e-6 * snap["wall_s"]


def test_kernel_build_span_books_compile(monkeypatch):
    """A kernel library's build (stubbed: no nvcc here) runs inside
    `introspect.build`, which goodput books as `compile`."""
    t = goodput.install()
    monkeypatch.setattr(_build, "_libs", {})

    class Job(_build._Job):
        """nvcc's process stubbed by a 0.1 s sleep."""

        def __init__(self, name, warm=None):
            self.name, self.proc = name, None

        def finish(self):
            time.sleep(0.1)
            return object()
    monkeypatch.setattr(_build, "_Job", Job)
    _build.lib("wgmma_probe")
    assert t.snapshot()["buckets"]["compile"] >= 0.1


def test_numpy_batch_iter_waits_are_data_wait_spans_as_in_jax():
    """Each batch's wait in `data.NumpyBatchIter` is a `data.wait` span
    (goodput's `data_wait`) as in the JAX package: the same epoch gives
    the same span count in both packages' `singa_span_seconds`."""
    from singa_tpu import data as jdata
    from singa_tpu_torch import data
    x = np.arange(40 * 3, dtype=np.float32).reshape(40, 3)
    y = np.arange(40, dtype=np.int32)
    got = {}
    for name, mod, obs in (("jax", jdata, jobserve), ("port", data, observe)):
        obs.get_registry().reset()
        it = mod.NumpyBatchIter(x, y, 8, shuffle=True, seed=3)
        n = sum(1 for _ in it)
        h = obs.get_registry().get("singa_span_seconds")
        got[name] = (n, h.count(span="data.wait") if h else 0)
    assert got["port"] == got["jax"] == (5, 5)
