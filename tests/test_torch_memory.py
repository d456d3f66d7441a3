"""Port parity, the live device-memory ledger: singa_tpu_torch.memory
against singa_tpu.memory, on the CPU (the port's CPU ledger enumerates
the live tensors through the garbage collector; its regions are keyed on
storages).

- On the MLP of tests/test_memory.py (fp32, SGD with momentum 0.9) the
  `params`, `opt_state`, `prefetch_ring` and `flight_snapshot` bytes
  equal JAX's exactly (both step counters are 0-d fp32); on a tiny GPT
  the engine's page pools (`kv_cache`, from its provider) and
  `generate`'s noted caches equal JAX's exactly.
- The port's regions reconcile at every snapshot, and its build count
  stays 1 with a ledger installed.
- `LeakDetector.check` gives equal verdicts on the same synthetic
  timelines; the injected leak is flagged within 20 steps and a clean
  run gives none.
- A `torch.OutOfMemoryError` raised inside the step writes a bundle that
  both packages' `load_flight_bundle` read, and propagates; successive
  bundles do not overwrite each other.
- `estimate_fit` under `SINGA_TPU_HBM_LIMIT_BYTES` gives JAX's
  ledger-side fields; `observe.record_hbm` on the CPU sets the ledger
  total.
"""

import gc
import os
import threading
import time

import numpy as np
import pytest
import torch

from singa_tpu import engine as jengine
from singa_tpu import health as jhealth
from singa_tpu import layer as jlayer
from singa_tpu import memory as jmemory
from singa_tpu import model as jmodel
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import overlap as joverlap
from singa_tpu import tensor as jtensor
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import engine as tengine
from singa_tpu_torch import (goodput, health, introspect, layer, memory,
                             model, observe)
from singa_tpu_torch import opt, overlap, resilience, watchdog
from singa_tpu_torch import tensor as ttensor
from singa_tpu_torch.models import transformer as tt

torch.set_num_threads(2)
TDEV = tdevice.create_cpu_device()
REGIONS = memory.MEM_REGIONS


@pytest.fixture(autouse=True)
def _port_state():
    """The port's ledger (its sampler thread, named like the JAX
    package's, joined before tests/conftest.py's leak check), providers,
    tracker, watchdog, engines, monitor and registry are reset around
    each test."""
    def clean():
        memory.reset()
        jmemory.reset()
        goodput.uninstall()
        watchdog.uninstall_watchdog()
        tengine.reset()
        health.set_active_monitor(None)
        resilience.clear_fault_plan()
        observe.get_registry().reset()
        observe.enable(True)
        introspect.reset()
    clean()
    yield
    clean()


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


def _data(batch=32, feat=10):
    rng = np.random.RandomState(0)
    return (rng.randn(batch, feat).astype(np.float32),
            rng.randint(0, 4, batch).astype(np.int32))


def _jbuild(mon=None, use_graph=True, momentum=0.9):
    from singa_tpu import device as jdevice
    dev = jdevice.best_device()
    X, Y = _data()
    m = JMLP()
    m.set_optimizer(jopt.SGD(lr=0.1, momentum=momentum))
    tx, ty = jtensor.from_numpy(X, dev), jtensor.from_numpy(Y, dev)
    m.compile([tx], is_train=True, use_graph=use_graph, health=mon)
    return m, tx, ty


def _tbuild(mon=None, use_graph=True, momentum=0.9):
    X, Y = _data()
    m = TMLP()
    m.set_optimizer(opt.SGD(lr=0.1, momentum=momentum))
    tx, ty = ttensor.from_numpy(X, TDEV), ttensor.from_numpy(Y, TDEV)
    m.compile([tx], is_train=True, use_graph=use_graph, health=mon)
    return m, tx, ty


def _reconciled(snap):
    assert set(snap["regions"]) == set(REGIONS)
    assert sum(snap["regions"].values()) == snap["total_bytes"]
    assert sum(snap["counts"].values()) == snap["n_arrays"]
    assert snap["regions"]["unattributed"] >= 0


# ---- region bytes against JAX ----------------------------------------------

def test_params_and_opt_state_equal_jax_and_reconcile():
    jm, jx, jy = _jbuild()
    jled = jmemory.install_ledger()
    for _ in range(3):
        jm(jx, jy)
    tm, tx, ty = _tbuild()
    tled = memory.install_ledger(device="cpu")
    for _ in range(3):
        tm(tx, ty)
    assert len(tled.timeline) == 3
    for snap in tled.timeline:
        _reconciled(snap)
    j, t = jled.timeline[-1]["regions"], tled.timeline[-1]["regions"]
    assert t["params"] == j["params"] == sum(
        p.numel() * p.element_size() for p in tm._raw_params().values()) > 0
    assert t["opt_state"] == j["opt_state"] == sum(
        a.numel() * a.element_size()
        for a in tm.optimizer.state_arrays()) > 0
    # a fresh snapshot against a direct enumeration: identical
    snap = tled.snapshot()
    assert snap["total_bytes"] == memory.total_live_bytes("cpu")
    # host-only bookkeeping: no new step signature
    assert tm._build_count == 1
    c = observe.get_registry().get("singa_model_compile_total")
    assert sum(v for _n, _k, v in c.samples()) == 1
    text = observe.to_prometheus_text()
    for region in REGIONS:
        assert f'singa_mem_region_bytes{{region="{region}"}}' in text


def test_flight_snapshot_equals_jax_with_monitor(tmp_path):
    jmon = jhealth.HealthMonitor(out_dir=str(tmp_path / "j"),
                                 snapshot_batch=True)
    jm, jx, jy = _jbuild(mon=jmon)
    jled = jmemory.install_ledger()
    for _ in range(2):
        jm(jx, jy)
    tmon = health.HealthMonitor(out_dir=str(tmp_path / "t"),
                                snapshot_batch=True)
    tm, tx, ty = _tbuild(mon=tmon)
    tled = memory.install_ledger(device="cpu")
    for _ in range(2):
        tm(tx, ty)
    j = jled.timeline[-1]["regions"]["flight_snapshot"]
    t = tled.timeline[-1]["regions"]["flight_snapshot"]
    assert t == j == tx.data.nbytes + ty.data.nbytes
    _reconciled(tled.timeline[-1])
    tm.set_health_monitor(None)     # detached: the inputs are unclaimed
    assert tled.snapshot()["regions"]["flight_snapshot"] == 0


def _ring_bytes(ovl, led, m):
    """The ring's bytes once it holds its two batches, and after close.
    The batches are distinct host arrays: each becomes its own device
    buffer in both packages (the same tensor queued twice is one storage
    to the port's ledger, but two transfers to JAX's)."""
    X, Y = _data()
    want = 2 * (X.nbytes + Y.nbytes)
    p = ovl.DevicePrefetcher(iter([(X.copy(), Y.copy()) for _ in range(4)]),
                             model=m, size=2)
    try:
        deadline = time.monotonic() + 10.0
        got = 0
        while time.monotonic() < deadline:
            got = led.snapshot()["regions"]["prefetch_ring"]
            if got >= want:
                break
            time.sleep(0.01)
    finally:
        p.close()
    return got, led.snapshot()["regions"]["prefetch_ring"], want


def test_prefetch_ring_equals_jax_and_untracks_on_close():
    jm, _, _ = _jbuild()
    jfull, jafter, want = _ring_bytes(joverlap, jmemory.install_ledger(), jm)
    tm, _, _ = _tbuild()
    tfull, tafter, _ = _ring_bytes(
        overlap, memory.install_ledger(device="cpu"), tm)
    assert tfull == jfull == want
    assert tafter == jafter == 0


SMALL = dict(vocab_size=61, max_seq=64, dim=32, num_heads=2, num_layers=2)


def _gpt_pair():
    from singa_tpu import device as jdevice
    jm = jmodels.create_model("gpt", **SMALL)
    ids = np.random.RandomState(0).randint(0, 61, (2, 6)).astype(np.int32)
    jm.compile([jtensor.from_numpy(ids, device=jdevice.best_device())],
               is_train=False, use_graph=False)
    jm.eval()
    tm = tt.GPT(**SMALL, device="cpu")
    tt.load_singa_params(
        tm, {k: jtensor.to_numpy(v) for k, v in jm.get_params().items()})
    return jm, tm


def test_kv_cache_engine_pools_and_generate_equal_jax():
    jm, tm = _gpt_pair()
    kw = dict(max_slots=3, page_size=8, steps_per_sync=2)
    jled = jmemory.install_ledger()
    tled = memory.install_ledger(device="cpu")
    prompt = np.random.RandomState(1).randint(0, 61, (2, 6))
    jm.generate(prompt, 4, temperature=0.0)
    tm.generate(prompt, 4, temperature=0.0)
    jkv = max(s["regions"]["kv_cache"] for s in jled.timeline)
    tkv = max(s["regions"]["kv_cache"] for s in tled.timeline)
    assert tkv == jkv > 0
    gc.collect()
    assert tled.snapshot()["regions"]["kv_cache"] == 0   # the notes died
    je = jengine.ServingEngine(jm, **kw).start()
    te = tengine.ServingEngine(tm, **kw).start()
    try:
        assert memory.region_has_provider("kv_cache")
        j = jled.snapshot()["regions"]["kv_cache"]
        t = tled.snapshot()
        assert t["regions"]["kv_cache"] == j == te.pool_bytes() > 0
        _reconciled(t)
        # with a ledger, the serve snapshot reads the kv_cache region
        from singa_tpu_torch import slo
        assert slo.fleet_serve_snapshot()["kv_cache_bytes"] \
            == t["regions"]["kv_cache"]
    finally:
        je.stop()
        te.stop()
    assert not memory.region_has_provider("kv_cache")


def test_engine_provider_includes_the_draft():
    tm = tt.GPT(**SMALL, device="cpu")
    draft = tt.GPT(**dict(SMALL, num_layers=1), device="cpu")
    led = memory.install_ledger(device="cpu")
    e = tengine.ServingEngine(tm, max_slots=2, page_size=8,
                              draft_model=draft, spec_k=2).start()
    try:
        snap = led.snapshot()
        assert snap["regions"]["kv_cache"] \
            == e.pool_bytes() + e.draft_pool_bytes()
        assert snap["regions"]["params"] == e.draft_param_bytes() > 0
        _reconciled(snap)
    finally:
        e.stop()


# ---- leak detection ---------------------------------------------------------

def _timeline(kind, n=30):
    rng = np.random.RandomState(len(kind))
    out = []
    base = 1 << 20
    for i in range(n):
        grow = {"flat": 0, "leak": 65536 * i, "late": 65536 * max(0, i - 12),
                "noisy": int(rng.randint(-8192, 8192)),
                "burst": 262144 * (i // 10)}[kind]
        regions = {r: 0 for r in REGIONS}
        regions["params"] = base
        regions["unattributed" if kind != "late" else "kv_cache"] = \
            max(0, grow) + 4096
        out.append({"step": i, "total_bytes": sum(regions.values()),
                    "regions": regions})
    return out


@pytest.mark.parametrize("kind", ["flat", "leak", "late", "noisy", "burst"])
def test_leak_detector_verdicts_match_jax(kind):
    tl = _timeline(kind)
    kw = dict(warmup=3, window=6, min_slope_bytes=4096.0, sustain=2)
    jd, td = jmemory.LeakDetector(**kw), memory.LeakDetector(**kw)
    jv, tv = [], []
    for i in range(1, len(tl) + 1):
        jv.append(jd.check(tl[:i], step=i))
        tv.append(td.check(tl[:i], step=i))
        assert td.slope == jd.slope
    strip = [None if v is None else {k: x for k, x in v.items() if k != "ts"}
             for v in jv]
    assert strip == [None if v is None else
                     {k: x for k, x in v.items() if k != "ts"} for v in tv]
    assert (kind in ("flat", "noisy")) == (not any(tv))


def test_injected_leak_flagged_within_20_steps_and_clean_gives_none(
        tmp_path):
    mon = health.HealthMonitor(policy="warn", out_dir=str(tmp_path))
    health.set_active_monitor(mon)
    m, tx, ty = _tbuild()
    led = memory.install_ledger(device="cpu")
    m.fit([(tx, ty)] * 12, epochs=1)
    assert led.leak.verdicts == []
    kept = []

    class LeakySrc:
        def __iter__(self):
            for i in range(24):
                kept.append(torch.full((64, 1024), float(i)))
                yield (tx, ty)

    m.fit(LeakySrc(), epochs=1)
    assert led.leak.verdicts, "leak never flagged"
    v = led.leak.verdicts[0]
    assert v["step"] - 12 <= 20
    assert v["suspect_region"] == "unattributed" and v["action"] == "warn"
    assert len(led.leak.verdicts) == 1
    reg = observe.get_registry()
    assert reg.get("singa_health_anomaly_total").value(
        kind=health.KIND_MEM_LEAK) == 1
    assert reg.get("singa_mem_leak_verdicts_total").value(
        region="unattributed") == 1
    for snap in led.timeline:
        _reconciled(snap)


# ---- OOM forensics ----------------------------------------------------------

def test_oom_in_the_step_writes_a_bundle_both_packages_load(tmp_path,
                                                            monkeypatch):
    m, tx, ty = _tbuild()
    led = memory.install_ledger(device="cpu", out_dir=str(tmp_path))
    for _ in range(2):
        m(tx, ty)
    err = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "9.99 GiB")

    def boom(*a, **k):
        raise err
    monkeypatch.setattr(m, "_run_buffered", boom)
    with pytest.raises(torch.OutOfMemoryError) as ei:
        m(tx, ty)
    assert ei.value is err
    bundles = [f for f in os.listdir(tmp_path) if f.startswith("flight_oom_")]
    assert len(bundles) == 1
    path = str(tmp_path / bundles[0])
    for load in (health.load_flight_bundle, jhealth.load_flight_bundle):
        b = load(path)
        assert b["header"]["reason"] == "oom"
        oom = b["header"]["oom"]
        assert oom["executable_key"] == "step"
        assert "out of memory" in oom["error"]
        assert sum(oom["regions"].values()) == oom["total_bytes"]
        top = oom["top_arrays"]
        assert top and top[0]["nbytes"] >= top[-1]["nbytes"]
        assert {"shape", "dtype", "region"} <= set(top[0])
        assert len(b["steps"]) == b["header"]["n_steps"] == 3
        # the bundle pins the builds made so far
        assert b["header"]["executables"] == (
            introspect.executable_manifest()[-8:] or None)
    assert observe.get_registry().get(
        "singa_mem_oom_dumps_total").value() == 1
    # every live storage is ranked (the bundle keeps the largest 16 of
    # the whole process): the parameters are there, attributed
    w = m.l1.W.data
    assert {"nbytes": w.numel() * w.element_size(), "shape": list(w.shape),
            "dtype": str(w.dtype), "region": "params"} \
        in led.top_arrays(10 ** 9)
    # an error that is not an OOM writes nothing
    monkeypatch.setattr(m, "_run_buffered", lambda *a, **k: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        m(tx, ty)
    assert len([f for f in os.listdir(tmp_path)
                if f.startswith("flight_oom_")]) == 1
    assert led is memory.get_ledger()


def test_oom_in_the_eager_step_and_at_serving_sites(tmp_path, monkeypatch):
    m, tx, ty = _tbuild(use_graph=False)
    memory.install_ledger(device="cpu", out_dir=str(tmp_path))

    def boom(*a, **k):
        raise torch.OutOfMemoryError("out of memory")
    monkeypatch.setattr(m.l1, "forward", boom)
    with pytest.raises(torch.OutOfMemoryError):
        m(tx, ty)
    g = tt.GPT(**SMALL, device="cpu")
    from singa_tpu_torch import serving
    monkeypatch.setattr(serving._DecodeCore, "token_step", boom)
    with pytest.raises(torch.OutOfMemoryError):
        g.generate(np.zeros((1, 4), np.int64), 3)
    keys = sorted(health.load_flight_bundle(str(tmp_path / f))["header"][
        "oom"]["executable_key"] for f in os.listdir(tmp_path)
        if f.startswith("flight_oom_"))
    assert keys == ["serving.decode_scan", "step"]


def test_successive_oom_bundles_do_not_overwrite(tmp_path):
    memory.install_ledger(device="cpu", out_dir=str(tmp_path))
    err = torch.OutOfMemoryError("out of memory")
    p1 = memory.dump_oom_bundle(exc=err, key="serving.prefill")
    p2 = memory.dump_oom_bundle(exc=err, key="serving.prefill")
    assert p1 != p2 and os.path.isfile(p1) and os.path.isfile(p2)
    assert jhealth.load_flight_bundle(p2)["header"]["reason"] == "oom"
    assert memory.is_resource_exhausted(err)
    assert memory.is_resource_exhausted(torch.cuda.OutOfMemoryError("x"))
    assert not memory.is_resource_exhausted(RuntimeError("out of memory"))
    assert memory.handle_oom(RuntimeError("x")) is None


def test_oom_bundle_defaults_to_flight_recorder_dir(tmp_path):
    flights = tmp_path / "flights"
    health.set_active_monitor(health.HealthMonitor(out_dir=str(flights)))
    memory.install_ledger(device="cpu")
    path = memory.dump_oom_bundle(exc=torch.OutOfMemoryError("x"),
                                  key="step")
    assert os.path.dirname(path) == str(flights)


# ---- fit, record_hbm, lifecycle ---------------------------------------------

def test_estimate_fit_ledger_side_fields_equal_jax(monkeypatch):
    jm, jx, jy = _jbuild(use_graph=False)
    tm, tx, ty = _tbuild(use_graph=False)
    keys = ("params_bytes", "opt_state_bytes", "batch_bytes",
            "estimated_peak_bytes", "limit_bytes", "fits", "headroom_frac",
            "source", "exec_arguments_bytes", "exec_temps_bytes")
    for limit in (None, "1000000000", "1024"):
        if limit is None:
            monkeypatch.delenv("SINGA_TPU_HBM_LIMIT_BYTES", raising=False)
        else:
            monkeypatch.setenv("SINGA_TPU_HBM_LIMIT_BYTES", limit)
        j = jmemory.estimate_fit(model=jm, batch=(jx, jy))
        t = memory.estimate_fit(model=tm, batch=(tx, ty))
        assert {k: t[k] for k in keys} == {k: j[k] for k in keys}, limit
    assert t["source"] == "ledger" and t["fits"] is False


def test_record_hbm_on_the_cpu_sets_the_ledger_total():
    m, tx, ty = _tbuild()
    led = memory.install_ledger(device="cpu")
    m(tx, ty)
    assert memory.hbm_fallback_bytes() == led.timeline[-1]["total_bytes"] > 0
    observe.record_hbm(TDEV)
    g = observe.get_registry().get("singa_hbm_bytes_in_use")
    assert g.value() == led.timeline[-1]["total_bytes"]


def test_note_arrays_transient_and_unknown_region():
    led = memory.install_ledger(device="cpu")
    arrs = [torch.zeros(4, 64)]
    assert memory.note_arrays("kv_cache", arrs + [arrs[0][:2]]) == 2
    assert led.snapshot()["regions"]["kv_cache"] == 4 * 64 * 4  # one storage
    del arrs
    gc.collect()
    assert led.snapshot()["regions"]["kv_cache"] == 0
    with pytest.raises(ValueError):
        memory.register_provider("heap", object(), lambda: ())
    with pytest.raises(ValueError):
        memory.note_arrays("heap", [])


def test_sampler_lifecycle_reset_and_dead_providers():
    led = memory.install_ledger(device="cpu", sample_interval_s=0.02)
    assert memory.install_ledger() is led
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not led.timeline:
        time.sleep(0.01)
    assert led.timeline
    assert "singa-mem-sampler" in [t.name for t in threading.enumerate()]
    memory.uninstall_ledger()
    assert "singa-mem-sampler" not in [
        t.name for t in threading.enumerate() if t.is_alive()]
    raw = memory.MemoryLedger(sample_interval_s=0.02, device="cpu")
    memory.reset()
    assert not any(t.name == "singa-mem-sampler" and t.is_alive()
                   for t in threading.enumerate())
    assert raw.timeline is not None
    m, tx, ty = _tbuild()
    m(tx, ty)
    with memory._lock:
        assert len(memory._providers) >= 3
    del m
    gc.collect()
    with memory._lock:
        assert len(memory._providers) == 0


def test_memz_report_and_json():
    assert "no MemoryLedger installed" in memory.memz_report()
    m, tx, ty = _tbuild()
    memory.install_ledger(device="cpu")
    for _ in range(2):
        m(tx, ty)
    rep = memory.memz_report()
    assert "== memory ==" in rep and "(OK)" in rep and "leak: slope" in rep
    for region in REGIONS:
        assert region in rep
    j = memory.memz_json()
    assert j["installed"] and sum(j["regions"].values()) == j["total_bytes"]
    # the static view is the step build's memory record
    assert j["timeline"] and j["top_arrays"]
    assert j["static_hbm"] == introspect.last_build("step")["memory"]
    assert j["static_hbm"]["arguments"] > 0
    assert "static estimate (introspect, step build)" in rep


def test_ledger_defaults_to_the_card():
    """Entry points run on the card unless asked for the CPU: with no
    CUDA, a ledger with no device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        memory.MemoryLedger()
