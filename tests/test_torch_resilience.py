"""Port parity, the supervised training loop: singa_tpu_torch.resilience
against singa_tpu.resilience on the CPU (tests/test_resilience.py's
cases; the kill-and-resume onto a smaller mesh, across gloo ranks, is in
test_torch_dist_dryrun.py).

- Manifests: build, atomic write, read, validation, discovery, retention
  and set-aside, held against the JAX package on the same directories; a
  manifest each package writes passes the other's `read_manifest` and
  `validate_manifest` for the same model.
- `Model.save_checkpoint`'s reclamation and `load_checkpoint(validate=)`.
- The controller on the MLP of tests/test_resilience.py (8 -> 16 -> 4,
  SGD lr 0.1 momentum 0.9, batch 16), the port's weights carried over
  from the JAX model: under the same FaultPlan (a transient save
  failure, a mid-epoch restart, a restart right after an async save, a
  stale manifested checkpoint set aside, a preemption by a real SIGTERM
  and its resume, a health halt, a kill across an epoch), both packages
  end with the same report fields, histories equal at rtol 1e-5 and the
  same `resilience` events in the same order.
- Retry backoff: equal jittered sleeps under one `retry_seed`, the
  exponential schedule, the total-elapsed cap.
- A watchdog `HangError` in a step restarts from the latest checkpoint
  and `clear_hang` retires the verdict, in both packages.
- The CLI's kill-and-resume A/B on one device (`--ab`) ends ok.
"""

import json
import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import health as jhealth
from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu import observe as jobserve
from singa_tpu import opt as jopt
from singa_tpu import overlap as joverlap
from singa_tpu import resilience as jres
from singa_tpu import tensor as jtensor
from singa_tpu import watchdog as jwatchdog
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import (health, introspect, layer, memory, model,
                             observe, opt, overlap, resilience, watchdog)
from singa_tpu_torch import tensor as ttensor

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TDEV = tdevice.create_cpu_device()
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _port_state():
    """Both packages' fault plans and watchdogs, and the port's registry,
    introspect state and ledger, reset around each test
    (tests/conftest.py resets only the JAX package's registry)."""
    def clean():
        resilience.clear_fault_plan()
        jres.clear_fault_plan()
        watchdog.uninstall_watchdog()
        jwatchdog.uninstall_watchdog()
        health.set_active_monitor(None)
        memory.reset()
        introspect.reset()
        observe.get_registry().reset()
        observe.enable(True)
    clean()
    yield
    overlap.wait_for_checkpoints()
    clean()


class JNet(jmodel.Model):
    def __init__(self):
        super().__init__()
        self.fc1 = jlayer.Linear(16)
        self.relu = jlayer.ReLU()
        self.fc2 = jlayer.Linear(4)
        self.sce = jlayer.SoftMaxCrossEntropy()

    def forward(self, x):
        return self.fc2(self.relu(self.fc1(x)))

    def train_one_batch(self, x, y):
        loss = self.sce(self.forward(x), y)
        self.optimizer(loss)
        return loss


class TNet(model.Model):
    def __init__(self):
        super().__init__()
        self.fc1 = layer.Linear(16)
        self.relu = layer.ReLU()
        self.fc2 = layer.Linear(4)
        self.sce = layer.SoftMaxCrossEntropy()

    def forward(self, x):
        return self.fc2(self.relu(self.fc1(x)))

    def train_one_batch(self, x, y):
        loss = self.sce(self.forward(x), y)
        self.optimizer(loss)
        return loss


def _data(seed=7):
    rng = np.random.RandomState(seed)
    return (rng.randn(16, 8).astype(np.float32),
            rng.randint(0, 4, 16).astype(np.int32))


PKGS = {
    "jax": types.SimpleNamespace(res=jres, overlap=joverlap, obs=jobserve,
                                 health=jhealth, wd=jwatchdog,
                                 tensor=jtensor),
    "port": types.SimpleNamespace(res=resilience, overlap=overlap,
                                  obs=observe, health=health, wd=watchdog,
                                  tensor=ttensor),
}


def _build(pkg, seed=7, monitor=None):
    """The package's Net on one device, compiled in graph mode, with the
    JAX Net's weights for `seed` (the port's copied from a JAX build);
    returns (model, tx, ty, device)."""
    import jax
    jdev = jdevice.get_default_device()
    jdev.rng_state = jax.random.key(seed)
    X, Y = _data(seed)
    jm = JNet()
    jm.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9))
    jm.compile([jtensor.from_numpy(X, jdev)], is_train=True,
               use_graph=True, health=monitor if pkg == "jax" else None)
    if pkg == "jax":
        return (jm, jtensor.from_numpy(X, jdev),
                jtensor.from_numpy(Y, jdev), jdev)
    tm = TNet()
    tm.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    tm.compile([ttensor.from_numpy(X, TDEV)], is_train=True, use_graph=True,
               health=monitor)
    for k, v in jm.get_params().items():
        tm.get_params()[k].copy_from_numpy(jtensor.to_numpy(v))
    return tm, ttensor.from_numpy(X, TDEV), ttensor.from_numpy(Y, TDEV), TDEV


def _events(p):
    return [r["event"] for r in p.obs.get_registry().recent
            if r.get("kind") == "resilience"]


def _both(scenario):
    """Run `scenario(pkg, p)` for each package; returns {pkg: (result,
    resilience events)}."""
    out = {}
    for pkg, p in PKGS.items():
        res = scenario(pkg, p)
        p.overlap.wait_for_checkpoints()
        out[pkg] = (res, _events(p))
        p.res.clear_fault_plan()
    return out


def _same_reports(got, fields=("status", "resumed_step", "final_step",
                               "steps_run", "restarts")):
    (j, je), (t, te) = got["jax"], got["port"]
    assert {k: t[k] for k in fields} == {k: j[k] for k in fields}
    jh, th = dict(j["history"]), dict(t["history"])
    assert sorted(th) == sorted(jh)
    np.testing.assert_allclose([th[k] for k in sorted(th)],
                               [jh[k] for k in sorted(jh)], rtol=RTOL)
    assert te == je
    return t


def _ref(steps=8):
    """The port's uninterrupted run (equal to JAX's, as the controller
    tests show)."""
    m, tx, ty, _ = _build("port")
    return [float(m(tx, ty).numpy()) for _ in range(steps)]


# ---- manifests -------------------------------------------------------------

def test_manifest_roundtrip_and_cross_package_validation(tmp_path):
    jm, *_ = _build("jax")
    tm, *_ = _build("port")
    for name, m, mod in (("j", jm, jres), ("t", tm, resilience)):
        d = tmp_path / name / "step_4"
        d.mkdir(parents=True)
        man = mod.build_manifest(m, step=4, status="ok")
        path = mod.write_manifest(str(d), man)
        assert path == mod.manifest_path(str(d))
        assert not os.path.exists(path + ".tmp")
        assert mod.is_complete_checkpoint(str(d))
    tman = resilience.read_manifest(str(tmp_path / "t" / "step_4"))
    jman = jres.read_manifest(str(tmp_path / "j" / "step_4"))
    assert tman["params"] == jman["params"]
    assert tman["params"]["fc1.W"] == {"shape": [8, 16], "dtype": "float32"}
    assert tman["n_opt_slots"] == len(tm.optimizer.state_arrays())
    assert tman["mesh"] == {"axes": None, "n_devices": 1, "n_processes": 1,
                            "process_index": 0}
    assert tman["warm_store"] is None and tman["status"] == "ok"
    assert set(tman) == set(jman)
    # each package's manifest passes the other's reader and validator
    assert jres.read_manifest(str(tmp_path / "t" / "step_4")) == tman
    assert resilience.read_manifest(str(tmp_path / "j" / "step_4")) == jman
    assert jres.validate_manifest(tman, jm) == []
    assert resilience.validate_manifest(jman, tm) == []


def test_manifest_carries_the_build_fingerprints(tmp_path):
    m, tx, ty, _ = _build("port")
    m(tx, ty)
    man = resilience.build_manifest(m, step=1)
    assert man["hlo_fingerprints"] == [
        {"key": "step", "fingerprint": introspect.latest_fingerprint("step")}]


def test_read_manifest_rejects_garbage(tmp_path):
    d = tmp_path / "step_1"
    d.mkdir()
    mp = resilience.manifest_path(str(d))
    cases = [None, "{not json", json.dumps({"kind": "x", "step": 1}),
             json.dumps({"kind": "singa_ckpt_manifest", "step": "x"})]
    for body in cases:
        if body is not None:
            with open(mp, "w") as f:
                f.write(body)
        assert resilience.read_manifest(str(d)) is None
        assert jres.read_manifest(str(d)) is None
    assert not resilience.is_complete_checkpoint(str(d))


def test_validate_manifest_catches_param_mismatch():
    tm, *_ = _build("port")
    jm, *_ = _build("jax")
    man = resilience.build_manifest(tm, step=1)
    bad = json.loads(json.dumps(man))
    bad["params"]["fc1.W"]["shape"] = [8, 99]
    bad2 = json.loads(json.dumps(man))
    del bad2["params"]["fc2.b"]
    bad2["params"]["ghost.W"] = {"shape": [1], "dtype": "float32"}
    bad3 = json.loads(json.dumps(man))
    bad3["mesh"]["n_devices"] = 1024
    for b in (man, bad, bad2, bad3):
        assert resilience.validate_manifest(b, tm) == \
            jres.validate_manifest(b, jm)
    assert len(resilience.validate_manifest(bad, tm)) == 1
    assert any("ghost.W" in p for p in resilience.validate_manifest(bad2, tm))
    assert resilience.validate_manifest(bad3, tm) == []


def _mk_complete(ckpt_dir, step, mod=resilience):
    d = os.path.join(str(ckpt_dir), f"step_{step}")
    os.makedirs(d)
    mod.write_manifest(d, {"kind": "singa_ckpt_manifest", "version": 1,
                           "step": int(step)})
    return d


def test_discovery_and_retention_match_jax(tmp_path):
    for name in ("j", "t"):
        root = tmp_path / name
        root.mkdir()
        for s in (1, 2, 3, 4, 5):
            _mk_complete(root, s)
        (root / "step_7").mkdir()                      # half-written
        (root / "step_9").mkdir()                      # corrupt manifest
        with open(resilience.manifest_path(str(root / "step_9")), "w") as f:
            f.write("{broken")
    got = {}
    for name, mod in (("j", jres), ("t", resilience)):
        root = str(tmp_path / name)
        allc = [(s, m is None) for s, _p, m in
                mod.list_checkpoints(root, complete_only=False)]
        latest = mod.latest_checkpoint(root)
        removed = [os.path.basename(p) for p in mod.keep_last_k(root, 2)]
        left = [s for s, _p, _m in mod.list_checkpoints(root)]
        got[name] = (allc, os.path.basename(latest[0]), removed, left,
                     os.path.isdir(os.path.join(root, "step_7")),
                     mod.keep_last_k(root, 0), mod.keep_last_k(root, 5))
    assert got["t"] == got["j"]
    assert got["t"][:4] == ([(1, False), (2, False), (3, False),
                             (4, False), (5, False), (7, True), (9, True)],
                            "step_5", ["step_1", "step_2", "step_3"],
                            [4, 5])


def test_set_aside_checkpoints_bounded(tmp_path):
    base = str(tmp_path / "step_0")
    for i in range(6):
        os.makedirs(base)
        with open(os.path.join(base, "x"), "w") as f:
            f.write(str(i))
        os.utime(base, (1000 + i, 1000 + i))
        resilience.set_aside_checkpoint(base, ".reclaimed")
    aside = [n for n in os.listdir(tmp_path)
             if n.startswith("step_0.reclaimed")]
    assert len(aside) == 3
    assert {open(tmp_path / n / "x").read() for n in aside} == \
        {"3", "4", "5"}


# ---- save_checkpoint / load_checkpoint --------------------------------------

def test_half_written_step_overwritable_by_default(tmp_path):
    m, tx, ty, _ = _build("port")
    m(tx, ty)
    stale = tmp_path / "ck" / "step_0"
    stale.mkdir(parents=True)
    (stale / "junk").write_text("half-written")
    path = m.save_checkpoint(str(tmp_path / "ck"), step=0)
    overlap.wait_for_checkpoints()
    assert not (stale / "junk").exists()
    assert (tmp_path / "ck" / "step_0.reclaimed" / "junk").exists()
    m2, *_ = _build("port", seed=9)
    m2.load_checkpoint(path)
    for k, v in m._raw_params().items():
        assert torch.equal(v, m2._raw_params()[k]), k


def test_complete_step_still_raises_without_overwrite(tmp_path):
    m, tx, ty, _ = _build("port")
    m(tx, ty)
    path = m.save_checkpoint(str(tmp_path / "ck"), step=0)
    overlap.wait_for_checkpoints()
    resilience.write_manifest(path, resilience.build_manifest(m, 0))
    with pytest.raises(ValueError):
        m.save_checkpoint(str(tmp_path / "ck"), step=0)
    m.save_checkpoint(str(tmp_path / "ck"), step=0, overwrite=True)
    overlap.wait_for_checkpoints()
    assert not resilience.is_complete_checkpoint(path)


def test_load_checkpoint_validates_against_manifest(tmp_path):
    m, tx, ty, _ = _build("port")
    m(tx, ty)
    path = m.save_checkpoint(str(tmp_path / "ck"), step=1)
    overlap.wait_for_checkpoints()
    man = resilience.build_manifest(m, 1)
    man["params"]["fc1.W"]["shape"] = [8, 99]
    resilience.write_manifest(path, man)
    m2, *_ = _build("port", seed=9)
    before = {k: v.clone() for k, v in m2._raw_params().items()}
    with pytest.raises(ValueError, match="does not fit.*fc1.W"):
        m2.load_checkpoint(path)
    for k, v in m2._raw_params().items():
        assert torch.equal(v, before[k]), k    # nothing restored
    m2.load_checkpoint(path, validate=False)
    # another device count restores, with the reshard event
    man["params"]["fc1.W"]["shape"] = [8, 16]
    man["mesh"]["n_devices"] = 8
    resilience.write_manifest(path, man)
    m2.load_checkpoint(path)
    ev = [r for r in observe.get_registry().recent
          if r.get("event") == "reshard_restore"]
    assert ev and ev[-1]["saved_devices"] == 8 \
        and ev[-1]["live_devices"] == 1


# ---- the controller, against JAX --------------------------------------------

def test_retry_after_transient_save_failure(tmp_path):
    def run(pkg, p):
        m, tx, ty, _ = _build(pkg)
        plan = p.res.install_fault_plan(
            p.res.FaultPlan().fail("ckpt.save", times=2))
        rep = p.res.TrainController(
            m, str(tmp_path / pkg), save_every_steps=2, retries=3,
            backoff_s=0.01, retry_seed=5, handle_signals=False).fit(
            [(tx, ty)] * 3, epochs=1)
        assert [k for _pt, _n, k in plan.fired] == ["fail", "fail"]
        reg = p.obs.get_registry()
        assert reg.get("singa_resilience_retries_total").value() == 2
        _path, man = p.res.latest_checkpoint(str(tmp_path / pkg))
        assert man["step"] == 3
        return rep
    rep = _same_reports(_both(run))
    assert rep["status"] == "completed"


def test_failed_async_save_never_manifested_complete(tmp_path):
    def run(pkg, p):
        m, tx, ty, _ = _build(pkg)
        p.res.install_fault_plan(p.res.FaultPlan().fail("ckpt.wait",
                                                        times=1))
        rep = p.res.TrainController(
            m, str(tmp_path / pkg), save_every_steps=2, retries=2,
            backoff_s=0.01, handle_signals=False).fit([(tx, ty)] * 6,
                                                      epochs=1)
        s2 = tmp_path / pkg / "step_2"
        assert s2.is_dir() and not p.res.is_complete_checkpoint(str(s2))
        assert [s for s, _p, _m in
                p.res.list_checkpoints(str(tmp_path / pkg))] == [4, 6]
        assert p.obs.get_registry().get(
            "singa_resilience_retries_total").value() == 0
        return rep
    _same_reports(_both(run))


def test_manifest_survives_error_drained_by_another_barrier(tmp_path):
    ck = str(tmp_path / "ck")
    m, *_ = _build("port")
    ctrl = resilience.TrainController(m, ck, handle_signals=False)
    ctrl._step = 1
    ctrl._save()
    assert ctrl._pending_manifest is not None
    resilience.install_fault_plan(resilience.FaultPlan().fail("ckpt.wait"))
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        overlap.wait_for_checkpoints()
    resilience.clear_fault_plan()
    assert overlap.write_failed(os.path.join(ck, "step_1"))
    ctrl._settle_pending()
    assert ctrl._pending_manifest is None
    assert resilience.list_checkpoints(ck) == []
    ctrl._last_saved_step = -1
    ctrl._save(final=True)
    _path, man = resilience.latest_checkpoint(ck)
    assert man["step"] == 1


def test_foreign_barrier_failure_does_not_drop_own_manifest(tmp_path):
    ck = str(tmp_path / "ck")
    m, *_ = _build("port")
    ctrl = resilience.TrainController(m, ck, handle_signals=False)
    ctrl._step = 1
    ctrl._save()
    other = str(tmp_path / "other")
    overlap.start_async_save(other, lambda: None)
    resilience.install_fault_plan(
        resilience.FaultPlan().fail("ckpt.wait", nth=2))
    ctrl._settle_pending()
    resilience.clear_fault_plan()
    assert ctrl._pending_manifest is None
    assert overlap.write_failed(other)
    assert not overlap.write_failed(os.path.join(ck, "step_1"))
    _path, man = resilience.latest_checkpoint(ck)
    assert man["step"] == 1


def test_preempt_at_already_saved_step_keeps_terminal_status(tmp_path):
    def run(pkg, p):
        m, tx, ty, _ = _build(pkg)
        p.res.install_fault_plan(p.res.FaultPlan().send_signal(
            "step", signal.SIGTERM, step=3))
        rep = p.res.TrainController(
            m, str(tmp_path / pkg), save_every_steps=1,
            handle_signals=True).fit([(tx, ty)] * 8, epochs=1)
        _path, man = p.res.latest_checkpoint(str(tmp_path / pkg))
        assert man["step"] == 3 and man["status"] == "preempt"
        return rep
    rep = _same_reports(_both(run))
    assert rep["status"] == "preempted" and rep["final_step"] == 3


def test_save_retries_exhausted_raises(tmp_path):
    m, tx, ty, _ = _build("port")
    resilience.install_fault_plan(
        resilience.FaultPlan().fail("ckpt.save", times=10))
    ctrl = resilience.TrainController(
        m, str(tmp_path / "ck"), save_every_steps=1, retries=2,
        backoff_s=0.01, max_restarts=0, handle_signals=False)
    with pytest.raises(RuntimeError, match="injected fault"):
        ctrl.fit([(tx, ty)] * 2, epochs=1)
    assert ctrl._status == "failed"


def test_in_process_restart_after_midepoch_raise(tmp_path):
    def run(pkg, p):
        m, tx, ty, _ = _build(pkg)
        p.res.install_fault_plan(p.res.FaultPlan().fail("step", step=5))
        return p.res.TrainController(
            m, str(tmp_path / pkg), save_every_steps=2, max_restarts=1,
            handle_signals=False).fit([(tx, ty)] * 8, epochs=1)
    rep = _same_reports(_both(run))
    assert rep["status"] == "completed" and rep["restarts"] == 1
    assert observe.get_registry().get(
        "singa_resilience_restarts_total").value() == 1
    got = dict(rep["history"])
    np.testing.assert_allclose([got[k] for k in range(8)], _ref(8),
                               rtol=RTOL)


def test_restart_sees_pending_async_save(tmp_path):
    def run(pkg, p):
        m, tx, ty, _ = _build(pkg)
        p.res.install_fault_plan(p.res.FaultPlan().fail("step", step=4))
        return p.res.TrainController(
            m, str(tmp_path / pkg), save_every_steps=3, max_restarts=1,
            handle_signals=False).fit([(tx, ty)] * 6, epochs=1)
    rep = _same_reports(_both(run))
    assert rep["restarts"] == 1 and rep["resumed_step"] == 3


def test_stale_manifested_checkpoint_set_aside_not_deleted(tmp_path):
    def run(pkg, p):
        ck = str(tmp_path / pkg)
        m, tx, ty, _ = _build(pkg)
        p.res.TrainController(m, ck, save_every_steps=2,
                              handle_signals=False).fit([(tx, ty)] * 4,
                                                        epochs=1)
        p.overlap.wait_for_checkpoints()
        bad = tmp_path / pkg / "step_9"
        bad.mkdir()
        p.res.write_manifest(str(bad), p.res.build_manifest(m, step=9))
        m2, tx, ty, _ = _build(pkg, seed=9)
        rep = p.res.TrainController(
            m2, ck, save_every_steps=2, retries=1, backoff_s=0.01,
            retry_seed=3, handle_signals=False).fit([(tx, ty)] * 6,
                                                    epochs=1)
        assert not bad.exists()
        aside = tmp_path / pkg / "step_9.stale"
        assert aside.is_dir()
        with open(str(aside) + p.res.MANIFEST_SUFFIX) as f:
            assert json.load(f)["step"] == 9
        return rep
    rep = _same_reports(_both(run))
    assert rep["resumed_step"] == 4


def test_restart_budget_exhausted_reraises(tmp_path):
    m, tx, ty, _ = _build("port")
    resilience.install_fault_plan(
        resilience.FaultPlan().fail("step", step=2, times=5))
    ctrl = resilience.TrainController(
        m, str(tmp_path / "ck"), save_every_steps=1, max_restarts=1,
        handle_signals=False)
    with pytest.raises(RuntimeError, match="injected fault"):
        ctrl.fit([(tx, ty)] * 4, epochs=1)
    assert observe.get_registry().get(
        "singa_resilience_restarts_total").value() == 1


def test_preemption_signal_saves_and_resumes(tmp_path):
    def run(pkg, p):
        ck = str(tmp_path / pkg)
        prev = signal.getsignal(signal.SIGTERM)
        m, tx, ty, _ = _build(pkg)
        p.res.install_fault_plan(p.res.FaultPlan().send_signal(
            "step", signal.SIGTERM, step=3))
        r1 = p.res.TrainController(m, ck, save_every_steps=10,
                                   handle_signals=True).fit(
            [(tx, ty)] * 8, epochs=1)
        assert signal.getsignal(signal.SIGTERM) is prev
        _path, man = p.res.latest_checkpoint(ck)
        assert man["step"] == 3 and man["status"] == "preempt"
        p.res.clear_fault_plan()
        m2, tx, ty, _ = _build(pkg)
        r2 = p.res.TrainController(m2, ck, save_every_steps=10,
                                   handle_signals=False).fit(
            [(tx, ty)] * 8, epochs=1)
        return dict(r2, history=r1["history"] + r2["history"],
                    first=(r1["status"], r1["final_step"]))
    got = _both(run)
    rep = _same_reports(got)
    assert rep["first"] == got["jax"][0]["first"] == ("preempted", 3)
    assert rep["status"] == "completed" and rep["resumed_step"] == 3
    got = dict(rep["history"])
    np.testing.assert_allclose([got[k] for k in range(8)], _ref(8),
                               rtol=RTOL)
    assert observe.get_registry().get(
        "singa_resilience_preempt_total").value() == 1


def test_fit_rejects_one_shot_iterator(tmp_path):
    m, tx, ty, _ = _build("port")
    ctrl = resilience.TrainController(m, str(tmp_path / "ck"),
                                      handle_signals=False)
    with pytest.raises(ValueError, match="re-iterable"):
        ctrl.fit((b for b in [(tx, ty)] * 4), epochs=1)


def test_fit_reentry_after_preemption_trains(tmp_path):
    m, tx, ty, _ = _build("port")
    resilience.install_fault_plan(resilience.FaultPlan().send_signal(
        "step", signal.SIGTERM, step=3))
    ctrl = resilience.TrainController(
        m, str(tmp_path / "ck"), save_every_steps=2, handle_signals=True)
    r1 = ctrl.fit([(tx, ty)] * 6, epochs=1)
    assert r1["status"] == "preempted" and r1["final_step"] == 3
    resilience.clear_fault_plan()
    r2 = ctrl.fit([(tx, ty)] * 6, epochs=1)
    assert r2["status"] == "completed" and r2["final_step"] == 6


def test_halt_flows_into_save_then_stop(tmp_path):
    X, _ = _data()
    Xn = X.copy()
    Xn[0, 0] = np.nan

    def run(pkg, p):
        mon = p.health.HealthMonitor(policy="halt",
                                     out_dir=str(tmp_path / f"b{pkg}"))
        m, tx, ty, dev = _build(pkg, monitor=mon)
        tnan = p.tensor.from_numpy(Xn, dev)
        data = [(tx, ty)] * 3 + [(tnan, ty)] + [(tx, ty)] * 2
        ctrl = p.res.TrainController(m, str(tmp_path / pkg),
                                     save_every_steps=2,
                                     handle_signals=False)
        with pytest.raises(p.health.HealthError) as ei:
            ctrl.fit(data, epochs=1)
        e = ei.value
        assert e.bundle_path and os.path.exists(e.bundle_path)
        _path, man = p.res.latest_checkpoint(str(tmp_path / pkg))
        assert man["step"] == 3 and man["status"] == "halt"
        assert p.overlap.pending_checkpoints() == 0
        if pkg == "port":
            m.set_health_monitor(None)
        return e.resilience
    rep = _same_reports(_both(run))
    assert rep["status"] == "halted" and rep["final_step"] == 3


def test_retention_prunes_during_run(tmp_path):
    m, tx, ty, _ = _build("port")
    rep = resilience.TrainController(
        m, str(tmp_path / "ck"), save_every_steps=1, keep=2,
        handle_signals=False).fit([(tx, ty)] * 6, epochs=1)
    assert rep["status"] == "completed"
    left = resilience.list_checkpoints(str(tmp_path / "ck"))
    assert len(left) == 2 and left[-1][0] == 6


def test_resilience_report(tmp_path):
    m, tx, ty, _ = _build("port")
    rep = resilience.fit_resilient(m, [(tx, ty)] * 2, str(tmp_path / "ck"),
                                   save_every_steps=2, handle_signals=False)
    assert rep["status"] == "completed"
    assert resilience.active_controller().ckpt_dir == str(tmp_path / "ck")
    text = resilience.resilience_report()
    assert "== resilience ==" in text and "resumed_from=0" in text
    assert "status=completed" in text and "saves=1" in text


def test_resume_across_epoch_boundary(tmp_path):
    def run(pkg, p):
        ck = str(tmp_path / pkg)
        m, tx, ty, _ = _build(pkg)
        p.res.install_fault_plan(p.res.FaultPlan().fail("step", step=6))
        with pytest.raises(RuntimeError):
            p.res.TrainController(m, ck, save_every_steps=2, max_restarts=0,
                                  handle_signals=False).fit(
                [(tx, ty)] * 4, epochs=2)
        p.res.clear_fault_plan()
        p.overlap.wait_for_checkpoints()
        m2, tx, ty, _ = _build(pkg)
        return p.res.TrainController(m2, ck, save_every_steps=2,
                                     handle_signals=False).fit(
            [(tx, ty)] * 4, epochs=2)
    rep = _same_reports(_both(run))
    assert rep["resumed_step"] == 4
    got = dict(rep["history"])
    np.testing.assert_allclose([got[k] for k in sorted(got)], _ref(8)[4:],
                               rtol=RTOL)


def test_hang_restart_clears_the_verdict(tmp_path):
    """A step stalled past the watchdog's abort threshold raises HangError
    at the step guard's exit; the controller restores the latest
    checkpoint, replays, clears the hang verdict and completes."""
    def run(pkg, p):
        m, tx, ty, _ = _build(pkg)
        p.wd.install_watchdog(deadlines={"step": 0.15}, action="abort",
                              dump_at=1.5, abort_at=2.0, hard_at=100.0,
                              poll_interval_s=0.005,
                              out_dir=str(tmp_path / f"w{pkg}"))
        p.res.install_fault_plan(p.res.FaultPlan().delay("step", 0.5,
                                                         step=5))
        try:
            rep = p.res.TrainController(
                m, str(tmp_path / pkg), save_every_steps=4, max_restarts=1,
                handle_signals=False).fit([(tx, ty)] * 8, epochs=1)
            assert p.wd.hang_report() is None
        finally:
            p.wd.uninstall_watchdog()
        return rep
    got = _both(run)
    rep = _same_reports(got)
    assert rep["status"] == "completed" and rep["restarts"] == 1
    assert "hang_restart" in got["port"][1]
    got = dict(rep["history"])
    np.testing.assert_allclose([got[k] for k in range(8)], _ref(8),
                               rtol=RTOL)


# ---- retry backoff ----------------------------------------------------------

def _sleeps(mod, monkeypatch, seed, fails=3, **kw):
    ctrl = mod.TrainController(None, "/nonexistent", retry_seed=seed,
                               handle_signals=False, **kw)
    sleeps = []
    monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(s))
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] <= fails:
            raise OSError("transient")
        return "ok"
    assert ctrl._retry("save", flaky) == "ok"
    return sleeps


def test_retry_jitter_sleeps_equal_jax(monkeypatch):
    kw = dict(retries=5, backoff_s=0.01, backoff_max_s=0.5)
    a = _sleeps(jres, monkeypatch, 1234, **kw)
    b = _sleeps(resilience, monkeypatch, 1234, **kw)
    c = _sleeps(resilience, monkeypatch, 99, **kw)
    assert b == a and len(b) == 3 and len({round(s, 9) for s in b}) > 1
    prev = 0.01
    for s in b:
        assert 0.01 <= s <= min(0.5, max(0.01, prev * 3.0)) + 1e-9
        prev = s
    assert c != b
    reg = observe.get_registry()
    assert reg.get("singa_resilience_retry_seconds_total").value() == \
        pytest.approx(sum(b) + sum(c))
    assert reg.get("singa_resilience_retries_total").value() == 6


def test_retry_jitter_off_keeps_exponential_schedule(monkeypatch):
    ctrl = resilience.TrainController(
        None, "/nonexistent", retries=3, backoff_s=0.01, backoff_mult=2.0,
        retry_jitter=False, handle_signals=False)
    sleeps = []
    monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(s))

    def always_fails():
        raise OSError("down")
    with pytest.raises(OSError):
        ctrl._retry("save", always_fails)
    assert sleeps == pytest.approx([0.01, 0.02, 0.04])


def test_retry_total_elapsed_cap():
    ctrl = resilience.TrainController(
        None, "/nonexistent", retries=1000, backoff_s=0.02,
        retry_jitter=False, max_elapsed_s=0.1, handle_signals=False)
    calls = [0]

    def always_fails():
        calls[0] += 1
        raise OSError("down")
    t0 = time.monotonic()
    with pytest.raises(OSError):
        ctrl._retry("save", always_fails)
    assert time.monotonic() - t0 < 2.0
    assert 1 < calls[0] < 20
    assert any(r.get("event") == "retry_exhausted"
               for r in observe.get_registry().recent)


# ---- the CLI ----------------------------------------------------------------

def test_kill_and_resume_ab_cli(tmp_path):
    out = str(tmp_path / "ab.json")
    r = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.resilience", "--ab",
         "--devices-a", "1", "--devices-b", "1", "--device", "cpu",
         "--steps", "12", "--save-every", "3", "--out", out],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    with open(out) as f:
        rec = json.load(f)
    assert rec["ok"] is True
    assert rec["killed_status"] == "preempted"
    assert rec["resumed_status"] == "completed"
    assert rec["resumed_step"] > 0
    assert rec["max_abs_loss_delta"] < 1e-4
