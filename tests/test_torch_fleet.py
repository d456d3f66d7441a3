"""Port parity, fleet observability: singa_tpu_torch.fleet against
singa_tpu.fleet.

- `merge_metric_snapshots` gives equal rollups for the same snapshots.
- Fake shards, written with tests/test_fleet.py's helpers into one spool,
  are read by both packages' `FleetAggregator`s poll for poll: straggler
  scores (rtol 1e-9), sustained verdicts and what reached each package's
  HealthMonitor, staleness, ghost pruning, host collisions, restarted
  workers, peer hangs and the audit vote, the rollup (times left out),
  `fleet_report`'s text (times and the coordinator's pid left out) and
  the merged trace (a multiset of (name, ph, tid, cat, pid) with aligned
  `ts` within 1 us): one parametrised test, a case per scenario.
- Shards cross between the packages: a port `ShardWriter`'s shard is read
  by JAX's aggregator and a JAX writer's by the port's, with the same
  line kinds in the same order.
- `publish` runs under the watchdog's `fleet_publish` guard and the
  "fleet.publish" fault point; the port's `TrainController` halts on a
  sustained straggler with JAX's `exclude_hosts`, and both packages'
  controllers restore in lockstep on a peer's hang verdict alike; a hang
  bundle carries the installed aggregator's rollup in both.
- One `fleet --ab --synthetic --device cpu` run with 3 workers, its
  processes kept on two cores.
"""

import json
import os
import re
import time

import numpy as np
import pytest
import torch

from singa_tpu import fleet as jfleet
from singa_tpu import health as jhealth
from singa_tpu import observe as jobserve
from singa_tpu import resilience as jres
from singa_tpu import watchdog as jwatchdog
from singa_tpu_torch import diag as tdiag
from singa_tpu_torch import fleet as tfleet
from singa_tpu_torch import goodput as tgoodput
from singa_tpu_torch import health as thealth
from singa_tpu_torch import observe as tobserve
from singa_tpu_torch import resilience as tres
from singa_tpu_torch import watchdog as twatchdog
from tests.test_fleet import _fake_serve, _step_spans, _write_fake_shard

import torch_ab

torch.set_num_threads(2)

PKGS = {"jax": (jfleet, jhealth, jobserve), "port": (tfleet, thealth,
                                                    tobserve)}


def _port_clean():
    tdiag.stop_diag_server()
    tgoodput.uninstall()
    tfleet.uninstall()
    twatchdog.uninstall_watchdog()
    thealth.set_active_monitor(None)
    tres.clear_fault_plan()
    tobserve.get_registry().reset()
    tobserve.enable(True)


@pytest.fixture(autouse=True)
def _port_state():
    """The port's fleet, diag, watchdog, monitor and fault plan torn down
    around each test (tests/conftest.py cleans only the JAX package's),
    and the JAX package's fleet state too before its leak check."""
    _port_clean()
    yield
    _port_clean()
    jfleet.uninstall()
    jres.clear_fault_plan()
    jhealth.set_active_monitor(None)


# ---- merging ----------------------------------------------------------------

def _snap(ctr, gval, hcount, hsum, labels=None):
    lab = labels or {}
    return {
        "singa_steps_total": {"type": "counter", "help": "", "samples": [
            {"labels": lab, "value": ctr}]},
        "singa_hbm_bytes_in_use": {"type": "gauge", "help": "", "samples": [
            {"labels": lab, "value": gval}]},
        "singa_step_seconds": {"type": "histogram", "help": "", "samples": [
            {"labels": lab, "count": hcount, "sum": hsum,
             "buckets": {"0.1": hcount // 2, "1": hcount,
                         "+Inf": hcount}}]},
    }


@pytest.mark.parametrize("snaps", [
    {"host0": _snap(10, 100.0, 4, 0.4), "host1": _snap(32, 300.0, 6, 1.2)},
    {"host0": _snap(1, 5.0, 2, 0.3, {"op": "all_reduce"}),
     "host1": _snap(2, 7.0, 3, 0.1, {"op": "broadcast"}),
     "host2": {"singa_steps_total": {"type": "gauge", "samples": [
         {"labels": {}, "value": 4.0}]}}},
    {"host0": None, "host1": {}},
], ids=["two_hosts", "labels_and_type_conflict", "empty"])
def test_merge_metric_snapshots_equal(snaps):
    assert tfleet.merge_metric_snapshots(snaps) \
        == jfleet.merge_metric_snapshots(snaps)


# ---- the aggregators, poll for poll -----------------------------------------

def _with_line(path, kind, key, value):
    """Insert one `{"kind": kind, key: value}` line after the header of a
    fake shard (the helper writes no hang or audit line)."""
    with open(path, encoding="utf-8") as f:
        rows = [json.loads(x) for x in f if x.strip()]
    rows.insert(1, {"kind": kind, key: value})
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


_TL = {"id": 42, "outcome": "completed", "prompt_tokens": 5,
       "new_tokens": 4, "slot": 1, "ttft_s": 0.4, "total_s": 0.9,
       "tokens_per_sec": 4.4,
       "events": [["submit", 100.0, None], ["queue", 100.001, None],
                  ["admit", 100.2, None], ["prefill", 100.21, None],
                  ["first_token", 100.4, None],
                  ["decode", 100.6, {"tokens": 2, "sync": 9}],
                  ["decode", 100.8, {"tokens": 4, "sync": 10}],
                  ["terminal", 100.9, {"outcome": "completed"}]],
       "syncs": [9, 10]}
_SYNCS = [{"sync": 9, "t0": 100.5, "dur": 0.2, "tid": 77, "slots": 1,
           "steps": 2, "tokens": 2},
          {"sync": 10, "t0": 100.75, "dur": 0.1, "tid": 77, "slots": 1,
           "steps": 2, "tokens": 2}]
_WALL = 1_700_000_000.0


def _sc_step(d, now):
    _write_fake_shard(d, "host0", 100, spans=_step_spans(0.005), steps=6)
    _write_fake_shard(d, "host1", 101, spans=_step_spans(0.005), steps=6)
    _write_fake_shard(d, "host2", 102, spans=_step_spans(0.060), steps=6)
    yield "poll"


def _sc_comm(d, now):
    spans = [("comm.all_reduce", 100.0 + i, 0.001, 1, "comm")
             for i in range(6)]
    slow = [("comm.all_reduce", 100.0 + i, 0.055, 1, "comm")
            for i in range(6)]
    _write_fake_shard(d, "host0", 100, spans=spans + _step_spans(0.01))
    _write_fake_shard(d, "host1", 101, spans=slow + _step_spans(0.012))
    _write_fake_shard(d, "host2", 102, spans=spans)
    yield "poll"


def _sc_sustained(d, now):
    _write_fake_shard(d, "host0", 100, spans=_step_spans(0.005))
    _write_fake_shard(d, "host1", 101, spans=_step_spans(0.080))
    for _ in range(4):
        yield "poll"


def _sc_restart(d, now):
    _write_fake_shard(d, "host0", 100, seq=40, steps=40,
                      spans=_step_spans(0.005))
    _write_fake_shard(d, "host1", 101, seq=3, steps=30,
                      spans=_step_spans(0.005))
    yield "poll"
    _write_fake_shard(d, "host0", 100, seq=1, steps=2,
                      spans=_step_spans(0.050, t0=300.0))
    yield "poll"
    _write_fake_shard(d, "host0", 100, seq=2, steps=9, ts=now + 2.0,
                      spans=_step_spans(0.050, t0=310.0))
    yield "poll"


def _sc_ghost_collision_stale(d, now):
    p = _write_fake_shard(d, "host9", 90, ts=now, spans=_step_spans(0.005))
    _write_fake_shard(d, "host0", 100, ts=now, spans=_step_spans(0.005),
                      name="worker_100")
    _write_fake_shard(d, "host0", 99, ts=now - 120.0,
                      spans=_step_spans(0.200), name="worker_99")
    _write_fake_shard(d, "host1", 101, ts=now, spans=_step_spans(0.005),
                      name="worker_101")
    _write_fake_shard(d, "host2", 102, ts=now - 60.0)
    yield "poll"
    os.remove(p)
    yield "poll"


def _sc_mem_serve(d, now):
    _write_fake_shard(d, "hostA", 100, steps=5, serve=_fake_serve(),
                      mem={"regions": {"params": 10 ** 8},
                           "total_bytes": 10 ** 8, "n_arrays": 3,
                           "step": 5},
                      capacity={"headroom_frac": 0.25, "wall": "slots"})
    _write_fake_shard(d, "hostB", 101, steps=5,
                      serve=dict(_fake_serve(rps=1.0, breaching=()),
                                 draining=True),
                      mem={"regions": {"params": 10 ** 9},
                           "total_bytes": 10 ** 9, "n_arrays": 3,
                           "step": 5})
    _write_fake_shard(d, "hostC", 102, steps=5)
    yield "poll"


def _sc_trace(d, now):
    _write_fake_shard(d, "hostA", 100, ts=_WALL, perf=100.0,
                      spans=[("model.step", 101.0, 0.01, 7, "span"),
                             ("startup.build", 99.0, 0.5, 800_000,
                              "startup")],
                      serve=_fake_serve(timelines=[_TL], syncs=_SYNCS))
    _write_fake_shard(d, "hostB", 101, ts=_WALL, perf=50.0,
                      spans=[("model.step", 51.0, 0.01, 8, "span"),
                             ("comm.all_reduce", 51.002, 0.05, 8, "comm"),
                             ("serving.engine_step", 50.1501, 0.1498, 77,
                              "span")],
                      serve=_fake_serve(
                          timelines=[dict(_TL, id=7)],
                          syncs=[dict(_SYNCS[0], t0=50.15, dur=0.15)]))
    yield "poll"


def _sc_peer_hang(d, now):
    _write_fake_shard(d, "host0", 100, spans=_step_spans(0.005))
    p = _write_fake_shard(d, "hostW", 101, spans=_step_spans(0.005))
    _with_line(p, "fleet_hang", "hang", {"id": 3, "stage": "abort",
                                         "op": "collective",
                                         "seconds": 4.5})
    yield "poll"
    yield "take_peer_hang"
    yield "poll"


def _sc_audit_vote(d, now):
    good = [["embed", 11], ["blocks.0", 22], ["head", 33]]
    for i, host in enumerate(("hostA", "hostB", "hostC", "hostD")):
        p = _write_fake_shard(d, host, 100 + i)
        fp = good if host != "hostC" else [["embed", 11],
                                           ["blocks.0", 99],
                                           ["head", 33]]
        _with_line(p, "fleet_audit", "audit",
                   {"fingerprint": fp, "count": 4})
    yield "poll"
    yield "poll"


SCENARIOS = {
    "step_signal": (_sc_step, {}, None),
    "comm_signal": (_sc_comm, {}, None),
    "sustained_warn": (_sc_sustained, {"sustain": 3}, "warn"),
    "sustained_halt": (_sc_sustained, {"sustain": 1, "policy": "halt"},
                       None),
    "policy_override": (_sc_sustained, {"sustain": 1, "policy": "warn"},
                        "halt"),
    "restarted_worker": (_sc_restart, {}, None),
    "ghost_collision_stale": (_sc_ghost_collision_stale, {}, None),
    "mem_and_serve": (_sc_mem_serve, {}, None),
    "merged_trace": (_sc_trace, {}, None),
    "peer_hang": (_sc_peer_hang, {}, None),
    "audit_vote": (_sc_audit_vote, {}, "warn"),
}


#: what each scenario must show (on the JAX view, which the port's equals)
#: so that no case passes on an empty view: (scores, rollup, dissent,
#: peer hang, halted, sustained count, straggler notes, divergence notes,
#: the monitor's last action) per poll
EXPECT = {
    "step_signal": lambda v: v[0][0]["host2"] > 0.5 >= v[0][0]["host0"],
    "comm_signal": lambda v: v[0][0]["host1"] > 0.5,
    "sustained_warn": lambda v: v[1][5] == 0 and v[2][5] == 1
    and v[3][8] == "warn",
    "sustained_halt": lambda v: v[0][4],
    "policy_override": lambda v: not v[0][4] and v[0][8] == "warn",
    "restarted_worker": lambda v: v[1][1]["workers"][0]["seq"] == 1,
    "ghost_collision_stale": lambda v: v[0][1]["n_stale"] == 2
    and v[1][1]["n_workers"] == 4 and v[0][0]["host0"] <= 0.5,
    "mem_and_serve": lambda v: v[0][1]["worst_mem_host"] == "hostB",
    "merged_trace": lambda v: v[0][1]["n_workers"] == 2,
    "peer_hang": lambda v: v[0][3]["host"] == "hostW" and v[1][1]
    and v[2][3] is None,
    "audit_vote": lambda v: set(v[0][2]) == {"hostC"}
    and v[0][7] == 1 and v[1][7] == 1,
}


def _roll(roll):
    """A rollup without its times (each worker's age, the halt's stamp)
    and the spool path."""
    out = dict(roll)
    out.pop("fleet_dir")
    out["workers"] = [{k: v for k, v in r.items() if k != "age_s"}
                      for r in roll["workers"]]
    if out["halt"] is not None:
        out["halt"] = {k: v for k, v in out["halt"].items() if k != "ts"}
    return out


_AGE = re.compile(r"^(\S+\s*\*?\s+\d+\s+\d+\s+)\d+\.\d+")


def _report(text):
    """fleet_report's text without its first line (the coordinator's pid
    and spool), each worker row's age, and the halt's stamp."""
    lines = text.splitlines()[1:]
    lines = [_AGE.sub(r"\1<age>", ln) for ln in lines]
    return [re.sub(r"'ts': [0-9.]+", "'ts': <ts>", ln) for ln in lines]


def _trace(events):
    """The merged trace as sorted (name, ph, tid, cat, pid, ts) rows."""
    rows = [(e.get("name"), e.get("ph"), e.get("tid"), e.get("cat"),
             e.get("pid"), e.get("ts")) for e in events]
    return sorted(rows, key=lambda r: tuple(
        (x is None, x if x is not None else 0) if i == 5 else str(x)
        for i, x in enumerate(r)))


def _counter(obs, name, **labels):
    c = obs.get_registry().get(name)
    return None if c is None else c.value(**labels)


def _compare(a, b, path="out"):
    """Equal, floats within rtol 1e-9."""
    if isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-9, abs=1e-12), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in a:
            _compare(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _compare(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_aggregators_agree(tmp_path, case):
    script, kw, mon_policy = SCENARIOS[case]
    d = str(tmp_path / "spool")
    os.makedirs(d)
    aggs, mons = {}, {}
    for name, (fl, hl, _obs) in PKGS.items():
        if mon_policy is not None:
            mons[name] = hl.HealthMonitor(policy=mon_policy,
                                          out_dir=str(tmp_path / name))
            hl.set_active_monitor(mons[name])
        aggs[name] = fl.FleetAggregator(d, threshold=0.5,
                                        stale_after_s=5.0,
                                        poll_interval_s=0.0, **kw)
    views = {name: [] for name in PKGS}
    for step in script(d, time.time()):
        for name, (fl, hl, obs) in PKGS.items():
            agg = aggs[name]
            if step == "take_peer_hang":
                views[name].append(("take", agg.take_peer_hang()))
                continue
            roll = agg.poll()
            views[name].append((
                agg.straggler_scores(), _roll(roll),
                agg.audit_dissent(), agg.peer_hang(),
                agg.halt_verdict() is not None,
                _counter(obs, "singa_fleet_straggler_sustained_total",
                         host="host1"),
                _counter(obs, "singa_health_anomaly_total",
                         kind=hl.KIND_STRAGGLER),
                _counter(obs, "singa_health_anomaly_total",
                         kind=hl.KIND_DIVERGENCE),
                mons[name].last_action if name in mons else None))
    _compare(views["port"], views["jax"])
    assert EXPECT[case](views["jax"]), views["jax"]
    reports, traces = {}, {}
    for name, (fl, hl, _obs) in PKGS.items():
        fl.install_aggregator(aggregator=aggs[name])
        reports[name] = _report(fl.fleet_report())
        traces[name] = _trace(aggs[name].trace_events()["traceEvents"])
        fl.uninstall_aggregator()
        hl.set_active_monitor(None)
    assert reports["port"] == reports["jax"]
    tp, tj = traces["port"], traces["jax"]
    assert [r[:5] for r in tp] == [r[:5] for r in tj]
    for a, b in zip(tp, tj):
        if a[5] is None or b[5] is None:
            assert a[5] == b[5], (a, b)
        else:
            assert abs(a[5] - b[5]) <= 1.0, (a, b)   # us


def test_peer_hang_and_halt_raise_alike(tmp_path):
    """check_straggler_halt raises the same errors in both packages: a
    sustained straggler under halt (FleetStragglerError, its hosts), then
    after the halt is cleared a peer's abort-stage hang (HangError naming
    the peer, consumed once)."""
    d = str(tmp_path)
    _write_fake_shard(d, "host0", 100, spans=_step_spans(0.005))
    _write_fake_shard(d, "hostS", 101, spans=_step_spans(0.080))
    p = _write_fake_shard(d, "hostW", 102, spans=_step_spans(0.005))
    _with_line(p, "fleet_hang", "hang", {"id": 1, "stage": "abort",
                                         "op": "step", "seconds": 9.0})
    got = {}
    for name, wd in (("jax", jwatchdog), ("port", twatchdog)):
        fl = PKGS[name][0]
        agg = fl.FleetAggregator(d, threshold=0.5, sustain=1,
                                 policy="halt", poll_interval_s=0.0)
        fl.install_aggregator(aggregator=agg)
        with pytest.raises(fl.FleetStragglerError) as e1:
            fl.check_straggler_halt(step=4)
        agg.clear_halt()   # the verdict stays sustained: no re-fire
        with pytest.raises(wd.HangError) as e2:
            fl.check_straggler_halt(step=5)
        fl.check_straggler_halt(step=6)   # consumed: no second raise
        got[name] = (e1.value.hosts, e1.value.score, str(e1.value),
                     e2.value.hosts, e2.value.op, e2.value.seconds,
                     str(e2.value))
        fl.uninstall_aggregator()
    assert got["port"] == got["jax"]


# ---- shards across the packages ---------------------------------------------

def _kinds(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(x)["kind"] for x in f if x.strip()]


def test_shards_cross_between_the_packages(tmp_path):
    """A port writer's shard and a JAX writer's shard in one spool: each
    package's read_shard reads both, with the same line kinds in the same
    order, and each aggregator tracks both workers and scores the port's
    comm stamps (`Communicator` at world 1) beside JAX's."""
    import jax.numpy as jnp
    from singa_tpu.parallel.communicator import Communicator as JComm
    from singa_tpu_torch.parallel.communicator import Communicator as TComm
    d = str(tmp_path)
    tw = tfleet.ShardWriter(d, interval_s=0, host="hostP", name="port")
    jw = jfleet.ShardWriter(d, interval_s=0, host="hostJ", name="jax")
    try:
        tcomm, jcomm = TComm(), JComm()
        for _ in range(3):
            with tobserve.span("model.step"):
                tcomm.all_reduce(torch.ones(()))
            tobserve.record_step(0.001)
            with jobserve.span("model.step"):
                jcomm.all_reduce(jnp.ones(()))
            jobserve.record_step(0.001)
        assert tw.publish() == 1 and jw.publish() == 1
    finally:
        tw.close(final_publish=False)
        jw.close(final_publish=False)
    assert _kinds(tw.path) == _kinds(jw.path)
    for path in (tw.path, jw.path):
        a, b = tfleet.read_shard(path), jfleet.read_shard(path)
        assert a is not None and a == b
        assert a["header"]["version"] == tfleet.SHARD_VERSION \
            == jfleet.SHARD_VERSION
        assert a["header"]["steps"] == 3
        assert {s["span_kind"] for s in a["spans"]} == {"span", "comm"}
        assert (a["capacity"], a["audit"], a["regress"]) \
            == (None, None, None)
    port_shard = tfleet.read_shard(tw.path)
    assert port_shard["metrics"]["singa_comm_host_seconds"]["samples"]
    for fl in (jfleet, tfleet):
        agg = fl.FleetAggregator(d)
        roll = agg.poll()
        assert [r["host"] for r in roll["workers"]] == ["hostJ", "hostP"]
        assert all(r["steps"] == 3 for r in roll["workers"])
        assert set(agg.straggler_scores()) == {"hostJ", "hostP"}
        ev = agg.trace_events()["traceEvents"]
        assert {e["pid"] for e in ev if e.get("cat") == "comm"} \
            == {os.getpid()}
        assert len([e for e in ev if e.get("cat") == "comm"]) == 6


def test_publish_guard_and_fault_point(tmp_path):
    """`publish` passes the fault point "fleet.publish" inside the
    watchdog's `fleet_publish` guard: a FaultPlan delay there breaches
    the guard's static deadline, and a FaultPlan failure reaches the
    caller (the publisher thread counts it instead)."""
    plan = tres.FaultPlan().delay("fleet.publish", 0.2, times=1) \
        .fail("fleet.publish", nth=2)
    tres.install_fault_plan(plan)
    twatchdog.install_watchdog(deadlines={"fleet_publish": 0.02},
                               action="warn", poll_interval_s=0.005)
    w = tfleet.ShardWriter(str(tmp_path), interval_s=0, host="hostA")
    try:
        assert w.publish() == 1
        with pytest.raises(Exception):
            w.publish()
    finally:
        w.close(final_publish=False)
        twatchdog.uninstall_watchdog()
    assert [p for p, *_ in plan.fired] == ["fleet.publish"] * 2
    assert _counter(tobserve, "singa_watchdog_breach_total",
                    op="fleet_publish") >= 1
    assert _counter(tobserve, "singa_fleet_shard_publish_total") == 1


# ---- the training hook ------------------------------------------------------

def test_controller_halts_on_straggler_with_exclude_hosts(tmp_path):
    """After tests/test_fleet.py's controller case: under the halt policy
    the port's TrainController raises FleetStragglerError out of its loop
    with a final "halt" checkpoint and JAX's `exclude_hosts`."""
    from singa_tpu_torch import overlap
    from singa_tpu_torch.resilience import _worker_build
    spool = str(tmp_path / "spool")
    _write_fake_shard(spool, "host0", 100, spans=_step_spans(0.005))
    _write_fake_shard(spool, "hostS", 101, spans=_step_spans(0.080))
    agg = tfleet.FleetAggregator(spool, threshold=0.5, sustain=1,
                                 policy="halt", poll_interval_s=0.0)
    tfleet.install_aggregator(aggregator=agg)
    m, tx, ty = _worker_build(1, 8, 0, "cpu")
    ctrl = tres.TrainController(m, str(tmp_path / "ck"),
                                save_every_steps=2, handle_signals=False)
    with pytest.raises(tfleet.FleetStragglerError) as ei:
        ctrl.fit([(tx, ty)] * 6, epochs=1)
    overlap.wait_for_checkpoints()
    rep = ei.value.resilience
    assert rep["exclude_hosts"] == ["hostS"]
    assert isinstance(ei.value, thealth.HealthError)
    latest = tres.latest_checkpoint(str(tmp_path / "ck"))
    assert latest is not None and latest[1]["status"] == "halt"
    assert rep["final_step"] == 0


class _HangAfter:
    """`n` copies of one batch; yielding the one at `at` writes a peer's
    abort-stage hang shard into the spool (once), so the controller's
    next step meets the verdict."""

    def __init__(self, batch, n, at, spool):
        self.batch, self.n, self.at, self.spool = batch, n, at, spool
        self.written = False

    def __iter__(self):
        for i in range(self.n):
            if i == self.at and not self.written:
                self.written = True
                p = _write_fake_shard(self.spool, "hostW", 102,
                                      spans=_step_spans(0.005))
                _with_line(p, "fleet_hang", "hang", {
                    "id": 1, "stage": "abort", "op": "collective",
                    "seconds": 9.0})
            yield self.batch


def _jax_mlp():
    from singa_tpu import layer, model as model_mod, opt, tensor
    from singa_tpu.device import get_default_device

    class Net(model_mod.Model):
        def __init__(self):
            super().__init__()
            self.fc = layer.Linear(4)
            self.sce = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc(x)

        def train_one_batch(self, x, y):
            loss = self.sce(self.forward(x), y)
            self.optimizer(loss)
            return loss

    dev = get_default_device()
    rng = np.random.RandomState(0)
    tx = tensor.from_numpy(rng.randn(8, 8).astype(np.float32), dev)
    ty = tensor.from_numpy(rng.randint(0, 4, 8).astype(np.int32), dev)
    m = Net()
    m.set_optimizer(opt.SGD(lr=0.1))
    m.compile([tx], is_train=True, use_graph=True)
    return m, tx, ty


def test_controller_restores_in_lockstep_on_a_peer_hang(tmp_path):
    """A peer's abort-stage hang verdict reaches each package's
    TrainController through its per-step `check_straggler_halt`: one
    hang restart naming the peer, from the latest checkpoint, then the
    run completes; the reports agree."""
    from singa_tpu_torch.resilience import _worker_build
    got = {}
    for name in ("jax", "port"):
        fl, res = (jfleet, jres) if name == "jax" else (tfleet, tres)
        obs = PKGS[name][2]
        spool = str(tmp_path / name / "spool")
        _write_fake_shard(spool, "host0", 100, spans=_step_spans(0.005))
        fl.install_aggregator(spool, poll_interval_s=0.0)
        if name == "jax":
            m, tx, ty = _jax_mlp()
        else:
            m, tx, ty = _worker_build(1, 8, 0, "cpu")
        since = len(obs.get_registry().recent)
        ctrl = res.TrainController(m, str(tmp_path / name / "ck"),
                                   save_every_steps=2, max_restarts=1,
                                   handle_signals=False)
        rep = ctrl.fit(_HangAfter((tx, ty), 6, 3, spool), epochs=1)
        (jfleet if name == "jax" else tfleet).uninstall_aggregator()
        if name == "jax":
            from singa_tpu import overlap as ov
        else:
            from singa_tpu_torch import overlap as ov
        ov.wait_for_checkpoints()
        ev = [r for r in list(obs.get_registry().recent)[since:]
              if r.get("kind") == "resilience"]
        got[name] = (rep["status"], rep["restarts"], rep["final_step"],
                     [r["event"] for r in ev],
                     [r.get("hosts") for r in ev
                      if r["event"] == "hang_restart"],
                     [r.get("resumed_step") for r in ev
                      if r["event"] == "resume"])
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ("completed", 1, 6)
    assert got["port"][4] == [["hostW"]]


def test_hang_bundle_carries_the_fleet_rollup(tmp_path):
    """With an aggregator installed, a watchdog hang bundle holds the
    `hang_fleet` line in both packages, with equal keys and workers
    (ages left out)."""
    spool = str(tmp_path / "spool")
    _write_fake_shard(spool, "host0", 100, spans=_step_spans(0.005))
    _write_fake_shard(spool, "host1", 101, spans=_step_spans(0.080))
    got = {}
    for name, wd in (("jax", jwatchdog), ("port", twatchdog)):
        fl = PKGS[name][0]
        agg = fl.install_aggregator(spool, threshold=0.5, sustain=1)
        agg.poll()
        w = wd.Watchdog(out_dir=str(tmp_path / name))
        try:
            path = w.dump_hang_bundle("step", 1.5)
        finally:
            w.close()
        b = wd.load_hang_bundle(path)
        fl.uninstall_aggregator()
        got[name] = {k: v for k, v in b["fleet"].items()
                     if k != "workers"}
        got[name]["workers"] = [{k: v for k, v in r.items()
                                 if k != "age_s"}
                                for r in b["fleet"]["workers"]]
    assert got["port"] == got["jax"]
    assert got["port"]["n_workers"] == 2
    assert got["port"]["stragglers"] == ["host1"]


# ---- the subprocess A/B -----------------------------------------------------

def test_straggler_ab_synthetic_on_cpu(tmp_path, tmp_path_factory,
                                      monkeypatch):
    """`fleet --ab --synthetic --device cpu` with 3 workers: the slow host
    detected within 5 steps, every host on /fleetz, 3 trace tracks and the
    injected 50 ms visible on the slow track. The coordinator thread and
    its worker processes (which inherit its affinity) share two cores,
    one subprocess A/B at a time (`torch_ab.two_cores`)."""
    out = str(tmp_path / "FLEET_test.json")
    with torch_ab.two_cores(tmp_path_factory, monkeypatch):
        rc = tfleet.main(["--ab", "--synthetic", "--device", "cpu",
                          "--workers", "3", "--steps", "6",
                          "--step-sleep", "0.02", "--delay", "0.05",
                          "--timeout", "120", "--out", out])
    with open(out, encoding="utf-8") as f:
        rec = json.load(f)
    assert rc == 0 and rec["ok"] is True, rec
    assert rec["device"] == "cpu" and rec["mode"] == "synthetic"
    assert rec["detected"] and rec["steps_at_detection"] <= 5
    assert rec["slow_host"] == "host2"
    assert rec["scores_at_detection"]["host2"] > rec["threshold"]
    assert all(v <= rec["threshold"] for h, v
               in rec["scores_at_detection"].items() if h != "host2")
    assert rec["fleetz_lists_all_hosts"] and rec["trace_schema_ok"]
    assert rec["trace_tracks"] == 3
    assert rec["slow_gap_ms"] >= 40.0
    assert rec["worker_rcs"] == [0, 0, 0]


def test_worker_and_ab_need_the_card_unless_cpu(tmp_path):
    """Without a card the command line's default device raises; nothing
    falls back to the CPU. A worker's mesh is one device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    args = ["--worker", "--fleet-dir", str(tmp_path), "--steps", "1"]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tfleet.main(args + ["--synthetic"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tfleet.main(["--ab", "--synthetic", "--out",
                     str(tmp_path / "x.json")])
    with pytest.raises(ValueError, match="mesh-devices"):
        tfleet.main(args + ["--device", "cpu", "--mesh-devices", "2"])
    assert np.all([not f.endswith(".json") for f in os.listdir(tmp_path)])
