"""Port parity, the capacity observatory: singa_tpu_torch.capacity against
singa_tpu.capacity.

- The enums are JAX's.
- `CapacityModel`: per-replica rows (every wall binding in turn, the
  optional walls gated, the peak floor across a cooldown, per host) and
  the fleet rollup over fresh and stale workers are equal, field for
  field, on the same serve dicts.
- `DemandForecaster`: the fast and slow EWMAs, bursts, time to saturation
  and snapshots are equal step for step on the same seeded rate series.
- `ShadowScaler` on the same scripted sample sequences (tests/
  test_capacity.py's feeds: a sustained burn, a quiet surplus, a hard
  reversal, a forecast deficit, seeded bursty arrivals, scoring): every
  decision record, the accuracy scorecard, the snapshot, the JSONL
  ledger's lines, `capacity_report`'s text and the exported metrics are
  equal across the packages.
- A live port engine: `default_sample` and the `fleet_capacity` shard
  line reconcile; the port's shard carries the line in JAX's format and
  both packages' `read_shard` and aggregators read it the same, headroom
  column on /fleetz included.
- /capacityz answers 503 until a scaler is installed, then 200 (text and
  ?json=1), and /statusz has its section.
- One `capacity --ab --device cpu` run at the CLI's defaults holds its
  record's `ok`; a `cuda` run without a card raises.
- The A/B's CPU engine threads split the intra-op threads (ROADMAP.md,
  Queue 3, fault 16): each runs at most the starting thread's count over
  the number of engines.
"""

import argparse
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from singa_tpu import capacity as jcapacity
from singa_tpu import fleet as jfleet
from singa_tpu import observe as jobserve
from singa_tpu_torch import capacity as tcapacity
from singa_tpu_torch import diag as tdiag
from singa_tpu_torch import engine as tengine
from singa_tpu_torch import fleet as tfleet
from singa_tpu_torch import observe as tobserve
from singa_tpu_torch import router as trouter
from singa_tpu_torch import slo as tslo
from singa_tpu_torch.models import transformer as tt

import torch_ab

torch.set_num_threads(2)

PKGS = {"jax": (jcapacity, jobserve), "port": (tcapacity, tobserve)}


def _port_clean():
    tcapacity.reset()
    trouter.reset()
    tengine.reset()
    tfleet.uninstall()
    tdiag.stop_diag_server()
    tslo.reset()
    tobserve.get_registry().reset()
    tobserve.enable(True)


@pytest.fixture(autouse=True)
def _port_state():
    """The port's scaler (its singa-capacity-poll thread joined), engines,
    router, fleet, diag and SLO state torn down around each test:
    tests/conftest.py cleans only the JAX package's, and asserts on the
    same `singa-capacity` thread prefix."""
    _port_clean()
    jobserve.get_registry().reset()
    yield
    _port_clean()
    jcapacity.reset()


def _serve(slots=4, occupancy=2, page_util=0.25, queue_depth=0,
           ttft_p99_s=None, decode_tok_s=None, rps=2.0):
    return {"slots": slots, "occupancy": occupancy,
            "page_util": page_util, "queue_depth": queue_depth,
            "ttft_p99_s": ttft_p99_s, "decode_tok_s": decode_tok_s,
            "rps": rps}


def _workers(*serves, stale=()):
    return [{"host": f"r{i:02d}", "serve": s, "stale": i in stale}
            for i, s in enumerate(serves)]


def test_enums_equal_jax():
    for name in ("CAPACITY_WALLS", "SCALE_DECISIONS", "DECISION_REASONS",
                 "SHADOW_OUTCOMES"):
        assert getattr(tcapacity, name) == getattr(jcapacity, name), name


# ---- the capacity model ------------------------------------------------------

#: (CapacityModel kwargs, decode floor or None, [(serve, host)])
MODEL_CASES = {
    "walls": (dict(ttft_slo_s=1.0, decode_floor_tok_s=100.0), None, [
        (_serve(occupancy=3, rps=3.0), "local"),
        (_serve(occupancy=1, page_util=0.9), "local"),
        (_serve(occupancy=2, queue_depth=9), "local"),
        (_serve(occupancy=1, ttft_p99_s=0.8), "local"),
        (_serve(occupancy=1, decode_tok_s=85.0), "local")]),
    "gated": (dict(), None, [
        (_serve(ttft_p99_s=5.0, decode_tok_s=1e9), "local")]),
    "module_floor": (dict(), 200.0, [
        (_serve(occupancy=0, page_util=0.0, decode_tok_s=190.0), "a")]),
    "peak_floor": (dict(), None, [
        (_serve(occupancy=4, rps=8.0), "local"),
        (_serve(occupancy=2, rps=1.0), "local"),
        (_serve(occupancy=0, page_util=0.01, rps=0.0), "local"),
        (_serve(occupancy=0, page_util=0.01, rps=0.0), "other")]),
    "no_slots": (dict(queue_factor=2.0), None, [
        (_serve(slots=0, occupancy=0, page_util=None, queue_depth=3),
         "local"),
        (_serve(slots=0, occupancy=0, page_util=None), "local")]),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_rows_equal(case):
    kw, floor, seq = MODEL_CASES[case]
    rows = {}
    for name, (cap, _obs) in PKGS.items():
        cap.note_decode_floor(floor)
        try:
            m = cap.CapacityModel(**kw)
            rows[name] = [m.assess_replica(dict(s), host=h)
                          for s, h in seq]
        finally:
            cap.note_decode_floor(None)
    assert rows["port"] == rows["jax"]


def test_fleet_rollup_equal():
    ws = _workers(_serve(occupancy=3, rps=3.0), _serve(occupancy=1, rps=1.0),
                  _serve(occupancy=4, rps=9.0), stale={2})
    ws.append({"host": "noserve", "serve": None, "stale": False})
    got = {name: (cap.CapacityModel().assess(ws),
                  cap.CapacityModel().assess([]))
           for name, (cap, _obs) in PKGS.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0]["sustainable_rps"] == 8.0


# ---- the demand forecaster ---------------------------------------------------

def test_forecaster_equal_on_seeded_series():
    rng = np.random.RandomState(11)
    t, series = 0.0, []
    for i in range(120):
        t += float(rng.uniform(0.05, 1.5))
        burst = (i // 15) % 2
        series.append((float(rng.rand() * (12.0 if burst else 0.4)), t))
    got = {}
    for name, (cap, _obs) in PKGS.items():
        f = cap.DemandForecaster(fast_tau_s=0.7, slow_tau_s=6.0,
                                 burst_ratio=1.5, min_rate=0.1)
        out = [(f.demand_rps(), f.burst(), f.time_to_saturation(5.0))]
        for rate, now in series:
            f.update(rate, now)
            out.append((f.fast, f.slow, f.burst(), f.demand_rps(),
                        f.time_to_saturation(5.0),
                        f.time_to_saturation(50.0),
                        f.time_to_saturation(None), f.snapshot()))
        got[name] = out
    assert got["port"] == got["jax"]
    assert any(row[2] for row in got["port"][1:])


# ---- the shadow scaler -------------------------------------------------------

class _Feed:
    """tests/test_capacity.py's scripted sample()/clock pair: one
    (admitted_rps, burn) step an evaluate() at a 1 s cadence, against a
    steady 2-replica fleet (4 rps sustainable)."""

    def __init__(self, steps):
        self.steps = list(steps)
        self.i = 0

    def clock(self):
        return float(self.i)

    def sample(self):
        admitted, burn = self.steps[min(self.i, len(self.steps) - 1)]
        self.i += 1
        return {"workers": _workers(_serve(rps=1.0), _serve(rps=1.0)),
                "admitted_rps": admitted, "burn_fast": burn,
                "burn_slow": burn, "breaching": [], "shed_rate": 0.0}


def _bursty():
    rng = np.random.RandomState(1234)
    steps, mode = [], 0
    while len(steps) < 160:
        mode = 1 - mode
        for _ in range(int(rng.randint(1, 7))):
            if mode:
                steps.append((float(8.0 + rng.rand() * 6.0),
                              float(3.0 + rng.rand() * 3.0)))
            else:
                steps.append((float(rng.rand() * 0.3), 0.0))
    return steps


#: name -> (steps, polls, scaler kwargs beyond the defaults)
SCRIPTS = {
    "burn_sustained": ([(2.0, 0.0)] * 2 + [(2.0, 5.0)] * 6, 8, {}),
    "surplus": ([(0.1, 0.0)] * 8, 6, {}),
    "surplus_burning": ([(0.1, 5.0)] * 4, 4, dict(burn_sustain=99)),
    "reversal": ([(0.1, 0.0)] * 3 + [(8.0, 5.0)] * 12, 12,
                 dict(cooldown_polls=2, damp_polls=2)),
    "deficit": ([(10.0, 0.0)] * 12, 12,
                dict(burn_sustain=99, horizon_s=3.0)),
    "scoring": ([(2.0, 0.0)] * 2 + [(2.0, 5.0)] * 4 + [(2.0, 0.0)] * 10, 16,
                dict(horizon_s=3.0)),
    "bursty": (_bursty(), 160, dict(cooldown_polls=4, damp_polls=2)),
}


def _run_script(cap, obs, steps, polls, kw, ledger):
    feed = _Feed(steps)
    kw = dict(dict(interval_s=0.0, burn_sustain=2, down_sustain=2,
                   cooldown_polls=3, damp_polls=2, horizon_s=4.0), **kw)
    s = cap.ShadowScaler(
        cap.CapacityModel(),
        cap.DemandForecaster(fast_tau_s=0.5, slow_tau_s=5.0),
        sample=feed.sample, clock=feed.clock, ledger_path=ledger, **kw)
    s.install(poll=False)
    try:
        recs = [s.evaluate() for _ in range(polls)]
        snap = s.snapshot()
        snap["ledger_path"] = None
        out = {"recs": recs, "ring": s.decisions(), "snap": snap,
               "accuracy": s.accuracy(),
               "changes": s.direction_changes(),
               "report": cap.capacity_report(),
               "json_decisions": cap.capacity_json()["decisions"]}
    finally:
        cap.uninstall()
    reg = obs.get_registry()
    out["metrics"] = {
        "polls": reg.get("singa_capacity_polls_total").value(),
        "headroom": reg.get("singa_capacity_headroom_frac").value(),
        "sustainable": reg.get("singa_capacity_sustainable_rps").value(),
        "demand": reg.get("singa_capacity_demand_rps").value(),
        "decisions": {(d, r): reg.get(
            "singa_scaler_decisions_total").value(decision=d, reason=r)
            for d in cap.SCALE_DECISIONS for r in cap.DECISION_REASONS},
        "changes": reg.get("singa_scaler_direction_changes_total").value()
        if reg.get("singa_scaler_direction_changes_total") else None}
    with open(ledger, encoding="utf-8") as f:
        out["ledger"] = f.read()
    out["read_ledger"] = cap.read_ledger(ledger)
    return out


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scaler_scripts_equal(tmp_path, script):
    """The same scripted samples through both packages' scalers: decisions
    and reasons poll for poll, scores, snapshot, ledger bytes, report text
    and metrics equal."""
    steps, polls, kw = SCRIPTS[script]
    got = {name: _run_script(cap, obs, steps, polls, kw,
                             str(tmp_path / f"{name}.jsonl"))
           for name, (cap, obs) in PKGS.items()}
    assert got["port"]["recs"] == got["jax"]["recs"]
    for key in ("ring", "snap", "accuracy", "changes", "report",
                "json_decisions", "metrics", "ledger", "read_ledger"):
        assert got["port"][key] == got["jax"][key], key
    recs = got["port"]["recs"]
    assert all(r["decision"] in tcapacity.SCALE_DECISIONS
               and r["reason"] in tcapacity.DECISION_REASONS for r in recs)
    if script == "bursty":
        emitted = [r["poll"] for r in recs if r["decision"] != "hold"]
        assert emitted and all(b - a >= 5
                               for a, b in zip(emitted, emitted[1:]))


def test_install_reset_and_poll_thread():
    feed = _Feed([(1.0, 0.0)] * 4)
    s = tcapacity.ShadowScaler(sample=feed.sample, interval_s=0.01)
    s.install()
    try:
        assert tcapacity.get_scaler() is s
        assert len([t for t in threading.enumerate()
                    if t.name.startswith("singa-capacity-poll-")]) == 1
        deadline = time.monotonic() + 10.0
        while s.snapshot()["polls"] < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert s.snapshot()["polls"] >= 2
    finally:
        tcapacity.reset()
    assert tcapacity.get_scaler() is None
    assert not [t for t in threading.enumerate()
                if t.name.startswith("singa-capacity")]
    a = tcapacity.ShadowScaler(sample=feed.sample, interval_s=0.0)
    b = tcapacity.ShadowScaler(sample=feed.sample, interval_s=0.0)
    a.install(poll=False)
    b.install(poll=False)
    assert tcapacity.get_scaler() is b
    tcapacity.note_decode_floor(50.0)
    tcapacity.reset()
    assert tcapacity.get_scaler() is None
    assert tcapacity.get_decode_floor() is None


# ---- live engine, the shard line, the endpoints ----------------------------

def _get(url):
    from urllib.error import HTTPError
    from urllib.request import urlopen
    try:
        with urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except HTTPError as e:
        return e.code, e.read().decode()


def test_live_engine_shard_line_and_endpoints(tmp_path):
    """A port engine serving: `default_sample`'s local row is the
    `fleet_serve` dict, `fleet_capacity_snapshot` is its headroom row;
    the port's shard carries the `fleet_capacity` line in JAX's format
    (both `read_shard`s and both aggregators read the same rows, the
    /fleetz headroom column in both reports); /capacityz 503 until a
    scaler is installed, then 200, and /statusz has the section."""
    assert tcapacity.fleet_capacity_snapshot() is None
    s = tcapacity.default_sample()
    assert s["workers"] == [] and s["burn_fast"] is None
    m = tt.GPT(vocab_size=97, max_seq=64, dim=64, num_heads=4,
               num_layers=2, device="cpu", seed=0)
    m.eval()
    e = tengine.ServingEngine(m, max_slots=2, page_size=8, max_ctx=64,
                              steps_per_sync=2).start()
    srv = tdiag.start_diag_server(port=0)
    d = str(tmp_path)
    try:
        rng = np.random.RandomState(5)
        hs = [e.submit(rng.randint(0, 97, (6,)), 5) for _ in range(3)]
        assert all(h.wait(120) and h.outcome == "completed" for h in hs)
        s = tcapacity.default_sample()
        assert len(s["workers"]) == 1
        serve = s["workers"][0]["serve"]
        assert serve["slots"] == 2 and s["admitted_rps"] == serve["rps"]
        snap = tcapacity.fleet_capacity_snapshot()
        row = tcapacity.CapacityModel().assess_replica(serve)
        assert snap["wall"] == row["wall"] in tcapacity.CAPACITY_WALLS
        assert snap["utils"]["slots"] == row["utils"]["slots"]
        assert set(snap) == {"headroom_frac", "wall", "wall_util",
                             "sustainable_rps", "source", "utils", "rps"}
        st, body = _get(srv.url + "/capacityz")
        assert st == 503 and "no ShadowScaler installed" in body
        st, body = _get(srv.url + "/capacityz?json=1")
        assert st == 503 and json.loads(body) == {"installed": False}
        w = tfleet.ShardWriter(d, interval_s=0, host="hostP", name="port")
        try:
            w.publish()
        finally:
            w.close(final_publish=False)
        a, b = tfleet.read_shard(w.path), jfleet.read_shard(w.path)
        assert a == b and a["capacity"]["wall"] == snap["wall"]
        rows = {}
        for fl in (jfleet, tfleet):
            fl.install_aggregator(d, stale_after_s=60.0)
            try:
                roll = fl.get_aggregator().poll()
                rows[fl] = [r["capacity"] for r in roll["workers"]]
                assert f"({snap['wall']})" in fl.fleet_report()
            finally:
                fl.uninstall()
        assert rows[tfleet] == rows[jfleet] == [a["capacity"]]
        sc = tcapacity.ShadowScaler(interval_s=0.0).install(poll=False)
        sc.evaluate()
        st, body = _get(srv.url + "/capacityz")
        assert st == 200 and body.startswith("== capacity ==")
        assert "fleet: 1 replica(s)" in body
        st, body = _get(srv.url + "/capacityz?json=1")
        js = json.loads(body)
        assert st == 200 and js["installed"] and len(js["decisions"]) == 1
        st, body = _get(srv.url + "/statusz")
        assert st == 200 and "== capacity ==" in body
        assert "(capacity unavailable" not in body
        assert tcapacity.fleet_capacity_snapshot()["polls"] == 1
    finally:
        tdiag.stop_diag_server()
        e.stop()


# ---- the command line --------------------------------------------------------

def test_capacity_ab_on_cpu(tmp_path, tmp_path_factory):
    """`capacity --ab --device cpu` at the CLI's defaults: the record's
    `ok` (scale-up within 5 polls of sustained burn, scale-down on the
    cooldown leg, at most one direction change a leg, every decision
    reason-coded, a ledger beside the record holding every decision and
    a score). Its engines run in this process, on this process's cores,
    one A/B at a time (`torch_ab.one_at_a_time`)."""
    out = str(tmp_path / "CAPACITY_test.json")
    with torch_ab.one_at_a_time(tmp_path_factory):
        rc = tcapacity.main(["--ab", "--device", "cpu", "--out", out])
    with open(out, encoding="utf-8") as f:
        lines = [json.loads(x) for x in f if x.strip()]
    rec = lines[-1]
    assert rc == 0 and rec["ok"] is True, rec
    assert rec["device"] == "cpu" and rec["scale_up_delay_polls"] <= 5
    assert rec["first_scale_down_poll"] is not None
    ledger = tcapacity.read_ledger(
        str(tmp_path / "CAPACITY_torch_ledger.jsonl"))
    assert len(ledger) == rec["ledger_decisions"] + rec["ledger_scores"]
    assert {m["metric"] for m in lines[:-1]} == {
        "capacity_scale_up_delay_polls", "capacity_decision_flaps",
        "capacity_cooldown_headroom_frac", "capacity_shadow_precision"}
    assert not [t.name for t in threading.enumerate() if t.is_alive()
                and t.name.startswith(("singa-capacity", "singa-route"))]


def test_ab_engine_threads_split_the_cores(monkeypatch):
    """Fault 16: the capacity A/B's two CPU engines, built by its own
    `_ab_build` at the CLI's defaults, each decode on at most the
    starting thread's intra-op count over the number of engines. Each
    engine thread at the full count oversubscribed the cores, and a sync
    took several times its one-thread time."""
    seen = {}
    decode = tengine.ServingEngine._decode

    def spy(self, *args):
        seen[threading.get_ident()] = torch.get_num_threads()
        return decode(self, *args)

    monkeypatch.setattr(tengine.ServingEngine, "_decode", spy)
    args = argparse.Namespace(
        replicas=2, slots=2, vocab=211, dim=64, layers=2, page_size=8,
        prompt_hi=12, new_hi=12, seed=1234, ramp_requests=80,
        cool_requests=12, timeout=60.0, device="cpu")
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        engines, ctls, r = tcapacity._ab_build(args)
        try:
            rng = np.random.RandomState(0)
            hs = [e.submit(rng.randint(0, 211, 6).astype(np.int32), 9)
                  for e in engines for _ in range(2)]
            for h in hs:
                assert h.wait(60) and h.outcome == "completed"
        finally:
            r.stop()
            for ctl in ctls:
                ctl.stop()
    finally:
        torch.set_num_threads(prev)
    assert len(seen) == 2, seen
    assert all(n <= 4 // 2 for n in seen.values()), seen


def test_ab_needs_the_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcapacity.main(["--ab", "--out", str(tmp_path / "c.json")])
