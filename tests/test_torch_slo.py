"""Port parity, request-level serving observability: singa_tpu_torch.slo
and the engine's request timelines against singa_tpu.slo and
singa_tpu.engine.

- The pure functions (objective_good, attainment, burn_rate,
  attribute_timeline, attribute_route, tail_summary, the multi-window
  gate on a synthetic violation sequence, the trace builder, ...) take
  the same inputs in both packages and give equal outputs (floats rtol
  1e-9): one parametrised test, a case per function (the cases of
  tests/test_slo.py).
- Engine cases queue the same requests before `start()` in both packages
  (tests/test_torch_moe_serving.py's pattern), so both batch the same
  rows: each request's phase sequence and info, outcome and synthetic
  flag, and `report()`'s counts are equal, times and thread ids left
  out.
- A FaultPlan delay on "serving.engine_step" trips KIND_SLO on the port's
  engine; the read surfaces never advance `sustain`.
- `serving.poisson_workload` is byte-equal to JAX's for three seeds.
- `engine_trace_events` passes the ported `_check_flow_trace`, and the
  dense, speculative and beam paths feed the tracker one record per
  sequence of a call.
- One `slo --ab --device cpu` run at the CLI's defaults (the JAX test
  sizes) holds its record's `ok`; a `cuda` run without a card raises.
"""

import json
import math
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import engine as jengine
from singa_tpu import health as jhealth
from singa_tpu import models as jmodels
from singa_tpu import observe as jobserve
from singa_tpu import resilience as jres
from singa_tpu import serving as jserving
from singa_tpu import slo as jslo
from singa_tpu import tensor as jtensor
from singa_tpu_torch import engine as tengine
from singa_tpu_torch import health as thealth
from singa_tpu_torch import observe as tobserve
from singa_tpu_torch import resilience as tres
from singa_tpu_torch import serving as tserving
from singa_tpu_torch import slo as tslo
from singa_tpu_torch.models import transformer as tt

import torch_ab

torch.set_num_threads(2)
SMALL = dict(vocab_size=97, max_seq=64, dim=64, num_heads=4, num_layers=2)

JAX = types.SimpleNamespace(slo=jslo, health=jhealth, observe=jobserve,
                            engine=jengine)
PORT = types.SimpleNamespace(slo=tslo, health=thealth, observe=tobserve,
                             engine=tengine)


def _port_clean():
    tslo.reset()
    tengine.reset()
    tengine.clear_request_listeners()
    thealth.set_active_monitor(None)
    tres.clear_fault_plan()


@pytest.fixture(autouse=True)
def _port_state():
    _port_clean()
    tobserve.get_registry().reset()
    tobserve.enable(True)
    yield
    _port_clean()
    jslo.reset()
    jres.clear_fault_plan()
    tobserve.enable(True)


def _eq(a, b, path="out"):
    """Structural equality, floats at rtol 1e-9 (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            _eq(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), \
            (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(a, bool):
        assert isinstance(b, (int, float)), (path, a, b)
        assert (math.isnan(a) and math.isnan(b)) or \
            b == pytest.approx(a, rel=1e-9, abs=1e-12), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _rec(ts=0.0, outcome="completed", ttft=0.01, total=0.1, rate=100.0):
    return {"ts": ts, "outcome": outcome, "ttft_s": ttft,
            "total_s": total, "tokens_per_sec": rate}


# ---- the pure functions, one case each -------------------------------------

def case_enums(p):
    return (p.slo.REQUEST_PHASES, p.slo.SLO_OBJECTIVES, p.slo.LATENCY_ATTR,
            p.health.POLICIES, p.health.KIND_SLO)


def case_objective_good(p):
    cfg = p.slo.SLOConfig(ttft_p99_s=0.1, latency_p99_s=1.0,
                          availability=0.99, min_tokens_per_sec=10.0)
    recs = [_rec(), _rec(ttft=0.2), _rec(outcome="timeout", ttft=None),
            _rec(outcome="completed", ttft=None),
            _rec(outcome="rejected", ttft=None), _rec(outcome="evicted"),
            _rec(outcome="evicted", total=9.0), _rec(total=2.0),
            _rec(rate=1.0), _rec(total=None), _rec(rate=None)]
    return [[p.slo.objective_good(o, r, cfg) for o in p.slo.SLO_OBJECTIVES]
            for r in recs]


def case_attainment(p):
    cfg = p.slo.SLOConfig(ttft_p99_s=0.1, availability=0.9,
                          latency_p99_s=0.5, window_s=100.0,
                          fast_window_s=10.0, slow_window_s=100.0)
    now = 1000.0
    recs = [_rec(ts=now - 1 - i, ttft=0.2 if i < 50 else 0.01,
                 total=0.3 + 0.01 * i,
                 outcome="timeout" if i % 17 == 0 else "completed")
            for i in range(100)]
    return [p.slo.attainment(recs, cfg, now=now),
            p.slo.attainment(recs, cfg, now=now, window_s=5.0),
            p.slo.attainment(recs, cfg, now=now + 10_000),
            p.slo.attainment(recs, cfg)]


def case_burn_rate(p):
    return [p.slo.burn_rate(a, t) for a, t in (
        (0.5, 0.99), (1.0, 0.99), (None, 0.99), (0.9, 1.0), (0.97, 0.9),
        (0.0, 0.5))]


def case_phase_durations(p):
    tl = {"events": [("submit", 0.0, None), ("queue", 0.01, None),
                     ("admit", 0.03, None), ("decode", 0.05, None),
                     ("decode", 0.04, None), ("terminal", 0.2, None)]}
    return [p.slo.phase_durations(tl), p.slo.phase_durations({})]


def case_attribute_timeline(p):
    evs = [("submit", 0.00, None), ("queue", 0.01, None),
           ("admit", 0.03, None), ("first_token", 0.05, None),
           ("decode", 0.06, None), ("decode", 0.07, None),
           ("decode", 0.18, None), ("terminal", 0.19, None)]
    return [p.slo.attribute_timeline({"events": evs}),
            p.slo.attribute_timeline(
                {"events": [("submit", 0.0, None), ("mystery", 1.0, None),
                            ("terminal", 1.5, None)]}),
            p.slo.attribute_timeline({"events": []}),
            p.slo.attribute_timeline({"events": evs[:5] + evs[-1:]})]


def case_attribute_route(p):
    d = [("dispatch", 0.1, {"replica": "r0"})]
    f = [("dispatch", 0.1, {"replica": "a"}),
         ("failover", 0.5, {"probe_s": 0.2, "pending": True}),
         ("dispatch", 0.6, {"replica": "b"})]
    g = [f[0], ("failover", 0.5, {"probe_s": 0.2, "pending": False}), f[2]]
    return [p.slo.attribute_route(10.0, 10.5, []),
            p.slo.attribute_route(0.0, 1.1, d, replica_attr={
                "prefill": 0.3, "decode": 0.5}),
            p.slo.attribute_route(0.0, 1.1, d, replica_attr={
                "prefill": 0.3, "decode": 5.0}),
            p.slo.attribute_route(0.0, 1.0, f),
            p.slo.attribute_route(0.0, 1.0, g)]


def case_tail_summary(p):
    p.slo.tail_reset()
    for i in range(20):
        p.slo.note_attribution(
            {"id": i, "outcome": "completed", "total_s": 0.1,
             "attr": {"decode": 0.08, "prefill": 0.02}})
    p.slo.note_attribution(
        {"id": 99, "outcome": "completed", "total_s": 2.0,
         "attr": {"decode": 0.08, "decode_stall": 1.92, "martian": 0.1}})
    out = [p.slo.tail_summary(), p.slo.tail_report(),
           p.slo.tail_json()["summary"], p.slo.tail_records()[-1],
           p.observe.get_registry().get("singa_tail_seconds_total")
           .value(attr="other")]
    p.slo.tail_reset()
    return out + [p.slo.tail_report()]


def _gate(p):
    """The multi-window gate on a synthetic violation sequence
    (tests/test_slo.py's), with the process monitor set."""
    mon = p.health.HealthMonitor(policy="warn")
    p.health.set_active_monitor(mon)
    clock = [1000.0]
    cfg = p.slo.SLOConfig(ttft_p99_s=0.1, window_s=100.0,
                          fast_window_s=10.0, slow_window_s=100.0,
                          burn_threshold=2.0, sustain=2, min_requests=3,
                          eval_interval_s=1e9)
    tr = p.slo.SLOTracker(cfg, clock=lambda: clock[0])
    verdicts = []
    for i in range(20):
        tr.note_record(_rec(ts=960.0 + i * 0.5, ttft=0.5))
    for i in range(5):
        tr.note_record(_rec(ts=995.0 + i, ttft=0.01))
    verdicts.append(tr.evaluate(now=clock[0]))
    for i in range(5):
        tr.note_record(_rec(ts=996.0 + i, ttft=0.5))
    verdicts += [tr.evaluate(now=clock[0]) for _ in range(3)]
    clock[0] = 1200.0
    for i in range(10):
        tr.note_record(_rec(ts=1190.0 + i, ttft=0.01))
    verdicts.append(tr.evaluate(now=clock[0]))
    for i in range(10):
        tr.note_record(_rec(ts=1195.0 + i * 0.5, ttft=0.5))
    verdicts += [tr.evaluate(now=clock[0]) for _ in range(2)]
    reg = p.observe.get_registry()
    counts = (reg.get("singa_health_anomaly_total").value(kind="slo"),
              reg.get("singa_slo_breach_total").value(objective="ttft_p99"),
              reg.get("singa_slo_violations_total")
              .value(objective="ttft_p99"),
              reg.get("singa_slo_evaluations_total").value(),
              reg.get("singa_slo_burn_rate_slow")
              .value(objective="ttft_p99"),
              reg.get("singa_slo_error_budget_remaining")
              .value(objective="ttft_p99"))
    p.health.set_active_monitor(None)
    return verdicts, counts, mon.last_action, len(tr.violations()), \
        tr.breaching(), tr.window_records(now=1200.0, window_s=20.0)


def case_multiwindow_gate(p):
    return _gate(p)


def case_tracker_policy_and_report(p):
    tr = p.slo.SLOTracker(p.slo.SLOConfig(ttft_p99_s=0.1, availability=0.9,
                                          eval_interval_s=1e9),
                          policy="halt", clock=lambda: 100.0)
    tr.note_record(_rec(ts=99.0))
    tr.note_record(_rec(ts=99.5, ttft=0.5, outcome="timeout"))
    v = tr.evaluate(now=100.0)
    with pytest.raises(ValueError):
        p.slo.SLOTracker(policy="skip_step")
    tr.install()
    rep, js = p.slo.slo_report(), p.slo.slo_json()
    p.slo.reset()
    # the no-tracker line names each package's own module
    none = p.slo.slo_report().replace("singa_tpu_torch.", "singa_tpu.")
    return (v, tr.config.snapshot(), tr.config.enabled(), rep,
            js["config"], js["verdict"]["objectives"], none,
            p.slo.slo_json())


def case_request_latency_sample(p):
    base = {"outcome": "completed", "ttft_s": 0.05, "total_s": 0.5,
            "new_tokens": 10}
    return [p.slo.request_latency_sample(None, tl) for tl in (
        base, dict(base, synthetic=True), dict(base, outcome="timeout"),
        dict(base, ttft_s=None), dict(base, new_tokens=1), {})]


def _timelines():
    return [{"id": 3, "outcome": "completed", "trace": "tabc-3", "slot": 1,
             "prompt_tokens": 6, "new_tokens": 5, "syncs": [1, 2],
             "events": [("submit", 1.00, None), ("queue", 1.001, None),
                        ("admit", 1.02, None), ("prefill", 1.021, None),
                        ("first_token", 1.05, None),
                        ("decode", 1.07, {"tokens": 3, "sync": 1}),
                        ("decode", 1.09, {"tokens": 5, "sync": 2}),
                        ("terminal", 1.10, {"outcome": "completed"})]},
            {"id": 4, "outcome": "rejected", "trace": "tabc-4",
             "events": [("submit", 2.0, None), ("terminal", 2.1, None)]},
            {"id": 5, "outcome": None, "slot": 0, "syncs": [],
             "events": [("submit", 3.0, None), ("admit", 3.1, None)]}]


def case_request_trace_events(p):
    syncs = [{"sync": 1, "t0": 1.06, "dur": 0.015, "tid": 77, "slots": 1,
              "steps": 2, "tokens": 2},
             {"sync": 2, "t0": 1.08, "dur": 0.015, "tid": 77, "slots": 1,
              "steps": 2, "tokens": 2}]
    return [p.slo.request_trace_events(_timelines(), syncs, pid=4242,
                                       offset=0.5),
            p.slo.request_trace_events(_timelines(), syncs, pid=9,
                                       emit_sync_slices=False),
            p.slo._track_metadata(_timelines(), syncs, 4242, "w0"),
            p.slo.flow_event_id(4242, 3)]


def case_serve_attainment_pct(p):
    return [p.slo.serve_attainment_pct(s) for s in (
        None, {}, {"slo": None},
        {"slo": {"objectives": {"a": {"attainment": 0.98765},
                                "b": {"attainment": None},
                                "c": {"attainment": 0.5}}}})]


def case_note_decode(p):
    clock = [50.0]
    tr = p.slo.SLOTracker(p.slo.SLOConfig(latency_p99_s=1.0,
                                          min_tokens_per_sec=5.0,
                                          eval_interval_s=1e9),
                          clock=lambda: clock[0]).install()
    p.slo.tail_reset()
    p.slo.note_decode("greedy", 0.5, 12, ttft=0.1, batch=3)
    p.slo.note_decode("beam", 2.0, 4, batch=1)
    p.slo.note_decode("spec", 0.0, 4)
    out = (tr.window_records(now=50.0), p.slo.tail_records(),
           tr.evaluate(now=50.0))
    p.slo.reset()
    return out


def case_pctile(p):
    return [p.engine.pctile(xs, q) for xs in ([], [3.0], [5, 1, 4, 2, 3])
            for q in (0.0, 0.5, 0.99, 1.0)]


PURE = {n[len("case_"):]: f for n, f in sorted(globals().items())
        if n.startswith("case_")}


@pytest.mark.parametrize("name", sorted(PURE))
def test_pure_functions_match_jax(name):
    tobserve.get_registry().reset()
    jobserve.get_registry().reset()
    want = PURE[name](JAX)
    got = PURE[name](PORT)
    _eq(want, got)


# ---- the engine: timelines against JAX's ------------------------------------

def _pair():
    jm = jmodels.create_model("gpt", **SMALL)
    ids = np.random.RandomState(0).randint(0, 97, (2, 8)).astype(np.int32)
    jm.compile([jtensor.from_numpy(ids, device=jdevice.best_device())],
               is_train=False, use_graph=False)
    jm.eval()
    tm = tt.GPT(**SMALL, device="cpu")
    tt.load_singa_params(
        tm, {k: jtensor.to_numpy(v) for k, v in jm.get_params().items()})
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


SPECS = [(5, 6), (16, 9), (1, 4), (17, 12), (8, 1), (30, 13)]


def _serve(eng_mod, e, reqs_in, synthetic=()):
    """Queue every request, then start the decode thread (both packages
    then batch the same rows); an over-length request submitted after
    the start is rejected. Returns the handles and the timelines."""
    reqs = [eng_mod.EngineRequest(i, np.asarray(p, np.int32), mn, None,
                                  None) for i, (p, mn) in enumerate(reqs_in)]
    for i in synthetic:
        reqs[i].synthetic = True
    e._queue.extend(reqs)
    e.start()
    try:
        rej = e.submit(np.ones(70, np.int32), 2)
        for r in reqs:
            assert r.wait(300), f"request {r.id} never finished"
        tls = e.timelines()
        rep = e.report()
        syncs = e.sync_records()
    finally:
        e.stop()
    return reqs + [rej], tls, rep, syncs


def _shape(tl):
    """A timeline without its times: the phases with their info."""
    return {k: v for k, v in tl.items()
            if k not in ("events", "ttft_s", "total_s", "tokens_per_sec",
                         "queue_delay_s", "id")} | {
        "events": [(ph, info) for ph, _, info in tl["events"]]}


def test_engine_timelines_match_jax(pair):
    jm, tm = pair
    rng = np.random.RandomState(1)
    reqs_in = [(rng.randint(0, 97, (s0,)), mn) for s0, mn in SPECS]
    kw = dict(max_slots=3, page_size=8, max_ctx=64, steps_per_sync=2)
    want, wtl, wrep, wsync = _serve(jengine, jengine.ServingEngine(jm, **kw),
                                    reqs_in, synthetic=(2,))
    got, gtl, grep_, gsync = _serve(tengine, tengine.ServingEngine(tm, **kw),
                                    reqs_in, synthetic=(2,))
    for w, g in zip(want, got):
        assert (g.outcome, g.synthetic, g.tokens) == \
            (w.outcome, w.synthetic, w.tokens)
        assert [(ph, info) for ph, _, info in g.events] == \
            [(ph, info) for ph, _, info in w.events]
        assert g.syncs == w.syncs
        stamps = [t for _, t, _ in g.events]
        assert stamps == sorted(stamps)
    assert [_shape(t) for t in gtl] == [_shape(t) for t in wtl]
    assert "rejected" in [t["outcome"] for t in gtl]
    assert any(t["synthetic"] for t in gtl)
    for k in ("slots", "active", "queue_depth", "pages_total",
              "pages_in_use", "page_size", "steps", "finished", "kv_dtype",
              "max_ctx", "spec_k", "spec"):
        assert grep_[k] == wrep[k], k
    assert set(grep_) == set(wrep)
    assert grep_["ttft_p50_s"] is not None and grep_["rps"] > 0
    assert grep_["decode_tok_s"] > 0
    # the sync ring: the same syncs, slots, steps and tokens
    strip = [{k: s[k] for k in ("sync", "slots", "steps", "tokens")}
             for s in gsync]
    assert strip == [{k: s[k] for k in ("sync", "slots", "steps", "tokens")}
                     for s in wsync]
    for s in gsync:
        assert s["dur"] >= 0 and s["tid"] == gsync[0]["tid"]


def test_trace_flow_links_and_check_flow_trace(pair):
    """The exported trace passes `_check_flow_trace` (the port's copy,
    and JAX's on the port's engine), a request's flow events (s -> t* ->
    f) each land inside a serving.engine_step slice, and each sync's
    window lies inside its serving.engine_step span."""
    _, tm = pair
    tobserve.enable_span_records()
    e = tengine.ServingEngine(tm, max_slots=2, page_size=8, max_ctx=64,
                              steps_per_sync=2).start()
    try:
        rng = np.random.RandomState(1)
        hs = [e.submit(rng.randint(0, 97, (5,)), 8) for _ in range(2)]
        hs.append(e.submit(rng.randint(0, 97, (6,)), 9))
        for h in hs:
            assert h.wait(300) and h.outcome == "completed"
        trace = tslo.engine_trace_events(e)
        for check in (tslo._check_flow_trace, jslo._check_flow_trace):
            res = check(trace, e)
            assert res["schema_ok"] and res["flow_ok"], res
        tl = next(t for t in e.timelines() if t["syncs"])
        fid = tslo.flow_event_id(os.getpid(), tl["id"])
        flows = [ev for ev in trace["traceEvents"]
                 if ev.get("cat") == "req_flow" and ev.get("id") == fid]
        assert [ev["ph"] for ev in flows] == \
            ["s"] + ["t"] * (len(flows) - 2) + ["f"]
        assert len(flows) - 1 == len(tl["syncs"])
        names = {ev["args"]["name"] for ev in trace["traceEvents"]
                 if ev["ph"] == "M" and ev["name"] == "thread_name"}
        assert "serve queue" in names
        spans = [r for r in tobserve.span_records()
                 if r["name"] == "serving.engine_step"]
        syncs = e.sync_records()
        assert len(spans) == len(syncs)
        for s, r in zip(syncs, spans):
            assert r["t0"] <= s["t0"] and \
                s["t0"] + s["dur"] <= r["t0"] + r["dur"] + 1e-6
        path = tslo.export_trace(os.path.join(
            os.environ.get("TMPDIR", "/tmp"), f"slo_trace_{os.getpid()}"
            ".json"), e)
        assert os.path.getsize(path) > 0
        os.remove(path)
    finally:
        e.stop()
        tobserve.disable_span_records()


def test_degraded_engine_trips_kind_slo_and_reads_do_not_advance(pair):
    """A FaultPlan delay on serving.engine_step stalls every sync, so the
    queued requests' TTFT degrades past the target: the tracker breaches
    within sustain + 3 evaluations and feeds KIND_SLO to the monitor;
    report, json and snapshot reads in between never advance the
    sustain count."""
    _, tm = pair
    mon = thealth.HealthMonitor(policy="warn")
    thealth.set_active_monitor(mon)
    cfg = tslo.SLOConfig(ttft_p99_s=0.04, window_s=60.0, fast_window_s=5.0,
                         slow_window_s=30.0, burn_threshold=2.0, sustain=2,
                         min_requests=3, eval_interval_s=1e9)
    tracker = tslo.SLOTracker(cfg).install()
    plan = tres.FaultPlan().delay("serving.engine_step", 0.12,
                                  times=10 ** 9)
    e = tengine.ServingEngine(tm, max_slots=1, page_size=8, max_ctx=64,
                              steps_per_sync=1).start()
    try:
        buckets, first = e.prewarm([4, 5], max_new=2, timeout_s=300)
        assert buckets == [16] and first > 0
        assert tracker.window_records(window_s=1e9) == []  # synthetic
        tracker.evaluate()   # the first verdict: the reads below reuse it
        rng = np.random.RandomState(4)
        tres.install_fault_plan(plan)
        e.submit(rng.randint(0, 97, (5,)), 24)
        evals_to_breach = None
        for n in range(1, 7):
            h = e.submit(rng.randint(0, 97, (4,)), 2)
            assert h.wait(300), h.id
            evals = tracker._evals
            tslo.slo_report()
            tslo.slo_json()
            tslo.fleet_serve_snapshot()
            assert tracker._evals == evals and not tracker.breaching()
            v = tracker.evaluate()
            if v["breaching"]:
                evals_to_breach = n
                break
        assert evals_to_breach is not None, tracker.last_verdict()
        assert evals_to_breach <= cfg.sustain + 3
        assert mon.verdict()["status"] == "warn"
        c = tobserve.get_registry().get("singa_health_anomaly_total")
        assert c.value(kind=thealth.KIND_SLO) == 1
        viol = tracker.violations()
        assert viol and all("ttft_p99" in r["objectives"] for r in viol)
        assert any(r["timeline"] is not None and r["attr"] for r in viol)
        assert plan.count("serving.engine_step") > 0
        assert tobserve.get_registry().get(
            "singa_resilience_faults_injected_total").value(
                kind="delay") == len(plan.fired)
    finally:
        tres.clear_fault_plan()
        e.stop()


def test_clean_engine_attainment_snapshot_and_report(pair):
    _, tm = pair
    mon = thealth.HealthMonitor(policy="warn")
    thealth.set_active_monitor(mon)
    cfg = tslo.SLOConfig(ttft_p99_s=60.0, latency_p99_s=120.0,
                         availability=0.9, eval_interval_s=1e9)
    tracker = tslo.SLOTracker(cfg).install()
    tslo.install_tail()
    e = tengine.ServingEngine(tm, max_slots=2, page_size=8, max_ctx=64,
                              steps_per_sync=2).start()
    try:
        assert tengine.get_engines() == [e]
        rep = tengine.serving_report()
        assert "ttft: no data (0 admitted requests)" in rep
        rng = np.random.RandomState(5)
        hs = [e.submit(rng.randint(0, 97, (6,)), 5) for _ in range(4)]
        for h in hs:
            assert h.wait(300) and h.outcome == "completed"
        rep = tengine.serving_report()
        assert "ttft p50" in rep and "rps" in rep
        v = tracker.evaluate()
        for obj in cfg.enabled():
            assert v["objectives"][obj]["attainment"] == 1.0
        assert not v["breaching"] and mon.last_action is None
        snap = tslo.fleet_serve_snapshot()
        assert snap["engines"] == 1 and snap["slots"] == 2
        assert snap["kv_cache_bytes"] == e.pool_bytes() > 0
        assert snap["finished"]["completed"] == 4
        assert tslo.serve_attainment_pct(snap) == 100.0
        assert e.active_timelines() == []
        recs = tslo.tail_records()
        assert len(recs) == 4
        for r in recs:
            assert sum(r["attr"].values()) == pytest.approx(
                r["total_s"], rel=0.1, abs=0.005)
    finally:
        e.stop()
    assert tengine.get_engines() == []
    tslo.reset()
    assert tslo.fleet_serve_snapshot() is None
    assert tengine.request_listeners() == []


def test_listener_lifecycle_and_errors_swallowed(pair):
    _, tm = pair
    seen = []

    def bad(req, tl):
        raise RuntimeError("listener fault")

    def good(req, tl):
        seen.append((req.id, tl["outcome"], req.done()))

    tengine.add_request_listener(bad)
    tengine.add_request_listener(good)
    assert tengine.request_listeners() == [bad, good]
    t1 = tslo.SLOTracker(tslo.SLOConfig(ttft_p99_s=1.0)).install()
    t2 = tslo.SLOTracker(tslo.SLOConfig(ttft_p99_s=1.0)).install()
    assert tengine.request_listeners() == [bad, good, t2._on_request]
    e = tengine.ServingEngine(tm, max_slots=1, page_size=8, max_ctx=64,
                              steps_per_sync=2).start()
    try:
        h = e.submit(np.arange(1, 6), 3)
        assert h.wait(300) and h.outcome == "completed"
    finally:
        e.stop()
    # the listener ran before the handle's done-event was set
    assert seen == [(h.id, "completed", False)]
    assert len(t2.window_records(window_s=1e9)) == 1
    assert t1.window_records(window_s=1e9) == []
    tengine.remove_request_listener(bad)
    tslo.reset()
    assert tengine.request_listeners() == [good]
    tengine.clear_request_listeners()


def test_timeline_ring_locked_copy_under_concurrent_submit(pair):
    _, tm = pair
    e = tengine.ServingEngine(tm, max_slots=2, page_size=8, max_ctx=64,
                              steps_per_sync=2, timeline_capacity=8,
                              prompt_buckets=[8]).start()
    errors = []

    def submitter():
        try:
            rng = np.random.RandomState(2)
            hs = [e.submit(rng.randint(0, 97, (rng.randint(1, 9),)),
                           int(rng.randint(1, 5))) for _ in range(10)]
            for h in hs:
                if not h.wait(300):
                    errors.append(f"request {h.id} stalled")
        except Exception as exc:
            errors.append(repr(exc))

    t = threading.Thread(target=submitter)
    t.start()
    try:
        deadline = time.monotonic() + 300
        while t.is_alive() and time.monotonic() < deadline:
            tls = e.timelines()
            assert len(tls) <= 8
            for tl in tls:
                assert tl["events"][0][0] == "submit"
                assert tl["events"][-1][0] == "terminal"
            e.sync_records()
            e.active_timelines()
            e.report()
            tslo.engine_trace_events(e)
    finally:
        t.join(timeout=300)
        e.stop()
    assert not errors, errors
    assert len(e.timelines()) == 8


def test_prewarm_raises_on_a_failed_bucket(pair):
    _, tm = pair
    e = tengine.ServingEngine(tm, max_slots=1, page_size=8, max_ctx=64,
                              steps_per_sync=2)
    with pytest.raises(RuntimeError, match="prewarm"):
        e.prewarm([5])   # not started: the request is rejected


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_poisson_workload_byte_equal(seed):
    kw = dict(n_req=16, rps=6.0, vocab=50257, prompt_lens=(64, 256),
              new_lens=(16, 64))
    for dist in ("bimodal", "uniform"):
        w = jserving.poisson_workload(seed, new_dist=dist, **kw)
        g = tserving.poisson_workload(seed, new_dist=dist, **kw)
        assert w.keys() == g.keys()
        assert w["arrivals"].tobytes() == g["arrivals"].tobytes()
        assert w["new_lens"].tobytes() == g["new_lens"].tobytes()
        assert len(w["prompts"]) == len(g["prompts"])
        for a, b in zip(w["prompts"], g["prompts"]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_decode_paths_feed_the_tracker(pair):
    """With a tracker installed and observe disabled, each dense,
    speculative and beam call is one note_decode: one record per
    sequence at the per-request rate, as in JAX."""
    jm, tm = pair
    prompt = np.random.RandomState(6).randint(0, 97, (2, 8))
    counts = {}
    for name, (mod, m) in {"jax": (jslo, jm), "port": (tslo, tm)}.items():
        obs = jobserve if name == "jax" else tobserve
        obs.enable(False)
        tr = mod.SLOTracker(mod.SLOConfig(latency_p99_s=600.0,
                                          eval_interval_s=1e9)).install()
        try:
            m.generate(prompt, 3)
            n1 = len(tr.window_records(window_s=1e9))
            m.generate(prompt, 3, draft_model=m, spec_k=2)
            n2 = len(tr.window_records(window_s=1e9))
            m.generate_beam(prompt, 3, num_beams=2)
            recs = tr.window_records(window_s=1e9)
            counts[name] = (n1, n2, len(recs),
                            [r["outcome"] for r in recs],
                            [r["ttft_s"] is None for r in recs])
            r0 = recs[0]
            assert r0["total_s"] > 0 and r0["tokens_per_sec"] == \
                pytest.approx(3 / r0["total_s"])
        finally:
            mod.reset()
            obs.enable(True)
    assert counts["port"] == counts["jax"]
    assert counts["port"][:3] == (2, 4, 6)
    assert tobserve.get_registry().get("singa_health_nan_logits_total") \
        is None


# ---- the command line --------------------------------------------------------

def test_slo_ab_on_cpu(tmp_path, tmp_path_factory):
    """`slo --ab --device cpu` at the CLI's defaults: the clean leg at 100%
    TTFT attainment and not breaching, the degraded leg breached within
    sustain + 3 evaluations with the monitor at warn, both traces
    schema-valid and the degraded one's flow linked; everything it
    installed is gone after it. It runs in this process (the engine's
    thread beside the test's), on this process's cores, one A/B at a time
    (`torch_ab.one_at_a_time`)."""
    out = str(tmp_path / "SLO_test.json")
    with torch_ab.one_at_a_time(tmp_path_factory):
        rc = tslo.main(["--ab", "--device", "cpu", "--out", out])
    with open(out, encoding="utf-8") as f:
        rec = json.load(f)
    assert rc == 0 and rec["ok"] is True, rec
    assert rec["device"] == "cpu"
    assert rec["clean"]["attainment"]["ttft_p99"] == 100.0
    assert "ttft_p99" in rec["degraded"]["breaching"]
    assert rec["degraded"]["breach_after_evals"] <= rec["max_evals"] == 5
    assert rec["degraded"]["health_status"] == "warn"
    assert rec["degraded"]["trace"]["flow_ok"]
    assert tslo.get_tracker() is None and thealth.active_monitor() is None
    assert tres._fault_plan is None
    assert not [t.name for t in threading.enumerate() if t.is_alive()
                and t.name.startswith(("singa-fleet", "torch-serve"))]


def test_slo_ab_needs_the_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tslo.main(["--ab", "--out", str(tmp_path / "s.json")])
