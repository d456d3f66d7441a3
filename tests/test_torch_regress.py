"""Port parity, the regression observatory: singa_tpu_torch.regress against
singa_tpu.regress.

- Scripted streams fed alike to both packages' detectors (raw `feed`
  samples, span listener calls with the engine's attrs, terminal-request
  timelines, planted builds and blames, a prior incarnation's baseline
  file, a fleet spool): the freeze, conviction, recovery and attribution
  verdicts, `signal_state`, `snapshot()`, `regress_report()`,
  `regress_json()`, `fleetz_lines()` and the fleet snapshot and vote are
  equal, times, pids and paths left out. One outlier window convicts in
  both (the CUSUM's score stays past h for `sustain` windows). The baseline files hold the same
  entries. Every bundle loads in both packages' `health.load_flight_bundle`
  with the same line kinds and header keys.
- The port taints a sample whose span encloses `model.build` (its
  graph-mode step's warm-up and capture), as JAX's does `introspect.build`.
- /regressz and /statusz answer with JAX's status codes, bare and
  installed; the port's shard carries the `fleet_regress` line.
- One `regress --ab --device cpu` run holds its record's `ok` (both legs
  convicted with their causes, zero false positives in the clean arms);
  a `cuda` run without a card raises.
"""

import json
import os
import time
import urllib.error
import urllib.request

import pytest
import torch

from singa_tpu import diag as jdiag
from singa_tpu import fleet as jfleet
from singa_tpu import health as jhealth
from singa_tpu import introspect as jintro
from singa_tpu import observe as jobserve
from singa_tpu import regress as jregress
from singa_tpu_torch import diag as tdiag
from singa_tpu_torch import fleet as tfleet
from singa_tpu_torch import health as thealth
from singa_tpu_torch import introspect as tintro
from singa_tpu_torch import observe as tobserve
from singa_tpu_torch import regress as tregress

import torch_ab

PKGS = {"jax": (jregress, jintro, jfleet, jhealth, jdiag, jobserve),
        "port": (tregress, tintro, tfleet, thealth, tdiag, tobserve)}


def _clean():
    for reg, intro, fl, _, dg, obs in PKGS.values():
        reg.reset()
        intro.reset()
        fl.uninstall()
        dg.stop_diag_server()
        obs.get_registry().reset()
        obs.enable(True)


@pytest.fixture(autouse=True)
def _state():
    _clean()
    yield
    _clean()


def _detector(reg, out_dir, store=None, **kw):
    kw.setdefault("warmup_samples", 8)
    kw.setdefault("window", 4)
    kw.setdefault("sustain", 2)
    return reg.RegressionDetector(store, out_dir=str(out_dir), **kw)


_TIMES = {"ts", "pid", "bundle", "store_path", "bundles"}


def _strip(x):
    """Times, pids and paths left out, recursively."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in _TIMES}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _plant_build(intro, key, fingerprint):
    intro._manifest.append({"key": key, "fingerprint": fingerprint,
                            "hlo_path": None, "ts": round(time.time(), 6)})


def _feed_until(det, fn, n, stop=lambda d: False):
    for i in range(n):
        fn(i)
        if stop(det):
            return


# ---- the scripts --------------------------------------------------------------
# each takes (package modules, detector) and drives it

def _warm(det, signal="model.step", value=0.01):
    for _ in range(det.warmup_samples):
        det.feed(signal, value)


def s_unknown_then_recover(m, det):
    _warm(det)
    _feed_until(det, lambda i: det.feed("model.step", 0.03), 64,
                lambda d: d.verdicts())
    for _ in range(4 * det.window):
        det.feed("model.step", 0.01)


def s_straggler_and_zcap(m, det):
    _warm(det, value=0.01)
    for i in range(6 * det.window):
        det.feed("model.step", 5.0 if i == 5 else 0.01)
    det.feed("model.step", 100.0)
    for _ in range(det.window - 1):
        det.feed("model.step", 100.0)


def s_contention_spans(m, det):
    for _ in range(det.warmup_samples):
        det._on_span("serving.engine_step", 0.01, {"queue": 0, "slots": 2})
        det._on_span("serving.engine_prefill", 0.004, {"bucket": 16})
    _feed_until(det, lambda i: det._on_span(
        "serving.engine_step", 0.03, {"queue": 8, "slots": 2}), 64,
        lambda d: d.verdicts())


def s_workload_shift(m, det):
    def req(ttft, tokens):
        det._on_request(None, {"outcome": "completed", "ttft_s": ttft,
                               "total_s": ttft + 0.01 * tokens,
                               "new_tokens": tokens})
    for _ in range(det.warmup_samples):
        req(0.01, 10)
    det._on_request(None, {"outcome": "evicted", "ttft_s": 9.0})
    det._on_request(None, {"outcome": "completed", "ttft_s": 9.0,
                           "synthetic": True})
    _feed_until(det, lambda i: req(0.05, 40), 64,
                lambda d: any(v["signal"] == "request.ttft"
                              for v in d.verdicts()))


def s_compile(m, det):
    intro = m[1]
    _plant_build(intro, "step", "fpA")
    _warm(det)
    intro._blames.append({"key": "step", "reason": "batch_bucket",
                          "detail": "8->64", "fingerprint": "fpB",
                          "ts": round(time.time(), 6)})
    _plant_build(intro, "step", "fpB")
    _feed_until(det, lambda i: det.feed("model.step", 0.03), 64,
                lambda d: d.verdicts())


def s_taint_and_tags(m, det):
    for i in range(det.warmup_samples + 2):
        if i % 3 == 0:
            det._on_span("model.step/introspect.build", 0.5, {})
            det._on_span("model.step", 0.9, {"tag": 0})
        det._on_span("model.step", 0.01, {"tag": 0})
        det._on_span("model.step", 0.02, {"tag": 1})
    det._on_span("other.span", 0.5, {})


def s_one_outlier_window(m, det):
    # one window at 1.25x the baseline (z 5 at the 5% sigma floor) takes
    # the CUSUM past h at once; it decays by only k a window, so the next
    # window, at 1.03x, completes `sustain` and convicts at x1.03
    _warm(det, value=0.01)
    for _ in range(det.window):
        det.feed("model.step", 0.0125)
    for _ in range(det.window):
        det.feed("model.step", 0.0103)


S_SCRIPTS = {"unknown_then_recover": s_unknown_then_recover,
             "one_outlier_window": s_one_outlier_window,
             "straggler_and_zcap": s_straggler_and_zcap,
             "contention_spans": s_contention_spans,
             "workload_shift": s_workload_shift,
             "compile": s_compile, "taint_and_tags": s_taint_and_tags}


def _run(name, script, tmp_path, store_lines=None, install=True):
    """The script on package `name`'s detector: its normalized results."""
    reg, intro, fl, health, _, _ = m = PKGS[name]
    out = tmp_path / name
    out.mkdir(parents=True, exist_ok=True)
    store = None
    if store_lines is not None:
        path = out / "baselines.jsonl"
        path.write_text("".join(json.dumps(x) + "\n" for x in store_lines))
        store = reg.BaselineStore(str(path))
    det = _detector(reg, out, store)
    if install:
        det.install()
    script(m, det)
    res = {"verdicts": _strip(det.verdicts()),
           "snapshot": _strip(det.snapshot()),
           "signals": {s["signal"]: _strip(det.signal_state(s["signal"]))
                       for s in det.snapshot()["signals"]},
           "report": reg.regress_report(),
           "json": _strip(reg.regress_json()),
           "fleetz": reg.fleetz_lines(),
           "fleet": _strip(reg.fleet_regress_snapshot()),
           "vote": reg.fleet_regress_vote(),
           "bundles": [os.path.basename(b) for b in det.bundles()]}
    res["bundle_paths"] = det.bundles()
    if store is not None:
        res["store"] = [_strip(json.loads(x)) for x in
                        (out / "baselines.jsonl").read_text().splitlines()]
    reg.reset()
    return res


def _equal(tmp_path, script, **kw):
    got = {n: _run(n, script, tmp_path, **kw) for n in PKGS}
    paths = {n: got[n].pop("bundle_paths") for n in got}
    assert got["port"] == got["jax"]
    for name, (_, _, _, health, _, _) in PKGS.items():
        for mine in paths.values():
            for path in mine:
                b = health.load_flight_bundle(path)
                assert b["header"]["reason"] == "regression", (name, path)
                assert isinstance(b["header"]["verdict"], dict)
                assert len(b["steps"]) > 0
    for pj, pp in zip(paths["jax"], paths["port"]):
        kinds = [[json.loads(x)["kind"] for x in open(p)] for p in (pj, pp)]
        assert kinds[0] == kinds[1]
        heads = [set(json.loads(open(p).readline())) for p in (pj, pp)]
        assert heads[0] == heads[1]
    return got["port"]


@pytest.mark.parametrize("name", sorted(S_SCRIPTS))
def test_scripted_streams_equal_jax(tmp_path, name):
    got = _equal(tmp_path, S_SCRIPTS[name])
    want_cause = {"unknown_then_recover": "unknown",
                  "one_outlier_window": "unknown",
                  "contention_spans": "contention",
                  "workload_shift": "workload_shift",
                  "compile": "compile"}.get(name)
    if want_cause:
        assert got["verdicts"] and got["verdicts"][0]["cause"] == want_cause
    else:
        assert not got["verdicts"]
    if name == "one_outlier_window":
        assert [(v["window"], v["ratio"]) for v in got["verdicts"]] \
            == [(2, 1.03)]
    if name == "unknown_then_recover":
        assert got["snapshot"]["active"] == []
        assert got["signals"]["model.step"]["state"] == "ok"
    if name == "taint_and_tags":
        assert set(got["signals"]) == {"model.step", "model.step.t1"}
        assert got["signals"]["model.step"]["baseline_median_s"] == 0.01


def test_restart_regression_and_store_files_equal(tmp_path):
    prior = [{"kind": "baseline", "signal": "model.step", "median_s": 0.01,
              "mad_s": 0.0, "n": 8, "fingerprint": "fpA", "pid": 1,
              "ts": 1.0},
             "garbage", {"kind": "other"},
             {"kind": "baseline", "signal": "engine.step", "median_s": 0.01,
              "mad_s": 0.0, "n": 8, "fingerprint": "fpX", "pid": 1,
              "ts": 1.0}]

    def script(m, det):
        _plant_build(m[1], "step", "fpA")
        _plant_build(m[1], "serving.engine_step", "fpY")
        _warm(det, value=0.03)
        _warm(det, signal="engine.step", value=0.05)

    got = _equal(tmp_path, script, store_lines=prior)
    [v] = got["verdicts"]
    assert v["restart"] is True and v["signal"] == "model.step"
    assert v["ratio"] == 3.0
    assert [e["signal"] for e in got["store"][-2:]] == ["model.step",
                                                        "engine.step"]


def _write_regress_shard(spool, host, pid, active):
    """One worker shard with a fleet_regress line (tests/test_regress.py's
    hand-built shard), in the format both packages read."""
    os.makedirs(spool, exist_ok=True)
    rows = [
        {"kind": "fleet_shard_header", "version": 1, "seq": 1,
         "host": host, "pid": pid, "ts": time.time(),
         "perf": time.perf_counter(), "started_ts": 0.0, "steps": 10},
        {"kind": "fleet_regress",
         "regress": {"signals": 2, "baselines": 2, "active": active,
                     "active_signals": ["engine.step"] if active else [],
                     "verdicts": active, "windows": 20,
                     "last": {"signal": "engine.step", "cause": "unknown",
                              "ratio": 2.5, "restart": False,
                              "ts": 12.5} if active else None}},
    ]
    path = os.path.join(spool, f"worker_{pid}" + jfleet.SHARD_SUFFIX)
    with open(path, "w", encoding="utf-8") as f:
        for rec in rows:
            f.write(json.dumps(rec) + "\n")


@pytest.mark.parametrize("actives", [(0, 1, 0), (1, 1, 1), (1, 0)])
def test_fleet_vote_and_host_attribution_equal_jax(tmp_path, actives):
    spool = str(tmp_path / "spool")
    for i, a in enumerate(actives):
        _write_regress_shard(spool, f"host{i}", 100 + i, a)

    def script(m, det):
        m[2].install_aggregator(spool, stale_after_s=600.0).poll()
        _warm(det)
        _feed_until(det, lambda i: det.feed("model.step", 0.03), 64,
                    lambda d: d.verdicts())

    got = _equal(tmp_path, script)
    want = {(0, 1, 0): "host", (1, 1, 1): "unknown", (1, 0): "unknown"}
    assert got["verdicts"][0]["cause"] == want[actives]
    assert got["fleetz"][0] == "== fleet regress =="


def test_bare_reports_and_snapshots():
    assert tregress.regress_report() == jregress.regress_report().replace(
        "singa_tpu.regress", "singa_tpu_torch.regress")
    assert tregress.regress_json() == jregress.regress_json() \
        == {"installed": False}
    assert tregress.fleet_regress_snapshot() is None
    assert tregress.fleetz_lines() == jregress.fleetz_lines() == []
    assert tregress.REGRESS_CAUSES == jregress.REGRESS_CAUSES


def test_health_note_and_metrics_equal(tmp_path):
    notes = {}
    for name, (reg, _, _, health, _, obs) in PKGS.items():
        mon = health.HealthMonitor(out_dir=str(tmp_path / name / "flight"))
        health.set_active_monitor(mon)
        try:
            det = _detector(reg, tmp_path / name).install()
            _warm(det)
            _feed_until(det, lambda i: det.feed("model.step", 0.03), 64,
                        lambda d: d.verdicts())
            v = mon.verdict()
            notes[name] = [(v["status"], _strip(v["last_step"]))]
            r = obs.get_registry()
            notes[name].append((
                r.get("singa_regress_verdicts_total").value(cause="unknown"),
                r.get("singa_regress_windows_total").value(),
                r.get("singa_regress_bundles_total").value()))
        finally:
            health.set_active_monitor(None)
            reg.reset()
    assert notes["port"] == notes["jax"]
    assert notes["port"][0][0] == "warn"
    assert notes["port"][0][1]["external"] == "regression"


def _get(url):
    try:
        r = urllib.request.urlopen(url, timeout=60)
        return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_endpoints_and_shard_line(tmp_path):
    codes = {}
    for name, (reg, _, fl, _, dg, _) in PKGS.items():
        srv = dg.start_diag_server(port=0)
        try:
            c = [_get(srv.url + p)[0]
                 for p in ("/regressz", "/regressz?json=1", "/statusz")]
            det = _detector(reg, tmp_path / name).install()
            _warm(det)
            c += [_get(srv.url + p)[0]
                  for p in ("/regressz", "/regressz?json=1", "/statusz")]
            st, body = _get(srv.url + "/statusz")
            assert "== regress ==" in body and "model.step" in body
            w = fl.ShardWriter(str(tmp_path / name / "spool"), interval_s=0,
                               host="hostA", name="worker_a")
            w.publish()
            for rfl in (jfleet, tfleet):
                assert rfl.read_shard(w.path)["regress"]["baselines"] == 1
            w.close(final_publish=False)
            codes[name] = c
        finally:
            reg.reset()
            dg.stop_diag_server()
    assert codes["port"] == codes["jax"] == [503, 503, 200, 200, 200, 200]


# ---- the command line --------------------------------------------------------

def test_regress_ab_on_cpu(tmp_path, tmp_path_factory, monkeypatch):
    """`regress --ab --device cpu` at the CLI's defaults: both legs
    convicted with their causes within 5 windows, zero false positives,
    a bundle that round-trips, the baselines persisted beside the record.
    Its engine and model run in this process on its last two cores, one
    A/B at a time (`torch_ab.two_cores`): the clean arms' gate reads
    millisecond step times."""
    out = str(tmp_path / "REGRESS_test.json")
    with torch_ab.two_cores(tmp_path_factory, monkeypatch):
        rc = tregress.main(["--ab", "--device", "cpu", "--out", out])
    with open(out, encoding="utf-8") as f:
        lines = [json.loads(x) for x in f if x.strip()]
    rec = lines[-1]
    assert rc == 0 and rec["ok"] is True, json.dumps(rec)
    assert rec["device"] == "cpu" and rec["false_positives"] == 0
    assert rec["serving"]["cause"] == "contention"
    assert rec["training"]["cause"] == "compile"
    assert os.path.isfile(tmp_path / "REGRESS_torch_baselines.jsonl")
    assert {m["metric"] for m in lines[:-1]} == {
        "regress_contention_detect_windows",
        "regress_compile_detect_windows", "regress_false_positives",
        "regress_bundle_roundtrip"}
    b = jhealth.load_flight_bundle(rec["serving"]["bundle"])
    assert b["header"]["cause"] == "contention"


def test_ab_needs_the_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tregress.main(["--ab", "--out", str(tmp_path / "r.json")])


def test_model_build_taints_the_step_sample(tmp_path):
    """The port's graph-mode step builds (warm-up, capture) under
    `model.build` inside its `model.step` span: that sample is tainted."""
    det = _detector(tregress, tmp_path)
    det._on_span("model.step", 0.01, {"tag": 0})
    det._on_span("model.step/model.build", 0.5, {})
    det._on_span("model.step", 0.9, {"tag": 0})
    det._on_span("model.step", 0.01, {"tag": 0})
    st = det.signal_state("model.step")
    assert st["samples"] == 2 and st["state"] == "warmup"
