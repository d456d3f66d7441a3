"""observe on the port (`singa_tpu_torch.observe`) against
`singa_tpu.observe`.

- The registry, span, exposition and EventLog cases of
  tests/test_observe.py, on the port's module.
- The same sequence of metric and `record_*` calls into both packages'
  registries gives equal `to_prometheus_text()` and `dump()` (wall
  times, which no two runs share, left out: the span histogram and the
  `ts` stamps).
- The metric-name lint (tools/check_metrics_names.py) passes on the
  port's package.
- The hooks: greedy `generate` and the engine (the same requests queued
  before `start()` in both packages) book equal `singa_serving_*` and
  `singa_serve_*` counts; three eager and three graph-mode training steps
  book equal host-side step metrics. The in-step hooks follow the port's
  rule (observe's module docstring): once per host execution of the step
  body, so on the CPU every graph-mode step books `opt.apply_updates`,
  where JAX books it once per trace.
"""

import json
import math
import os
import re
import sys
import time

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jag
from singa_tpu import device as jdevice
from singa_tpu import engine as jengine
from singa_tpu import layer as jl
from singa_tpu import model as jmodel
from singa_tpu import models as jmodels
from singa_tpu import observe as jobs
from singa_tpu import opt as jopt
from singa_tpu import serving as jserving
from singa_tpu import tensor as jt
from singa_tpu_torch import autograd as tag
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import engine as tengine
from singa_tpu_torch import layer as tl
from singa_tpu_torch import memory
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import observe
from singa_tpu_torch import opt as topt
from singa_tpu_torch import serving as tserving
from singa_tpu_torch import tensor as tt
from singa_tpu_torch.models import transformer as ttr
from singa_tpu_torch.observe import EventLog, MetricsRegistry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TDEV = tdevice.create_cpu_device()


@pytest.fixture
def reg():
    """A clean port registry (and the JAX one, which conftest resets too),
    no EventLog, the hooks on."""
    for o in (observe, jobs):
        o.get_registry().reset()
        o.set_event_log(None)
        o.enable(True)
    yield observe.get_registry()
    for o in (observe, jobs):
        o.get_registry().reset()
        o.set_event_log(None)
        o.enable(True)


# ---- the module's surface ---------------------------------------------------

def test_public_names_and_constants_equal_jax():
    assert observe.__all__ == jobs.__all__
    assert all(hasattr(observe, n) for n in observe.__all__)
    assert observe.DEFAULT_BUCKETS == jobs.DEFAULT_BUCKETS
    assert observe.COMM_OPS == jobs.COMM_OPS
    assert observe.SPAN_TRACE_PREFIX == jobs.SPAN_TRACE_PREFIX
    assert tserving.SPEC_VERDICTS == jserving.SPEC_VERDICTS
    assert tengine.KV_DTYPES == jengine.KV_DTYPES
    # the live server is the port's diag module's
    from singa_tpu_torch import diag, goodput
    try:
        srv = observe.start_diag_server(port=0)
        assert isinstance(srv, diag.DiagServer) and srv.port > 0
        assert diag.get_diag_server() is srv
    finally:
        diag.stop_diag_server()
        goodput.uninstall()


def test_metric_names_pass_the_lint():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import check_metrics_names
    finally:
        sys.path.pop(0)
    assert check_metrics_names.check(
        [os.path.join(ROOT, "singa_tpu_torch")]) == []


# ---- metric primitives (tests/test_observe.py's cases) ---------------------

def test_counter_semantics(reg):
    c = observe.counter("singa_t_total", "h")
    c.inc()
    c.inc(2.5)
    assert c.value() == 3.5
    c.inc(op="x")
    c.inc(3, op="x")
    assert c.value(op="x") == 4.0
    assert c.value() == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    assert observe.counter("singa_t_total") is c
    with pytest.raises(ValueError):
        observe.gauge("singa_t_total")


def test_gauge_semantics(reg):
    g = observe.gauge("singa_t_gauge")
    g.set(5.0)
    g.inc(2)
    g.dec(3)
    assert g.value() == 4.0
    g.set(1.0, dev="0")
    assert g.value(dev="0") == 1.0


def test_histogram_semantics(reg):
    h = observe.histogram("singa_t_seconds", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    assert h.count() == 4
    assert abs(h.sum() - 5.555) < 1e-9
    assert h.bucket_counts() == [1, 2, 3, 4]
    h.observe(0.5, kind="x")
    assert h.count(kind="x") == 1
    assert h.count() == 4


def test_metric_name_contract(reg):
    with pytest.raises(ValueError):
        observe.counter("not_singa_prefixed")
    with pytest.raises(ValueError):
        observe.counter("singa_Bad_Case")


def test_span_nesting_and_timing(reg):
    with observe.span("outer"):
        assert observe.current_span() == "outer"
        with observe.span("inner", attr=1):
            assert observe.current_span() == "outer/inner"
            time.sleep(0.01)
    assert observe.current_span() is None
    h = reg.get("singa_span_seconds")
    assert h.count(span="outer") == 1
    assert h.count(span="outer/inner") == 1
    assert h.sum(span="outer/inner") >= 0.01
    assert h.sum(span="outer") >= h.sum(span="outer/inner")


def test_span_survives_exception(reg):
    with pytest.raises(RuntimeError):
        with observe.span("boom"):
            raise RuntimeError("x")
    assert observe.current_span() is None
    assert reg.get("singa_span_seconds").count(span="boom") == 1


def test_span_is_a_profiler_range_and_listeners_fire(reg):
    """Under torch.profiler a span is a record_function range named
    singa.span/<path>; without one the histogram and listeners still
    fire; suppress_spans silences the calling thread."""
    seen = []
    observe.add_span_listener(lambda p, s, a: seen.append(p),
                              on_enter=lambda p: seen.append("+" + p))
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with observe.span("outer"):
                with observe.span("inner"):
                    torch.ones(4).sum()
        names = {e.name for e in prof.events()}
        assert {"singa.span/outer", "singa.span/outer/inner"} <= names
        with observe.span("plain"):
            pass
        with observe.suppress_spans():
            assert observe.spans_suppressed()
            with observe.span("hidden"):
                pass
    finally:
        observe._span_listeners.clear()
    assert seen == ["+outer", "+outer/inner", "outer/inner", "outer",
                    "+plain", "plain"]
    h = reg.get("singa_span_seconds")
    assert h.count(span="plain") == 1 and h.count(span="hidden") == 0


def test_span_records_ring(reg):
    observe.enable_span_records(8)
    try:
        with observe.span("a"):
            pass
        observe.note_span("synthetic", time.perf_counter(), 0.5)
        recs = observe.span_records()
    finally:
        observe.disable_span_records()
    assert [r["name"] for r in recs] == ["a", "synthetic"]
    assert not observe.span_records_enabled()


def test_record_hbm_reads_the_caching_allocator(reg, monkeypatch):
    """On a CUDA device the three singa_hbm_* gauges come from
    torch.cuda.memory_stats and the card's total memory (stubbed here);
    on the CPU the in-use gauge is the memory ledger's live total (no
    ledger installed: the enumerated live CPU storages)."""
    stats = {"allocated_bytes.all.current": 123,
             "reserved_bytes.all.peak": 456}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d=None: stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d=None: type("P", (), {"total_memory": 789}))
    observe.record_hbm(torch.device("cuda", 0))
    got = {n: reg.get(n).value() for n in (
        "singa_hbm_bytes_in_use", "singa_hbm_peak_bytes_in_use",
        "singa_hbm_bytes_limit")}
    assert got == {"singa_hbm_bytes_in_use": 123,
                   "singa_hbm_peak_bytes_in_use": 456,
                   "singa_hbm_bytes_limit": 789}
    reg.reset()
    memory.reset()  # no ledger, and the fallback's throttle cache cleared
    pin = torch.ones(4096)
    observe.record_step(0.01, device=TDEV)
    assert reg.get("singa_hbm_bytes_in_use").value() \
        >= pin.numel() * pin.element_size()
    assert reg.get("singa_hbm_bytes_limit") is None


def test_disabled_hooks_record_nothing(reg):
    observe.enable(False)
    observe.record_step(0.1)
    observe.record_decode("greedy", 0.1, 4, 1)
    with observe.span("s"):
        pass
    assert reg.names() == []


# ---- exposition -------------------------------------------------------------

def test_prometheus_text_golden():
    r = MetricsRegistry()
    c = r.counter("singa_x_total", "things done")
    c.inc(3)
    c.inc(2, op="a b")
    r.gauge("singa_g").set(2.5)
    h = r.histogram("singa_h_seconds", buckets=(1.0, 10.0))
    h.observe(0.5)
    h.observe(5.0)
    expected = (
        "# TYPE singa_g gauge\n"
        "singa_g 2.5\n"
        "# TYPE singa_h_seconds histogram\n"
        'singa_h_seconds_bucket{le="1"} 1\n'
        'singa_h_seconds_bucket{le="10"} 2\n'
        'singa_h_seconds_bucket{le="+Inf"} 2\n'
        "singa_h_seconds_sum 5.5\n"
        "singa_h_seconds_count 2\n"
        "# HELP singa_x_total things done\n"
        "# TYPE singa_x_total counter\n"
        "singa_x_total 3\n"
        'singa_x_total{op="a b"} 2\n'
    )
    assert r.to_prometheus_text() == expected


_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [^ ]+$")


def assert_valid_prometheus(text):
    """Line by line (tests/test_observe.py's grammar): every line is a
    # HELP/# TYPE header or a sample whose family has a # TYPE."""
    typed = set()
    n_samples = 0
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            assert kind in ("counter", "gauge", "histogram"), line
            typed.add(name)
            continue
        if line.startswith("# HELP "):
            continue
        assert _SAMPLE_RE.match(line), f"unparseable sample line: {line!r}"
        base = line.split("{")[0].split(" ")[0]
        family = re.sub(r"_(bucket|sum|count)$", "", base)
        assert base in typed or family in typed, \
            f"sample {base} has no # TYPE header"
        n_samples += 1
    return n_samples


def test_prometheus_text_parses(reg):
    observe.counter("singa_t_total").inc()
    observe.histogram("singa_t_seconds").observe(0.1, kind="a")
    observe.gauge("singa_t_gauge").set(-1.5)
    observe.gauge("singa_t_nan").set(math.nan)
    assert assert_valid_prometheus(observe.to_prometheus_text()) > 3


def _same_records(o, ser):
    """One fixed sequence of metric and record_* calls (no wall times)."""
    c = o.counter("singa_t_total", "things")
    c.inc()
    c.inc(2.5, op="a b")
    o.gauge("singa_t_gauge", "level").set(-3.25, dev='q"x')
    h = o.histogram("singa_t_seconds", "latency")
    for v in (1e-7, 3e-6, 0.02, 0.5, 7.0, 5e3):
        h.observe(v, kind="k")
    o.record_step_build(0.75)
    o.record_compile(8, donated_bytes=1024)
    o.record_compile(4, recompile=True)
    for s in (0.01, 0.02, 0.03):
        o.record_step(s, batch=8, tag=0)
    o.record_step_fenced(0.05)
    o.record_opt_update(6, 0.001, "local")
    o.record_decode("greedy", 0.25, new_tokens=16, batch=2, ttft=0.05,
                    prompt_tokens=10)
    o.record_decode("beam", 0.5, new_tokens=8, batch=1)
    o.record_prefetch(depth=2, produced=True)
    o.record_prefetch(depth=1, blocked_s=0.004)
    o.record_ckpt_async(1, blocking_s=0.2)
    o.record_ckpt_async(0)
    o.record_checkpoint_bytes(123456)
    o.record_comm("all_reduce", 4096, world_size=2)
    o.record_comm("mystery", 1)
    o.record_bench({"metric": "x", "tokens_per_sec": 12.5, "ok": True})
    ser.record_spec(12, 9, 3, 4)


def _strip_ts(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


def test_same_records_give_equal_exposition_and_dump(reg):
    _same_records(jobs, jserving)
    _same_records(observe, tserving)
    want, got = jobs.to_prometheus_text(), observe.to_prometheus_text()
    assert got == want
    assert assert_valid_prometheus(got) > 40
    jd, td = jobs.dump(), observe.dump()
    assert td["metrics"] == jd["metrics"]
    assert _strip_ts(td["recent_events"]) == _strip_ts(jd["recent_events"])


def test_dump_writes_json(reg, tmp_path):
    _same_records(observe, tserving)
    path = str(tmp_path / "m.json")
    observe.dump(path)
    with open(path) as f:
        back = json.load(f)
    assert back["metrics"]["singa_steps_total"]["samples"][0]["value"] == 3


# ---- EventLog ---------------------------------------------------------------

def test_eventlog_roundtrip(tmp_path):
    p = str(tmp_path / "ev.jsonl")
    log = EventLog(p)
    recs = [{"kind": "step", "i": i, "v": 1.5 * i} for i in range(5)]
    for rec in recs:
        log.write(dict(rec))
    log.close()
    back = EventLog.read(p)
    assert len(back) == 5
    for orig, got in zip(recs, back):
        assert got["i"] == orig["i"] and got["v"] == orig["v"]
        assert "ts" in got


def test_eventlog_rotation(tmp_path):
    p = str(tmp_path / "rot.jsonl")
    log = EventLog(p, max_bytes=300, backups=2)
    for i in range(50):
        log.write({"i": i, "pad": "x" * 40})
    log.close()
    assert os.path.exists(p) and os.path.exists(p + ".1")
    live = EventLog.read(p)
    assert live and live[-1]["i"] == 49
    assert all("i" in r for r in EventLog.read(p + ".1"))


def test_eventlog_zero_backups_still_bounded(tmp_path):
    p = str(tmp_path / "nobak.jsonl")
    log = EventLog(p, max_bytes=300, backups=0)
    for i in range(50):
        log.write({"i": i, "pad": "x" * 40})
    log.close()
    assert os.path.getsize(p) <= 300
    assert not os.path.exists(p + ".1")
    live = EventLog.read(p)
    assert live and live[-1]["i"] == 49


def test_eventlog_skips_torn_line(tmp_path):
    p = str(tmp_path / "torn.jsonl")
    with open(p, "w") as f:
        f.write('{"a":1}\n{"b":2}\n{"c": tr')
    assert EventLog.read(p) == [{"a": 1}, {"b": 2}]


def test_eventlog_flush_and_fsync_mode(tmp_path):
    p = str(tmp_path / "fsync.jsonl")
    log = EventLog(p, fsync=True)
    log.write({"step": 1})
    log.flush()
    log.flush(fsync=True)
    rows = EventLog.read(p)
    assert len(rows) == 1 and rows[0]["step"] == 1
    log.close()


def test_event_log_receives_step_records(reg, tmp_path):
    p = str(tmp_path / "steps.jsonl")
    observe.set_event_log(p)
    try:
        observe.record_step(0.01, batch=4)
        observe.record_step(0.02, batch=4)
    finally:
        observe.get_event_log().close()
        observe.set_event_log(None)
    rows = EventLog.read(p)
    assert [r["step"] for r in rows] == [1, 2]
    assert all(r["kind"] == "step" and r["batch"] == 4 for r in rows)


# ---- the hooks: serving -------------------------------------------------------

CFG = dict(vocab_size=61, max_seq=64, dim=32, num_heads=4, num_layers=2)


@pytest.fixture(scope="module")
def gpts():
    jm = jmodels.create_model("gpt", **CFG)
    ids = np.random.RandomState(0).randint(0, 61, (2, 8)).astype(np.int32)
    jm.compile([jt.from_numpy(ids, device=jdevice.best_device())],
               is_train=False, use_graph=False)
    jm.eval()
    tm = ttr.GPT(**CFG, device="cpu")
    ttr.load_singa_params(tm, {k: jt.to_numpy(v)
                               for k, v in jm.get_params().items()})
    return jm, tm


def _serving_counts(o):
    r = o.get_registry()
    out = {}
    for name in r.names():
        if not name.startswith(("singa_serving_", "singa_serve_",
                                "singa_spec_")):
            continue
        m = r.get(name)
        for s in m.snapshot():
            key = (name, tuple(sorted(s["labels"].items())))
            if m.kind == "histogram":
                out[key] = s["count"]
            elif m.kind == "counter" or not name.endswith(
                    ("_per_sec", "_seconds")):
                out[key] = s["value"]
    return out


def _span_counts(o, prefix=""):
    """{span path: count}, leaving out the JAX package's compile spans
    (introspect.*), which the port has no counterpart of."""
    h = o.get_registry().get("singa_span_seconds")
    if h is None:
        return {}
    return {s["labels"]["span"]: s["count"] for s in h.snapshot()
            if s["labels"]["span"].startswith(prefix)
            and "introspect." not in s["labels"]["span"]}


def test_generate_books_the_same_serving_metrics(reg, gpts):
    jm, tm = gpts
    p = np.random.RandomState(3).randint(0, 61, (2, 9)).astype(np.int32)
    np.testing.assert_array_equal(tm.generate(p, 6), jm.generate(p, 6))
    np.testing.assert_array_equal(tm.generate_beam(p, 4, num_beams=2),
                                  jm.generate_beam(p, 4, num_beams=2))
    want, got = _serving_counts(jobs), _serving_counts(observe)
    assert got == want
    assert want[("singa_serving_tokens_total", (("kind", "greedy"),))] == 12
    assert _span_counts(observe, "serving.") == _span_counts(
        jobs, "serving.")
    assert _span_counts(observe, "serving.") == {
        "serving.decode": 1, "serving.decode/serving.prefill": 1,
        "serving.decode/serving.decode_scan": 1, "serving.beam_decode": 1}


def _serve(eng_mod, e, reqs_in):
    """Queue every request, then start: both packages admit the same
    rows in the same order."""
    reqs = [eng_mod.EngineRequest(i, np.asarray(p, np.int32), mn, None, None)
            for i, (p, mn) in enumerate(reqs_in)]
    e._queue.extend(reqs)
    e.start()
    try:
        for r in reqs:
            assert r.wait(300), f"request {r.id} never finished"
    finally:
        e.stop()
    return reqs


def test_engine_books_the_same_serve_metrics(reg, gpts):
    jm, tm = gpts
    rng = np.random.RandomState(1)
    reqs_in = [(rng.randint(0, 61, (s0,)), mn)
               for s0, mn in ((5, 6), (11, 3), (7, 9), (3, 5), (9, 1))]
    kw = dict(max_slots=3, page_size=8, max_ctx=32, steps_per_sync=2)
    want = _serve(jengine, jengine.ServingEngine(jm, **kw), reqs_in)
    got = _serve(tengine, tengine.ServingEngine(tm, **kw), reqs_in)
    for w, g in zip(want, got):
        assert g.done() and w.done()
        np.testing.assert_array_equal(g.result(), w.result())
    jc, tc = _serving_counts(jobs), _serving_counts(observe)
    assert tc == jc
    n_tok = sum(len(g.tokens) for g in got)
    assert tc[("singa_serve_tokens_total", ())] == n_tok
    assert tc[("singa_serve_requests_total",
               (("outcome", "completed"),))] == 5
    assert tc[("singa_serve_ttft_seconds", ())] == 5
    spans = _span_counts(observe, "serving.engine")
    assert spans["serving.engine_prefill"] == 5
    assert spans["serving.engine_step"] == tc[("singa_serve_steps_total",
                                               ())] / 2


def test_engine_request_done():
    r = tengine.EngineRequest(1, np.arange(3), 2, None, None)
    assert not r.done()
    r._done.set()
    assert r.done()


# ---- the hooks: training -----------------------------------------------------

def _mlp(pkg):
    layer, ag, model = (jl, jag, jmodel) if pkg == "jax" else \
        (tl, tag, tmodel)

    class MLP(model.Model):
        def __init__(self):
            super().__init__()
            self.l1 = layer.Linear(8)
            self.l2 = layer.Linear(3)
            self.sce = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.l2(ag.relu(self.l1(x)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.sce(out, y)
            self.optimizer(loss)
            return out, loss

    return MLP()


def _train(pkg, graph, steps=3):
    """Losses of `steps` training calls from weights drawn from a seed."""
    t, o = (jt, jopt) if pkg == "jax" else (tt, topt)
    dev = jdevice.get_default_device() if pkg == "jax" else TDEV
    rng = np.random.RandomState(0)
    x = rng.randn(4, 5).astype(np.float32)
    y = rng.randint(0, 3, 4).astype(np.int32)
    m = _mlp(pkg)
    m.set_optimizer(o.SGD(0.1, momentum=0.9))
    tx, ty = t.from_numpy(x, device=dev), t.from_numpy(y, device=dev)
    m.compile([tx], is_train=True, use_graph=graph)
    m.set_params({k: rng.randn(*v.shape).astype(np.float32) * 0.3
                  for k, v in m.get_params().items()})
    return [float(np.asarray(t.to_numpy(m(tx, ty)[1])))
            for _ in range(steps)]


HOST_SIDE = ("singa_steps_total", "singa_step_seconds",
             "singa_step_build_seconds", "singa_model_compile_total",
             "singa_model_recompile_total", "singa_step_donated_bytes")


def _host_side(o):
    r = o.get_registry()
    out = {}
    for name in HOST_SIDE:
        m = r.get(name)
        for s in (m.snapshot() if m is not None else ()):
            key = (name, tuple(sorted(s["labels"].items())))
            out[key] = s["count"] if m.kind == "histogram" else s["value"]
    return out


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph"])
def test_training_books_the_same_host_side_metrics(reg, graph):
    jl_ = _train("jax", graph)
    tl_ = _train("port", graph)
    np.testing.assert_allclose(tl_, jl_, rtol=1e-5)
    want, got = _host_side(jobs), _host_side(observe)
    assert got == want
    jspans, tspans = _span_counts(jobs), _span_counts(observe)
    upd = observe.get_registry().get("singa_opt_updates_total")
    if not graph:
        # no step hooks on the eager path, in either package; the
        # optimizer books every step
        assert want == {}
        assert tspans == jspans == {"opt.apply_updates": 3}
        assert upd.value(strategy="local") == 3 * 4 == jobs.get_registry() \
            .get("singa_opt_updates_total").value(strategy="local")
        return
    assert want[("singa_steps_total", ())] == 3
    assert want[("singa_model_compile_total", (("batch_class", "4"),))] == 1
    # host-side spans: one model.step per call, one build per signature
    # (the port's build nests in the step: the warm-up is the first step)
    leaf = {}
    for path, n in tspans.items():
        leaf[path.rsplit("/", 1)[-1]] = leaf.get(path.rsplit("/", 1)[-1],
                                                 0) + n
    assert tspans["model.step"] == jspans["model.step"] == 3
    assert leaf["model.build"] == jspans["model.build"] == 1
    # in-step hooks: per host execution of the step body (every CPU step)
    assert tspans == {"model.step": 3, "model.step/model.build": 1,
                      "model.step/model.build/opt.apply_updates": 1,
                      "model.step/opt.apply_updates": 2}
    assert leaf["opt.apply_updates"] == 3
    assert upd.value(strategy="local") == 3 * 4


def test_fenced_step_times_at_verbosity_one(reg):
    """SetVerbosity(1) with SetSkipIteration(1): the graph-mode steps past
    the first are fenced into dev.step_times and the fenced histogram;
    PrintTimeProfiling prints their summary (and, at verbosity 2, says
    the cost analysis waits for introspect)."""
    dev = TDEV
    saved = (dev.verbosity, dev.skip_iteration, list(dev.step_times))
    dev.step_times.clear()
    dev.SetVerbosity(1)
    dev.SetSkipIteration(1)
    try:
        _train("port", True, steps=6)
        assert len(dev.step_times) == 5
        assert observe.get_registry().get(
            "singa_step_fenced_seconds").count() == 5
        assert observe.get_registry().get("singa_hbm_bytes_in_use") \
            is not None
        dev.SetVerbosity(2)
        dev.PrintTimeProfiling()
    finally:
        dev.verbosity, dev.skip_iteration = saved[:2]
        dev.step_times[:] = saved[2]
