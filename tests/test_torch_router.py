"""Port parity, the serving control plane: singa_tpu_torch.router against
singa_tpu.router.

- JAX's stub engine (tests/test_router.py, copied below: canned greedy
  tokens behind a real `ReplicaControl`) runs behind both packages'
  controls and routers with one `retry_seed`, on scripts whose order is
  fixed (requests submitted one at a time unless the script is about
  concurrency): balance, shed, retry exhausted, structural rejection,
  failover from a dead replica, drain hand-back (a control that hands
  back, and `drain_replica`), a replacement joining, and stop. Each
  request's outcome, reason, detail, tokens, replica and attempts, the
  snapshot's counters, the `singa_route_*` exposition (times left out),
  `router_json`'s keys and the `serving_lines`/`router_report` text
  (times and pids left out) are equal: one parametrised test, a case a
  script.
- The port router's track in a merged fleet trace passes both packages'
  `_check_merged_trace`.
- Real engines, fp32: a JAX GPT's parameters go into a port GPT
  (`load_singa_params`); two engines behind two controls in each
  package, the same prompts: routed greedy tokens equal across the
  packages and equal to each package's direct engine.
- One `router --ab --device cpu` run (CLI defaults, 2 replicas, 8
  requests), its processes kept on two cores, must hold its record's
  `ok`.
- The A/B's kill trigger freezes the victim and leaves it frozen (to be
  killed) only while it holds a request its final shard shows accepted.
"""

import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import engine as jengine
from singa_tpu import models as jmodels
from singa_tpu import observe as jobserve
from singa_tpu import router as jrouter
from singa_tpu import slo as jslo
from singa_tpu import tensor as jtensor
from singa_tpu_torch import diag as tdiag
from singa_tpu_torch import engine as tengine
from singa_tpu_torch import fleet as tfleet
from singa_tpu_torch import goodput as tgoodput
from singa_tpu_torch import observe as tobserve
from singa_tpu_torch import router as trouter
from singa_tpu_torch import slo as tslo
from singa_tpu_torch.models import transformer as tt

import torch_ab

torch.set_num_threads(2)

PKGS = {"jax": (jrouter, jobserve, jengine),
        "port": (trouter, tobserve, tengine)}


def _port_clean():
    trouter.reset()
    tengine.reset()
    tfleet.uninstall()
    tdiag.stop_diag_server()
    tgoodput.uninstall()
    tslo.reset()
    tengine.clear_request_listeners()
    tobserve.get_registry().reset()
    tobserve.enable(True)


@pytest.fixture(autouse=True)
def _port_state():
    """The port's router (threads joined), engines, fleet, diag and SLO
    state torn down around each test: tests/conftest.py cleans only the
    JAX package's, and asserts on the same `singa-route-*` thread
    prefix."""
    _port_clean()
    yield
    _port_clean()
    jrouter.reset()
    jslo.tail_reset()


# ---- the stub replica (tests/test_router.py) --------------------------------

def _canned(prompt, max_new):
    s = int(np.sum(np.asarray(prompt, np.int64)))
    return [(s + i) % 97 for i in range(int(max_new))]


class _StubReq:
    def __init__(self, prompt, max_new, delay=0.0, outcome="completed",
                 detail=None):
        self.outcome = outcome
        self.tokens = _canned(prompt, max_new) \
            if outcome == "completed" else []
        self.detail = detail
        self.ttft_s = 0.001
        self._delay = delay

    def wait(self, timeout=None):
        if self._delay:
            time.sleep(self._delay)
        return True


class _StubEngine:
    def __init__(self, delay=0.0, outcome="completed", detail=None):
        self.delay = delay
        self.outcome = outcome
        self.detail = detail
        self.submitted = 0

    def submit(self, prompt, max_new):
        self.submitted += 1
        return _StubReq(prompt, max_new, self.delay, self.outcome,
                        self.detail)

    def stop(self, *a, **k):
        return []


class _Refusing(_StubEngine):
    def submit(self, prompt, max_new):
        raise AssertionError("a draining replica must not admit")


def _mk_router(rt, **kw):
    kw.setdefault("queue_limit", 64)
    kw.setdefault("retry_total_s", 30.0)
    kw.setdefault("poll_wait_s", 0.3)
    kw.setdefault("retry_seed", 0)
    kw.setdefault("retry_base_s", 0.01)
    kw.setdefault("retry_max_s", 0.05)
    return rt.Router(**kw).start()


# ---- the scripts ------------------------------------------------------------
# Each takes the package's router module, returns (router, handles,
# controls); `_drive` waits, reads and tears down.

def _seq(r, prompts, max_new):
    hs = []
    for p in prompts:
        h = r.submit(np.asarray(p, np.int32), max_new)
        assert h.wait(30)
        hs.append(h)
    return hs


def _sc_balance(rt):
    ctls = [rt.ReplicaControl(_StubEngine()) for _ in range(2)]
    r = _mk_router(rt)
    for i, c in enumerate(ctls):
        r.add_replica(f"s{i}", c.url, host=f"s{i}")
    return r, _seq(r, [[i, 2, 3] for i in range(12)], 4), ctls


def _sc_shed(rt):
    ctl = rt.ReplicaControl(_StubEngine())
    r = _mk_router(rt, queue_limit=0)
    r.add_replica("s0", ctl.url, host="s0")
    return r, [r.submit(np.array([1], np.int32), 1) for _ in range(5)], \
        [ctl]


def _sc_retry_exhausted(rt):
    r = _mk_router(rt, retry_total_s=0.3, poll_wait_s=0.1)
    return r, _seq(r, [[1]], 1), []


def _sc_structural(rt):
    ctl = rt.ReplicaControl(_StubEngine(
        outcome="rejected",
        detail="prompt 99 + max_new 99 exceeds max_ctx 36"))
    r = _mk_router(rt)
    r.add_replica("s0", ctl.url, host="s0")
    return r, _seq(r, [[1], [2]], 1), [ctl]


def _sc_failover(rt):
    dead = rt.ReplicaControl(_StubEngine())
    dead_url = dead.url
    dead.stop()                       # port closed: dispatches refuse
    live = rt.ReplicaControl(_StubEngine())
    r = _mk_router(rt)
    r.add_replica("dead", dead_url, host="dead")
    r.add_replica("live", live.url, host="live")
    return r, _seq(r, [[i, 1] for i in range(6)], 3), [live]


def _sc_handback(rt):
    draining = rt.ReplicaControl(_Refusing())
    draining.draining = True          # /submit answers "rejected, retry"
    survivor = rt.ReplicaControl(_StubEngine())
    r = _mk_router(rt)
    r.add_replica("d0", draining.url, host="d0")
    r.add_replica("ok", survivor.url, host="ok")
    return r, _seq(r, [[i] for i in range(6)], 2), [draining, survivor]


def _sc_drain_replica(rt):
    ctls = [rt.ReplicaControl(_StubEngine()) for _ in range(2)]
    r = _mk_router(rt)
    for i, c in enumerate(ctls):
        r.add_replica(f"r{i}", c.url, host=f"r{i}")
    hs = _seq(r, [[i] for i in range(4)], 2)
    out = r.drain_replica("r0", timeout_s=10.0)
    assert out["ok"] and out["handed_back"] == []
    again = r.drain_replica("r0")
    assert again == {"noop": True, "replica": "r0", "state": "dead"}
    return r, hs + _seq(r, [[i] for i in range(4, 8)], 2), ctls


def _sc_replacement(rt):
    r = _mk_router(rt, retry_total_s=30.0)
    hs = [r.submit(np.array([i], np.int32), 2) for i in range(3)]
    time.sleep(0.2)
    assert not any(h.done() for h in hs)    # waiting, not rejected
    late = rt.ReplicaControl(_StubEngine())
    r.add_replica("late", late.url, host="late")
    return r, hs, [late]


def _sc_stop(rt):
    r = _mk_router(rt)
    hs = [r.submit(np.array([1], np.int32), 1) for _ in range(4)]
    time.sleep(0.1)
    r.stop()
    post = r.submit(np.array([1], np.int32), 1)
    return r, hs + [post], []


SCRIPTS = {"balance": _sc_balance, "shed": _sc_shed,
           "retry_exhausted": _sc_retry_exhausted,
           "structural_rejection": _sc_structural,
           "failover_dead_replica": _sc_failover,
           "handback": _sc_handback, "drain_replica": _sc_drain_replica,
           "replacement_joins": _sc_replacement, "stop": _sc_stop}


def _route_lines(obs):
    """The singa_route_* exposition without times (the request-seconds
    histogram's buckets and sum)."""
    return [ln for ln in obs.to_prometheus_text().splitlines()
            if "singa_route_" in ln
            and not ln.startswith(("singa_route_request_seconds_bucket",
                                   "singa_route_request_seconds_sum"))]


def _untimed(lines):
    """Report text with its times, rates and pids left out, and the
    largest latency bucket of a request (which the times decide)."""
    out = []
    for ln in lines:
        ln = re.sub(r"\[t[0-9a-f]+-(\d+)\]", r"[t<pid>-\1]", ln)
        ln = re.sub(r", top \S+ \d+\.\d+s$", ", top <bucket>", ln)
        ln = re.sub(r"\d+\.\d+(s|/s)", r"<t>\1", ln)
        out.append(ln)
    return out


def _drive(name, script):
    rt, obs, eng = PKGS[name]
    obs.get_registry().reset()
    obs.enable(True)
    r, hs, ctls = script(rt)
    try:
        for h in hs:
            assert h.wait(30), f"{name}: request {h.id} not terminal"
        snap = r.snapshot()
        snap.pop("admitted_rps")
        snap.pop("shed_rate")
        for rep in snap["replicas"]:
            rep.pop("admitted_rps")
            rep.pop("shed_rate")
        rj = rt.router_json()
        view = {
            "requests": [(h.outcome, h.reason, h.detail, h.tokens,
                          h.replica, h.attempts) for h in hs],
            "snapshot": snap,
            "exposition": _route_lines(obs),
            "json_keys": sorted(rj),
            "json_snapshot_keys": sorted(rj.get("snapshot") or {}),
            "json_request_keys": sorted({k for t in rj.get("requests", [])
                                         for k in t}),
            "serving_lines": _untimed(rt.serving_lines()),
            # the recent-request rows in id order: concurrent requests
            # reach their terminals in either order
            "report": sorted(_untimed(rt.router_report().splitlines())),
            "statusz_serving": _untimed(eng.serving_report().splitlines()),
        }
    finally:
        r.stop()
        rt.reset()
        for c in ctls:
            c.stop()
    return view


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_stub_scripts_agree(case):
    views = {name: _drive(name, SCRIPTS[case]) for name in PKGS}
    for key in views["jax"]:
        assert views["port"][key] == views["jax"][key], key
    reqs = views["jax"]["requests"]
    assert all(o in trouter.ROUTE_OUTCOMES for o, *_ in reqs)
    if case in ("balance", "failover_dead_replica", "handback",
                "drain_replica", "replacement_joins"):
        assert all(o == "completed" for o, *_ in reqs), reqs
    if case == "failover_dead_replica":
        assert views["jax"]["snapshot"]["failovers"]["replica_dead"] >= 1
        assert views["jax"]["snapshot"]["retries"] >= 1
    if case == "balance":
        assert {rep for *_, rep, _a in reqs} == {"s0", "s1"}
    if case == "shed":
        assert {(o, rs) for o, rs, *_ in reqs} == {("rejected", "shed")}
    if case == "stop":
        assert {(o, rs) for o, rs, *_ in reqs} == {("rejected", "drain")}


def test_enums_equal_jax():
    for n in ("ROUTE_OUTCOMES", "ROUTE_REASONS", "REPLICA_STATES",
              "RETRYABLE_DETAILS", "STARTUP_PHASES", "STARTUP_TID",
              "ROUTER_QUEUE_TID", "ROUTER_DISPATCH_TID"):
        assert getattr(trouter, n) == getattr(jrouter, n), n
    assert trouter.router_json() == {"installed": False}
    assert trouter.serving_lines() == trouter.fleetz_lines() == []
    assert "no Router installed" in trouter.router_report()
    assert trouter.router_trace_events() == []


def test_router_track_passes_both_trace_checks(tmp_path):
    """After tests/test_fleet.py's trace-context case: the port router's
    track, merged by the port's aggregator with two replica shards (a
    victim's in-flight partial and the winner), links the request across
    both replicas, by JAX's checker and the port's."""
    from tests.test_fleet import _fake_serve, _write_fake_shard
    ctls = [trouter.ReplicaControl(_StubEngine()) for _ in range(2)]
    r = _mk_router(trouter)
    for i, c in enumerate(ctls):
        r.add_replica(f"s{i}", c.url, host=f"s{i}")
    try:
        h = r.submit(np.array([3, 1], np.int32), 2)
        assert h.wait(30) and h.outcome == "completed"
        off = time.time() - time.perf_counter()
        q = next(t for e, t, _i in h.events if e == "dispatch")
        w = ((q + off) + (h.finished_ts + off)) / 2.0

        def _tl(terminal):
            evs = [["submit", 100.0, None], ["admit", 100.0001, None],
                   ["first_token", 100.0003, None]]
            if terminal:
                evs.append(["terminal", 100.0004,
                            {"outcome": "completed"}])
            return {"id": 1, "trace": h.trace, "slot": 0,
                    "outcome": "completed" if terminal else None,
                    "prompt_tokens": 2, "new_tokens": 2,
                    "ttft_s": 0.0003, "total_s": 0.0004, "events": evs,
                    "syncs": []}

        victim = _fake_serve(timelines=[], syncs=[])
        victim["active"] = [_tl(False)]
        _write_fake_shard(str(tmp_path), "hostA", 100, ts=w - 100.0,
                          perf=0.0, serve=victim)
        _write_fake_shard(str(tmp_path), "hostB", 101, ts=w - 100.0,
                          perf=0.0,
                          serve=_fake_serve(timelines=[_tl(True)],
                                            syncs=[]))
        agg = tfleet.FleetAggregator(str(tmp_path))
        agg.poll()
        trace = agg.trace_events()
        for check in (trouter._check_merged_trace,
                      jrouter._check_merged_trace):
            out = check(trace, h.trace, os.getpid())
            assert out["ok"], out
            assert out["replica_pids"] == [100, 101]
    finally:
        r.stop()
        trouter.reset()
        for c in ctls:
            c.stop()


# ---- real engines -----------------------------------------------------------

def test_routed_tokens_equal_across_packages_and_direct():
    """Two fp32 engines behind two controls in each package (the size of
    tests/test_router.py's direct-engine case), the port's GPT holding the
    JAX GPT's parameters: routed greedy tokens are equal across the
    packages and equal to each package's direct engine."""
    cfg = dict(vocab_size=101, max_seq=36, dim=32, num_heads=4,
               num_layers=2)
    jm = jmodels.create_model("gpt", **cfg)
    ids = np.random.RandomState(0).randint(0, 101, (2, 8)).astype(np.int32)
    jm.compile([jtensor.from_numpy(ids, device=jdevice.best_device())],
               is_train=False, use_graph=False)
    jm.eval()
    tm = tt.GPT(**cfg, device="cpu")
    tt.load_singa_params(tm, {k: jtensor.to_numpy(v)
                              for k, v in jm.get_params().items()})
    tm.eval()
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 101, rng.randint(4, 12)).astype(np.int32)
               for _ in range(6)]
    got = {}
    for name, model in (("jax", jm), ("port", tm)):
        rt, _obs, eng_mod = PKGS[name]
        engines = [eng_mod.ServingEngine(model, max_slots=2, page_size=8,
                                         max_ctx=36, queue_limit=32).start()
                   for _ in range(2)]
        ctls = []
        r = None
        try:
            direct = []
            for i, p in enumerate(prompts):
                d = engines[i % 2].submit(p, 6)
                assert d.wait(300) and d.outcome == "completed"
                direct.append(list(d.tokens))
            ctls = [rt.ReplicaControl(e) for e in engines]
            r = _mk_router(rt)
            for i, c in enumerate(ctls):
                r.add_replica(f"e{i}", c.url, host=f"e{i}")
            hs = [r.submit(p, 6) for p in prompts]
            routed = []
            for h in hs:
                assert h.wait(300) and h.outcome == "completed", \
                    (h.outcome, h.detail)
                routed.append(h.tokens)
            assert {h.replica for h in hs} == {"e0", "e1"}
            assert routed == direct, name
            got[name] = routed
        finally:
            if r is not None:
                r.stop()
            rt.reset()
            for c in ctls:
                c.stop()
            for e in engines:
                e.stop()
    assert got["port"] == got["jax"]


# ---- the command line -------------------------------------------------------

def test_kill_and_replace_ab_on_cpu(tmp_path, tmp_path_factory, monkeypatch):
    """`router --ab --device cpu` at the CLI's defaults with 2 replicas and
    8 requests: the record's `ok` (zero lost, tokens equal to the clean
    arm's, the victim dead, the standby serving, router rows on /fleetz,
    decode the fault arm's top bucket, every startup phase). The
    coordinator thread and its replica processes (which inherit its
    affinity) share two cores, one subprocess A/B at a time
    (`torch_ab.two_cores`)."""
    out = str(tmp_path / "SERVE_test.json")
    with torch_ab.two_cores(tmp_path_factory, monkeypatch):
        rc = trouter.main(["--ab", "--device", "cpu", "--replicas", "2",
                           "--requests", "8", "--timeout", "120",
                           "--out", out])
    with open(out, encoding="utf-8") as f:
        lines = [json.loads(x) for x in f if x.strip()]
    rec = lines[-1]
    assert rc == 0 and rec["ok"] is True, rec
    assert rec["device"] == "cpu"
    assert rec["lost_requests"] == 0 and rec["failovers"] >= 1
    assert rec["tokens_match_clean_arm"] and rec["victim_marked_dead"]
    assert rec["standby_served"] and rec["fleetz_has_router_rows"]
    assert rec["fault_top_bucket"] == "decode"
    assert set(rec["startup_phases"]) == set(trouter.STARTUP_PHASES)
    assert rec["trace"]["ok"]
    assert {m["metric"] for m in lines[:-1]} >= {
        "router_lost_requests", "router_ttft_p99_kill_s"}
    assert not [t.name for t in threading.enumerate()
                if t.is_alive() and t.name.startswith("singa-route")]


def _stopped(pid, want, timeout_s=10.0):
    """Whether /proc/<pid>/stat shows the process stopped ("T"), read
    until it matches `want` or `timeout_s` passes (a signal lands when
    the process next runs, later on a busy host)."""
    deadline = time.monotonic() + timeout_s
    while True:
        with open(f"/proc/{pid}/stat", encoding="utf-8") as f:
            got = f.read().rsplit(")", 1)[1].split()[0] == "T"
        if got == want or time.monotonic() > deadline:
            return got
        time.sleep(0.01)


@pytest.mark.parametrize("case", ["holds", "answered", "not_on_disk"])
def test_kill_trigger_freezes_only_a_holder(case):
    """`_freeze_holding` SIGSTOPs the victim. It returns the trace ids of
    the requests the router still has in flight to it that the victim's
    shard shows active, and leaves it stopped for the kill; with none
    (the answer came back, or the victim never recorded the request) it
    SIGCONTs it and returns an empty set. Another host's shard does not
    count."""
    import subprocess
    import sys
    import types
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    try:
        rep = types.SimpleNamespace(
            proc=proc, inflight=set() if case == "answered" else {1, 2})
        active = [] if case == "not_on_disk" else [{"trace": "t-1"}]
        agg = types.SimpleNamespace(poll=lambda: None, _workers={
            "a": types.SimpleNamespace(host="r1",
                                       serve={"active": active}),
            "b": types.SimpleNamespace(host="r0", serve={
                "active": [{"trace": "t-2"}]})})
        router = types.SimpleNamespace(_lock=threading.Lock())
        handles = [types.SimpleNamespace(id=1, trace="t-1"),
                   types.SimpleNamespace(id=2, trace="t-2"),
                   types.SimpleNamespace(id=3, trace=None)]
        held = trouter._freeze_holding(router, rep, "r1", agg, handles,
                                       settle_s=0.01)
        if case == "holds":
            assert held == {"t-1"}
            assert _stopped(proc.pid, True)
        else:
            assert held == set()
            assert not _stopped(proc.pid, False)
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_replicas_need_the_card_unless_cpu(tmp_path):
    """Without a card a replica on the default device raises, in
    spawn_replica and in the replica's own entry point; nothing falls
    back to the CPU. The warm-start options run: on the default device
    they raise as every replica does, and a CPU replica spawned with
    `warm_dir` enables the store there and reports it on its ready line;
    `--corrupt-after` is audit's and runs (tests/test_torch_audit.py)."""
    import types
    args = types.SimpleNamespace(
        vocab=211, dim=64, layers=2, prompt_lo=4, prompt_hi=12, new_hi=24,
        slots=4, page_size=8, publish_interval=0.1, device="cuda")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        trouter.spawn_replica("r0", str(tmp_path), args)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        trouter.main(["--replica", "--fleet-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        trouter._build_replica_model(211, 512, 2, 36)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        trouter.main(["--replica", "--fleet-dir", str(tmp_path),
                      "--warm-dir", str(tmp_path / "warm")])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        trouter.main(["--warm-ab", "--out", str(tmp_path / "w.json")])
    warm = str(tmp_path / "warm")
    proc, ready = trouter.spawn_replica(
        "r0", str(tmp_path), types.SimpleNamespace(
            **dict(vars(args), device="cpu", warm_dir=warm)),
        ready_timeout_s=120)
    try:
        assert ready["warm"]["root"] == warm
        assert ready["warm"]["lookups"]["miss"] > 0
        assert ready["warm"]["exports"] == ready["warm"]["entries"] > 0
    finally:
        trouter._http_json(f"http://127.0.0.1:{ready['ctl_port']}"
                           "/shutdown", {}, timeout=10.0)
        assert proc.wait(timeout=60) == 0
    assert not os.path.exists(tmp_path / "w.json")
    assert trouter.get_router() is None
