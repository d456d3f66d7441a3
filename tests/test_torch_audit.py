"""Port parity, the serving correctness observatory: singa_tpu_torch.audit
against singa_tpu.audit.

- The enums are JAX's.
- The fingerprint is bit-exact with JAX's `ParamFingerprinter.compute()`,
  group by group, for a JAX GPT carried over with `load_singa_params`,
  with +0, -0, NaN and +-inf entries; a one-bit flip in any parameter
  moves exactly its group, in both packages alike; values in permuted
  positions fold differently; computing moves no compile counter; the
  timer thread and `reset` follow JAX's contract.
- The corruption fault point flips one layer in place: the fingerprint
  moves in that group only, the snapshot says `injected`, and an engine's
  served tokens change.
- The aggregator's fingerprint vote over handcrafted shards (a dissenter
  drained through the observatory, unanimity, the health-note fallback)
  and the canary, replay, quarantine-cap, health-note and event cases of
  tests/test_audit.py run on both packages' observatories: their
  snapshots, drains, counters and reports are equal.
- Synthetic traffic moves neither the router's admission stamps, SLO
  attainment nor the demand forecast.
- /auditz answers 503 until a fingerprinter is installed, then 200, and
  /statusz has its section; the `fleet_audit` shard line is JAX's.
- A replica process started with `--corrupt-after 3` flips a layer at its
  third fingerprint tick.
- One `audit --ab --device cpu` run at reduced flags (12 requests, the
  corruption at the 30th tick, a 2 s clean-arm settle), its processes
  kept on two cores, holds its record's `ok`; a `cuda` run without a
  card raises.
"""

import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from singa_tpu import audit as jaudit
from singa_tpu import device as jdevice
from singa_tpu import fleet as jfleet
from singa_tpu import health as jhealth
from singa_tpu import models as jmodels
from singa_tpu import observe as jobserve
from singa_tpu import resilience as jres
from singa_tpu import tensor as jtensor
from singa_tpu_torch import audit as taudit
from singa_tpu_torch import capacity as tcapacity
from singa_tpu_torch import diag as tdiag
from singa_tpu_torch import engine as tengine
from singa_tpu_torch import fleet as tfleet
from singa_tpu_torch import health as thealth
from singa_tpu_torch import observe as tobserve
from singa_tpu_torch import resilience as tres
from singa_tpu_torch import router as trouter
from singa_tpu_torch import slo as tslo
from singa_tpu_torch.models import transformer as tt

import torch_ab

torch.set_num_threads(2)

PKGS = {"jax": (jaudit, jobserve, jhealth, jfleet, jres),
        "port": (taudit, tobserve, thealth, tfleet, tres)}
CFG = dict(vocab_size=97, max_seq=64, dim=32, num_heads=2, num_layers=2)


def _port_clean():
    taudit.reset()
    trouter.reset()
    tengine.reset()
    tfleet.uninstall()
    tdiag.stop_diag_server()
    tslo.reset()
    tres.clear_fault_plan()
    thealth.set_active_monitor(None)
    tobserve.get_registry().reset()
    tobserve.enable(True)


@pytest.fixture(autouse=True)
def _port_state():
    """The port's fingerprinter, observatory (prober, replayer and drain
    threads joined), router, fleet, diag and fault plan torn down around
    each test: tests/conftest.py cleans only the JAX package's, and
    asserts on the same `singa-audit` thread prefix."""
    _port_clean()
    jobserve.get_registry().reset()
    yield
    _port_clean()
    jaudit.reset()
    jres.clear_fault_plan()
    jhealth.set_active_monitor(None)


@pytest.fixture(scope="module")
def gpts():
    """A JAX GPT and the port GPT holding its parameters."""
    jm = jmodels.create_model("gpt", **CFG)
    ids = np.random.RandomState(0).randint(0, 97, (2, 8)).astype(np.int32)
    jm.compile([jtensor.from_numpy(ids, device=jdevice.best_device())],
               is_train=False, use_graph=False)
    jm.eval()
    tm = tt.GPT(**CFG, device="cpu")
    tt.load_singa_params(tm, {k: jtensor.to_numpy(v)
                              for k, v in jm.get_params().items()})
    tm.eval()
    return jm, tm


def _set(jm, tm, name, arr):
    """The same float32 values into parameter `name` of both models."""
    jm.get_params()[name].copy_from_numpy(arr)
    with torch.no_grad():
        tm._raw_params()[name].copy_(torch.from_numpy(arr))


def test_enums_equal_jax():
    for name in ("AUDIT_LEGS", "AUDIT_VERDICTS", "LEG_FINGERPRINT",
                 "LEG_CANARY", "LEG_REPLAY", "VERDICT_MATCH",
                 "VERDICT_MISMATCH", "VERDICT_ERROR", "_REPLAY_RID_BASE"):
        assert getattr(taudit, name) == getattr(jaudit, name), name


# ---- leg 1: the fingerprint ------------------------------------------------

def test_fingerprint_bit_exact_with_jax(gpts):
    """Equal checksums, group by group, on the carried-over weights with
    +0, -0, NaN, +inf and -inf planted in one layer, then on each
    one-bit flip of every parameter (a random element, a random bit): a
    flip moves exactly its own group, identically in both packages."""
    jm, tm = gpts
    name = next(n for n in jm.get_params() if n.endswith("fc1.W"))
    orig = jtensor.to_numpy(jm.get_params()[name]).astype(np.float32)
    special = orig.copy()
    special.flat[:5] = [0.0, -0.0, np.nan, np.inf, -np.inf]
    _set(jm, tm, name, special)
    jfp, tfp = jaudit.ParamFingerprinter(jm), taudit.ParamFingerprinter(tm)
    try:
        base = tfp.compute()
        assert base == jfp.compute()
        assert tfp.groups == jfp.groups and len(base) == 6
        assert all(0 <= v < 2 ** 32 for _, v in base)
        rng = np.random.RandomState(3)
        for pname, p in tm._raw_params().items():
            old = jtensor.to_numpy(jm.get_params()[pname]).astype(
                np.float32)
            flipped = old.copy()
            u = flipped.view(np.uint32)
            u.flat[rng.randint(old.size)] ^= np.uint32(
                1 << int(rng.randint(32)))
            _set(jm, tm, pname, flipped)
            try:
                got = tfp.compute()
                assert got == jfp.compute(), pname
                moved = [g for (g, a), (_, b) in zip(base, got) if a != b]
                assert moved == [pname.split(".", 1)[0]], pname
            finally:
                _set(jm, tm, pname, old)
        assert tfp.compute() == base
    finally:
        _set(jm, tm, name, orig)


def test_fingerprint_position_sensitive():
    class Holder:
        sep = "."

        def __init__(self, arr):
            self.p = torch.nn.Parameter(torch.from_numpy(arr))

        def _raw_params(self):
            return {"blk.W": self.p}

    class JHolder:
        sep = "."

        def __init__(self, arr):
            self._t = jtensor.from_numpy(arr)

        def get_params(self):
            return {"blk.W": self._t}

    base = np.arange(8, dtype=np.float32)
    perm = base[::-1].copy()
    a = taudit.ParamFingerprinter(Holder(base)).compute()
    b = taudit.ParamFingerprinter(Holder(perm)).compute()
    assert a != b
    assert a == jaudit.ParamFingerprinter(JHolder(base)).compute()
    assert b == jaudit.ParamFingerprinter(JHolder(perm)).compute()


def test_fingerprint_compiles_nothing_and_timer_resets(gpts):
    _jm, tm = gpts
    c = tobserve.get_registry().get("singa_model_compile_total")
    before = int(c.value()) if c is not None else 0
    fp = taudit.install_fingerprint(tm, interval_s=0.05)
    deadline = time.monotonic() + 10.0
    while fp.count < 3 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert fp.count >= 3
    taudit.refresh_fingerprint("restore")
    c = tobserve.get_registry().get("singa_model_compile_total")
    assert (int(c.value()) if c is not None else 0) == before
    assert [t for t in threading.enumerate()
            if t.name.startswith("singa-audit-fp")]
    taudit.reset()
    assert taudit.get_fingerprinter() is None
    assert not [t.name for t in threading.enumerate()
                if t.is_alive() and t.name.startswith("singa-audit")]


def test_corrupt_flips_one_layer_and_changes_served_tokens():
    """The fault point at the first tick flips the sign of every element
    of the target layer in place: the fingerprint moves in its group
    only, the snapshot says injected, and the engine serves other tokens
    (its decode parameters rebuilt). The weights come from a fixed seed:
    a full sign flip of a layer leaves the fold unchanged for about one
    draw in 1/sqrt(size) (`test_uniform_sign_flip_blind_spot_is_jax_s`)."""
    tm = tt.GPT(**CFG, device="cpu", seed=0)
    tm.eval()
    name = next(n for n in tm._raw_params() if n.endswith("fc1.W"))
    orig = tm._raw_params()[name].detach().clone()
    e = tengine.ServingEngine(tm, max_slots=2, page_size=8, max_ctx=64,
                              steps_per_sync=2).start()
    prompt = np.asarray([3, 14, 15, 92, 65, 35], np.int32)
    try:
        h = e.submit(prompt, 12)
        assert h.wait(120) and h.outcome == "completed"
        fp = taudit.ParamFingerprinter(tm, e)
        before = fp.compute()
        ver = tm._raw_params()[name]._version
        tres.install_fault_plan(
            tres.FaultPlan().fail("audit.corrupt_params", nth=1))
        after = fp.tick()
        assert tm._raw_params()[name]._version > ver
        assert torch.equal(tm._raw_params()[name], -orig)
        moved = [g for (g, a), (_, b) in zip(before, after) if a != b]
        assert moved == [name.split(".", 1)[0]]
        snap = fp.snapshot()
        assert snap["injected"] is True and fp.corrupted["param"] == name
        assert snap["fingerprint"] == [[g, v] for g, v in after]
        h2 = e.submit(prompt, 12)
        assert h2.wait(120) and h2.outcome == "completed"
        assert list(h2.tokens) != list(h.tokens)
    finally:
        e.stop()
        tres.clear_fault_plan()


def test_uniform_sign_flip_blind_spot_is_jax_s():
    """The reference fold's blind spot, kept bit for bit: flipping the sign
    of every element of an even-sized layer moves each word's mixed value
    by 2^31 + s * 2^15 * c (s = +-1 by one bit of the mixed word), so the
    sum is unchanged when the +1s and -1s balance: for a 4096-element
    layer about once in 80 draws. The first such draw of a seeded search
    fingerprints alike before and after the flip in both packages, and a
    one-bit flip of it still moves both."""

    class Holder:
        sep = "."

        def __init__(self, arr):
            self.p = torch.nn.Parameter(torch.from_numpy(arr))

        def _raw_params(self):
            return {"blk.W": self.p}

    class JHolder:
        sep = "."

        def __init__(self, arr):
            self._t = jtensor.from_numpy(arr)

        def get_params(self):
            return {"blk.W": self._t}

    rng = np.random.RandomState(0)
    for _ in range(1000):
        a = (rng.randn(32, 128) * 0.02).astype(np.float32)
        if taudit.ParamFingerprinter(Holder(a)).compute() \
                == taudit.ParamFingerprinter(Holder(-a)).compute():
            break
    else:
        pytest.fail("no cancelling draw in 1000")
    one_bit = a.copy()
    one_bit.view(np.uint32).flat[7] ^= np.uint32(1)
    for arr in (a, -a, one_bit):
        assert taudit.ParamFingerprinter(Holder(arr)).compute() \
            == jaudit.ParamFingerprinter(JHolder(arr)).compute()
    assert jaudit.ParamFingerprinter(JHolder(a)).compute() \
        == jaudit.ParamFingerprinter(JHolder(-a)).compute()
    assert taudit.ParamFingerprinter(Holder(one_bit)).compute() \
        != taudit.ParamFingerprinter(Holder(a)).compute()


# ---- the fingerprint vote, canary, replay, quarantine ------------------------

class _FakeRep:
    def __init__(self, name, state="live"):
        self.name = name
        self.state = state


class _FakeRouter:
    """tests/test_audit.py's duck-typed router."""

    def __init__(self, reps):
        self._reps = list(reps)
        self.drained = []
        self.listeners = []

    def replicas(self):
        return list(self._reps)

    def drain_replica(self, name):
        self.drained.append(name)
        for rep in self._reps:
            if rep.name == name:
                rep.state = "draining"

    def add_request_listener(self, cb):
        self.listeners.append(cb)

    def remove_request_listener(self, cb):
        if cb in self.listeners:
            self.listeners.remove(cb)


class _ScriptedRouter(_FakeRouter):
    def __init__(self, reps, script):
        super().__init__(reps)
        self.script = list(script)
        self.submits = []

    def submit(self, prompt, max_new, *, synthetic=False):
        self.submits.append((list(np.asarray(prompt).reshape(-1)),
                             int(max_new), synthetic))
        return self.script[(len(self.submits) - 1) % len(self.script)]


class _Handle:
    def __init__(self, tokens, replica, outcome="completed"):
        self.tokens = list(tokens)
        self.replica = replica
        self.outcome = outcome
        self.detail = None

    def wait(self, timeout=None):
        return True


class _Req:
    def __init__(self, rid, replica, tokens, synthetic=False,
                 outcome="completed"):
        self.id = rid
        self.prompt = np.asarray([1, 2, 3], np.int32)
        self.max_new = len(tokens)
        self.replica = replica
        self.tokens = tokens
        self.outcome = outcome
        self.synthetic = synthetic


def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _write_shard(fleet_dir, host, fingerprint, seq=1):
    path = os.path.join(fleet_dir, host + tfleet.SHARD_SUFFIX)
    rows = [
        {"kind": "fleet_shard_header", "version": tfleet.SHARD_VERSION,
         "seq": seq, "host": host, "pid": 1000 + seq,
         "ts": round(time.time(), 6), "perf": 0.0,
         "started_ts": 0.0, "steps": 0},
        {"kind": "fleet_audit",
         "audit": {"fingerprint": [[g, v] for g, v in fingerprint],
                   "count": seq, "ts": time.time(),
                   "groups": len(fingerprint), "params": len(fingerprint),
                   "injected": False}}]
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _vote(p, d):
    """tests/test_audit.py's majority-vote script on package `p`."""
    au, _obs, _h, fl, _r = p
    good = [("tok_embed", 1), ("blk0", 2), ("head", 3)]
    _write_shard(d, "r0", good)
    _write_shard(d, "r1", good)
    agg = fl.install_aggregator(d, stale_after_s=60.0)
    fr = _FakeRouter([_FakeRep(f"r{i}") for i in range(3)])
    obs = au.install_observatory(fr, sustain=2, min_replicas=1)
    try:
        agg.poll()
        first = agg.audit_dissent()
        _write_shard(d, "r2", [("tok_embed", 1), ("blk0", 99), ("head", 3)])
        roll = agg.poll()
        row = next(r for r in roll["workers"] if r["host"] == "r2")
        agg.poll()
        assert _wait_for(lambda: fr.drained == ["r2"])
        obs.stop()
        snap = obs.snapshot()
        for q in snap["quarantined"].values():
            q.pop("ts")
        report = fl.fleet_report()
        return {"first": first, "dissent": agg.audit_dissent(),
                "roll": roll["audit_dissent"], "row": row["audit"],
                "snap": snap, "drained": fr.drained,
                "integrity": report[report.index("== fleet integrity =="):
                                    report.index("fleet steps")],
                "fleetz": au.fleetz_lines()}
    finally:
        au.reset()
        fl.uninstall()


def _unanimous(p, d):
    _au, _obs, h, fl, _r = p
    for host in ("r0", "r1", "r2"):
        _write_shard(d, host, [("tok_embed", 1), ("head", 3)])
    mon = h.HealthMonitor()
    h.set_active_monitor(mon)
    agg = fl.install_aggregator(d, stale_after_s=60.0)
    try:
        roll = agg.poll()
        out = {"dissent": agg.audit_dissent(),
               "roll": roll["audit_dissent"]}
        _write_shard(d, "r2", [("tok_embed", 2), ("head", 3)])
        agg.poll()
        agg.poll()
        out["notes"] = [r["detail"] for r in mon.recorder.ring
                        if r.get("external") == h.KIND_DIVERGENCE]
        return out
    finally:
        fl.uninstall()
        h.set_active_monitor(None)


def _canary(p, d):
    au = p[0]
    good, bad = _Handle([5, 6, 7], "r0"), _Handle([5, 9, 7], "r1")
    router = _ScriptedRouter([_FakeRep("r0"), _FakeRep("r1")],
                             [good, good, bad])
    obs = au.AuditObservatory(router, sustain=99)
    pr = au.CanaryProber(obs, router, vocab=31, n_goldens=1, prompt_len=4,
                         max_new=3, seed=7)
    pr.record_goldens()
    pr.run_once()
    pr.run_once()
    err = _ScriptedRouter([_FakeRep("r0")], [_Handle([], "r0", "timeout")])
    eobs = au.AuditObservatory(err, sustain=1, min_replicas=0)
    ep = au.CanaryProber(eobs, err, vocab=31, n_goldens=1, seed=7)
    for _ in range(3):
        ep.run_once()
    return {"prompts": [x.tolist() for x in pr.prompts],
            "goldens": pr.goldens, "submits": router.submits,
            "snap": obs.snapshot(), "err": eobs.snapshot(),
            "err_drained": err.drained}


def _replay(p, d):
    au = p[0]
    router = _FakeRouter([_FakeRep(f"r{i}") for i in range(3)])
    obs = au.AuditObservatory(router, sustain=99, min_replicas=1,
                              replay_min_peers=2)

    def replay_fn(prompt, max_new, target):
        return [99] * max_new if target.name == "r2" else [1] * max_new

    rp = au.ShadowReplayer(obs, router, fraction=1.0, replay_fn=replay_fn)
    rp._on_terminal(_Req(1, "r0", [1, 1], synthetic=True), {})
    rp._on_terminal(_Req(2, "r0", [1, 1], outcome="timeout"), {})
    sampled_after_filters = rp.sampled
    rp._on_terminal(_Req(3, "r2", [7, 7]), {})
    rp._on_terminal(_Req(4, "r2", [7, 7]), {})
    rp._on_terminal(_Req(5, "r0", [1, 1, 1]), {})
    while rp.process_one():
        pass
    assert _wait_for(lambda: router.drained == ["r2"])
    obs.stop()
    snap = obs.snapshot()
    for q in snap["quarantined"].values():
        q.pop("ts")
    return {"filtered": sampled_after_filters, "sampled": rp.sampled,
            "replays": rp.replays, "snap": snap, "drained": router.drained}


def _cap_and_events(p, d):
    au, ob, h, _fl, _r = p
    router = _FakeRouter([_FakeRep("r0"), _FakeRep("r1", "dead")])
    mon = h.HealthMonitor()
    h.set_active_monitor(mon)
    try:
        obs = au.AuditObservatory(router, sustain=1, min_replicas=1)
        obs.note("r0", "canary", "mismatch", detail="probe diverged")
        obs.note("r0", "canary", "mismatch")
        capped = obs.snapshot()
        for q in capped["quarantined"].values():
            q.pop("ts")
        capped_notes = [r["detail"] for r in mon.recorder.ring
                        if r.get("external") == h.KIND_DIVERGENCE]
        obs.stop()
        router2 = _FakeRouter([_FakeRep(f"r{i}") for i in range(3)])
        obs2 = au.AuditObservatory(router2, sustain=2, min_replicas=1)
        obs2.note("r1", "canary", "match")
        obs2.note("r1", "canary", "mismatch", position=3, detail="div")
        obs2.note("r1", "canary", "mismatch", position=3, detail="div")
        assert _wait_for(lambda: router2.drained == ["r1"])
        obs2.stop()
        reg = ob.get_registry()
        events = [{k: v for k, v in e.items() if k not in ("ts", "seq")}
                  for e in reg.recent if e.get("kind") == "audit"]
        c = reg.get("singa_audit_checks_total")
        q = reg.get("singa_audit_quarantine_total")
        counts = {(leg, v): c.value(leg=leg, verdict=v)
                  for leg in au.AUDIT_LEGS for v in au.AUDIT_VERDICTS}
        qs = {leg: q.value(leg=leg) for leg in au.AUDIT_LEGS}
        ob.enable(False)
        router3 = _FakeRouter([_FakeRep(f"r{i}") for i in range(3)])
        obs3 = au.AuditObservatory(router3, sustain=1, min_replicas=1)
        obs3.note("r1", "canary", "mismatch", position=0)
        assert _wait_for(lambda: router3.drained == ["r1"])
        obs3.stop()
        silent = [e for e in reg.recent if e.get("kind") == "audit"] \
            == [e for e in reg.recent if e.get("kind") == "audit"][
                :len(events)]
        ob.enable(True)
        return {"capped": capped, "capped_notes": capped_notes,
                "events": events, "counts": counts, "quarantines": qs,
                "silent": silent,
                "notes": len([r for r in mon.recorder.ring
                              if r.get("external") == h.KIND_DIVERGENCE])}
    finally:
        ob.enable(True)
        h.set_active_monitor(None)


def _confirm(p, d, monkeypatch):
    au = p[0]
    reps = [_FakeRep(f"r{i}") for i in range(3)]
    for rep in reps:
        rep.ctl_url = f"http://127.0.0.1:1/{rep.name}"
    r = _FakeRouter(reps)
    r.get_replica = lambda name: next(
        (rep for rep in reps if rep.name == name), None)
    obs = au.install_observatory(r, sustain=2, min_replicas=1)
    prober = au.CanaryProber(obs, r, vocab=31, n_goldens=2, prompt_len=4,
                             max_new=4, seed=7)
    prober.goldens = {0: [1, 2, 3, 4], 1: [5, 6, 7, 8]}
    obs.prober = prober
    calls = []

    def fake_direct(target, prompt, max_new, **kw):
        calls.append(target.name)
        return [9, 9, 9, 9]

    monkeypatch.setattr(au, "_direct_generate", fake_direct)
    for _ in range(2):
        obs.note("r2", au.LEG_FINGERPRINT, au.VERDICT_MISMATCH,
                 detail="vote dissent")
    assert _wait_for(lambda: "r2" in r.drained)
    obs.stop()
    obs.note("r1", au.LEG_REPLAY, au.VERDICT_MISMATCH, peer="r0")
    obs.note("r1", au.LEG_REPLAY, au.VERDICT_MISMATCH, peer="r2")
    assert _wait_for(lambda: "r1" in r.drained)
    obs.stop()
    snap = obs.snapshot()
    for q in snap["quarantined"].values():
        q.pop("ts")
    au.reset()
    return {"calls": calls, "snap": snap, "drained": r.drained}


OBSERVATORY_CASES = {"vote": _vote, "unanimous": _unanimous,
                     "canary": _canary, "replay": _replay,
                     "cap_and_events": _cap_and_events,
                     "confirm": _confirm}


@pytest.mark.parametrize("case", sorted(OBSERVATORY_CASES))
def test_observatory_cases_agree(tmp_path, monkeypatch, case):
    fn = OBSERVATORY_CASES[case]
    got = {}
    for name, p in PKGS.items():
        d = str(tmp_path / name)
        os.makedirs(d)
        args = (p, d, monkeypatch) if case == "confirm" else (p, d)
        got[name] = fn(*args)
    assert got["port"] == got["jax"]
    out = got["port"]
    if case == "vote":
        assert out["first"] == {} and out["drained"] == ["r2"]
        assert out["dissent"]["r2"]["first_group"] == "blk0"
        assert out["snap"]["quarantined"]["r2"]["leg"] == "fingerprint"
    if case == "unanimous":
        assert out["dissent"] == {} and len(out["notes"]) == 1
    if case == "replay":
        assert out["filtered"] == 0 and out["drained"] == ["r2"]
    if case == "cap_and_events":
        assert out["capped"]["quarantined"]["r0"]["capped"] is True
        assert out["silent"] and out["notes"] == 3
    if case == "confirm":
        assert out["calls"] == ["r2", "r2"]


# ---- synthetic traffic ---------------------------------------------------------

def test_synthetic_traffic_moves_no_demand_signal():
    """A synthetic storm through the port router's front door stamps no
    admission or shed, so the demand forecast stays at zero while real
    submits move it; the SLO tracker drops synthetic timelines."""
    r = trouter.Router(queue_limit=8)
    try:
        for _ in range(9):
            r.submit(np.asarray([1, 2], np.int32), 4, synthetic=True)
        snap = r.snapshot()
        assert snap["admitted_rps"] == 0.0 and snap["shed_rate"] == 0.0
        f = tcapacity.DemandForecaster()
        f.update(r.admit_rate(10.0), now=1.0)
        assert f.fast == 0.0 and f.slow == 0.0
        real = r.submit(np.asarray([1, 2], np.int32), 4)
        assert real.outcome == "rejected" and r.snapshot()["shed_rate"] > 0
    finally:
        r.stop()
    r = trouter.Router(queue_limit=64)
    try:
        for _ in range(20):
            r.submit(np.asarray([1], np.int32), 2)
        f.update(r.admit_rate(10.0), now=2.0)
        assert f.fast > 0.0
    finally:
        r.stop()
    tr = tslo.SLOTracker(tslo.SLOConfig(ttft_p99_s=0.01))
    bad = {"id": 1, "outcome": "completed", "ttft_s": 5.0, "total_s": 6.0,
           "tokens_per_sec": 1.0, "events": [["terminal", 100.0, {}]]}
    for i in range(50):
        tr.note_timeline(dict(bad, id=i, synthetic=True))
    assert len(tr._records) == 0
    tr.note_timeline(dict(bad, id=999))
    assert len(tr._records) == 1


# ---- surfaces ----------------------------------------------------------------

def _get(url):
    from urllib.error import HTTPError
    from urllib.request import urlopen
    try:
        with urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except HTTPError as e:
        return e.code, e.read().decode()


def test_reports_shard_line_and_auditz(gpts, tmp_path):
    """With equal weights installed in both packages and the same verdicts
    noted, `audit_report`, `audit_json` (times left out) and
    `fleetz_lines` are equal; the port's shard carries the fingerprint in
    JAX's `fleet_audit` form; /auditz 503 before, 200 after, /statusz has
    the section."""
    jm, tm = gpts
    srv = tdiag.start_diag_server(port=0)
    try:
        st, body = _get(srv.url + "/auditz")
        assert st == 503 and "(not installed)" in body
        st, body = _get(srv.url + "/auditz?json=1")
        assert st == 503
        assert json.loads(body) == {"fingerprint": None, "observatory": None}
        got = {}
        for name, m in (("jax", jm), ("port", tm)):
            au = PKGS[name][0]
            au.install_fingerprint(m)
            fr = _FakeRouter([_FakeRep("r0")])
            obs = au.install_observatory(fr, sustain=3)
            obs.note("r0", "canary", "match")
            obs.note("r0", "replay", "mismatch", peer="r1", position=2)
            js = au.audit_json()
            js["fingerprint"].pop("ts")
            got[name] = (au.audit_report(), js, au.fleetz_lines())
        assert got["port"] == got["jax"]
        assert "replica r0" in got["port"][0]
        st, body = _get(srv.url + "/auditz")
        assert st == 200 and body.startswith("== audit ==")
        st, body = _get(srv.url + "/auditz?json=1")
        assert st == 200 and json.loads(body)["fingerprint"]["params"] > 0
        st, body = _get(srv.url + "/statusz")
        assert "== audit ==" in body and "(audit unavailable" not in body
        w = tfleet.ShardWriter(str(tmp_path), interval_s=0, host="hostP",
                               name="port")
        try:
            w.publish()
        finally:
            w.close(final_publish=False)
        a, b = tfleet.read_shard(w.path), jfleet.read_shard(w.path)
        assert a == b
        assert a["audit"]["fingerprint"] \
            == [[g, v] for g, v in jaudit.ParamFingerprinter(jm).compute()]
        taudit.reset()
        assert taudit.audit_report() == "== audit ==\n(not installed)"
        assert taudit.fleetz_lines() == []
    finally:
        jaudit.reset()
        tdiag.stop_diag_server()


def test_replica_corrupt_after_flips_at_the_nth_tick(tmp_path,
                                                    tmp_path_factory,
                                                    monkeypatch):
    """A replica process (`--device cpu --corrupt-after 3`, ticks every
    0.05 s): its shard says `injected` from the third tick on (the
    startup fingerprint is computation 1, the third tick computation 4;
    a publish between the flip and its recompute may show `injected`
    beside computation 3's checksums); every clean snapshot carries the
    fingerprint of the same seeded model built here, and computation 4's
    differs from it in one layer group."""
    args = types.SimpleNamespace(
        vocab=211, dim=64, layers=2, prompt_lo=4, prompt_hi=12, new_hi=8,
        slots=2, page_size=8, publish_interval=0.05, device="cpu",
        audit_interval=0.05, corrupt_after=3)
    d = str(tmp_path)
    with torch_ab.two_cores(tmp_path_factory, monkeypatch):
        proc, ready = trouter.spawn_replica("r0", d, args,
                                            ready_timeout_s=120)
        _watch_corruption(d, proc, ready)


def _watch_corruption(d, proc, ready):
    try:
        seen = []
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            shards = [tfleet.read_shard(os.path.join(d, f))
                      for f in os.listdir(d)
                      if f.endswith(tfleet.SHARD_SUFFIX)]
            a = next((s["audit"] for s in shards if s and s["audit"]), None)
            if a is not None:
                seen.append(a)
                if a["injected"] and a["count"] >= 4:
                    break
            time.sleep(0.02)
        assert seen and seen[-1]["injected"] and seen[-1]["count"] >= 4, \
            seen[-1:]
        assert all(s["count"] <= 3 for s in seen if not s["injected"])
        assert all(s["count"] >= 3 for s in seen if s["injected"])
        # the replica's weights, built here from the same seed
        clean = taudit.ParamFingerprinter(
            trouter._build_replica_model(211, 64, 2, 12 + 8, "cpu")).compute()
        assert all(s["fingerprint"] == [list(x) for x in clean]
                   for s in seen if not s["injected"])
        moved = [g for (g, x), (_, y) in zip(clean, seen[-1]["fingerprint"])
                 if x != y]
        assert moved == ["TransformerBlock_0"]
    finally:
        trouter._http_json(f"http://127.0.0.1:{ready['ctl_port']}/shutdown",
                           {}, timeout=10.0)
        proc.wait(timeout=30)


# ---- the command line --------------------------------------------------------

def test_audit_ab_on_cpu(tmp_path, tmp_path_factory, monkeypatch):
    """`audit --ab --device cpu` at reduced flags: the record's `ok` (zero
    lost, zero clean-arm false positives, the victim quarantined by the
    fingerprint and one more leg within the probe budget, the cap not
    hit). The processes keep to two cores, one subprocess A/B at a time
    (`torch_ab.two_cores`)."""
    out = str(tmp_path / "AUDIT_test.json")
    with torch_ab.two_cores(tmp_path_factory, monkeypatch):
        rc = taudit.main(["--ab", "--device", "cpu", "--requests", "12",
                          "--corrupt-after", "30", "--settle", "2",
                          "--timeout", "120", "--out", out])
    with open(out, encoding="utf-8") as f:
        lines = [json.loads(x) for x in f if x.strip()]
    rec = lines[-1]
    assert rc == 0 and rec["ok"] is True, rec
    assert rec["device"] == "cpu" and rec["lost_requests"] == 0
    assert rec["false_positives_clean_arm"] == 0
    assert "fingerprint" in rec["legs_detected"]
    assert len(rec["legs_detected"]) >= 2
    assert {m["metric"] for m in lines[:-1]} >= {
        "audit_false_positive_count", "audit_probes_to_detect"}
    assert not [t.name for t in threading.enumerate() if t.is_alive()
                and t.name.startswith(("singa-audit", "singa-route"))]


def test_ab_needs_the_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        taudit.main(["--ab", "--out", str(tmp_path / "a.json")])
