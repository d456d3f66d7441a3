"""Port parity, the live diagnostics server: singa_tpu_torch.diag against
singa_tpu.diag.

- Every endpoint of JAX's route table answers with JAX's status code on
  the same state in both packages: bare (nothing installed: /fleetz,
  /routerz and /tailz 503) and installed (a HealthMonitor with a flight
  bundle, a memory ledger, an SLO tracker, a fleet aggregator, a router
  with one stub replica, an attributed request): one parametrised test,
  a case a state.
- /metrics exposition is equal for the same records, times left out.
- /healthz answers 200, then 503 once the monitor halted, in both.
- A /flightz bundle of a port model's monitor loads in JAX's
  `health.load_flight_bundle`.
- /statusz keeps JAX's sections in JAX's order; `warmstart`, which
  ROADMAP.md Queue 1 item 7c still brings, prints JAX's "(warm-start
  unavailable: ...)" form there; /regressz, /capacityz and /auditz
  answer 503 with nothing installed, as JAX's do; /profilez on a server
  without a device raises without a card (500 naming device="cpu") and
  captures on a CPU server's device (tests/test_torch_xprof.py holds its
  rows).
"""

import json
import re
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from singa_tpu import diag as jdiag
from singa_tpu import fleet as jfleet
from singa_tpu import goodput as jgoodput
from singa_tpu import health as jhealth
from singa_tpu import memory as jmemory
from singa_tpu import observe as jobserve
from singa_tpu import router as jrouter
from singa_tpu import slo as jslo
from singa_tpu_torch import diag as tdiag
from singa_tpu_torch import fleet as tfleet
from singa_tpu_torch import goodput as tgoodput
from singa_tpu_torch import health as thealth
from singa_tpu_torch import memory as tmemory
from singa_tpu_torch import observe as tobserve
from singa_tpu_torch import router as trouter
from singa_tpu_torch import slo as tslo
from tests.test_fleet import _step_spans, _write_fake_shard

torch.set_num_threads(2)

PKGS = {
    "jax": types.SimpleNamespace(diag=jdiag, fleet=jfleet, goodput=jgoodput,
                                 health=jhealth, memory=jmemory,
                                 observe=jobserve, router=jrouter,
                                 slo=jslo),
    "port": types.SimpleNamespace(diag=tdiag, fleet=tfleet,
                                  goodput=tgoodput, health=thealth,
                                  memory=tmemory, observe=tobserve,
                                  router=trouter, slo=tslo),
}


def _clean(p):
    p.diag.stop_diag_server()
    p.goodput.uninstall()
    p.router.reset()
    p.fleet.uninstall()
    p.slo.reset()
    p.memory.reset()
    p.health.set_active_monitor(None)
    p.observe.get_registry().reset()
    p.observe.enable(True)


@pytest.fixture(autouse=True)
def _port_state():
    """Both packages' servers, routers (threads joined), aggregators,
    trackers, ledgers and monitors torn down around each test
    (tests/conftest.py cleans only the JAX package's, after its leak
    checks would have seen the port's threads)."""
    _clean(PKGS["port"])
    yield
    for p in PKGS.values():
        _clean(p)


def _get(srv, path):
    try:
        r = urllib.request.urlopen(srv.url + path, timeout=60)
        return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class _Stub:
    """A replica engine whose request completes at once (the stub of
    tests/test_router.py, trimmed to one canned request)."""

    class _Req:
        outcome, detail, ttft_s, tokens = "completed", None, 0.001, [1, 2]

        def wait(self, timeout=None):
            return True

    def submit(self, prompt, max_new):
        return self._Req()

    def stop(self, *a, **k):
        return []


PATHS = ("/", "/index", "/metrics", "/healthz", "/statusz", "/flightz",
         "/flightz?name=../../etc/passwd",
         "/flightz?name=flight_step99.jsonl", "/fleetz", "/fleetz/trace",
         "/routerz", "/routerz?json=1", "/tailz", "/tailz?json=1", "/memz",
         "/memz?json=1", "/slo", "/slo?json=1", "/stackz",
         "/stackz?json=1", "/capacityz", "/capacityz?json=1", "/auditz",
         "/auditz?json=1", "/regressz", "/regressz?json=1", "/nope")


def _install(p, tmp_path, ctls):
    """The installed state in package `p`: monitor + flight bundle, memory
    ledger, SLO tracker, aggregator over a fake spool, a router over one
    stub replica with one completed request, an attributed request."""
    mon = p.health.HealthMonitor(out_dir=str(tmp_path / "flight"))
    p.health.set_active_monitor(mon)
    mon.recorder.dump(reason="manual", step=3)
    if p is PKGS["port"]:
        p.memory.install_ledger(device="cpu")
    else:
        p.memory.install_ledger()
    p.slo.SLOTracker(p.slo.SLOConfig()).install()
    spool = str(tmp_path / "spool")
    _write_fake_shard(spool, "host0", 100, spans=_step_spans(0.005))
    _write_fake_shard(spool, "host1", 101, spans=_step_spans(0.070))
    p.fleet.install_aggregator(spool, threshold=0.5, sustain=1)
    ctl = p.router.ReplicaControl(_Stub())
    ctls.append(ctl)
    r = p.router.Router(retry_seed=0, poll_wait_s=0.3).start()
    r.add_replica("s0", ctl.url, host="s0")
    h = r.submit(np.array([1, 2], np.int32), 2)
    assert h.wait(30) and h.outcome == "completed"


@pytest.mark.parametrize("state", ["bare", "installed"])
def test_status_codes_equal(tmp_path, state):
    codes = {}
    for name, p in PKGS.items():
        ctls = []
        try:
            if state == "installed":
                _install(p, tmp_path / name, ctls)
            srv = p.diag.start_diag_server(port=0)
            codes[name] = {path: _get(srv, path)[0] for path in PATHS}
        finally:
            _clean(p)
            for c in ctls:
                c.stop()
    assert codes["port"] == codes["jax"]
    c = codes["port"]
    if state == "bare":
        assert (c["/fleetz"], c["/fleetz/trace"], c["/routerz"],
                c["/routerz?json=1"], c["/tailz"], c["/tailz?json=1"],
                c["/memz"], c["/slo"]) == (503,) * 8
    else:
        assert (c["/fleetz"], c["/routerz"], c["/tailz"], c["/memz"],
                c["/slo"], c["/flightz"]) == (200,) * 6
    assert c["/nope"] == 404 and c["/flightz?name=../../etc/passwd"] == 400
    assert (c["/capacityz"], c["/auditz"], c["/regressz"]) == (503,) * 3


def _exposition(text):
    """Prometheus text with the wall-clock samples left out."""
    return [re.sub(r"^(singa_time_seconds_total\S*) \S+$", r"\1 <t>", ln)
            for ln in text.splitlines()]


def test_metrics_exposition_equal():
    texts = {}
    for name, p in PKGS.items():
        o = p.observe
        o.get_registry().reset()
        for s in (0.01, 0.02, 0.5):
            o.record_step(s)
        o.record_comm("all_reduce", 4096, world_size=2)
        o.record_comm_host("all_reduce", 0.0, 0.003)
        o.counter("singa_test_events_total", "events").inc(3, kind="a")
        o.gauge("singa_test_depth", "depth").set(7.5)
        srv = p.diag.start_diag_server(port=0)
        try:
            st, texts[name] = _get(srv, "/metrics")
            assert st == 200
        finally:
            _clean(p)
    assert _exposition(texts["port"]) == _exposition(texts["jax"])
    assert "singa_steps_total 3" in texts["port"]


def test_healthz_turns_503_on_halt(tmp_path):
    got = {}
    for name, p in PKGS.items():
        mon = p.health.HealthMonitor(policy="halt",
                                     out_dir=str(tmp_path / name))
        srv = p.diag.start_diag_server(port=0, monitor=mon)
        try:
            st0, b0 = _get(srv, "/healthz")
            mon.note_external(p.health.KIND_STRAGGLER,
                              detail={"host": "h1"}, action="halt")
            st1, b1 = _get(srv, "/healthz")
            got[name] = (st0, json.loads(b0)["status"], st1,
                         json.loads(b1)["status"])
        finally:
            _clean(p)
    assert got["port"] == got["jax"] == (200, "idle", 503, "halt")


def test_flightz_bundle_loads_in_jax(tmp_path):
    """A port model trained three steps under a HealthMonitor, its flight
    bundle dumped, fetched over /flightz and read by JAX's loader."""
    from singa_tpu_torch import layer, model, opt, tensor
    from singa_tpu_torch import device as tdevice

    class MLP(model.Model):
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
            self.optimizer(loss)
            return out, loss

    dev = tdevice.create_cpu_device()
    rng = np.random.RandomState(0)
    tx = tensor.from_numpy(rng.randn(32, 10).astype(np.float32), dev)
    ty = tensor.from_numpy(rng.randint(0, 4, 32).astype(np.int32), dev)
    m = MLP()
    m.set_optimizer(opt.SGD(lr=0.1))
    mon = thealth.HealthMonitor(out_dir=str(tmp_path))
    m.compile([tx], is_train=True, use_graph=True, health=mon)
    srv = tobserve.start_diag_server(port=0, model=m, device=dev)
    for _ in range(3):
        m(tx, ty)
    mon.recorder.dump(reason="manual", step=3)
    st, body = _get(srv, "/flightz")
    assert st == 200
    assert json.loads(body)["bundles"] == ["flight_step3.jsonl"]
    st, body = _get(srv, "/flightz?name=flight_step3.jsonl")
    assert st == 200
    fetched = tmp_path / "fetched.jsonl"
    fetched.write_text(body)
    b = jhealth.load_flight_bundle(str(fetched))
    assert b["header"]["reason"] == "manual" and b["header"]["step"] == 3
    assert len(b["steps"]) == 3
    assert b == thealth.load_flight_bundle(str(fetched))
    st, text = _get(srv, "/statusz")
    assert st == 200 and "== health ==" in text


_SECTION = re.compile(r"^(?:== (?:singa_tpu(?:_torch)? )?(\S.*?) ==|"
                      r"\((\S+) unavailable)")


def _sections(text):
    """The /statusz section labels in order ("== x ==" or "(x
    unavailable: ...)"), the header's and the explain report's names
    unified."""
    out = []
    for part in text.split("\n\n"):
        m = _SECTION.match(part)
        if m is None:
            continue
        label = (m.group(1) or m.group(2)).replace("-", " ")
        out.append(label.split(":")[0].split(" /statusz")[0]
                   .split(" introspect")[0] or label)
    return out


def test_statusz_sections_and_item7_endpoints():
    texts = {}
    for name, p in PKGS.items():
        srv = p.diag.start_diag_server(port=0)
        try:
            st, texts[name] = _get(srv, "/statusz")
            assert st == 200
            if name == "port":
                st, body = _get(srv, "/regressz")
                assert st == 503
                assert "no RegressionDetector installed" in body
                st, body = _get(srv, "/regressz?json=1")
                assert st == 503
                assert json.loads(body)["installed"] is False
                # capacity and audit answer as JAX's do with nothing
                # installed (tests/test_torch_capacity.py and
                # test_torch_audit.py install them)
                st, body = _get(srv, "/capacityz")
                assert st == 503 and "no ShadowScaler installed" in body
                st, body = _get(srv, "/auditz")
                assert st == 503 and "(not installed)" in body
                if not torch.cuda.is_available():
                    st, body = _get(srv, "/profilez?steps=1&seconds=0")
                    assert st == 500 and 'device="cpu"' in body
                _st, idx = _get(srv, "/")
                for ep in ("/fleetz", "/routerz", "/tailz", "/profilez"):
                    assert ep in idx
        finally:
            _clean(p)
    jax_secs, port_secs = _sections(texts["jax"]), _sections(texts["port"])
    assert port_secs == jax_secs, (port_secs, jax_secs)
    assert jax_secs[-5:] == ["capacity", "audit", "regress", "warm start",
                             "health"]
    assert "== warm start ==\nwarm store not enabled" in texts["port"]
    assert "== regress ==" in texts["port"]
    assert "== capacity ==" in texts["port"] and "== audit ==" in texts["port"]
