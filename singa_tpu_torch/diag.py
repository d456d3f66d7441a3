"""Live diagnostics HTTP server (counterpart of singa_tpu/diag.py): the
telemetry, reachable mid-run.

A stdlib `ThreadingHTTPServer` (daemon threads, ephemeral port by
default) serves the process's telemetry while the job runs, with the JAX
package's route table and status codes:

  /          endpoint index
  /metrics   Prometheus text exposition (observe.to_prometheus_text;
             the goodput tracker's residual is flushed first)
  /healthz   the HealthMonitor's verdict as JSON (HTTP 503 once the
             halt policy has fired)
  /statusz   one text page: explain report (introspect), goodput,
             resilience, watchdog, serving (with the router's rows), SLO
             and health sections, in the JAX package's order
  /flightz   flight-bundle index; ?name=<bundle> streams one bundle's
             JSONL (loads in health.load_flight_bundle of either package)
  /fleetz    the installed fleet.FleetAggregator's per-host table
             (503 without one); /fleetz/trace its merged trace
  /routerz   the installed router.Router's control plane (503 without
             one); ?json=1 structured
  /tailz     tail-latency attribution (slo); 503 before any request
             was attributed
  /memz      the live device-memory ledger (memory); ?json=1 timeline
  /slo       serving-SLO state (slo); ?json=1 structured
  /stackz    all-thread Python stack dump (watchdog.thread_stacks);
             ?json=1 structured

  /capacityz the capacity observatory (capacity); ?json=1 structured;
             503 until a ShadowScaler is installed
  /auditz    the correctness observatory (audit); ?json=1 structured;
             503 until a fingerprinter or an observatory is installed

The endpoints of the modules that ROADMAP.md Queue 1 item 7 still brings
answer as the JAX package's do with nothing installed: /regressz 503 with
a body naming the module and the item; /profilez 501 until `xprof` (and
the device trace it reads) is ported. /statusz prints those modules'
sections in the JAX form "(regress unavailable: ...)".

Start it with `observe.start_diag_server(port=0)` (port 0 = ephemeral;
default port comes from `SINGA_TPU_DIAG_PORT`). Starting the server
installs the goodput tracker. `stop_diag_server()` shuts it down.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from . import goodput, observe

_BUNDLE_RE = re.compile(r"^flight_[A-Za-z0-9_.-]+\.jsonl$")

#: the modules whose endpoints and /statusz sections wait for ROADMAP.md
#: Queue 1 item 7, with the label of their /statusz section
_ITEM7 = (("regress", "regress"), ("warmstart", "warm-start"))


def _item7(module: str) -> str:
    return (f"singa_tpu_torch.{module} is not ported yet "
            "(ROADMAP.md Queue 1 item 7)")


class _Handler(BaseHTTPRequestHandler):
    # served by daemon threads; never write to stderr per request
    def log_message(self, fmt, *args):
        pass

    @property
    def diag(self) -> "DiagServer":
        return self.server.diag  # type: ignore[attr-defined]

    def _send(self, body, status=200, ctype="text/plain; charset=utf-8"):
        if isinstance(body, str):
            body = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj, status=200):
        self._send(json.dumps(obj, indent=1, default=str), status=status,
                   ctype="application/json")

    def do_GET(self):  # noqa: N802 (http.server contract)
        url = urlparse(self.path)
        q = parse_qs(url.query)
        try:
            route = {
                "/": self._index, "/index": self._index,
                "/metrics": self._metrics,
                "/healthz": self._healthz,
                "/statusz": self._statusz,
                "/flightz": self._flightz,
                "/fleetz": self._fleetz,
                "/fleetz/trace": self._fleetz_trace,
                "/routerz": self._routerz,
                "/capacityz": self._capacityz,
                "/auditz": self._auditz,
                "/regressz": self._regressz,
                "/tailz": self._tailz,
                "/memz": self._memz,
                "/slo": self._sloz,
                "/stackz": self._stackz,
                "/profilez": self._profilez,
            }.get(url.path.rstrip("/") or "/")
            if route is None:
                self._send(f"404: no endpoint {url.path}\n", status=404)
                return
            route(q)
        except Exception as e:  # surface, don't kill the handler thread
            try:
                self._send(f"500: {type(e).__name__}: {e}\n", status=500)
            except Exception:
                pass

    # ---- endpoints -------------------------------------------------------
    def _index(self, q):
        self._send(
            "singa_tpu_torch diag server\n"
            "  /metrics      Prometheus text\n"
            "  /healthz      HealthMonitor verdict (JSON)\n"
            "  /statusz      explain + goodput + recompile blame (text)\n"
            "  /flightz      flight-bundle index; ?name=<bundle> fetches\n"
            "  /fleetz       aggregated per-host fleet status (text)\n"
            "  /fleetz/trace merged Perfetto/Chrome trace (JSON)\n"
            "  /routerz      serving control plane: replica states, "
            "shed/failover/retry counters + recent request "
            "timelines; ?json=1 for the structured form\n"
            "  /capacityz    capacity observatory: per-replica "
            "headroom table, demand forecast, shadow-scaler "
            "decision tail + counterfactual accuracy; ?json=1 for "
            "the structured form\n"
            "  /auditz       correctness observatory: per-layer-group "
            "param fingerprint, canary/replay verdict table per "
            "replica, quarantine ledger; ?json=1 for the structured "
            "form\n"
            "  /regressz     performance regression observatory: "
            "per-signal latency baseline + CUSUM table, verdict "
            "tail with attributed causes, evidence-bundle index; "
            "?json=1 for the structured form\n"
            "  /tailz        tail-latency attribution: p99 "
            "contribution per LATENCY_ATTR bucket; ?json=1 for "
            "the structured form\n"
            "  /memz         live device-memory ledger breakdown; "
            "?json=1 for the timeline JSON\n"
            "  /slo          serving SLO attainment + error-budget "
            "burn rates + violating request timelines; ?json=1 for "
            "the structured form\n"
            "  /stackz       all-thread Python stack dump; "
            "?json=1 for the structured form\n"
            "  /profilez     on-demand device trace (501 until "
            "ROADMAP.md Queue 1 item 7)\n")

    def _metrics(self, q):
        gp = goodput.get_tracker()
        if gp is not None:
            gp.snapshot()  # flush pending step + residual into `other`
        self._send(observe.to_prometheus_text(),
                   ctype="text/plain; version=0.0.4; charset=utf-8")

    def _monitor(self):
        if self.diag.monitor is not None:
            return self.diag.monitor
        from . import health
        return health.active_monitor()

    def _healthz(self, q):
        mon = self._monitor()
        if mon is None:
            self._send_json({"status": "unmonitored",
                             "detail": "no HealthMonitor attached"})
            return
        v = mon.verdict()
        self._send_json(v, status=503 if v.get("status") == "halt" else 200)

    def _statusz(self, q):
        from . import introspect
        parts = [f"== singa_tpu_torch /statusz ==  pid {os.getpid()}  "
                 f"uptime {time.monotonic() - self.diag.started_mono:.1f}s"]
        try:
            rep = introspect.explain(model=self.diag.model,
                                     device=self.diag.device)
            parts.append(introspect.format_explain(rep))
        except Exception as e:
            parts.append(f"(explain unavailable: {e})")
        parts.append(goodput.goodput_report())
        try:
            from . import overlap
            parts.append(overlap.overlap_report())
        except Exception as e:
            parts.append(f"(overlap unavailable: {e})")
        try:
            from . import resilience
            parts.append(resilience.resilience_report())
        except Exception as e:
            parts.append(f"(resilience unavailable: {e})")
        try:
            from . import watchdog
            parts.append(watchdog.watchdog_report())
        except Exception as e:
            parts.append(f"(watchdog unavailable: {e})")
        try:
            from . import engine
            parts.append(engine.serving_report())
        except Exception as e:
            parts.append(f"(serving unavailable: {e})")
        try:
            from . import slo
            parts.append(slo.slo_report())
        except Exception as e:
            parts.append(f"(slo unavailable: {e})")
        try:
            from . import capacity
            parts.append(capacity.capacity_report())
        except Exception as e:
            parts.append(f"(capacity unavailable: {e})")
        try:
            from . import audit
            parts.append(audit.audit_report())
        except Exception as e:
            parts.append(f"(audit unavailable: {e})")
        for module, label in _ITEM7:
            parts.append(f"({label} unavailable: {_item7(module)})")
        mon = self._monitor()
        if mon is None:
            parts.append("== health ==\nno HealthMonitor attached")
        else:
            v = mon.verdict()
            parts.append("== health ==\n" + json.dumps(v, default=str))
        self._send("\n\n".join(parts) + "\n")

    def _flight_dir(self):
        mon = self._monitor()
        if mon is not None:
            return mon.recorder.out_dir
        return self.diag.flight_dir

    def _flightz(self, q):
        d = self._flight_dir()
        name = (q.get("name") or [None])[0]
        if name is None:
            bundles = []
            if d and os.path.isdir(d):
                bundles = sorted(f for f in os.listdir(d)
                                 if _BUNDLE_RE.match(f))
            self._send_json({"dir": d, "bundles": bundles})
            return
        # basename-only, pattern-pinned: no path traversal out of the dir
        if not _BUNDLE_RE.match(name) or not d:
            self._send(f"400: bad bundle name {name!r}\n", status=400)
            return
        path = os.path.join(d, name)
        if not os.path.isfile(path):
            self._send(f"404: no bundle {name}\n", status=404)
            return
        with open(path, "rb") as f:
            self._send(f.read(), ctype="application/x-ndjson")

    def _fleetz(self, q):
        """Aggregated fleet status: per-host step rate, goodput ratio,
        straggler score, shard staleness — the coordinator's one-page
        answer to "which host is slow?". Served from the process's
        installed fleet.FleetAggregator (fleet)."""
        from . import fleet
        self._send(fleet.fleet_report() + "\n",
                   status=200 if fleet.get_aggregator() is not None
                   else 503)

    def _routerz(self, q):
        """The serving control plane: per-replica state
        (live/draining/dead), router queue depth, shed/failover/retry
        counters, and a bounded tail of recent request timelines —
        served from the process's installed router.Router
        (router). `?json=1` returns the snapshot plus the
        per-request timelines (trace ids, hop marks, attribution)."""
        from . import router
        status = 200 if router.get_router() is not None else 503
        if (q.get("json") or ["0"])[0] not in ("0", "", "false"):
            self._send_json(router.router_json(), status=status)
            return
        self._send(router.router_report() + "\n", status=status)

    def _pending(self, q, module):
        """An endpoint of a module that item 7 brings: 503, as the JAX
        package answers with nothing installed."""
        if (q.get("json") or ["0"])[0] not in ("0", "", "false"):
            self._send_json({"installed": False, "detail": _item7(module)},
                            status=503)
        else:
            self._send(f"503: {_item7(module)}\n", status=503)

    def _capacityz(self, q):
        """The capacity observatory (capacity): the per-replica headroom
        table with each replica's binding wall, the demand forecast, the
        shadow scaler's recent decisions with reason codes, and the
        counterfactual accuracy scorecard. `?json=1` returns the scaler
        snapshot plus the full decision ring. 503 until a ShadowScaler is
        installed."""
        from . import capacity
        status = 200 if capacity.get_scaler() is not None else 503
        if (q.get("json") or ["0"])[0] not in ("0", "", "false"):
            self._send_json(capacity.capacity_json(), status=status)
        else:
            self._send(capacity.capacity_report() + "\n", status=status)

    def _regressz(self, q):
        """The regression observatory (JAX package: singa_tpu.regress)."""
        self._pending(q, "regress")

    def _auditz(self, q):
        """The serving correctness observatory (audit): this process's
        per-layer-group param fingerprint, the per-replica canary/replay
        verdict table, and the quarantine ledger. `?json=1` returns the
        structured form. 503 until a fingerprinter or an observatory is
        installed."""
        from . import audit
        status = 200 if (audit.get_fingerprinter() is not None
                         or audit.get_observatory() is not None) else 503
        if (q.get("json") or ["0"])[0] not in ("0", "", "false"):
            self._send_json(audit.audit_json(), status=status)
        else:
            self._send(audit.audit_report() + "\n", status=status)

    def _tailz(self, q):
        """Tail-latency attribution: every terminal request's wall
        time decomposed into slo.LATENCY_ATTR buckets, aggregated as
        each bucket's p99 CONTRIBUTION to the fleet tail — the
        one-page answer to "where did the p99 go". `?json=1` returns
        the summary plus a bounded tail of per-request records. 503
        until any request has been attributed."""
        from . import slo
        status = 200 if slo.tail_records() else 503
        if (q.get("json") or ["0"])[0] not in ("0", "", "false"):
            self._send_json(slo.tail_json(), status=status)
            return
        self._send(slo.tail_report() + "\n", status=status)

    def _fleetz_trace(self, q):
        """The merged Perfetto/Chrome trace (Trace Event Format JSON,
        one track per host) built from every worker's published span
        records, clocks aligned — download and open in Perfetto."""
        from . import fleet
        agg = fleet.get_aggregator()
        if agg is None:
            self._send_json(
                {"error": "no FleetAggregator installed "
                          "(singa_tpu_torch.fleet.install_aggregator)"},
                status=503)
            return
        agg.poll()
        self._send_json(agg.trace_events())

    def _memz(self, q):
        """Live device-memory breakdown from the installed
        memory.MemoryLedger: region table + reconciliation + the
        static introspect HBM view side-by-side (estimate-vs-actual
        drift) + leak state + timeline tail. `?json=1` returns the
        full timeline as JSON. 503 until a ledger is installed."""
        from . import memory
        led = memory.get_ledger()
        if led is None:
            body = memory.memz_report()  # the "not installed" text
            self._send(body + "\n", status=503)
            return
        if (q.get("json") or ["0"])[0] not in ("0", "", "false"):
            self._send_json(memory.memz_json())
            return
        self._send(memory.memz_report() + "\n")

    def _sloz(self, q):
        """Serving-SLO state from the installed slo.SLOTracker: the
        declared objectives, per-objective attainment over the sliding
        window, fast/slow error-budget burn rates, breach state, and
        the recent VIOLATING request ids with their phase-stamped
        timelines. `?json=1` returns the structured form. 503 until a
        tracker is installed."""
        from . import slo
        status = 200 if slo.get_tracker() is not None else 503
        if (q.get("json") or ["0"])[0] not in ("0", "", "false"):
            self._send_json(slo.slo_json(), status=status)
        else:
            self._send(slo.slo_report() + "\n", status=status)

    def _stackz(self, q):
        """On-demand all-thread stack dump — the hang-forensics capture
        (`watchdog.thread_stacks`, `sys._current_frames` joined against
        `threading.enumerate`) served live: when a run LOOKS wedged,
        this names the frame every thread is parked in without
        attaching a debugger or waiting for the watchdog's own dump
        stage. `?json=1` returns the structured form."""
        from . import watchdog
        stacks = watchdog.thread_stacks()
        if (q.get("json") or ["0"])[0] not in ("0", "", "false"):
            self._send_json(stacks)
            return
        self._send(watchdog.format_stacks(stacks) + "\n")

    def _profilez(self, q):
        """On-demand device trace: it reads `xprof`'s op table over
        `Device.StartTrace`/`StopTrace`, which come with ROADMAP.md Queue 1
        item 7; until then 501."""
        self._send("501: /profilez needs singa_tpu_torch.xprof and "
                   "Device.StartTrace (ROADMAP.md Queue 1 item 7)\n",
                   status=501)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class DiagServer:
    """The running server: `.port`, `.url`, `.stop()`. Context over the
    process-global telemetry; `model`/`device`/`monitor` enrich
    /statusz, /healthz and /flightz when provided."""

    def __init__(self, port=0, host="127.0.0.1", model=None, device=None,
                 monitor=None, flight_dir="."):
        self.model = model
        self.device = device
        self.monitor = monitor
        self.flight_dir = flight_dir
        self.started_mono = time.monotonic()
        self._httpd = _Server((host, int(port)), _Handler)
        self._httpd.diag = self  # type: ignore[attr-defined]
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name=f"singa-diag-{self.port}", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


_server: "DiagServer | None" = None
_lock = threading.Lock()


def start_diag_server(port=None, host="127.0.0.1", model=None, device=None,
                      monitor=None, flight_dir=None) -> DiagServer:
    """Start (or return) the process diag server. `port=None` reads
    `SINGA_TPU_DIAG_PORT` (default 0 = OS-assigned ephemeral port).
    Installs the goodput tracker: a live /statusz without the wall-time
    ledger would be half an answer. When a server is already running,
    explicitly passed context (model/device/monitor/flight_dir) is
    applied to it — a library can start the server early and the
    training script enrich it later — but the listening port cannot
    change; stop_diag_server() first to rebind."""
    global _server
    with _lock:
        if _server is not None:
            for attr, val in (("model", model), ("device", device),
                              ("monitor", monitor),
                              ("flight_dir", flight_dir)):
                if val is not None:
                    setattr(_server, attr, val)
            return _server
        if port is None:
            port = int(os.environ.get("SINGA_TPU_DIAG_PORT", "0"))
        goodput.install()
        _server = DiagServer(port=port, host=host, model=model,
                             device=device, monitor=monitor,
                             flight_dir="." if flight_dir is None
                             else flight_dir)
        return _server


def get_diag_server() -> "DiagServer | None":
    return _server


def stop_diag_server():
    """Shut the server down (idempotent; leaves goodput tracking to its
    own lifecycle)."""
    global _server
    with _lock:
        if _server is not None:
            _server.stop()
            _server = None


__all__ = ["DiagServer", "start_diag_server", "stop_diag_server",
           "get_diag_server"]
