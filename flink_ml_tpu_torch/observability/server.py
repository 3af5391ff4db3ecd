"""Embedded live-telemetry HTTP endpoint: scrape a *running* process.

The port of ``flink_ml_tpu/observability/server.py``: a stdlib
``http.server`` daemon thread, env-armed by
``FLINK_ML_TPU_METRICS_PORT`` (``0`` binds an ephemeral port; read it
back from :attr:`TelemetryServer.port`), started lazily by the first
instrumented seam that runs (api/stage.py fit/transform, the servable
``_served`` wrapper), or explicitly with ``maybe_start(port)``.

THE route table (also :data:`ROUTE_TABLE` — the dispatch map, the 404
body and this doc all render from one definition, so they cannot
drift):

================  ==========================================  =============================
route             serves                                      response with no data
================  ==========================================  =============================
``/metrics``      process registry, Prometheus text           empty exposition (0 families)
                  exposition (cumulative histograms — any
                  scraper computes its own windows)
``/healthz``      liveness + readiness JSON (status, pid,     200 ``{"status": "ok"}`` —
                  uptime); 503 + per-gate reasons while any   no gates registered means
                  readiness gate is unready (serving          ready
                  warmup registers one, serving/warmup.py)
``/slo``          live SLO verdicts (observability/slo.py)    200, verdicts evaluate over
                  over the registry's *windowed* metrics;     empty windows (every
                  violations emit events/counters on every    objective ``ok`` with 0
                  evaluation — scraping doubles as the        samples)
                  burn-rate alerter
``/serving``      the serving runtime's live status (queue    200 ``{"serving": null}`` —
                  depth, bucket table, active model version)  no runtime registered a
                  from the registered provider                provider (serving/batcher.py)
                  (serving/batcher.py)
``/drift``        live drift verdicts                         200 with an empty
                  (observability/drift.py): PSI/JS/KS per     ``servables`` map — nothing
                  servable series vs the installed            sketched yet; a servable
                  training-time baselines; evaluating emits   without a baseline reports
                  the events/gauges, so scraping doubles as   ``source: "missing"``
                  the drift alerter
``/quality``      live continuous-evaluation verdicts         200 with an empty
                  (observability/evaluation.py): AUC/logloss/ ``servables`` map — no
                  calibration from feedback-joined windows    feedback joined yet; a thin
                  vs the installed quality baselines;         window is insufficient
                  evaluating emits the events/gauges, so      evidence; no baseline →
                  scraping doubles as the quality alerter     ``source: "missing"``
``/controller``   the ops controller's live state             200 ``{"controller": null}``
                  (serving/controller.py): state machine      — no controller registered
                  position, cycle, canary version/fraction,   a provider
                  cycle outcomes, recent transitions
``/incidents``    the flight recorder's incident bundles      200 with an empty
                  (observability/flightrecorder.py) under     ``incidents`` list — nothing
                  the armed trace dir, plus the span-ring     recorded, or no trace dir
                  ``dropped_spans`` truncation count          armed
``/spans/recent`` the tracer's in-memory ring of recently     200 ``{"spans": []}``
                  closed spans (tracing.RECENT_SPANS;
                  arming the endpoint flips
                  ``tracer.keep_recent`` so request-scoped
                  spans exist even without a trace dir)
``/fleet``        the live fleet report                        200 ``{"fleet": null}`` —
                  (observability/fleet.py): membership with    no fleet dir resolves, or
                  alive/stale/dead classification, bin-exact   no member wrote a beacon
                  windowed fleet quantiles folded across       yet
                  member beacons, per-replica load rows
``/profilez``     on-demand bounded device profile             409 — capture killed
                  (observability/profiling.py): ``?ms=250``    (``FLINK_ML_TPU_PROFILE_``
                  captures a window (clamped to                ``CAPTURE=0``), another
                  ``FLINK_ML_TPU_PROFILEZ_MAX_MS``), answers   trace already active, or
                  with the parsed per-op/per-fn attribution;   not the owning process
                  one at a time, owning process only
================  ==========================================  =============================

Any other path: 404 JSON naming the known routes.

**Owning process only.** Forked children never listen:
:func:`maybe_start` refuses in any pid other than the one that imported
this module, and the fork reseed (:func:`reseed_child`) closes the
inherited listener fd and pins the module shut — children keep shipping
metric snapshots through the existing merge path instead. Binding
failures are logged once and latch the module off; telemetry must never
take the serving process down.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from flink_ml_tpu_torch.common.locks import make_lock
from flink_ml_tpu_torch.common.metrics import metrics
from flink_ml_tpu_torch.observability import tracing

__all__ = ["METRICS_PORT_ENV", "METRICS_HOST_ENV", "ROUTE_TABLE",
           "ROUTES", "TelemetryServer",
           "maybe_start", "stop", "reseed_child", "set_gate",
           "clear_gate", "readiness", "set_serving_status",
           "get_serving_status", "clear_serving_status",
           "set_controller_status", "get_controller_status",
           "clear_controller_status"]

#: env var holding the port to serve on; unset → no endpoint, ``0`` →
#: an ephemeral port (tests, the serve smoke)
METRICS_PORT_ENV = "FLINK_ML_TPU_METRICS_PORT"
#: bind address (default loopback — a sidecar scraper; widen explicitly)
METRICS_HOST_ENV = "FLINK_ML_TPU_METRICS_HOST"

#: route → (handler method name on _Handler, no-data response note) —
#: the ONE definition the dispatch, the 404 body and the module
#: docstring's table derive from
ROUTE_TABLE = {
    "/metrics": ("_route_metrics",
                 "empty Prometheus exposition (0 families)"),
    "/healthz": ("_route_healthz",
                 '200 {"status": "ok"} — no gates registered'),
    "/slo": ("_route_slo",
             "200, every objective ok with 0 samples"),
    "/serving": ("_route_serving",
                 '200 {"serving": null} — no runtime provider'),
    "/drift": ("_route_drift",
               '200 with an empty "servables" map; no baseline → '
               'source: "missing"'),
    "/quality": ("_route_quality",
                 '200 with an empty "servables" map; no joined '
                 'feedback → thin; no baseline → source: "missing"'),
    "/controller": ("_route_controller",
                    '200 {"controller": null} — no ops controller '
                    'registered a provider (serving/controller.py)'),
    "/incidents": ("_route_incidents",
                   '200 with an empty "incidents" list — the flight '
                   'recorder (observability/flightrecorder.py) has '
                   'dumped no bundle, or no trace dir is armed'),
    "/spans/recent": ("_route_spans_recent", '200 {"spans": []}'),
    "/fleet": ("_route_fleet",
               '200 {"fleet": null} — no fleet dir resolves '
               '(observability/fleet.py) or no beacons written yet'),
    "/profilez": ("_route_profilez",
                  "409 — capture killed, another trace active, or not "
                  "the owning process (observability/profiling.py)"),
}

ROUTES = tuple(ROUTE_TABLE)

_PROM_CTYPE = "text/plain; version=0.0.4; charset=utf-8"
_JSON_CTYPE = "application/json"

_log = logging.getLogger(__name__)

_lock = make_lock("observability.server")
_FAILED = object()   # latched off: bad port / bind failure / forked child
_server = None       # None | TelemetryServer | _FAILED
_owner_pid = os.getpid()
_t0 = time.monotonic()

# -- readiness gates (liveness vs readiness split) ----------------------------
# ``/healthz`` stays the liveness probe (the process answers); readiness
# is gated: a registered gate that is not yet ready flips /healthz to
# 503 with a JSON reason — how serving warmup (serving/warmup.py) keeps
# a load balancer from routing traffic at a cold compile cache. With no
# gates registered (every plain fit/serve process) /healthz is 200, as
# before.
_gates: dict = {}
_gates_lock = make_lock("observability.server.gates")

# ``/serving`` status provider: the serving runtime (serving/batcher.py)
# registers a zero-arg callable returning its live status dict (queue
# depth, bucket table, active model version); None → route answers with
# ``{"serving": null}``.
_serving_status = None

# ``/controller`` status provider: the ops controller
# (serving/controller.py) registers a zero-arg callable returning its
# live state dict (state machine position, cycle, canary, outcomes);
# None → route answers with ``{"controller": null}``.
_controller_status = None


def set_gate(name: str, ready: bool, reason: str = "") -> None:
    """Register/update a readiness gate. ``/healthz`` reports 503 until
    every registered gate is ready."""
    with _gates_lock:
        _gates[name] = (bool(ready), str(reason))


def clear_gate(name: str) -> None:
    with _gates_lock:
        _gates.pop(name, None)


def readiness() -> tuple:
    """(ready, {gate: reason}) — the unready gates and their reasons."""
    with _gates_lock:
        blocked = {n: reason for n, (ok, reason) in _gates.items()
                   if not ok}
    return (not blocked, blocked)


def set_serving_status(provider) -> None:
    """Register the ``/serving`` route's status provider (a zero-arg
    callable returning a JSON-serializable dict), or None to unregister."""
    global _serving_status
    _serving_status = provider


def get_serving_status():
    """The currently registered ``/serving`` provider (or None) — a
    runtime snapshots it at start so its stop can restore it."""
    return _serving_status


def clear_serving_status(provider=None, restore=None) -> None:
    """Unregister the ``/serving`` provider — with ``provider`` given,
    only if it is still the registered one (a runtime stopping must not
    clobber a later runtime's registration), re-installing ``restore``
    (the provider that was registered when ``provider`` took over, so a
    short-lived runtime hands the route back)."""
    global _serving_status
    if provider is None or _serving_status == provider:
        _serving_status = restore


def set_controller_status(provider) -> None:
    """Register the ``/controller`` route's status provider (a zero-arg
    callable returning a JSON-serializable dict), or None to
    unregister."""
    global _controller_status
    _controller_status = provider


def get_controller_status():
    """The currently registered ``/controller`` provider (or None)."""
    return _controller_status


def clear_controller_status(provider=None) -> None:
    """Unregister the ``/controller`` provider — with ``provider``
    given, only if it is still the registered one (the /serving
    contract: a stopping controller must not clobber a later one)."""
    global _controller_status
    if provider is None or _controller_status == provider:
        _controller_status = None


class _Handler(BaseHTTPRequestHandler):
    server_version = "flink-ml-tpu-telemetry"

    def log_message(self, fmt, *args):  # stdout silence: debug log only
        _log.debug("telemetry: " + fmt, *args)

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    # -- one method per ROUTE_TABLE row --------------------------------------
    def _route_metrics(self) -> None:
        from flink_ml_tpu_torch.observability.exporters import (
            prometheus_text,
        )

        self._send(200, prometheus_text(metrics.snapshot()),
                   _PROM_CTYPE)

    def _route_healthz(self) -> None:
        ready, blocked = readiness()
        body = {"status": "ok" if ready else "unready",
                "pid": os.getpid(),
                "uptime_s": round(time.monotonic() - _t0, 3),
                "tracing": tracing.tracer.enabled}
        if not ready:
            # 503: the readiness half of the probe — alive but not yet
            # fit to take traffic (e.g. serving warmup still compiling
            # bucket shapes)
            body["reasons"] = blocked
        self._send(200 if ready else 503, json.dumps(body),
                   _JSON_CTYPE)

    def _route_slo(self) -> None:
        from flink_ml_tpu_torch.observability import slo

        verdicts = slo.evaluate_slos(slo.active_slos(), emit=True)
        self._send(200, json.dumps(
            {"source": "windowed", "verdicts": verdicts,
             "violated": [v["slo"] for v in verdicts
                          if not v["ok"]]},
            default=str), _JSON_CTYPE)

    def _route_serving(self) -> None:
        provider = _serving_status
        status = provider() if provider is not None else None
        self._send(200, json.dumps({"serving": status},
                                   default=str), _JSON_CTYPE)

    def _route_drift(self) -> None:
        from flink_ml_tpu_torch.observability import drift
        from flink_ml_tpu_torch.observability.health import _json_safe

        # emit=True: scraping doubles as the drift alerter, exactly
        # like /slo — the verdict gauges/events land on every scrape.
        # _json_safe: never-observed series carry NaN stats, and the
        # bare NaN token is unparseable strict JSON
        self._send(200, json.dumps(
            _json_safe(drift.drift_report(emit=True)),
            default=str), _JSON_CTYPE)

    def _route_quality(self) -> None:
        from flink_ml_tpu_torch.observability import evaluation
        from flink_ml_tpu_torch.observability.health import _json_safe

        # emit=True: scraping doubles as the quality alerter, exactly
        # like /drift — verdict gauges/events land on every scrape.
        # _json_safe: an empty joined window carries NaN AUC, and the
        # bare NaN token is unparseable strict JSON
        self._send(200, json.dumps(
            _json_safe(evaluation.quality_report(emit=True)),
            default=str), _JSON_CTYPE)

    def _route_controller(self) -> None:
        from flink_ml_tpu_torch.observability.health import _json_safe

        provider = _controller_status
        status = provider() if provider is not None else None
        self._send(200, json.dumps(_json_safe({"controller": status}),
                                   default=str), _JSON_CTYPE)

    def _route_incidents(self) -> None:
        from flink_ml_tpu_torch.observability import flightrecorder

        trace_dir = tracing.tracer.trace_dir
        # include_spans=False: a polling monitor must not re-parse
        # every bundle's span evidence per scrape; the meta's own
        # "spans" count says how much each bundle holds
        rows = (flightrecorder.read_incidents(trace_dir,
                                              include_spans=False)
                if trace_dir else [])
        slim = [{k: v for k, v in r.items() if k != "recent_spans"}
                for r in rows]
        self._send(200, json.dumps(
            {"trace_dir": trace_dir, "incidents": slim,
             "dropped_spans": tracing.tracer.mirror_dropped()},
            default=str), _JSON_CTYPE)

    def _route_spans_recent(self) -> None:
        # deque.append is thread-safe but ITERATION is not: serving
        # threads ring spans concurrently, and a mid-iteration append
        # raises RuntimeError — retry
        spans = []
        for _ in range(8):
            try:
                spans = list(tracing.tracer.recent)
                break
            except RuntimeError:
                continue
        self._send(200, json.dumps({"spans": spans},
                                   default=str), _JSON_CTYPE)

    def _route_fleet(self) -> None:
        from flink_ml_tpu_torch.observability import fleet
        from flink_ml_tpu_torch.observability.health import _json_safe

        base = fleet.fleet_dir()
        resolved = fleet.find_fleet_dir(base) if base else None
        if resolved is None:
            self._send(200, json.dumps({"fleet": None,
                                        "fleetDir": base}),
                       _JSON_CTYPE)
            return
        view = fleet.FleetView(resolved)
        self._send(200, json.dumps(
            _json_safe({"fleet": view.report()}), default=str),
            _JSON_CTYPE)

    def _route_profilez(self) -> None:
        # on-demand device profile: /profilez?ms=250 captures a bounded
        # window (clamped to FLINK_ML_TPU_PROFILEZ_MAX_MS) and answers
        # with the parsed attribution. One at a time, owning process only —
        # profiling.capture_now refuses (→ 409) rather than queue: a
        # scraper must never stack blocking capture windows.
        from urllib.parse import parse_qs, urlsplit

        from flink_ml_tpu_torch.observability import profiling

        query = parse_qs(urlsplit(self.path).query)
        try:
            ms = int(query.get("ms", ["200"])[0])
            if ms <= 0:
                raise ValueError(ms)
        except (TypeError, ValueError):
            self._send(400, json.dumps(
                {"error": "ms must be a positive integer",
                 "example": "/profilez?ms=250"}), _JSON_CTYPE)
            return
        result = profiling.capture_now(ms)
        if result is None:
            self._send(409, json.dumps(
                {"error": "capture refused: disabled "
                          f"({profiling.CAPTURE_ENV}=0), another trace "
                          "active, or not the owning process"}),
                _JSON_CTYPE)
            return
        self._send(200, json.dumps(result, default=str), _JSON_CTYPE)

    def do_GET(self):  # noqa: N802 — http.server's casing
        path = self.path.split("?", 1)[0]
        if path != "/" and path.endswith("/"):
            path = path.rstrip("/")
        try:
            row = ROUTE_TABLE.get(path)
            if row is not None:
                getattr(self, row[0])()
            else:
                self._send(404, json.dumps(
                    {"error": f"no route {path!r}",
                     "routes": list(ROUTES)}), _JSON_CTYPE)
        except (BrokenPipeError, ConnectionError):
            pass  # scraper went away mid-write: not our problem
        except Exception as e:  # noqa: BLE001 — a route bug must never
            # take the serving process down; report it to the scraper
            _log.warning("telemetry route %s failed", path,
                         exc_info=True)
            try:
                self._send(500, json.dumps({"error": repr(e)}),
                           _JSON_CTYPE)
            except OSError:
                pass


class TelemetryServer:
    """The endpoint: a ThreadingHTTPServer on a daemon thread. Port 0
    resolves to the bound ephemeral port."""

    def __init__(self, port: int, host: Optional[str] = None):
        if host is None:
            host = os.environ.get(METRICS_HOST_ENV, "127.0.0.1")
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self.thread = threading.Thread(
            target=self.httpd.serve_forever,
            name="flink-ml-tpu-telemetry", daemon=True)

    def start(self) -> None:
        self.thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def maybe_start(port: Optional[int] = None) -> Optional[TelemetryServer]:
    """Start the endpoint once per owning process when armed; return it
    (or None when unarmed/latched off). ``port=None`` reads
    ``FLINK_ML_TPU_METRICS_PORT``; instrumented seams call this on
    every entry, so the unarmed fast path is one dict lookup."""
    global _server
    if _server is not None:
        return _server if isinstance(_server, TelemetryServer) else None
    if port is None:
        raw = os.environ.get(METRICS_PORT_ENV)
        if not raw:
            return None
        try:
            port = int(raw)
        except ValueError:
            _log.warning("invalid %s=%r: telemetry endpoint disabled",
                         METRICS_PORT_ENV, raw)
            with _lock:
                if _server is None:
                    _server = _FAILED
            return None
    if os.getpid() != _owner_pid:
        return None  # forked child: owning process only, by contract
    with _lock:
        if _server is None:
            try:
                srv = TelemetryServer(int(port))
                srv.start()
            except (OSError, OverflowError, ValueError) as e:
                # OverflowError: port outside 0-65535; the seams call
                # maybe_start unguarded, so ANY failure must latch the
                # endpoint off instead of re-raising on every fit
                _log.warning("telemetry endpoint failed to bind port "
                             "%s: %s", port, e)
                _server = _FAILED
                return None
            # request-scoped spans must exist for /spans/recent even
            # when no trace dir is armed
            tracing.tracer.keep_recent = True
            _server = srv
            _log.info("telemetry endpoint listening on %s:%d",
                      srv.host, srv.port)
    return _server if isinstance(_server, TelemetryServer) else None


def stop() -> None:
    """Shut the endpoint down and disarm the span ring (tests; also
    un-latches a failed start so a new port can be tried). Readiness
    gates and the /serving provider reset too — they belong to the
    runtime that registered them, which is gone."""
    global _server, _serving_status, _controller_status
    with _lock:
        srv, _server = _server, None
    if isinstance(srv, TelemetryServer):
        srv.stop()
    tracing.tracer.keep_recent = False
    with _gates_lock:
        _gates.clear()
    _serving_status = None
    _controller_status = None


def reseed_child() -> None:
    """Called in a freshly forked host-pool child: close the inherited
    listener fd (the parent keeps serving on its own copy) and latch
    this process's endpoint shut — children never listen."""
    global _server, _owner_pid
    _owner_pid = -1
    srv, _server = _server, _FAILED
    if isinstance(srv, TelemetryServer):
        try:
            srv.httpd.socket.close()
        except OSError:
            pass
