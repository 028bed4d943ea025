"""Live introspection server (≙ ``bigdl_tpu/observability/http.py``):
a stdlib ``http.server`` on a daemon thread rendering a Recorder that a
scraper can poll while the job runs:

  ``/metrics``   Prometheus text exposition
                 (:func:`~bigdl_tpu_torch.observability.sinks
                 .render_prometheus`): counters, gauges, histogram
                 summaries with quantiles (or buckets, where opted in)
  ``/healthz``   JSON liveness: last-step index and age, the stall
                 watchdog's verdict and budget, writer-queue depths,
                 serving shed rate, sentinel event counts.  HTTP 200 when
                 healthy, 503 when stalled or diverged
  ``/records``   the last-N records of the Recorder's ring
                 (``?n=20&type=step``)
  ``/trace``     Chrome-trace JSON of recent per-request span timelines
                 (the serving engines attach their trace ring as
                 ``trace_source``; ``?trace_id=`` keeps one request's)
  ``/series``    windowed time-series points (``?name=&window=``) of
                 the Recorder's ``keep_series=`` store or an
                 aggregator's (``series_source``); no name lists the
                 series, no store is a 404
  ``/goodput``   the device-second attribution document of the
                 recorder's attached
                 :class:`~bigdl_tpu_torch.observability.goodput
                 .GoodputLedger`

Attach with ``serve_metrics(port)`` on ``Optimizer`` / ``SpmdTrainer`` /
``ServingEngine`` / ``DecodeEngine`` / ``ReplicaSet``, or standalone::

    from bigdl_tpu_torch.observability.http import IntrospectionServer
    srv = IntrospectionServer(rec, port=9100).start()   # port=0: ephemeral
    # curl localhost:9100/metrics
    srv.stop()

``add_job`` aggregates further recorders under a ``job`` label (a replica
set's replicas).  Handlers only read snapshots under the Recorder's lock;
``ThreadingHTTPServer`` keeps one slow scraper from starving the next
probe.  ``stop()`` shuts the serving thread down and joins it.
"""
from __future__ import annotations

import contextlib
import errno
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

from .sinks import (_json_default, render_prometheus,
                    render_prometheus_multi)
from ..utils.retry import RetryPolicy


def _finite_json(obj):
    """Strict-JSON encode: non-finite floats become the strings "NaN" /
    "Inf" / "-Inf".  json.dumps would emit the bare token ``NaN``
    (invalid RFC 8259) — and a NaN loss in the ring is EXACTLY the
    record a health client wants to read, so it must stay parseable."""
    def walk(v):
        if isinstance(v, float) and not math.isfinite(v):
            if math.isnan(v):
                return "NaN"
            return "Inf" if v > 0 else "-Inf"
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [walk(x) for x in v]
        return v
    return json.dumps(walk(obj), default=_json_default)


def _filter_trace(body, trace_id: str):
    """Restrict a Chrome-trace document to one trace id: keep the
    ``"M"`` metadata rows (process/thread names) and every B/E event
    whose ``args.trace_id`` matches.  A body that isn't Chrome-trace
    JSON passes through untouched — the filter must never 500 the
    endpoint over an exotic trace_source."""
    doc = body
    if isinstance(doc, (str, bytes)):
        try:
            doc = json.loads(doc)
        except ValueError:
            return body
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return body
    events = [ev for ev in doc["traceEvents"]
              if ev.get("ph") == "M"
              or (ev.get("args") or {}).get("trace_id") == trace_id
              or (ev.get("ph") == "E" and "args" not in ev)]
    # an E event carries no args; keep it only when its B survived —
    # pair per (pid, tid) stack to drop ends of filtered-out spans
    kept, depth = [], {}
    for ev in events:
        key = (ev.get("pid"), ev.get("tid"))
        if ev.get("ph") == "B":
            depth[key] = depth.get(key, 0) + 1
            kept.append(ev)
        elif ev.get("ph") == "E" and "args" not in ev:
            if depth.get(key, 0) > 0:
                depth[key] -= 1
                kept.append(ev)
        else:
            kept.append(ev)
    out = dict(doc)
    out["traceEvents"] = kept
    return out


class IntrospectionServer:
    """One Recorder's live read surface; start()/stop() lifecycle."""

    def __init__(self, recorder, port: int = 0, host: str = "127.0.0.1",
                 watchdog=None, monitor=None, namespace: str = "bigdl",
                 records_default: int = 50, trace_source=None,
                 bind_retries: int = 4, metrics_source=None,
                 healthz_source=None, goodput_source=None,
                 series_source=None):
        self.recorder = recorder
        self.host = host
        self.port = int(port)           # 0 -> ephemeral, bound in start()
        self.watchdog = watchdog
        self.monitor = monitor
        self.namespace = namespace
        self.records_default = int(records_default)
        # zero-arg callable returning a Chrome-trace JSON string (e.g.
        # ServingEngine.dump_chrome_trace); None -> /trace is 404
        self.trace_source = trace_source
        self.bind_retries = int(bind_retries)
        # overrides for a non-Recorder-backed surface (the fleet
        # MetricsAggregator): zero-arg callables replacing the /metrics
        # body and the /healthz payload
        self.metrics_source = metrics_source
        self.healthz_source = healthz_source
        # zero-arg callable returning the goodput attribution document
        # (MetricsAggregator.goodput_doc, or a ledger's snapshot);
        # defaults to the recorder's own attached ledger
        self.goodput_source = goodput_source
        # a SeriesStore served at /series; defaults to the recorder's own
        # (Recorder(keep_series=N)), resolved per request
        self.series_source = series_source
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # fleet mode: named (recorder, watchdog, monitor) jobs this
        # server aggregates next to its own recorder.  Plain dict with
        # whole-value assignment only (GIL-atomic); scrapes iterate a
        # dict() copy, so registration needs no lock of its own
        self._jobs: Dict[str, Dict[str, Any]] = {}

    # -- lifecycle --------------------------------------------------------- #
    def start(self) -> "IntrospectionServer":
        if self._server is not None:
            return self
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):       # no per-scrape stderr spam
                pass

            def do_GET(self):
                try:
                    outer._route(self)
                except (BrokenPipeError, ConnectionResetError):
                    pass                # scraper went away mid-response
                except Exception as e:  # introspection must never crash
                    try:
                        self.send_error(500, repr(e))
                    except Exception:
                        pass

        def bind():
            from .. import faults as faultplane
            faultplane.inject("http.bind", self.recorder)
            return ThreadingHTTPServer((self.host, self.port), Handler)

        # a fixed port just vacated by a predecessor (serve_metrics
        # reconfiguration, a supervisor restart) can sit in TIME_WAIT
        # for a beat: EADDRINUSE is the one transient bind error worth
        # retrying — anything else (bad host, privileged port) is fatal
        srv = RetryPolicy(
            max_attempts=self.bind_retries, base=0.1, max_delay=1.0,
            classify=lambda e: (isinstance(e, OSError)
                                and e.errno == errno.EADDRINUSE),
            recorder_fn=lambda: self.recorder, name="http.bind",
        ).run(bind)
        srv.daemon_threads = True
        self._server = srv
        self.port = srv.server_address[1]
        self._thread = threading.Thread(target=srv.serve_forever,
                                        daemon=True,
                                        name=f"introspection:{self.port}")
        self._thread.start()
        return self

    def stop(self):
        srv, self._server = self._server, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def swap_into(self, owner, lock=None, closed_error=None):
        """Start this server as ``owner._http_server`` (the
        ``serve_metrics`` of every trainer and engine).  The server there
        before is stopped first, so that a fixed port is free again; every
        stop, which joins a thread, runs outside ``lock``.  ``lock``
        guards ``owner._http_server`` and ``owner._closed`` against a
        concurrent ``shutdown()``: a closed owner stops this server and
        raises ``closed_error``, and of two racing callers the last one
        wins.  Returns this server."""
        guard = lock if lock is not None else contextlib.nullcontext()
        with guard:
            closed, prev = getattr(owner, "_closed", False), None
            if not closed:
                prev, owner._http_server = owner._http_server, None
        if prev is not None:
            prev.stop()
        if not closed:
            self.start()
            while True:
                with guard:
                    if getattr(owner, "_closed", False):
                        break
                    prev = owner._http_server
                    if prev is None:
                        owner._http_server = self
                        return self
                    owner._http_server = None
                prev.stop()
            self.stop()
        raise closed_error

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    # -- fleet job registration -------------------------------------------- #
    def add_job(self, name: str, recorder, watchdog=None,
                monitor=None) -> "IntrospectionServer":
        """Aggregate ``recorder`` into this server under a
        ``job="<name>"`` label on every /metrics sample and a per-job
        verdict in /healthz (the aggregated ``ok`` is the worst-of).
        ``watchdog``/``monitor`` may be the object itself or a zero-arg
        callable resolved per scrape — a supervisor builds its watchdog
        lazily, after the job is registered."""
        self._jobs[str(name)] = {"recorder": recorder,
                                 "watchdog": watchdog,
                                 "monitor": monitor}
        return self

    def remove_job(self, name: str):
        self._jobs.pop(str(name), None)

    # -- routing ----------------------------------------------------------- #
    def _route(self, h: BaseHTTPRequestHandler):
        parsed = urlparse(h.path)
        if parsed.path == "/metrics":
            if self.metrics_source is not None:
                body = self.metrics_source()
            else:
                jobs = dict(self._jobs)
                if jobs:
                    sources = [(None, self.recorder)]
                    sources += [({"job": name}, j["recorder"])
                                for name, j in jobs.items()]
                    body = render_prometheus_multi(sources,
                                                   self.namespace)
                else:
                    body = render_prometheus(self.recorder,
                                             self.namespace)
            self._reply(h, 200, body,
                        "text/plain; version=0.0.4; charset=utf-8")
        elif parsed.path == "/healthz":
            payload = (self.healthz_source() if self.healthz_source
                       is not None else self.healthz())
            self._reply(h, 200 if payload["ok"] else 503,
                        _finite_json(payload), "application/json")
        elif parsed.path == "/goodput":
            if self.goodput_source is not None:
                payload = self.goodput_source()
            else:
                get_led = getattr(self.recorder, "get_ledger", None)
                led = get_led() if get_led is not None else None
                if led is None:
                    h.send_error(404, "no goodput ledger attached "
                                      "(rec.set_ledger(GoodputLedger) "
                                      "or an aggregator expose one)")
                    return
                payload = led.snapshot()
            self._reply(h, 200, _finite_json(payload),
                        "application/json")
        elif parsed.path == "/series":
            store = self.series_source
            if store is None:
                store = getattr(self.recorder, "series", None)
            if store is None:
                h.send_error(404, "no series store attached "
                                  "(Recorder(keep_series=N) or an "
                                  "aggregator expose one)")
                return
            q = parse_qs(parsed.query)
            name = q["name"][0] if q.get("name") else None
            window = float(q["window"][0]) if q.get("window") else None
            if name is None:
                payload = {"names": store.names()}
            else:
                payload = {"name": name, "window": window,
                           "points": [[t, v] for t, v in
                                      store.points(name, window)],
                           "summary": store.summary(name, window)}
            self._reply(h, 200, _finite_json(payload),
                        "application/json")
        elif parsed.path == "/records":
            q = parse_qs(parsed.query)
            n = int(q["n"][0]) if q.get("n") else self.records_default
            rec_type = q["type"][0] if q.get("type") else None
            recs = self.recorder.recent_records(n, rec_type=rec_type)
            self._reply(h, 200, _finite_json(recs), "application/json")
        elif parsed.path == "/trace":
            if self.trace_source is None:
                h.send_error(404, "no per-request trace source attached "
                                  "(serving engines expose one)")
            else:
                body = self.trace_source()
                q = parse_qs(parsed.query)
                want = q["trace_id"][0] if q.get("trace_id") else None
                if want is not None:
                    body = _filter_trace(body, want)
                if not isinstance(body, str):
                    body = json.dumps(body, default=_json_default)
                self._reply(h, 200, body, "application/json")
        else:
            h.send_error(404, "try /metrics, /healthz, /records, "
                              "/series, /goodput or /trace")

    @staticmethod
    def _reply(h: BaseHTTPRequestHandler, code: int, body: str,
               content_type: str):
        data = body.encode("utf-8")
        h.send_response(code)
        h.send_header("Content-Type", content_type)
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)

    # -- health verdict ----------------------------------------------------- #
    @staticmethod
    def _resolve(obj):
        """A watchdog/monitor registered as a zero-arg provider (fleet
        jobs build theirs lazily) resolves at scrape time."""
        return obj() if callable(obj) else obj

    def _verdict(self, rec, watchdog, monitor) -> Dict[str, Any]:
        """One source's healthz payload: liveness + queue depths +
        sentinel state.  ``ok`` is False when the watchdog says stalled
        or the monitor has tripped a fatal condition."""
        snap = rec.snapshot()
        gauges, counters = snap["gauges"], snap["counters"]
        stalled = bool(gauges.get("health/stalled", 0))
        budget = None
        watchdog = self._resolve(watchdog)
        monitor = self._resolve(monitor)
        if watchdog is not None:
            stalled = watchdog.check_once()
            budget = watchdog.budget()
        diverged = (monitor is not None and not monitor.healthy)
        out: Dict[str, Any] = {
            "ok": not (stalled or diverged),
            "stalled": stalled,
            "diverged": diverged,
            "last_step": rec.last_step(),
            "step_age_s": rec.step_age(),
            "stall_budget_s": budget,
            "health_events": counters.get("health/events", 0),
            "writer_queue_depth": {
                k: v for k, v in gauges.items()
                if k in ("dataloader/queue_depth", "checkpoint/in_flight")
                or k.startswith("serving.queue_depth.")},
        }
        requests = counters.get("serving.requests", 0)
        if requests:
            shed = (counters.get("serving.shed_queue_full", 0)
                    + counters.get("serving.shed_deadline", 0))
            out["shed_rate"] = shed / requests
        # replica-set health (serving resilience): rotation state per
        # replica, the healthy count, and the brownout flag — published
        # as gauges by ReplicaSet.check_health, folded in here so one
        # /healthz answers "how degraded is the serving fleet"
        replicas = {k: v for k, v in gauges.items()
                    if k.startswith("replica/")
                    or k in ("serving/brownout", "serving/saturation")}
        if replicas:
            out["replicas"] = replicas
        return out

    def healthz(self) -> Dict[str, Any]:
        """The /healthz JSON.  With registered fleet jobs the payload
        grows a per-job verdict map and the top-level ``ok`` becomes the
        WORST-OF: 503 iff the base source or any job is stalled or
        diverged — one probe covers the whole pool."""
        out = self._verdict(self.recorder, self.watchdog, self.monitor)
        jobs = dict(self._jobs)
        if not jobs:
            return out
        out["jobs"] = {}
        stalled, diverged = out["stalled"], out["diverged"]
        for name, j in jobs.items():
            v = self._verdict(j["recorder"], j["watchdog"], j["monitor"])
            out["jobs"][name] = v
            stalled = stalled or v["stalled"]
            diverged = diverged or v["diverged"]
        out["stalled"] = stalled
        out["diverged"] = diverged
        out["ok"] = not (stalled or diverged)
        return out
