"""Fleet-wide /metrics aggregation (≙
``bigdl_tpu/observability/aggregate.py``): scrape N endpoints, serve one.

A replica set and a fleet of trainers are N independent /metrics
surfaces; SLO-driven autoscaling wants ONE.  :class:`MetricsAggregator`
polls each source (an in-process :class:`Recorder`, a live
``http://host:port`` base URL, or any zero-arg callable returning
exposition text), parses the Prometheus text back into typed samples
(:func:`parse_prometheus`), and re-exposes:

  * one merged ``/metrics`` where every sample carries a
    ``source="<name>"`` label (and ``stale="1"`` when that source's last
    successful scrape is older than ``stale_after``): a dead member's
    last samples are RETAINED and flagged, never silently dropped;
  * one worst-of ``/healthz`` (503 iff any source is unhealthy or stale);
  * a :class:`~bigdl_tpu_torch.observability.timeseries.SeriesStore` fed
    on every scrape (series key ``<source>/<metric>``, summary quantiles
    flattened to ``/p50``/``/p95``/``/p99`` suffixes), which the
    :class:`~bigdl_tpu_torch.observability.slo.SLOEngine` evaluates and
    ``/series`` serves;
  * the fleet's ``/goodput`` roll-up and a merged ``/trace``.

A deliberately removed member (``remove_member``: the autoscaler's scale
down) leaves the exposition, the store and the per-source gauges
(:meth:`Recorder.drop_gauges`; the reference deletes them through its
``reset_gauges``, which the port's zeroes).  ``clock`` is injectable, so
staleness and window math are deterministic under test.  Every HTTP read
has the ``timeout``; :meth:`MetricsAggregator.stop` joins the scrape
thread with a time-out.

One-call attachment: anything with ``telemetry_sources()`` (ReplicaSet,
DecodeEngine, ServingEngine, FleetScheduler, Optimizer) registers all its
recorders at once::

    agg = MetricsAggregator()
    agg.add(replica_set, name="serve")
    agg.add(trainer, name="train")
    agg.scrape()                       # or agg.start(interval=5.0)
    srv = agg.serve(port=9200)         # fleet /metrics + /healthz + /series
"""
from __future__ import annotations

import json
import re
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

from .http import IntrospectionServer
from .recorder import Recorder
from .sinks import (_collect_prometheus, _emit_prometheus, _prom_group,
                    _prom_labels, _prom_value, render_prometheus)
from .timeseries import SeriesStore

Sample = Tuple[str, Dict[str, str], float]

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)\s*(\{.*\})?\s+(\S+)(?:\s+-?\d+)?$")


def _parse_label_block(block: str) -> Dict[str, str]:
    """Parse ``{k="v",...}`` honouring ``\\\\``, ``\\"`` and ``\\n``
    escapes inside values."""
    out: Dict[str, str] = {}
    i, n = 1, len(block)                 # skip leading '{'
    while i < n:
        while i < n and block[i] in ", ":
            i += 1
        if i >= n or block[i] == "}":
            break
        j = block.index("=", i)
        key = block[i:j].strip()
        i = j + 1
        if i >= n or block[i] != '"':
            raise ValueError(f"unquoted label value near {block[i:]!r}")
        i += 1
        buf = []
        while i < n:
            c = block[i]
            if c == "\\" and i + 1 < n:
                nxt = block[i + 1]
                buf.append({"n": "\n", '"': '"', "\\": "\\"}
                           .get(nxt, "\\" + nxt))
                i += 2
                continue
            if c == '"':
                i += 1
                break
            buf.append(c)
            i += 1
        out[key] = "".join(buf)
    return out


def parse_prometheus(text: str) -> Dict[str, Any]:
    """Parse exposition text (version 0.0.4) back into typed samples:
    ``{"samples": [(name, labels, value), ...], "types": {metric:
    type}, "help": {metric: help}}``.  Malformed lines are skipped —
    one bad sample from one replica must not poison the fleet scrape."""
    samples: List[Sample] = []
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                types[parts[2]] = parts[3] if len(parts) > 3 else "untyped"
            elif len(parts) >= 3 and parts[1] == "HELP":
                helps[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, block, value = m.group(1), m.group(2), m.group(3)
        try:
            labels = _parse_label_block(block) if block else {}
            samples.append((name, labels, float(value)))
        except (ValueError, IndexError):
            continue
    return {"samples": samples, "types": types, "help": helps}


def _base_metric(name: str, types: Dict[str, str]) -> str:
    """``_sum``/``_count``/``_bucket`` samples belong to their declared
    summary/histogram metric's HELP/TYPE group."""
    for suffix in ("_sum", "_count", "_bucket"):
        if name.endswith(suffix):
            base = name[:-len(suffix)]
            if types.get(base) in ("summary", "histogram"):
                return base
    return name


def series_key(source: str, name: str, labels: Dict[str, str]) -> str:
    """The SeriesStore key for one scraped sample:
    ``<source>/<metric>`` plus sorted non-synthetic labels; a summary's
    ``quantile="0.99"`` flattens to a ``/p99`` suffix so one objective
    pattern (``*decode*ttft_ms/p99``) matches both raw recorder series
    and aggregated ones."""
    labels = {k: v for k, v in labels.items()
              if k not in ("source", "stale")}
    q = labels.pop("quantile", None)
    key = f"{source}/{name}"
    if labels:
        inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
        key += "{" + inner + "}"
    if q is not None:
        try:
            key += f"/p{float(q) * 100:g}"
        except ValueError:
            key += f"/q{q}"
    return key


class MetricsAggregator:
    """Scrape many /metrics sources into one surface + series store."""

    def __init__(self, namespace: str = "bigdl", stale_after: float = 10.0,
                 clock: Optional[Callable[[], float]] = None,
                 series_capacity: int = 512, timeout: float = 2.0,
                 series_filter: Optional[Callable[[str], bool]] = None,
                 recorder: Optional[Recorder] = None):
        self.namespace = namespace
        self.stale_after = float(stale_after)
        self.clock = clock if clock is not None else time.time
        self.timeout = float(timeout)
        # keep-or-drop predicate on series keys; None keeps everything
        # (bounded by series_capacity points per key)
        self.series_filter = series_filter
        self.recorder = recorder if recorder is not None \
            else Recorder()
        self.store = SeriesStore(capacity=series_capacity,
                                 clock=self.clock)
        self._lock = threading.Lock()
        self._sources: Dict[str, Dict[str, Any]] = {}
        # label -> trace source (Tracer/SpanStore/TraceRing/engine with
        # a .trace_ring) for the merged /trace document
        self._trace_sources: Dict[str, Any] = {}
        # job name -> GoodputLedger (or any object with snapshot());
        # rolled up into the fleet /goodput document plus pool-level
        # goodput/* gauges on the aggregator's own recorder
        self._goodput_sources: Dict[str, Any] = {}
        # the DevicePool's OwnershipLedger: unclaimed device-seconds
        # are POOL idle, attributed separately from any job's badput
        self._pool_ledger: Optional[Any] = None
        self._server: Optional[IntrospectionServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- source registration ---------------------------------------------- #
    def add_source(self, name: str, fetch: Callable[[], str],
                   healthz: Optional[Callable[[], Dict[str, Any]]] = None
                   ) -> "MetricsAggregator":
        """Register a raw source: ``fetch()`` returns exposition text,
        ``healthz()`` (optional) a PR-11-shaped verdict dict."""
        with self._lock:
            self._sources[str(name)] = {
                "fetch": fetch, "healthz": healthz,
                "samples": [], "types": {},
                "last_ok": None, "last_err": None, "stale": False,
                "scrapes": 0, "errors": 0, "health": None,
            }
        return self

    def add_recorder(self, name: str, recorder) -> "MetricsAggregator":
        """In-process source: rendered and re-parsed through the same
        pipeline as remote ones, so there is exactly one merge path."""
        probe = IntrospectionServer(recorder, namespace=self.namespace)
        return self.add_source(
            name, lambda: render_prometheus(recorder, self.namespace),
            healthz=probe.healthz)

    def add_endpoint(self, name: str, base_url: str
                     ) -> "MetricsAggregator":
        """Remote source scraped over HTTP: ``<base_url>/metrics`` for
        samples, ``<base_url>/healthz`` for the verdict (a 503 still
        carries the JSON body — that IS the verdict, not an error)."""
        base = base_url.rstrip("/")

        def fetch() -> str:
            with urllib.request.urlopen(base + "/metrics",
                                        timeout=self.timeout) as r:
                return r.read().decode("utf-8")

        def healthz() -> Optional[Dict[str, Any]]:
            try:
                try:
                    with urllib.request.urlopen(
                            base + "/healthz", timeout=self.timeout) as r:
                        body = r.read()
                except urllib.error.HTTPError as e:
                    body = e.read()
                return json.loads(body.decode("utf-8"))
            except Exception:
                return None

        return self.add_source(name, fetch, healthz=healthz)

    def add(self, obj, name: Optional[str] = None) -> "MetricsAggregator":
        """One-call attachment.  ``obj`` may be anything with
        ``telemetry_sources() -> [(sub_name, recorder), ...]``
        (ReplicaSet, DecodeEngine, FleetScheduler, Optimizer, ...), a
        Recorder, an ``http://...`` base URL, or a zero-arg callable
        returning exposition text.  ``name`` prefixes (or names) the
        registered source(s)."""
        hook = getattr(obj, "telemetry_sources", None)
        if hook is not None:
            for sub, rec in hook():
                self.add_recorder(f"{name}.{sub}" if name else str(sub),
                                  rec)
            return self
        if isinstance(obj, str):
            return self.add_endpoint(name or obj, obj)
        if hasattr(obj, "snapshot") and hasattr(obj, "hist_names"):
            return self.add_recorder(name or "recorder", obj)
        if callable(obj):
            return self.add_source(name or getattr(obj, "__name__",
                                                   "source"), obj)
        raise TypeError(f"don't know how to scrape {type(obj).__name__}")

    def remove_source(self, name: str):
        with self._lock:
            self._sources.pop(str(name), None)

    # -- merged tracing ---------------------------------------------------- #
    def add_trace_source(self, name: str, source) -> "MetricsAggregator":
        """Register a span source for the merged ``/trace`` document: a
        :class:`~.tracing.Tracer` / :class:`~.tracing.SpanStore`, a
        serving :class:`~.profile.trace.TraceRing`, or an engine/
        replica-set exposing ``trace_ring``.  Each source renders as
        its own process row in Perfetto, all on the one
        :func:`~.context.trace_now` clock domain."""
        with self._lock:
            self._trace_sources[str(name)] = source
        return self

    def remove_trace_source(self, name: str) -> bool:
        with self._lock:
            return self._trace_sources.pop(str(name), None) is not None

    # -- goodput roll-up ---------------------------------------------------- #
    def add_goodput(self, name: str, ledger) -> "MetricsAggregator":
        """Register a job's :class:`~.goodput.GoodputLedger` (anything
        with ``snapshot() -> dict``) for the fleet roll-up: the
        ``/goodput`` document and pool-level ``goodput/*`` gauges."""
        with self._lock:
            self._goodput_sources[str(name)] = ledger
        return self

    def remove_goodput(self, name: str) -> bool:
        with self._lock:
            return self._goodput_sources.pop(str(name), None) is not None

    def set_pool_ledger(self, ledger) -> "MetricsAggregator":
        """Attach the DevicePool's :class:`~.goodput.OwnershipLedger`
        so unclaimed device-seconds are attributed as POOL idle in the
        roll-up, never as any job's badput."""
        with self._lock:
            self._pool_ledger = ledger
        return self

    def goodput_doc(self) -> Dict[str, Any]:
        """The fleet goodput attribution — per-job ledger snapshots
        rolled into summed buckets + pool idle + one goodput fraction
        (:func:`~.goodput.rollup`).  Served at ``/goodput``; also
        mirrors pool-level gauges onto the aggregator's recorder."""
        from .goodput import rollup
        with self._lock:
            sources = list(self._goodput_sources.items())
            pool = self._pool_ledger
        jobs = {}
        for name, led in sources:
            try:
                jobs[name] = led.snapshot()
            except Exception:
                continue    # one broken ledger must not kill the doc
        doc = rollup(jobs, pool.snapshot() if pool is not None else None)
        rec = self.recorder
        rec.gauge("goodput/pool_fraction", doc["goodput_fraction"])
        rec.gauge("goodput/pool_owned_s", doc["owned_s"])
        rec.gauge("goodput/pool_idle_s", doc["pool_idle_s"])
        for b, v in doc["buckets"].items():
            rec.gauge(f"goodput/pool_{b}_s", v)
        return doc

    def trace_doc(self) -> str:
        """One Chrome-trace/Perfetto JSON merging every registered
        trace source — what ``/trace`` serves and ``trace_summary
        critical-path`` consumes."""
        from .tracing import merge_perfetto
        with self._lock:
            items = list(self._trace_sources.items())
        resolved = []
        for name, src in items:
            rings = getattr(src, "trace_ring", None)
            resolved.append((name, rings if rings is not None else src))
        return merge_perfetto(resolved)

    def remove_member(self, name: str, purge_series: bool = True) -> bool:
        """Deliberate deregistration — the scale-DOWN path, as opposed
        to a crash.  The source leaves the merged exposition AND (by
        default) its retained samples leave the series store, so
        ``stale="1"`` keeps meaning "crashed, dashboards should see
        the gap" while a scaled-away member simply stops existing:
        ``/healthz`` must not 503 forever over a replica the
        autoscaler retired on purpose.  Members that die WITHOUT
        deregistering keep the crash-retention behavior (samples
        retained, flagged stale).  Idempotent: unknown names return
        False.  Counted as ``agg/deregistered``."""
        name = str(name)
        with self._lock:
            src = self._sources.pop(name, None)
            self._goodput_sources.pop(name, None)
        if src is None:
            return False
        rec = self.recorder
        rec.inc("agg/deregistered")
        # drop the per-source gauges so the merged /metrics carries no
        # ghost staleness verdict for a member that no longer exists
        rec.drop_gauges(f"agg/stale.{name}")
        rec.drop_gauges(f"agg/scrape_age_s.{name}")
        if purge_series:
            self.store.drop(f"{name}/*")
        return True

    def source_names(self) -> List[str]:
        with self._lock:
            return list(self._sources)

    def stale_sources(self) -> List[str]:
        with self._lock:
            return [n for n, s in self._sources.items() if s["stale"]]

    # -- scraping ----------------------------------------------------------- #
    def scrape(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One scrape round over every source.  A source that raises
        mid-scrape keeps its previous samples (flagged stale once its
        last-success age exceeds ``stale_after``) — the fleet surface
        never shrinks because one member died."""
        now = float(now) if now is not None else float(self.clock())
        with self._lock:
            sources = list(self._sources.items())
        rec = self.recorder
        ok = errs = 0
        for name, src in sources:
            rec.inc("agg/scrapes")
            try:
                parsed = parse_prometheus(src["fetch"]())
                health = src["healthz"]() if src["healthz"] else None
            except Exception as e:
                src["errors"] += 1
                src["last_err"] = repr(e)
                rec.inc("agg/scrape_errors")
                errs += 1
            else:
                src["samples"] = parsed["samples"]
                src["types"] = parsed["types"]
                src["health"] = health
                src["last_ok"] = now
                src["last_err"] = None
                src["scrapes"] += 1
                ok += 1
                self._feed_series(name, parsed["samples"], now)
            age = (now - src["last_ok"]) if src["last_ok"] is not None \
                else None
            src["stale"] = age is None or age > self.stale_after
            rec.gauge(f"agg/stale.{name}", 1.0 if src["stale"] else 0.0)
            if age is not None:
                rec.gauge(f"agg/scrape_age_s.{name}", age)
        stale = [n for n, s in sources if s["stale"]]
        rec.gauge("agg/sources", len(sources))
        rec.gauge("agg/stale_sources", len(stale))
        with self._lock:
            any_goodput = bool(self._goodput_sources
                               or self._pool_ledger is not None)
        if any_goodput:
            try:
                self.goodput_doc()    # refresh pool goodput/* gauges
            except Exception:
                pass    # attribution must never kill a scrape
        return {"time": now, "sources": len(sources), "ok": ok,
                "errors": errs, "stale": stale}

    def _feed_series(self, source: str, samples: List[Sample],
                     now: float):
        keep = self.series_filter
        for mname, labels, value in samples:
            key = series_key(source, mname, labels)
            if keep is None or keep(key):
                self.store.observe(key, value, now)

    # -- re-exposure -------------------------------------------------------- #
    def render(self) -> str:
        """The merged exposition: the aggregator's own ``agg/*``
        telemetry first, then every source's retained samples tagged
        ``source="<name>"`` (plus ``stale="1"`` on sources past the
        staleness budget)."""
        groups: Dict[str, Dict[str, Any]] = {}
        _collect_prometheus(self.recorder, self.namespace, None, groups)
        with self._lock:
            sources = list(self._sources.items())
        for name, src in sources:
            extra = {"source": name}
            if src["stale"]:
                extra["stale"] = "1"
            types = src["types"]
            for mname, labels, value in src["samples"]:
                base = _base_metric(mname, types)
                lines = _prom_group(groups, base,
                                    f"aggregated {base}",
                                    types.get(base, "untyped"))
                lines.append(f"{mname}{_prom_labels({**labels, **extra})}"
                             f" {_prom_value(value)}")
        return _emit_prometheus(groups)

    def healthz(self) -> Dict[str, Any]:
        """Worst-of verdict across sources (PR-11 semantics): ``ok`` is
        False iff any source's own /healthz said so OR the source went
        stale.  Per-source verdicts ride along for diagnosis."""
        with self._lock:
            sources = list(self._sources.items())
        out: Dict[str, Any] = {"ok": True, "stalled": False,
                               "diverged": False, "sources": {},
                               "stale_sources": []}
        for name, src in sources:
            v = dict(src["health"]) if src["health"] else {}
            v.setdefault("ok", src["last_err"] is None)
            v["stale"] = src["stale"]
            if src["last_err"] is not None:
                v["last_error"] = src["last_err"]
            if src["stale"]:
                v["ok"] = False
                out["stale_sources"].append(name)
            out["sources"][name] = v
            out["ok"] = out["ok"] and bool(v["ok"])
            out["stalled"] = out["stalled"] or bool(v.get("stalled"))
            out["diverged"] = out["diverged"] or bool(v.get("diverged"))
        return out

    # -- lifecycle ----------------------------------------------------------- #
    def serve(self, port: int = 0, host: str = "127.0.0.1"
              ) -> IntrospectionServer:
        """Start the fleet-level HTTP surface: ``/metrics`` renders the
        merged exposition, ``/healthz`` the worst-of verdict,
        ``/series`` the scrape-fed store, and ``/trace`` the merged
        multi-subsystem Perfetto document (``?trace_id=`` filters to
        one request/decision trace)."""
        if self._server is None:
            self._server = IntrospectionServer(
                self.recorder, port=port, host=host,
                namespace=self.namespace, metrics_source=self.render,
                healthz_source=self.healthz,
                series_source=self.store,
                goodput_source=self.goodput_doc,
                trace_source=self.trace_doc).start()
        return self._server

    def start(self, interval: float = 5.0) -> "MetricsAggregator":
        """Background scrape loop every ``interval`` seconds (wall
        time; tests drive ``scrape(now=...)`` directly instead)."""
        if self._thread is not None:
            return self

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.scrape()
                except Exception:
                    pass        # the scraper must outlive any source

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="metrics-aggregator")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def close(self):
        self.stop()
        srv, self._server = self._server, None
        if srv is not None:
            srv.stop()
