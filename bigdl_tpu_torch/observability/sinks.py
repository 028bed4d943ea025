"""Sinks for Recorder step records (≙ ``bigdl_tpu/observability/sinks.py``):
anything with ``emit(record: dict)`` (and optionally ``flush`` /
``close``).

  :class:`JsonlSink`        one JSON object per line (the reference's
                            ``scripts/trace_summary.py steps`` reads it)
  :class:`InMemorySink`     keeps records in a list (tests, notebooks)
  :class:`TensorBoardSink`  span durations and step scalars as tfevents
                            scalars through the port's own
                            :class:`~bigdl_tpu_torch.visualization
                            .event_writer.EventWriter`

And the Prometheus text exposition of a recorder's snapshot
(:func:`render_prometheus`, :func:`render_prometheus_multi`), which the
``/metrics`` endpoint (``observability.http``) renders per scrape.
"""
from __future__ import annotations

import json
import math
import os
import re
import threading
from typing import Any, Dict, List, Optional


class Sink:
    """Interface marker; subclasses implement emit/close."""

    def emit(self, record: Dict[str, Any]):
        raise NotImplementedError

    def close(self):
        pass


class InMemorySink(Sink):
    """Append records to ``self.records`` (thread-safe)."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def emit(self, record):
        with self._lock:
            self.records.append(record)

    def steps(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r for r in self.records if r.get("type") == "step"]


class JsonlSink(Sink):
    """One JSON object per line, flushed every ``flush_every`` records
    (and on close) so that a crashed run keeps its telemetry tail."""

    def __init__(self, path: str, flush_every: int = 20):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a")
        self._lock = threading.Lock()
        self._since_flush = 0
        self.flush_every = max(int(flush_every), 1)

    def emit(self, record):
        line = json.dumps(record, default=_json_default)
        with self._lock:
            self._f.write(line + "\n")
            self._since_flush += 1
            if self._since_flush >= self.flush_every:
                self._f.flush()
                self._since_flush = 0

    def flush(self):
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._since_flush = 0

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


class TensorBoardSink(Sink):
    """Write span durations (milliseconds, under ``telemetry/span_ms/``)
    and step scalars (under ``telemetry/``) as tfevents scalars.

    Accepts a log dir (an :class:`EventWriter` is created) or any object
    with ``add_scalar(tag, value, step)`` — e.g. an existing
    :class:`~bigdl_tpu_torch.visualization.TrainSummary`.
    """

    def __init__(self, writer_or_dir, prefix: str = "telemetry"):
        if isinstance(writer_or_dir, str):
            from ..visualization.event_writer import EventWriter
            writer_or_dir = EventWriter(writer_or_dir)
            self._owned = True
        else:
            self._owned = False
        self.writer = writer_or_dir
        self.prefix = prefix.rstrip("/")

    def emit(self, record):
        step = record.get("step")
        if record.get("type") != "step" or step is None:
            return
        add = self.writer.add_scalar
        for name, secs in record.get("spans", {}).items():
            add(f"{self.prefix}/span_ms/{name}", secs * 1e3, step)
        for name, v in record.get("scalars", {}).items():
            if isinstance(v, (int, float)):
                add(f"{self.prefix}/{name}", float(v), step)

    def flush(self):
        fl = getattr(self.writer, "flush", None)
        if fl is not None:
            fl()

    def close(self):
        if self._owned:
            self.writer.close()


def _json_default(v):
    """Last-resort leaf encoder: tensors and numpy scalars float()
    cleanly; anything else degrades to repr instead of killing the run."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


# -- Prometheus exposition rendering -------------------------------------- #
# Not a Sink: Prometheus *pulls*, so the /metrics endpoint
# (observability.http) renders the Recorder's current snapshot per
# scrape instead of pushing records anywhere.

_PROM_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def prometheus_name(name: str, namespace: str = "bigdl") -> str:
    """Sanitize a recorder metric name into a legal Prometheus metric
    name ``[a-zA-Z_:][a-zA-Z0-9_:]*`` under ``namespace``."""
    out = _PROM_NAME_BAD.sub("_", str(name))
    if out and out[0].isdigit():
        out = "_" + out
    return f"{namespace}_{out}" if namespace else out


def prometheus_escape_help(text: str) -> str:
    r"""Escape a HELP line: ``\`` -> ``\\`` and newline -> ``\n``."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def prometheus_escape_label(value: str) -> str:
    r"""Escape a label value: ``\``, ``"`` and newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_value(v) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def _prom_labels(labels: Optional[Dict[str, Any]]) -> str:
    """``{k="v",...}`` sample-label block; empty string for no labels."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{prometheus_escape_label(v)}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def _prom_group(groups: Dict[str, Dict[str, Any]], metric: str,
                help_text: str, type_text: str) -> List[str]:
    """The sample-line list for ``metric``, creating its HELP/TYPE group
    on first sight — exposition format wants ONE header per metric even
    when several labeled sources (fleet jobs) contribute samples."""
    g = groups.get(metric)
    if g is None:
        g = groups[metric] = {"help": help_text, "type": type_text,
                              "lines": []}
    return g["lines"]


def _collect_prometheus(recorder, namespace: str,
                        labels: Optional[Dict[str, Any]],
                        groups: Dict[str, Dict[str, Any]]) -> None:
    """Fold one recorder's snapshot into ``groups`` (ordered metric →
    header + sample lines), tagging every sample with ``labels``."""
    snap = recorder.snapshot()
    lab = dict(labels or {})

    for name in sorted(snap["counters"]):
        metric = prometheus_name(name, namespace)
        if not metric.endswith("_total"):
            metric += "_total"
        _prom_group(groups, metric,
                    prometheus_escape_help("counter " + name),
                    "counter").append(
            f"{metric}{_prom_labels(lab)} "
            f"{_prom_value(snap['counters'][name])}")

    queue_depths = {}
    for name in sorted(snap["gauges"]):
        if name.startswith("serving.queue_depth."):
            queue_depths[name[len("serving.queue_depth."):]] = \
                snap["gauges"][name]
            continue
        metric = prometheus_name(name, namespace)
        _prom_group(groups, metric,
                    prometheus_escape_help("gauge " + name),
                    "gauge").append(
            f"{metric}{_prom_labels(lab)} "
            f"{_prom_value(snap['gauges'][name])}")
    if queue_depths:
        metric = prometheus_name("serving.queue_depth", namespace)
        lines = _prom_group(groups, metric, "rows queued per model",
                            "gauge")
        for model in sorted(queue_depths):
            lines.append(
                f"{metric}{_prom_labels({**lab, 'model': model})} "
                f"{_prom_value(queue_depths[model])}")

    hist_buckets = getattr(recorder, "hist_buckets", None)
    for name in sorted(recorder.hist_names()):
        summ = recorder.hist_summary(name)
        if not summ:
            continue
        metric = prometheus_name(name, namespace)
        buckets = hist_buckets(name) if hist_buckets is not None else None
        if buckets is not None and buckets[0] is not None:
            # opted-in bucket spec: native TYPE histogram with
            # cumulative le-labeled buckets counted at observe() time,
            # so +Inf == _count exactly and external Prometheus can
            # compute its own quantiles
            bounds, bins = buckets
            lines = _prom_group(groups, metric,
                                prometheus_escape_help("histogram "
                                                       + name),
                                "histogram")
            cum = 0
            for le, n in zip(bounds, bins):
                cum += n
                lines.append(
                    f"{metric}_bucket"
                    f"{_prom_labels({**lab, 'le': _prom_value(le)})} "
                    f"{cum}")
            lines.append(
                f"{metric}_bucket{_prom_labels({**lab, 'le': '+Inf'})} "
                f"{cum + bins[-1]}")
        else:
            lines = _prom_group(groups, metric,
                                prometheus_escape_help("histogram "
                                                       + name),
                                "summary")
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                if key in summ:
                    lines.append(
                        f"{metric}{_prom_labels({**lab, 'quantile': q})} "
                        f"{_prom_value(summ[key])}")
        lines.append(f"{metric}_sum{_prom_labels(lab)} "
                     f"{_prom_value(summ['mean'] * summ['count'])}")
        lines.append(f"{metric}_count{_prom_labels(lab)} "
                     f"{int(summ['count'])}")


def _emit_prometheus(groups: Dict[str, Dict[str, Any]]) -> str:
    lines: List[str] = []
    for metric, g in groups.items():
        lines.append(f"# HELP {metric} {g['help']}")
        lines.append(f"# TYPE {metric} {g['type']}")
        lines.extend(g["lines"])
    return "\n".join(lines) + "\n" if lines else ""


def render_prometheus(recorder, namespace: str = "bigdl",
                      labels: Optional[Dict[str, Any]] = None) -> str:
    """Render ``recorder``'s counters, gauges and pending histograms as
    Prometheus text exposition format (version 0.0.4).

    Counters keep their monotonic semantics (``_total`` suffix added
    when missing), gauges map 1:1, and each histogram renders as a
    ``summary``: ``{quantile="..."}`` samples over the bounded recent
    window plus exact ``_sum``/``_count``.  Per-model
    ``serving.queue_depth.<model>`` gauges fold into ONE metric with a
    ``model`` label so a fleet of models can't explode the metric
    namespace.  ``labels`` tags every sample (e.g. ``{"job": name}``)."""
    groups: Dict[str, Dict[str, Any]] = {}
    _collect_prometheus(recorder, namespace, labels, groups)
    return _emit_prometheus(groups)


def render_prometheus_multi(sources, namespace: str = "bigdl") -> str:
    """One exposition over several recorders — the fleet's aggregated
    ``/metrics``.  ``sources`` is an iterable of ``(labels, recorder)``
    pairs (``labels`` None for the unlabeled base source); a metric
    emitted by several sources renders under ONE ``HELP``/``TYPE``
    header with one labeled sample per source, so per-job ``fleet/*``
    and ``elastic/*`` counters stay distinct series instead of
    colliding."""
    groups: Dict[str, Dict[str, Any]] = {}
    for labels, recorder in sources:
        _collect_prometheus(recorder, namespace, labels, groups)
    return _emit_prometheus(groups)


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a JsonlSink file back into records (bad lines skipped)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


__all__ = ["InMemorySink", "JsonlSink", "Sink", "TensorBoardSink",
           "prometheus_escape_help", "prometheus_escape_label",
           "prometheus_name", "read_jsonl", "render_prometheus",
           "render_prometheus_multi"]
