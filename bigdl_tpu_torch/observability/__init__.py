"""Telemetry of the port (≙ ``bigdl_tpu/observability``): the Recorder
and its step records, the sinks (JSONL, in-memory, TensorBoard) and the
Prometheus rendering, the live introspection server (:mod:`.http`), the
training-health layer (:mod:`.health`), cost attribution and the
per-request trace ring (:mod:`.profile`), the causal trace spine
(:mod:`.tracing`), the goodput ledger and its pool roll-up
(:mod:`.goodput`), collective accounting (:mod:`.collectives`), and the
fleet side: time series (:mod:`.timeseries`), SLOs (:mod:`.slo`), the
metrics aggregator (:mod:`.aggregate`) and the regression gate
(:mod:`.regress`)."""
from .context import TraceContext, trace_now
from .aggregate import MetricsAggregator, parse_prometheus, series_key
from .goodput import (STATE_BUCKETS, GoodputLedger, OwnershipLedger,
                      ledger_phase, rollup)
from .health import (DivergenceError, FlightRecorder, HealthMonitor,
                     StallWatchdog, attribute_stragglers, read_flight)
from .http import IntrospectionServer
from .recorder import Recorder
from .slo import SLOEngine, SLObjective, default_objectives
from .sinks import (InMemorySink, JsonlSink, Sink, TensorBoardSink,
                    read_jsonl, render_prometheus, render_prometheus_multi)
from .timeseries import MetricSeries, SeriesStore
from .tracing import Tracer, get_tracer, set_tracer

__all__ = ["DivergenceError", "FlightRecorder", "GoodputLedger",
           "HealthMonitor", "InMemorySink", "IntrospectionServer",
           "JsonlSink", "MetricSeries", "MetricsAggregator",
           "OwnershipLedger", "Recorder", "SLOEngine", "SLObjective",
           "STATE_BUCKETS", "SeriesStore", "Sink", "StallWatchdog",
           "TensorBoardSink", "TraceContext", "Tracer",
           "attribute_stragglers", "default_objectives", "get_tracer",
           "ledger_phase", "parse_prometheus", "read_flight", "read_jsonl",
           "render_prometheus", "render_prometheus_multi", "rollup",
           "series_key", "set_tracer", "trace_now"]
