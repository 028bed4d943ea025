"""Telemetry of the port (≙ ``bigdl_tpu/observability``): the Recorder
and its step records, the sinks (JSONL, in-memory, TensorBoard) and the
Prometheus rendering, the live introspection server (:mod:`.http`), the
training-health layer (:mod:`.health`), cost attribution and the
per-request trace ring (:mod:`.profile`), the causal trace spine
(:mod:`.tracing`), the goodput ledger (:mod:`.goodput`) and collective
accounting (:mod:`.collectives`)."""
from .context import TraceContext, trace_now
from .goodput import GoodputLedger, ledger_phase
from .health import (DivergenceError, FlightRecorder, HealthMonitor,
                     StallWatchdog, attribute_stragglers, read_flight)
from .http import IntrospectionServer
from .recorder import Recorder
from .sinks import (InMemorySink, JsonlSink, Sink, TensorBoardSink,
                    read_jsonl, render_prometheus, render_prometheus_multi)
from .tracing import Tracer, get_tracer, set_tracer

__all__ = ["DivergenceError", "FlightRecorder", "GoodputLedger",
           "HealthMonitor", "InMemorySink", "IntrospectionServer",
           "JsonlSink", "Recorder", "Sink", "StallWatchdog",
           "TensorBoardSink", "TraceContext", "Tracer",
           "attribute_stragglers", "get_tracer", "ledger_phase",
           "read_flight", "read_jsonl", "render_prometheus",
           "render_prometheus_multi", "set_tracer", "trace_now"]
