"""Telemetry of the port (≙ ``bigdl_tpu/observability``): the Recorder
and its step records, the sinks, the training-health layer
(:mod:`.health`), the per-request trace ring the serving engines write
to, the causal trace spine (:mod:`.tracing`) and the goodput ledger
(:mod:`.goodput`)."""
from .context import TraceContext, trace_now
from .goodput import GoodputLedger, ledger_phase
from .health import (DivergenceError, FlightRecorder, HealthMonitor,
                     StallWatchdog, attribute_stragglers, read_flight)
from .recorder import Recorder
from .sinks import InMemorySink, JsonlSink, Sink, read_jsonl
from .tracing import Tracer, get_tracer, set_tracer

__all__ = ["DivergenceError", "FlightRecorder", "GoodputLedger",
           "HealthMonitor", "InMemorySink", "JsonlSink", "Recorder", "Sink",
           "StallWatchdog", "TraceContext", "Tracer", "attribute_stragglers",
           "get_tracer", "ledger_phase", "read_flight", "read_jsonl",
           "set_tracer", "trace_now"]
