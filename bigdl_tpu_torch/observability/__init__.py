"""Telemetry of the port (≙ ``bigdl_tpu/observability``): the Recorder
and the per-request trace ring the serving engine writes to."""
from .context import TraceContext, trace_now
from .recorder import Recorder

__all__ = ["Recorder", "TraceContext", "trace_now"]
