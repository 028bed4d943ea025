"""Telemetry of the port (≙ ``bigdl_tpu/observability``): the Recorder,
the per-request trace ring the serving engines write to, the causal trace
spine (:mod:`.tracing`) and the goodput ledger (:mod:`.goodput`)."""
from .context import TraceContext, trace_now
from .goodput import GoodputLedger, ledger_phase
from .recorder import Recorder
from .tracing import Tracer, get_tracer, set_tracer

__all__ = ["GoodputLedger", "Recorder", "TraceContext", "Tracer",
           "get_tracer", "ledger_phase", "set_tracer", "trace_now"]
