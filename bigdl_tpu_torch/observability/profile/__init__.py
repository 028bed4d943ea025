"""Per-request tracing (≙ ``bigdl_tpu/observability/profile``)."""
from .trace import (RequestTrace, TraceRing, chrome_trace_events,
                    dump_chrome_trace)

__all__ = ["RequestTrace", "TraceRing", "chrome_trace_events",
           "dump_chrome_trace"]
