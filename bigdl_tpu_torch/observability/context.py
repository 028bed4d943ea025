"""One trace clock + one trace context
(≙ ``bigdl_tpu/observability/context.py``).

  :func:`trace_now`        the single trace clock, ``time.monotonic()``
                           seconds: the serving queue's native clock,
                           immune to wall-clock steps and shared across
                           the threads of one process.
  :class:`TraceContext`    W3C-traceparent-shaped identity —
                           ``trace_id`` (32 hex), ``span_id`` (16 hex),
                           ``parent_span_id``.  Instances are immutable
                           (``__setattr__`` raises), so passing one
                           through a queue is all cross-thread
                           propagation needs.
"""
from __future__ import annotations

import time
import uuid
from typing import Any, Dict, Optional

#: the single trace clock (documented above; do not fork per subsystem)
TRACE_CLOCK = time.monotonic


def trace_now() -> float:
    """Seconds on the repo's one trace clock (``time.monotonic``)."""
    return time.monotonic()


class TraceContext:
    """Immutable W3C-shaped trace identity.

    ``new_root()`` mints a fresh trace; ``child()`` mints a new span id
    under the same trace with this context as the parent.  The string
    form round-trips through the ``traceparent`` header grammar
    (``00-<trace_id>-<span_id>-01``) so a future RPC boundary can carry
    it without a new format.
    """

    __slots__ = ("trace_id", "span_id", "parent_span_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_span_id: Optional[str] = None):
        trace_id, span_id = str(trace_id), str(span_id)
        if len(trace_id) != 32 or len(span_id) != 16:
            raise ValueError("trace_id must be 32 hex chars and "
                             f"span_id 16, got {trace_id!r}/{span_id!r}")
        object.__setattr__(self, "trace_id", trace_id)
        object.__setattr__(self, "span_id", span_id)
        object.__setattr__(self, "parent_span_id",
                           None if parent_span_id is None
                           else str(parent_span_id))

    # immutability IS the thread-safety story (see module docstring)
    def __setattr__(self, name, value):
        raise AttributeError("TraceContext is immutable; derive a new "
                             "context with child()")

    def __delattr__(self, name):
        raise AttributeError("TraceContext is immutable")

    # -- construction --------------------------------------------------- #
    @classmethod
    def new_root(cls) -> "TraceContext":
        """A fresh trace: new trace_id, new span_id, no parent."""
        return cls(uuid.uuid4().hex, uuid.uuid4().hex[:16])

    def child(self) -> "TraceContext":
        """A new span under the same trace, parented on this one."""
        return TraceContext(self.trace_id, uuid.uuid4().hex[:16],
                            parent_span_id=self.span_id)

    # -- wire form ------------------------------------------------------ #
    def to_traceparent(self) -> str:
        """``00-<trace_id>-<span_id>-01`` (sampled flag always set:
        nothing in-process is ever head-sampled away)."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, header: str) -> "TraceContext":
        parts = str(header).strip().split("-")
        if len(parts) != 4 or parts[0] != "00":
            raise ValueError(f"not a traceparent header: {header!r}")
        return cls(parts[1], parts[2])

    # -- plumbing ------------------------------------------------------- #
    def as_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_span_id": self.parent_span_id}

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.parent_span_id == other.parent_span_id)

    def __hash__(self):
        return hash((self.trace_id, self.span_id, self.parent_span_id))

    def __repr__(self):
        return (f"TraceContext({self.trace_id[:8]}…/"
                f"{self.span_id[:8]}…"
                + (f" <- {self.parent_span_id[:8]}…"
                   if self.parent_span_id else "") + ")")
