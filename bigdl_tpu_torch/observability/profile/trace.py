"""Per-request tracing: span timelines + Chrome-trace/Perfetto export.

Port of ``bigdl_tpu/observability/profile/trace.py``.

The serving metrics answer fleet questions — p99, shed rate,
batch fill.  They cannot answer "where did *this* request's latency
go?".  Here every admitted request carries a :class:`RequestTrace`: a
trace ID plus timestamped spans for each pipeline stage

    admit -> queue -> batch_gather -> compute -> reply

(shed requests end in a terminal ``shed`` span carrying the cause
instead), collected into a bounded :class:`TraceRing` and exported as
Chrome trace event format — the JSON that chrome://tracing and
https://ui.perfetto.dev open directly.  ``B``/``E`` begin/end pairs are
emitted (not ``X`` complete events) so nested and zero-length spans
render faithfully; each request gets its own ``tid`` track named after
its trace ID.

Timestamps are :func:`bigdl_tpu_torch.observability.context.trace_now`
seconds — ``time.monotonic()``, the one trace clock (the serving
queue's native clock); the exporter rebases them to microseconds from
the earliest event, which is all the trace viewers need.

A request admitted with an upstream :class:`~..context.TraceContext`
(e.g. minted by the ReplicaSet front door) ADOPTS that trace id —
``ring.new_trace(model, ctx=ctx)`` — so the same id names the request
across the failover hop and into the decode slot lifetime.
"""
from __future__ import annotations

import json
import threading
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

from ..context import TraceContext


class RequestTrace:
    """One request's span timeline.  Not thread-safe by itself: a trace
    is only ever touched by the submitting thread (admit/shed spans)
    and then the single batcher thread (queue/gather/compute/reply),
    with the queue handoff ordering the two."""

    __slots__ = ("trace_id", "model", "spans", "meta", "_open", "ctx")

    def __init__(self, trace_id: str, model: str,
                 ctx: Optional[TraceContext] = None):
        self.trace_id = trace_id
        self.model = model
        self.spans: List[tuple] = []     # (name, t0, t1, args|None)
        self.meta: Dict[str, Any] = {}
        self._open: Dict[str, float] = {}
        self.ctx = ctx                   # upstream TraceContext, if any

    def add_span(self, name: str, t0: float, t1: float, **args):
        self.spans.append((name, t0, max(t1, t0), args or None))

    def open(self, name: str, t: float):
        """Begin a span whose end lands on another thread/time."""
        self._open[name] = t

    def close(self, name: str, t: float, **args):
        t0 = self._open.pop(name, None)
        if t0 is not None:
            self.add_span(name, t0, t, **args)

    def discard(self, name: str):
        """Drop an open span that turned out not to happen (e.g. a
        ``queue`` span opened optimistically before a shed put)."""
        self._open.pop(name, None)

    def terminal(self, cause: str, t: float, name: str = "shed"):
        """Record the terminal cause span for a request that will never
        reply — ``shed`` (admission/deadline), ``error`` (batch
        execution failed), ``closed`` (engine shut down first).  Any
        still-open spans are closed at ``t`` so the track shows how far
        the request got."""
        for open_name in list(self._open):
            self.close(open_name, t)
        self.meta["cause"] = cause
        self.add_span(name, t, t, cause=cause)


class TraceRing:
    """Thread-safe bounded ring of *completed* request traces — the
    /trace endpoint's source.  Bounded exactly like the Recorder's
    record ring: tracing a heavy-traffic engine must cost O(capacity)
    memory, not O(requests served)."""

    def __init__(self, capacity: int = 512):
        self._ring: deque = deque(maxlen=max(int(capacity), 1))
        self._lock = threading.Lock()
        self.dropped = 0        # finished traces evicted by the bound

    def new_trace(self, model: str,
                  ctx: Optional[TraceContext] = None) -> RequestTrace:
        """Mint a trace; with ``ctx`` the request adopts the upstream
        trace id so one id spans admission → failover → decode."""
        if ctx is not None:
            return RequestTrace(ctx.trace_id, model, ctx=ctx)
        return RequestTrace(uuid.uuid4().hex[:16], model)

    def finish(self, trace: RequestTrace):
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(trace)

    def traces(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._ring)

    def __len__(self):
        with self._lock:
            return len(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()


def chrome_trace_events(traces, pid: int = 1) -> List[Dict[str, Any]]:
    """Chrome trace event list for ``traces``: one ``tid`` track per
    request (named via ``thread_name`` metadata), ``B``/``E`` pairs per
    span with the trace ID and batch/bucket attribution in ``args``."""
    events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": "bigdl_tpu_torch serving"}}]
    t_origin = min((t0 for tr in traces for _, t0, _, _ in tr.spans),
                   default=0.0)

    def us(t):
        return round((t - t_origin) * 1e6, 3)

    for tid, tr in enumerate(traces, start=1):
        events.append(
            {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
             "args": {"name": f"req {tr.trace_id} ({tr.model})"}})
        for name, t0, t1, args in sorted(tr.spans, key=lambda s: s[1]):
            span_args = {"trace_id": tr.trace_id, "model": tr.model}
            span_args.update(tr.meta)
            if args:
                span_args.update(args)
            events.append({"ph": "B", "name": name, "cat": "serving",
                           "pid": pid, "tid": tid, "ts": us(t0),
                           "args": span_args})
            events.append({"ph": "E", "name": name, "cat": "serving",
                           "pid": pid, "tid": tid, "ts": us(t1)})
    return events


def dump_chrome_trace(traces, extra_meta: Optional[Dict[str, Any]]
                      = None) -> str:
    """Serialize ``traces`` as a Chrome-trace JSON document (load in
    chrome://tracing or ui.perfetto.dev)."""
    doc: Dict[str, Any] = {"traceEvents": chrome_trace_events(traces),
                           "displayTimeUnit": "ms"}
    if extra_meta:
        doc["otherData"] = dict(extra_meta)
    return json.dumps(doc)
