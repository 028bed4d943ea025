"""Causal trace spine (≙ ``bigdl_tpu/observability/tracing.py``): spans,
causal links, merged export, attribution.

The Recorder aggregates; the serving TraceRing keeps per-request
timelines for ONE engine.  This module is the cross-subsystem half, which
answers "why was this request slow" when the answer crosses a boundary (a
failover hop, a canary publication, a weight-stream snapshot):

  :class:`Span`        one named interval on the
                       :func:`~.context.trace_now` clock, carrying a
                       :class:`~.context.TraceContext` (its trace and its
                       parent) plus optional causal ``links`` to spans in
                       OTHER traces.
  :class:`SpanStore`   thread-safe bounded ring of finished spans,
                       queryable by trace id.
  :class:`Tracer`      the recording surface: ``span()`` context manager,
                       ``begin()``/``OpenSpan.end()`` for intervals whose
                       two ends live on different threads (the handle
                       travels through the same queue that orders the
                       work), and ``event()`` for points.
  :func:`merge_perfetto`
                       merge Tracers/SpanStores and serving TraceRings
                       into ONE Chrome-trace/Perfetto document on one
                       clock, one process row per source.
  :func:`critical_path`
                       per-trace latency attribution: every instant of the
                       trace's window is charged to the innermost span
                       covering it (gaps to ``(untraced)``); the named
                       coverage fraction is a testable number.

A process-global default tracer (:func:`get_tracer` / :func:`set_tracer`)
lets deep call sites record spans without threading a tracer through
every signature; components that take an explicit ``tracer=`` win over it.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from . import context as _ctx
from .context import TraceContext


class Span:
    """One finished interval.  ``links`` is a tuple of
    ``(trace_id, span_id, kind)`` causal edges to spans in other
    traces (same-trace parentage rides on the context itself)."""

    __slots__ = ("name", "subsystem", "context", "t0", "t1", "args",
                 "links")

    def __init__(self, name: str, ctx: TraceContext, t0: float,
                 t1: float, subsystem: str = "",
                 args: Optional[Dict[str, Any]] = None,
                 links: Sequence[Tuple[str, str, str]] = ()):
        self.name = str(name)
        self.subsystem = str(subsystem)
        self.context = ctx
        self.t0 = float(t0)
        self.t1 = max(float(t1), self.t0)
        self.args = dict(args) if args else None
        self.links = tuple(links)

    @property
    def trace_id(self) -> str:
        return self.context.trace_id

    def duration(self) -> float:
        return self.t1 - self.t0

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "subsystem": self.subsystem,
                "t0": self.t0, "t1": self.t1,
                "links": [list(l) for l in self.links],
                "args": self.args, **self.context.as_dict()}

    def __repr__(self):
        return (f"Span({self.name!r}, {self.duration() * 1e3:.3f}ms, "
                f"trace={self.trace_id[:8]}…)")


class SpanStore:
    """Bounded, thread-safe ring of finished spans."""

    def __init__(self, capacity: int = 2048):
        self._ring: deque = deque(maxlen=max(int(capacity), 1))
        self._lock = threading.Lock()
        self.dropped = 0        # finished spans evicted by the bound

    def add(self, span: Span):
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(span)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def by_trace(self, trace_id: str) -> List[Span]:
        with self._lock:
            return [s for s in self._ring if s.trace_id == trace_id]

    def trace_ids(self) -> List[str]:
        seen, out = set(), []
        for s in self.spans():
            if s.trace_id not in seen:
                seen.add(s.trace_id)
                out.append(s.trace_id)
        return out

    def __len__(self):
        with self._lock:
            return len(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()


class OpenSpan:
    """A span begun on one thread and ended on another.  NOT internally
    locked: the contract is the trace ring's handoff discipline — the handle
    travels through the same queue/condition that orders the work, so
    exactly one thread touches it at a time."""

    __slots__ = ("tracer", "name", "context", "subsystem", "t0",
                 "_links", "_done")

    def __init__(self, tracer: "Tracer", name: str, ctx: TraceContext,
                 subsystem: str, t0: float):
        self.tracer = tracer
        self.name = name
        self.context = ctx
        self.subsystem = subsystem
        self.t0 = t0
        self._links: List[Tuple[str, str, str]] = []
        self._done = False

    def link(self, other: Optional[TraceContext], kind: str = "causes"):
        if other is not None:
            self._links.append((other.trace_id, other.span_id, kind))

    def end(self, t1: Optional[float] = None, **args) -> Span:
        """Finish and record the span; idempotent (a double end on a
        failure path records once)."""
        if self._done:
            return None
        self._done = True
        span = Span(self.name, self.context,
                    self.t0, _ctx.trace_now() if t1 is None else t1,
                    subsystem=self.subsystem, args=args or None,
                    links=self._links)
        self.tracer.store.add(span)
        return span


class _SpanCtx:
    """``with tracer.span(...)`` sugar over :class:`OpenSpan`."""

    __slots__ = ("open",)

    def __init__(self, open_span: OpenSpan):
        self.open = open_span

    @property
    def context(self) -> TraceContext:
        return self.open.context

    def link(self, other: Optional[TraceContext], kind: str = "causes"):
        self.open.link(other, kind)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.open.end(error=repr(exc)) if exc is not None \
            else self.open.end()
        return False


class Tracer:
    """Recording surface over one :class:`SpanStore`."""

    def __init__(self, capacity: int = 2048, subsystem: str = ""):
        self.store = SpanStore(capacity)
        self.subsystem = str(subsystem)

    # -- recording ------------------------------------------------------ #
    def begin(self, name: str, ctx: Optional[TraceContext] = None, *,
              subsystem: Optional[str] = None,
              child: bool = True) -> OpenSpan:
        """Open a span now.  ``ctx=None`` mints a new root trace;
        ``child=True`` (default) derives a child context so the span
        has its own span_id parented on ``ctx``; ``child=False``
        records under ``ctx`` itself (the caller already minted it)."""
        if ctx is None:
            ctx = TraceContext.new_root()
        elif child:
            ctx = ctx.child()
        return OpenSpan(self, name, ctx,
                        self.subsystem if subsystem is None
                        else subsystem, _ctx.trace_now())

    def span(self, name: str, ctx: Optional[TraceContext] = None, *,
             subsystem: Optional[str] = None,
             child: bool = True) -> _SpanCtx:
        return _SpanCtx(self.begin(name, ctx, subsystem=subsystem,
                                   child=child))

    def event(self, name: str, ctx: Optional[TraceContext] = None, *,
              subsystem: Optional[str] = None,
              links: Sequence[Tuple[str, str, str]] = (),
              t: Optional[float] = None, **args) -> Span:
        """A zero-length span (a state transition, a decision)."""
        if ctx is None:
            ctx = TraceContext.new_root()
        else:
            ctx = ctx.child()
        t = _ctx.trace_now() if t is None else t
        span = Span(name, ctx, t, t,
                    subsystem=self.subsystem if subsystem is None
                    else subsystem, args=args or None, links=links)
        self.store.add(span)
        return span

    def record(self, span: Span):
        self.store.add(span)


# -- process-global default tracer (mirrors recorder.get_recorder) ------ #
_default_tracer = Tracer()
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    return _default_tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process default; returns the previous
    one so tests can restore it."""
    global _default_tracer
    with _tracer_lock:
        prev, _default_tracer = _default_tracer, tracer
    return prev


# -- cross-subsystem actuation stitching -------------------------------- #
# The autoscaler moves devices in the POOL's name space; the elastic
# supervisor observes only "my capacity_fn shrank".  This tiny registry
# carries the causal context across that gap: the pool notes the
# context that moved an owner's devices, the supervisor's next replan
# takes it and links its span back to the decision that caused it.
_actuations: Dict[str, TraceContext] = {}
_actuation_lock = threading.Lock()


def note_actuation(owner: str, ctx: Optional[TraceContext]):
    if ctx is None:
        return
    with _actuation_lock:
        _actuations[str(owner)] = ctx


def take_actuation(owner: str) -> Optional[TraceContext]:
    with _actuation_lock:
        return _actuations.pop(str(owner), None)


# -- merged Perfetto export --------------------------------------------- #
def _source_spans(src) -> Tuple[List[Span], List[Any]]:
    """Normalize one source into (tracing spans, serving RequestTraces)."""
    if isinstance(src, Tracer):
        return src.store.spans(), []
    if isinstance(src, SpanStore):
        return src.spans(), []
    if hasattr(src, "traces"):              # TraceRing
        return [], list(src.traces())
    if isinstance(src, (list, tuple)):
        spans = [s for s in src if isinstance(s, Span)]
        reqs = [t for t in src if hasattr(t, "spans")
                and not isinstance(t, Span)]
        return spans, reqs
    raise TypeError(f"cannot merge trace source {type(src).__name__}")


def merge_perfetto(sources: Iterable[Tuple[str, Any]],
                   extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Merge ``[(label, source), ...]`` into one Chrome-trace JSON.

    Every source gets its own process row (``pid`` + process_name
    metadata = the label — per-host/per-subsystem rows in the Perfetto
    UI); within a source, one ``tid`` track per trace id.  All
    timestamps are :func:`~.context.trace_now` seconds rebased to the
    earliest event across ALL sources — one clock domain, no skew."""
    resolved = []
    t_origin = None
    for label, src in sources:
        spans, reqs = _source_spans(src)
        resolved.append((str(label), spans, reqs))
        for s in spans:
            t_origin = s.t0 if t_origin is None else min(t_origin, s.t0)
        for tr in reqs:
            for _, t0, _, _ in tr.spans:
                t_origin = t0 if t_origin is None else min(t_origin, t0)
    t_origin = t_origin or 0.0

    def us(t):
        return round((t - t_origin) * 1e6, 3)

    events: List[Dict[str, Any]] = []
    for pid, (label, spans, reqs) in enumerate(resolved, start=1):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": label}})
        tids: Dict[str, int] = {}

        def tid_for(trace_id, title):
            if trace_id not in tids:
                tids[trace_id] = len(tids) + 1
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tids[trace_id],
                               "args": {"name": title}})
            return tids[trace_id]

        for s in sorted(spans, key=lambda s: s.t0):
            tid = tid_for(s.trace_id, f"trace {s.trace_id[:12]}")
            args = {"trace_id": s.trace_id,
                    "span_id": s.context.span_id}
            if s.context.parent_span_id:
                args["parent_span_id"] = s.context.parent_span_id
            if s.subsystem:
                args["subsystem"] = s.subsystem
            if s.links:
                args["links"] = [{"trace_id": t, "span_id": sp,
                                  "kind": k} for t, sp, k in s.links]
            if s.args:
                args.update(s.args)
            events.append({"ph": "B", "name": s.name,
                           "cat": s.subsystem or "trace", "pid": pid,
                           "tid": tid, "ts": us(s.t0), "args": args})
            events.append({"ph": "E", "name": s.name,
                           "cat": s.subsystem or "trace", "pid": pid,
                           "tid": tid, "ts": us(s.t1)})
        for tr in reqs:
            tid = tid_for(tr.trace_id,
                          f"req {tr.trace_id[:12]} ({tr.model})")
            for name, t0, t1, args in sorted(tr.spans,
                                             key=lambda s: s[1]):
                span_args = {"trace_id": tr.trace_id,
                             "model": tr.model}
                span_args.update(tr.meta)
                if args:
                    span_args.update(args)
                events.append({"ph": "B", "name": name,
                               "cat": "serving", "pid": pid,
                               "tid": tid, "ts": us(t0),
                               "args": span_args})
                events.append({"ph": "E", "name": name,
                               "cat": "serving", "pid": pid,
                               "tid": tid, "ts": us(t1)})
    doc: Dict[str, Any] = {"traceEvents": events,
                           "displayTimeUnit": "ms"}
    if extra_meta:
        doc["otherData"] = dict(extra_meta)
    return json.dumps(doc)


# -- critical-path attribution ------------------------------------------ #
def critical_path(intervals: Sequence[Tuple[str, float, float]]
                  ) -> Dict[str, Any]:
    """Attribute one trace's end-to-end window to its spans.

    ``intervals`` is ``[(name, t0, t1), ...]`` for ONE trace.  Every
    elementary interval between consecutive span boundaries is charged
    to the innermost covering span — the one that started latest
    (ties: the one ending soonest), which for properly nested spans is
    the deepest frame, i.e. what was *actually happening*.  Instants
    no span covers charge to ``(untraced)``.

    Returns ``{"total": seconds, "attribution": {name: seconds},
    "coverage": named_fraction}`` where coverage is the share of the
    window attributed to named spans (the ≥95% acceptance number)."""
    spans = [(str(n), float(t0), float(t1))
             for n, t0, t1 in intervals if t1 >= t0]
    if not spans:
        return {"total": 0.0, "attribution": {}, "coverage": 1.0}
    lo = min(t0 for _, t0, _ in spans)
    hi = max(t1 for _, _, t1 in spans)
    bounds = sorted({t for _, t0, t1 in spans for t in (t0, t1)})
    attribution: Dict[str, float] = {}
    for a, b in zip(bounds, bounds[1:]):
        if b <= a:
            continue
        covering = [(t0, t1, n) for n, t0, t1 in spans
                    if t0 <= a and t1 >= b]
        if covering:
            # innermost: latest start, then earliest end
            _, _, name = max(covering, key=lambda c: (c[0], -c[1]))
        else:
            name = "(untraced)"
        attribution[name] = attribution.get(name, 0.0) + (b - a)
    total = hi - lo
    named = sum(v for k, v in attribution.items() if k != "(untraced)")
    return {"total": total, "attribution": attribution,
            "coverage": (named / total) if total > 0 else 1.0}


def spans_from_chrome(doc) -> Dict[str, List[Tuple[str, float, float]]]:
    """Reconstruct per-trace ``(name, t0, t1)`` interval lists from a
    Chrome-trace document (dict or JSON string) produced by
    :func:`merge_perfetto` / the serving exporter.  ``B``/``E`` events
    are paired per ``(pid, tid)`` LIFO; timestamps come back in
    SECONDS (the µs rebase divided out) so the result feeds
    :func:`critical_path` directly."""
    if isinstance(doc, (str, bytes)):
        doc = json.loads(doc)
    events = doc.get("traceEvents", doc if isinstance(doc, list) else [])
    open_stack: Dict[Tuple[int, int], List[Tuple[str, float, dict]]] = {}
    by_trace: Dict[str, List[Tuple[str, float, float]]] = {}
    for ev in events:
        ph = ev.get("ph")
        key = (ev.get("pid", 0), ev.get("tid", 0))
        if ph == "B":
            open_stack.setdefault(key, []).append(
                (ev.get("name", "?"), float(ev.get("ts", 0.0)),
                 ev.get("args") or {}))
        elif ph == "E":
            stack = open_stack.get(key)
            if not stack:
                continue
            name, t0, args = stack.pop()
            trace_id = args.get("trace_id")
            if trace_id is None:
                continue
            t1 = float(ev.get("ts", t0))
            by_trace.setdefault(str(trace_id), []).append(
                (name, t0 / 1e6, t1 / 1e6))
    return by_trace
