"""Thread-safe telemetry recorder (≙ ``bigdl_tpu/observability/recorder.py``).

Counters (``inc``), gauges (``gauge``), histograms with p50/p95/p99 over
a bounded recent window (``observe``, ``hist_summary``,
``hist_quantiles``), timed spans (``span``, ``add_span``) and per-step
scalars (``scalar``).

``start_step`` / ``end_step`` bracket one training iteration: ``end_step``
folds everything recorded since ``start_step`` — spans, scalars,
histograms, and snapshots of the counters and gauges — into one *step
record* (a plain dict), folds the step into an attached goodput ledger
(:class:`~bigdl_tpu_torch.observability.goodput.GoodputLedger`, as the
reference's ``fold_step``), keeps it in a bounded ring
(``recent_records``: what the flight recorder dumps and the stall
watchdog reads) and hands it to every sink (``observability.sinks``).
Out-of-band records (``emit_record``) go to the ring and the sinks too.
``step_age`` is the liveness signal: seconds since the pending step
opened, or since the last one closed.

Not ported yet (ROADMAP queue A, operate plane): profiler traces
(``trace_every``), the cost model, time series, Prometheus buckets,
disabled recorders and the process-active recorder.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import context as _trace_clock


class _Span:
    __slots__ = ("_rec", "_name", "_t0")

    def __init__(self, rec: "Recorder", name: str):
        self._rec = rec
        self._name = name

    def __enter__(self):
        self._t0 = _trace_clock.trace_now()
        return self

    def __exit__(self, *exc):
        self._rec._add_span(self._name, _trace_clock.trace_now() - self._t0)
        return False


class Recorder:
    """Aggregates counters, gauges, histograms and spans."""

    #: quantiles are taken over the most recent this-many samples
    HIST_SAMPLE_CAP = 2048
    #: ``emit_record`` keeps the most recent this-many records
    KEEP_RECORDS = 256

    def __init__(self, sinks=(), keep_records: Optional[int] = None):
        self._lock = threading.Lock()
        self.sinks = list(sinks)
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._spans: Dict[str, float] = {}
        self._span_counts: Dict[str, int] = {}
        # count/min/max/sum/sumsq over ALL samples; quantiles over the
        # most recent HIST_SAMPLE_CAP
        self._hists: Dict[str, List[float]] = {}
        self._hist_samples: Dict[str, deque] = {}
        self._ring: deque = deque(maxlen=max(
            self.KEEP_RECORDS if keep_records is None else keep_records, 1))
        self._ledger = None
        # the pending step: its per-step scalars and clock; liveness
        self._scalars: Dict[str, object] = {}
        self._step: Optional[int] = None
        self._step_t0: Optional[float] = None
        self._step_started_wall: Optional[float] = None
        self._last_step_end: Optional[float] = None
        self._last_step_index: Optional[int] = None

    @property
    def enabled(self) -> bool:
        """Always True: the port has no disabled recorder."""
        return True

    def add_sink(self, sink):
        """Attach a sink (anything with ``emit(record)``)."""
        self.sinks.append(sink)
        return self

    def set_ledger(self, ledger):
        """Attach a :class:`~bigdl_tpu_torch.observability.goodput
        .GoodputLedger` (``None`` detaches)."""
        self._ledger = ledger
        return self

    def get_ledger(self):
        """The attached goodput ledger, or None."""
        return self._ledger

    # -- primitives ------------------------------------------------------ #
    def inc(self, name: str, value: float = 1.0) -> float:
        """Add to a monotonic counter; returns the new total."""
        with self._lock:
            total = self._counters.get(name, 0.0) + value
            self._counters[name] = total
            return total

    def gauge(self, name: str, value: float):
        """Set a last-value gauge."""
        with self._lock:
            self._gauges[name] = float(value)

    def reset_gauges(self, prefix: str):
        """Zero every gauge whose name starts with ``prefix``."""
        with self._lock:
            for name in self._gauges:
                if name.startswith(prefix):
                    self._gauges[name] = 0.0

    def counter_value(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._counters.get(name, default)

    def gauge_value(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def span_value(self, name: str, default: float = 0.0) -> float:
        """Accumulated seconds of ``name``."""
        with self._lock:
            return self._spans.get(name, default)

    def observe(self, name: str, value: float):
        """Add one observation to the histogram ``name``."""
        v = float(value)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                self._hists[name] = [1, v, v, v, v * v]
            else:
                h[0] += 1
                h[1] = min(h[1], v)
                h[2] = max(h[2], v)
                h[3] += v
                h[4] += v * v
            s = self._hist_samples.get(name)
            if s is None:
                s = self._hist_samples[name] = deque(
                    maxlen=self.HIST_SAMPLE_CAP)
            s.append(v)

    def hist_summary(self, name: str) -> Optional[Dict[str, float]]:
        """count/min/max/mean plus p50/p95/p99 of the histogram; ``None``
        (never an exception) for unknown or empty names."""
        with self._lock:
            h = self._hists.get(name)
            if h is None or not h[0]:
                return None
            samples = sorted(self._hist_samples.get(name) or ())
        out = {"count": int(h[0]), "min": h[1], "max": h[2],
               "mean": h[3] / max(h[0], 1), "sumsq": h[4]}
        if samples:
            out.update({f"p{q:g}": _quantile(samples, q)
                        for q in (50.0, 95.0, 99.0)})
        return out

    def hist_quantiles(self, name: str, qs=(50.0, 95.0, 99.0)
                       ) -> Optional[Dict[str, float]]:
        """``{"p50": ..., ...}`` over the histogram's recent samples;
        ``None`` (never an exception) for unknown or empty names."""
        with self._lock:
            samples = sorted(self._hist_samples.get(name) or ())
        if not samples:
            return None
        return {f"p{q:g}": _quantile(samples, q) for q in qs}

    def span(self, name: str):
        """Context manager timing a region."""
        return _Span(self, name)

    def _add_span(self, name: str, dt: float):
        with self._lock:
            self._spans[name] = self._spans.get(name, 0.0) + dt
            self._span_counts[name] = self._span_counts.get(name, 0) + 1

    def add_span(self, name: str, seconds: float):
        """Record an externally timed duration as a span."""
        self._add_span(name, seconds)

    def scalar(self, name: str, value):
        """Record a per-step scalar (loss, grad norm, lr, ...); a device
        tensor is accepted and converted at ``end_step``."""
        with self._lock:
            self._scalars[name] = value

    def emit_record(self, rec_type: str, **fields):
        """An out-of-band (non-step) record: kept in the bounded ring and
        handed to every sink."""
        rec = {"type": rec_type, "time": time.time(), **fields}
        with self._lock:
            self._ring.append(rec)
            sinks = list(self.sinks)
        for s in sinks:
            s.emit(rec)
        return rec

    # -- step lifecycle -------------------------------------------------- #
    def start_step(self, step: Optional[int] = None):
        with self._lock:
            self._step = step
            self._step_t0 = _trace_clock.trace_now()
            self._step_started_wall = time.time()
        if self._ledger is not None:
            try:
                # the inter-step gap goes to the background phase, so
                # fold_step attributes only this step's own interval
                self._ledger.note_step_begin()
            except Exception:
                pass        # attribution must never kill the step loop

    def _clear_step_locked(self):
        self._spans.clear()
        self._span_counts.clear()
        self._scalars.clear()
        self._hists.clear()
        self._hist_samples.clear()
        self._step = None
        self._step_t0 = None
        self._step_started_wall = None

    def end_step(self, step: Optional[int] = None,
                 **scalars) -> Dict[str, object]:
        """Close the pending step: fold its spans, scalars and histograms
        and snapshots of the counters and gauges into one record, fold it
        into the ledger, keep it in the ring, emit it to every sink, and
        reset the per-step state."""
        with self._lock:
            if step is None:
                step = self._step
            dur = (_trace_clock.trace_now() - self._step_t0
                   if self._step_t0 is not None else None)
            pend = dict(self._scalars)
            pend.update(scalars)
            rec: Dict[str, object] = {
                "type": "step", "step": step, "time": time.time(),
                "dur": dur, "spans": dict(self._spans),
                "span_counts": dict(self._span_counts),
                "scalars": {k: _to_float(v) for k, v in pend.items()},
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
            }
            recs = rec["scalars"].get("records")
            if dur and isinstance(recs, (int, float)) and recs > 0:
                rec["scalars"]["records_per_sec"] = recs / dur
            if self._hists:
                rec["hist"] = {}
                for k, h in self._hists.items():
                    entry = {"count": int(h[0]), "min": h[1], "max": h[2],
                             "mean": h[3] / max(h[0], 1), "sumsq": h[4]}
                    samples = sorted(self._hist_samples.get(k) or ())
                    if samples:
                        entry.update({f"p{q:g}": _quantile(samples, q)
                                      for q in (50.0, 95.0, 99.0)})
                    rec["hist"][k] = entry
            self._clear_step_locked()
            self._last_step_end = rec["time"]
            self._last_step_index = step
            self._ring.append(rec)
            sinks = list(self.sinks)
        if self._ledger is not None:
            try:
                # outside the recorder lock: the ledger's and ours never
                # nest
                self._ledger.fold_step(rec["dur"], rec["spans"])
                rec["goodput"] = self._ledger.publish(self)
            except Exception:
                pass        # attribution must never kill a record
        for s in sinks:
            s.emit(rec)
        return rec

    def abort_step(self):
        """Discard the pending step (e.g. the data ran dry after
        ``start_step``)."""
        with self._lock:
            self._clear_step_locked()

    # -- introspection ----------------------------------------------------- #
    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges)}

    def recent_records(self, n: Optional[int] = None,
                       rec_type: Optional[str] = None) -> List[dict]:
        """The last ``n`` records of the ring (all when None), oldest
        first; ``rec_type`` filters on the record's ``type``."""
        with self._lock:
            recs = list(self._ring)
        if rec_type is not None:
            recs = [r for r in recs if r.get("type") == rec_type]
        if n is None:
            return recs
        n = max(int(n), 0)
        return recs[max(len(recs) - n, 0):] if n else []

    def step_age(self) -> Optional[float]:
        """Seconds since the pending step opened, or since the last step
        record was cut; None before any step."""
        with self._lock:
            started, ended = self._step_started_wall, self._last_step_end
        now = time.time()
        if started is not None:
            return now - started
        if ended is not None:
            return now - ended
        return None

    def step_in_flight(self) -> bool:
        """True between ``start_step`` and ``end_step``/``abort_step``."""
        with self._lock:
            return self._step_started_wall is not None

    def last_step(self) -> Optional[int]:
        """Index of the newest completed step (None before the first)."""
        with self._lock:
            return self._last_step_index

    def flush(self):
        for s in self.sinks:
            fl = getattr(s, "flush", None)
            if fl is not None:
                fl()
        return self

    def close(self):
        for s in self.sinks:
            close = getattr(s, "close", None)
            if close is not None:
                close()


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def _quantile(sorted_samples: List[float], q: float) -> float:
    """Linear-interpolated percentile (numpy's default method) over an
    already-sorted list."""
    n = len(sorted_samples)
    if n == 0:
        return float("nan")
    if n == 1:
        return sorted_samples[0]
    pos = (q / 100.0) * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_samples[lo] * (1.0 - frac) + sorted_samples[hi] * frac

