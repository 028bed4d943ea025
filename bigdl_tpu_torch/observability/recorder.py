"""Thread-safe telemetry recorder — the part the serving engine uses.

Port of ``bigdl_tpu/observability/recorder.py``: counters (``inc``),
gauges (``gauge``), histograms with p50/p95/p99 over a bounded recent
window (``observe``, ``hist_summary``, ``hist_quantiles``), timed spans
(``span``) and
out-of-band records (``emit_record``) kept in a bounded ring.

A goodput ledger (:class:`~bigdl_tpu_torch.observability.goodput.GoodputLedger`)
attaches with :meth:`set_ledger`; the engines fold into it.

Not ported yet (ROADMAP queue A, operate plane): step records
(``start_step``/``end_step``, which fold a step into the ledger), profiler
traces, the cost model, time series, Prometheus buckets, sinks, disabled
recorders and the process-active recorder.
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

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._spans: Dict[str, float] = {}
        self._span_counts: Dict[str, int] = {}
        # count/min/max/sum/sumsq over ALL samples; quantiles over the
        # most recent HIST_SAMPLE_CAP
        self._hists: Dict[str, List[float]] = {}
        self._hist_samples: Dict[str, deque] = {}
        self._ring: deque = deque(maxlen=self.KEEP_RECORDS)
        self._ledger = None

    @property
    def enabled(self) -> bool:
        """Always True: the port has no disabled recorder."""
        return True

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

    def emit_record(self, rec_type: str, **fields):
        """Keep an out-of-band record in the bounded ring."""
        rec = {"type": rec_type, "time": time.time(), **fields}
        with self._lock:
            self._ring.append(rec)
        return rec


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

