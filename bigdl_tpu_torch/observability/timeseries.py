"""Fixed-capacity time series for metrics (≙
``bigdl_tpu/observability/timeseries.py``): the time dimension the
Recorder's instantaneous counters and gauges lack.

A :class:`MetricSeries` is a preallocated ``(timestamp, value)`` ring:
O(1) append, bounded memory, and *windowed* reducers (rate, delta,
mean, pXX) computed over a trailing **time** window rather than a
sample count, which is what SLO math needs ("p99 over the last 5
minutes").

A :class:`SeriesStore` keys many series by metric name behind one lock
and an **injected clock**, so tests drive virtual time and burn-rate
fixtures reproduce bit for bit.  The store is what

  * ``Recorder(keep_series=N)`` feeds from ``end_step`` (scalars,
    counters, gauges, histogram quantiles) and ``series_tick``,
  * :class:`~bigdl_tpu_torch.observability.aggregate.MetricsAggregator`
    feeds from every scrape, and
  * :class:`~bigdl_tpu_torch.observability.slo.SLOEngine` evaluates
    objectives over.

``IntrospectionServer`` serves any attached store at
``/series?name=&window=`` as JSON-safe points.  Host arithmetic only:
the same inputs give the reference's outputs bit for bit.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .recorder import _quantile


class MetricSeries:
    """One metric's ``(t, v)`` ring: O(1) append, windowed reducers.

    The ring is two preallocated float lists; ``append`` overwrites the
    oldest slot once ``capacity`` points exist.  Timestamps are assumed
    non-decreasing (the store's single clock guarantees it); reducers
    never raise on empty/short windows — they return ``None``, so SLO
    evaluation can distinguish "no data" from "zero".
    """

    __slots__ = ("_t", "_v", "_cap", "_n")

    def __init__(self, capacity: int = 512):
        cap = max(int(capacity), 1)
        self._cap = cap
        self._t: List[float] = [0.0] * cap
        self._v: List[float] = [0.0] * cap
        self._n = 0                   # total points ever appended

    @property
    def capacity(self) -> int:
        return self._cap

    def __len__(self) -> int:
        return min(self._n, self._cap)

    def append(self, t: float, v: float):
        i = self._n % self._cap
        self._t[i] = float(t)
        self._v[i] = float(v)
        self._n += 1

    def last(self) -> Optional[Tuple[float, float]]:
        if self._n == 0:
            return None
        i = (self._n - 1) % self._cap
        return (self._t[i], self._v[i])

    def points(self, window: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Chronological ``[(t, v), ...]``; ``window`` keeps only points
        with ``t >= now - window`` (``now`` defaults to the newest
        timestamp, so a quiesced series still reduces over its tail)."""
        n = len(self)
        if n == 0:
            return []
        start = (self._n - n) % self._cap
        pts = [(self._t[(start + k) % self._cap],
                self._v[(start + k) % self._cap]) for k in range(n)]
        if window is None:
            return pts
        if now is None:
            now = pts[-1][0]
        cutoff = now - float(window)
        return [p for p in pts if p[0] >= cutoff]

    # -- windowed reducers ------------------------------------------------ #
    def mean(self, window: Optional[float] = None,
             now: Optional[float] = None) -> Optional[float]:
        pts = self.points(window, now)
        if not pts:
            return None
        return sum(v for _, v in pts) / len(pts)

    def delta(self, window: Optional[float] = None,
              now: Optional[float] = None) -> Optional[float]:
        """``last - first`` value over the window — a counter's increase
        (None with fewer than two points: one sample has no slope)."""
        pts = self.points(window, now)
        if len(pts) < 2:
            return None
        return pts[-1][1] - pts[0][1]

    def rate(self, window: Optional[float] = None,
             now: Optional[float] = None) -> Optional[float]:
        """Per-second increase over the window (counter semantics);
        ``None`` with fewer than two points or zero elapsed time."""
        pts = self.points(window, now)
        if len(pts) < 2:
            return None
        dt = pts[-1][0] - pts[0][0]
        if dt <= 0:
            return None
        return (pts[-1][1] - pts[0][1]) / dt

    def quantile(self, q: float, window: Optional[float] = None,
                 now: Optional[float] = None) -> Optional[float]:
        """Linear-interpolated percentile (``q`` in [0, 100]) of the
        point VALUES inside the window."""
        pts = self.points(window, now)
        if not pts:
            return None
        return _quantile(sorted(v for _, v in pts), q)

    def vmin(self, window: Optional[float] = None,
             now: Optional[float] = None) -> Optional[float]:
        pts = self.points(window, now)
        return min(v for _, v in pts) if pts else None

    def vmax(self, window: Optional[float] = None,
             now: Optional[float] = None) -> Optional[float]:
        pts = self.points(window, now)
        return max(v for _, v in pts) if pts else None


class SeriesStore:
    """Named :class:`MetricSeries` behind one lock and one clock.

    ``clock`` is any zero-arg callable returning seconds; inject a
    virtual clock in tests so windowed math is deterministic.  Series
    are created on first ``observe`` with the store's per-series
    ``capacity``.
    """

    def __init__(self, capacity: int = 512,
                 clock: Optional[Callable[[], float]] = None):
        self.capacity = max(int(capacity), 1)
        self.clock = clock if clock is not None else time.time
        self._lock = threading.Lock()
        self._series: Dict[str, MetricSeries] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._series)

    def now(self) -> float:
        return float(self.clock())

    def observe(self, name: str, value: float,
                t: Optional[float] = None):
        """Append one point (``t`` defaults to the store clock)."""
        if t is None:
            t = self.now()
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = MetricSeries(self.capacity)
            s.append(t, value)

    def get(self, name: str) -> Optional[MetricSeries]:
        with self._lock:
            return self._series.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def match(self, patterns) -> List[str]:
        """Names matching any fnmatch-style pattern in ``patterns`` (a
        string is one pattern).  A pattern without glob characters also
        matches as an exact name or a ``.../<pattern>`` suffix, so
        objectives can say ``decode/ttft_ms/p99`` without caring which
        source prefix the aggregator added."""
        from fnmatch import fnmatchcase
        if isinstance(patterns, str):
            patterns = (patterns,)
        names = self.names()
        out = []
        for n in names:
            for p in patterns:
                if ("*" in p or "?" in p or "[" in p):
                    if fnmatchcase(n, p):
                        out.append(n)
                        break
                elif n == p or n.endswith("/" + p):
                    out.append(n)
                    break
        return out

    def drop(self, patterns) -> int:
        """Remove every series whose name matches ``patterns`` (same
        semantics as :meth:`match`); returns how many were dropped.
        The deregistration seam: when a fleet member is deliberately
        scaled away its history leaves the store with it, so windowed
        reducers (and the SLO engine on top) stop judging a replica
        that no longer exists — as opposed to a *crashed* member,
        whose series are retained so dashboards see the gap."""
        victims = self.match(patterns)
        dropped = 0
        with self._lock:
            for name in victims:
                if self._series.pop(name, None) is not None:
                    dropped += 1
        return dropped

    def points(self, name: str, window: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        s = self.get(name)
        return s.points(window, now) if s is not None else []

    def summary(self, name: str, window: Optional[float] = None,
                now: Optional[float] = None) -> Optional[Dict[str, float]]:
        """JSON-safe reducer bundle for ``/series``: n/mean/min/max/
        p50/p95/p99/delta/rate over the window; ``None`` for unknown
        names."""
        s = self.get(name)
        if s is None:
            return None
        pts = s.points(window, now)
        if not pts:
            return {"n": 0}
        vals = sorted(v for _, v in pts)
        out = {"n": len(pts), "mean": sum(vals) / len(vals),
               "min": vals[0], "max": vals[-1],
               "p50": _quantile(vals, 50.0),
               "p95": _quantile(vals, 95.0),
               "p99": _quantile(vals, 99.0)}
        d = s.delta(window, now)
        if d is not None:
            out["delta"] = d
        r = s.rate(window, now)
        if r is not None:
            out["rate"] = r
        return out
