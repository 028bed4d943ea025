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

A cost model (``set_cost_model``: the step cost capture's
:class:`~bigdl_tpu_torch.observability.profile.StepCostModel`) folds
``perf/mfu`` and its kin into every step record; gauge pollers
(``add_gauge_poller``: live device memory) refresh before each snapshot
and record; opted-in histograms count Prometheus buckets
(``set_hist_buckets``).  ``trace_every(n, log_dir)`` captures a
``torch.profiler`` trace of every n-th step as a Chrome trace file, with
the recorder's spans as ranges on its timeline.  A disabled recorder
(``enable(False)``) drops everything.

Not ported yet (ROADMAP queue A, A8b): time series (``keep_series``,
``series_tick``) and the process-active recorder.
"""
from __future__ import annotations

import os
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Any, Dict, List, Optional

from . import context as _trace_clock


class _NullSpan:
    """Shared no-op context manager for disabled recorders."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_rec", "_name", "_t0", "_range")

    def __init__(self, rec: "Recorder", name: str):
        self._rec = rec
        self._name = name
        self._range = None

    def __enter__(self):
        if self._rec._tracing:
            # a range on the profiler's timeline while a trace is captured
            import torch
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        self._t0 = _trace_clock.trace_now()
        return self

    def __exit__(self, *exc):
        dt = _trace_clock.trace_now() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        self._rec._add_span(self._name, dt)
        return False


class Recorder:
    """Aggregates counters, gauges, histograms and spans."""

    #: quantiles are taken over the most recent this-many samples
    HIST_SAMPLE_CAP = 2048
    #: ``emit_record`` keeps the most recent this-many records
    KEEP_RECORDS = 256

    def __init__(self, sinks=(), keep_records: Optional[int] = None,
                 enabled: bool = True):
        self._lock = threading.Lock()
        self.sinks = list(sinks)
        self._enabled = bool(enabled)
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
        # a StepCostModel: scalars(dur) folded into every step record
        self._cost_model = None
        # callables(recorder) refreshing live gauges before each snapshot
        self._gauge_pollers: List = []
        # opt-in Prometheus buckets: name (or "prefix/*") -> upper bounds;
        # per-bin counts beside _hists, with its per-step lifecycle
        self._hist_bucket_spec: Dict[str, tuple] = {}
        self._hist_bucket_bounds: Dict[str, Optional[tuple]] = {}
        self._hist_bucket_counts: Dict[str, List[int]] = {}
        # trace_every: (every_n, log_dir); the open profiler session
        self._trace_cfg = None
        self._tracing = False
        self._profiler = None
        self._trace_step = None
        self.trace_files: List[str] = []
        # the pending step: its per-step scalars and clock; liveness
        self._scalars: Dict[str, object] = {}
        self._step: Optional[int] = None
        self._step_t0: Optional[float] = None
        self._step_started_wall: Optional[float] = None
        self._last_step_end: Optional[float] = None
        self._last_step_index: Optional[int] = None

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, on: bool = True):
        """A disabled recorder's methods return at once (its ``span`` is a
        shared no-op), so instrumentation stays in the hot path."""
        self._enabled = bool(on)
        return self

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

    def set_cost_model(self, model):
        """Attach a cost model (anything with ``scalars(dur) -> dict``,
        e.g. :class:`~bigdl_tpu_torch.observability.profile
        .StepCostModel`); ``end_step`` folds its scalars into every step
        record.  ``None`` detaches."""
        self._cost_model = model
        return self

    def add_gauge_poller(self, fn):
        """Register ``fn(recorder)`` to refresh live gauges right before
        each ``snapshot()`` / ``end_step()`` (every /metrics scrape and
        every step record).  A poller's exception is swallowed."""
        self._gauge_pollers.append(fn)
        return self

    def _run_gauge_pollers(self):
        # outside the lock: pollers call self.gauge(), which locks
        for fn in list(self._gauge_pollers):
            try:
                fn(self)
            except Exception:
                pass

    # -- primitives ------------------------------------------------------ #
    def inc(self, name: str, value: float = 1.0) -> float:
        """Add to a monotonic counter; returns the new total."""
        if not self._enabled:
            return 0.0
        with self._lock:
            total = self._counters.get(name, 0.0) + value
            self._counters[name] = total
            return total

    def gauge(self, name: str, value: float):
        """Set a last-value gauge."""
        if not self._enabled:
            return
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
        if not self._enabled:
            return
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
            if self._hist_bucket_spec:
                bounds = self._resolve_buckets(name)
                if bounds is not None:
                    c = self._hist_bucket_counts.get(name)
                    if c is None:
                        c = self._hist_bucket_counts[name] = \
                            [0] * (len(bounds) + 1)
                    c[bisect_left(bounds, v)] += 1

    # -- Prometheus histogram buckets (opt-in) --------------------------- #
    def set_hist_buckets(self, spec: Dict[str, Any]):
        """Opt histograms into cumulative ``_bucket`` exposition.
        ``spec`` maps an exact histogram name, or a ``"prefix/*"`` family,
        to its ``le`` upper bounds (``+Inf`` is implicit).  Exact names
        beat families; among families the longest prefix wins.  Buckets
        are counted at ``observe`` time, so ``_bucket`` lines stay
        consistent with ``_count``."""
        with self._lock:
            self._hist_bucket_spec = {
                str(k): tuple(sorted(float(b) for b in v))
                for k, v in spec.items()}
            self._hist_bucket_bounds.clear()
            self._hist_bucket_counts.clear()
        return self

    def _resolve_buckets(self, name: str) -> Optional[tuple]:
        # caller holds the lock
        if name in self._hist_bucket_bounds:
            return self._hist_bucket_bounds[name]
        bounds = self._hist_bucket_spec.get(name)
        if bounds is None:
            best = -1
            for pat, b in self._hist_bucket_spec.items():
                if pat.endswith("/*") and len(pat) > best \
                        and name.startswith(pat[:-1]):
                    bounds, best = b, len(pat)
        self._hist_bucket_bounds[name] = bounds
        return bounds

    def hist_buckets(self, name: str):
        """``(bounds, per_bin_counts)`` of an opted-in histogram with
        observations this step, else ``None``; ``per_bin_counts`` has
        ``len(bounds) + 1`` entries (the last is the overflow bin)."""
        with self._lock:
            c = self._hist_bucket_counts.get(name)
            if c is None:
                return None
            return (self._hist_bucket_bounds.get(name), list(c))

    def hist_names(self) -> List[str]:
        """Names with at least one observation in the pending step."""
        with self._lock:
            return list(self._hists)

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
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name)

    def _add_span(self, name: str, dt: float):
        with self._lock:
            self._spans[name] = self._spans.get(name, 0.0) + dt
            self._span_counts[name] = self._span_counts.get(name, 0) + 1

    def add_span(self, name: str, seconds: float):
        """Record an externally timed duration as a span."""
        if not self._enabled:
            return
        self._add_span(name, seconds)

    def scalar(self, name: str, value):
        """Record a per-step scalar (loss, grad norm, lr, ...); a device
        tensor is accepted and converted at ``end_step``."""
        if not self._enabled:
            return
        with self._lock:
            self._scalars[name] = value

    def emit_record(self, rec_type: str, **fields):
        """An out-of-band (non-step) record: kept in the bounded ring and
        handed to every sink."""
        if not self._enabled:
            return None
        rec = {"type": rec_type, "time": time.time(), **fields}
        with self._lock:
            self._ring.append(rec)
            sinks = list(self.sinks)
        for s in sinks:
            s.emit(rec)
        return rec

    # -- step lifecycle -------------------------------------------------- #
    def start_step(self, step: Optional[int] = None):
        if not self._enabled:
            return
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
        self._maybe_start_trace(step)

    def _clear_step_locked(self):
        self._spans.clear()
        self._span_counts.clear()
        self._scalars.clear()
        self._hists.clear()
        self._hist_samples.clear()
        self._hist_bucket_counts.clear()
        self._step = None
        self._step_t0 = None
        self._step_started_wall = None

    def end_step(self, step: Optional[int] = None,
                 **scalars) -> Dict[str, object]:
        """Close the pending step: fold its spans, scalars and histograms
        and snapshots of the counters and gauges into one record, fold it
        into the ledger, keep it in the ring, emit it to every sink, and
        reset the per-step state."""
        if not self._enabled:
            return None
        self._maybe_stop_trace()
        self._run_gauge_pollers()
        with self._lock:
            if step is None:
                step = self._step
            dur = (_trace_clock.trace_now() - self._step_t0
                   if self._step_t0 is not None else None)
            pend = dict(self._scalars)
            pend.update(scalars)
            if self._cost_model is not None:
                try:
                    # arithmetic over the captured cost; explicit scalars
                    # win ties
                    for k, v in self._cost_model.scalars(dur).items():
                        pend.setdefault(k, v)
                except Exception:
                    pass        # attribution must never kill a record
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
        ``start_step``, or the step raised); a trace it opened is closed
        and discarded, as its record is."""
        if not self._enabled:
            return
        self._maybe_stop_trace(export=False)
        with self._lock:
            self._clear_step_locked()

    # -- on-demand profiler traces --------------------------------------- #
    def trace_every(self, n_steps: int, log_dir: str):
        """Capture a ``torch.profiler`` trace (host ops and ranges, and the
        device's kernels and copies on a CUDA machine) of every
        ``n_steps``-th step, written to ``log_dir`` as a Chrome trace file
        ``trace_step<k>.json`` (open with Perfetto or chrome://tracing).
        ``n_steps=0`` disables."""
        self._trace_cfg = (int(n_steps), str(log_dir)) if n_steps else None
        return self

    def _maybe_start_trace(self, step):
        if self._tracing:
            # the previously traced step raised before end_step/abort_step
            # could close the session: stop the stale trace now, or every
            # remaining step would fold into one capture
            self._maybe_stop_trace()
        cfg = self._trace_cfg
        if cfg is None or step is None or step % cfg[0] != 0:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        try:
            prof.start()
            self._profiler, self._trace_step = prof, step
            self._tracing = True
        except Exception:
            # start may have opened a session before raising: never let
            # the flag and the profiler disagree
            try:
                prof.stop()
            except Exception:
                pass
            self._profiler = None
            self._tracing = False

    def _maybe_stop_trace(self, export: bool = True):
        if not self._tracing:
            return
        prof, self._profiler = self._profiler, None
        self._tracing = False
        try:
            import torch
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()    # the step's kernels complete
            prof.stop()
            if not export:
                return
            log_dir = self._trace_cfg[1] if self._trace_cfg else "."
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"trace_step{self._trace_step}.json")
            prof.export_chrome_trace(path)
            self.trace_files.append(path)
        except Exception:
            pass        # profiling must never kill training

    # -- introspection ----------------------------------------------------- #
    def snapshot(self) -> Dict[str, Dict[str, float]]:
        self._run_gauge_pollers()
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

