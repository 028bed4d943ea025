"""Declarative SLOs with error-budget burn-rate alerting (≙
``bigdl_tpu/observability/slo.py``).

An :class:`SLObjective` states what good looks like ("decode TTFT p99
<= 200 ms for 99 % of observations over 5 minutes"); the
:class:`SLOEngine` evaluates every objective over a
:class:`~bigdl_tpu_torch.observability.timeseries.SeriesStore` (a
``Recorder(keep_series=)`` store or a
:class:`~bigdl_tpu_torch.observability.aggregate.MetricsAggregator`'s
scrape-fed one) into:

  compliance        good / total observations inside the window
  budget_remaining  ``1 - burn_slow``: the fraction of the window's
                    error budget still unspent (negative = overspent)
  burn rate         ``(1 - compliance) / (1 - target)``; 1.0 spends the
                    budget exactly as fast as allowed.  Evaluated over a
                    **fast** window (default ``window / 12``) and the
                    full **slow** window; a breach fires only when BOTH
                    reach ``burn_alert``

Verdicts go through a :class:`Recorder`: per-objective ``slo/*`` gauges
on every evaluation, ``slo/breaches`` / ``slo/recoveries`` counters and
an ``slo_event`` record on every state transition.

Two objective modes:

  threshold  ``series=`` patterns + ``threshold=``: each point in the
             window is good iff ``value <= threshold`` (or ``>=`` with
             ``good_below=False``).  For latency-quantile series.
  ratio      ``bad_series=`` / ``total_series=`` counter patterns:
             compliance is ``1 - Δbad / Δtotal`` over the window.  For
             shed rate and checkpoint write failures.

All time comes from an injected clock (the store's), and the math is
host float arithmetic: the same points give the reference's verdicts
bit for bit.  :meth:`SLOEngine.start` evaluates on a daemon thread that
:meth:`SLOEngine.stop` joins with a time-out.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .recorder import Recorder


class SLObjective:
    """One service-level objective over series-store metrics."""

    def __init__(self, name: str, target: float, window: float,
                 series=None, threshold: Optional[float] = None,
                 good_below: bool = True, bad_series=None,
                 total_series=None, fast_window: Optional[float] = None,
                 burn_alert: float = 2.0, description: str = ""):
        if (series is None) == (bad_series is None):
            raise ValueError("exactly one of series= (threshold mode) "
                             "or bad_series=/total_series= (ratio mode)"
                             " is required")
        if series is not None and threshold is None:
            raise ValueError("threshold mode needs threshold=")
        if bad_series is not None and total_series is None:
            raise ValueError("ratio mode needs total_series=")
        self.name = str(name)
        self.target = float(target)
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1)")
        self.window = float(window)
        self.fast_window = (float(fast_window) if fast_window is not None
                            else self.window / 12.0)
        self.series = series
        self.threshold = (float(threshold) if threshold is not None
                          else None)
        self.good_below = bool(good_below)
        self.bad_series = bad_series
        self.total_series = total_series
        self.burn_alert = float(burn_alert)
        self.description = description

    @property
    def mode(self) -> str:
        return "threshold" if self.series is not None else "ratio"

    # -- window math -------------------------------------------------------- #
    def compliance(self, store, window: float, now: float
                   ) -> Tuple[float, float, Optional[float]]:
        """``(good, total, compliance)`` over the trailing ``window``;
        compliance is ``None`` when there is no data to judge."""
        if self.series is not None:
            good = total = 0
            for key in store.match(self.series):
                for _, v in store.points(key, window, now):
                    total += 1
                    if (v <= self.threshold if self.good_below
                            else v >= self.threshold):
                        good += 1
            return (float(good), float(total),
                    good / total if total else None)
        bad = self._delta_sum(store, self.bad_series, window, now)
        tot = self._delta_sum(store, self.total_series, window, now)
        if tot is None or tot <= 0:
            return (bad or 0.0, tot or 0.0, None)
        bad = bad or 0.0
        return (bad, tot, max(0.0, 1.0 - bad / tot))

    @staticmethod
    def _delta_sum(store, patterns, window: float, now: float
                   ) -> Optional[float]:
        """Summed counter increase over the window across every
        matching series (None when no series has two points yet)."""
        total = None
        for key in store.match(patterns):
            d = store.get(key).delta(window, now)
            if d is not None:
                total = (total or 0.0) + max(d, 0.0)
        return total

    def evaluate(self, store, now: Optional[float] = None
                 ) -> Dict[str, Any]:
        """One verdict: compliance + budget over the full window, burn
        rates over (fast, slow) windows, breach = both above
        ``burn_alert``.  A window with no data never breaches — "no
        traffic" is not "all traffic failed"."""
        if now is None:
            now = store.now()
        allowed = 1.0 - self.target
        good, total, comp_slow = self.compliance(store, self.window, now)
        _, _, comp_fast = self.compliance(store, self.fast_window, now)
        burn_slow = (None if comp_slow is None
                     else (1.0 - comp_slow) / allowed)
        burn_fast = (None if comp_fast is None
                     else (1.0 - comp_fast) / allowed)
        breach = (burn_slow is not None and burn_fast is not None
                  and burn_slow >= self.burn_alert
                  and burn_fast >= self.burn_alert)
        return {
            "objective": self.name,
            "mode": self.mode,
            "target": self.target,
            "threshold": self.threshold,
            "window": self.window,
            "fast_window": self.fast_window,
            "burn_alert": self.burn_alert,
            "good": good,
            "total": total,
            "compliance": comp_slow,
            "budget_remaining": (None if burn_slow is None
                                 else 1.0 - burn_slow),
            "burn_slow": burn_slow,
            "burn_fast": burn_fast,
            "no_data": comp_slow is None,
            "breach": breach,
        }


def default_objectives(window: float = 300.0, target: float = 0.99,
                       ttft_p99_ms: float = 200.0,
                       intertoken_p99_ms: float = 50.0,
                       shed_target: float = 0.99,
                       ckpt_target: float = 0.999,
                       burn_alert: float = 2.0) -> List[SLObjective]:
    """The serving + training objectives this codebase already exports
    metrics for.  Patterns match BOTH naming planes: a raw recorder
    store (``decode/ttft_ms/p99``) and an aggregator store
    (``replica0/bigdl_decode_ttft_ms/p99``)."""
    return [
        SLObjective("decode_ttft_p99", target=target, window=window,
                    series=("*decode*ttft_ms/p99",),
                    threshold=ttft_p99_ms, burn_alert=burn_alert,
                    description="time-to-first-token p99"),
        SLObjective("decode_intertoken_p99", target=target,
                    window=window,
                    series=("*decode*intertoken_ms/p99",),
                    threshold=intertoken_p99_ms, burn_alert=burn_alert,
                    description="inter-token latency p99"),
        SLObjective("shed_rate", target=shed_target, window=window,
                    bad_series=("*decode*shed_*", "*serving*shed_*"),
                    total_series=("*decode*requests*",
                                  "*serving*requests*"),
                    burn_alert=burn_alert,
                    description="admitted fraction of offered requests"),
        SLObjective("checkpoint_writes", target=ckpt_target,
                    window=window,
                    bad_series=("*checkpoint*failed*",),
                    total_series=("*checkpoint*committed*",
                                  "*checkpoint*failed*"),
                    burn_alert=burn_alert,
                    description="checkpoint write success"),
    ]


class SLOEngine:
    """Evaluate objectives over a series store; emit ``slo/*`` gauges
    and ``slo_event`` records through a Recorder."""

    def __init__(self, store, objectives: Sequence[SLObjective] = (),
                 recorder: Optional[Recorder] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.store = store
        self.objectives: List[SLObjective] = list(objectives)
        self.recorder = recorder if recorder is not None \
            else Recorder()
        self.clock = clock if clock is not None \
            else getattr(store, "now", time.time)
        self._breached: Dict[str, bool] = {}
        #: the most recent :meth:`evaluate` results, by objective name —
        #: consumers that must not re-run the window math (the
        #: autoscale policy reading burn rates between its own ticks)
        #: read this instead of calling evaluate() again
        self.last_results: Dict[str, Dict[str, Any]] = {}
        self.last_eval_at: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def add(self, objective: SLObjective) -> "SLOEngine":
        self.objectives.append(objective)
        return self

    def evaluate(self, now: Optional[float] = None
                 ) -> Dict[str, Dict[str, Any]]:
        """One pass over every objective.  Gauges are refreshed each
        call; ``slo_event`` records fire only on breach/recovery
        transitions, so the record stream stays quiet in steady state."""
        if now is None:
            now = float(self.clock())
        rec = self.recorder
        results: Dict[str, Dict[str, Any]] = {}
        for obj in self.objectives:
            r = obj.evaluate(self.store, now)
            results[obj.name] = r
            g = f"slo/{obj.name}"
            rec.gauge(f"{g}/breach", 1.0 if r["breach"] else 0.0)
            rec.gauge(f"{g}/no_data", 1.0 if r["no_data"] else 0.0)
            if not r["no_data"]:
                rec.gauge(f"{g}/compliance", r["compliance"])
                rec.gauge(f"{g}/budget_remaining",
                          r["budget_remaining"])
                rec.gauge(f"{g}/burn_slow", r["burn_slow"])
                if r["burn_fast"] is not None:
                    rec.gauge(f"{g}/burn_fast", r["burn_fast"])
            prev = self._breached.get(obj.name, False)
            if r["breach"] and not prev:
                rec.inc("slo/breaches")
                rec.emit_record("slo_event", kind="breach",
                                eval_time=now, **r)
            elif prev and not r["breach"] and not r["no_data"]:
                rec.inc("slo/recoveries")
                rec.emit_record("slo_event", kind="recovered",
                                eval_time=now, **r)
            if not r["no_data"]:
                self._breached[obj.name] = r["breach"]
        self.last_results = results
        self.last_eval_at = now
        return results

    def breached(self) -> List[str]:
        """Objectives currently in breach, sorted."""
        return sorted(n for n, b in self._breached.items() if b)

    def summary_record(self, results: Optional[Dict[str, Any]] = None,
                       now: Optional[float] = None) -> Dict[str, Any]:
        """Emit one ``slo_summary`` record carrying the full objective
        table — the shutdown/post-run snapshot ``trace_summary slo``
        renders its table from."""
        if now is None:
            now = float(self.clock())
        if results is None:
            results = self.evaluate(now)
        return self.recorder.emit_record(
            "slo_summary", eval_time=now,
            objectives=[results[o.name] for o in self.objectives
                        if o.name in results])

    # -- background evaluation ---------------------------------------------- #
    def start(self, interval: float = 5.0) -> "SLOEngine":
        if self._thread is not None:
            return self

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.evaluate()
                except Exception:
                    pass        # SLO math must never kill the host

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="slo-engine")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
