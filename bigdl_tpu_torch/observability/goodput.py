"""Goodput ledger (≙ ``bigdl_tpu/observability/goodput.py``):
device-second accounting with badput attribution.

Every second of wall-clock × device an engine owns is classified into
**goodput** (productive batch compute, live decode slots) or exactly one
bucket of a closed taxonomy of **badput** (:data:`BUCKETS`): compile and
warmup runs, failover re-dispatch, golden-probe readmission, queue wait,
brownout, or ``idle``, the honest remainder.

**Conservation by construction.**  The ledger is an exclusive-bucket
interval accountant: a monotonic cursor advances through wall time under
one lock, and every elapsed interval × device count lands in exactly one
bucket (or is split across buckets whose shares sum to the interval), so
``sum(buckets) == owned`` holds to float rounding.

**No host syncs.**  Folding is host arithmetic over time stamps the
producers already take: the decode engine folds each step by slot
occupancy (``fold_split``), the serving engine each batch by fill, and the
replica set marks coarse control-plane phases
(``with ledger_phase(rec, "failover")``).

Wiring::

    rec.set_ledger(GoodputLedger(name="serving", devices=1))
    with ledger_phase(rec, "probe_readmission"):
        ...

The Recorder's ``end_step`` folds each step (``fold_step``), and the
introspection server's ``/goodput`` serves :meth:`GoodputLedger.snapshot`.
Not ported (ROADMAP queue A, A8b): the pool side (``OwnershipLedger``,
``rollup``) and the elastic supervisor's state buckets.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from . import context as _trace_clock

#: the closed taxonomy; "goodput" first, "idle" (unattributed) last
BUCKETS = (
    "goodput",
    "compile_warmup",
    "input_stall",
    "checkpoint_blocking",
    "preemption_drain",
    "preemption_replan",
    "preemption_reshard",
    "failover",
    "probe_readmission",
    "queue_wait",
    "brownout",
    "autoscale_transfer",
    "idle",
)

#: recorder span name -> badput bucket.  Spans not listed here are
#: productive step time (the residual of fold_step is goodput).
SPAN_BUCKETS = {
    "data_fetch": "input_stall",
    "h2d": "input_stall",
    "train_step_compile": "compile_warmup",
    "profile.capture": "compile_warmup",
    "serving.compile": "compile_warmup",
    "serving.warmup": "compile_warmup",
    "decode.compile": "compile_warmup",
    "decode.warmup": "compile_warmup",
    "checkpoint.blocking": "checkpoint_blocking",
    "elastic.reshard": "preemption_reshard",
}

class _Phase:
    """Context manager for one declared badput phase; time elapsing
    while it is the innermost active phase lands in its bucket."""
    __slots__ = ("_led", "_bucket", "_token")

    def __init__(self, led: "GoodputLedger", bucket: str):
        self._led = led
        self._bucket = bucket
        self._token = None

    def __enter__(self):
        self._token = self._led._push_phase(self._bucket)
        return self

    def __exit__(self, *exc):
        self._led._pop_phase(self._token)
        return False


class _NullPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_PHASE = _NullPhase()


def ledger_phase(recorder, bucket: str):
    """``with ledger_phase(rec, "failover"): ...`` — a no-op context
    manager when ``recorder`` carries no ledger, so producers can
    instrument unconditionally (the disabled-recorder discipline)."""
    led = getattr(recorder, "get_ledger", None)
    led = led() if led is not None else None
    if led is None:
        return _NULL_PHASE
    return led.phase(bucket)


class GoodputLedger:
    """Exclusive-bucket device-second accountant for one job.

    Every public method advances the cursor under one lock, so buckets
    are disjoint by construction and ``sum(buckets) == owned`` holds to
    rounding regardless of which threads drive it.
    """

    def __init__(self, name: str = "job", devices: int = 1,
                 clock=None):
        self.name = str(name)
        self._clock = clock if clock is not None else _trace_clock.trace_now
        self._lock = threading.Lock()
        self._devices = max(0, int(devices))
        self._cursor = float(self._clock())
        self._owned = 0.0
        self._acc: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        # declared-phase stack; index 0 is the background phase wall
        # time defaults into, later entries are nested declarations
        # (innermost/newest wins)
        self._phases: List[List[Any]] = [[0, "idle"]]
        self._phase_seq = 0

    # -- core interval engine (callers hold no lock) ---------------------- #
    def _advance_locked(self, now: float, bucket: Optional[str] = None):
        dt = now - self._cursor
        if dt <= 0.0:
            self._cursor = max(self._cursor, now)
            return 0.0
        self._cursor = now
        dev_s = dt * self._devices
        self._owned += dev_s
        b = bucket if bucket is not None else self._phases[-1][1]
        self._acc[b] = self._acc.get(b, 0.0) + dev_s
        return dt

    def _now(self, now: Optional[float]) -> float:
        return float(now) if now is not None else float(self._clock())

    # -- device count ------------------------------------------------------ #
    def set_devices(self, n: int, now: Optional[float] = None):
        """Change the device count this job owns; time up to ``now`` is
        charged at the old count (the transfer instant is the edge)."""
        now = self._now(now)
        with self._lock:
            self._advance_locked(now)
            self._devices = max(0, int(n))
        return self

    @property
    def devices(self) -> int:
        return self._devices

    # -- declared phases --------------------------------------------------- #
    def _push_phase(self, bucket: str):
        now = self._now(None)
        with self._lock:
            self._advance_locked(now)
            self._phase_seq += 1
            token = [self._phase_seq, str(bucket)]
            self._phases.append(token)
            return token

    def _pop_phase(self, token):
        now = self._now(None)
        with self._lock:
            self._advance_locked(now)
            # remove THIS declaration wherever it sits: concurrent
            # phases from different threads unwind in any order, and
            # time always flowed to whichever was newest at the time
            for i in range(len(self._phases) - 1, 0, -1):
                if self._phases[i] is token:
                    del self._phases[i]
                    break

    def phase(self, bucket: str) -> _Phase:
        """Declare a badput phase for a ``with`` region — drain,
        replan, failover, probe, autoscale transfer.  Nested/concurrent
        phases never double-book: elapsed time goes to the newest
        active declaration only."""
        return _Phase(self, bucket)

    def declare(self, bucket: str, now: Optional[float] = None) -> str:
        """Set the *background* phase — what un-folded wall time counts
        as until the next declaration (the ElasticSupervisor state
        machine drives this).  Returns the previous background."""
        now = self._now(now)
        with self._lock:
            self._advance_locked(now)
            prev = self._phases[0][1]
            self._phases[0][1] = str(bucket)
            return prev

    # -- folding ----------------------------------------------------------- #
    def note_step_begin(self, now: Optional[float] = None):
        """Close out the inter-step gap (charged to the background
        phase) so the following ``fold_step`` attributes only the step's
        own interval."""
        now = self._now(now)
        with self._lock:
            self._advance_locked(now)
        return self

    def fold_step(self, dur: Optional[float],
                  spans: Optional[Dict[str, float]] = None,
                  now: Optional[float] = None):
        """Attribute one finished step's interval from its recorded
        span totals — the ``end_step``-time fold (no extra host syncs,
        pure arithmetic over telemetry already collected).

        Of the elapsed interval since the cursor, up to ``dur`` seconds
        are the step: badput spans (``SPAN_BUCKETS``) are carved out
        first (clamped — overlapping spans can't mint time), the
        residual is goodput.  Anything elapsed beyond ``dur`` (a gap
        before the step that ``note_step_begin`` didn't close) goes to
        the background phase."""
        now = self._now(now)
        with self._lock:
            dt = now - self._cursor
            if dt <= 0.0:
                self._cursor = max(self._cursor, now)
                return self
            self._cursor = now
            dev = self._devices
            self._owned += dt * dev
            step = min(float(dur), dt) if dur is not None else dt
            gap = dt - step
            if gap > 0.0:
                bg = self._phases[-1][1]
                self._acc[bg] = self._acc.get(bg, 0.0) + gap * dev
            budget = step
            for sname, secs in (spans or {}).items():
                bucket = SPAN_BUCKETS.get(sname)
                if bucket is None or secs is None:
                    continue
                take = min(max(float(secs), 0.0), budget)
                if take <= 0.0:
                    continue
                self._acc[bucket] = self._acc.get(bucket, 0.0) + take * dev
                budget -= take
            if budget > 0.0:
                self._acc["goodput"] = self._acc.get("goodput", 0.0) \
                    + budget * dev
        return self

    def fold_split(self, weights: Dict[str, float],
                   now: Optional[float] = None):
        """Distribute the elapsed interval across buckets proportionally
        to ``weights`` — the decode engine's per-step attribution
        (``{"goodput": n_live, "queue_wait": waiting, "idle": spare}``).
        Weights summing to zero fall back to the background phase."""
        now = self._now(now)
        with self._lock:
            dt = now - self._cursor
            if dt <= 0.0:
                self._cursor = max(self._cursor, now)
                return self
            self._cursor = now
            dev = self._devices
            self._owned += dt * dev
            total = sum(max(float(w), 0.0) for w in weights.values())
            if total <= 0.0:
                bg = self._phases[-1][1]
                self._acc[bg] = self._acc.get(bg, 0.0) + dt * dev
                return self
            for bucket, w in weights.items():
                w = max(float(w), 0.0)
                if w:
                    self._acc[bucket] = self._acc.get(bucket, 0.0) \
                        + dt * dev * (w / total)
        return self

    # -- reading ------------------------------------------------------------ #
    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Advance to ``now`` and return the ledger as a plain dict:
        per-bucket device-seconds, owned total, goodput fraction, and
        the conservation error (≈0 by construction; asserted ≤1% by
        the chaos smokes)."""
        now = self._now(now)
        with self._lock:
            self._advance_locked(now)
            buckets = {b: self._acc.get(b, 0.0) for b in BUCKETS}
            owned = self._owned
        total = sum(buckets.values())
        return {
            "name": self.name,
            "devices": self._devices,
            "owned_s": owned,
            "buckets": buckets,
            "goodput_fraction": (buckets["goodput"] / owned) if owned
            else 0.0,
            "conservation_error": (abs(total - owned) / owned) if owned
            else 0.0,
        }

    def publish(self, recorder, now: Optional[float] = None
                ) -> Dict[str, Any]:
        """Snapshot and mirror onto ``recorder`` as ``goodput/*``
        gauges (every bucket, plus owned seconds and the fraction) so
        /metrics scrapes and the series store see the ledger without a
        step loop.  Gauges are written OUTSIDE this ledger's lock —
        recorder-lock/ledger-lock never nest in either order."""
        snap = self.snapshot(now)
        for b, v in snap["buckets"].items():
            recorder.gauge(f"goodput/{b}_s", v)
        recorder.gauge("goodput/owned_s", snap["owned_s"])
        recorder.gauge("goodput/fraction", snap["goodput_fraction"])
        recorder.gauge("goodput/devices", snap["devices"])
        return snap


__all__ = ["BUCKETS", "SPAN_BUCKETS", "GoodputLedger", "ledger_phase"]
