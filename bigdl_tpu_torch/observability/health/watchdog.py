"""Stall and straggler detection (≙
``bigdl_tpu/observability/health/watchdog.py``).

A wedged training loop is invisible to record-based telemetry: the step
that never finishes never emits.  :class:`StallWatchdog` is a daemon
thread polling ``Recorder.step_age()`` against a rolling budget: p99 of
the recent step durations × ``factor``, floored.  Crossing it flips the
``health/stalled`` gauge, emits one ``health_event`` (``condition=
"stall"``) an episode and accrues ``health/stall_seconds``; recovery
flips it back.  The trainers suspend the verdict around legitimate
between-step work (:meth:`StallWatchdog.suspended`: validation, a
checkpoint's blocking copy or a synchronous commit).
:meth:`StallWatchdog.set_escalation` arms a hang-abort: a flight dump and
a callback once an episode, a grace period past detection.

:func:`attribute_stragglers` groups step records carrying a ``host``
scalar and names the slowest host and its skew against the median.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional


def _p99(durs: List[float]) -> float:
    s = sorted(durs)
    return s[min(len(s) - 1, int(0.99 * (len(s) - 1) + 0.999999))]


def attribute_stragglers(records: List[Dict[str, Any]]
                         ) -> Optional[Dict[str, Any]]:
    """Per-host mean step time from records carrying a ``host`` scalar.

    Returns ``{"hosts": {host: mean_s}, "straggler": host,
    "skew": slowest/median}`` or None when records aren't per-host
    (single-process runs)."""
    by_host: Dict[int, List[float]] = {}
    for r in records:
        if r.get("type") != "step":
            continue
        host = (r.get("scalars") or {}).get("host")
        dur = r.get("dur")
        if host is None or not isinstance(dur, (int, float)):
            continue
        by_host.setdefault(int(host), []).append(float(dur))
    if len(by_host) < 2:
        return None
    means = {h: sum(v) / len(v) for h, v in by_host.items()}
    ranked = sorted(means.items(), key=lambda kv: kv[1])
    # lower-middle for even host counts: the slowest host must never be
    # its own baseline (a 2-host fleet would always report skew 1.0)
    median = ranked[(len(ranked) - 1) // 2][1]
    slowest, slowest_mean = ranked[-1]
    return {"hosts": means, "straggler": slowest,
            "skew": slowest_mean / max(median, 1e-12)}


class StallWatchdog:
    """Background budget check over ``recorder``'s liveness signal."""

    def __init__(self, recorder, factor: float = 5.0,
                 min_history: int = 8, floor_seconds: float = 2.0,
                 poll_interval: float = 0.25):
        self.recorder = recorder
        self.factor = float(factor)
        self.min_history = int(min_history)
        self.floor_seconds = float(floor_seconds)
        self.poll_interval = float(poll_interval)
        self._stop = threading.Event()
        self._stalled = False
        self._thread: Optional[threading.Thread] = None
        self._stall_started: Optional[float] = None
        self.stall_episodes = 0
        # check_once runs on the polling thread AND every /healthz
        # scrape thread: serialize the verdict state
        self._check_lock = threading.Lock()
        # a stopped watchdog (training finished) must not flag the
        # ever-growing idle step_age as a stall; fresh instances are
        # active so check_once works without a polling thread
        self._active = True
        # legitimate between-step work (validation, a sync checkpoint
        # commit) suspends the verdict; _resumed_at re-baselines the
        # idle age so the suspended interval can't trip the budget
        # right after resume
        self._suspend = 0
        self._resumed_at: Optional[float] = None
        # hang-abort escalation (set_escalation): grace past stall
        # detection, then flight dump + abort callback, once/episode
        self._escalate_after: Optional[float] = None
        self._esc_callback: Optional[Callable] = None
        self._esc_flight = None
        self._escalated = False         # this episode already escalated
        self._esc_fire = False          # check_once: fire outside lock

    # -- budget ------------------------------------------------------------ #
    def budget(self) -> Optional[float]:
        """Current stall budget in seconds: max(p99 × factor, floor);
        None until ``min_history`` completed steps exist."""
        durs = [r["dur"] for r in
                self.recorder.recent_records(rec_type="step")
                if isinstance(r.get("dur"), (int, float))]
        if len(durs) < self.min_history:
            return None
        return max(_p99(durs) * self.factor, self.floor_seconds)

    def set_escalation(self, grace: float, callback: Optional[Callable],
                       flight=None) -> "StallWatchdog":
        """Arm hang-abort escalation: ``grace`` seconds after a stall is
        DETECTED (i.e. budget + grace after the step wedged), dump a
        flight record via ``flight`` (a FlightRecorder, or None) and
        invoke ``callback()`` — once per stall episode; recovery
        re-arms.  ``grace=None`` disarms."""
        with self._check_lock:
            self._escalate_after = None if grace is None else float(grace)
            self._esc_callback = callback
            self._esc_flight = flight
            self._escalated = False
        return self

    def check_once(self) -> bool:
        """One poll; returns the current stalled verdict.  Public so
        tests (and /healthz handlers without a running thread) can
        evaluate the budget synchronously.  Thread-safe: the polling
        thread and concurrent /healthz scrapes share the verdict."""
        with self._check_lock:
            verdict = self._check_locked()
            fire = self._esc_fire
            self._esc_fire = False
        if fire:
            self._escalate()
        return verdict

    def suspended(self):
        """Context manager marking legitimate between-step work (an
        epoch-end validation pass, a synchronous checkpoint commit) so
        a LONG one doesn't read as a wedged step loop.  Re-entrant; the
        trainers wrap their validation/checkpoint blocks in it."""
        @contextlib.contextmanager
        def cm():
            with self._check_lock:
                self._suspend += 1
            try:
                yield
            finally:
                with self._check_lock:
                    self._suspend -= 1
                    self._resumed_at = time.time()
        return cm()

    def _check_locked(self) -> bool:
        rec = self.recorder
        if not self._active or self._suspend:
            self._clear_stall_locked()
            return False
        age = rec.step_age()
        # time spent suspended is not loop inactivity: measure from the
        # resume point until the next step record re-baselines properly
        if (age is not None and self._resumed_at is not None
                and not rec.step_in_flight()):
            age = min(age, time.time() - self._resumed_at)
        b = self.budget()
        if age is not None and b is not None and age > b:
            if not self._stalled:
                self._stalled = True
                self._stall_started = time.time()
                self.stall_episodes += 1
                rec.gauge("health/stalled", 1)
                ev = {"condition": "stall", "step": rec.last_step(),
                      "metric": "step_age_s", "value": age,
                      "threshold": b, "action": "record"}
                stragglers = attribute_stragglers(rec.recent_records())
                if stragglers is not None:
                    ev["straggler"] = stragglers["straggler"]
                    ev["skew"] = stragglers["skew"]
                rec.emit_record("health_event", **ev)
                rec.inc("health/events")
                rec.inc("health/stall")
                print(f"[health] stall: step age {age:.2f}s exceeds "
                      f"budget {b:.2f}s (p99×{self.factor:g})"
                      + (f"; straggler host {ev['straggler']} "
                         f"({ev['skew']:.2f}x median)"
                         if "straggler" in ev else ""), flush=True)
        elif self._stalled:
            self._clear_stall_locked()
        if (self._stalled and self._escalate_after is not None
                and not self._escalated
                and self._stall_started is not None
                and time.time() - self._stall_started
                >= self._escalate_after):
            # mark under the lock (one escalation per episode even with
            # concurrent scrapes), FIRE outside it — the flight dump
            # does real IO and the callback is arbitrary caller code
            self._escalated = True
            self._esc_fire = True
        return self._stalled

    def _escalate(self):
        """The hang-abort action (called OFF the verdict lock): flight
        dump + health event + abort callback.  A failing dump must not
        eat the abort — the callback is the part that un-wedges."""
        rec = self.recorder
        age = rec.step_age()
        rec.inc("health/hang_aborts")
        rec.inc("health/events")
        rec.emit_record("health_event", condition="hang_abort",
                        step=rec.last_step(), metric="step_age_s",
                        value=age, threshold=self._escalate_after,
                        action="abort")
        print(f"[health] hang-abort: stalled past the "
              f"{self._escalate_after:g}s escalation grace (step age "
              f"{age if age is None else round(age, 2)}s); dumping "
              "flight record and invoking the abort callback",
              flush=True)
        if self._esc_flight is not None:
            try:
                self._esc_flight.dump("hang_abort",
                                      extra={"step_age_s": age})
            except Exception as e:
                print(f"[health] hang-abort flight dump failed: {e!r}",
                      flush=True)
        if self._esc_callback is not None:
            try:
                self._esc_callback()
            except Exception as e:
                print(f"[health] hang-abort callback failed: {e!r}",
                      flush=True)

    def _clear_stall_locked(self):
        # *_locked: every caller holds self._check_lock (GL003)
        self._escalated = False     # recovery re-arms the escalation
        if not self._stalled:
            return
        self._stalled = False
        self.recorder.gauge("health/stalled", 0)
        if self._stall_started is not None:
            self.recorder.inc("health/stall_seconds",
                              time.time() - self._stall_started)
            self._stall_started = None

    @property
    def stalled(self) -> bool:
        return self._stalled

    # -- thread lifecycle --------------------------------------------------- #
    def start(self) -> "StallWatchdog":
        # under the lock (GL003): _active and _thread are shared with
        # stop() and the /healthz scrape path; starting the thread
        # while holding it is safe — _run only needs the lock inside
        # check_once, after its first poll sleep
        with self._check_lock:
            self._active = True
            # re-baseline idle age from the moment of arming: with a
            # shared recorder the last step record may predate a long
            # stopped interval (the elastic supervisor's teardown/
            # backoff/rebuild gap between segments), and that gap is
            # not loop inactivity
            self._resumed_at = time.time()
            if self._thread is None or not self._thread.is_alive():
                # a FRESH event per poller thread: reusing one event
                # means a start() racing stop()'s join window could
                # clear the flag before the old thread observed it —
                # leaking a second poller forever.  Each thread only
                # ever watches its own event
                self._stop = threading.Event()
                self._thread = threading.Thread(target=self._run,
                                                args=(self._stop,),
                                                daemon=True,
                                                name="health-watchdog")
                self._thread.start()
        return self

    def _run(self, stop_ev: threading.Event):
        while not stop_ev.wait(self.poll_interval):
            try:
                self.check_once()
            except Exception as e:   # the watchdog must never die silently
                print(f"[health] watchdog check failed: {e!r}", flush=True)

    def stop(self):
        """Stop polling AND deactivate: a finished (or paused) loop is
        not a stalled one, so subsequent direct check_once calls — e.g.
        /healthz scrapes after training completed — report healthy."""
        with self._check_lock:
            self._stop.set()        # the CURRENT thread's event
            t = self._thread
            self._thread = None
        if t is not None:
            # join OUTSIDE the lock: the polling thread takes it in
            # check_once, and joining while holding it would deadlock
            t.join(timeout=5.0)
            if t.is_alive():        # never silent: a leaked poller is
                print("[health] watchdog thread did not stop within "
                      "5s", flush=True)
        with self._check_lock:
            self._active = False
            self._clear_stall_locked()
