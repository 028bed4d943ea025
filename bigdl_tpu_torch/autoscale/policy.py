"""Hysteresis-damped scaling policy (≙ ``bigdl_tpu/autoscale/policy.py``):
signals in, sized decisions out.

  * **scale-up is fast**: a dual-window SLO burn alert, saturated decode
    occupancy, or deep per-replica backlog triggers an up decision on
    ONE tick, sized 1 (2 under surge), gated only by the short
    ``cooldown_up``;
  * **scale-down is slow**: it needs ``idle_ticks`` CONSECUTIVE calm
    observations (occupancy under the low-water mark, shallow queue,
    zero breaches) AND the long ``cooldown_down`` since the last scale
    in either direction, and always steps by exactly one replica.

Because ``cooldown_down >= cooldown_up`` and any scale resets the clock,
an up→down→up flap inside one ``cooldown_down`` window is impossible by
construction.  The band between the water marks is dead: it resets the
idle streak without creating pressure (the hysteresis).

:meth:`AutoscalePolicy.decide` only OBSERVES (it advances the idle
streak); cooldowns commit through :meth:`AutoscalePolicy.mark_scaled`,
which the controller calls after actuation succeeds, so a scale-up
blocked by an exhausted pool does not burn the cooldown.  Every
decision, holds included, carries a ``reason``.  Host arithmetic on an
injectable clock: the same signals give the reference's decisions.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

from .signals import Signals


class ScaleDecision:
    """One policy verdict: ``direction`` in {"up", "down", "hold"},
    ``delta`` replicas (0 for holds), and the ``reason`` it fired."""

    __slots__ = ("direction", "delta", "reason", "at", "signals")

    def __init__(self, direction: str, delta: int, reason: str,
                 at: float, signals: Signals):
        self.direction = direction
        self.delta = int(delta)
        self.reason = reason
        self.at = float(at)
        self.signals = signals

    @property
    def evidence(self):
        """The exact SLO-burn/occupancy/queue samples the signals
        snapshot folded — what a decision trace's ``slo.sample``
        child events cite (empty tuple when signals carry none)."""
        return getattr(self.signals, "evidence", ())

    def as_dict(self) -> Dict[str, Any]:
        return {"direction": self.direction, "delta": self.delta,
                "reason": self.reason, "at": self.at,
                "signals": self.signals.as_dict()}

    def __repr__(self):
        return (f"ScaleDecision({self.direction!r}, delta={self.delta},"
                f" reason={self.reason!r})")


class AutoscalePolicy:
    """Signals → :class:`ScaleDecision`, with hysteresis + cooldowns.

    Knobs (all per-instance, documented in docs/autoscaling.md):

      min_replicas / max_replicas   hard floors the policy never
                                    crosses
      occupancy_high / occupancy_low
                                    water marks on mean decode slot
                                    occupancy; the gap between them is
                                    the hysteresis dead band
      queue_high                    per-replica backlog (rows) that
                                    reads as pressure
      burn_surge                    worst ``burn_fast`` at or above
                                    this doubles the up step
      idle_ticks                    consecutive calm ``decide()`` calls
                                    required before a scale-down
      cooldown_up / cooldown_down   seconds since the last committed
                                    scale (either direction) before
                                    another up / down may fire;
                                    ``cooldown_down >= cooldown_up`` is
                                    enforced — it is what makes a flap
                                    inside one down-window impossible
      max_step                      upper bound on one decision's delta
    """

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 4,
                 occupancy_high: float = 0.85,
                 occupancy_low: float = 0.25,
                 queue_high: float = 8.0, burn_surge: float = 6.0,
                 idle_ticks: int = 3, cooldown_up: float = 15.0,
                 cooldown_down: float = 60.0, max_step: int = 2,
                 clock=time.monotonic):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas < min_replicas")
        if occupancy_low >= occupancy_high:
            raise ValueError("occupancy_low must sit below "
                             "occupancy_high (the gap is the "
                             "hysteresis)")
        if cooldown_down < cooldown_up:
            raise ValueError("cooldown_down must be >= cooldown_up "
                             "(the anti-flap invariant)")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.occupancy_high = float(occupancy_high)
        self.occupancy_low = float(occupancy_low)
        self.queue_high = float(queue_high)
        self.burn_surge = float(burn_surge)
        self.idle_ticks = int(idle_ticks)
        self.cooldown_up = float(cooldown_up)
        self.cooldown_down = float(cooldown_down)
        self.max_step = max(int(max_step), 1)
        self.clock = clock
        self.last_scaled_at: Optional[float] = None
        self.last_direction: Optional[str] = None
        self.idle_streak = 0

    # -- verdict ------------------------------------------------------------ #
    def _pressure(self, sig: Signals, n: int) -> str:
        """The first scale-up trigger that fires, or '' for none."""
        if sig.breached:
            return "slo_breach:" + ",".join(sig.breached)
        if sig.occupancy is not None \
                and sig.occupancy >= self.occupancy_high:
            return f"occupancy {sig.occupancy:.2f}"
        if sig.queue_depth is not None and n > 0 \
                and sig.queue_depth / n >= self.queue_high:
            return f"queue {sig.queue_depth:.0f} rows over {n}"
        return ""

    def _calm(self, sig: Signals, n: int) -> bool:
        """True when the tick argues for LESS capacity: informative
        data, zero breaches, occupancy under the low-water mark, and a
        per-replica backlog under half the pressure bar."""
        if sig.no_data or sig.breached:
            return False
        if sig.occupancy is None or sig.occupancy > self.occupancy_low:
            return False
        q = sig.queue_depth or 0.0
        return n > 0 and q / n < self.queue_high / 2.0

    def decide(self, sig: Signals, n_replicas: int,
               now: Optional[float] = None) -> ScaleDecision:
        """One observation.  Advances the idle streak; cooldowns are
        read here but only committed by :meth:`mark_scaled`."""
        if now is None:
            now = float(self.clock())
        n = int(n_replicas)
        since = (None if self.last_scaled_at is None
                 else now - self.last_scaled_at)

        if sig.no_data:
            self.idle_streak = 0
            return ScaleDecision("hold", 0, "no_data", now, sig)

        pressure = self._pressure(sig, n)
        if pressure:
            self.idle_streak = 0
            if n >= self.max_replicas:
                return ScaleDecision("hold", 0,
                                     f"at_max ({pressure})", now, sig)
            if since is not None and since < self.cooldown_up:
                return ScaleDecision(
                    "hold", 0, f"cooldown_up {since:.1f}s "
                    f"< {self.cooldown_up:.0f}s ({pressure})", now, sig)
            step = 1
            if sig.burn_fast is not None \
                    and sig.burn_fast >= self.burn_surge:
                step = 2
            delta = min(step, self.max_step, self.max_replicas - n)
            return ScaleDecision("up", delta, pressure, now, sig)

        if self._calm(sig, n):
            self.idle_streak += 1
            if n <= self.min_replicas:
                return ScaleDecision("hold", 0, "at_min", now, sig)
            if self.idle_streak < self.idle_ticks:
                return ScaleDecision(
                    "hold", 0, f"idle {self.idle_streak}/"
                    f"{self.idle_ticks}", now, sig)
            if since is not None and since < self.cooldown_down:
                return ScaleDecision(
                    "hold", 0, f"cooldown_down {since:.1f}s "
                    f"< {self.cooldown_down:.0f}s", now, sig)
            return ScaleDecision(
                "down", 1, f"idle x{self.idle_streak}, occupancy "
                f"{sig.occupancy:.2f}", now, sig)

        # dead band: neither pressure nor calm — the hysteresis gap
        self.idle_streak = 0
        return ScaleDecision("hold", 0, "steady", now, sig)

    def mark_scaled(self, direction: str, now: Optional[float] = None):
        """Commit a cooldown: the controller actually scaled.  A
        blocked actuation never calls this, so the next tick retries
        instead of waiting out a cooldown it never earned."""
        if now is None:
            now = float(self.clock())
        self.last_scaled_at = float(now)
        self.last_direction = direction
        self.idle_streak = 0
