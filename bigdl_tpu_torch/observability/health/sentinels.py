"""Numeric-health sentinels: NaN/Inf, loss spikes, gradient explosions
(≙ ``bigdl_tpu/observability/health/sentinels.py``).

The detection is split:

  device side   ``optim.optimizer.health_scalars`` computes the gradient,
                parameter and update norms and a non-finite gradient
                element count inside the step; they reach the host in the
                same step record as the loss, one sync a step in all.
  host side     :class:`HealthMonitor` inspects each completed step record
                and trips conditions:

                  ``non_finite_loss``   loss is NaN/Inf
                  ``non_finite_grads``  grad_norm NaN/Inf, or the
                                        in-step count > 0
                  ``loss_spike``        |loss − EWMA| > z·σ (EWMA mean and
                                        variance, after a warmup)
                  ``grad_explosion``    grad_norm above an absolute
                                        limit, or > factor × its EWMA

Every tripped condition becomes a ``health_event`` record (ring, sinks,
``health/events`` counter).  The policy decides what follows: ``warn``
prints, ``record`` only records, ``raise`` dumps a flight record and
raises :class:`DivergenceError`, and ``rollback`` raises it for the
training loop, which restores the last committed checkpoint
(``Optimizer.set_health``).  ``loss_spike`` is advisory by default; pass
``fatal_conditions`` to promote it.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence

POLICIES = ("warn", "record", "raise", "rollback")

_DEFAULT_FATAL = ("non_finite_loss", "non_finite_grads", "grad_explosion")


class DivergenceError(RuntimeError):
    """Raised by :class:`HealthMonitor` under ``raise``/``rollback``
    policy; carries the tripped events."""

    def __init__(self, events: List[Dict[str, Any]]):
        self.events = list(events)
        conds = ", ".join(f"{e['condition']}@step {e.get('step')}"
                          for e in self.events)
        super().__init__(f"training diverged: {conds}")


class HealthMonitor:
    """Checks step records; owns the policy response.

    ``flight``: an optional
    :class:`~bigdl_tpu_torch.observability.health.flight.FlightRecorder` —
    fatal events dump before the error propagates, so the artifact
    exists even when ``rollback`` swallows the exception.
    """

    def __init__(self, policy: str = "warn", recorder=None, flight=None,
                 spike_zscore: float = 10.0, warmup_steps: int = 20,
                 ewma_alpha: float = 0.05,
                 grad_norm_limit: Optional[float] = None,
                 grad_explosion_factor: Optional[float] = 100.0,
                 fatal_conditions: Sequence[str] = _DEFAULT_FATAL):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        self.policy = policy
        self.recorder = recorder
        self.flight = flight
        self.spike_zscore = float(spike_zscore)
        self.warmup_steps = int(warmup_steps)
        self.ewma_alpha = float(ewma_alpha)
        self.grad_norm_limit = grad_norm_limit
        self.grad_explosion_factor = grad_explosion_factor
        self.fatal_conditions = tuple(fatal_conditions)
        self.events: List[Dict[str, Any]] = []
        self.rollbacks = 0            # incremented by the training loop
        self._recovered_upto = 0      # events before this index were
                                      # resolved by a rollback
        # EWMA state (loss mean/var, grad-norm mean), warmup-gated
        self._n = 0
        self._loss_mean: Optional[float] = None
        self._loss_var = 0.0
        self._gn_mean: Optional[float] = None

    # -- checks ----------------------------------------------------------- #
    @staticmethod
    def _num(v) -> Optional[float]:
        return float(v) if isinstance(v, (int, float)) else None

    def check_record(self, record: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Inspect one step record; returns tripped events (possibly
        raising per policy).  Non-step records pass through untouched."""
        if not isinstance(record, dict) or record.get("type") != "step":
            return []
        scalars = record.get("scalars") or {}
        step = record.get("step")
        events: List[Dict[str, Any]] = []

        def trip(condition, metric, value, threshold=None):
            events.append({
                "type": "health_event", "condition": condition,
                "step": step, "metric": metric,
                "value": None if value is None else float(value),
                "threshold": threshold, "action": self.policy,
                "time": time.time(),
            })

        loss = self._num(scalars.get("loss"))
        if loss is not None and not math.isfinite(loss):
            trip("non_finite_loss", "loss", loss)

        gn = self._num(scalars.get("grad_norm"))
        nonfinite = self._num(scalars.get("nonfinite_grads"))
        if (gn is not None and not math.isfinite(gn)) or \
                (nonfinite is not None and nonfinite > 0):
            trip("non_finite_grads",
                 "nonfinite_grads" if nonfinite else "grad_norm",
                 nonfinite if nonfinite else gn)

        if loss is not None and math.isfinite(loss):
            if (self._n >= self.warmup_steps and self._loss_mean is not None
                    and self._loss_var > 0):
                sd = math.sqrt(self._loss_var)
                z = abs(loss - self._loss_mean) / max(sd, 1e-12)
                if z > self.spike_zscore:
                    trip("loss_spike", "loss_zscore", z, self.spike_zscore)
            a = self.ewma_alpha
            if self._loss_mean is None:
                self._loss_mean = loss
            else:
                d = loss - self._loss_mean
                self._loss_mean += a * d
                # EWMA variance (West 1979 incremental form)
                self._loss_var = (1 - a) * (self._loss_var + a * d * d)

        if gn is not None and math.isfinite(gn):
            if self.grad_norm_limit is not None and gn > self.grad_norm_limit:
                trip("grad_explosion", "grad_norm", gn, self.grad_norm_limit)
            elif (self.grad_explosion_factor is not None
                  and self._n >= self.warmup_steps
                  and self._gn_mean is not None and self._gn_mean > 0
                  and gn > self.grad_explosion_factor * self._gn_mean):
                trip("grad_explosion", "grad_norm", gn,
                     self.grad_explosion_factor * self._gn_mean)
            a = self.ewma_alpha
            self._gn_mean = gn if self._gn_mean is None else \
                self._gn_mean + a * (gn - self._gn_mean)

        self._n += 1
        if events:
            self._handle(events)
        return events

    # -- policy ----------------------------------------------------------- #
    def _handle(self, events: List[Dict[str, Any]]):
        self.events.extend(events)
        rec = self.recorder
        if rec is not None:
            for ev in events:
                rec.inc("health/events")
                rec.inc(f"health/{ev['condition']}")
                rec.gauge("health/last_event_step",
                          -1 if ev.get("step") is None else ev["step"])
                rec.emit_record("health_event",
                                **{k: v for k, v in ev.items()
                                   if k != "type"})
        fatal = [e for e in events
                 if e["condition"] in self.fatal_conditions]
        if self.policy == "warn" or (self.policy != "record" and not fatal):
            for ev in events:
                print(f"[health] {ev['condition']} at step {ev['step']}: "
                      f"{ev['metric']}={ev['value']}"
                      + (f" (threshold {ev['threshold']:.4g})"
                         if ev.get("threshold") is not None else ""),
                      flush=True)
        if fatal and self.policy in ("raise", "rollback"):
            err = DivergenceError(fatal)
            if self.flight is not None:
                try:
                    # keyed on the error so the chained excepthook won't
                    # dump the same divergence a second time at exit
                    self.flight.dump("divergence", {"events": fatal},
                                     key=id(err))
                except Exception as e:   # dump failure must not mask
                    print(f"[health] flight dump failed: {e!r}", flush=True)
            raise err

    def reset_statistics(self):
        """Forget the EWMA baselines (kept events stay).  Called after a
        rollback: the restored loss may legitimately sit far from the
        diverged run's statistics, and a stale baseline would re-trip
        the spike sentinel on the first healthy step."""
        self._n = 0
        self._loss_mean = None
        self._loss_var = 0.0
        self._gn_mean = None

    def mark_recovered(self):
        """A rollback restored good state: prior events no longer count
        against :attr:`healthy` (they stay in ``events`` for the log)."""
        self._recovered_upto = len(self.events)

    @property
    def healthy(self) -> bool:
        """False once a fatal condition tripped without a subsequent
        recovery (rollback)."""
        return not any(e["condition"] in self.fatal_conditions
                       for e in self.events[self._recovered_upto:])
