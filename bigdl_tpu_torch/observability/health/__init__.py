"""The training-health layer (≙ ``bigdl_tpu/observability/health``):

  * :class:`HealthMonitor` (:mod:`.sentinels`) — sentinels over each step
    record (NaN/Inf in loss or gradients, loss spike, gradient explosion)
    with the ``warn`` / ``record`` / ``raise`` / ``rollback`` policies;
  * :class:`StallWatchdog` (:mod:`.watchdog`) — flags a step past a
    rolling p99 × k budget; :func:`attribute_stragglers`;
  * :class:`FlightRecorder` (:mod:`.flight`) — dumps the Recorder's ring
    of recent records on divergence, unhandled exception or SIGTERM;
    :func:`read_flight` reads a dump back.

``/healthz`` of the introspection server (``observability.http``,
``serve_metrics``) reads the watchdog's and the monitor's verdicts.
"""
from __future__ import annotations

from .flight import FlightRecorder, read_flight
from .sentinels import DivergenceError, HealthMonitor
from .watchdog import StallWatchdog, attribute_stragglers

__all__ = ["DivergenceError", "FlightRecorder", "HealthMonitor",
           "StallWatchdog", "attribute_stragglers", "read_flight"]
