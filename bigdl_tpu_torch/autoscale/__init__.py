"""SLO-driven autoscaling on one shared pool (≙ ``bigdl_tpu/autoscale``).

The telemetry plane (SLO burn rates, queue depth, decode occupancy)
feeds a hysteresis-damped :class:`AutoscalePolicy`, whose sized
decisions an :class:`AutoscaleController` actuates against a
:class:`~bigdl_tpu_torch.serving.ReplicaSet` and the shared fleet
:class:`~bigdl_tpu_torch.fleet.DevicePool`: a co-scheduled training job
yields slots at a traffic peak and takes them back at the trough
through its ``capacity_fn`` seam.
"""
from __future__ import annotations

from .controller import AutoscaleController
from .policy import AutoscalePolicy, ScaleDecision
from .signals import Signals, read_signals

__all__ = ["AutoscaleController", "AutoscalePolicy", "ScaleDecision",
           "Signals", "read_signals"]
