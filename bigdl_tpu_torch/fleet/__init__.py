"""Many jobs, one device pool (≙ ``bigdl_tpu/fleet``).

The fleet layer gang-places N independent
:class:`~bigdl_tpu_torch.elastic.ElasticSupervisor` jobs onto disjoint
slots of one shared pool and keeps all of them alive through contention:
a higher-priority arrival shrinks or displaces lower-priority jobs
through their ``capacity_fn`` seam (drain → replan → resume),
completions hand capacity back (regrow), and a job whose ``min_axes``
floor fits surviving capacity is never killed by a fleet decision.  One
aggregated ``/metrics`` + ``/healthz`` + ``/goodput`` covers the pool.
See :mod:`.pool` for what the port does its own way.
"""
from __future__ import annotations

from .pool import (DevicePool, FleetAdmissionError, FleetJob,
                   FleetScheduler, PoolExhaustedError,
                   enable_shared_compile_cache, min_plan, plan_fleet)

__all__ = ["DevicePool", "FleetScheduler", "FleetJob",
           "FleetAdmissionError", "PoolExhaustedError", "plan_fleet",
           "min_plan", "enable_shared_compile_cache"]
