"""bigdl_tpu_torch.elastic — survive preemption by shrinking, not dying
(≙ ``bigdl_tpu/elastic``).

v2 manifest checkpoints record the save-time mesh and restore reassembles
global arrays from whatever slice shards exist
(:mod:`bigdl_tpu_torch.checkpoint.reshard`), so the
:class:`ElasticSupervisor` can commit a final checkpoint on SIGTERM,
re-plan the largest mesh the surviving capacity supports
(:func:`plan_mesh`, shrinking ``dp`` first), resume through the reshard
path on rank processes started for that mesh, and regrow when capacity
returns — emitting ``elastic/*`` counters and health events through the
Recorder.
"""
from __future__ import annotations

from .plan import SHRINK_PRIORITY, plan_devices, plan_mesh, shrink_cost
from .supervisor import ElasticSupervisor, HangAbortError

__all__ = ["ElasticSupervisor", "HangAbortError", "SHRINK_PRIORITY",
           "plan_devices", "plan_mesh", "shrink_cost"]
