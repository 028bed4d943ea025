"""Fault-tolerant async checkpointing (≙ ``bigdl_tpu/checkpoint``).

  * **async snapshot pipeline** — the step loop blocks only for the
    device→host copy (``checkpoint.blocking`` span, :func:`host_snapshot`);
    a background writer (:class:`AsyncCheckpointWriter`) serializes
    sharded, CRC32C-verified files off the critical path
  * **atomic commit** — a per-checkpoint ``MANIFEST.json`` (shards,
    checksums, step/epoch metadata) written last through
    ``os.replace``: a checkpoint without a valid manifest does not exist
    (:mod:`.manifest`)
  * **retention and GC** — keep-last-N plus keep-every-M-epochs
  * **preemption** — SIGTERM finishes the in-flight write, commits a
    final checkpoint and stops cleanly (:class:`PreemptionHandler`)
  * **auto-resume** — scan manifests, verify CRCs, fall back to the
    newest intact checkpoint when the latest is torn
    (:meth:`CheckpointManager.restore_latest`)
  * **fault injection** — :mod:`.faults` kills the writer at byte offsets
  * **fragments** — ``DistriOptimizer``'s fsdp and zero1 ranks write
    their own slices and :mod:`.reshard` assembles them at restore, onto
    any layout and world size

The files are the reference's: each package restores the other's
checkpoints.  Wired into ``optim.Optimizer.set_checkpoint``.
"""
from __future__ import annotations

from . import faults, reshard
from .manager import CheckpointManager, host_snapshot
from .manifest import (CheckpointError, Manifest, Shard, read_manifest,
                       scan, verify)
from .preemption import PreemptionHandler
from .writer import AsyncCheckpointWriter

__all__ = [
    "AsyncCheckpointWriter", "CheckpointError", "CheckpointManager",
    "Manifest", "PreemptionHandler", "Shard", "faults", "host_snapshot",
    "read_manifest", "reshard", "scan", "verify",
]
