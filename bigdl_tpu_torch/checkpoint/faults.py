"""Crash-consistency fault injection for the checkpoint writer (≙
``bigdl_tpu/checkpoint/faults.py``).

Every byte the checkpoint package puts on disk goes through
:func:`guarded_write`, which can be armed — with :func:`set_plan` or the
``BIGDL_CKPT_FAULT`` environment variable (for subprocess kill tests) —
to kill the process (``os._exit``) at a byte offset.  That makes "a
checkpoint without a valid manifest does not exist" a tested property:
tests kill the writer mid-shard, mid-manifest or between the two, then
check that resume lands on the newest intact checkpoint.

Spec grammar (environment variable or :func:`set_plan` string):

    "<save>:bytes:<offset>"     kill after <offset> cumulative shard
                                payload bytes of the <save>-th checkpoint
                                save in this process (0-based)
    "<save>:manifest:<offset>"  kill <offset> bytes into that save's
                                manifest write
    "<save>:pre_manifest"       kill after all shards, before the
                                manifest (shards durable, commit absent)
    "sleep:<ms>"                no kill; delay every shard write by
                                <ms> (shows that writes stay off the
                                step loop)

The kill is ``os._exit(KILL_EXIT_CODE)``: no atexit handlers, no flush
beyond the bytes already written and fsync'ed.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

ENV_VAR = "BIGDL_CKPT_FAULT"
KILL_EXIT_CODE = 42


@dataclass
class FaultPlan:
    save_index: int = 0          # which checkpoint save to fault (0-based)
    point: str = "bytes"         # "bytes" | "manifest" | "pre_manifest"
    offset: int = 0              # byte offset within the faulted region
    sleep_s: float = 0.0         # per-shard-write delay (no kill)

    @staticmethod
    def parse(spec: str) -> "FaultPlan":
        parts = spec.strip().split(":")
        try:
            if parts[0] == "sleep":
                return FaultPlan(save_index=-1, point="sleep",
                                 sleep_s=float(parts[1]) / 1e3)
            save = int(parts[0])
            point = parts[1]
            if point == "pre_manifest":
                return FaultPlan(save_index=save, point=point)
            if point in ("bytes", "manifest"):
                return FaultPlan(save_index=save, point=point,
                                 offset=int(parts[2]))
        except (IndexError, ValueError) as e:
            raise ValueError(f"bad {ENV_VAR} spec {spec!r}") from e
        raise ValueError(f"bad {ENV_VAR} spec {spec!r}")


_lock = threading.Lock()
_plan: Optional[FaultPlan] = None
_env_loaded = False
_save_idx = -1            # index of the save currently in progress
_shard_bytes = 0          # cumulative shard payload bytes of this save


def set_plan(plan):
    """Arm (FaultPlan or spec string) or disarm (None) fault injection."""
    global _plan, _env_loaded
    with _lock:
        _plan = FaultPlan.parse(plan) if isinstance(plan, str) else plan
        _env_loaded = True      # explicit plan overrides the environment


def active_plan() -> Optional[FaultPlan]:
    global _plan, _env_loaded
    with _lock:
        if not _env_loaded:
            _env_loaded = True
            spec = os.environ.get(ENV_VAR)
            if spec:
                _plan = FaultPlan.parse(spec)
        return _plan


def begin_save() -> int:
    """Called by the writer at the start of each checkpoint save; returns
    the save index faults are matched against."""
    global _save_idx, _shard_bytes
    active_plan()
    with _lock:
        _save_idx += 1
        _shard_bytes = 0
        return _save_idx


def _die():
    # hard kill: simulate a preemption/power-cut mid-write.  os._exit
    # skips atexit, GC, and pending buffers — only fsync'ed bytes survive.
    os._exit(KILL_EXIT_CODE)


def on_pre_manifest():
    """Kill point between the last shard and the manifest write."""
    plan = active_plan()
    if (plan is not None and plan.point == "pre_manifest"
            and plan.save_index == _save_idx):
        _die()


def _kill_offset_within(kind: str, nbytes: int) -> Optional[int]:
    """Offset inside this write at which to kill, or None."""
    global _shard_bytes
    plan = active_plan()
    if plan is None:
        return None
    if plan.point == "sleep" and kind == "shard":
        time.sleep(plan.sleep_s)
        return None
    if plan.save_index != _save_idx:
        return None
    if plan.point == "bytes" and kind == "shard":
        start = _shard_bytes
        _shard_bytes += nbytes
        if start <= plan.offset < start + nbytes:
            return plan.offset - start
        return None
    if plan.point == "manifest" and kind == "manifest":
        if plan.offset < nbytes:
            return plan.offset
        return None
    if kind == "shard":
        _shard_bytes += nbytes
    return None


def guarded_write(path: str, data: bytes, kind: str = "shard",
                  recorder=None):
    """Write ``data`` to a FRESH file at ``path`` (O_EXCL) with fsync,
    honoring the active fault plan.  On a planned kill, exactly the
    prefix up to the configured offset is flushed to disk before
    ``os._exit`` — a maximally-torn file for resume to reject.

    Both fault planes apply: the byte-offset kill grammar above, and
    the ``BIGDL_FAULT`` sites ``ckpt.shard_write`` / ``ckpt.manifest``
    (:mod:`bigdl_tpu_torch.faults`), whose ``err:``/``delay:``/
    ``corrupt:`` modes model the transient failures the retry layer must
    survive — an err raises before any byte lands, so a retried write
    starts clean."""
    from .. import faults as _plane
    site = "ckpt.manifest" if "manifest" in kind else "ckpt.shard_write"
    data, plane_kill = _plane.filter_write(site, data, recorder)
    kill_at = _kill_offset_within(kind, len(data))
    if kill_at is None:
        kill_at = plane_kill
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o666)
    try:
        if kill_at is not None:
            os.write(fd, data[:kill_at])
            os.fsync(fd)
            _die()
        os.write(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)
