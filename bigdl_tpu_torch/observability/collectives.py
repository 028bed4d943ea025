"""Collective-volume accounting (≙ ``bigdl_tpu/observability/
collectives.py``, its static half): bytes on the interconnect per step,
computed on the host from gradient and parameter shapes, before and
after 16-bit compression.  ``parallel.allreduce``, ``bucketer`` and
``zero`` report each exchange through :func:`account_collective`.

The reference's measured half parses the collectives XLA inserted out of
a compiled step's HLO; the port issues its collectives by hand, so that
half has no counterpart here (NCCL accounting is ROADMAP queue A,
item 8).

Ring costs per rank for S bytes over a ring of n:
  all-reduce       2*S*(n-1)/n     (reduce-scatter + all-gather)
  all-gather         S*(n-1)/n     (S = full gathered size)
  reduce-scatter     S*(n-1)/n     (S = full pre-scatter size)
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def leaf_bytes(leaf, wire_itemsize: Optional[int] = None) -> int:
    """Bytes of one tensor leaf; ``wire_itemsize`` overrides the dtype
    width (compressed-on-the-wire accounting)."""
    shape = tuple(getattr(leaf, "shape", ()))
    n = math.prod(shape) if shape else 1
    if wire_itemsize is not None:
        return n * wire_itemsize
    dt = getattr(leaf, "dtype", None)
    return n * (dt.itemsize if isinstance(dt, torch.dtype) else 4)


def tree_bytes(leaves, wire_itemsize: Optional[int] = None,
               mask=None) -> int:
    """Total bytes of a list of leaves; ``mask`` (a list of bools beside
    them) restricts the sum to the True ones."""
    leaves = list(leaves)
    if mask is not None:
        leaves = [leaf for leaf, m in zip(leaves, mask) if m]
    return sum(leaf_bytes(leaf, wire_itemsize) for leaf in leaves)


def ring_allreduce_bytes(total_bytes: int, n: int) -> float:
    return 2.0 * total_bytes * (n - 1) / n if n > 1 else 0.0


def ring_gather_bytes(total_bytes: int, n: int) -> float:
    """all-gather OR reduce-scatter of a full-size tensor over a ring."""
    return float(total_bytes) * (n - 1) / n if n > 1 else 0.0


def compressed_itemsize(compress: Optional[str]) -> Optional[int]:
    """Wire bytes/element for an allreduce ``compress=`` mode."""
    if compress in ("fp16", "float16", "bf16", "bfloat16"):
        return 2
    return None


def account_collective(op: str, raw_bytes: float, wire_bytes: float,
                       recorder=None, group: Optional[str] = None):
    """Report one collective's static volume to ``recorder`` (nothing
    without one).  Gauges, accumulated over one step's exchanges (the
    caller resets the ``collective/`` and ``comm/group.`` prefixes at each
    step's start, :func:`reset_step`):

      ``collective/{op}_bytes``       raw (uncompressed) volume
      ``collective/{op}_wire_bytes``  on-the-wire (post-compression) volume
      ``collective/bytes_per_step``   raw volume of the step
      ``collective/wire_bytes_per_step``  wire volume of the step
      ``comm/group.{group}.{op}_bytes`` / ``..._wire_bytes`` /
      ``wire_bytes_per_step``         the same per parallelism group
    """
    if recorder is None:
        return
    adds = [(f"collective/{op}_bytes", raw_bytes),
            (f"collective/{op}_wire_bytes", wire_bytes),
            ("collective/bytes_per_step", raw_bytes),
            ("collective/wire_bytes_per_step", wire_bytes)]
    if group is not None:
        pre = f"comm/group.{group}."
        adds += [(pre + f"{op}_bytes", raw_bytes),
                 (pre + f"{op}_wire_bytes", wire_bytes),
                 (pre + "wire_bytes_per_step", wire_bytes)]
    for name, val in adds:
        recorder.gauge(name, recorder.gauge_value(name) + float(val))


def reset_step(recorder) -> None:
    """Zero the per-step ``collective/`` and ``comm/group.`` gauges."""
    if recorder is not None:
        recorder.reset_gauges("collective/")
        recorder.reset_gauges("comm/group.")
