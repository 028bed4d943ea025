"""Collective-volume accounting (≙ ``bigdl_tpu/observability/
collectives.py``): bytes on the interconnect per step.

  * **Static**: computed on the host from gradient and parameter shapes,
    before and after 16-bit compression.  ``parallel.allreduce``,
    ``bucketer`` and ``zero`` report each exchange through
    :func:`account_collective`.
  * **Measured** (:class:`CollectiveTap`): the reference parses the
    collectives GSPMD put into a compiled step's HLO; the port places its
    collectives by hand, and the SPMD path (``parallel.tp_ops``,
    ``allreduce``, ``ring_attention``, ``spmd``, ``nn.moe``) issues them
    through this module's :func:`all_reduce`, :func:`all_gather_into_tensor`,
    :func:`reduce_scatter_tensor`, :func:`all_to_all_single` (the
    embedding exchange, ``embedding.sharded``) and
    :func:`batch_isend_irecv`, which
    record each call in every open tap, whatever thread issues it: op,
    bytes of the result, bytes on the wire, and the mesh axes of the
    group.  ``SpmdTrainer.account_collectives`` runs one step under it.

Ring costs per rank for S bytes over a ring of n:
  all-reduce       2*S*(n-1)/n     (reduce-scatter + all-gather)
  all-gather         S*(n-1)/n     (S = full gathered size)
  reduce-scatter     S*(n-1)/n     (S = full pre-scatter size)
  all-to-all         S*(n-1)/n
  collective-permute S             (point-to-point: the bytes sent)
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


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


# -- measured accounting: the collectives the port's code issues ---------- #
# the names of torch 2.13 where they exist (their predecessors warn
# there), else those of earlier releases; the arguments are the same
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor

_tap_lock = threading.Lock()
#: the open taps, process-wide: a backward's collectives run on the
#: autograd engine's thread (one per device on CUDA), not the caller's
_open_taps: List["CollectiveTap"] = []


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _ring(group) -> float:
    """``(n-1)/n`` of the group."""
    n = dist.get_world_size(group)
    return (n - 1) / n if n > 1 else 0.0


def _note(op: str, raw: float, wire: float, group) -> None:
    with _tap_lock:
        for tap in _open_taps:
            tap._note(op, raw, wire, group)


def all_reduce(tensor, op=dist.ReduceOp.SUM, group=None, **kw):
    """``dist.all_reduce``, recorded by the open taps: ``2 S (n-1)/n`` on
    the wire."""
    if _open_taps:
        s = _nbytes(tensor)
        _note("all-reduce", s, 2.0 * s * _ring(group), group)
    return dist.all_reduce(tensor, op=op, group=group, **kw)


def all_gather_into_tensor(out, src, group=None, **kw):
    """The all-gather into one tensor, recorded: ``S (n-1)/n``, S the
    gathered result."""
    if _open_taps:
        s = _nbytes(out)
        _note("all-gather", s, s * _ring(group), group)
    return _all_gather(out, src, group=group, **kw)


def reduce_scatter_tensor(out, src, group=None, **kw):
    """The reduce-scatter of one tensor, recorded: ``S (n-1)/n``, S the
    input before the scatter."""
    if _open_taps:
        _note("reduce-scatter", _nbytes(out),
              _nbytes(src) * _ring(group), group)
    return _reduce_scatter(out, src, group=group, **kw)


def all_to_all_single(output, input, group=None, **kw):
    """``dist.all_to_all_single`` (equal splits), recorded: ``S (n-1)/n``
    on the wire, S the bytes of the result (the embedding exchange's two
    legs)."""
    if _open_taps:
        s = _nbytes(output)
        _note("all-to-all", s, s * _ring(group), group)
    return dist.all_to_all_single(output, input, group=group, **kw)


def batch_isend_irecv(p2p_ops):
    """``dist.batch_isend_irecv``, recorded: its sends as one
    ``collective-permute`` of their bytes."""
    if _open_taps:
        sends = [p for p in p2p_ops if p.op is dist.isend]
        if sends:
            s = float(sum(_nbytes(p.tensor) for p in sends))
            _note("collective-permute", s, s, sends[0].group)
    return dist.batch_isend_irecv(p2p_ops)


class CollectiveTap:
    """Records the collectives the port issues through this module's
    :func:`all_reduce`, :func:`all_gather_into_tensor`,
    :func:`reduce_scatter_tensor`, :func:`all_to_all_single` and
    :func:`batch_isend_irecv` while
    open (``with CollectiveTap(labels) as tap:``), on any thread:
    ``tap.ops`` holds ``(op, result_bytes, wire_bytes, group label)`` in
    issue order.  ``labels`` maps a process group to its mesh axes' label
    (``Mesh.group_labels``); an unlabeled group reads ``"all"`` (the
    default group) or ``"unattributed"``."""

    def __init__(self, labels: Optional[Dict[object, str]] = None):
        self.labels = dict(labels or {})
        self.ops: List[Tuple[str, int, float, str]] = []

    def _note(self, op, raw, wire, group):
        if group is None:
            label = "all"
        else:
            label = self.labels.get(group, "unattributed")
        self.ops.append((op, int(raw), float(wire), label))

    def __enter__(self):
        with _tap_lock:
            _open_taps.append(self)
        return self

    def __exit__(self, *exc):
        with _tap_lock:
            _open_taps.remove(self)
        return False

    def by_op(self) -> Dict[str, float]:
        """``{op: wire bytes}`` over the recorded calls."""
        out: Dict[str, float] = {}
        for op, _, wire, _ in self.ops:
            out[op] = out.get(op, 0.0) + wire
        return out

    def by_group(self) -> Dict[str, Dict[str, float]]:
        """``{group label: {op: wire bytes, "wire_bytes": total}}``, the
        measured counterpart of the reference's ``hlo_group_breakdown``."""
        out: Dict[str, Dict[str, float]] = {}
        for op, _, wire, label in self.ops:
            d = out.setdefault(label, {"wire_bytes": 0.0})
            d[op] = d.get(op, 0.0) + wire
            d["wire_bytes"] += wire
        return out

    def publish(self, recorder) -> Dict[str, object]:
        """Set the step's ``collective/*`` and ``comm/group.*`` gauges from
        the recorded calls (the prefixes reset first, so that a step
        measured twice does not add up) and return ``{"ops": {op: wire
        bytes}, "groups": ..., "wire_bytes_per_step": total}``."""
        by_op, groups = self.by_op(), self.by_group()
        total = sum(by_op.values())
        raw = float(sum(r for _, r, _, _ in self.ops))
        if recorder is not None:
            reset_step(recorder)
            for op, wire in by_op.items():
                recorder.gauge(
                    f"collective/{op.replace('-', '_')}_wire_bytes", wire)
            recorder.gauge("collective/wire_bytes_per_step", total)
            recorder.gauge("collective/bytes_per_step", raw)
            for label, d in groups.items():
                for op, wire in d.items():
                    if op != "wire_bytes":
                        recorder.gauge(f"comm/group.{label}."
                                       f"{op.replace('-', '_')}_wire_bytes",
                                       wire)
                recorder.gauge(f"comm/group.{label}.wire_bytes_per_step",
                               d["wire_bytes"])
        return {"ops": by_op, "groups": groups,
                "wire_bytes_per_step": total, "bytes_per_step": raw}

