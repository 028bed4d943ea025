"""Mesh metadata, array fragments and their assembly (≙
``bigdl_tpu/checkpoint/reshard.py``), over the port's data-parallel
layouts.

A whole-tree shard holds global host arrays.  Under ``DistriOptimizer``'s
fsdp and zero1, and ``SpmdTrainer`` on a mesh of several ranks, no rank
holds every leaf whole, so each rank writes its own *fragments* — its
slices of each leaf with their global index ranges (:func:`_bounds`, on
any dims) — and :func:`assemble` merges the fragments of every rank into
global arrays, whatever layout and world size wrote them:

  * fsdp: a dim-0-sharded leaf's fragment is rank r's block of rows; a
    replicated leaf is written whole by rank 0;
  * zero1: a leaf sharded on dim 0 is the same; a leaf packed into a flat
    bucket contributes the range of its flattened elements that falls in
    rank r's chunk (``shape`` is then the flat length and ``reshape`` the
    leaf's shape; the reference's assembler ignores ``reshape`` and
    returns such a leaf flat);
  * ``SpmdTrainer``: a block of a leaf split on any dims over several
    mesh axes, written by the first of the ranks holding it.

A payload carries the tree's skeleton (leaves replaced by a placeholder)
in the order the reference flattens (sorted dict keys), so the two
packages' assemblers agree on leaf numbers.  Fragments hold owning copies.
Missing coverage raises: a rank's lost shards never restore as zeros.

:func:`mesh_info`, :func:`same_mesh`, :func:`describe_delta` and
:func:`explain_shape_delta` are the wording restore errors use.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..parallel.mesh import MODEL_AXES
from .manifest import CheckpointError

FRAGMENT_KEY = "__elastic_fragments__"
FRAGMENT_VERSION = 1
_LEAF = "__leaf__"      # skeleton placeholder (a string: stays a leaf)


# --------------------------------------------------------------------- #
# mesh metadata                                                          #
# --------------------------------------------------------------------- #
def mesh_info(mesh) -> Dict[str, Any]:
    """JSON-able description of a port :class:`~bigdl_tpu_torch.parallel
    .mesh.Mesh`: ordered axis names and sizes, device and process counts
    (one process a device)."""
    axes = [[str(a), int(mesh.shape[a])] for a in mesh.axis_names]
    n = int(np.prod([s for _, s in axes], dtype=np.int64))
    return {"axes": axes, "devices": n, "processes": n}


def mesh_axes(info: Optional[Dict]) -> Dict[str, int]:
    return {str(n): int(s) for n, s in (info or {}).get("axes", [])}


def same_mesh(a: Optional[Dict], b: Optional[Dict]) -> bool:
    """Identical ordered axes and process count; an unknown side (a v1
    manifest) never counts as different."""
    if a is None or b is None:
        return True
    return (list(map(tuple, a.get("axes", [])))
            == list(map(tuple, b.get("axes", [])))
            and a.get("processes") == b.get("processes"))


def fmt_mesh(info: Optional[Dict]) -> str:
    if info is None:
        return "<unknown mesh (v1 manifest)>"
    axes = "×".join(f"{n}={s}" for n, s in info.get("axes", []))
    return (f"{{{axes or 'no axes'}}} ({info.get('devices', '?')} devices, "
            f"{info.get('processes', '?')} process(es))")


def describe_delta(saved: Optional[Dict], target: Optional[Dict]) -> str:
    """Human-readable save→target mesh delta for logs and errors."""
    parts = [f"saved on {fmt_mesh(saved)}, restoring onto "
             f"{fmt_mesh(target)}"]
    if saved is not None and target is not None:
        sa, ta = mesh_axes(saved), mesh_axes(target)
        changed = [f"{n} {sa.get(n, 1)}→{ta.get(n, 1)}"
                   for n in dict.fromkeys(list(sa) + list(ta))
                   if sa.get(n, 1) != ta.get(n, 1)]
        if changed:
            parts.append("axis deltas: " + ", ".join(changed))
        if saved.get("devices") != target.get("devices"):
            parts.append(f"device count {saved.get('devices')}→"
                         f"{target.get('devices')}")
    return "; ".join(parts)


def explain_shape_delta(got, want, saved: Optional[Dict],
                        target: Optional[Dict]) -> Optional[str]:
    """If a restored leaf's shape is off by exactly a saved-mesh axis size
    or the device-count ratio in one dim, say that a per-rank (local) or
    per-shard array was saved where a global one belongs; else None."""
    got, want = tuple(got), tuple(want)
    if saved is None or len(got) != len(want):
        return None
    factors = {f"saved axis '{n}'": (s, n)
               for n, s in saved.get("axes", []) if s > 1}
    sd = saved.get("devices")
    td = None if target is None else target.get("devices")
    if sd and td and sd != td:
        hi, lo = max(sd, td), min(sd, td)
        if hi % lo == 0 and hi // lo > 1:
            factors[f"device-count ratio {sd}:{td}"] = (hi // lo, None)
    for dim, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        hits = [(why, f, axis) for why, (f, axis) in factors.items()
                if g * f == w or w * f == g]
        if not hits:
            continue
        f = hits[0][1]
        whys = " or ".join(why for why, _, _ in hits)
        model_hits = [a for _, _, a in hits if a in MODEL_AXES]
        local = ("the checkpoint looks like a per-host LOCAL array "
                 "saved where a global one belongs")
        slice_ = ("a model-parallel axis re-partitions tensors, so the "
                  "checkpoint looks like one shard's SLICE of the "
                  "weight saved where the global tensor belongs")
        detail = f"'{model_hits[0]}': {slice_}" if model_hits else local
        return f"dim {dim} is off by exactly {f} ({whys}): {detail}"
    return None


# --------------------------------------------------------------------- #
# trees of nested dicts, flattened in sorted-key order                   #
# --------------------------------------------------------------------- #
def _flatten(tree) -> Tuple[List[Any], Any]:
    if isinstance(tree, dict):
        leaves, skel = [], {}
        for k in sorted(tree):
            sub, skel[k] = _flatten(tree[k])
            leaves.extend(sub)
        return leaves, skel
    return [tree], _LEAF


def _unflatten(skeleton, leaves: Sequence):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(skeleton)


def _count_leaves(skeleton) -> int:
    if isinstance(skeleton, dict):
        return sum(_count_leaves(v) for v in skeleton.values())
    if isinstance(skeleton, (list, tuple)):
        return sum(_count_leaves(v) for v in skeleton)
    return 1


# --------------------------------------------------------------------- #
# fragment payloads                                                      #
# --------------------------------------------------------------------- #
class Pieces:
    """A leaf of which this writer holds only ``pieces``: ``(bounds,
    data)`` pairs, ``bounds`` a ``[[start, stop], ...]`` list over
    ``shape`` (the leaf's, or its flat length with ``reshape`` the leaf's
    shape)."""

    __slots__ = ("shape", "dtype", "pieces", "reshape")

    def __init__(self, shape, dtype, pieces, reshape=None):
        self.shape = [int(s) for s in shape]
        self.dtype = str(np.dtype(dtype))
        self.pieces = list(pieces)
        self.reshape = None if reshape is None else [int(s) for s in reshape]


def is_fragment_payload(payload) -> bool:
    return isinstance(payload, dict) and FRAGMENT_KEY in payload


def _bounds(index, shape) -> List[List[int]]:
    """``[[start, stop], ...]`` of a block given as a tuple of slices over
    a leaf of ``shape`` (the reference's ``_bounds``): the index range a
    fragment records on every dim, sharded over any axes."""
    out = []
    for sl, dim in zip(index, shape):
        start, stop, step = sl.indices(dim)
        if step != 1:
            raise CheckpointError(f"non-contiguous shard slice {sl!r}")
        out.append([int(start), int(stop)])
    return out


def split_fragments(tree, process_index: int = 0) -> Dict[str, Any]:
    """This writer's fragments of ``tree`` (nested dicts): a
    :class:`Pieces` leaf gives its pieces; a host array is replicated and
    written whole by process 0 only.  Arrays are copied (owning)."""
    leaves, skeleton = _flatten(tree)
    frags = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, Pieces):
            for bounds, data in leaf.pieces:
                f = {"leaf": i, "index": [[int(s), int(e)] for s, e in bounds],
                     "shape": list(leaf.shape), "dtype": leaf.dtype,
                     "data": np.array(data)}
                if leaf.reshape is not None:
                    f["reshape"] = list(leaf.reshape)
                frags.append(f)
        elif process_index == 0:
            a = np.array(leaf)
            frags.append({"leaf": i, "index": [[0, s] for s in a.shape],
                          "shape": list(a.shape), "dtype": str(a.dtype),
                          "data": a})
    return {FRAGMENT_KEY: FRAGMENT_VERSION, "skeleton": skeleton,
            "leaves": frags}


def assemble(payloads: List[Dict[str, Any]]):
    """Merge fragment payloads (any number of writers) into one tree of
    global numpy arrays; every element of every leaf must be covered."""
    if not payloads:
        raise CheckpointError("no fragment payloads to assemble")
    for p in payloads:
        if not is_fragment_payload(p):
            raise CheckpointError("not an elastic fragment payload")
        if p[FRAGMENT_KEY] > FRAGMENT_VERSION:
            raise CheckpointError(
                f"unsupported fragment version {p[FRAGMENT_KEY]}")
    skeleton = payloads[0]["skeleton"]
    n = _count_leaves(skeleton)
    by_leaf: List[List[Dict]] = [[] for _ in range(n)]
    for p in payloads:
        for f in p.get("leaves", []):
            i = int(f["leaf"])
            if not 0 <= i < n:
                raise CheckpointError(f"fragment for unknown leaf {i}")
            by_leaf[i].append(f)
    out: List[Optional[np.ndarray]] = [None] * n
    for i, frags in enumerate(by_leaf):
        if not frags:
            raise CheckpointError(
                f"leaf {i}: incomplete fragment coverage (entirely "
                "missing) — a writer's slice shards are absent")
        shape = tuple(int(s) for s in frags[0]["shape"])
        dtype = np.dtype(frags[0]["dtype"])
        reshape = frags[0].get("reshape")
        arr = np.zeros(shape, dtype)
        seen = np.zeros(shape, bool)
        for f in frags:
            if (tuple(int(s) for s in f["shape"]) != shape
                    or np.dtype(f["dtype"]) != dtype
                    or f.get("reshape") != reshape):
                raise CheckpointError(
                    f"leaf {i}: conflicting fragment metadata "
                    f"{f['shape']}/{f['dtype']} vs {shape}/{dtype}")
            sl = tuple(slice(int(s), int(e)) for s, e in f["index"])
            arr[sl] = np.asarray(f["data"]).reshape(arr[sl].shape)
            seen[sl] = True
        if not seen.all():
            raise CheckpointError(
                f"leaf {i}: incomplete fragment coverage "
                f"({int((~seen).sum())}/{seen.size} elements missing) "
                "— a writer's slice shards are absent")
        out[i] = arr if reshape is None else arr.reshape(reshape)
    return _unflatten(skeleton, out)


__all__ = ["FRAGMENT_KEY", "Pieces", "assemble", "describe_delta",
           "explain_shape_delta", "fmt_mesh", "is_fragment_payload",
           "mesh_info", "same_mesh", "split_fragments"]
