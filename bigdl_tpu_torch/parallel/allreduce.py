"""Gradient exchange over ``torch.distributed`` (≙
``bigdl_tpu/parallel/allreduce.py``).

The reference's collectives are XLA's inside ``shard_map``; here each is
an explicit ``torch.distributed`` call on the mesh's process group, so
that the reference's choices stay visible: the dim-0 mask, the 1/n mean
and the 16-bit wire.

  all-reduce            -> ``all_reduce`` (replicated params, dp)
  partitioned PS        -> ``reduce_scatter`` + ``all_gather`` (fsdp:
                           params and optimizer state sharded on dim 0)
  fp16/bf16 compression -> each leaf divided by n in fp32, cast to
                           16 bits, summed, cast back to its dtype (the
                           mean travels, so a 16-bit sum of n shards
                           cannot overflow; this is not DDP's
                           ``fp16_compress_hook``, which casts first and
                           divides after)

Trees are the port's nested dicts; their leaves are taken in the
reference's flatten order, sorted keys at every level
(:func:`tree_leaves`), so that bucket plans, shard layouts and masks list
the leaves as the reference's do.
"""
from __future__ import annotations

import logging
from typing import List, Optional

import torch
import torch.distributed as dist

from ..observability import collectives as _acct

log = logging.getLogger(__name__)

GROUP = "dp"        # the parallelism group the collectives account to

_CAST = {"fp16": torch.float16, "float16": torch.float16,
         "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}

# the names of torch 2.13 where they exist (their predecessors warn
# there), else those of earlier releases; the arguments are the same
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _is_node(x) -> bool:
    return isinstance(x, dict)


def tree_leaves(tree) -> List:
    """The leaves of a nested dict in ``jax.tree_util`` order: keys sorted
    at every level."""
    if not _is_node(tree):
        return [tree]
    out = []
    for k in sorted(tree):
        out.extend(tree_leaves(tree[k]))
    return out


def tree_paths(tree, prefix="") -> List[str]:
    """``"a/b"`` paths of :func:`tree_leaves`'s leaves."""
    if not _is_node(tree):
        return [prefix]
    out = []
    for k in sorted(tree):
        out.extend(tree_paths(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure over ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if _is_node(t):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def tree_map(fn, *trees):
    """``fn`` over the leaves of same-structure trees."""
    if _is_node(trees[0]):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _contiguous(g):
    return g if g.is_contiguous() else g.contiguous()


def _group(mesh):
    if mesh is None:
        from .mesh import get_mesh
        mesh = get_mesh()
    return mesh.group, mesh.shape["dp"]


def mean_leaf(g, n: int, group, compress: Optional[str] = None):
    """One leaf averaged over the group.  Uncompressed: an ``all_reduce``
    then ÷ n.  ``compress``: ``(g.float() / n)`` cast to 16 bits, summed,
    cast back to g's dtype."""
    cast_to = _CAST.get(compress)
    if cast_to is None:
        t = _contiguous(g)
        dist.all_reduce(t, group=group)
        return t / n
    t = (g.float() / n).to(cast_to)
    dist.all_reduce(t, group=group)
    return t.to(g.dtype)


def allreduce_gradients(grads, mesh=None, compress: Optional[str] = None,
                        recorder=None):
    """Mean of every gradient leaf over the mesh's dp ranks, one
    ``all_reduce`` a leaf, optionally 16-bit on the wire.  Accounts the
    ring all-reduce volume (raw and on the wire) to ``recorder``."""
    pg, n = _group(mesh)
    leaves = tree_leaves(grads)
    raw = _acct.tree_bytes(leaves)
    wire_item = _acct.compressed_itemsize(compress)
    wire = _acct.tree_bytes(leaves, wire_itemsize=wire_item) \
        if wire_item else raw
    _acct.account_collective("allreduce", _acct.ring_allreduce_bytes(raw, n),
                             _acct.ring_allreduce_bytes(wire, n),
                             recorder, GROUP)
    return tree_map(lambda g: mean_leaf(g, n, pg, compress), grads)


def _report_dense_fallback(counter, names, op, recorder):
    """Leaves left unsharded bump a ``comm/*`` counter and name
    themselves in a debug log: coverage is observable, not silent."""
    if not names:
        return
    if recorder is not None:
        recorder.inc(counter, len(names))
    log.debug("%s dense fallback for %d leaves (dim 0 not divisible by "
              "the axis, or masked unsharded): %s", op, len(names),
              ", ".join(names))


def reduce_scatter_leaf(g, n: int, group):
    """The sum of ``g`` over the group, this rank's dim-0 block of it."""
    g = _contiguous(g)
    out = torch.empty((g.shape[0] // n,) + tuple(g.shape[1:]),
                      dtype=g.dtype, device=g.device)
    _reduce_scatter(out, g, group=group)
    return out


def all_gather_leaf(shard, n: int, group, out=None):
    """The dim-0 concatenation of every rank's ``shard`` (into ``out``
    when given)."""
    if out is None:
        out = torch.empty((shard.shape[0] * n,) + tuple(shard.shape[1:]),
                          dtype=shard.dtype, device=shard.device)
    _all_gather(out, _contiguous(shard), group=group)
    return out


def reduce_scatter_gradients(grads, mesh, mask, recorder=None):
    """Each rank keeps its dim-0 block of the mean of every sharded
    gradient leaf (``reduce_scatter``, then ÷ n): the fsdp half of the
    partitioned parameter server.  ``mask`` (a tree of bools,
    :func:`shardable_mask_dim0`) marks the sharded leaves; the other
    leaves are all-reduced."""
    pg, n = _group(mesh)
    rs_bytes = ar_bytes = 0
    dense = []

    def rs(path, g, s):
        nonlocal rs_bytes, ar_bytes
        if not s:
            ar_bytes += _acct.leaf_bytes(g)
            dense.append(path)
            return mean_leaf(g, n, pg)
        rs_bytes += _acct.leaf_bytes(g)
        return reduce_scatter_leaf(g, n, pg) / n

    leaves = [rs(p, g, s) for p, g, s in zip(
        tree_paths(grads), tree_leaves(grads), tree_leaves(mask))]
    _report_dense_fallback("comm/unsharded_leaves", dense,
                           "reduce_scatter_gradients", recorder)
    if rs_bytes:
        v = _acct.ring_gather_bytes(rs_bytes, n)
        _acct.account_collective("reduce_scatter", v, v, recorder, GROUP)
    if ar_bytes:
        v = _acct.ring_allreduce_bytes(ar_bytes, n)
        _acct.account_collective("allreduce", v, v, recorder, GROUP)
    return tree_unflatten(grads, leaves)


def allgather_params(params, mesh, mask, recorder=None):
    """Full parameters from dim-0 shards (the getWeights fetch).  ``mask``
    marks the sharded leaves (a replicated leaf is returned as it is)."""
    pg, n = _group(mesh)
    ag_bytes = 0
    skipped = []

    def ag(path, p, s):
        nonlocal ag_bytes
        if not s:
            skipped.append(path)
            return p
        ag_bytes += _acct.leaf_bytes(p) * n
        return all_gather_leaf(p.detach(), n, pg)

    leaves = [ag(p, x, s) for p, x, s in zip(
        tree_paths(params), tree_leaves(params), tree_leaves(mask))]
    _report_dense_fallback("comm/ungathered_leaves", skipped,
                           "allgather_params", recorder)
    if ag_bytes:
        v = _acct.ring_gather_bytes(ag_bytes, n)
        _acct.account_collective("allgather", v, v, recorder, GROUP)
    return tree_unflatten(params, leaves)


def shardable_mask_dim0(tree, n: int):
    """A tree of bools beside ``tree``: True where a leaf's dim 0 is
    divisible by ``n`` (those leaves are dim-0 sharded for fsdp; the rest
    stay replicated).  From global shapes."""
    return tree_map(lambda p: p.ndim > 0 and p.shape[0] % n == 0, tree)
