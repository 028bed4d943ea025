"""ZeRO-1 sharded weight update for the data-parallel path (≙
``bigdl_tpu/parallel/zero.py``; arXiv:2004.13336).

Plain dp keeps parameters and optimizer state replicated and all-reduces
the whole gradient.  Under zero1 each rank reduce-scatters the gradient,
updates only its 1/n of the parameters with its 1/n of the optimizer
state, and all-gathers the updated parameters.  :class:`Zero1Layout` is
the reference's plan, over its flatten order (sorted keys):

  * a leaf whose dim 0 divides n is exchanged and updated as dim-0
    blocks (``reduce_scatter`` / ``all_gather`` a leaf);
  * every other leaf is packed into padded flat buckets (by dtype, split
    at ``bucket_bytes``, zero-padded to a multiple of n), exchanged the
    same way, so that the whole optimizer state is 1/n.

The shard space is ``{"flat": {"00000": chunk, ...}, "leaves": {"00000":
block, ...}}``: a nested dict, so that the optimizer methods (and K4–K6's
leaf tables, when ``fused``) update its buffers as they update a param
dict.  Unlike the reference's global shard space sharded by specs, each
rank holds only its own shards (:class:`Zero1Optim`): its optimizer
state is initialized over them.  Elementwise methods are exact under
this re-partitioning; LARS/LAMB, whose trust ratios need whole-tensor
norms, are refused by ``DistriOptimizer``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..observability import collectives as _acct
from .allreduce import (_CAST, GROUP, _group, all_gather_leaf,
                        reduce_scatter_leaf, shardable_mask_dim0,
                        tree_leaves, tree_paths, tree_unflatten)


def _keyed(tensors):
    return {f"{i:05d}": t for i, t in enumerate(tensors)}


class Zero1Layout:
    """The shard-space plan for one params template over a dp axis of
    size ``n`` (host metadata from global shapes)."""

    def __init__(self, params_template, n: int,
                 bucket_bytes: Optional[int] = None):
        self.n = int(n)
        self.template = params_template
        flat = tree_leaves(params_template)
        paths = tree_paths(params_template)
        mask = tree_leaves(shardable_mask_dim0(params_template, self.n))
        self.n_leaves = len(flat)
        self.sharded_idx = [i for i, m in enumerate(mask) if m]
        flat_leaf_idx = [i for i, m in enumerate(mask) if not m]
        self.flat_names = [paths[i] for i in flat_leaf_idx]
        self.shapes = [tuple(leaf.shape) for leaf in flat]
        self.dtypes = [leaf.dtype for leaf in flat]
        groups = {}
        for i in flat_leaf_idx:
            groups.setdefault(flat[i].dtype, []).append(i)
        self.buckets = []       # (dtype, [leaf idx], [sizes], pad)
        for dt, idxs in groups.items():
            cur, cur_bytes = [], 0
            for i in idxs:
                nbytes = self._size(i) * dt.itemsize
                if cur and bucket_bytes and cur_bytes + nbytes > bucket_bytes:
                    self._close_bucket(dt, cur)
                    cur, cur_bytes = [], 0
                cur.append(i)
                cur_bytes += nbytes
            if cur:
                self._close_bucket(dt, cur)

    def _size(self, i):
        return math.prod(self.shapes[i]) if self.shapes[i] else 1

    def _close_bucket(self, dt, idxs):
        sizes = [self._size(i) for i in idxs]
        self.buckets.append((dt, list(idxs), sizes, (-sum(sizes)) % self.n))

    def _pack_bucket(self, leaves, bi):
        dt, idxs, sizes, pad = self.buckets[bi]
        vec = torch.cat([leaves[i].reshape(-1) for i in idxs]) \
            if len(idxs) > 1 else leaves[idxs[0]].reshape(-1)
        if pad:
            vec = torch.cat([vec, vec.new_zeros(pad)])
        return vec

    def _space(self, flat, leaves):
        return {"flat": _keyed(flat), "leaves": _keyed(leaves)}

    # -- shard-space construction --------------------------------------- #
    def local_shard(self, tree, rank: int):
        """Rank ``rank``'s 1/n of a replicated full tree, as new tensors
        (the update writes them in place)."""
        leaves = [leaf.detach() for leaf in tree_leaves(tree)]
        out_l = []
        for i in self.sharded_idx:
            rows = self.shapes[i][0] // self.n
            out_l.append(leaves[i][rank * rows:(rank + 1) * rows].clone())
        out_f = []
        for bi in range(len(self.buckets)):
            vec = self._pack_bucket(leaves, bi)
            chunk = vec.shape[0] // self.n
            out_f.append(vec[rank * chunk:(rank + 1) * chunk].clone())
        return self._space(out_f, out_l)

    # -- collectives ------------------------------------------------------ #
    def scatter_grads(self, grads, mesh=None, compress=None, recorder=None):
        """Full per-rank gradients -> this rank's shard space of their
        mean (``reduce_scatter`` a leaf and a bucket).  ``compress``:
        each is divided by n in fp32, cast to 16 bits, reduce-scattered
        and cast back."""
        pg, n = _group(mesh)
        cast_to = _CAST.get(compress)
        leaves = tree_leaves(grads)
        raw = wire = 0
        wire_item = _acct.compressed_itemsize(compress)

        def rs(x):
            nonlocal raw, wire
            raw += _acct.leaf_bytes(x)
            wire += _acct.leaf_bytes(x, wire_item)
            if cast_to is None:
                return reduce_scatter_leaf(x, n, pg) / n
            return reduce_scatter_leaf((x.float() / n).to(cast_to), n,
                                       pg).to(x.dtype)

        out_l = [rs(leaves[i]) for i in self.sharded_idx]
        out_f = [rs(self._pack_bucket(leaves, bi))
                 for bi in range(len(self.buckets))]
        _acct.account_collective("reduce_scatter",
                                 _acct.ring_gather_bytes(raw, n),
                                 _acct.ring_gather_bytes(wire, n),
                                 recorder, GROUP)
        return self._space(out_f, out_l)

    def gather_params(self, shard_space, mesh=None, out=None, recorder=None):
        """Updated shard-space params -> the full tree (``all_gather`` a
        leaf and a bucket).  ``out``, a full tree of contiguous tensors,
        is written in place and returned."""
        pg, n = _group(mesh)
        full = [None] * self.n_leaves
        dst = tree_leaves(out) if out is not None else [None] * self.n_leaves
        gathered = 0
        for k, i in enumerate(self.sharded_idx):
            full[i] = all_gather_leaf(shard_space["leaves"][f"{k:05d}"], n,
                                      pg, out=dst[i])
            gathered += _acct.leaf_bytes(full[i])
        for bi, (dt, idxs, sizes, pad) in enumerate(self.buckets):
            vec = all_gather_leaf(shard_space["flat"][f"{bi:05d}"], n, pg)
            gathered += _acct.leaf_bytes(vec)
            off = 0
            for i, sz in zip(idxs, sizes):
                piece = vec[off:off + sz].reshape(self.shapes[i])
                full[i] = piece if dst[i] is None else dst[i].copy_(piece)
                off += sz
        v = _acct.ring_gather_bytes(gathered, n)
        _acct.account_collective("allgather", v, v, recorder, GROUP)
        return out if out is not None else tree_unflatten(self.template,
                                                          full)

    # -- bookkeeping ------------------------------------------------------ #
    def opt_state_bytes_per_replica(self, opt_state) -> int:
        """This rank's optimizer-state bytes: its shards, and the scalars
        (the step counter) whole."""
        return sum(_acct.leaf_bytes(leaf) for leaf in tree_leaves(opt_state))

    def describe(self) -> str:
        nb = len(self.buckets)
        return (f"zero1: {len(self.sharded_idx)} dim0-sharded leaves, "
                f"{len(self.flat_names)} flat-bucketed leaves in {nb} "
                f"bucket{'s' if nb != 1 else ''} over n={self.n}")


class Zero1Optim:
    """The shard-space optimizer: :meth:`init_state` takes this rank's
    shards of the full parameters as the update's master copies
    (:attr:`params`) and the inner method's state over them;
    :meth:`update` applies the inner method to them and all-gathers the
    result into the full parameters."""

    def __init__(self, inner, layout: Zero1Layout, mesh, recorder=None):
        self.inner = inner
        self.layout = layout
        self.mesh = mesh
        self.recorder = recorder
        self.params = None

    def init_state(self, params):
        self.params = self.layout.local_shard(params, self.mesh.rank)
        return self.inner.init_state(self.params)

    def update(self, grads, params, state):
        """``grads``: this rank's shard space of the mean gradient;
        ``params``: the full replicated tree, written in place."""
        _, state = self.inner.update(grads, self.params, state)
        with torch.no_grad():
            self.layout.gather_params(self.params, self.mesh, out=params,
                                      recorder=self.recorder)
        return params, state

    def get_learning_rate(self, state):
        return self.inner.get_learning_rate(state)
