"""Bucketed gradient exchange (≙ ``bigdl_tpu/parallel/bucketer.py``).

:class:`GradBucketer` packs gradient leaves into flat single-dtype
buckets of at most ``bucket_bytes`` (a leaf larger than that gets one of
its own) and exchanges each bucket with one collective, instead of one a
leaf.  The plan is the reference's: leaves in its flatten order (sorted
keys, :func:`~bigdl_tpu_torch.parallel.allreduce.tree_leaves`), packed
in backward-emission order (the reverse of that order, the reference's
default), so that bucket membership, and with it what a 16-bit wire
rounds together, is the same.  ``compress="fp16"|"bf16"`` sends the
1/n-scaled bucket in 16 bits and casts the sum back.  Uncompressed, the
bucketed exchange is elementwise the same sum as the per-leaf one.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch

from ..observability import collectives as _acct
from .allreduce import (GROUP, _group, mean_leaf, tree_leaves,
                        tree_unflatten)


class GradBucketer:
    """The bucket plan for one gradient-tree template, leaves packed in
    reverse flatten order."""

    def __init__(self, params_template, bucket_bytes: int = 4 << 20):
        leaves = tree_leaves(params_template)
        self.template = params_template
        self.n_leaves = len(leaves)
        self.shapes = [tuple(leaf.shape) for leaf in leaves]
        self.sizes = [math.prod(s) if s else 1 for s in self.shapes]
        self.dtypes = [leaf.dtype for leaf in leaves]
        self.bucket_bytes = int(bucket_bytes)
        self.buckets: List[List[int]] = []      # lists of leaf indices
        cur, cur_bytes, cur_dt = [], 0, None
        for i in reversed(range(self.n_leaves)):
            nbytes = self.sizes[i] * self.dtypes[i].itemsize
            if cur and (self.dtypes[i] != cur_dt
                        or cur_bytes + nbytes > self.bucket_bytes):
                self.buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
            cur_dt = self.dtypes[i]
        if cur:
            self.buckets.append(cur)

    def __len__(self):
        return len(self.buckets)

    def pack(self, grads) -> List[torch.Tensor]:
        """Gradient tree -> list of flat single-dtype bucket vectors."""
        leaves = tree_leaves(grads)
        return [torch.cat([leaves[i].reshape(-1) for i in bucket])
                if len(bucket) > 1 else leaves[bucket[0]].reshape(-1)
                for bucket in self.buckets]

    def unpack(self, vecs):
        """Inverse of :meth:`pack`: views into the bucket vectors."""
        leaves = [None] * self.n_leaves
        for bucket, vec in zip(self.buckets, vecs):
            off = 0
            for i in bucket:
                leaves[i] = vec[off:off + self.sizes[i]].reshape(
                    self.shapes[i]).to(self.dtypes[i])
                off += self.sizes[i]
        return tree_unflatten(self.template, leaves)

    def allreduce(self, grads, mesh=None, compress: Optional[str] = None,
                  recorder=None):
        """The mean of ``grads``, one all-reduce a bucket; accounts the
        raw and wire volume and the ``collective/buckets`` count to
        ``recorder``."""
        pg, n = _group(mesh)
        vecs = self.pack(grads)
        raw = sum(_acct.leaf_bytes(v) for v in vecs)
        wire_item = _acct.compressed_itemsize(compress)
        wire = raw if wire_item is None else sum(
            v.shape[0] * wire_item for v in vecs)
        _acct.account_collective("allreduce",
                                 _acct.ring_allreduce_bytes(raw, n),
                                 _acct.ring_allreduce_bytes(wire, n),
                                 recorder, GROUP)
        if recorder is not None:
            for name in ("collective/buckets", f"comm/group.{GROUP}.buckets"):
                recorder.gauge(name, recorder.gauge_value(name) + len(vecs))
        return self.unpack([mean_leaf(v, n, pg, compress) for v in vecs])
