"""Two-tower retrieval model over embedding-bag towers (≙
``bigdl_tpu/models/two_tower.py``).

A user tower and an item tower, each an embedding bag over an id table,
joined by a dot product and squashed to a click probability, trained
against ``BCECriterion`` on MovieLens ``(uid_list, mid_list, label)``
samples (:mod:`bigdl_tpu_torch.data.movielens`).  The towers
mean-combine their bags, so the ragged movie list (target and recent
history) folds into one item vector.  The bags are
:func:`~bigdl_tpu_torch.embedding.sharded.dense_bag`, whose gather and
combine add in a fixed order: a step repeats bit for bit on the card;
:class:`~bigdl_tpu_torch.embedding.ShardedEmbeddingBag` is the bitwise
drop-in when a table outgrows one device.
"""
from __future__ import annotations

import torch

from .._device import DeviceLike, resolve_device
from ..embedding.sharded import dense_bag
from ..nn.init import Xavier, init_tensor
from ..nn.module import Module


class TwoTower(Module):
    """``x = (uids (B, Lu), mids (B, Lm))`` int 1-based ids (0 = pad) ->
    ``sigmoid(<user_vec, item_vec>)`` of shape (B, 1), clipped to
    [1e-7, 1 - 1e-7].  Weights ``weight_user`` (n_users, n_output) and
    ``weight_item`` (n_items, n_output), Xavier draws from ``gen``."""

    def __init__(self, n_users: int, n_items: int, n_output: int = 16,
                 combiner: str = "mean", name=None, *,
                 gen: torch.Generator = None):
        super().__init__(name=name)
        self.n_users = int(n_users)
        self.n_items = int(n_items)
        self.n_output = int(n_output)
        self.combiner = combiner
        self.weight_user = torch.nn.Parameter(init_tensor(
            self, gen, (self.n_users, self.n_output), self.n_users,
            self.n_output, Xavier(), kind="weight_user"))
        self.weight_item = torch.nn.Parameter(init_tensor(
            self, gen, (self.n_items, self.n_output), self.n_items,
            self.n_output, Xavier(), kind="weight_item"))

    def apply(self, params, x, ctx):
        p = self.own(params)
        uids, mids = x
        u = dense_bag(p["weight_user"], uids, combiner=self.combiner)
        m = dense_bag(p["weight_item"], mids, combiner=self.combiner)
        logits = (u * m).sum(-1, keepdim=True)
        # the clip keeps BCE's log() finite at saturated predictions
        return torch.clamp(torch.sigmoid(logits), 1e-7, 1.0 - 1e-7)


def build(n_users: int, n_items: int, n_output: int = 16,
          combiner: str = "mean", *, device: DeviceLike = None,
          seed: int = 0) -> TwoTower:
    """Two-tower model sized for a rating table (ids are 1-based, so the
    tables hold ``n + 1`` rows and row 0, the padding, is never
    combined), with weights drawn from ``seed`` on ``device`` (``cuda``
    unless the caller asks for ``"cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    return TwoTower(n_users + 1, n_items + 1, n_output, combiner,
                    name="TwoTower", gen=gen).to(dev)
