"""Row-sharded embedding tables over one mesh axis (≙
``bigdl_tpu/embedding/sharded.py``).

The table's rows are dealt in contiguous blocks over the ranks of a mesh
axis, and a lookup is the model-parallel exchange of the reference:

  1. each rank holds its row block and takes its block of the batch (the
     caller hands every rank the global batch, as the port's trainers do);
  2. ids are bucketed by owner rank and sent with one
     ``all_to_all_single`` (the request leg);
  3. each owner gathers the requested rows of its block;
  4. a second ``all_to_all_single`` returns them (the reply leg);
  5. the replies go back to their flat positions and are combined per
     bag exactly as :func:`dense_bag` combines.

Both legs go through :func:`~bigdl_tpu_torch.observability.collectives
.all_to_all_single` on the axis's process group (NCCL on the card, gloo on
the CPU), so that a ``CollectiveTap`` records them.  The backward runs the
reply leg in reverse (:class:`_Exchange`): each requester sends the
gradient of its replies back to the owner, which adds them per row in the
order of the global batch's positions.  The gather and the combine sum in
a fixed order (:mod:`bigdl_tpu_torch.tensor._segment`), so the sharded
forward and backward are bitwise equal to :func:`dense_bag`, and two runs
are bitwise equal, on the CPU and on the card.

A mesh axis of size 1 runs the exchange on the process group of a world
of one rank (its collectives are issued, as on the card's one-rank mesh),
and with no process group at all, locally.

Not as in the reference: the wire accounting (``_account_exchange``) goes
to the recorder handed to :meth:`ShardedEmbeddingBag.set_recorder`, and to
none without one (the port has no process-wide recorder); ids past a full
bucket (``capacity``) are dropped and their positions read zeros (the
reference reads a clamped slot there); a module holds only its own row
block, so :func:`reference_table` gathers the blocks (a collective).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..nn.init import Xavier, init_tensor
from ..nn.module import Module
from ..observability import collectives as coll
from ..tensor._segment import combine_bags, gather_rows, segment_sum


def row_shard_spec(n_index: int, n_shards: int):
    """(rows_per_shard, padded_rows): rows are dealt in contiguous
    blocks, padded so every shard holds the same count."""
    rows = -(-int(n_index) // int(n_shards))
    return rows, rows * int(n_shards)


def pad_table(weight, n_shards: int):
    """Zero-pad a (V, D) table to (rows_per_shard * n_shards, D)."""
    v = weight.shape[0]
    _, padded = row_shard_spec(v, n_shards)
    if padded == v:
        return weight
    return torch.cat([weight, weight.new_zeros((padded - v,)
                                               + tuple(weight.shape[1:]))])


# --------------------------------------------------------------------- #
# shared building blocks: the sharded path and the dense reference run  #
# the same op sequence                                                  #
# --------------------------------------------------------------------- #
def _positions_emb(table, gid):
    """Per-position embeddings for 0-based global ids; invalid ids
    (``gid < 0``, the padding sentinel) contribute exactly +0.0."""
    valid = gid >= 0
    emb = gather_rows(table, torch.clamp(gid, 0, table.shape[0] - 1))
    return torch.where(valid[:, None], emb, emb.new_zeros(()))


def _flatten_bags(ids, per_id_weights):
    """(B, L) 1-based padded ids -> (flat 0-based gid with -1 padding,
    flat weights with 0.0 at padding, flat bag ids)."""
    b, l = ids.shape
    gid = ids.to(torch.int64).reshape(-1) - 1          # 0 (pad) -> -1
    valid = gid >= 0
    if per_id_weights is None:
        wts = valid.to(torch.float32)
    else:
        wts = torch.where(valid, per_id_weights.reshape(-1)
                          .to(device=gid.device, dtype=torch.float32),
                          torch.zeros((), device=gid.device))
    rows = torch.arange(b, device=ids.device).repeat_interleave(l)
    return gid, wts, rows


def _check_combiner(combiner):
    if combiner not in ("sum", "mean", "sqrtn"):
        raise ValueError(f"combiner must be sum|mean|sqrtn: {combiner}")


def dense_bag(weight, ids, per_id_weights=None, combiner="sum"):
    """Single-device dense-gather reference: padded (B, L) 1-based ids
    (0 = padding) over a (V, D) table; the semantics of
    :func:`bigdl_tpu_torch.tensor.embedding_bag` on the equivalent
    SparseTensor (an id past the table reads its last row, as the
    reference's does)."""
    _check_combiner(combiner)
    ids = ids.to(weight.device)
    gid, wts, rows = _flatten_bags(ids, per_id_weights)
    emb = _positions_emb(weight, gid)
    return combine_bags(emb, wts, rows, ids.shape[0], combiner)


# --------------------------------------------------------------------- #
# the all-to-all exchange (one rank's part)                             #
# --------------------------------------------------------------------- #
class _Axis:
    """The exchange's place on the mesh: its process group (None: run
    locally), size ``n`` and this rank's index ``k``."""

    def __init__(self, group, n, k, local):
        self.group, self.n, self.k, self.local = group, n, k, local


def _a2a(t, axis: _Axis):
    """One leg: row j of ``t`` to rank j, row j of the result from it."""
    if axis.local:
        return t
    out = torch.empty_like(t)
    coll.all_to_all_single(out, t.contiguous(), group=axis.group)
    return out


class _Exchange(torch.autograd.Function):
    """``table[gid]`` over the row-sharded table: forward sends the ids to
    their owners and the rows back; backward sends the rows' gradients to
    the owners, which add them per row (from every requester, in rank
    order, each in its positions' order: the global batch's order)."""

    @staticmethod
    def forward(ctx, table_local, gid, rows_per_shard, cap, axis):
        n, k = axis.n, axis.k
        gid = gid.to(torch.int64)
        s = gid.shape[0]
        dev = gid.device
        valid = gid >= 0
        # padding stays local (owner = self) and ships a -1 sentinel
        owner = torch.where(valid, torch.div(gid, rows_per_shard,
                                             rounding_mode="floor"),
                            torch.full((), k, device=dev, dtype=gid.dtype))
        order = torch.argsort(owner, stable=True)
        sowner = owner[order]
        sgid = gid[order]
        starts = torch.searchsorted(sowner, torch.arange(n, device=dev))
        slot = torch.arange(s, device=dev) - starts[sowner]
        kept = slot < cap             # past a full bucket: dropped
        dest = sowner * cap + torch.clamp(slot, max=cap - 1)
        # a dropped id is written to one spare slot past the buffer (no
        # boolean indexing: that would wait for the device)
        spare = torch.where(kept, dest, n * cap)
        send = torch.full((n * cap + 1,), -1, dtype=torch.int32, device=dev)
        send[spare] = sgid.to(torch.int32)
        recv = _a2a(send[:n * cap], axis).to(torch.int64)   # request leg
        lrow = recv - k * rows_per_shard
        rvalid = (lrow >= 0) & (lrow < rows_per_shard) & (recv >= 0)
        flat = torch.clamp(lrow, 0, rows_per_shard - 1)
        emb = table_local.index_select(0, flat)
        emb = torch.where(rvalid[:, None], emb, emb.new_zeros(()))
        back = _a2a(emb, axis)                              # reply leg
        got = back.index_select(0, dest)
        got = torch.where(kept[:, None], got, got.new_zeros(()))
        # unsort: each reply to its original flat position
        out = torch.empty_like(got)
        out[order] = got
        ctx.save_for_backward(order, dest, spare, kept, flat, rvalid)
        ctx.meta = (rows_per_shard, cap, axis)
        return out

    @staticmethod
    def backward(ctx, grad):
        order, dest, spare, kept, flat, rvalid = ctx.saved_tensors
        rows_per_shard, cap, axis = ctx.meta
        g_sorted = grad.index_select(0, order)
        g_back = g_sorted.new_zeros((axis.n * cap + 1, grad.shape[1]))
        g_back[spare] = g_sorted
        g_emb = _a2a(g_back[:axis.n * cap], axis)   # the reply leg, reversed
        g_emb = torch.where(rvalid[:, None], g_emb, g_emb.new_zeros(()))
        g_table = segment_sum(g_emb, flat, rows_per_shard)
        return g_table, None, None, None, None


def _exchange_gather(table_local, gid, rows_per_shard, capacity,
                     axis: _Axis):
    """``table[gid]`` when rows live on their owner rank: (S, D)
    per-position embeddings in the original order, padding (-1) rows
    exactly +0.0.  ``capacity`` bounds each owner's bucket; ids past a
    full bucket are dropped (their rows read zeros) without an error, so
    callers must keep it at least the worst per-owner count (the default,
    S, always is)."""
    cap = int(capacity) if capacity else int(gid.shape[0])
    return _Exchange.apply(table_local, gid, int(rows_per_shard),
                           max(cap, 1), axis)


def _account_exchange(n_shards, cap, dim, itemsize, axis, recorder=None):
    """Wire attribution of one lookup exchange (both legs) to
    ``recorder`` (nothing without one): ``comm/group.<axis>.*`` through
    :func:`~bigdl_tpu_torch.observability.collectives.account_collective`
    and the ``embedding/*`` gauges."""
    if recorder is None or not getattr(recorder, "enabled", True):
        return
    id_bytes = n_shards * cap * 4
    emb_bytes = n_shards * cap * dim * itemsize
    coll.account_collective("all-to-all", id_bytes, float(id_bytes),
                            recorder=recorder, group=axis)
    coll.account_collective("all-to-all", emb_bytes, float(emb_bytes),
                            recorder=recorder, group=axis)
    pre = "embedding/"
    for suffix, val in (("lookup_exchange_bytes",
                         float(id_bytes + emb_bytes)),
                        ("exchange_ids", float(n_shards * cap))):
        recorder.gauge(pre + suffix,
                       recorder.gauge_value(pre + suffix) + val)


def _resolve_axis(mesh, axis: str) -> _Axis:
    if mesh is None:
        if not dist.is_initialized():
            return _Axis(None, 1, 0, True)
        from ..parallel.mesh import get_mesh
        mesh = get_mesh()
    if axis not in mesh.shape:
        raise ValueError(f"axis {axis!r} is not an axis of {mesh}")
    group, n, k = mesh.group_of((axis,))
    if group is not None:
        return _Axis(group, n, k, False)
    # an axis of one rank: the exchange is issued on a world of one rank
    one = dist.is_initialized() and dist.get_world_size() == 1
    return _Axis(None, 1, 0, not one)


class ShardedEmbeddingBag(Module):
    """Embedding bag whose table rows are sharded over mesh ``axis``.

    Input, every rank the global batch: ``ids`` (B, L) int, 1-based,
    0 = padding, or ``(ids, per_id_weights)``; or, with the host dedup
    stage (:func:`~bigdl_tpu_torch.embedding.dedup.dedup_for_mesh`),
    ``(uniq_ids (n_shards, U), inverse (B, L))``, and only the unique ids
    cross the wire.  Output: this rank's (B / n_shards, n_output) block of
    the batch (B must divide by the axis size).

    The weight is this rank's row block, ``(rows_per_shard, n_output)``,
    cut from a dense (n_index, n_output) Xavier draw (from ``gen``)
    zero-padded to the shard grid, so :func:`dense_bag` over
    :func:`reference_table` is the bitwise reference for the forward and
    the backward.  ``mesh`` None: the current mesh under a process group,
    else one shard on this device."""

    def __init__(self, n_index, n_output, mesh=None, axis="tp",
                 combiner="sum", capacity=None, name=None, *,
                 gen: torch.Generator = None):
        super().__init__(name=name)
        _check_combiner(combiner)
        self.n_index = int(n_index)
        self.n_output = int(n_output)
        self.axis = axis
        self.combiner = combiner
        self.capacity = capacity
        self._axis = _resolve_axis(mesh, axis)
        self._recorder = None
        rows, _ = row_shard_spec(self.n_index, self.n_shards)
        full = pad_table(init_tensor(self, gen, (self.n_index, self.n_output),
                                     self.n_index, self.n_output, Xavier()),
                         self.n_shards)
        lo = self._axis.k * rows
        self.weight = torch.nn.Parameter(full[lo:lo + rows].clone())

    @property
    def n_shards(self) -> int:
        return self._axis.n

    def row_bounds(self):
        """[lo, hi) of the padded table's rows this rank holds."""
        rows, _ = row_shard_spec(self.n_index, self.n_shards)
        return self._axis.k * rows, (self._axis.k + 1) * rows

    def set_recorder(self, recorder) -> "ShardedEmbeddingBag":
        """The recorder each lookup's exchange is accounted to (None: no
        accounting)."""
        self._recorder = recorder
        return self

    def apply(self, params, x, ctx):
        w = self.own(params)["weight"]
        n = self.n_shards
        rows, padded = row_shard_spec(self.n_index, n)
        if w.shape[0] != rows:
            raise ValueError(
                f"{self.name}: this rank's table block has {w.shape[0]} "
                f"rows, the shard grid needs {rows} (= {padded} / {n})")
        if isinstance(x, (tuple, list)) and len(x) == 2 \
                and getattr(x[0], "dim", lambda: 0)() == 2 \
                and getattr(x[1], "dim", lambda: 0)() == 2 \
                and not torch.is_floating_point(x[1]):
            return self._apply_dedup(w, x[0], x[1], n, rows)
        if isinstance(x, (tuple, list)):
            ids, per_id_weights = x[0], x[1]
        else:
            ids, per_id_weights = x, None
        return self._apply_plain(w, ids, per_id_weights, n, rows)

    def _block(self, t, lb):
        k = self._axis.k
        return t[k * lb:(k + 1) * lb]

    def _apply_plain(self, w, ids, per_id_weights, n, rows):
        b, l = ids.shape
        if b % n:
            raise ValueError(f"batch {b} must divide by axis "
                             f"{self.axis}={n}")
        lb = b // n
        s = lb * l
        cap = int(self.capacity) if self.capacity else s
        _account_exchange(n, cap, self.n_output, w.element_size(),
                          self.axis, self._recorder)
        ids_l = self._block(ids, lb).to(w.device)
        wts_l = None if per_id_weights is None else \
            self._block(per_id_weights, lb).to(w.device)
        gid, wts, segs = _flatten_bags(ids_l, wts_l)
        emb = _exchange_gather(w, gid, rows, cap, self._axis)
        return combine_bags(emb, wts, segs, lb, self.combiner)

    def _apply_dedup(self, w, uniq_ids, inverse, n, rows):
        """Dedup mode: exchange only this rank's unique ids, then gather
        the per-position embeddings locally through ``inverse``.  The
        forward is bitwise the plain path's (a gather of gathers); the
        backward first adds each rank's duplicate rows per unique id, so
        the accumulation is reassociated against dense's per-position
        one: the reference's float32 envelope, not bitwise.  ``inverse``
        must point padding positions at a -1 slot of ``uniq_ids``
        (:func:`~bigdl_tpu_torch.embedding.dedup.dedup_for_mesh` keeps
        one)."""
        b, l = inverse.shape
        if b % n:
            raise ValueError(f"batch {b} must divide by axis "
                             f"{self.axis}={n}")
        if uniq_ids.shape[0] != n:
            raise ValueError(
                f"uniq_ids leading dim {uniq_ids.shape[0]} != axis size "
                f"{n} (one unique-id row per rank)")
        lb = b // n
        u = uniq_ids.shape[1]
        cap = int(self.capacity) if self.capacity else u
        _account_exchange(n, cap, self.n_output, w.element_size(),
                          self.axis, self._recorder)
        k = self._axis.k
        uid = uniq_ids[k].to(device=w.device, dtype=torch.int64)  # 0-based
        uniq_emb = _exchange_gather(w, uid, rows, cap, self._axis)
        inv = self._block(inverse, lb).reshape(-1).to(
            device=w.device, dtype=torch.int64)
        sel = torch.clamp(inv, 0, u - 1)
        emb = gather_rows(uniq_emb, sel)
        valid = (inv >= 0) & (uid.index_select(0, sel) >= 0)
        emb = torch.where(valid[:, None], emb, emb.new_zeros(()))
        wts = valid.to(torch.float32)
        segs = torch.arange(lb, device=w.device).repeat_interleave(l)
        return combine_bags(emb, wts, segs, lb, self.combiner)


def reference_table(params, bag: ShardedEmbeddingBag):
    """The unpadded (V, D) table of a ShardedEmbeddingBag, what
    :func:`dense_bag` takes: this rank's block on one shard, else every
    rank's blocks gathered over the axis (a collective: every rank of the
    axis calls it)."""
    w = params[bag.name]["weight"]
    if bag._axis.local or bag.n_shards == 1:
        return w[:bag.n_index]
    out = w.new_empty((bag.n_shards * w.shape[0],) + tuple(w.shape[1:]))
    coll.all_gather_into_tensor(out, w.detach().contiguous(),
                                group=bag._axis.group)
    return out[:bag.n_index]
