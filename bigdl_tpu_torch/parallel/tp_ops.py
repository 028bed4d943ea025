"""The collectives of tensor and fully sharded parallelism, as autograd
functions over a process group.

The reference declares a layout (``pspec``) and lets the GSPMD
partitioner insert the collectives; this module has no counterpart
there.  The port runs each rank's share of the math on local tensors and
places the collectives by hand, as Megatron-LM does:

  * :func:`copy_to_group` (Megatron's *f*): identity forward, all-reduce
    backward; before a column-parallel matmul, whose input is the same on
    every rank of the group;
  * :func:`reduce_from_group` (*g*): all-reduce forward, identity
    backward; after a row-parallel matmul, whose partial sums add up;
  * :func:`gather_from_group`: all-gather along a dim forward,
    reduce-scatter backward (fsdp's parameter gather, the sequence gather
    of sp without the ring);
  * :func:`vocab_embedding`: the gather of a vocab-sharded embedding;
  * :func:`vocab_parallel_nll`: the token NLL over vocab-sharded logits:
    the max, the sum of exponentials and the gold logit reduced over the
    group; the (B, S, V) logits are never gathered.

A group is ``(process group, size, index)`` as
:meth:`~bigdl_tpu_torch.parallel.mesh.Mesh.group_of` gives it; a group of
None (an axis of size 1) has nothing to communicate.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..observability import collectives as comm


def _all_reduce(t, group, op=dist.ReduceOp.SUM):
    out = t.contiguous().clone()
    if group is not None:
        comm.all_reduce(out, op=op, group=group)
    return out


def all_gather_dim(t, group, size: int, dim: int = 0):
    """``t`` of every rank of the group, concatenated along ``dim`` in
    rank order (no autograd)."""
    if group is None:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((size * src.shape[0],) + tuple(src.shape[1:]))
    comm.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(t, group, size: int, dim: int = 0):
    """The sum of ``t`` over the group, block ``index`` of ``size`` along
    ``dim`` on each rank (no autograd)."""
    if group is None:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // size,) + tuple(src.shape[1:]))
    comm.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        return all_gather_dim(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_dim(g, ctx.group, ctx.size, ctx.dim),
                None, None, None)


def copy_to_group(x, tp):
    """Megatron's *f* over ``tp``: the input of a column-parallel
    matmul."""
    return x if tp is None or tp[0] is None else _Copy.apply(x, tp[0])


def reduce_from_group(x, tp):
    """Megatron's *g* over ``tp``: the sum of a row-parallel matmul's
    partial outputs."""
    return x if tp is None or tp[0] is None else _Reduce.apply(x, tp[0])


def gather_from_group(x, group, size: int, dim: int = 0):
    """All-gather along ``dim`` with a reduce-scatter backward."""
    return x if group is None else _Gather.apply(x, group, size, dim)


def vocab_embedding(w, ids, tp):
    """Rows ``ids`` of a vocab-sharded ``(V/tp, D)`` embedding, summed
    over ``tp`` (each rank gives its rows, zero elsewhere).  An id is
    wrapped once and one still outside ``[0, V)`` gives a row of NaN, as
    the unsharded ``TokenEmbedding`` does."""
    _, size, index = tp
    rows = w.shape[0]
    v = rows * size
    ids = ids.long()
    ids = torch.where(ids < 0, ids + v, ids)
    valid = (ids >= 0) & (ids < v)
    local = ids - index * rows
    mine = (local >= 0) & (local < rows)
    out = w[local.clamp(0, rows - 1)] * mine[..., None].to(w.dtype)
    out = reduce_from_group(out, tp)
    return torch.where(valid[..., None], out, float("nan"))


class _VocabNLL(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[target]`` over logits split
    on the vocab dim; fp32."""

    @staticmethod
    def forward(ctx, logits, targets, group, index):
        rows = logits.shape[-1]
        m = _all_reduce(logits.amax(dim=-1), group, dist.ReduceOp.MAX)
        e = torch.exp(logits - m[..., None])
        se = _all_reduce(e.sum(dim=-1), group)
        local = targets - index * rows
        mine = (local >= 0) & (local < rows)
        idx = local.clamp(0, rows - 1)
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        gold = _all_reduce(torch.where(mine, gold, torch.zeros_like(gold)),
                           group)
        ctx.save_for_backward(e, se, idx, mine)
        return m + torch.log(se) - gold

    @staticmethod
    def backward(ctx, g):
        e, se, idx, mine = ctx.saved_tensors
        grad = e / se[..., None] * g[..., None]
        sub = torch.where(mine, g, torch.zeros_like(g))
        grad.scatter_add_(-1, idx[..., None], -sub[..., None])
        return grad, None, None, None


def vocab_parallel_nll(logits, targets, tp, ignore_index: int = -1):
    """(sum of masked token NLLs, valid-token count) over logits
    ``(B, S, V/tp)`` sharded on the vocab dim: the reference's
    ``lm_token_nll`` (targets clipped to ``[0, V)``, those equal to
    ``ignore_index`` masked), in fp32."""
    group, size, index = tp
    v = logits.shape[-1] * size
    tgt = targets.long().clamp(0, v - 1)
    nll = _VocabNLL.apply(logits.float(), tgt, group, index)
    mask = (targets != ignore_index).float()
    return (nll * mask).sum(), mask.sum()
