"""Ring attention: exact attention with the sequence split over ``sp``
(≙ ``bigdl_tpu/parallel/ring_attention.py``).

Each rank holds a block of ``S/sp`` positions of q, k and v.  The k/v
blocks travel around the ring over point-to-point sends
(``batch_isend_irecv``): at step ``t`` rank ``i`` holds the block of rank
``(i - t) mod sp`` and merges it into its online-softmax accumulators
(:func:`~bigdl_tpu_torch.ops.flash_attention.chunk_merge_blockwise`,
``block_k`` keys at a time), then passes it on.  Positions are global, so
the causal mask across blocks is exact, and a block that lies wholly in a
rank's future is skipped.

Autograd does not cross point-to-point ops, so the backward is written
out (:class:`_Ring`): the reverse ring.  The k/v blocks travel the other
way together with their gradient accumulators; each rank adds its
queries' share to the block it holds and, after ``sp`` hops, every
block's dK and dV are home.  Scores are recomputed from the saved
log-sum-exp, as the flash backward does.  Like the reference's ring, this
is plain math (fp32 accumulators), not a hand kernel.

:func:`ring_attention_shmap` is the reference's shard-map wrapper: it
takes the rank's local blocks and the mesh.  :func:`ring_attention_merge`
runs the ring's merge order for all ``sp`` ranks in one process.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..observability import collectives as comm

from ..ops.flash_attention import (DEFAULT_MASK_VALUE, _mask,
                                   chunk_merge_blockwise, finalize)


def _rotate(tensors, group, size: int, index: int, step: int):
    """Send each tensor to rank ``index + step`` of the group and receive
    the same-shaped tensors of rank ``index - step``."""
    to = dist.get_global_rank(group, (index + step) % size)
    frm = dist.get_global_rank(group, (index - step) % size)
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in tensors]
    ops = []
    for tag, (t, o) in enumerate(zip(tensors, outs)):
        ops.append(dist.P2POp(dist.isend, t, to, group, tag))
        ops.append(dist.P2POp(dist.irecv, o, frm, group, tag))
    for req in comm.batch_isend_irecv(ops):
        req.wait()
    return outs


def _ring_forward(q, blocks, index: int, size: int, causal: bool,
                  sm_scale: float, block_k: Optional[int]):
    """The accumulators of rank ``index``'s queries over the k/v blocks
    that ``blocks(t)`` yields at ring step ``t``: ``(out fp32, lse)``."""
    b, h, s, d = q.shape
    total = size * s
    dev = q.device
    q_pos = index * s + torch.arange(s, device=dev)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, s), DEFAULT_MASK_VALUE, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
    for t in range(size):
        src = (index - t) % size
        k_c, v_c = blocks(t)
        if causal and src > index:
            continue        # a block wholly in this rank's future
        k_pos = src * s + torch.arange(s, device=dev)
        acc, m, l = chunk_merge_blockwise(q, k_c, v_c, acc, m, l, q_pos,
                                          k_pos, total, sm_scale, causal,
                                          block_k)
    return finalize(acc, m, l)


def _block_grads(q32, do32, delta, lse, k_c, v_c, q_pos, k_pos, total,
                 sm_scale, causal, block_k):
    """One k/v block's share of the gradients of rank's queries:
    ``(dq, dk, dv)`` in fp32, ``block_k`` keys at a time."""
    sk = k_c.shape[2]
    bk = sk if block_k is None else min(block_k, sk)
    dq = torch.zeros_like(q32)
    dks, dvs = [], []
    for lo in range(0, sk, bk):
        kb, vb = k_c[:, :, lo:lo + bk].float(), v_c[:, :, lo:lo + bk].float()
        s_ = torch.matmul(q32, kb.transpose(-1, -2)) * sm_scale
        s_ = torch.where(_mask(q_pos, k_pos[lo:lo + bk], total, causal), s_,
                         DEFAULT_MASK_VALUE)
        p = torch.exp(s_ - lse[..., None])
        dvs.append(torch.matmul(p.transpose(-1, -2), do32))
        ds = p * (torch.matmul(do32, vb.transpose(-1, -2)) - delta[..., None])
        dq = dq + torch.matmul(ds, kb) * sm_scale
        dks.append(torch.matmul(ds.transpose(-1, -2), q32) * sm_scale)
    return dq, torch.cat(dks, dim=2), torch.cat(dvs, dim=2)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, size, index, causal, sm_scale,
                block_k):
        held = [k, v]

        def blocks(t):
            if t:
                held[:] = _rotate(held, group, size, index, +1)
            return held
        out, lse = _ring_forward(q, blocks, index, size, causal, sm_scale,
                                 block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (group, size, index, causal, sm_scale, block_k)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, size, index, causal, sm_scale, block_k = ctx.cfg
        s = q.shape[2]
        dev = q.device
        q32, do32 = q.float(), do.float()
        delta = (do32 * out).sum(dim=-1)
        q_pos = index * s + torch.arange(s, device=dev)
        dq = torch.zeros_like(q32)
        k_c, v_c = k, v
        dk_c = torch.zeros(k.shape, dtype=torch.float32, device=dev)
        dv_c = torch.zeros(v.shape, dtype=torch.float32, device=dev)
        # the reverse ring: at step t this rank holds block index + t
        for t in range(size):
            src = (index + t) % size
            if not (causal and src > index):
                k_pos = src * s + torch.arange(s, device=dev)
                gq, gk, gv = _block_grads(q32, do32, delta, lse, k_c, v_c,
                                          q_pos, k_pos, size * s, sm_scale,
                                          causal, block_k)
                dq, dk_c, dv_c = dq + gq, dk_c + gk, dv_c + gv
            if t < size - 1:
                k_c, v_c, dk_c, dv_c = _rotate([k_c, v_c, dk_c, dv_c], group,
                                               size, index, -1)
            else:       # one more hop takes every dK, dV home
                dk_c, dv_c = _rotate([dk_c, dv_c], group, size, index, -1)
        return (dq.to(q.dtype), dk_c.to(k.dtype), dv_c.to(v.dtype),
                None, None, None, None, None, None)


def ring_attention(q, k, v, sp, causal: bool = False,
                   sm_scale: Optional[float] = None,
                   block_k: Optional[int] = 1024):
    """Exact attention of this rank's sequence block.

    q, k, v: (batch, heads, seq_local, head_dim), the rank's block of a
    sequence split over ``sp`` (``(group, size, index)``, see
    :meth:`~bigdl_tpu_torch.parallel.mesh.Mesh.group_of`).  Returns the
    block of the output, q's shape and dtype.  ``block_k`` caps the
    scores alive at (seq_local, block_k); None merges a block whole."""
    group, size, index = sp
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _Ring.apply(q, k, v, group, size, index, bool(causal),
                       float(sm_scale), block_k)


def ring_attention_shmap(q, k, v, mesh, causal: bool = False,
                         sm_scale: Optional[float] = None,
                         seq_axis: str = "sp",
                         block_k: Optional[int] = 1024):
    """The reference's wrapper over a mesh: q, k and v are this rank's
    blocks (its batch rows and ``tp`` heads are its own already: heads are
    independent, so only the ``seq_axis`` ring communicates)."""
    if seq_axis not in mesh.shape:
        raise ValueError(
            f"ring_attention_shmap: seq_axis {seq_axis!r} is not a mesh "
            f"axis {mesh.axis_names}; for unsharded sequences use "
            "ops.flash_attention instead")
    return ring_attention(q, k, v, mesh.group_of((seq_axis,)), causal,
                          sm_scale, block_k)


def ring_attention_merge(q, k, v, sp: int, causal: bool = False,
                         sm_scale: Optional[float] = None,
                         block_k: Optional[int] = 1024):
    """The ring's forward for ``sp`` ranks in one process: q, k and v are
    whole sequences (B, H, S, D); each rank's block of queries merges the
    k/v blocks in the order the ring hands them over.  Returns the whole
    output (q's dtype): what ``sp`` ranks of :func:`ring_attention`
    return, concatenated."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = q.shape[2] // sp
    if s * sp != q.shape[2]:
        raise ValueError(f"sequence {q.shape[2]} does not split over "
                         f"sp={sp}")

    def blk(t, i):
        return t[:, :, i * s:(i + 1) * s]
    outs = []
    for index in range(sp):
        out, _ = _ring_forward(
            blk(q, index),
            lambda t: (blk(k, (index - t) % sp), blk(v, (index - t) % sp)),
            index, sp, causal, sm_scale, block_k)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=2)
