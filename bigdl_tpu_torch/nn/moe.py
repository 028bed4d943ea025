"""Mixture-of-experts FFN over an ``ep`` axis (≙ ``bigdl_tpu/nn/moe.py``).

:class:`SwitchFFN` is the reference's algorithm in torch: routing is one
fp32 softmax and a top-1/2 ``argmax`` (the ``masked *= 1 - onehot``
loop), dispatch and combine are dense one-hot tensors ``(N, E, C)`` over
a fixed capacity per expert, with each token's slot the ``cumsum`` of the
selections before it, and the experts are batched SwiGLU products over
the leading expert dim (``torch.einsum``; the reference leaves them to
XLA, no Pallas kernel).  The load-balancing loss (Switch Transformer eq.
4) goes through ``ctx.add_loss``; ``router_noise`` draws through
:meth:`Ctx.draw`.

The token population.  Capacity, slot positions and the aux loss are
functions of every token the module sees at once.  The reference's
``SpmdTrainer`` runs it on the logical global batch, so the port's
sharded step, where a rank holds a block of the rows and of the
sequence, reproduces that: ``ctx.shard.tokens`` (a :class:`TokenGroup`,
the ranks that split the batch) gathers each rank's ``(N_local, E)``
selection, places it at the rank's rows and sequence block, takes the
rank's rows of the global ``cumsum``, computes ``C`` from the global
``N`` and reduces ``frac_tokens`` and ``frac_probs`` over the group (the
latter with a gradient).  Without a token group (one device, the
pipeline's microbatch, decode) the population is the local input, as it
is in the reference there.

Over ``ep``: each ep rank holds ``E/ep`` experts; the tokens are the same
on every ep rank (``ep`` is a model axis).  A rank dispatches to and runs
its experts, and the combine is summed over ``tp × ep``.  The dispatch
input and the gates enter through copies whose backward all-reduces over
``tp × ep`` (Megatron's *f*), so the router and the block input get the
gradient of every expert; the aux loss reads ``probs`` outside those
copies.  Within an expert, tp is Megatron's layout, as in ``SwiGLU``
(``w1``/``w3`` column-, ``w2`` row-sharded); the row-parallel partial
sums are added by the same reduce as the experts'.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .module import Module


class TokenGroup:
    """The ranks whose blocks make up the token population of a sharded
    step: ``group``/``size``/``index`` as ``Mesh.group_of`` gives them, and
    for each member in group order its ``(row block, sequence block)``
    index; :meth:`bind` fixes the block sizes of a (micro)batch."""

    __slots__ = ("group", "size", "index", "members", "rows", "seq")

    def __init__(self, group, size: int, index: int,
                 members: Sequence[Tuple[int, int]], rows=None, seq=None):
        self.group, self.size, self.index = group, int(size), int(index)
        self.members = [tuple(m) for m in members]
        self.rows, self.seq = rows, seq      # (block, total) once bound

    def bind(self, rows: int, total_rows: int, seq: int, total_seq: int):
        """This group over blocks of ``rows`` × ``seq`` tokens of a batch
        of ``total_rows`` × ``total_seq``."""
        return TokenGroup(self.group, self.size, self.index, self.members,
                          (rows, total_rows), (seq, total_seq))

    @property
    def n_tokens(self) -> int:
        return self.rows[1] * self.seq[1]

    def _corner(self, member):
        r, s = self.members[member]
        return r * self.rows[0], s * self.seq[0]

    def global_cumsum(self, sel):
        """This rank's rows of the ``cumsum`` over the whole population in
        (row, position) order of the ``(N_local, E)`` selection ``sel``."""
        k, sl = self.rows[0], self.seq[0]
        e = sel.shape[-1]
        src = sel.reshape(1, k, sl, e).to(torch.int32).contiguous()
        every = src.new_empty((self.size, k, sl, e))
        dist.all_gather_into_tensor(every, src, group=self.group)
        glob = sel.new_zeros((self.rows[1], self.seq[1], e),
                             dtype=torch.int32)
        for j in range(self.size):
            r0, s0 = self._corner(j)
            glob[r0:r0 + k, s0:s0 + sl] = every[j]
        cum = torch.cumsum(glob.reshape(-1, e), dim=0).reshape(glob.shape)
        r0, s0 = self._corner(self.index)
        return cum[r0:r0 + k, s0:s0 + sl].reshape(k * sl, e)

    def local_rows(self, t):
        """This rank's block of ``t``, a tensor over the whole population
        ``(rows, seq, ...)``, flattened to ``(N_local, ...)``."""
        k, sl = self.rows[0], self.seq[0]
        r0, s0 = self._corner(self.index)
        return t[r0:r0 + k, s0:s0 + sl].reshape((k * sl,) + t.shape[2:])


class _SumOverGroup(torch.autograd.Function):
    """All-reduce forward and backward: a sum over the group whose every
    member's cotangent reaches every member's input (JAX's ``psum`` and
    its transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def _normal(shape, scale, gen):
    return torch.nn.Parameter(
        torch.randn(shape, generator=gen, dtype=torch.float32) * scale)


class SwitchFFN(Module):
    """Top-k routed SwiGLU experts with a fixed capacity.

    Input (B, S, d_model) -> output (B, S, d_model).  ``capacity_factor``
    bounds the tokens of an expert at
    ``ceil(top_k * tokens / n_experts * capacity_factor)``: an overflowing
    token is dropped (its combine weight is zero) and an empty slot
    computes zeros, as in Switch Transformer.  Layout (``pspec``, the
    reference's): ``router`` replicated, ``w1``/``w3`` ``("ep", None,
    "tp")``, ``w2`` ``("ep", "tp", None)``."""

    def __init__(self, d_model, d_ff, n_experts, top_k=1,
                 capacity_factor=1.25, aux_loss_weight=1e-2,
                 router_noise=0.0, gen: Optional[torch.Generator] = None,
                 name=None):
        super().__init__(name=name)
        if top_k not in (1, 2):
            raise ValueError("top_k must be 1 or 2")
        self.d_model = d_model
        self.d_ff = d_ff
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.router_noise = router_noise
        self.pspec = {"router": (None, None), "w1": ("ep", None, "tp"),
                      "w3": ("ep", None, "tp"), "w2": ("ep", "tp", None)}
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        E, D, Fd = n_experts, d_model, d_ff
        s_in, s_out = D ** -0.5, Fd ** -0.5
        self.router = _normal((D, E), s_in, gen)
        self.w1 = _normal((E, D, Fd), s_in, gen)
        self.w3 = _normal((E, D, Fd), s_in, gen)
        self.w2 = _normal((E, Fd, D), s_out, gen)

    def _capacity(self, n_tokens):
        cap = int(self.top_k * n_tokens / self.n_experts
                  * self.capacity_factor + 0.999)
        return max(cap, 1)

    def apply(self, params, x, ctx):
        from ..parallel import tp_ops
        p = self.own(params)
        dt = x.dtype
        b, s, d = x.shape
        E = self.n_experts
        n = b * s
        shard = ctx.shard
        tokens = None if shard is None else shard.tokens
        if tokens is not None:
            tokens = tokens.bind(b, shard.rows[2], s, shard.seq[2])
        n_all = n if tokens is None else tokens.n_tokens
        C = self._capacity(n_all)
        xt = x.reshape(n, d)

        # ---- routing (fp32 for a stable softmax) --------------------- #
        logits = torch.matmul(xt.float(), p["router"].float())
        if ctx.training and self.router_noise > 0.0:
            logits = logits + self.router_noise * self._noise(
                ctx, logits, tokens)
        probs = torch.softmax(logits, dim=-1)               # (N, E)
        gates = torch.zeros_like(probs)
        masked = probs
        for _ in range(self.top_k):
            onehot = F.one_hot(torch.argmax(masked, dim=-1), E).float()
            gates = gates + onehot * probs
            masked = masked * (1.0 - onehot)
        sel = (gates > 0.0).detach()                        # (N, E)

        # ---- capacity: the slot of each token in its expert ---------- #
        seli = sel.to(torch.int32)
        cum = torch.cumsum(seli, dim=0) if tokens is None \
            else tokens.global_cumsum(seli)
        pos = cum - 1
        keep = sel & (pos < C)
        slot = F.one_hot(pos.clamp(0, C - 1).long(), C).float() \
            * keep[..., None].float()                       # (N, E, C)

        # ---- this rank's experts ------------------------------------- #
        ep = None if shard is None else shard.ep
        e0, e1 = 0, E
        if ep is not None:
            el = E // ep[1]
            e0, e1 = ep[2] * el, (ep[2] + 1) * el
        experts = None if shard is None else shard.experts
        xd = tp_ops.copy_to_group(xt, experts)
        g = tp_ops.copy_to_group(gates, experts)
        slot_l = slot[:, e0:e1]
        combine = slot_l * g[:, e0:e1, None]
        expert_in = torch.einsum("nec,nd->ecd", slot_l.to(dt), xd)
        h = F.silu(torch.einsum("ecd,edf->ecf", expert_in,
                                p["w1"].to(dt))) \
            * torch.einsum("ecd,edf->ecf", expert_in, p["w3"].to(dt))
        expert_out = torch.einsum("ecf,efd->ecd", h, p["w2"].to(dt))
        out = torch.einsum("nec,ecd->nd", combine.to(dt), expert_out)
        out = tp_ops.reduce_from_group(out, experts)

        # ---- load-balancing aux loss (Switch eq. 4) ------------------ #
        if ctx.training and self.aux_loss_weight > 0.0:
            if tokens is None:
                frac_tokens = torch.mean(sel.float(), dim=0)
                frac_probs = torch.mean(probs, dim=0)
            else:
                counts = sel.float().sum(dim=0)
                dist.all_reduce(counts, group=tokens.group)
                frac_tokens = counts / n_all
                frac_probs = _SumOverGroup.apply(probs.sum(dim=0),
                                                 tokens.group) / n_all
            aux = E * torch.sum(frac_tokens * frac_probs) / self.top_k
            ctx.add_loss(self.aux_loss_weight * aux.float())
        return out.reshape(b, s, d)

    def _noise(self, ctx, logits, tokens):
        """The router noise: standard normals of the population's shape
        from the step's generator (or ``Ctx.draws``), this rank's rows."""
        e = logits.shape[-1]
        shape = logits.shape if tokens is None else \
            (tokens.rows[1], tokens.seq[1], e)
        z = ctx.draw(self, logits.device, lambda gen: torch.randn(
            shape, generator=gen, device=logits.device))
        return z if tokens is None else tokens.local_rows(z)
