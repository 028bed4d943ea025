"""TransformerLM — the flagship decoder-only LM: forward and token loss.

Port of ``bigdl_tpu/models/transformer.py``: the full-sequence forward
that the dynamic-batching ``ServingEngine`` runs (``apply`` →
``apply_trunk`` → ``head_logits``), the masked token cross-entropy
that ``SpmdTrainer`` trains on (``loss`` → ``token_nll`` →
:func:`lm_token_nll`), and the token-streaming paths: the contiguous kv
cache (``init_cache`` / ``apply_with_cache``), the slot-batched decode
step that ``serving.DecodeEngine`` runs over a paged cache
(``decode_tokens``), ``generate`` and ``generate_beam``.  Same layout and
op order as the
reference: weights are used as ``x @ w`` with ``w`` of shape
``(d_in, d_out)``, the embedding is ``(V, D)``, the head ``(D, V)``; RoPE
is the reference's *interleaved* form (pairs ``x[..., 0::2]``,
``x[..., 1::2]``); attention goes through ``ops.flash_attention`` (the
Hopper kernel on the card); the plain matmuls stay ``torch.matmul``, as
the reference leaves them to XLA.  Gradients flow through ``torch.autograd``;
attention's backward is the flash backward (the Hopper kernels on the
card).

Cached attention (``apply_cached``, ``attend_window``) is plain fp32
PyTorch, as the reference leaves it to XLA einsums: it never reaches the
flash kernels.  Its op order is the reference's (fp32 scores, a true
division by ``sqrt(head_dim)``, ``where`` with
:data:`~bigdl_tpu_torch.ops.flash_attention.DEFAULT_MASK_VALUE`, softmax,
the value sum), so that the paged and the contiguous caches stay
comparable.  The contiguous cache is written in place; ``apply_with_cache``
returns the same dict it was given.  Sampling draws Gumbel noise from a
``torch.Generator``: the draws are not ``jax.random``'s, so sampled
tokens are held to the reference by their properties, greedy ones by
value.

Training takes the reference's memory levers: ``remat`` wraps each block
in :class:`~bigdl_tpu_torch.nn.containers.Remat` (lazily, at the first
``apply_trunk``, so that no auto name shifts); ``loss_chunk`` computes the
head and the loss a sequence chunk at a time, each chunk under
``torch.utils.checkpoint`` (:func:`chunked_token_nll`), so that no more
than (B, chunk, V) logits exist at once; ``dropout`` draws one keep mask
a block through :meth:`Ctx.draw` (the training loop's generator, or the
mask ``Ctx.draws`` gives under the block's name) and applies it to the
attention and the MLP outputs, as the reference's ``_drop`` draws both
from one key.

Parallel layout: each module declares the reference's tensor-parallel
layout in ``pspec`` (:meth:`TransformerLM.param_pspecs`), and in a step
sharded over a mesh (``Ctx.shard``, set by ``parallel.SpmdTrainer``)
runs its rank's share with Megatron's collectives
(:mod:`~bigdl_tpu_torch.parallel.tp_ops`): column-parallel ``wq``/``wk``/
``wv``, ``w1``/``w3`` and head, row-parallel ``wo`` and ``w2``, a
vocab-sharded embedding and a vocab-parallel loss.  The flash kernels
run unchanged on the rank's ``H/tp`` heads.  ``use_ring_attention``
binds the sp ring (``parallel.ring_attention``) through
``attention_fn`` when the mesh has ``sp`` > 1, and asks for nothing
otherwise.  MoE (``moe_experts``) raises: ROADMAP queue A, item 5.

Weights are drawn from a ``torch.Generator`` seeded by ``build(seed=)``
on the CPU and then moved, so one seed gives the same weights on every
device.  The draws are not ``jax.random``'s: parity with the reference
is held on shared weights (``models.convert.from_jax_params``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from torch.utils.checkpoint import checkpoint

from ..nn.containers import Remat
from ..nn.module import Ctx, Module
from ..nn.normalization import RMSNorm
from ..ops.flash_attention import (DEFAULT_MASK_VALUE, _mask as _attn_mask,
                                   flash_attention)
from ..parallel import tp_ops


def _tp(ctx):
    """The tensor-parallel group ``(group, size, index)`` of a sharded
    step when tp > 1, else None."""
    shard = getattr(ctx, "shard", None)
    return None if shard is None else shard.tp


def _seq_offset(ctx) -> int:
    shard = getattr(ctx, "shard", None)
    return 0 if shard is None else shard.seq[0]


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_len: int = 2048
    dropout: float = 0.0
    rope_theta: float = 10000.0
    dtype: str = "float32"          # activation/compute dtype
    remat: bool = False             # per-block rematerialisation
    use_ring_attention: bool = False  # sp-sharded seq (needs mesh w/ 'sp')
    tie_embeddings: bool = False
    moe_experts: int = 0            # >0: SwitchFFN experts ('ep'-sharded)
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25

    @property
    def head_dim(self):
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads


def _rope_cos_sin(positions, d: int, theta: float, device):
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=device) / d)
    angles = positions.float()[:, None] * freqs[None, :]      # (N, D/2)
    return torch.cos(angles), torch.sin(angles)


def _rotate(x, cos, sin):
    """The interleaved rotation: pairs ``x[..., 0::2]``, ``x[..., 1::2]``."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    # re-interleave
    y = torch.stack([y1, y2], dim=-1).reshape(x.shape)
    return y.to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotary position embedding. x: (B, H, S, D), positions: (S,) global."""
    cos, sin = _rope_cos_sin(positions, x.shape[-1], theta, x.device)
    return _rotate(x, cos, sin)


def apply_rope_rows(x, positions, theta: float = 10000.0):
    """:func:`apply_rope` with a position per row: x (B, H, 1, D),
    positions (B,) — the continuous-batching decode shape, where every
    batch row (slot) sits at its own offset.  The same op sequence as
    :func:`apply_rope`, so a row here is the row ``apply_rope`` gives at
    that position."""
    cos, sin = _rope_cos_sin(positions, x.shape[-1], theta, x.device)
    return _rotate(x, cos[:, None, None, :], sin[:, None, None, :])


def _scaled_scores(q, k, head_dim: int):
    """fp32 ``q k^T / sqrt(head_dim)`` as the reference's cached attention
    computes it: a true division (a scalar divisor would let CUDA multiply
    by its reciprocal instead)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    return s / torch.full((), math.sqrt(head_dim), dtype=torch.float32,
                          device=s.device)


def _normal(shape, scale, gen):
    return torch.nn.Parameter(
        torch.randn(shape, generator=gen, dtype=torch.float32) * scale)


class TokenEmbedding(Module):
    """0-based token embedding ``(V, D)``.

    Out-of-range ids behave as the reference's ``jnp.take`` does: a
    negative id wraps once (``-1`` is row ``V-1``), and an id that is
    still outside ``[0, V)`` gives a row of NaN.

    Layout (the reference's): vocab-sharded over tp (``("tp", None)``)
    and exempt from fsdp (``fsdp_exempt``); under tp each rank looks up
    its rows and the partial rows are summed (``tp_ops.vocab_embedding``).
    """

    fsdp_exempt = True

    def __init__(self, vocab_size, d_model, gen: torch.Generator,
                 name=None):
        super().__init__(name=name)
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.pspec = {"weight": ("tp", None)}
        self.weight = _normal((vocab_size, d_model), d_model ** -0.5, gen)

    def apply(self, params, x, ctx):
        w = self.own(params)["weight"]
        tp = _tp(ctx)
        if tp is not None:
            return tp_ops.vocab_embedding(w, x, tp)
        v = w.shape[0]
        ids = x.long()
        ids = torch.where(ids < 0, ids + v, ids)
        valid = (ids >= 0) & (ids < v)
        rows = w[ids.clamp(0, v - 1)]
        return torch.where(valid[..., None], rows, float("nan"))


class MultiHeadAttention(Module):
    """Causal self-attention with RoPE + flash attention.

    ``attention_fn``, when set, replaces the attention core
    ``(q, k, v) -> o``: the seam the trainer binds the sp ring to
    (``SpmdTrainer.attach``), and ``chip_smoke.py`` the plain attention.

    Layout (Megatron's, the reference's): ``wq``/``wk``/``wv``
    column-sharded over tp (``(None, "tp")``: each rank holds ``H/tp``
    whole heads), ``wo`` row-sharded (``("tp", None)``), one all-reduce
    after ``wo``.  In a sharded step the positions are global (this
    rank's sequence block starts at ``ctx.shard.seq[0]``); with sp > 1
    and no ring, q, k and v are gathered over sp and each rank keeps its
    rows of the output.
    """

    def __init__(self, cfg: TransformerConfig, gen: torch.Generator,
                 name=None):
        super().__init__(name=name)
        self.cfg = cfg
        scale = cfg.d_model ** -0.5
        shape = (cfg.d_model, cfg.d_model)
        self.wq = _normal(shape, scale, gen)
        self.wk = _normal(shape, scale, gen)
        self.wv = _normal(shape, scale, gen)
        self.wo = _normal(shape, scale, gen)
        self.pspec = {"wq": (None, "tp"), "wk": (None, "tp"),
                      "wv": (None, "tp"), "wo": ("tp", None)}
        self.attention_fn = None

    def apply(self, params, x, ctx):
        cfg = self.cfg
        p = self.own(params)
        b, s, _ = x.shape
        dt = x.dtype
        tp = _tp(ctx)
        xin = tp_ops.copy_to_group(x, tp)
        q, k, v = (self._proj(p, xin, w) for w in ("wq", "wk", "wv"))
        positions = _seq_offset(ctx) + torch.arange(s, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        sp = None if ctx.shard is None else ctx.shard.sp
        if self.attention_fn is not None:
            o = self.attention_fn(q, k, v)
        elif sp is not None:
            o = _gathered_attention(q, k, v, sp)
        else:
            o = flash_attention(q, k, v, causal=True)
        o = o.transpose(1, 2).reshape(b, s, -1)
        return tp_ops.reduce_from_group(torch.matmul(o, p["wo"].to(dt)), tp)

    def _proj(self, p, x, w):
        """``x @ p[w]`` as (B, H, S, Dh), H the heads this rank holds."""
        b, s, _ = x.shape
        cfg = self.cfg
        y = torch.matmul(x, p[w].to(x.dtype))
        return y.reshape(b, s, -1, cfg.head_dim).transpose(1, 2)

    def apply_cached(self, params, x, cache, start: int):
        """Incremental attention: project the ``s`` new positions (global
        offsets ``start + arange(s)``), write their k/v into the
        contiguous cache at ``start`` (in place), and attend q against the
        whole cache under a global causal mask that also masks the
        unwritten rows (``kv_len = start + s``).  One path covers prompt
        prefill (s = prompt length) and decode (s = 1).  Returns
        ``(out, cache)``."""
        cfg = self.cfg
        p = self.own(params)
        b, s, _ = x.shape
        dt = x.dtype
        start = int(start)
        positions = start + torch.arange(s, device=x.device)
        q = apply_rope(self._proj(p, x, "wq"), positions, cfg.rope_theta)
        k = apply_rope(self._proj(p, x, "wk"), positions, cfg.rope_theta)
        v = self._proj(p, x, "wv")
        ck, cv = cache["k"], cache["v"]
        ck[:, :, start:start + s] = k.to(ck.dtype)
        cv[:, :, start:start + s] = v.to(cv.dtype)
        k_pos = torch.arange(ck.shape[2], device=x.device)
        s_ = _scaled_scores(q, ck, cfg.head_dim)
        mask = _attn_mask(positions, k_pos, start + s, True)
        s_ = torch.where(mask[None, None], s_, DEFAULT_MASK_VALUE)
        w_ = torch.softmax(s_, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", w_, cv.float()).to(dt)
        o = o.transpose(1, 2).reshape(b, s, cfg.d_model)
        return torch.matmul(o, p["wo"].to(dt)), cache

    # -- continuous-batching decode (a position per row) ---------------- #
    def project_qkv_rows(self, params, x, positions):
        """Projections of ONE new token per batch row at per-row offsets:
        x (B, 1, d_model), positions (B,).  Returns q, k, v, each
        (B, H, 1, Dh), with RoPE on q and k at ``positions[b]``: the
        slot-batched half of :meth:`apply_cached`, split out so that a
        paged cache can own the write and the gather in between."""
        cfg = self.cfg
        p = self.own(params)
        q = apply_rope_rows(self._proj(p, x, "wq"), positions,
                            cfg.rope_theta)
        k = apply_rope_rows(self._proj(p, x, "wk"), positions,
                            cfg.rope_theta)
        return q, k, self._proj(p, x, "wv")

    def attend_window(self, params, q, k_win, v_win, positions):
        """Single-token attention of q (B, H, 1, Dh) against a gathered
        window k_win/v_win (B, H, W, Dh): the other half of
        :meth:`apply_cached`, with its op order.  Keys at
        ``k_pos > positions[b]`` are masked; the masked V rows are set to
        0 before the value sum, since a recycled page can hold NaN and
        ``0 * NaN`` is NaN (for finite stale rows this changes nothing)."""
        cfg = self.cfg
        p = self.own(params)
        b = q.shape[0]
        dt = q.dtype
        k_pos = torch.arange(k_win.shape[2], device=q.device)
        s_ = _scaled_scores(q, k_win, cfg.head_dim)
        mask = k_pos[None, :] <= positions[:, None]            # (B, W)
        s_ = torch.where(mask[:, None, None, :], s_, DEFAULT_MASK_VALUE)
        w_ = torch.softmax(s_, dim=-1)
        v_ = torch.where(mask[:, None, :, None], v_win.float(), 0.0)
        o = torch.einsum("bhqk,bhkd->bhqd", w_, v_).to(dt)
        o = o.transpose(1, 2).reshape(b, 1, cfg.d_model)
        return torch.matmul(o, p["wo"].to(dt))


def _gathered_attention(q, k, v, sp):
    """Causal attention of this rank's sequence block when the sequence
    is split over sp without the ring: q, k and v gathered over sp (a
    reduce-scatter backward), the flash attention over the whole
    sequence, this rank's rows of the output."""
    group, size, index = sp
    s = q.shape[2]
    full = [tp_ops.gather_from_group(t, group, size, 2) for t in (q, k, v)]
    o = flash_attention(*full, causal=True)
    return o[:, :, index * s:(index + 1) * s]


class SwiGLU(Module):
    """Gated MLP: (silu(x w1) * x w3) w2; under tp ``w1``/``w3``
    column-sharded and ``w2`` row-sharded, one all-reduce after ``w2``."""

    def __init__(self, cfg: TransformerConfig, gen: torch.Generator,
                 name=None):
        super().__init__(name=name)
        self.cfg = cfg
        s_in = cfg.d_model ** -0.5
        s_out = cfg.d_ff ** -0.5
        self.w1 = _normal((cfg.d_model, cfg.d_ff), s_in, gen)
        self.w3 = _normal((cfg.d_model, cfg.d_ff), s_in, gen)
        self.w2 = _normal((cfg.d_ff, cfg.d_model), s_out, gen)
        self.pspec = {"w1": (None, "tp"), "w3": (None, "tp"),
                      "w2": ("tp", None)}

    def apply(self, params, x, ctx):
        p = self.own(params)
        dt = x.dtype
        tp = _tp(ctx)
        x = tp_ops.copy_to_group(x, tp)
        h = F.silu(torch.matmul(x, p["w1"].to(dt))) \
            * torch.matmul(x, p["w3"].to(dt))
        return tp_ops.reduce_from_group(torch.matmul(h, p["w2"].to(dt)), tp)


class TransformerBlock(Module):
    def __init__(self, cfg: TransformerConfig, gen: torch.Generator,
                 name=None):
        super().__init__(name=name)
        self.cfg = cfg
        self.norm1 = RMSNorm(cfg.d_model, name=f"{self.name}.norm1")
        self.attn = MultiHeadAttention(cfg, gen, name=f"{self.name}.attn")
        self.norm2 = RMSNorm(cfg.d_model, name=f"{self.name}.norm2")
        self.mlp = SwiGLU(cfg, gen, name=f"{self.name}.mlp")

    def apply(self, params, x, ctx):
        mask = self._keep_mask(x, ctx)
        h = x + self._drop(self.attn.apply(
            params, self.norm1.apply(params, x, ctx), ctx), mask)
        return h + self._drop(self.mlp.apply(
            params, self.norm2.apply(params, h, ctx), ctx), mask)

    def _keep_mask(self, x, ctx):
        """The block's keep mask in training with ``dropout > 0``, else
        None: one draw of ``x``'s shape (``uniform < keep``), shared by
        both sublayers as the reference's two ``_drop`` calls share one
        key (``ctx.rng(self)``).  In a sharded step the mask is drawn at
        the global (batch, sequence) shape and this rank keeps its block,
        so that the draws do not depend on the mesh."""
        rate = self.cfg.dropout
        if not ctx.training or rate <= 0.0:
            return None
        keep = 1.0 - rate
        shard = ctx.shard
        shape = x.shape if shard is None else \
            (shard.rows[2], shard.seq[2]) + tuple(x.shape[2:])
        mask = ctx.draw(self, x.device, lambda g: torch.rand(
            shape, generator=g, device=x.device) < keep)
        if shard is not None:
            mask = mask[shard.rows[0]:shard.rows[1],
                        shard.seq[0]:shard.seq[1]]
        return mask

    def _drop(self, y, mask):
        """``where(mask, y / keep, 0)`` in ``y``'s dtype (``keep`` rounded
        to it, as JAX rounds a weakly typed scalar)."""
        if mask is None:
            return y
        keep = torch.tensor(1.0 - self.cfg.dropout, dtype=y.dtype)
        return torch.where(mask, y / keep, y.new_zeros(()))

    def apply_cached(self, params, x, ctx, cache, start: int):
        a, cache = self.attn.apply_cached(
            params, self.norm1.apply(params, x, ctx), cache, start)
        h = x + a
        return h + self.mlp.apply(params, self.norm2.apply(params, h, ctx),
                                  ctx), cache

    def apply_decode(self, params, x, ctx, positions, kv_io):
        """Slot-batched single-token decode: x (B, 1, d_model), positions
        (B,).  ``kv_io(attn_name, k_new, v_new) -> (k_win, v_win)`` is the
        paged-cache seam: it writes this token's k/v rows into the cache
        and returns the gathered window, which already holds the rows
        just written (the write-then-attend order of
        :meth:`apply_cached`)."""
        h = self.norm1.apply(params, x, ctx)
        q, k, v = self.attn.project_qkv_rows(params, h, positions)
        k_win, v_win = kv_io(self.attn.name, k, v)
        h = x + self.attn.attend_window(params, q, k_win, v_win, positions)
        return h + self.mlp.apply(params, self.norm2.apply(params, h, ctx),
                                  ctx)


class LMHead(Module):
    """Final projection to vocab logits, ``(D, V)``; under tp
    column-sharded on the vocab (``(None, "tp")``), each rank's logits
    its block of the vocab."""

    def __init__(self, cfg: TransformerConfig, gen: torch.Generator,
                 name=None):
        super().__init__(name=name)
        self.cfg = cfg
        self.weight = _normal((cfg.d_model, cfg.vocab_size),
                              cfg.d_model ** -0.5, gen)
        self.pspec = {"weight": (None, "tp")}

    def apply(self, params, x, ctx):
        x = tp_ops.copy_to_group(x, _tp(ctx))
        return torch.matmul(x, self.own(params)["weight"].to(x.dtype))


class TransformerLM(Module):
    """Decoder-only causal LM. tokens (B, S) int -> logits (B, S, V) fp32."""

    def __init__(self, cfg: TransformerConfig,
                 gen: Optional[torch.Generator] = None, name=None):
        super().__init__(name=name)
        if cfg.moe_experts:
            raise NotImplementedError(
                "TransformerLM: moe_experts (SwitchFFN over an 'ep' axis) is "
                "not ported yet (ROADMAP queue A, item 5)")
        self.cfg = cfg
        # nn.Remat wrappers of the blocks, made at the first apply_trunk
        # (a plain list: not registered, so no parameter is listed twice)
        self._remat_blocks = None
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.embed = TokenEmbedding(cfg.vocab_size, cfg.d_model, gen,
                                    name=f"{self.name}.embed")
        self.blocks = torch.nn.ModuleList(
            [TransformerBlock(cfg, gen, name=f"{self.name}.block{i}")
             for i in range(cfg.n_layers)])
        self.final_norm = RMSNorm(cfg.d_model,
                                  name=f"{self.name}.final_norm")
        self.head = None if cfg.tie_embeddings else \
            LMHead(cfg, gen, name=f"{self.name}.head")

    def apply_trunk(self, params, x, ctx):
        """Everything up to (and including) the final norm: (B, S) int ->
        hidden states (B, S, d_model) in cfg.dtype."""
        h = self.embed.apply(params, x, ctx)
        h = h.to(getattr(torch, self.cfg.dtype))
        if self.cfg.remat and self._remat_blocks is None:
            # after the model is built, so that the wrappers' uids never
            # shift the model's own auto names
            self._remat_blocks = [Remat(b) for b in self.blocks]
        for blk in (self._remat_blocks if self.cfg.remat else self.blocks):
            h = blk.apply(params, h, ctx)
        return self.final_norm.apply(params, h, ctx)

    def head_logits(self, params, h, ctx):
        """Vocab projection of trunk hiddens (dtype preserved)."""
        if self.head is not None:
            return self.head.apply(params, h, ctx)
        w = params[self.embed.name]["weight"]            # (V, D) tied
        h = tp_ops.copy_to_group(h, _tp(ctx))
        return torch.matmul(h, w.t().to(h.dtype))

    def apply(self, params, x, ctx):
        h = self.apply_trunk(params, x, ctx)
        return self.head_logits(params, h, ctx).float()

    def token_nll(self, params, tokens, targets, *, ignore_index=-1,
                  loss_chunk=None, training=False, generator=None, ctx=None):
        """(sum of masked token NLLs, valid-token count), the head and the
        loss over the whole sequence, or with ``loss_chunk`` a chunk at a
        time (:func:`chunked_token_nll`: the same per-token log-sum-exp,
        summed over chunks in order).  ``generator`` feeds dropout's
        draws in training (the reference's ``rng``)."""
        if ctx is None:
            ctx = Ctx(state={}, training=training, generator=generator)
        h = self.apply_trunk(params, tokens, ctx)
        tp = _tp(ctx)
        if not loss_chunk or loss_chunk >= h.shape[1]:
            logits = self.head_logits(params, h, ctx).float()
            return lm_token_nll(logits, targets, ignore_index, tp=tp)
        head_ctx = Ctx(state={}, training=ctx.training, shard=ctx.shard)
        return chunked_token_nll(
            lambda h_c: self.head_logits(params, h_c, head_ctx),
            h, targets, loss_chunk, ignore_index, tp=tp)

    def loss(self, params, tokens, targets, *, ignore_index=-1,
             loss_chunk=None, training=False, generator=None, ctx=None):
        """Mean masked token cross-entropy (see :meth:`token_nll`)."""
        tot, cnt = self.token_nll(params, tokens, targets,
                                  ignore_index=ignore_index,
                                  loss_chunk=loss_chunk, training=training,
                                  generator=generator, ctx=ctx)
        return tot / torch.clamp(cnt, min=1.0)

    def param_pspecs(self, params):
        """The layout of ``params``: ``{module: {key: spec}}``, a spec a
        tuple of axis names (or None) a dim, as the modules declare it in
        ``pspec``; ``()`` (replicated) for the rest.  The trainer layers
        fsdp on top (``parallel.spmd``)."""
        by_name = {m.name: m for m in self.modules()
                   if isinstance(m, Module)}
        specs = {}
        for mod_name, sub in params.items():
            ps = getattr(by_name.get(mod_name), "pspec", {})
            specs[mod_name] = {k: tuple(ps.get(k, ())) for k in sub}
        return specs

    # -- generation (kv cache) ----------------------------------------- #
    def _device(self) -> torch.device:
        return self.embed.weight.device

    def init_cache(self, batch: int, dtype=None, cache_len=None):
        """Contiguous kv cache of zeros on the model's device, one entry per
        block keyed by the attention module's name: ``{name: {"k", "v"}}``,
        each (batch, H, cache_len, Dh).  ``cache_len`` defaults to
        max_len; ``generate`` sizes it to prompt + new."""
        cfg = self.cfg
        dt = _torch_dtype(dtype or cfg.dtype)
        shape = (batch, cfg.n_heads, int(cache_len or cfg.max_len),
                 cfg.head_dim)
        dev = self._device()
        return {blk.attn.name: {"k": torch.zeros(shape, dtype=dt, device=dev),
                                "v": torch.zeros(shape, dtype=dt, device=dev)}
                for blk in self.blocks}

    def apply_with_cache(self, params, tokens, cache, start: int):
        """Logits for ``tokens`` (B, s) written at global offset ``start``
        into ``cache`` (in place): ``(logits fp32 (B, s, V), cache)``."""
        ctx = Ctx(state={}, training=False)
        h = self.embed.apply(params, tokens, ctx).to(
            _torch_dtype(self.cfg.dtype))
        for blk in self.blocks:
            h, cache[blk.attn.name] = blk.apply_cached(
                params, h, ctx, cache[blk.attn.name], start)
        h = self.final_norm.apply(params, h, ctx)
        return self.head_logits(params, h, ctx).float(), cache

    def decode_tokens(self, params, tokens, positions, kv_io):
        """Continuous-batching decode core: one new token per slot.
        ``tokens`` (B,) are each slot's latest token, ``positions`` (B,)
        its global index (the slot's current length), and ``kv_io`` the
        paged-cache seam of :meth:`TransformerBlock.apply_decode`.
        Returns fp32 logits (B, V) for each slot's next position; every
        row advances at its own offset."""
        ctx = Ctx(state={}, training=False)
        h = self.embed.apply(params, tokens[:, None], ctx).to(
            _torch_dtype(self.cfg.dtype))
        for blk in self.blocks:
            h = blk.apply_decode(params, h, ctx, positions, kv_io)
        h = self.final_norm.apply(params, h, ctx)
        return self.head_logits(params, h, ctx)[:, 0].float()

    def _prompt(self, prompt) -> torch.Tensor:
        if isinstance(prompt, torch.Tensor):
            return prompt.to(device=self._device(), dtype=torch.int32)
        return torch.from_numpy(np.asarray(prompt, np.int32)).to(
            self._device())

    def _check_len(self, s0: int, max_new_tokens: int):
        if s0 + max_new_tokens > self.cfg.max_len:
            raise ValueError(
                f"prompt({s0}) + max_new_tokens({max_new_tokens}) exceeds "
                f"max_len={self.cfg.max_len}")

    @torch.inference_mode()
    def generate(self, params, prompt, max_new_tokens: int,
                 temperature: float = 0.0,
                 rng: Union[None, int, torch.Generator] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 params_transform=None):
        """Autoregressive decode with a kv cache: one prefill of the
        prompt, then one single-token step per new token.  Temperature 0
        is greedy (argmax, ties to the lower id); otherwise softmax
        sampling after the ``top_k`` / ``top_p`` (nucleus) filters, with
        Gumbel noise from ``rng`` (a seed or a ``torch.Generator`` on the
        model's device; seed 0 when None).  ``params_transform`` maps the
        params before the first step.  Returns int32 (B, prompt + new)
        on the model's device."""
        prompt = self._prompt(prompt)
        b, s0 = prompt.shape
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if max_new_tokens < 1:
            return prompt
        self._check_len(s0, max_new_tokens)
        if params_transform is not None:
            params = params_transform(params)
        gen = None
        if temperature > 0.0:
            gen = rng if isinstance(rng, torch.Generator) else \
                torch.Generator(device=self._device()).manual_seed(
                    int(rng or 0))

        def select(logits_last):
            if gen is None:
                return torch.argmax(logits_last, dim=-1).int()
            return gumbel_sample(_filter_logits(logits_last / temperature,
                                                top_k, top_p), gen)

        cache = self.init_cache(b, cache_len=s0 + max_new_tokens)
        logits, cache = self.apply_with_cache(params, prompt, cache, 0)
        out = [select(logits[:, -1])]
        for i in range(max_new_tokens - 1):
            # the last token sits at position s0 + i: write it there and
            # pick position s0 + i + 1's token
            lg, cache = self.apply_with_cache(params, out[-1][:, None],
                                              cache, s0 + i)
            out.append(select(lg[:, -1]))
        return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)

    @torch.inference_mode()
    def generate_beam(self, params, prompt, max_new_tokens: int,
                      beam_size: int = 4, eos_id: Optional[int] = None,
                      length_penalty: float = 0.0):
        """Beam-search decode with the kv cache.

        Keeps ``beam_size`` hypotheses per sequence: the cache runs at
        batch B*beam and is gathered along the beam dim after each step's
        top-k over (beam x vocab) continuations, ties to the lower flat
        index as ``lax.top_k`` breaks them.  Beams that emit ``eos_id``
        freeze (score stops accumulating, eos repeats).  Returns
        ``(tokens int32 (B, s0+new), scores (B,))`` of the best
        hypothesis; scores are summed token log-probs /
        (length ** length_penalty)."""
        cfg = self.cfg
        prompt = self._prompt(prompt)
        b, s0 = prompt.shape
        dev = prompt.device
        if not 1 <= beam_size <= cfg.vocab_size:
            raise ValueError(f"beam_size must be in [1, vocab_size], "
                             f"got {beam_size}")
        if max_new_tokens < 1:
            return prompt, torch.zeros((b,), dtype=torch.float32, device=dev)
        self._check_len(s0, max_new_tokens)
        K = int(beam_size)
        cache = self.init_cache(b, cache_len=s0 + max_new_tokens)
        logits, cache = self.apply_with_cache(params, prompt, cache, 0)
        logp0 = torch.log_softmax(logits[:, -1], dim=-1)          # (B, V)
        V = logp0.shape[-1]
        scores, tok0 = _top_k(logp0, K)                           # (B, K)
        cache = {n: {kk: c.repeat_interleave(K, dim=0)
                     for kk, c in sub.items()} for n, sub in cache.items()}
        tok = tok0.reshape(b * K).int()
        alive = (tok0 != eos_id) if eos_id is not None else None
        lengths = torch.ones((b, K), dtype=torch.float32, device=dev)
        if alive is not None:
            frozen = torch.full((V,), -math.inf, device=dev)
            frozen[eos_id] = 0.0
        base_rows = torch.arange(b, device=dev)[:, None] * K
        toks, srcs = [], []
        for i in range(max_new_tokens - 1):
            # `tok` sits at position s0 + i: write it there, then score
            # the candidates for position s0 + i + 1
            lg, cache = self.apply_with_cache(params, tok[:, None], cache,
                                              s0 + i)
            logp = torch.log_softmax(lg[:, 0], dim=-1).reshape(b, K, V)
            if alive is not None:
                # finished beams may only emit eos again, at score 0
                logp = torch.where(alive[..., None], logp,
                                   frozen[None, None, :])
            total = scores[..., None] + logp                       # (B,K,V)
            scores, flat_idx = _top_k(total.reshape(b, K * V), K)
            src_beam = flat_idx // V
            new_tok = (flat_idx % V).int()
            rows = (base_rows + src_beam).reshape(b * K)
            cache = {n: {kk: c.index_select(0, rows)
                         for kk, c in sub.items()}
                     for n, sub in cache.items()}
            lengths = torch.gather(lengths, 1, src_beam)
            if alive is not None:
                parent_alive = torch.gather(alive, 1, src_beam)
                # a frozen beam's repeated eos does not count as length
                lengths = lengths + parent_alive.float()
                alive = parent_alive & (new_tok != eos_id)
            else:
                lengths = lengths + 1.0
            tok = new_tok.reshape(b * K)
            toks.append(new_tok)
            srcs.append(src_beam)
        norm = scores
        if length_penalty:
            norm = scores / (torch.clamp(lengths, min=1.0) ** length_penalty)
        best = torch.argmax(norm, dim=-1)                          # (B,)
        # backtrack: follow the src_beam pointers from the best final beam
        beam, rev = best, []
        for sr, tk in zip(reversed(srcs), reversed(toks)):
            rev.append(torch.gather(tk, 1, beam[:, None])[:, 0])
            beam = torch.gather(sr, 1, beam[:, None])[:, 0]
        first_tok = torch.gather(tok0, 1, beam[:, None]).int()
        seq = torch.cat([prompt, first_tok]
                        + [t[:, None] for t in reversed(rev)], dim=1)
        best_score = torch.gather(norm, 1, best[:, None])[:, 0]
        return seq, best_score


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _top_k(x, k: int):
    """``lax.top_k`` over the last dim: the k largest values in descending
    order, equal values in ascending index order (a stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _filter_logits(lg, top_k: Optional[int], top_p: Optional[float]):
    """The reference's ``top_k`` then ``top_p`` filters: logits outside
    them become -inf."""
    if top_k is not None and top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, -math.inf, lg)
    if top_p is not None and 0.0 < top_p < 1.0:
        # nucleus: keep the smallest prefix of the sorted probs whose mass
        # reaches top_p (the top token always survives)
        srt = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, srt, math.inf).amin(dim=-1, keepdim=True)
        lg = torch.where(lg < cutoff, -math.inf, lg)
    return lg


def gumbel_sample(logits, gen: torch.Generator):
    """One draw per row from softmax(logits): the Gumbel-max trick with
    uniforms from ``gen`` (no host sync)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).int()


def chunked_token_nll(head_fn, h, targets, loss_chunk: int,
                      ignore_index: int = -1, tp=None):
    """(total masked NLL, valid count) with the vocab projection done a
    sequence chunk at a time, each chunk's head and log-sum-exp under
    ``torch.utils.checkpoint`` (non-reentrant), so that the backward
    recomputes a chunk's logits instead of keeping all (B, S, V) of them:
    at most (B, loss_chunk, V) fp32 logits live at once.

    ``head_fn(h_chunk) -> logits_chunk`` closes over the head's
    parameters.  The chunk is clamped to S (never padded up past the
    sequence); a ragged tail is padded with zero hiddens and
    ``ignore_index`` targets, so it adds nothing.  Chunks are summed in
    order from 0, as the reference's ``lax.scan`` sums them.  ``tp``: the
    logits are vocab-sharded over that group (:func:`lm_token_nll`)."""
    b, s, d = h.shape
    loss_chunk = min(int(loss_chunk), s)
    if s % loss_chunk:
        pad = loss_chunk - s % loss_chunk
        h = torch.cat([h, h.new_zeros((b, pad, d))], dim=1)
        targets = torch.cat([targets, targets.new_full((b, pad),
                                                       ignore_index)], dim=1)
        s += pad

    def chunk_nll(h_c, t_c):
        return lm_token_nll(head_fn(h_c).float(), t_c, ignore_index, tp=tp)

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, loss_chunk):
        t_i, c_i = checkpoint(chunk_nll, h[:, i:i + loss_chunk],
                              targets[:, i:i + loss_chunk],
                              use_reentrant=False)
        tot, cnt = tot + t_i, cnt + c_i
    return tot, cnt


def lm_token_nll(logits, targets, ignore_index: int = -1, tp=None):
    """(sum of masked token NLLs, valid-token count): the reference's
    ``clip(targets, 0, V-1)`` gather and ``targets != ignore_index``
    mask, in fp32.  With ``tp`` (a group ``(group, size, index)``) the
    logits are this rank's block of the vocab, and the log-sum-exp and
    the gold logit are reduced over the group
    (:func:`~bigdl_tpu_torch.parallel.tp_ops.vocab_parallel_nll`)."""
    if tp is not None:
        return tp_ops.vocab_parallel_nll(logits, targets, tp, ignore_index)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = targets.long().clamp(0, logits.shape[-1] - 1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = lse - gold
    mask = (targets != ignore_index).float()
    return (nll * mask).sum(), mask.sum()


def lm_cross_entropy(logits, targets, ignore_index: int = -1):
    """Mean token cross-entropy. logits (B, S, V) fp32, targets (B, S) int."""
    total, count = lm_token_nll(logits, targets, ignore_index)
    return total / torch.clamp(count, min=1.0)


PRESETS = {
    "tiny": dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2,
                 d_ff=256, max_len=256),
    "base": dict(vocab_size=32000, d_model=768, n_heads=6, n_layers=12,
                 d_ff=3072, max_len=2048),  # head_dim 128
    "long8k": dict(vocab_size=32000, d_model=1024, n_heads=8, n_layers=16,
                   d_ff=4096, max_len=8192, remat=True,
                   use_ring_attention=True, dtype="bfloat16"),
}


def build(preset: str = "base", *, device: DeviceLike = None, seed: int = 0,
          **overrides) -> TransformerLM:
    """A TransformerLM of ``preset`` (with ``overrides``) whose weights
    are drawn from ``seed``, on ``device`` (``cuda`` unless the caller
    asks for ``"cpu"``)."""
    dev = resolve_device(device)
    cfg = TransformerConfig(**{**PRESETS[preset], **overrides})
    gen = torch.Generator().manual_seed(int(seed))
    return TransformerLM(cfg, gen).to(dev)
