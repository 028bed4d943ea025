"""TransformerLM — the flagship decoder-only LM: forward and token loss.

Port of ``bigdl_tpu/models/transformer.py``: the full-sequence forward
that the dynamic-batching ``ServingEngine`` runs (``apply`` →
``apply_trunk`` → ``head_logits``), and the masked token cross-entropy
that ``SpmdTrainer`` trains on (``loss`` → ``token_nll`` →
:func:`lm_token_nll`).  Same layout and op order as the
reference: weights are used as ``x @ w`` with ``w`` of shape
``(d_in, d_out)``, the embedding is ``(V, D)``, the head ``(D, V)``; RoPE
is the reference's *interleaved* form (pairs ``x[..., 0::2]``,
``x[..., 1::2]``); attention goes through ``ops.flash_attention`` (the
Hopper kernel on the card); the plain matmuls stay ``torch.matmul``, as
the reference leaves them to XLA.  Gradients flow through ``torch.autograd``;
attention's backward is the flash backward (the Hopper kernels on the
card).

Not ported yet (ROADMAP queue A): the kv cache / ``apply_with_cache`` /
decode / ``generate`` / beam paths, MoE (``moe_experts``), remat, ring
attention, dropout in training, and the chunked loss
(``chunked_token_nll``).  A config or an argument that asks for one of
them raises.

Weights are drawn from a ``torch.Generator`` seeded by ``build(seed=)``
on the CPU and then moved, so one seed gives the same weights on every
device.  The draws are not ``jax.random``'s: parity with the reference
is held on shared weights (``models.convert.from_jax_params``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..nn.module import Ctx, Module
from ..nn.normalization import RMSNorm
from ..ops.flash_attention import flash_attention


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


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotary position embedding. x: (B, H, S, D), positions: (S,) global."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions.float()[:, None] * freqs[None, :]      # (S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    # re-interleave
    y = torch.stack([y1, y2], dim=-1).reshape(x.shape)
    return y.to(x.dtype)


def _normal(shape, scale, gen):
    return torch.nn.Parameter(
        torch.randn(shape, generator=gen, dtype=torch.float32) * scale)


class TokenEmbedding(Module):
    """0-based token embedding ``(V, D)``.

    Out-of-range ids behave as the reference's ``jnp.take`` does: a
    negative id wraps once (``-1`` is row ``V-1``), and an id that is
    still outside ``[0, V)`` gives a row of NaN.
    """

    def __init__(self, vocab_size, d_model, gen: torch.Generator,
                 name=None):
        super().__init__(name=name)
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.weight = _normal((vocab_size, d_model), d_model ** -0.5, gen)

    def apply(self, params, x, ctx):
        w = self.own(params)["weight"]
        v = w.shape[0]
        ids = x.long()
        ids = torch.where(ids < 0, ids + v, ids)
        valid = (ids >= 0) & (ids < v)
        rows = w[ids.clamp(0, v - 1)]
        return torch.where(valid[..., None], rows, float("nan"))


class MultiHeadAttention(Module):
    """Causal self-attention with RoPE + flash attention.

    ``attention_fn``, when set, replaces the attention core
    ``(q, k, v) -> o`` — the reference's seam for ring attention; here
    ``chip_smoke.py`` uses it to run the model with the plain attention.
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
        self.attention_fn = None

    def apply(self, params, x, ctx):
        cfg = self.cfg
        p = self.own(params)
        b, s, _ = x.shape
        dt = x.dtype

        def proj(w):
            y = torch.matmul(x, w.to(dt))
            y = y.reshape(b, s, cfg.n_heads, cfg.head_dim)
            return y.transpose(1, 2)                     # (B, H, S, Dh)

        q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
        positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if self.attention_fn is not None:
            o = self.attention_fn(q, k, v)
        else:
            o = flash_attention(q, k, v, causal=True)
        o = o.transpose(1, 2).reshape(b, s, cfg.d_model)
        return torch.matmul(o, p["wo"].to(dt))


class SwiGLU(Module):
    """Gated MLP: (silu(x w1) * x w3) w2."""

    def __init__(self, cfg: TransformerConfig, gen: torch.Generator,
                 name=None):
        super().__init__(name=name)
        self.cfg = cfg
        s_in = cfg.d_model ** -0.5
        s_out = cfg.d_ff ** -0.5
        self.w1 = _normal((cfg.d_model, cfg.d_ff), s_in, gen)
        self.w3 = _normal((cfg.d_model, cfg.d_ff), s_in, gen)
        self.w2 = _normal((cfg.d_ff, cfg.d_model), s_out, gen)

    def apply(self, params, x, ctx):
        p = self.own(params)
        dt = x.dtype
        h = F.silu(torch.matmul(x, p["w1"].to(dt))) \
            * torch.matmul(x, p["w3"].to(dt))
        return torch.matmul(h, p["w2"].to(dt))


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
        if ctx.training and self.cfg.dropout > 0.0:
            raise NotImplementedError(
                "dropout in training is not ported yet (ROADMAP queue A, "
                "item 2)")
        h = x + self.attn.apply(params, self.norm1.apply(params, x, ctx),
                                ctx)
        return h + self.mlp.apply(params, self.norm2.apply(params, h, ctx),
                                  ctx)


class LMHead(Module):
    """Final projection to vocab logits, ``(D, V)``."""

    def __init__(self, cfg: TransformerConfig, gen: torch.Generator,
                 name=None):
        super().__init__(name=name)
        self.cfg = cfg
        self.weight = _normal((cfg.d_model, cfg.vocab_size),
                              cfg.d_model ** -0.5, gen)

    def apply(self, params, x, ctx):
        return torch.matmul(x, self.own(params)["weight"].to(x.dtype))


_NOT_PORTED = ("remat", "use_ring_attention", "moe_experts")


class TransformerLM(Module):
    """Decoder-only causal LM. tokens (B, S) int -> logits (B, S, V) fp32."""

    def __init__(self, cfg: TransformerConfig,
                 gen: Optional[torch.Generator] = None, name=None):
        super().__init__(name=name)
        asked = [f for f in _NOT_PORTED if getattr(cfg, f)]
        if asked:
            raise NotImplementedError(
                f"TransformerLM: {asked} not ported yet (ROADMAP queue A)")
        self.cfg = cfg
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
        for blk in self.blocks:
            h = blk.apply(params, h, ctx)
        return self.final_norm.apply(params, h, ctx)

    def head_logits(self, params, h, ctx):
        """Vocab projection of trunk hiddens (dtype preserved)."""
        if self.head is not None:
            return self.head.apply(params, h, ctx)
        w = params[self.embed.name]["weight"]            # (V, D) tied
        return torch.matmul(h, w.t().to(h.dtype))

    def apply(self, params, x, ctx):
        h = self.apply_trunk(params, x, ctx)
        return self.head_logits(params, h, ctx).float()

    def token_nll(self, params, tokens, targets, *, ignore_index=-1,
                  loss_chunk=None, training=False, ctx=None):
        """(sum of masked token NLLs, valid-token count) over the full
        sequence.  A ``loss_chunk`` smaller than the sequence (the
        reference's chunked head + loss) raises: not ported yet."""
        if loss_chunk and loss_chunk < tokens.shape[1]:
            raise NotImplementedError(
                "TransformerLM: loss_chunk (chunked_token_nll) is not "
                "ported yet (ROADMAP queue A, item 2)")
        if ctx is None:
            ctx = Ctx(state={}, training=training)
        h = self.apply_trunk(params, tokens, ctx)
        logits = self.head_logits(params, h, ctx).float()
        return lm_token_nll(logits, targets, ignore_index)

    def loss(self, params, tokens, targets, *, ignore_index=-1,
             loss_chunk=None, training=False, ctx=None):
        """Mean masked token cross-entropy (see :meth:`token_nll`)."""
        tot, cnt = self.token_nll(params, tokens, targets,
                                  ignore_index=ignore_index,
                                  loss_chunk=loss_chunk, training=training,
                                  ctx=ctx)
        return tot / torch.clamp(cnt, min=1.0)


def lm_token_nll(logits, targets, ignore_index: int = -1):
    """(sum of masked token NLLs, valid-token count): the reference's
    ``clip(targets, 0, V-1)`` gather and ``targets != ignore_index``
    mask, in fp32."""
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
