"""Flash attention: a hand-written Hopper kernel and its plain version.

Port of ``bigdl_tpu/ops/flash_attention.py``.  Layout (B, H, S, D) as in
the reference.

  * forward on a CUDA tensor — ``csrc/flash_fwd.cu``, which replaces the
    reference's Pallas ``_fwd_kernel``.  It takes f32 or bf16 inputs and
    head dims 64 and 128, and masks the ragged tail itself, so there is
    no shape gate.  Anything else raises: a CUDA tensor goes to the
    kernel or the call fails.
  * forward on a CPU tensor — :func:`flash_forward_plain`, the blockwise
    online softmax of the reference's ``_fwd_blockwise`` written in plain
    PyTorch.  It is also what ``chip_smoke.py`` holds the kernel against
    on the card.
  * backward — not ported yet: the flash backward kernels (``_bwd_kernel_dkv``,
    ``_bwd_kernel_dq``) belong to the training slice, ROADMAP queue B.

Masking is the reference's: a key is attended iff
``k_pos < kv_len and (not causal or q_pos >= k_pos)``; masked scores take
the finite :data:`DEFAULT_MASK_VALUE`, and a row with l == 0 is treated
as l == 1.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

# Finite "minus infinity": keeps exp()/max() NaN-free for fully-masked rows.
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

KERNEL_NAME = "flash_fwd"
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)
_PLAIN_BLOCK_K = 128        # the reference's default block_k

_launch_lock = threading.Lock()
_launches = 0


class _Config(NamedTuple):
    causal: bool
    sm_scale: float
    block_k: int


def launch_count() -> int:
    """Launches of the forward kernel since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _launch_lock:
        _launches = 0


# --------------------------------------------------------------------- #
# reference (quadratic) — used by tests and tiny shapes                 #
# --------------------------------------------------------------------- #
def attention_reference(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """Naive softmax(q k^T) v with optional causal mask. (B, H, S, D)."""
    if sm_scale is None:
        sm_scale = 1.0 / np.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(sq, device=s.device)[:, None]
                >= torch.arange(sk, device=s.device)[None, :])
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


# --------------------------------------------------------------------- #
# shared blockwise math                                                 #
# --------------------------------------------------------------------- #
def _mask(q_pos, k_pos, kv_len, causal):
    """(Sq, Sk) bool attend-mask from global positions."""
    valid = (k_pos < kv_len)[None, :]
    if causal:
        valid = valid & (q_pos[:, None] >= k_pos[None, :])
    return valid


def chunk_merge(q, k_chunk, v_chunk, acc, m, l, q_pos, k_pos, kv_len,
                sm_scale, causal):
    """Merge one key/value chunk into the online-softmax accumulators.

    q: (..., Sq, D); k_chunk/v_chunk: (..., Sk, D); acc: (..., Sq, D) fp32;
    m, l: (..., Sq) fp32 running max / normaliser. Returns updated
    (acc, m, l).
    """
    s = torch.matmul(q.float(), k_chunk.float().transpose(-1, -2)) \
        * sm_scale
    s = torch.where(_mask(q_pos, k_pos, kv_len, causal), s,
                    DEFAULT_MASK_VALUE)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = corr * l + p.sum(dim=-1)
    acc_new = corr[..., None] * acc + torch.matmul(p, v_chunk.float())
    return acc_new, m_new, l_new


def finalize(acc, m, l):
    """(out, lse) from final accumulators; fully-masked rows yield 0."""
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = acc / safe_l[..., None]
    lse = m + torch.log(safe_l)
    return out, lse


def _fwd_blockwise(q, k, v, cfg: _Config):
    """Loop over key blocks. (B, H, S, D) -> (out, lse)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bk = min(cfg.block_k, sk)
    n_blocks = -(-sk // bk)
    pad = n_blocks * bk - sk
    if pad:   # pad keys out past kv_len so the position mask drops them
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    dev = q.device
    q_pos = torch.arange(sq, device=dev)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, sq), DEFAULT_MASK_VALUE, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    for j in range(n_blocks):
        # skip blocks entirely beyond the causal horizon
        if cfg.causal and j * bk > sq - 1:
            continue
        k_pos = j * bk + torch.arange(bk, device=dev)
        acc, m, l = chunk_merge(q, k[:, :, j * bk:(j + 1) * bk],
                                v[:, :, j * bk:(j + 1) * bk], acc, m, l,
                                q_pos, k_pos, sk, cfg.sm_scale, cfg.causal)
    out, lse = finalize(acc, m, l)
    return out.to(q.dtype), lse


# --------------------------------------------------------------------- #
# the Hopper kernel                                                     #
# --------------------------------------------------------------------- #
def _kernel_lib():
    lib = _build.load(KERNEL_NAME)
    fn = lib.bigdl_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 17
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, S, D)")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)} / v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash_attention: the CUDA kernel takes float32 "
                         f"or bfloat16 q/k/v of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes head_dim "
                         f"in {KERNEL_HEAD_DIMS}, got {d}")
    if sq < 1 or k.shape[2] < 1 or b * h > 65535:
        raise ValueError(f"flash_attention: unsupported shape "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")


def _fwd_cuda(q, k, v, cfg: _Config):
    """Launch ``csrc/flash_fwd.cu`` on the current stream. -> (out, lse)"""
    global _launches
    _check_kernel_inputs(q, k, v)
    # the kernel takes any (batch, head, seq) strides, but D must be dense
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    # (B, S, H, D) storage seen as (B, H, S, D): the caller's transpose
    # back to (B, S, H*D) is then a view, not a copy
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, h, sq, sk, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], float(cfg.sm_scale), int(cfg.causal),
                KERNEL_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {rc} "
                           f"(q {tuple(q.shape)} {q.dtype})")
    with _launch_lock:
        _launches += 1
    return out, lse


# --------------------------------------------------------------------- #
# public entry points                                                   #
# --------------------------------------------------------------------- #
def _config(q, causal, sm_scale) -> _Config:
    if sm_scale is None:
        sm_scale = 1.0 / np.sqrt(q.shape[-1])
    return _Config(bool(causal), float(sm_scale), _PLAIN_BLOCK_K)


def flash_forward(q, k, v, causal: bool = False,
                  sm_scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; any other device raises."""
    cfg = _config(q, causal, sm_scale)
    if q.is_cuda:
        return _fwd_cuda(q, k, v, cfg)
    if q.device.type == "cpu":
        return _fwd_blockwise(q, k, v, cfg)
    raise RuntimeError(f"flash_attention: no implementation for device "
                       f"{q.device}")


def flash_forward_plain(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) from the plain PyTorch version, on any device."""
    return _fwd_blockwise(q, k, v, _config(q, causal, sm_scale))


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_forward(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "flash_attention backward is not ported yet: the flash "
            "backward kernels (_bwd_kernel_dkv, _bwd_kernel_dq) are "
            "ROADMAP queue B items K2/K3, the training slice")


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None):
    """Fused attention. q, k, v: (batch, heads, seq, head_dim).

    The Hopper kernel for CUDA tensors, the plain blockwise version for
    CPU tensors.  The backward raises ``NotImplementedError`` until the
    training slice ports it.
    """
    return _FlashAttention.apply(q, k, v, bool(causal), sm_scale)
