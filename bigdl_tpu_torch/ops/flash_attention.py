"""Flash attention: hand-written Hopper kernels and their plain versions.

Port of ``bigdl_tpu/ops/flash_attention.py``.  Layout (B, H, S, D) as in
the reference.

  * forward on a CUDA tensor — ``csrc/flash_fwd.cu`` (K1), which replaces
    the reference's Pallas ``_fwd_kernel``: tensor-core MMAs, three TF32
    products each for f32 (split TF32, fp32 accuracy) and bf16 products
    with P split into two bf16 halves.
  * backward on a CUDA tensor — ``csrc/flash_bwd.cu``: K2
    (``flash_bwd_dkv``, replaces ``_bwd_kernel_dkv``) writes dk and dv,
    K3 (``flash_bwd_dq``, replaces ``_bwd_kernel_dq``) writes dq, on the
    tensor cores as K1 (``csrc/flash_mma.cuh`` holds their shared helpers).
    ``delta = sum_d do * out`` stays a plain fp32 reduction in PyTorch
    between the two, as the reference leaves it to XLA.
  * the kernels take f32 or bf16 inputs and head dims 64 and 128, and mask
    the ragged tail themselves, so there is no shape gate.  Anything else
    raises: a CUDA tensor goes to the kernels or the call fails.
  * on a CPU tensor — :func:`flash_forward_plain` and
    :func:`flash_backward_plain`, the reference's blockwise
    ``_fwd_blockwise`` and ``_flash_bwd`` written in plain PyTorch.  They
    are also what ``chip_smoke.py`` holds the kernels against on the card,
    and :func:`flash_attention_plain` runs them under autograd on any
    device when called by that name.

Masking is the reference's: a key is attended iff
``k_pos < kv_len and (not causal or q_pos >= k_pos)``; masked scores take
the finite :data:`DEFAULT_MASK_VALUE`, and a row with l == 0 is treated
as l == 1.

Each wrapper counts its kernel's launches (``ops._build.count_launch``),
by kernel name: :data:`KERNELS`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

# Finite "minus infinity": keeps exp()/max() NaN-free for fully-masked rows.
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

KERNEL_NAME = "flash_fwd"
BWD_SOURCE = "flash_bwd"
KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)
_PLAIN_BLOCK_K = 128        # the reference's default block_k


class _Config(NamedTuple):
    causal: bool
    sm_scale: float
    block_k: int


def launch_count(kernel: str = KERNEL_NAME) -> int:
    """Launches of ``kernel`` (one of :data:`KERNELS`) since the last
    reset."""
    return _build.launch_counts().get(kernel, 0)


def reset_launch_count() -> None:
    """Set the counts of every kernel to 0."""
    _build.reset_launch_counts()


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


def _bwd_blockwise(q, k, v, out, lse, do, cfg: _Config):
    """The reference's blockwise ``_flash_bwd``: a loop over key blocks
    that recomputes ``p = exp(s - lse)`` from the saved ``lse``.
    -> (dq, dk, dv) in the input dtypes."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bk = min(cfg.block_k, sk)
    n_blocks = -(-sk // bk)
    pad = n_blocks * bk - sk
    if pad:   # pad keys out past kv_len so the position mask drops them
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    dev = q.device
    qf, dof = q.float(), do.float()
    delta = (dof * out.float()).sum(-1)                   # (B, H, Sq)
    q_pos = torch.arange(sq, device=dev)
    dq = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for j in range(n_blocks):
        k_c = k[:, :, j * bk:(j + 1) * bk].float()
        v_c = v[:, :, j * bk:(j + 1) * bk].float()
        k_pos = j * bk + torch.arange(bk, device=dev)
        s = torch.matmul(qf, k_c.transpose(-1, -2)) * cfg.sm_scale
        msk = _mask(q_pos, k_pos, sk, cfg.causal)
        p = torch.where(msk, torch.exp(s - lse[..., None]), 0.0)
        dvs.append(torch.matmul(p.transpose(-1, -2), dof))
        dp = torch.matmul(dof, v_c.transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * cfg.sm_scale
        dq = dq + torch.matmul(ds, k_c)
        dks.append(torch.matmul(ds.transpose(-1, -2), qf))
    dk = torch.cat(dks, dim=2)[:, :, :sk]
    dv = torch.cat(dvs, dim=2)[:, :, :sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _aligned4(t):
    """``t`` when its base and its (batch, head, seq) strides are 4-byte
    aligned, as the forward kernel's narrowest copy of a row needs;
    otherwise (only bf16 at an odd element offset or stride) a contiguous
    copy."""
    item = t.element_size()
    if t.data_ptr() % 4 == 0 and all(st * item % 4 == 0
                                     for st in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _fwd_operands(q, k, v):
    """q, k, v as the forward kernel takes them: D dense (any (batch, head,
    seq) strides) and 4-byte aligned."""
    return tuple(_aligned4(_unit_d(t)) for t in (q, k, v))


def copy_bytes(q, k, v) -> int:
    """The width of the forward kernel's copies of q, k and v tiles for
    these inputs: 16 bytes when all three and their strides are 16-byte
    aligned, else 4.  The kernel's own launcher applies the same rule
    (``bigdl_flash_fwd_copy_bytes``)."""
    q, k, v = _fwd_operands(q, k, v)
    fn = _build.load(KERNEL_NAME).bigdl_flash_fwd_copy_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 9 + [
            ctypes.c_int]
        fn.restype = ctypes.c_int
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
              *(st for t in (q, k, v) for st in t.stride()[:3]),
              KERNEL_DTYPES[q.dtype])


def _fwd_cuda(q, k, v, cfg: _Config):
    """Launch ``csrc/flash_fwd.cu`` on the current stream. -> (out, lse)"""
    _check_kernel_inputs(q, k, v)
    q, k, v = _fwd_operands(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    # (B, S, H, D) storage seen as (B, H, S, D): the caller's transpose
    # back to (B, S, H*D) is then a view, not a copy
    out = _seq_major_like(q)
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
    _build.count_launch(KERNEL_NAME)
    return out, lse


def _bwd_operands(q, k, v, do):
    """q, k, v, do as K2 and K3 take them: D dense (any (batch, head, seq)
    strides) and 4-byte aligned."""
    return tuple(_aligned4(_unit_d(t)) for t in (q, k, v, do))


def bwd_copy_bytes(q, k, v, do) -> int:
    """The width of K2's and K3's copies of q, k, v and do tiles for these
    inputs: 16 bytes when all four and their strides are 16-byte aligned,
    else 4.  The kernels' own launcher applies the same rule
    (``bigdl_flash_bwd_copy_bytes``)."""
    ts = _bwd_operands(q, k, v, do)
    fn = _build.load(BWD_SOURCE).bigdl_flash_bwd_copy_bytes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
        fn.restype = ctypes.c_int
    strides = (ctypes.c_int64 * 12)(
        *(st for t in ts for st in t.stride()[:3]))
    return fn(*(t.data_ptr() for t in ts), strides, KERNEL_DTYPES[q.dtype])


def _bwd_lib():
    lib = _build.load(BWD_SOURCE)
    dkv, dq = lib.bigdl_flash_bwd_dkv, lib.bigdl_flash_bwd_dq
    tail = [ctypes.c_int64] * 5 + [ctypes.c_void_p, ctypes.c_float,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    if dkv.argtypes is None:
        dkv.argtypes = [ctypes.c_void_p] * 8 + tail
        dkv.restype = ctypes.c_int
    if dq.argtypes is None:
        dq.argtypes = [ctypes.c_void_p] * 7 + tail
        dq.restype = ctypes.c_int
    return dkv, dq


def _unit_d(t):
    return t if t.stride(-1) == 1 else t.contiguous()


def _seq_major_like(t):
    """An empty (B, H, S, D) tensor in (B, S, H, D) storage, the layout
    the model's transpose back to (B, S, H*D) reads as a view."""
    b, h, s, d = t.shape
    return torch.empty((b, s, h, d), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


class _BwdCall(NamedTuple):
    """The arguments K2 and K3 share, prepared once per backward."""
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    do: torch.Tensor
    lse: torch.Tensor
    delta: torch.Tensor
    dq: torch.Tensor
    dk: torch.Tensor
    dv: torch.Tensor
    strides: ctypes.Array
    cfg: _Config


def _bwd_prepare(q, k, v, out, lse, do, cfg: _Config) -> _BwdCall:
    """Check the inputs, form delta and allocate dq, dk, dv."""
    _check_kernel_inputs(q, k, v)
    if do.shape != q.shape or out.shape != q.shape or \
            do.dtype != q.dtype or out.dtype != q.dtype:
        raise ValueError(f"flash_attention backward: do {tuple(do.shape)} "
                         f"{do.dtype} / out {tuple(out.shape)} {out.dtype} "
                         f"must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward: lse must be float32 "
                         f"{tuple(q.shape[:3])}, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    q, k, v, do = _bwd_operands(q, k, v, do)
    # delta = rowsum(do * out) in fp32 from the input dtype, as the
    # reference's _bwd_pallas forms it with XLA outside its kernels
    delta = (do.float() * out.float()).sum(-1).contiguous()
    dq, dk, dv = _seq_major_like(q), _seq_major_like(k), _seq_major_like(v)
    strides = (ctypes.c_int64 * 21)(
        *(st for t in (q, k, v, do, dq, dk, dv) for st in t.stride()[:3]))
    return _BwdCall(q, k, v, do, lse.contiguous(), delta, dq, dk, dv,
                    strides, cfg)


def _bwd_launch(c: _BwdCall, kernel: str) -> None:
    """Launch K2 (``"flash_bwd_dkv"``, writes dk and dv) or K3
    (``"flash_bwd_dq"``, writes dq) on the current stream."""
    dkv_fn, dq_fn = _bwd_lib()
    b, h, sq, d = c.q.shape
    ins = (c.q.data_ptr(), c.k.data_ptr(), c.v.data_ptr(), c.do.data_ptr(),
           c.lse.data_ptr(), c.delta.data_ptr())
    outs = ((c.dk.data_ptr(), c.dv.data_ptr()) if kernel == "flash_bwd_dkv"
            else (c.dq.data_ptr(),))
    fn = dkv_fn if kernel == "flash_bwd_dkv" else dq_fn
    with torch.cuda.device(c.q.device):
        stream = torch.cuda.current_stream(c.q.device).cuda_stream
        rc = fn(*ins, *outs, b, h, sq, c.k.shape[2], d, c.strides,
                float(c.cfg.sm_scale), int(c.cfg.causal),
                KERNEL_DTYPES[c.q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc} "
                           f"(q {tuple(c.q.shape)} {c.q.dtype})")
    _build.count_launch(kernel)


def _bwd_cuda(q, k, v, out, lse, do, cfg: _Config):
    """K2 then K3 of ``csrc/flash_bwd.cu``. -> (dq, dk, dv)"""
    c = _bwd_prepare(q, k, v, out, lse, do, cfg)
    _bwd_launch(c, "flash_bwd_dkv")
    _bwd_launch(c, "flash_bwd_dq")
    return c.dq, c.dk, c.dv


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


def flash_backward(q, k, v, out, lse, do, causal: bool = False,
                   sm_scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's (out, lse) and the output gradient
    ``do``: K2 and K3 for CUDA tensors, the plain version for CPU tensors;
    any other device raises."""
    cfg = _config(q, causal, sm_scale)
    if q.is_cuda:
        return _bwd_cuda(q, k, v, out, lse, do, cfg)
    if q.device.type == "cpu":
        return _bwd_blockwise(q, k, v, out, lse, do, cfg)
    raise RuntimeError(f"flash_attention: no implementation for device "
                       f"{q.device}")


def flash_backward_plain(q, k, v, out, lse, do, causal: bool = False,
                         sm_scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the plain PyTorch version, on any device."""
    return _bwd_blockwise(q, k, v, out, lse, do,
                          _config(q, causal, sm_scale))


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, plain):
        fwd = flash_forward_plain if plain else flash_forward
        out, lse = fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale, ctx.plain = causal, sm_scale, plain
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_backward_plain if ctx.plain else flash_backward
        dq, dk, dv = bwd(q, k, v, out, lse, do, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None):
    """Fused attention. q, k, v: (batch, heads, seq, head_dim).

    Forward and backward run the Hopper kernels (K1; K2 and K3) for CUDA
    tensors and the plain blockwise versions for CPU tensors.
    """
    return _FlashAttention.apply(q, k, v, bool(causal), sm_scale, False)


def flash_attention_plain(q, k, v, causal: bool = False,
                          sm_scale: Optional[float] = None):
    """:func:`flash_attention` on the plain versions, forward and
    backward, on any device: the yardstick the kernels are held to."""
    return _FlashAttention.apply(q, k, v, bool(causal), sm_scale, True)
