"""Row-wise int8 quantization for the paged KV cache (≙ the
``quantize_rows`` / ``dequantize_rows`` pair of
``bigdl_tpu/quantized/__init__.py``).

Symmetric int8 with one fp32 scale per row of ``axis``: the scale is
``max(|x|) / 127`` with a floor of 1e-8 on ``max(|x|)``, values are
rounded half to even (as ``jnp.round``) and clipped to ±127.

Not ported yet (ROADMAP queue A, item 9): the rest of the reference's
``quantized`` package (``quantize``, the quantized Linear and
convolutions, activation calibration) and the registry's int8 path.
"""
from __future__ import annotations

import torch


def quantize_rows(x, axis: int = -1):
    """``(q int8, scale fp32)`` with ``scale`` kept over ``axis`` (keepdim,
    so that the dequantizing multiply broadcasts)."""
    xf = x.float()
    absmax = torch.clamp(xf.abs().amax(dim=axis, keepdim=True), min=1e-8)
    # a true division: CUDA would multiply by the reciprocal of a scalar
    scale = absmax / torch.full((), 127.0, device=xf.device)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_rows`: int8 × broadcast scale →
    ``dtype``."""
    return q.to(dtype) * scale.to(dtype)


__all__ = ["dequantize_rows", "quantize_rows"]
