"""Normalization layers (≙ ``bigdl_tpu/nn/normalization.py``); the
serving slice needs only :class:`RMSNorm`."""
from __future__ import annotations

import torch

from .module import Module


class RMSNorm(Module):
    """RMS norm (the transformer flagship's norm), computed in fp32."""

    def __init__(self, hidden_size, eps=1e-6, name=None):
        super().__init__(name=name)
        self.hidden_size = hidden_size
        self.eps = eps
        self.weight = torch.nn.Parameter(
            torch.ones((hidden_size,), dtype=torch.float32))

    def apply(self, params, x, ctx):
        p = self.own(params)
        xf = x.float()
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                             + self.eps)
        return (y * p["weight"]).to(x.dtype)
