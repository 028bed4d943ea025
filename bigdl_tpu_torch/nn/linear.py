"""Dense layer (≙ ``bigdl_tpu/nn/linear.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .init import Xavier, Zeros, init_tensor
from .module import Module, check_regularizers


class Linear(Module):
    """y = x @ Wᵀ + b with the weight ``(out, in)``: the reference's own
    orientation for this layer (the transformer's projections are
    ``(d_in, d_out)``).  Xavier weight, zero bias, drawn from ``gen``."""

    def __init__(self, input_size, output_size, with_bias=True,
                 w_regularizer=None, b_regularizer=None, name=None, *,
                 gen: torch.Generator = None):
        super().__init__(name=name)
        check_regularizers(self, w_regularizer, b_regularizer)
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.weight = torch.nn.Parameter(init_tensor(
            self, gen, (output_size, input_size), input_size, output_size,
            Xavier()))
        if with_bias:
            self.bias = torch.nn.Parameter(init_tensor(
                self, gen, (output_size,), input_size, output_size, Zeros(),
                kind="bias"))

    def apply(self, params, x, ctx):
        p = self.own(params)
        return F.linear(x, p["weight"].to(x.dtype),
                        p["bias"].to(x.dtype) if self.with_bias else None)
