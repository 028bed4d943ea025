"""Dense layer and the learned elementwise scale and shift (≙
``bigdl_tpu/nn/linear.py``): ``Linear``, ``CMul`` and ``CAdd``."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .init import RandomUniform, Xavier, Zeros, init_tensor
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


class CMul(Module):
    """x times a learned tensor of ``size`` (broadcast), drawn
    U(±1/sqrt(n)) with n its element count."""

    def __init__(self, size, name=None, *, gen: torch.Generator = None):
        super().__init__(name=name)
        self.size = tuple(size)
        n = int(np.prod(self.size))
        self.weight = torch.nn.Parameter(init_tensor(
            self, gen, self.size, n, n, RandomUniform()))

    def apply(self, params, x, ctx):
        return x * self.own(params)["weight"].to(x.dtype)


class CAdd(Module):
    """x plus a learned tensor of ``size`` (broadcast), drawn
    U(±1/sqrt(n))."""

    def __init__(self, size, b_regularizer=None, name=None, *,
                 gen: torch.Generator = None):
        super().__init__(name=name)
        check_regularizers(self, None, b_regularizer)
        self.size = tuple(size)
        n = int(np.prod(self.size))
        self.bias = torch.nn.Parameter(init_tensor(
            self, gen, self.size, n, n, RandomUniform(), kind="bias"))

    def apply(self, params, x, ctx):
        return x + self.own(params)["bias"].to(x.dtype)
