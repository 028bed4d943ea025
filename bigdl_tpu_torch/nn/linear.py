"""Dense layer, the learned elementwise scale and shift, and the
embedding lookup (≙ ``bigdl_tpu/nn/linear.py``): ``Linear``, ``CMul``,
``CAdd`` and ``LookupTable``."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .init import RandomNormal, RandomUniform, Xavier, Zeros, init_tensor
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


class LookupTable(Module):
    """Embedding lookup: row ``i`` of the ``(n_index, n_output)`` table for
    the 1-based index ``i``.  An index outside ``[1, n_index]`` is clamped
    into it (the reference clamps; a CUDA gather would assert).
    ``max_norm`` rescales each gathered row to at most that ``norm_type``
    norm and leaves the table as it is; with ``mask_zero`` an index equal
    to ``padding_value`` embeds to zeros.  N(0, 1) weight, drawn from
    ``gen``.

    The gather is ``F.embedding`` without its ``max_norm`` (which would
    renormalise the table in place, a registered snapshot included).  Its
    backward sums the rows of one index in a fixed order on CUDA, so two
    equal runs give equal tables."""

    def __init__(self, n_index, n_output, padding_value=0.0, max_norm=None,
                 norm_type=2.0, w_regularizer=None, mask_zero=False,
                 name=None, *, gen: torch.Generator = None):
        super().__init__(name=name)
        check_regularizers(self, w_regularizer, None)
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.mask_zero = mask_zero
        self.weight = torch.nn.Parameter(init_tensor(
            self, gen, (n_index, n_output), n_index, n_output,
            RandomNormal(0, 1)))

    def apply(self, params, x, ctx):
        w = self.own(params)["weight"]
        ids = x.to(torch.int32).long()
        out = F.embedding(torch.clamp(ids - 1, 0, self.n_index - 1), w)
        if self.max_norm is not None:
            norms = torch.linalg.vector_norm(out, ord=self.norm_type, dim=-1,
                                             keepdim=True)
            out = out * torch.clamp(
                self.max_norm / torch.clamp(norms, min=1e-7), max=1.0)
        if self.mask_zero and self.padding_value is not None:
            keep = ids != int(self.padding_value)
            out = out * keep.unsqueeze(-1).to(out.dtype)
        return out
