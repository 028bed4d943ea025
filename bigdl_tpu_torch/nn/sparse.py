"""Sparse-input layers (≙ ``bigdl_tpu/nn/sparse.py``; nn/SparseLinear.scala,
LookupTableSparse.scala, SparseJoinTable.scala).

Sparse activities are :class:`bigdl_tpu_torch.tensor.SparseTensor` s (the
reference's COO layout); every op here is a gather and a segment sum in a
fixed order (:mod:`bigdl_tpu_torch.tensor`), so the gradients repeat bit
for bit on the card."""
from __future__ import annotations

import torch

from ..tensor import (SparseTensor, embedding_bag, sparse_concat,
                      sparse_dense_matmul)
from .init import Xavier, Zeros, init_tensor
from .module import Module, check_regularizers


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


class SparseLinear(Module):
    """Linear over a 2-D SparseTensor input (nn/SparseLinear.scala:44):
    ``y = x @ W + b`` with the weight ``(input_size, output_size)``, the
    reference's orientation for this layer.  ``backward_start`` /
    ``backward_length`` are the reference's restricted grad-input window,
    kept as configuration."""

    def __init__(self, input_size, output_size, backward_start=-1,
                 backward_length=-1, with_bias=True, w_regularizer=None,
                 b_regularizer=None, name=None, *,
                 gen: torch.Generator = None):
        super().__init__(name=name)
        check_regularizers(self, w_regularizer, b_regularizer)
        self.input_size = input_size
        self.output_size = output_size
        self.backward_start = backward_start
        self.backward_length = backward_length
        self.with_bias = with_bias
        self.weight = torch.nn.Parameter(init_tensor(
            self, gen, (input_size, output_size), input_size, output_size,
            Xavier()))
        if with_bias:
            self.bias = torch.nn.Parameter(init_tensor(
                self, gen, (output_size,), input_size, output_size, Zeros(),
                kind="bias"))

    def apply(self, params, x, ctx):
        p = self.own(params)
        if not isinstance(x, SparseTensor):
            raise TypeError("SparseLinear input must be a SparseTensor")
        y = sparse_dense_matmul(x.to(p["weight"].device), p["weight"])
        if self.with_bias:
            y = y + p["bias"]
        return y


class LookupTableSparse(Module):
    """Embedding bag over sparse ids (nn/LookupTableSparse.scala:44): a
    2-D SparseTensor of 1-based ids (batch, maxlen), or ``(ids, weights)``
    with the same sparsity.  ``combiner`` is sum, mean or sqrtn;
    ``max_norm`` l2-clips each embedding before combining.  The
    single-device semantic model of
    :class:`~bigdl_tpu_torch.embedding.ShardedEmbeddingBag`."""

    def __init__(self, n_index, n_output, combiner="sum", max_norm=-1.0,
                 w_regularizer=None, name=None, *,
                 gen: torch.Generator = None):
        super().__init__(name=name)
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError(f"combiner must be sum|mean|sqrtn: {combiner}")
        check_regularizers(self, w_regularizer, None)
        self.n_index = n_index
        self.n_output = n_output
        self.combiner = combiner
        self.max_norm = max_norm
        self.weight = torch.nn.Parameter(init_tensor(
            self, gen, (n_index, n_output), n_index, n_output, Xavier()))

    def apply(self, params, x, ctx):
        w = self.own(params)["weight"]
        if isinstance(x, (list, tuple)):
            ids_sp, weights_sp = _as_list(x)[:2]
            weights = weights_sp.values
        else:
            ids_sp, weights = x, None
        if not isinstance(ids_sp, SparseTensor):
            raise TypeError("LookupTableSparse input must be a SparseTensor")
        return embedding_bag(w, ids_sp, per_id_weights=weights,
                             combiner=self.combiner, max_norm=self.max_norm)


class SparseJoinTable(Module):
    """Concatenate 2-D SparseTensors along ``dimension`` (1-based)
    (nn/SparseJoinTable.scala); dim 2 (columns) is the one batched
    sparse activities use."""

    def __init__(self, dimension=2, name=None):
        super().__init__(name=name)
        self.dimension = dimension

    def apply(self, params, x, ctx):
        return sparse_concat(_as_list(x), dim=self.dimension)
