"""int8 embedding tables for the serving side (≙
``bigdl_tpu/embedding/serve.py``).

A serving replica never updates the table, so it can hold the rows as int8
with one fp32 scale a row (``quantized``'s row-wise scheme, the paged KV
cache's layout): 4x less device memory and 4x fewer bytes a gather, which
is the whole cost of a gather-bound lookup.  Rows are dequantized after
the gather: only the touched rows widen.  Ragged request ids pad to the
training bucket ladder (:func:`~bigdl_tpu_torch.embedding.dedup
.pad_ragged`)."""
from __future__ import annotations

from typing import Tuple

import torch

from ..quantized import dequantize_rows, quantize_rows
from ..tensor._segment import combine_bags, gather_rows
from .sharded import _check_combiner, _flatten_bags


def quantize_table(table) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V, D) float table -> (q int8 (V, D), scale fp32 (V, 1)), one
    symmetric scale a row."""
    return quantize_rows(torch.as_tensor(table), axis=-1)


def dequantize_table(q, scale, dtype=torch.float32):
    return dequantize_rows(q, scale, dtype)


def quantized_dense_bag(q, scale, ids, per_id_weights=None,
                        combiner="sum"):
    """Embedding bag over an int8 table: gather the int8 rows and their
    scales, dequantize the gathered rows, combine with
    :func:`~bigdl_tpu_torch.embedding.sharded.dense_bag`'s op sequence, so
    that the only difference from the fp32 bag is the rows' quantization
    error."""
    _check_combiner(combiner)
    ids = ids.to(q.device)
    gid, wts, rows = _flatten_bags(ids, per_id_weights)
    sel = torch.clamp(gid, 0, q.shape[0] - 1)
    emb = dequantize_rows(q.index_select(0, sel),
                          gather_rows(scale, sel))
    emb = torch.where((gid >= 0)[:, None], emb, emb.new_zeros(()))
    return combine_bags(emb, wts, rows, ids.shape[0], combiner)


def table_bytes(table) -> int:
    """Device bytes of a dense float table."""
    return int(table.numel() * table.element_size())


def quantized_table_bytes(q, scale) -> int:
    """Device bytes of the int8 table and its per-row scales."""
    return int(q.numel() * 1 + scale.numel() * 4)
