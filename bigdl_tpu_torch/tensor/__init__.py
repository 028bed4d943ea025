"""Tensor utilities (≙ ``bigdl_tpu/tensor/__init__.py``).

  * torch-style 1-based view and index helpers (``narrow``, ``select``,
    ``index_select``, ``index_add`` / ``index_copy`` / ``index_fill``,
    ``gather``, ``scatter`` / ``scatter_add``, ``masked_fill`` /
    ``masked_select``);
  * :class:`SparseTensor`, the reference's COO layout kept as it is:
    1-based ``(indices (ndim, nnz) int32, values (nnz,), shape)``, not
    ``torch.sparse``; :func:`sparse_dense_matmul`, :func:`embedding_bag`,
    :func:`sparse_concat` and :func:`sparse_dense_add` on it;
  * int8 helpers: :func:`quantize_symmetric`, :func:`dequantize` and
    :class:`QuantizedTensor` ``(q, scale, axis)``.

Every sum where an index repeats (``index_add``, ``scatter_add``, a
bag's combine, ``to_dense``, the gradient of a gather) adds in a fixed
order on the CPU and on CUDA (:mod:`._segment`), the order of the
reference's XLA scatter-add, so that two runs agree bitwise.

Out-of-range ids in :func:`embedding_bag`: ids on the host raise
``IndexError`` before anything runs; ids already on the card are clamped
for the gather (an out-of-range CUDA gather is a device-side assert, which
kills the context) and their embeddings poisoned with NaN, as the
reference's traced path does, with no host synchronisation.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._segment import (combine_bags, gather_rows, scatter_add_flat,
                       segment_sum)

__all__ = ["narrow", "select", "index_select", "index_add", "index_copy",
           "index_fill", "gather", "scatter", "scatter_add", "masked_fill",
           "masked_select", "SparseTensor", "sparse_dense_matmul",
           "embedding_bag", "sparse_concat", "sparse_dense_add",
           "quantize_symmetric", "dequantize", "QuantizedTensor"]


def _as_tensor(a, like=None, dtype=None) -> torch.Tensor:
    """``a`` as a tensor, on ``like``'s device when it is given."""
    dev = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(a, torch.Tensor):
        return a.to(device=dev or a.device,
                    dtype=dtype if dtype is not None else a.dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


def _idx0(indices, like) -> torch.Tensor:
    """1-based indices as 0-based int64 on ``like``'s device."""
    return _as_tensor(indices, like, torch.int64) - 1


def _scalar(value, like) -> torch.Tensor:
    return torch.full((), value, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------- #
# torch-style helpers (tensor/DenseTensor.scala narrow/select/index)    #
# --------------------------------------------------------------------- #
def narrow(x, dim: int, index: int, size: int):
    """1-based narrow: ``size`` elements from ``index`` along ``dim``."""
    return x.narrow(dim - 1, index - 1, size)


def select(x, dim: int, index: int):
    """1-based select: index along ``dim``, dropping that dim."""
    return x.select(dim - 1, index - 1)


def index_select(x, dim: int, indices):
    """1-based index_select along ``dim``."""
    return x.index_select(dim - 1, _idx0(indices, x))


def _index_flat(x, dim: int, idx):
    """Flat positions in ``x`` of the slices ``x[..., idx[i], ...]`` along
    axis ``dim`` (0-based), in the order of a source ``(..., len(idx),
    ...)`` laid out like ``x``."""
    shape = list(x.shape)
    shape[dim] = idx.numel()
    pos = torch.arange(x.numel(), device=x.device).reshape(x.shape)
    return pos.index_select(dim, idx), shape


def index_add(x, dim: int, indices, source):
    """1-based index_add: ``x[..., indices[i], ...] += source[..., i, ...]``
    (tensor/DenseTensor.scala indexAdd); duplicates add in order."""
    idx = _idx0(indices, x)
    flat, shape = _index_flat(x, dim - 1, idx)
    src = _as_tensor(source, x).expand(shape)
    return scatter_add_flat(x, flat, src)


def index_copy(x, dim: int, indices, source):
    """1-based index_copy: ``x[..., indices[i], ...] = source[..., i, ...]``."""
    return x.index_copy(dim - 1, _idx0(indices, x),
                        _as_tensor(source, x, x.dtype))


def index_fill(x, dim: int, indices, value):
    """1-based index_fill along ``dim`` with a scalar."""
    return x.index_fill(dim - 1, _idx0(indices, x), value)


def gather(x, dim: int, index):
    """torch-style 1-based gather: ``out[i][j] = x[index[i][j]][j]`` for
    dim 1 (tensor/DenseTensor.scala gather)."""
    return torch.gather(x, dim - 1, _idx0(index, x))


def scatter(x, dim: int, index, src):
    """torch-style 1-based scatter: ``out[index[i][j]][j] = src[i][j]``
    for dim 1 (tensor/DenseTensor.scala scatter)."""
    return x.scatter(dim - 1, _idx0(index, x), _as_tensor(src, x, x.dtype))


def scatter_add(x, dim: int, index, src):
    """torch-style 1-based scatter-add; duplicates add in order."""
    idx = _idx0(index, x)
    axis = dim - 1
    grids = torch.meshgrid(*[torch.arange(s, device=x.device)
                             for s in idx.shape], indexing="ij")
    coords = [idx if a == axis else grids[a] for a in range(x.dim())]
    strides = [int(np.prod(x.shape[a + 1:])) for a in range(x.dim())]
    flat = sum(c * s for c, s in zip(coords, strides))
    return scatter_add_flat(x, flat, _as_tensor(src, x, x.dtype)
                            .expand(idx.shape))


def masked_fill(x, mask, value):
    """``x`` where ``mask`` is 0, ``value`` where it is nonzero."""
    m = _as_tensor(mask, x).to(torch.bool)
    return torch.where(m, _scalar(value, x), x)


def masked_select(x, mask):
    """The elements of ``x`` where ``mask`` is nonzero (data-dependent
    size)."""
    return x[_as_tensor(mask, x).to(torch.bool)]


# --------------------------------------------------------------------- #
# sparse (tensor/SparseTensor.scala)                                    #
# --------------------------------------------------------------------- #
class SparseTensor:
    """COO sparse tensor: ``indices`` (ndim, nnz) int32 (0-based
    coordinates, as the reference keeps them), ``values`` (nnz,), dense
    ``shape``."""

    def __init__(self, indices, values, shape: Tuple[int, ...]):
        self.values = _as_tensor(values)
        self.indices = _as_tensor(indices, self.values, torch.int32)
        self.shape = tuple(int(s) for s in shape)

    @property
    def nnz(self):
        return self.values.shape[0]

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    def to(self, device) -> "SparseTensor":
        return SparseTensor(self.indices.to(device), self.values.to(device),
                            self.shape)

    @classmethod
    def from_dense(cls, dense):
        """Host-side conversion (data-dependent nnz); the result is on
        ``dense``'s device."""
        dev = dense.device if isinstance(dense, torch.Tensor) else "cpu"
        d = dense.detach().cpu().numpy() if isinstance(dense, torch.Tensor) \
            else np.asarray(dense)
        idx = np.nonzero(d)
        return cls(torch.as_tensor(np.stack(idx).astype(np.int32),
                                   device=dev),
                   torch.as_tensor(d[idx], device=dev), d.shape)

    def _flat_index(self) -> torch.Tensor:
        strides = np.concatenate(
            [np.cumprod(self.shape[1:][::-1])[::-1], [1]]).astype(np.int64) \
            if self.ndim > 1 else np.ones(1, np.int64)
        st = torch.as_tensor(strides, device=self.device)
        return (self.indices.to(torch.int64) * st[:, None]).sum(0)

    def to_dense(self):
        """Dense tensor; duplicate coordinates add in order."""
        n = int(np.prod(self.shape))
        return segment_sum(self.values, self._flat_index(), n) \
            .reshape(self.shape)

    def row_ids(self):
        """Flattened leading-dims index per nnz (the combiners' segment
        ids), int32."""
        if self.ndim == 1:
            return torch.zeros((self.nnz,), dtype=torch.int32,
                               device=self.device)
        strides = np.concatenate(
            [np.cumprod(self.shape[1:-1][::-1])[::-1], [1]]).astype(np.int32)
        lead = self.indices[:-1]
        st = torch.as_tensor(strides, device=self.device)
        return (lead * st[:, None]).sum(0).to(torch.int32)

    # -- the reference SparseTensor's implemented surface ---------------- #
    def astype(self, dtype) -> "SparseTensor":
        return SparseTensor(self.indices, self.values.to(dtype), self.shape)

    def apply1(self, fn) -> "SparseTensor":
        """Elementwise map over the stored values (zeros stay zero)."""
        return SparseTensor(self.indices, fn(self.values), self.shape)

    def __mul__(self, scalar):
        return SparseTensor(self.indices, self.values * scalar, self.shape)

    __rmul__ = __mul__

    def __truediv__(self, scalar):
        # a true division (CUDA multiplies by the reciprocal of a Python
        # scalar divisor)
        return SparseTensor(self.indices,
                            self.values / _scalar(scalar, self.values),
                            self.shape)

    def __neg__(self):
        return SparseTensor(self.indices, -self.values, self.shape)

    def abs(self) -> "SparseTensor":
        return self.apply1(torch.abs)

    def sum(self):
        return self.values.sum()

    def num_nonzero_by_row(self):
        """nnz count per leading-dim row, int32
        (tensor/SparseTensor.scala numNonZeroByRow)."""
        n = int(np.prod(self.shape[:-1])) if self.ndim > 1 else 1
        out = torch.zeros(n, dtype=torch.int32, device=self.device)
        return out.index_add_(0, self.row_ids().to(torch.int64),
                              torch.ones(self.nnz, dtype=torch.int32,
                                         device=self.device))

    def transpose(self) -> "SparseTensor":
        """2-D transpose: swap the index rows."""
        if self.ndim != 2:
            raise ValueError("transpose needs a 2-D SparseTensor")
        return SparseTensor(self.indices.flip(0), self.values,
                            self.shape[::-1])

    t = transpose

    def narrow(self, dim: int, index: int, size: int) -> "SparseTensor":
        """1-based narrow along the leading dim (SparseTensor.scala:306);
        host-side (data-dependent nnz)."""
        if dim != 1:
            raise ValueError("SparseTensor.narrow supports dim=1 only "
                             "(like the reference)")
        lo = index - 1
        idx = self.indices.cpu().numpy()
        keep = (idx[0] >= lo) & (idx[0] < lo + size)
        new_idx = idx[:, keep].copy()
        new_idx[0] -= lo
        keep_t = torch.as_tensor(np.nonzero(keep)[0], device=self.device)
        return SparseTensor(torch.as_tensor(new_idx, device=self.device),
                            self.values.index_select(0, keep_t),
                            (size,) + self.shape[1:])

    def select(self, dim: int, index: int) -> "SparseTensor":
        """1-based row select dropping the leading dim (host-side)."""
        if dim != 1 or self.ndim < 2:
            raise ValueError("SparseTensor.select supports dim=1 on >=2-D")
        sub = self.narrow(1, index, 1)
        return SparseTensor(sub.indices[1:], sub.values, self.shape[1:])

    def __repr__(self):
        return (f"SparseTensor(shape={self.shape}, nnz={int(self.nnz)}, "
                f"dtype={self.values.dtype})")


def sparse_dense_matmul(sp: SparseTensor, dense):
    """(N, D)-sparse @ (D, K)-dense: a gather of ``dense``'s rows and a
    per-row segment sum (SparseLinear's core)."""
    if sp.ndim != 2:
        raise ValueError("sparse_dense_matmul needs a 2-D SparseTensor")
    rows, cols = sp.indices.to(torch.int64)
    contrib = sp.values[:, None] * gather_rows(dense, cols)
    return segment_sum(contrib, rows, sp.shape[0])


def _check_ids(ids: torch.Tensor, oob: torch.Tensor, n_rows: int) -> None:
    """Raise for out-of-range ids that are on the host; on a device the
    NaN poison carries the error (no synchronisation)."""
    if ids.device.type == "cpu" and bool(oob.any()):
        bad = (ids[oob][:4] + 1).tolist()
        raise IndexError(
            f"embedding_bag: ids out of range for {n_rows}-row table "
            f"(1-based, first offenders: {bad})")


def embedding_bag(weight, ids_sp: SparseTensor, per_id_weights=None,
                  combiner="sum", max_norm=-1.0):
    """Combine embedding rows per sparse-row bag: one gather and one
    segment sum (nn/LookupTableSparse.scala's per-row loop).

    ``ids_sp.values`` are 1-based ids; ``combiner`` is sum, mean or sqrtn;
    ``max_norm > 0`` l2-clips each embedding before combining.  An empty
    bag combines to zeros; a repeated id adds once per occurrence.  Out of
    range ids raise on the host and are NaN on a device (see the
    module's docstring)."""
    if combiner not in ("sum", "mean", "sqrtn"):
        raise ValueError(f"combiner must be sum|mean|sqrtn: {combiner}")
    n_rows = ids_sp.shape[0]
    v = weight.shape[0]
    rows = ids_sp.row_ids().to(torch.int64).to(weight.device)
    ids = ids_sp.values.to(torch.int64) - 1
    oob = (ids < 0) | (ids >= v)
    _check_ids(ids, oob, v)
    ids, oob = ids.to(weight.device), oob.to(weight.device)
    emb = gather_rows(weight, torch.clamp(ids, 0, v - 1))
    emb = torch.where(oob[:, None], _scalar(float("nan"), emb), emb)
    if max_norm > 0:
        norms = torch.sqrt((emb * emb).sum(-1, keepdim=True))
        emb = emb * torch.minimum(
            _scalar(1.0, emb),
            _scalar(max_norm, emb) / torch.clamp_min(norms, 1e-7))
    wts = per_id_weights.to(device=emb.device, dtype=emb.dtype) \
        if per_id_weights is not None else \
        torch.ones(emb.shape[0], dtype=emb.dtype, device=emb.device)
    return combine_bags(emb, wts, rows, n_rows, combiner)


def sparse_concat(tensors, dim: int = 2):
    """Concatenate 2-D SparseTensors along rows (1-based dim 1) or columns
    (dim 2) (tensor/SparseTensor.scala concat)."""
    if dim not in (1, 2):
        raise ValueError("sparse_concat supports dim=1 (rows) or 2 "
                         "(columns)")
    axis = dim - 1
    other = 1 - axis
    n_other = tensors[0].shape[other]
    off = 0
    idx_parts, val_parts = [], []
    for sp in tensors:
        if sp.shape[other] != n_other:
            raise ValueError("row counts must match" if dim == 2
                             else "column counts must match")
        idx = sp.indices.clone()
        idx[axis] += off
        idx_parts.append(idx)
        val_parts.append(sp.values)
        off += sp.shape[axis]
    shape = (n_other, off) if dim == 2 else (off, n_other)
    return SparseTensor(torch.cat(idx_parts, dim=1), torch.cat(val_parts),
                        shape)


def sparse_dense_add(sp: SparseTensor, dense):
    """dense + sparse -> dense (tensor/DenseTensorMath's sparse add);
    duplicates add in order after the dense value."""
    d = _as_tensor(dense, sp.values)
    return scatter_add_flat(d, sp._flat_index(), sp.values)


# --------------------------------------------------------------------- #
# int8 quantization (tensor/QuantizedTensor.scala)                      #
# --------------------------------------------------------------------- #
def quantize_symmetric(x, axis=None):
    """Symmetric per-tensor (``axis`` None) or per-axis int8 quantization:
    ``(q int8, scale)`` with ``x ≈ q * scale``."""
    x = _as_tensor(x)
    if axis is None:
        amax = x.abs().amax()
    else:
        dims = tuple(i for i in range(x.dim()) if i != axis % x.dim())
        amax = x.abs().amax(dim=dims, keepdim=True)
    # true divisions: CUDA multiplies by the reciprocal of a scalar
    scale = torch.clamp_min(amax, 1e-8) / _scalar(127.0, amax)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.to(torch.float32) * scale


class QuantizedTensor:
    """int8 values and an fp32 scale, ``x ≈ q * scale``
    (tensor/QuantizedTensor.scala); ``axis`` is the per-axis quantization
    dim (None: per tensor)."""

    def __init__(self, q, scale, axis=None):
        self.q = _as_tensor(q, dtype=torch.int8)
        self.scale = _as_tensor(scale, self.q, torch.float32)
        self.axis = axis

    @classmethod
    def quantize(cls, x, axis=None):
        q, scale = quantize_symmetric(x, axis=axis)
        return cls(q, scale, axis=axis)

    def dequantize(self):
        return dequantize(self.q, self.scale)

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def dtype(self):
        return self.q.dtype

    def __repr__(self):
        return f"QuantizedTensor(shape={tuple(self.q.shape)}, axis={self.axis})"
