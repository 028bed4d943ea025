"""Sums over rows in a fixed order, the same on the CPU and on CUDA.

On CUDA, ``index_add_``, ``index_put_(accumulate=True)`` and the backward
of ``index_select`` / ``F.embedding`` add the rows of a repeated index
with atomics, in no fixed order, so that two equal runs can differ in the
last bits.  The functions here sort the rows by their segment (a stable
sort: a segment's rows keep their order) and add each segment's rows one
after another from +0.0 (``torch.segment_reduce``, whose kernel walks a
segment sequentially on both devices); every output row is written once.
That is also the order of XLA's scatter-add on the CPU, which the
reference's ``segment_sum`` and gathers' gradients lower to.

  * :func:`segment_sum`   ``values`` rows summed per segment id;
  * :func:`gather_rows`   ``table[idx]`` whose gradient for ``table`` is
                          :func:`segment_sum` of the output's gradient;
  * :func:`scatter_add_flat`  ``base`` plus values at flat positions,
                          duplicates added in order after the base value;
  * :func:`combine_bags`  a weighted per-bag combine (sum, mean, sqrtn),
                          the one op sequence of every bag of the port.

None of them synchronises with the host."""
from __future__ import annotations

import torch


def _segment_sum(values: torch.Tensor, seg: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Rows of ``values`` summed per ``seg`` in ``[0, n)`` (others
    dropped), each segment in its rows' order, from +0.0."""
    lead = values.shape[0]
    tail = tuple(values.shape[1:])
    if lead == 0 or n == 0:
        return values.new_zeros((n,) + tail)
    flat = values.reshape(lead, -1)
    seg = seg.to(torch.int64)
    # dropped rows go to one extra segment past the end
    key = torch.where((seg >= 0) & (seg < n), seg, n)
    order = torch.argsort(key, stable=True)
    bounds = torch.searchsorted(
        key[order], torch.arange(n + 2, device=seg.device))
    lengths = bounds[1:] - bounds[:-1]
    out = torch.segment_reduce(flat.index_select(0, order), "sum",
                               lengths=lengths, unsafe=True)
    return out[:n].reshape((n,) + tail)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, seg, n):
        ctx.save_for_backward(seg)
        ctx.lead = values.shape[0]
        return _segment_sum(values, seg, n)

    @staticmethod
    def backward(ctx, grad):
        (seg,) = ctx.saved_tensors
        n = grad.shape[0]
        seg = seg.to(torch.int64)
        keep = (seg >= 0) & (seg < n)
        g = grad.index_select(0, torch.clamp(seg, 0, max(n - 1, 0)))
        g = torch.where(keep.reshape((-1,) + (1,) * (g.dim() - 1)), g,
                        torch.zeros((), dtype=g.dtype, device=g.device))
        return g, None, None


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                n: int) -> torch.Tensor:
    """``out[s] = sum of values[i] over i with seg[i] == s``, for s in
    ``[0, n)``, added in ``i`` order from +0.0; rows whose segment is out
    of range are dropped.  Differentiable in ``values`` (the gradient of a
    row is its segment's)."""
    return _SegmentSum.apply(values, seg, int(n))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return _segment_sum(grad, idx, ctx.n), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (``idx`` in range, int64) whose gradient for
    ``table`` adds the rows of a repeated index in their order."""
    return _GatherRows.apply(table, idx.to(torch.int64))


def scatter_add_flat(base: torch.Tensor, flat_idx: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """A new tensor: ``base`` with ``values[i]`` added at the flat position
    ``flat_idx[i]`` in ``i`` order after the base value (XLA's
    ``x.at[idx].add(v)``); positions no index names keep their value."""
    n = base.numel()
    flat = base.reshape(-1)
    idx = flat_idx.reshape(-1).to(torch.int64)
    seg = torch.cat([torch.arange(n, device=base.device), idx])
    summed = segment_sum(torch.cat([flat, values.reshape(-1).to(base.dtype)]),
                         seg, n)
    touched = torch.zeros(n, dtype=torch.bool, device=base.device)
    touched = touched.index_fill(0, idx, True)
    return torch.where(touched, summed, flat).reshape(base.shape)


def combine_bags(emb, wts, rows, n_bags: int, combiner: str):
    """Per-bag combine of flat per-position embeddings ``emb`` (S, D)
    weighted by ``wts`` (S,), bag ``rows`` (S,) in ``[0, n_bags)``:
    ``sum``, ``mean`` (over the weights' sum) or ``sqrtn`` (over the root
    of their squares' sum); an empty bag combines to zeros."""
    summed = segment_sum(emb * wts[:, None], rows, n_bags)
    if combiner == "sum":
        return summed
    if combiner == "mean":
        denom = segment_sum(wts[:, None], rows, n_bags)
        return summed / torch.clamp_min(denom, 1e-7)
    denom2 = segment_sum((wts * wts)[:, None], rows, n_bags)
    return summed / torch.sqrt(torch.clamp_min(denom2, 1e-7))
