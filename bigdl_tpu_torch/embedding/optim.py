"""Sparse gradient application for embedding tables: touch only the rows
a batch looked up (≙ ``bigdl_tpu/embedding/optim.py``).

A dense optimizer step on a (V, D) table moves O(V·D) bytes even though a
batch touches U << V rows.  Here the gradient is a :class:`SparseRowGrad`
``(ids, values)`` that never becomes dense, and the update mirrors the
port's ``optim.optim_method`` term for term:

  * :class:`SparseSGD` updates only the touched rows with the expression
    dense SGD applies (``p - clr * g``); an untouched row's dense update
    ``p - clr * 0`` is the identity, so on unique ids the result is
    bitwise dense SGD's over ``grad.to_dense()``.
  * :class:`SparseAdam` keeps full moments (they slice on row boundaries
    for zero1, :func:`zero1_row_bounds`): untouched moments decay by
    ``β·m`` (dense's ``β·m + (1-β)·0``), touched ones run the dense
    expressions on their rows, and the table update is dense's.
    ``lazy=True`` is LazyAdam: untouched rows and moments stay as they
    are (other math, never compared with dense).

The updates write the table and the moments in place, the torch way (a
served snapshot is an owning copy, ``serving.registry.owning_copy``, so
it never shares this storage); every row is written once, in a fixed
way, so two runs agree bitwise on the card.  Within one
:class:`SparseRowGrad` the ids must be unique (-1 = padding, skipped),
which the dedup path's backward gives; :func:`combine_duplicates` folds a
duplicated gradient into that form.  The ``embedding/*`` gauge goes to the
``recorder`` handed in (none without one)."""
from __future__ import annotations

import torch

from ..tensor._segment import segment_sum


class SparseRowGrad:
    """Row-sparse table gradient: ``ids`` (N,) 0-based touched rows (-1 =
    padding, ignored), ``values`` (N, D) their gradient rows, ``n_rows``
    the dense table's height."""

    def __init__(self, ids, values, n_rows: int):
        self.values = torch.as_tensor(values)
        self.ids = torch.as_tensor(ids, device=self.values.device) \
            .to(torch.int64)
        self.n_rows = int(n_rows)

    @property
    def nnz(self):
        return self.ids.shape[0]

    def oob_ids(self):
        """ids with padding (-1) moved past the table (``n_rows``)."""
        return torch.where(self.ids >= 0, self.ids, self.n_rows)

    def to_dense(self):
        """Dense (V, D) gradient; duplicate ids add in slot order, as a
        dense backward would."""
        return segment_sum(self.values, self.ids, self.n_rows)

    @classmethod
    def from_dense(cls, grad, ids):
        """Sparse view of a dense gradient at the given unique rows."""
        ids = torch.as_tensor(ids, device=grad.device).to(torch.int64)
        vals = grad.index_select(0, torch.clamp(ids, 0, grad.shape[0] - 1))
        vals = torch.where((ids >= 0)[:, None], vals, vals.new_zeros(()))
        return cls(ids, vals, grad.shape[0])

    def wire_bytes(self):
        """Bytes this gradient ships (4-byte ids and its rows), against
        the ``n_rows * D * itemsize`` of a dense exchange."""
        return int(self.ids.numel() * 4
                   + self.values.numel() * self.values.element_size())

    def __repr__(self):
        return (f"SparseRowGrad(nnz={int(self.nnz)}, "
                f"n_rows={self.n_rows}, dim={self.values.shape[-1]})")


def combine_duplicates(grad: SparseRowGrad) -> SparseRowGrad:
    """Fold duplicate ids into per-row sums (N slots kept; the slots past
    the unique ids become -1 padding).  A row's slots add in slot order,
    the order a dense scatter-add sees, so SGD over the result stays
    bitwise dense SGD's."""
    ids, vals = grad.ids, grad.values
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=ids.device),
                       sid[1:] != sid[:-1]])
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    summed = segment_sum(vals.index_select(0, order), seg, n)
    uniq = torch.full((n,), -1, dtype=torch.int64, device=ids.device)
    uniq = uniq.index_put((seg,), sid)       # a run writes one value
    uniq = torch.where(torch.arange(n, device=ids.device) <= seg[-1], uniq,
                       -1)
    return SparseRowGrad(uniq, summed, grad.n_rows)


def touched_fraction(grad: SparseRowGrad, recorder=None) -> float:
    """Touched-rows fraction (padded slots included: the shape the update
    pays), reported as ``embedding/touched_rows_fraction`` to
    ``recorder``."""
    frac = grad.nnz / float(grad.n_rows)
    if recorder is not None and getattr(recorder, "enabled", True):
        recorder.gauge("embedding/touched_rows_fraction", frac)
    return frac


def _put_rows(dst, sel, keep, rows):
    """``dst[sel[i]] = rows[i]`` in place for the kept slots, every row
    written once in effect: a padding slot writes what the first kept slot
    writes to its row (or, with none kept, that row's own value)."""
    j = torch.argmax(keep.to(torch.int32))
    fallback = torch.where(keep.any(), rows[j], dst[sel[j]])
    dest = torch.where(keep, sel, sel[j])
    vals = torch.where(keep[:, None], rows, fallback)
    dst.index_put_((dest,), vals)


def _rows(grad: SparseRowGrad):
    keep = grad.ids >= 0
    return keep, torch.clamp(grad.ids, 0, grad.n_rows - 1)


def _clr(lr, lr_decay, step):
    # as optim_method._current_lr computes it (a device scalar)
    rate = torch.full((), lr, dtype=torch.float32, device=step.device)
    return rate / (1.0 + step * lr_decay)


class SparseSGD:
    """Touched-rows SGD, the port's ``SGD``'s plain path (learning-rate
    decay, no momentum: a velocity would decay densely, as Adam's
    moments); bitwise dense SGD over ``grad.to_dense()`` on unique ids."""

    def __init__(self, learning_rate=1e-2, lr_decay=0.0):
        self.learning_rate = float(learning_rate)
        self.lr_decay = float(lr_decay)

    def init_state(self, table):
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=table.device)}

    @torch.no_grad()
    def update(self, table, grad: SparseRowGrad, state, recorder=None):
        """Writes ``table`` in place; returns ``(table, new_state)``."""
        clr = _clr(self.learning_rate, self.lr_decay, state["step"])
        touched_fraction(grad, recorder)
        keep, sel = _rows(grad)
        rows = table.index_select(0, sel)
        step = torch.where(keep[:, None], clr * grad.values.to(table.dtype),
                           table.new_zeros(()))
        _put_rows(table, sel, keep, rows - step)
        return table, {"step": state["step"] + 1}


class SparseAdam:
    """Adam with sparse gradient application (exact mode): moments decay
    densely, gradient terms land on the touched rows, the table update is
    the port's ``Adam``'s.  ``lazy=True`` freezes untouched rows and
    moments (LazyAdam)."""

    def __init__(self, learning_rate=1e-3, lr_decay=0.0, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, lazy=False):
        self.learning_rate = float(learning_rate)
        self.lr_decay = float(lr_decay)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.epsilon = float(epsilon)
        self.lazy = bool(lazy)

    def init_state(self, table):
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=table.device),
                "m": torch.zeros_like(table), "v": torch.zeros_like(table)}

    @torch.no_grad()
    def update(self, table, grad: SparseRowGrad, state, recorder=None):
        """Writes ``table`` and the moments in place; returns ``(table,
        new_state)``."""
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        step = state["step"]
        clr = _clr(self.learning_rate, self.lr_decay, step)
        tf = (step + 1).to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.full((), b1, device=step.device), tf)
        bc2 = 1.0 - torch.pow(torch.full((), b2, device=step.device), tf)
        m, v = state["m"], state["v"]
        touched_fraction(grad, recorder)
        keep, sel = _rows(grad)
        g = grad.values.to(table.dtype)
        # the touched rows: the dense expressions on gathered rows
        m_rows = b1 * m.index_select(0, sel) + (1 - b1) * g
        v_rows = b2 * v.index_select(0, sel) + (1 - b2) * g * g
        if self.lazy:
            p_rows = table.index_select(0, sel)
            upd = p_rows - (clr * (m_rows / bc1)
                            / (torch.sqrt(v_rows / bc2) + eps))
            _put_rows(m, sel, keep, m_rows)
            _put_rows(v, sel, keep, v_rows)
            _put_rows(table, sel, keep, upd.to(table.dtype))
        else:
            # untouched moments decay (dense's β·m + (1-β)·0), so the
            # dense update below sees dense's moments
            m.mul_(b1)
            v.mul_(b2)
            _put_rows(m, sel, keep, m_rows)
            _put_rows(v, sel, keep, v_rows)
            # dense Adam's ``clr * (m / bc1) / (sqrt(v / bc2) + eps)``,
            # op for op, on two table-sized temporaries
            denom = (v / bc2).sqrt_().add_(eps)
            upd = (m / bc1).mul_(clr).div_(denom)
            del denom
            table.sub_(upd.to(table.dtype))
        return table, {"step": step + 1, "m": m, "v": v}


def zero1_row_bounds(n_rows: int, rank: int, size: int):
    """[lo, hi) rows that ``rank`` owns in the zero1 shard space: row
    ranges slice the moments exactly, so per-rank application of a
    row-range-filtered SparseRowGrad concatenates bitwise to the full
    application."""
    per = -(-n_rows // size)
    lo = min(rank * per, n_rows)
    return lo, min(lo + per, n_rows)


def slice_grad_rows(grad: SparseRowGrad, lo: int, hi: int) -> SparseRowGrad:
    """A SparseRowGrad restricted to rows in [lo, hi), rebased to the
    slice (the slots outside become -1 padding)."""
    inside = (grad.ids >= lo) & (grad.ids < hi)
    ids = torch.where(inside, grad.ids - lo, -1)
    vals = torch.where(inside[:, None], grad.values,
                       grad.values.new_zeros(()))
    return SparseRowGrad(ids, vals, hi - lo)
