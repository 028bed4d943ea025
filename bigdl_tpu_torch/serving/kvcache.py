"""Paged KV cache for continuous-batching decode
(≙ ``bigdl_tpu/serving/kvcache.py``).

The contiguous ``TransformerLM.init_cache`` layout holds ``max_len`` key
and value rows per sequence from the start: a 12-token answer beside a
900-token one strands ``max_len - 12`` rows for its whole life.  Here the
cache is a device **pool of fixed-size pages** (``page_size`` token rows
each, one pool per attention layer) plus a host allocator.  Each slot
(one running request) owns an ordered page table; a request holds
``ceil(len / page_size)`` pages and grows one page at a time as it
decodes.  The decode step never sees the allocator: it takes the tables
as a plain ``(slots, max_pages)`` int32 tensor and

  * **writes** each new token's k/v rows at
    ``(table[len // page_size], len % page_size)``, in place;
  * **gathers** each slot's pages back into a contiguous window
    ``(slots, heads, max_pages * page_size, head_dim)``.

A table entry of ``-1`` marks no page.  Torch indexing wraps ``-1`` onto
the pool's last page, as jax did (where a dead slot's write once
clobbered the live request that owned that page), so ``-1`` is never used
as an index: writes through it go to one extra **sink page** at index
``n_pages``, which takes every dropped write and which no table points
at, and gathers through it read page 0 and are replaced by zeros with a
``torch.where`` (the zero rows of a fresh contiguous cache).  Shapes stay
fixed and no row is filtered on the host, so a step never synchronises
to find its live rows.

Page tables are data, not shapes: admissions, retirements and evictions
change values only, so the decode step runs at one shape for every batch
composition.

``int8=True`` stores the pool as int8 with one fp32 scale per (page,
position, head) over head_dim (:func:`bigdl_tpu_torch.quantized.quantize_rows`
on write, :func:`~bigdl_tpu_torch.quantized.dequantize_rows` on gather),
a quarter of the fp32 bytes each step streams.

Telemetry (``kv/*``): ``kv/page_allocs`` / ``kv/page_frees`` /
``kv/evictions`` counters, ``kv/pages_in_use`` / ``kv/pool_fill`` /
``kv/peak_fill`` gauges.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..observability import Recorder
from ..quantized import dequantize_rows, quantize_rows


class PagePoolError(RuntimeError):
    """Allocator invariant violation (double free, foreign page)."""


class PagedKVCache:
    """Device page pool + host allocator + the write/gather functions.

    ``layer_names``   attention-module names (one k/v pool each)
    ``n_heads`` / ``head_dim``  per-layer KV row geometry
    ``n_pages``       pool size, in pages, shared by all slots (the sink
                      page comes on top)
    ``page_size``     token rows per page
    ``n_slots``       concurrent sequences (page-table rows)
    ``max_context``   longest sequence a slot may hold; rounded up to a
                      page multiple; fixes the gather window
                      ``max_pages_per_slot * page_size``
    ``dtype``         pool dtype of the fp path (the int8 path stores
                      int8 + fp32 scales)
    ``int8``          quantize KV rows on write, dequantize on gather
    ``device``        where the pool lives (``cuda`` unless the caller
                      passes ``"cpu"``)

    The allocator (``alloc_for`` / ``free_slot``) is guarded by one lock
    and keeps ``free + sum(owned) == n_pages`` with every page owned by at
    most one slot (:meth:`check_invariants`).
    """

    def __init__(self, layer_names: Sequence[str], *, n_heads: int,
                 head_dim: int, n_pages: int, page_size: int = 16,
                 n_slots: int = 8, max_context: int = 256,
                 dtype=torch.float32, int8: bool = False,
                 recorder: Optional[Recorder] = None,
                 device: DeviceLike = None):
        if page_size < 1 or n_pages < 1 or n_slots < 1:
            raise ValueError("page_size, n_pages and n_slots must be >= 1")
        self.device = resolve_device(device)
        self.layer_names = list(layer_names)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.n_slots = int(n_slots)
        self.max_pages_per_slot = math.ceil(max_context / page_size)
        self.max_context = self.max_pages_per_slot * self.page_size
        self.window = self.max_context
        self.dtype = dtype
        self.int8 = bool(int8)
        self.recorder = recorder if recorder is not None else Recorder()
        self._lock = threading.Lock()
        # deterministic allocation order: lowest free page first
        self._free: List[int] = list(range(self.n_pages))
        self._owned: Dict[int, List[int]] = {s: [] for s in
                                             range(self.n_slots)}
        self.tables = np.full((self.n_slots, self.max_pages_per_slot),
                              -1, np.int32)

    # -- device pool ------------------------------------------------------ #
    def init_pool(self):
        """Zeroed device pool: ``{layer: {"k", "v"[, "k_scale",
        "v_scale"]}}`` with pages laid out ``(n_pages + 1, page_size,
        n_heads, head_dim)`` (scales ``(..., 1)``); page ``n_pages`` is the
        sink."""
        shape = (self.n_pages + 1, self.page_size, self.n_heads,
                 self.head_dim)
        sshape = shape[:-1] + (1,)

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=self.device)

        def one():
            if self.int8:
                return {"k": zeros(shape, torch.int8),
                        "v": zeros(shape, torch.int8),
                        "k_scale": zeros(sshape, torch.float32),
                        "v_scale": zeros(sshape, torch.float32)}
            return {"k": zeros(shape, self.dtype),
                    "v": zeros(shape, self.dtype)}

        return {name: one() for name in self.layer_names}

    # -- host allocator --------------------------------------------------- #
    def pages_for(self, n_tokens: int) -> int:
        return math.ceil(max(int(n_tokens), 0) / self.page_size)

    def can_fit(self, n_tokens: int) -> bool:
        with self._lock:
            return self.pages_for(n_tokens) <= len(self._free)

    def alloc_for(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s table to cover ``n_tokens`` token rows.
        All-or-nothing: returns False (allocating nothing) when the free
        list cannot cover the growth; the caller then evicts or waits."""
        need_pages = self.pages_for(n_tokens)
        if need_pages > self.max_pages_per_slot:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens need {need_pages} pages "
                f"> max_pages_per_slot {self.max_pages_per_slot} "
                f"(max_context {self.max_context})")
        with self._lock:
            owned = self._owned[slot]
            grow = need_pages - len(owned)
            if grow <= 0:
                return True
            if grow > len(self._free):
                return False
            for _ in range(grow):
                page = self._free.pop(0)
                self.tables[slot, len(owned)] = page
                owned.append(page)
            self.recorder.inc("kv/page_allocs", grow)
            self._publish_gauges_locked()
            return True

    def free_slot(self, slot: int, evict: bool = False) -> int:
        """Return every page ``slot`` owns to the free list (retirement or
        eviction); its table row resets to ``-1``.  Returns the page
        count."""
        with self._lock:
            owned = self._owned[slot]
            for page in owned:
                if page in self._free:
                    raise PagePoolError(
                        f"double free: page {page} of slot {slot} is "
                        "already on the free list")
                self._free.append(page)
            n = len(owned)
            self._free.sort()
            self._owned[slot] = []
            self.tables[slot, :] = -1
            if n:
                self.recorder.inc("kv/page_frees", n)
            if evict:
                self.recorder.inc("kv/evictions")
            self._publish_gauges_locked()
            return n

    def pages_in_use(self) -> int:
        with self._lock:
            return self.n_pages - len(self._free)

    def fill(self) -> float:
        """Pool fill fraction in [0, 1], the ``kv/pool_fill`` gauge."""
        with self._lock:
            return (self.n_pages - len(self._free)) / self.n_pages

    def check_invariants(self):
        """Every page owned at most once, free + owned == n_pages, and the
        tables agree with the ledger; raises :class:`PagePoolError`."""
        with self._lock:
            seen = list(self._free)
            for slot, owned in self._owned.items():
                seen += owned
                for i, page in enumerate(owned):
                    if self.tables[slot, i] != page:
                        raise PagePoolError(
                            f"table/ledger disagree at slot {slot}[{i}]")
                if np.any(self.tables[slot, len(owned):] != -1):
                    raise PagePoolError(
                        f"slot {slot}: table entries past its pages")
            if sorted(seen) != list(range(self.n_pages)):
                raise PagePoolError(
                    f"page ledger broken: {sorted(seen)} != "
                    f"0..{self.n_pages - 1}")

    def _publish_gauges_locked(self):
        used = self.n_pages - len(self._free)
        rec = self.recorder
        rec.gauge("kv/pages_in_use", used)
        fill = used / self.n_pages
        rec.gauge("kv/pool_fill", fill)
        if fill > rec.gauge_value("kv/peak_fill", 0.0):
            rec.gauge("kv/peak_fill", fill)

    # -- write / gather on the device (fixed shapes) ---------------------- #
    def _sink(self, idx):
        """Page indices with every entry that is not a page of the pool
        (``-1``, or past the window) sent to the sink page."""
        idx = idx.long()
        return torch.where((idx < 0) | (idx >= self.n_pages), self.n_pages,
                           idx)

    def gather_window(self, layer_pool, tables):
        """``(k_win, v_win)``, each ``(slots, heads, window, head_dim)``,
        gathered from ``layer_pool`` through ``tables`` (slots,
        max_pages).  Pages concatenate in table order, so a slot's window
        is the contiguous cache an ``init_cache`` request would hold;
        ``-1`` entries read as zeros (never the sink's rows)."""
        tables = tables.long()
        have = (tables >= 0)[:, :, None, None, None]
        idx = tables.clamp(min=0)

        def one(key):
            pages = layer_pool[key][idx]              # (S, P, page, H, Dh)
            if self.int8:
                pages = dequantize_rows(pages,
                                        layer_pool[key + "_scale"][idx])
            pages = torch.where(have, pages, 0.0)
            s, p, pg, h, d = pages.shape
            return pages.permute(0, 3, 1, 2, 4).reshape(s, h, p * pg, d)

        return one("k"), one("v")

    def write_token(self, layer_pool, tables, lengths, k_new, v_new):
        """Write one new k/v row per slot into ``layer_pool`` in place, at
        ``(table[len // page], len % page)``.  ``k_new``/``v_new`` are
        ``(slots, heads, 1, head_dim)`` (``project_qkv_rows``'s output);
        a dead slot's ``-1`` page sends its row to the sink."""
        lengths = lengths.long()
        page_i = torch.clamp(lengths // self.page_size,
                             max=self.max_pages_per_slot - 1)
        pidx = torch.gather(tables.long(), 1, page_i[:, None])[:, 0]
        # a length past the window writes nowhere (the sink)
        pidx = self._sink(torch.where(
            lengths < self.max_context, pidx, -1))
        off = lengths % self.page_size
        for key, new in (("k", k_new), ("v", v_new)):
            row = new[:, :, 0, :]                     # (S, H, Dh)
            if self.int8:
                q, sc = quantize_rows(row, axis=-1)
                layer_pool[key].index_put_((pidx, off), q)
                layer_pool[key + "_scale"].index_put_((pidx, off), sc)
            else:
                layer_pool[key].index_put_(
                    (pidx, off), row.to(layer_pool[key].dtype))

    def write_prefill(self, layer_pool, table, k, v):
        """Write a contiguous prefill's k/v ``(1, heads, Lb, head_dim)``
        into the pages of ``table`` (``ceil(Lb / page_size)`` entries,
        ``-1`` past the slot's pages: those pages hold only prompt
        padding, which no mask ever exposes, so they go to the sink)."""
        pg = self.page_size
        idx = self._sink(table)
        for key, arr in (("k", k), ("v", v)):
            rows = arr[0].transpose(0, 1)             # (Lb, H, Dh)
            lb = rows.shape[0]
            n_pages = math.ceil(lb / pg)
            if lb % pg:
                rows = torch.cat([rows, rows.new_zeros(
                    (n_pages * pg - lb,) + tuple(rows.shape[1:]))])
            pages = rows.reshape(n_pages, pg, self.n_heads, self.head_dim)
            if self.int8:
                q, sc = quantize_rows(pages, axis=-1)
                layer_pool[key].index_put_((idx,), q)
                layer_pool[key + "_scale"].index_put_((idx,), sc)
            else:
                layer_pool[key].index_put_(
                    (idx,), pages.to(layer_pool[key].dtype))


__all__ = ["PagedKVCache", "PagePoolError"]
