"""Host-side dedup / unique-ids stage for the sharded lookup exchange (≙
``bigdl_tpu/embedding/dedup.py``, the port's own copy of its numpy code).

A recommendation batch repeats hot ids heavily (head items, the same
user across interactions); shipping each occurrence over the all-to-all
wastes wire.  This stage runs on the HOST (numpy, inside the sharded pipeline's
collate, before device placement):

  * dedups each device slice's ids to a unique list,
  * pads the unique lists (and ragged per-bag lists) to a static
    **bucket ladder** — a finite set of power-of-two-ish sizes — so the
    post-warmup stream presents only a handful of shapes and stays
    recompile-free,
  * records the ``embedding/*`` dedup/padding telemetry.

Variable-length ID lists are exactly the new cursor-protocol shape: the
record stream stays byte-exact (the cursor never sees shapes), and the
collate output varies only over the ladder.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


DEFAULT_LADDER = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_ladder(n: int, ladder: Sequence[int] = DEFAULT_LADDER) -> int:
    """Smallest ladder rung >= n; past the top rung, the next multiple
    of the top rung (still a finite shape set for bounded batches)."""
    for b in ladder:
        if n <= b:
            return int(b)
    top = int(ladder[-1])
    return -(-n // top) * top


def pad_ragged(lists, ladder: Sequence[int] = DEFAULT_LADDER,
               fill: int = 0, recorder=None,
               min_len: Optional[int] = None) -> np.ndarray:
    """(B, L) int32 from B ragged id lists, L from the bucket ladder.

    ``fill=0`` matches the 1-based-id padding convention of
    :func:`bigdl_tpu_torch.embedding.sharded.dense_bag`.  Padding waste is
    reported as the fraction of emitted slots that are fill.
    """
    lens = [len(x) for x in lists]
    longest = max(lens) if lens else 1
    l = bucket_ladder(max(longest, 1, min_len or 1), ladder)
    out = np.full((len(lists), l), fill, np.int32)
    for i, ids in enumerate(lists):
        out[i, :len(ids)] = np.asarray(ids, np.int32)
    _report(recorder, n_slots=out.size, n_ids=int(sum(lens)))
    return out


def dedup_for_mesh(ids: np.ndarray, n_shards: int,
                   ladder: Sequence[int] = DEFAULT_LADDER,
                   recorder=None) -> Tuple[np.ndarray, np.ndarray]:
    """Per-device-slice unique ids for the dedup lookup path.

    ``ids``: (B, L) int32, 1-based, 0 = padding; B must divide by
    ``n_shards`` (contiguous batch blocks per device, matching
    ``P(axis)``).  Returns:

      * ``uniq`` (n_shards, U) int32 **0-based** global rows, -1 padded
        — each row is one device's unique-id list, with at least one -1
        sentinel slot (padding positions point there);
      * ``inverse`` (B, L) int32 indices into the owning device's uniq
        row.

    U comes from the bucket ladder, so warm streams reuse a small shape
    set.  Telemetry: dedup ratio (unique/total) and padding waste.
    """
    ids = np.asarray(ids, np.int32)
    b, l = ids.shape
    if b % n_shards:
        raise ValueError(f"batch {b} must divide by n_shards={n_shards}")
    lb = b // n_shards
    uniqs, invs, n_uniq_total, n_ids_total = [], [], 0, 0
    for k in range(n_shards):
        block = ids[k * lb:(k + 1) * lb].reshape(-1) - 1   # 0-based, pad=-1
        valid = block >= 0
        uniq, inv = np.unique(block[valid], return_inverse=True)
        n_uniq_total += uniq.size
        n_ids_total += int(valid.sum())
        inv_full = np.full(block.shape, uniq.size, np.int64)
        inv_full[valid] = inv           # padding -> the sentinel slot
        uniqs.append(uniq)
        invs.append(inv_full.reshape(lb, l))
    # +1 reserves the -1 sentinel slot padding positions point at
    u = bucket_ladder(max(max(q.size for q in uniqs) + 1, 1), ladder)
    uniq_out = np.full((n_shards, u), -1, np.int32)
    inv_out = np.empty((b, l), np.int32)
    for k, (q, iv) in enumerate(zip(uniqs, invs)):
        uniq_out[k, :q.size] = q
        iv = np.where(iv >= q.size, q.size, iv)   # sentinel follows uniq
        inv_out[k * lb:(k + 1) * lb] = iv
    _report(recorder, n_slots=uniq_out.size, n_ids=n_uniq_total,
            dedup_in=n_ids_total, dedup_out=n_uniq_total)
    return uniq_out, inv_out


def exchange_ids_without_dedup(ids: np.ndarray) -> int:
    """How many ids the plain path would ship (every non-pad slot)."""
    return int((np.asarray(ids) > 0).sum())


def _report(recorder, n_slots: int, n_ids: int, dedup_in: int = 0,
            dedup_out: int = 0):
    # the port has no process-wide recorder: nothing without one
    if recorder is None or not getattr(recorder, "enabled", True):
        return
    recorder.inc("embedding/pad_slots", n_slots)
    recorder.inc("embedding/pad_ids", n_ids)
    if n_slots:
        recorder.gauge("embedding/padding_waste",
                       1.0 - n_ids / float(n_slots))
    if dedup_in:
        recorder.inc("embedding/dedup_in_ids", dedup_in)
        recorder.inc("embedding/dedup_out_ids", dedup_out)
        recorder.gauge("embedding/dedup_ratio", dedup_out / float(dedup_in))
