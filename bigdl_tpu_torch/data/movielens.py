"""MovieLens-1M loader (≙ ``bigdl_tpu/data/movielens.py``, itself
≙ pyspark/bigdl/dataset/movielens.py; the port's own copy, so that one
codec reads the records of both packages).

Reads ml-1m/ratings.dat ("uid::mid::rating::timestamp") from a local dir;
synthesizes a deterministic rating matrix sample when absent (zero egress).

Recommendation-stream extensions (the sharded-embedding workload):

  * :func:`leave_one_out` — deterministic per-user train/eval split
    (each user's latest rating held out; ties broken by movie id);
  * :func:`rating_samples` / :func:`write_rating_shards` — turn ratings
    into ``(uid_list, mid_list, label)`` samples with a RAGGED movie-id
    list (target + recent history) and pack them into TFRecord shards
    the :class:`~bigdl_tpu_torch.data.sharded.ShardedRecordDataSet`
    streams with its exactly-once cursor protocol — ragged payloads are
    invisible to the cursor, which tracks byte records;
  * :func:`decode_sample` / :func:`padded_collate` — the pipeline hooks:
    decode yields ragged numpy id lists, the collate pads them to the
    static bucket ladder of :mod:`bigdl_tpu_torch.embedding.dedup` so warm
    streams present a finite shape set (recompile-free after warmup).
"""
from __future__ import annotations

import os
import struct

import numpy as np


def _synthetic(n_users=200, n_movies=120, n_ratings=4000, seed=0):
    rng = np.random.RandomState(seed)
    uid = rng.randint(1, n_users + 1, n_ratings)
    mid = rng.randint(1, n_movies + 1, n_ratings)
    # structured ratings: users like movies whose id mod 5 matches theirs
    base = 3.0 + ((uid % 5) == (mid % 5)) * 1.5 - ((uid % 7) == 0) * 1.0
    rating = np.clip(np.round(base + rng.randn(n_ratings) * 0.5), 1, 5)
    ts = rng.randint(9e8, 1e9, n_ratings)
    return np.stack([uid, mid, rating.astype(np.int64), ts], 1)


def read_data_sets(data_dir):
    """Returns int array [N, 4] of (userid, movieid, rating, timestamp)."""
    rating_file = os.path.join(data_dir, "ml-1m", "ratings.dat")
    if not os.path.exists(rating_file):
        return _synthetic()
    rows = []
    with open(rating_file) as f:
        for line in f:
            rows.append([int(float(v)) for v in line.strip().split("::")])
    return np.asarray(rows, np.int64)


def get_id_pairs(data_dir):
    return read_data_sets(data_dir)[:, 0:2]


def get_id_ratings(data_dir):
    return read_data_sets(data_dir)[:, 0:3]


# --------------------------------------------------------------------- #
# recommendation stream: leave-one-out split + ragged-ID samples        #
# --------------------------------------------------------------------- #
def leave_one_out(ratings):
    """Deterministic per-user split: each user's LAST rating (max
    timestamp, ties broken by movie id, then position) goes to eval,
    the rest to train.  Returns (train, eval) int64 [*, 4] arrays in
    the original row order."""
    ratings = np.asarray(ratings, np.int64)
    order = np.lexsort((np.arange(len(ratings)), ratings[:, 1],
                        ratings[:, 3], ratings[:, 0]))
    held = {}
    for i in order:          # ascending: the last seen per user wins
        held[int(ratings[i, 0])] = int(i)
    eval_mask = np.zeros(len(ratings), bool)
    eval_mask[list(held.values())] = True
    return ratings[~eval_mask], ratings[eval_mask]


def rating_samples(ratings, max_hist: int = 8, threshold: int = 4):
    """``(uid_list, mid_list, label)`` samples from a rating table.

    Per rating, in (user, timestamp) order: ``uid_list = [uid]``,
    ``mid_list = [target_mid] + up to max_hist previous mids`` (newest
    first — RAGGED, length 1..1+max_hist), ``label = 1.0`` iff rating >=
    ``threshold``.  Sample order matches the input row order, so the
    stream is deterministic."""
    ratings = np.asarray(ratings, np.int64)
    order = np.lexsort((np.arange(len(ratings)), ratings[:, 3],
                        ratings[:, 0]))
    hist = {}
    by_row = [None] * len(ratings)
    for i in order:
        uid, mid, rating = (int(ratings[i, 0]), int(ratings[i, 1]),
                            int(ratings[i, 2]))
        prev = hist.setdefault(uid, [])
        mids = [mid] + prev[:max_hist]
        by_row[i] = ([uid], mids, 1.0 if rating >= threshold else 0.0)
        prev.insert(0, mid)
    return by_row


def encode_sample(uid_list, mid_list, label) -> bytes:
    """Variable-length record: ``<f label | <i nu | nu ids | <i nm |
    nm ids`` — the ragged-ID payload shape of the cursor protocol."""
    u = [int(x) for x in uid_list]
    m = [int(x) for x in mid_list]
    return struct.pack(f"<fi{len(u)}ii{len(m)}i", float(label),
                       len(u), *u, len(m), *m)


def decode_sample(b: bytes):
    """Inverse of :func:`encode_sample`: ``((uid_arr, mid_arr), label)``
    with ragged int32 id arrays — collate pads them (a decode hook for
    ShardedRecordDataSet)."""
    label, nu = struct.unpack_from("<fi", b, 0)
    off = 8
    uids = np.frombuffer(b, "<i4", nu, off)
    (nm,) = struct.unpack_from("<i", b, off + 4 * nu)
    mids = np.frombuffer(b, "<i4", nm, off + 4 * nu + 4)
    return ((uids.astype(np.int32), mids.astype(np.int32)),
            np.float32(label))


def write_rating_shards(out_dir, ratings=None, n_files: int = 4,
                        max_hist: int = 8, threshold: int = 4):
    """Pack ratings (default: the synthetic table) into ``n_files``
    TFRecord shards of ragged-ID samples; returns the shard paths.
    Samples are dealt round-robin so every shard sees every user mix."""
    from ..utils.tfrecord import write_tfrecords
    if ratings is None:
        ratings = _synthetic()
    samples = rating_samples(ratings, max_hist=max_hist,
                             threshold=threshold)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for f in range(n_files):
        recs = [encode_sample(*s) for s in samples[f::n_files]]
        p = os.path.join(out_dir, f"ratings-{f:04d}.tfr")
        write_tfrecords(p, recs)
        paths.append(p)
    return paths


def padded_collate(ladder=None, min_uid_len: int = 1,
                   min_mid_len: int = 16):
    """Collate hook for the sharded pipeline: pad ragged
    ``(uid_arr, mid_arr)`` samples to the static bucket ladder and
    emit ``((uids (B, Lu), mids (B, Lm)), labels (B, 1))`` — copying,
    so the staged batch owns its memory (the pipeline's owned-buffer
    rule).  Pinning ``min_mid_len`` above the max ragged length makes
    the warm stream single-shape (zero recompiles)."""
    from ..embedding.dedup import DEFAULT_LADDER, pad_ragged
    ladder = tuple(ladder or (1, 2, 4) + tuple(DEFAULT_LADDER))

    def collate(samples):
        xs, ys = zip(*samples)
        uids = pad_ragged([u for u, _ in xs], ladder, min_len=min_uid_len)
        mids = pad_ragged([m for _, m in xs], ladder, min_len=min_mid_len)
        labels = np.asarray(ys, np.float32).reshape(-1, 1)
        return (uids, mids), labels

    return collate


def sharded_rating_dataset(paths, batch_size: int = 32, n_workers: int = 2,
                           seed: int = 7, min_mid_len: int = 16, **kw):
    """ShardedRecordDataSet over rating shards with the ragged decode +
    padded collate wired in — exactly-once and cursor-resume semantics
    come from the sharded pipeline unchanged."""
    from .sharded import ShardedRecordDataSet
    return ShardedRecordDataSet(
        paths, "tfrecord", lambda b: decode_sample(b),
        batch_size=batch_size, n_workers=n_workers, seed=seed,
        collate=padded_collate(min_mid_len=min_mid_len), **kw)
