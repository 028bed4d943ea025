"""Shape buckets for static-shape serving (≙ ``bigdl_tpu/serving/buckets.py``).

Every batch is padded up to one of a small, fixed ladder of power-of-two
sizes, so any request mix lands on a shape that
:meth:`~bigdl_tpu_torch.serving.ServingEngine.warmup` has already run.
On the reference's TPU an unseen shape meant a compile measured in
seconds; on the card it means a first run (cuBLAS heuristics, the
caching allocator growing), and later a CUDA graph captured per bucket.

Powers of two keep the ladder short (log2(max_batch)+1 compiles cover
every size) while bounding pad waste below 50%; the measured waste is
the ``serving.batch_fill`` histogram.
"""
from __future__ import annotations

from typing import Tuple


class BucketLadder:
    """The fixed set of batch sizes the engine ever compiles:
    ``1, 2, 4, ..., max_batch`` (``max_batch`` is rounded up to a power
    of two).  Selection is deterministic: ``bucket_for(n)`` is the
    smallest bucket >= n, so a replayed request stream always hits the
    same executables."""

    def __init__(self, max_batch: int = 32):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = _next_pow2(max_batch)
        self.sizes: Tuple[int, ...] = tuple(
            2 ** i for i in range(self.max_batch.bit_length()))

    def bucket_for(self, n: int) -> int:
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        if n > self.max_batch:
            raise ValueError(
                f"batch size {n} exceeds max_batch {self.max_batch}; "
                "split the request upstream (ServingEngine.predict does)")
        return _next_pow2(n)

    def __iter__(self):
        return iter(self.sizes)

    def __len__(self):
        return len(self.sizes)

    def __repr__(self):
        return f"BucketLadder({list(self.sizes)})"


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1
