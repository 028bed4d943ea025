"""TFRecord writing (≙ the writer half of ``bigdl_tpu/utils/tfrecord.py``;
the reader is :func:`bigdl_tpu_torch.data.sharded.iter_tfrecord_salvage`).

Record framing: u64 little-endian length | masked crc32c(length) | payload
| masked crc32c(payload).
"""
from __future__ import annotations

import struct

from .crc32c import masked_crc32c


def write_tfrecords(path: str, records) -> None:
    """Write ``records`` (bytes each) to ``path`` as one TFRecord file."""
    with open(path, "wb") as f:
        for r in records:
            header = struct.pack("<Q", len(r))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(r)
            f.write(struct.pack("<I", masked_crc32c(r)))


__all__ = ["write_tfrecords"]
