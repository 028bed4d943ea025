"""CRC32C (Castagnoli) with the TFRecord masking (≙
``bigdl_tpu/utils/crc32c.py``), over the port's native runtime
(``bigdl_tpu_torch.native``): ``crc32c`` and ``masked_crc32c`` run in
C++; ``mask`` and ``unmask`` are the rotation on a finished CRC, so that
a streaming caller can chain ``crc32c`` over chunks and mask once at the
end."""
from __future__ import annotations

from .. import native

_MASK_DELTA = 0xA282EAD8


def crc32c(data: bytes, crc: int = 0) -> int:
    return native.crc32c(data, crc)


def mask(crc: int) -> int:
    """TFRecord 'masked' rotation of a raw crc."""
    return ((crc >> 15) | (crc << 17)) + _MASK_DELTA & 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord 'masked' crc (≙ tensorflow/core/lib/hash/crc32c.h Mask)."""
    return native.masked_crc32c(data)


def unmask(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF
