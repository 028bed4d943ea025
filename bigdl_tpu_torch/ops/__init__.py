"""Hand-written Hopper kernels and their plain PyTorch versions
(≙ ``bigdl_tpu/ops``)."""
from . import flash_attention as flash_attention_mod  # noqa: F401
from .flash_attention import (attention_reference, flash_attention,
                              flash_attention_plain)

__all__ = ["flash_attention", "flash_attention_plain", "attention_reference",
           "flash_attention_mod"]
