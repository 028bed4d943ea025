"""Hand-written Hopper kernels for the optimizer update and their plain
PyTorch versions (≙ ``bigdl_tpu/kernels``).  The attention kernels live
in :mod:`bigdl_tpu_torch.ops.flash_attention`, as in the reference."""
from .fused_optim import fused_adam_update, fused_adam_update_plain

__all__ = ["fused_adam_update", "fused_adam_update_plain"]
