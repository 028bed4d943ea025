"""The port's layer library (≙ ``bigdl_tpu/nn``): the functional module
core and the layers the ported slices use."""
from .module import Ctx, Module
from .normalization import RMSNorm

__all__ = ["Ctx", "Module", "RMSNorm"]
