"""The port's layer library (≙ ``bigdl_tpu/nn``): the functional module
core and the layers the ported slices use."""
from .activation import LogSoftMax, ReLU, Tanh
from .containers import ConcatTable, Container, Identity, Sequential
from .conv import SpatialConvolution
from .criterion import ClassNLLCriterion, MSECriterion
from .init import (InitializationMethod, MsraFiller, Ones, RandomNormal,
                   RandomUniform, Xavier, Zeros)
from .linear import Linear
from .module import Criterion, Ctx, Module
from .normalization import (BatchNormalization, RMSNorm,
                            SpatialBatchNormalization)
from .pooling import SpatialAveragePooling, SpatialMaxPooling
from .shape_ops import Reshape, View
from .table_ops import CAddTable

__all__ = ["BatchNormalization", "CAddTable", "ClassNLLCriterion",
           "ConcatTable", "Container", "Criterion", "Ctx", "Identity",
           "InitializationMethod", "Linear", "LogSoftMax", "MSECriterion",
           "Module",
           "MsraFiller", "Ones", "RMSNorm", "RandomNormal", "RandomUniform",
           "ReLU", "Reshape", "Sequential", "SpatialAveragePooling",
           "SpatialBatchNormalization", "SpatialConvolution",
           "SpatialMaxPooling", "Tanh", "View", "Xavier", "Zeros"]
