"""The port's layer library (≙ ``bigdl_tpu/nn``): the module core with
its Torch shell, and the layers the ported slices use."""
from .activation import LogSoftMax, ReLU, Tanh
from .containers import (Bottle, Concat, ConcatTable, Container, Echo,
                         Identity, MapTable, ParallelTable, Remat,
                         Sequential)
from .conv import SpaceToDepthConvolution, SpatialConvolution
from .criterion import (ClassNLLCriterion, CrossEntropyCriterion,
                        MSECriterion)
from .dropout import (Dropout, GaussianDropout, GaussianNoise,
                      GaussianSampler, SpatialDropout1D, SpatialDropout2D,
                      SpatialDropout3D)
from .elementwise import (Abs, ActivityRegularization, AddConstant, Exp,
                          Highway, L1Penalty, Log, Log1p, MulConstant,
                          NegativeEntropyPenalty, Power, Scale, Sqrt, Square)
from .fusion import fold_batchnorm
from .graph import DynamicGraph, Graph, Input, Node
from .init import (InitializationMethod, MsraFiller, Ones, RandomNormal,
                   RandomUniform, Xavier, Zeros)
from .linear import CAdd, CMul, Linear
from .module import Criterion, Ctx, Module
from .normalization import (BatchNormalization, RMSNorm,
                            SpatialBatchNormalization)
from .pooling import SpatialAveragePooling, SpatialMaxPooling
from .shape_ops import Padding, Reshape, SpatialZeroPadding, Transpose, View
from .table_ops import CAddTable

# the reference's alias spellings of Graph (nn/StaticGraph.scala; pyspark's
# Model)
StaticGraph = Graph
Model = Graph

__all__ = ["Abs", "ActivityRegularization", "AddConstant",
           "BatchNormalization", "Bottle", "CAdd", "CAddTable", "CMul",
           "ClassNLLCriterion", "Concat", "ConcatTable", "Container",
           "Criterion", "CrossEntropyCriterion", "Ctx", "Dropout",
           "DynamicGraph", "Echo", "Exp", "GaussianDropout", "GaussianNoise",
           "GaussianSampler", "Graph", "Highway", "Identity",
           "InitializationMethod", "Input", "L1Penalty", "Linear",
           "Log", "Log1p", "LogSoftMax", "MSECriterion", "MapTable", "Model",
           "Module", "MsraFiller", "MulConstant", "NegativeEntropyPenalty",
           "Node", "Ones", "Padding", "ParallelTable", "Power", "RMSNorm",
           "RandomNormal", "RandomUniform", "ReLU", "Remat", "Reshape",
           "Scale", "Sequential", "SpaceToDepthConvolution",
           "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialDropout1D", "SpatialDropout2D",
           "SpatialDropout3D", "SpatialMaxPooling", "SpatialZeroPadding",
           "Sqrt", "Square", "StaticGraph", "Tanh", "Transpose", "View",
           "Xavier", "Zeros", "fold_batchnorm"]
