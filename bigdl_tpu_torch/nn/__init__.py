"""The port's layer library (≙ ``bigdl_tpu/nn``): the module core with
its Torch shell, and the layers the ported slices use."""
from .activation import LogSoftMax, ReLU, Tanh
from .containers import (Bottle, Concat, ConcatTable, Container, Echo,
                         Identity, MapTable, ParallelTable, Remat,
                         Sequential)
from .conv import (SpaceToDepthConvolution, SpatialConvolution,
                   SpatialDilatedConvolution, TemporalConvolution)
from .criterion import (BCECriterion, ClassNLLCriterion,
                        CrossEntropyCriterion, MSECriterion)
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
from .linear import CAdd, CMul, Linear, LookupTable
from .module import Criterion, Ctx, Module
from .normalization import (BatchNormalization, RMSNorm,
                            SpatialBatchNormalization)
from .pooling import (SpatialAveragePooling, SpatialMaxPooling,
                      TemporalMaxPooling)
from .shape_ops import (Padding, Reshape, SpatialZeroPadding, Squeeze,
                        Transpose, View)
from .sparse import LookupTableSparse, SparseJoinTable, SparseLinear
from .table_ops import CAddTable

# the reference's alias spellings of Graph (nn/StaticGraph.scala; pyspark's
# Model)
StaticGraph = Graph
Model = Graph

__all__ = ["Abs", "ActivityRegularization", "AddConstant",
           "BatchNormalization", "BCECriterion", "Bottle", "CAdd", "CAddTable",
           "ClassNLLCriterion", "CMul", "Concat", "ConcatTable", "Container",
           "Criterion", "CrossEntropyCriterion", "Ctx", "Dropout",
           "DynamicGraph", "Echo", "Exp", "fold_batchnorm", "GaussianDropout",
           "GaussianNoise", "GaussianSampler", "Graph", "Highway", "Identity",
           "InitializationMethod", "Input", "L1Penalty", "Linear", "Log",
           "Log1p", "LogSoftMax", "LookupTable", "LookupTableSparse",
           "MapTable", "Model",
           "Module", "MSECriterion", "MsraFiller", "MulConstant",
           "NegativeEntropyPenalty", "Node", "Ones", "Padding",
           "ParallelTable", "Power", "RandomNormal", "RandomUniform", "ReLU",
           "Remat", "Reshape", "RMSNorm", "Scale", "Sequential",
           "SpaceToDepthConvolution", "SparseJoinTable", "SparseLinear",
           "SpatialAveragePooling",
           "SpatialBatchNormalization", "SpatialConvolution",
           "SpatialDilatedConvolution", "SpatialDropout1D",
           "SpatialDropout2D", "SpatialDropout3D", "SpatialMaxPooling",
           "SpatialZeroPadding", "Sqrt", "Square", "Squeeze", "StaticGraph",
           "Tanh", "TemporalConvolution", "TemporalMaxPooling", "Transpose",
           "View", "Xavier", "Zeros"]
