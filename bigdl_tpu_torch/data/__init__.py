"""Data of the port (≙ ``bigdl_tpu/data``): the in-memory array path."""
from .dataset import ArrayMiniBatchDataSet, DataSet
from .minibatch import MiniBatch

__all__ = ["ArrayMiniBatchDataSet", "DataSet", "MiniBatch"]
