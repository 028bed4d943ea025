"""Data of the port (≙ ``bigdl_tpu/data``): the in-memory array path,
prefetch and the device loader."""
from .dataset import ArrayMiniBatchDataSet, DataSet
from .device_loader import DeviceLoader, HostToDevice
from .minibatch import MiniBatch
from .prefetch import PrefetchedDataSet

__all__ = ["ArrayMiniBatchDataSet", "DataSet", "DeviceLoader",
           "HostToDevice", "MiniBatch", "PrefetchedDataSet"]
