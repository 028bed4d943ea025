"""Data of the port (≙ ``bigdl_tpu/data``): samples, datasets and
transformers, the image pipeline, the file-record dataset over the native
ring, prefetch, the device loader and device augmentation, the text
pipeline (``data.text``) and the 20-Newsgroups loader (``data.news20``)."""
from .dataset import (ArrayMiniBatchDataSet, ChainedTransformer, DataSet,
                      DistributedDataSet, FunctionTransformer,
                      LocalArrayDataSet, SampleToMiniBatch,
                      TransformedDataSet, Transformer)
from .device_augment import DeviceAugment
from .device_loader import DeviceLoader, HostToDevice
from .minibatch import MiniBatch, PaddingParam, Sample, samples_to_minibatch
from .prefetch import FileRecordDataSet, PrefetchedDataSet

__all__ = ["ArrayMiniBatchDataSet", "ChainedTransformer", "DataSet",
           "DeviceAugment", "DeviceLoader", "DistributedDataSet",
           "FileRecordDataSet", "FunctionTransformer", "HostToDevice",
           "LocalArrayDataSet", "MiniBatch", "PaddingParam",
           "PrefetchedDataSet", "Sample", "SampleToMiniBatch",
           "TransformedDataSet", "Transformer", "samples_to_minibatch"]
