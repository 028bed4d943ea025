"""Data of the port (≙ ``bigdl_tpu/data``): samples, datasets and
transformers, the image pipeline, the file-record dataset over the native
ring, prefetch, the device loader and device augmentation, the text
pipeline (``data.text``), the 20-Newsgroups loader (``data.news20``) and
the sharded streaming data plane with its exactly-once cursor
(``data.sharded``)."""
from .dataset import (ArrayMiniBatchDataSet, ChainedTransformer, DataSet,
                      DistributedDataSet, FunctionTransformer,
                      LocalArrayDataSet, SampleToMiniBatch,
                      TransformedDataSet, Transformer)
from .device_augment import DeviceAugment
from .device_loader import DeviceLoader, HostToDevice
from .minibatch import MiniBatch, PaddingParam, Sample, samples_to_minibatch
from .prefetch import FileRecordDataSet, PrefetchedDataSet
from .sharded import (ShardedRecordDataSet, count_records, epoch_order,
                      plan_epoch, replan_cursors)

__all__ = ["ArrayMiniBatchDataSet", "ChainedTransformer", "DataSet",
           "DeviceAugment", "DeviceLoader", "DistributedDataSet",
           "FileRecordDataSet", "FunctionTransformer", "HostToDevice",
           "LocalArrayDataSet", "MiniBatch", "PaddingParam",
           "PrefetchedDataSet", "Sample", "SampleToMiniBatch",
           "ShardedRecordDataSet", "TransformedDataSet", "Transformer",
           "count_records", "epoch_order", "plan_epoch", "replan_cursors",
           "samples_to_minibatch"]
