"""LeNet-5 (≙ ``bigdl_tpu/models/lenet.py``).

conv(1→6, 5x5) → tanh → maxpool → conv(6→12, 5x5) → tanh → maxpool →
fc(100) → tanh → fc(class_num) → logsoftmax, on (B, 1, 28, 28) NCHW
input (a (B, 784) input is reshaped).  The graph-API variant
(``build_graph``) is not ported yet (ROADMAP queue A, item 10).
"""
from __future__ import annotations

import torch

from .._device import DeviceLike, resolve_device
from ..nn import (Linear, LogSoftMax, Reshape, Sequential, SpatialConvolution,
                  SpatialMaxPooling, Tanh)


def build(class_num: int = 10, *, device: DeviceLike = None, seed: int = 0):
    """LeNet-5 with weights drawn from ``seed`` on ``device`` (``cuda``
    unless the caller asks for ``"cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    model = Sequential(name="LeNet5")
    (model
     .add(Reshape((1, 28, 28)))
     .add(SpatialConvolution(1, 6, 5, 5, name="conv1_5x5", gen=gen))
     .add(Tanh())
     .add(SpatialMaxPooling(2, 2, 2, 2))
     .add(SpatialConvolution(6, 12, 5, 5, name="conv2_5x5", gen=gen))
     .add(Tanh())
     .add(SpatialMaxPooling(2, 2, 2, 2))
     .add(Reshape((12 * 4 * 4,)))
     .add(Linear(12 * 4 * 4, 100, name="fc1", gen=gen))
     .add(Tanh())
     .add(Linear(100, class_num, name="fc2", gen=gen))
     .add(LogSoftMax()))
    return model.to(dev)


def build_graph(class_num: int = 10, **_):
    raise NotImplementedError(
        "lenet.build_graph: the graph API (nn/graph.py) is not ported yet "
        "(ROADMAP queue A, item 10); lenet.build gives the same topology")
