"""VGG (≙ ``bigdl_tpu/models/vgg.py``): BigDL's VGG-16 for CIFAR-10
(``VggForCifar10``: conv-BN-ReLU stacks with dropout and a 512-unit head)
and the ImageNet VGG-16/19, NCHW or NHWC, built module for module as the
reference builds them, so that ``get_weights`` lists the weights in the
reference's order.  Dropout draws from the generator a training loop
hands the step (``Optimizer(seed=)``).
"""
from __future__ import annotations

import torch

from .._device import DeviceLike, resolve_device
from ..nn import (BatchNormalization, Dropout, Linear, LogSoftMax, ReLU,
                  Sequential, SpatialBatchNormalization, SpatialConvolution,
                  SpatialMaxPooling, Transpose, View)


def vgg_for_cifar10(class_num=10, has_dropout=True, format="NCHW", *,
                    gen: torch.Generator = None):
    """BigDL's ``VggForCifar10``: 13 conv-BN(eps 1e-3)-ReLU layers in five
    ceil-mode max-pooled stages, dropout 0.3/0.4 between them, and a
    Dropout(0.5)-Linear(512)-BN-ReLU-Dropout(0.5)-Linear head."""
    model = Sequential()

    def conv_bn_relu(ni, no):
        model.add(SpatialConvolution(ni, no, 3, 3, 1, 1, 1, 1,
                                     format=format, gen=gen))
        model.add(SpatialBatchNormalization(no, 1e-3, format=format))
        model.add(ReLU())

    def dropout(p):
        if has_dropout:
            model.add(Dropout(p))

    def pool():
        model.add(SpatialMaxPooling(2, 2, 2, 2, format=format).ceil())

    conv_bn_relu(3, 64)
    dropout(0.3)
    conv_bn_relu(64, 64)
    pool()
    conv_bn_relu(64, 128)
    dropout(0.4)
    conv_bn_relu(128, 128)
    pool()
    for ni in (128, 256):
        no = 2 * ni
        conv_bn_relu(ni, no)
        dropout(0.4)
        conv_bn_relu(no, no)
        dropout(0.4)
        conv_bn_relu(no, no)
        pool()
    conv_bn_relu(512, 512)
    dropout(0.4)
    conv_bn_relu(512, 512)
    dropout(0.4)
    conv_bn_relu(512, 512)
    pool()
    model.add(View(512))

    classifier = Sequential()
    if has_dropout:
        classifier.add(Dropout(0.5))
    classifier.add(Linear(512, 512, gen=gen))
    classifier.add(BatchNormalization(512))
    classifier.add(ReLU())
    if has_dropout:
        classifier.add(Dropout(0.5))
    classifier.add(Linear(512, class_num, gen=gen))
    classifier.add(LogSoftMax())
    model.add(classifier)
    return model


_VGG_CFG = {
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def vgg_imagenet(class_num=1000, depth=16, has_dropout=True, format="NCHW",
                 *, gen: torch.Generator = None):
    """VGG-16/19 on 224x224 input.  In NHWC the features are flattened in
    (c, h, w) order, so the classifier's weights are the NCHW build's."""
    model = Sequential()
    ni = 3
    for v in _VGG_CFG[depth]:
        if v == "M":
            model.add(SpatialMaxPooling(2, 2, 2, 2, format=format))
        else:
            model.add(SpatialConvolution(ni, v, 3, 3, 1, 1, 1, 1,
                                         format=format, gen=gen))
            model.add(ReLU())
            ni = v
    if format == "NHWC":
        model.add(Transpose([(1, 3), (2, 3)]))
    model.add(View(512 * 7 * 7))
    model.add(Linear(512 * 7 * 7, 4096, gen=gen))
    model.add(ReLU())
    if has_dropout:
        model.add(Dropout(0.5))
    model.add(Linear(4096, 4096, gen=gen))
    model.add(ReLU())
    if has_dropout:
        model.add(Dropout(0.5))
    model.add(Linear(4096, class_num, gen=gen))
    model.add(LogSoftMax())
    return model


def build(class_num=10, dataset="cifar10", depth=16, has_dropout=True,
          format="NCHW", *, device: DeviceLike = None, seed: int = 0):
    """The reference's ``vgg.build`` with weights drawn from ``seed`` on
    ``device`` (``cuda`` unless the caller asks for ``"cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    if dataset == "cifar10":
        model = vgg_for_cifar10(class_num, has_dropout, format=format,
                                gen=gen)
    else:
        model = vgg_imagenet(class_num, depth, has_dropout, format=format,
                             gen=gen)
    return model.to(dev)
