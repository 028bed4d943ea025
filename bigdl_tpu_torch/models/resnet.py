"""ResNet (≙ ``bigdl_tpu/models/resnet.py``).

ImageNet depths 18, 34, 50, 101, 152 and 200 (basic or bottleneck
blocks) and the CIFAR-10 variant of depth 6n+2, shortcut types A, B and
C, NCHW or NHWC, built module for module as the reference builds them, so
that ``get_weights`` lists the weights in the reference's order.
``stem="s2d"`` computes the 7x7/2 stem through
``SpaceToDepthConvolution``, ``remat=True`` wraps every residual block in
``nn.Remat`` after the build (so no auto name shifts), and
``sync_bn_axis`` makes every BN a sync BN over that mesh axis.

Shortcut type A in NHWC raises: the reference builds its channel padding
as ``Padding(1, n, 4)``, which pads the batch dim of an NHWC activity and
fails in the residual add (ROADMAP C6).  In NCHW it is ported.
"""
from __future__ import annotations

import torch

from .._device import DeviceLike, resolve_device
from ..nn import (CAddTable, ConcatTable, Identity, Linear, LogSoftMax,
                  Padding, ReLU, Remat, Sequential, SpaceToDepthConvolution,
                  SpatialAveragePooling, SpatialBatchNormalization,
                  SpatialConvolution, SpatialMaxPooling, View)


class ShortcutType:
    A = "A"  # zero-padded identity when channels grow (no params)
    B = "B"  # 1x1 conv projection only when shapes differ (default)
    C = "C"  # projection on every shortcut


class _Builder:
    def __init__(self, shortcut_type, format, gen, sync_bn_axis=None):
        self.i_channels = 0
        self.shortcut_type = shortcut_type
        self.format = format
        self.gen = gen
        self.sync_bn_axis = sync_bn_axis
        self.block_sites = []

    def conv(self, *a, **kw):
        return SpatialConvolution(*a, format=self.format, gen=self.gen, **kw)

    def bn(self, n):
        return SpatialBatchNormalization(n, format=self.format,
                                         sync_axis=self.sync_bn_axis)

    def shortcut(self, n_input, n_output, stride):
        use_conv = (self.shortcut_type == ShortcutType.C
                    or (self.shortcut_type == ShortcutType.B
                        and n_input != n_output))
        if use_conv:
            return Sequential(
                self.conv(n_input, n_output, 1, 1, stride, stride,
                          with_bias=False),
                self.bn(n_output))
        if n_input != n_output:
            # type A: strided identity, channels zero-padded
            return Sequential(
                SpatialAveragePooling(1, 1, stride, stride,
                                      format=self.format),
                Padding(1, n_output - n_input, 3))
        if stride != 1:
            return SpatialAveragePooling(1, 1, stride, stride,
                                         format=self.format)
        return Identity()

    def basic_block(self, n, stride):
        n_input = self.i_channels
        self.i_channels = n
        main = Sequential(
            self.conv(n_input, n, 3, 3, stride, stride, 1, 1,
                      with_bias=False),
            self.bn(n),
            ReLU(),
            self.conv(n, n, 3, 3, 1, 1, 1, 1, with_bias=False),
            self.bn(n))
        return Sequential(
            ConcatTable(main, self.shortcut(n_input, n, stride)),
            CAddTable(),
            ReLU())

    def bottleneck(self, n, stride):
        n_input = self.i_channels
        self.i_channels = n * 4
        main = Sequential(
            self.conv(n_input, n, 1, 1, 1, 1, with_bias=False),
            self.bn(n),
            ReLU(),
            self.conv(n, n, 3, 3, stride, stride, 1, 1, with_bias=False),
            self.bn(n),
            ReLU(),
            self.conv(n, n * 4, 1, 1, 1, 1, with_bias=False),
            self.bn(n * 4))
        return Sequential(
            ConcatTable(main, self.shortcut(n_input, n * 4, stride)),
            CAddTable(),
            ReLU())

    def layer(self, block, features, count, stride=1):
        s = Sequential()
        for i in range(count):
            s.add(block(features, stride if i == 0 else 1))
            self.block_sites.append((s, str(len(s) - 1)))
        return s


# (blocks per stage, final features, block kind) per ImageNet depth
_IMAGENET_CFG = {
    18: ((2, 2, 2, 2), 512, "basic"),
    34: ((3, 4, 6, 3), 512, "basic"),
    50: ((3, 4, 6, 3), 2048, "bottleneck"),
    101: ((3, 4, 23, 3), 2048, "bottleneck"),
    152: ((3, 8, 36, 3), 2048, "bottleneck"),
    200: ((3, 24, 36, 3), 2048, "bottleneck"),
}


def build(class_num=1000, depth=50, shortcut_type=ShortcutType.B,
          dataset="imagenet", with_logsoftmax=True, format="NCHW",
          sync_bn_axis=None, stem="conv", remat=False, *,
          device: DeviceLike = None, seed: int = 0):
    """The reference's ResNet with weights drawn from ``seed`` on
    ``device`` (``cuda`` unless the caller asks for ``"cpu"``).
    ``format="NHWC"`` takes (B, H, W, C) input."""
    if stem not in ("conv", "s2d"):
        raise ValueError(f"unknown stem {stem!r}")
    if stem == "s2d" and (format != "NHWC" or dataset != "imagenet"):
        raise ValueError("stem='s2d' requires format='NHWC' imagenet")
    if shortcut_type == ShortcutType.A and format == "NHWC":
        raise ValueError(
            "resnet.build: shortcut type A in NHWC pads the batch dim in "
            "the reference (Padding(1, n, 4) on a 4-dim activity), whose "
            "forward then fails in the residual add; ROADMAP C6.  Use "
            "format='NCHW' or shortcut type B")
    dev = resolve_device(device)
    b = _Builder(shortcut_type, format, torch.Generator().manual_seed(
        int(seed)), sync_bn_axis)
    model = Sequential(name=f"ResNet{depth}_{dataset}")
    if dataset == "imagenet":
        (c1, c2, c3, c4), n_features, kind = _IMAGENET_CFG[depth]
        block = b.bottleneck if kind == "bottleneck" else b.basic_block
        b.i_channels = 64
        stem_cls = (SpaceToDepthConvolution if stem == "s2d"
                    else SpatialConvolution)
        (model
         .add(stem_cls(3, 64, 7, 7, 2, 2, 3, 3, with_bias=False,
                       format=format, name="conv1", gen=b.gen))
         .add(b.bn(64))
         .add(ReLU())
         .add(SpatialMaxPooling(3, 3, 2, 2, 1, 1, format=format))
         .add(b.layer(block, 64, c1))
         .add(b.layer(block, 128, c2, 2))
         .add(b.layer(block, 256, c3, 2))
         .add(b.layer(block, 512, c4, 2))
         .add(SpatialAveragePooling(7, 7, 1, 1, format=format))
         .add(View(n_features))
         .add(Linear(n_features, class_num, name="fc1000", gen=b.gen)))
    elif dataset == "cifar10":
        if (depth - 2) % 6 != 0:
            raise ValueError("CIFAR-10 ResNet depth must be 6n+2")
        n = (depth - 2) // 6
        b.i_channels = 16
        (model
         .add(b.conv(3, 16, 3, 3, 1, 1, 1, 1, with_bias=False))
         .add(b.bn(16))
         .add(ReLU())
         .add(b.layer(b.basic_block, 16, n))
         .add(b.layer(b.basic_block, 32, n, 2))
         .add(b.layer(b.basic_block, 64, n, 2))
         .add(SpatialAveragePooling(8, 8, 1, 1, format=format))
         .add(View(64))
         .add(Linear(64, class_num, gen=b.gen)))
    else:
        raise ValueError(f"unknown dataset {dataset}")
    if with_logsoftmax:
        model.add(LogSoftMax())
    if remat:
        for seq, key in b.block_sites:
            seq._modules[key] = Remat(seq._modules[key])
    return model.to(dev)
