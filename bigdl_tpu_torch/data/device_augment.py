"""Image augmentation on the device (≙ ``bigdl_tpu/data/device_augment.py``).

The host ships raw uint8 NHWC batches (a quarter of fp32's bytes over
PCIe) and the random crop, flip and normalization run as torch ops on the
batch's device inside the train step.  The random functions draw their
offsets and flips from an explicit ``torch.Generator`` on that device (a
``jax.random`` stream cannot be reproduced in torch), and each has a
counterpart that takes them as given (:func:`crop_at`, :func:`hflip_at`,
:meth:`DeviceAugment.apply`), so that a test can hold the result against
the reference at the same offsets.  A crop is one gather at per-image
offsets held in a tensor: no host loop, no host sync.

The channel order is kept as given: records stored BGR (the reference's
OpenCV order) reach the model BGR, and ``mean``/``std`` are given in that
order.

    aug = DeviceAugment(crop=(224, 224), flip=True,
                        mean=(103.53, 116.28, 123.675),     # B, G, R
                        std=(57.375, 57.12, 58.395))
    x = aug(raw_uint8_nhwc, gen)            # inside the train step
"""
from __future__ import annotations

import torch


def _offsets(n, size, crop, gen, device):
    return torch.randint(0, size - crop + 1, (n,), generator=gen,
                         device=device)


def crop_at(x, oy, ox, crop_h, crop_w):
    """Crop image i of the NHWC batch ``x`` at rows ``oy[i]:oy[i]+crop_h``
    and columns ``ox[i]:ox[i]+crop_w`` (``oy``, ``ox``: integer tensors on
    ``x``'s device)."""
    n = x.shape[0]
    rows = oy.long()[:, None] + torch.arange(crop_h, device=x.device)
    cols = ox.long()[:, None] + torch.arange(crop_w, device=x.device)
    idx = torch.arange(n, device=x.device)[:, None, None]
    return x[idx, rows[:, :, None], cols[:, None, :]]


def random_crop(x, gen, crop_h, crop_w):
    """Per-image random crop of an NHWC batch: row offsets, then column
    offsets, drawn uniformly from ``gen``."""
    n, h, w = x.shape[:3]
    oy = _offsets(n, h, crop_h, gen, x.device)
    ox = _offsets(n, w, crop_w, gen, x.device)
    return crop_at(x, oy, ox, crop_h, crop_w)


def center_crop(x, crop_h, crop_w):
    n, h, w, c = x.shape
    y0, x0 = (h - crop_h) // 2, (w - crop_w) // 2
    return x[:, y0:y0 + crop_h, x0:x0 + crop_w]


def hflip_at(x, flips):
    """Image i of the NHWC batch ``x`` mirrored left to right where
    ``flips[i]`` (a bool tensor on ``x``'s device)."""
    return torch.where(flips[:, None, None, None], x.flip(2), x)


def random_hflip(x, gen, p=0.5):
    """Per-image horizontal flip with probability ``p``, drawn from
    ``gen``."""
    flips = torch.rand(x.shape[0], generator=gen, device=x.device) < p
    return hflip_at(x, flips)


def normalize(x, mean, std, dtype=torch.float32):
    """``(x - mean) / std`` per channel in fp32, then cast to ``dtype``."""
    mean = torch.tensor(mean, dtype=torch.float32).to(x.device)
    std = torch.tensor(std, dtype=torch.float32).to(x.device)
    return ((x.to(torch.float32) - mean) / std).to(dtype)


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


class DeviceAugment:
    """Train and eval augmentation of uint8 NHWC batches on their device.

    ``crop``: (h, w), a random crop in training and a center crop in
    eval; ``flip``: a random horizontal flip in training; ``mean`` /
    ``std``: per-channel normalization, in 0..255 units and in the
    batch's channel order; ``out_format``: ``"NCHW"`` (as a
    ``torch.permute`` view) or ``"NHWC"``; ``dtype``: the returned batch's
    dtype (``torch.bfloat16`` feeds the tensor cores directly).
    """

    def __init__(self, crop=None, flip=False, mean=(0.0, 0.0, 0.0),
                 std=(1.0, 1.0, 1.0), out_format="NCHW",
                 dtype=torch.float32):
        if out_format not in ("NCHW", "NHWC"):
            raise ValueError(f"unknown out_format {out_format!r}")
        self.crop = crop
        self.flip = flip
        self.mean = tuple(mean)
        self.std = tuple(std)
        self.out_format = out_format
        self.dtype = dtype
        self._consts = {}

    def draw(self, x, gen):
        """The training draws for the batch ``x``: ``(oy, ox, flips)``,
        row and column offsets (None without a crop) and flips (None
        without a flip), in that order from ``gen``."""
        oy = ox = flips = None
        n, h, w = x.shape[:3]
        if self.crop is not None:
            ch, cw = self.crop
            oy = _offsets(n, h, ch, gen, x.device)
            ox = _offsets(n, w, cw, gen, x.device)
        if self.flip:
            flips = torch.rand(n, generator=gen, device=x.device) < 0.5
        return oy, ox, flips

    def apply(self, x, oy=None, ox=None, flips=None, training=True):
        """The augmentation at given draws (training), or the center crop
        (eval), then normalization and layout."""
        if self.crop is not None:
            ch, cw = self.crop
            x = crop_at(x, oy, ox, ch, cw) if training \
                else center_crop(x, ch, cw)
        if self.flip and training:
            x = hflip_at(x, flips)
        mean, std = self._on(x.device)
        x = ((x.to(torch.float32) - mean) / std).to(self.dtype)
        return to_nchw(x) if self.out_format == "NCHW" else x

    def __call__(self, x, gen=None, training=True):
        if training and gen is None and (self.crop or self.flip):
            raise ValueError("training-mode augmentation needs gen=")
        draws = self.draw(x, gen) if training else (None, None, None)
        return self.apply(x, *draws, training=training)

    def _on(self, device):
        """``mean`` and ``std`` as fp32 tensors on ``device``, copied there
        once."""
        if device not in self._consts:
            self._consts[device] = tuple(
                torch.tensor(v, dtype=torch.float32).to(device)
                for v in (self.mean, self.std))
        return self._consts[device]
