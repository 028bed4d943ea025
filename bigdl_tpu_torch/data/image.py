"""Image pipeline (≙ ``bigdl_tpu/data/image.py``, dataset/image/*.scala:
Types, BytesToBGRImg, BGRImgCropper, BGRImgRdmCropper, BGRImgNormalizer,
BGRImgPixelNormalizer, HFlip, ColorJitter, Lighting, GreyImg*,
BGRImgToSample, BGRImgToBatch, LocalImgReader).

All host-side numpy, with the reference's ``np.random.RandomState(seed)``
draws, so that crops, flips and jitter match it bit for bit; ``*ToBatch``
emits contiguous NCHW float32 MiniBatches ready for one host→device copy.
Images are float32 HWC in [0, 255] (BGR order like the reference's OpenCV
path) until ``*ToSample`` converts to CHW (optionally RGB) at the
pipeline tail.  PIL is imported only on the encoded-bytes paths
(``BytesTo*Img`` given bytes, ``LocalImgReader``).
"""
from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from .dataset import Transformer, SampleToMiniBatch
from .minibatch import MiniBatch, Sample


class LabeledBGRImage:
    """HWC float32 BGR image + 1-based float label (≙ image/Types.scala)."""

    def __init__(self, data: np.ndarray, label: float = 0.0):
        self.data = np.ascontiguousarray(data, dtype=np.float32)
        self.label = float(label)

    @property
    def height(self):
        return self.data.shape[0]

    @property
    def width(self):
        return self.data.shape[1]

    def copy(self):
        return LabeledBGRImage(self.data.copy(), self.label)


class LabeledGreyImage:
    """HW float32 grey image + label (≙ image/Types.scala GreyImage)."""

    def __init__(self, data: np.ndarray, label: float = 0.0):
        self.data = np.ascontiguousarray(data, dtype=np.float32)
        if self.data.ndim == 3 and self.data.shape[-1] == 1:
            self.data = self.data[..., 0]
        self.label = float(label)

    @property
    def height(self):
        return self.data.shape[0]

    @property
    def width(self):
        return self.data.shape[1]


# --------------------------------------------------------------------- #
# decoding                                                              #
# --------------------------------------------------------------------- #
class BytesToBGRImg(Transformer):
    """(bytes|uint8 HWC array, label) -> LabeledBGRImage
    (≙ image/BytesToBGRImg.scala)."""

    def __init__(self, normalize: float = 1.0):
        self.normalize = normalize

    def _decode(self, raw):
        if isinstance(raw, np.ndarray):
            arr = raw
        else:
            from PIL import Image
            import io
            arr = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
            arr = arr[..., ::-1]  # RGB -> BGR, matching the OpenCV reference
        return arr.astype(np.float32) / self.normalize

    def apply_iter(self, it):
        for item in it:
            raw, label = item if isinstance(item, tuple) else (item, 0.0)
            yield LabeledBGRImage(self._decode(raw), label)


class BytesToGreyImg(Transformer):
    """(bytes|uint8 HW array, label) -> LabeledGreyImage
    (≙ image/BytesToGreyImg.scala)."""

    def __init__(self, normalize: float = 1.0):
        self.normalize = normalize

    def apply_iter(self, it):
        for item in it:
            raw, label = item if isinstance(item, tuple) else (item, 0.0)
            if not isinstance(raw, np.ndarray):
                from PIL import Image
                import io
                raw = np.asarray(Image.open(io.BytesIO(raw)).convert("L"))
            yield LabeledGreyImage(raw.astype(np.float32) / self.normalize,
                                   label)


class LocalImgReader(Transformer):
    """(path, label) -> LabeledBGRImage, resizing the short edge to `scale_to`
    (≙ image/LocalImgReader.scala)."""

    def __init__(self, scale_to: int = 256):
        self.scale_to = scale_to

    def apply_iter(self, it):
        from PIL import Image
        for item in it:
            path, label = item if isinstance(item, tuple) else (item, 0.0)
            img = Image.open(path).convert("RGB")
            w, h = img.size
            if self.scale_to:
                if w < h:
                    nw, nh = self.scale_to, int(h * self.scale_to / w)
                else:
                    nw, nh = int(w * self.scale_to / h), self.scale_to
                img = img.resize((nw, nh), Image.BILINEAR)
            arr = np.asarray(img)[..., ::-1].astype(np.float32)
            yield LabeledBGRImage(arr, label)


def local_image_paths(root: str) -> List[tuple]:
    """Scan a class-per-subdir image folder into (path, 1-based label)
    (≙ image/LocalImageFiles.scala)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    out = []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                out.append((os.path.join(cdir, f), float(ci + 1)))
    return out


# --------------------------------------------------------------------- #
# crops / flips                                                         #
# --------------------------------------------------------------------- #
def _crop(data: np.ndarray, ch: int, cw: int, method: str, rng) -> np.ndarray:
    h, w = data.shape[:2]
    if method == "center":
        y0, x0 = (h - ch) // 2, (w - cw) // 2
    else:
        y0 = int(rng.randint(0, h - ch + 1))
        x0 = int(rng.randint(0, w - cw + 1))
    return data[y0:y0 + ch, x0:x0 + cw]


class BGRImgCropper(Transformer):
    """Crop to (crop_height, crop_width); 'random' while training, 'center'
    for eval (≙ image/BGRImgCropper.scala)."""

    def __init__(self, crop_width: int, crop_height: int,
                 crop_method: str = "random", seed: int = 0):
        self.cw, self.ch = crop_width, crop_height
        self.method = crop_method
        self._rng = np.random.RandomState(seed)

    def apply_iter(self, it):
        for img in it:
            img.data = np.ascontiguousarray(
                _crop(img.data, self.ch, self.cw, self.method, self._rng))
            yield img


class GreyImgCropper(BGRImgCropper):
    """≙ image/GreyImgCropper.scala."""


class BGRImgRdmCropper(Transformer):
    """Zero-pad `padding` on each side then random-crop back to size
    (the CIFAR augmentation; ≙ image/BGRImgRdmCropper.scala)."""

    def __init__(self, crop_width: int, crop_height: int, padding: int,
                 seed: int = 0):
        self.cw, self.ch = crop_width, crop_height
        self.padding = padding
        self._rng = np.random.RandomState(seed)

    def apply_iter(self, it):
        p = self.padding
        for img in it:
            padded = np.pad(img.data, ((p, p), (p, p), (0, 0)))
            img.data = np.ascontiguousarray(
                _crop(padded, self.ch, self.cw, "random", self._rng))
            yield img


class HFlip(Transformer):
    """Horizontal flip with probability `threshold`
    (≙ image/HFlip.scala)."""

    def __init__(self, threshold: float = 0.5, seed: int = 0):
        self.threshold = threshold
        self._rng = np.random.RandomState(seed)

    def apply_iter(self, it):
        for img in it:
            if self._rng.uniform() < self.threshold:
                img.data = np.ascontiguousarray(img.data[:, ::-1])
            yield img


# --------------------------------------------------------------------- #
# normalization                                                         #
# --------------------------------------------------------------------- #
class BGRImgNormalizer(Transformer):
    """(img - mean) / std per channel; means/stds either given or estimated
    from a dataset pass (≙ image/BGRImgNormalizer.scala)."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32).reshape(1, 1, -1)
        self.std = np.asarray(std, np.float32).reshape(1, 1, -1)

    @staticmethod
    def from_dataset(images: Iterable[LabeledBGRImage],
                     samples: int = 10000) -> "BGRImgNormalizer":
        tot = np.zeros(3, np.float64)
        tot2 = np.zeros(3, np.float64)
        n = 0
        for i, img in enumerate(images):
            if i >= samples:
                break
            tot += img.data.reshape(-1, 3).sum(0)
            tot2 += (img.data.reshape(-1, 3) ** 2).sum(0)
            n += img.data.shape[0] * img.data.shape[1]
        mean = tot / n
        std = np.sqrt(tot2 / n - mean ** 2)
        return BGRImgNormalizer(mean, std)

    def apply_iter(self, it):
        for img in it:
            img.data = (img.data - self.mean) / self.std
            yield img


class BGRImgPixelNormalizer(Transformer):
    """Subtract a per-pixel mean image (≙ image/BGRImgPixelNormalizer.scala)."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def apply_iter(self, it):
        for img in it:
            img.data = img.data - self.means
            yield img


class GreyImgNormalizer(Transformer):
    """≙ image/GreyImgNormalizer.scala."""

    def __init__(self, mean: float, std: float):
        self.mean = float(mean)
        self.std = float(std)

    @staticmethod
    def from_dataset(images, samples: int = 10000) -> "GreyImgNormalizer":
        tot = tot2 = 0.0
        n = 0
        for i, img in enumerate(images):
            if i >= samples:
                break
            tot += float(img.data.sum())
            tot2 += float((img.data ** 2).sum())
            n += img.data.size
        mean = tot / n
        return GreyImgNormalizer(mean, np.sqrt(tot2 / n - mean ** 2))

    def apply_iter(self, it):
        for img in it:
            img.data = (img.data - self.mean) / self.std
            yield img


# --------------------------------------------------------------------- #
# color augmentation                                                    #
# --------------------------------------------------------------------- #
def _grayscale_bgr(img: np.ndarray) -> np.ndarray:
    # reference grayScale walks BGR triples: B*0.299 + G*0.587 + R*0.114
    # (image/ColorJitter.scala grayScale)
    g = (img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114)
    return np.repeat(g[..., None], 3, axis=-1)


class ColorJitter(Transformer):
    """Random-order brightness/contrast/saturation, each strength 0.4
    (≙ image/ColorJitter.scala)."""

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, seed: int = 0):
        self.strength = {"brightness": brightness, "contrast": contrast,
                         "saturation": saturation}
        self._rng = np.random.RandomState(seed)

    def _blend(self, a, b, alpha):
        return a * alpha + (1.0 - alpha) * b

    def _jitter(self, img: np.ndarray) -> np.ndarray:
        order = list(self.strength)
        self._rng.shuffle(order)
        for key in order:
            var = self.strength[key]
            alpha = 1.0 + float(self._rng.uniform(-var, var))
            if key == "brightness":
                img = self._blend(img, np.zeros_like(img), alpha)
            elif key == "contrast":
                target = np.full_like(img, _grayscale_bgr(img).mean())
                img = self._blend(img, target, alpha)
            else:  # saturation
                img = self._blend(img, _grayscale_bgr(img), alpha)
        return img

    def apply_iter(self, it):
        for img in it:
            img.data = self._jitter(img.data)
            yield img


class Lighting(Transformer):
    """AlexNet fancy-PCA lighting noise (≙ image/Lighting.scala; same
    eigval/eigvec constants, alphastd=0.1).  Operates on BGR data by
    applying the RGB perturbation reversed."""

    alphastd = 0.1
    eigval = np.array([0.2175, 0.0188, 0.0045], np.float32)
    eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, seed: int = 0):
        self._rng = np.random.RandomState(seed)

    def apply_iter(self, it):
        for img in it:
            alpha = self._rng.normal(0, self.alphastd, 3).astype(np.float32)
            rgb = (self.eigvec * alpha[None, :] * self.eigval[None, :]).sum(1)
            img.data = img.data + rgb[::-1][None, None, :]  # BGR order
            yield img


# --------------------------------------------------------------------- #
# to Sample / MiniBatch                                                 #
# --------------------------------------------------------------------- #
class BGRImgToSample(Transformer):
    """HWC BGR -> CHW Sample, optionally reordered to RGB
    (≙ image/BGRImgToSample.scala)."""

    def __init__(self, to_rgb: bool = True):
        self.to_rgb = to_rgb

    def apply_iter(self, it):
        for img in it:
            data = img.data[..., ::-1] if self.to_rgb else img.data
            chw = np.ascontiguousarray(np.transpose(data, (2, 0, 1)))
            yield Sample(chw, np.float32(img.label))


class GreyImgToSample(Transformer):
    """HW -> (1,H,W) Sample (≙ image/GreyImgToSample.scala)."""

    def apply_iter(self, it):
        for img in it:
            yield Sample(img.data[None, ...], np.float32(img.label))


class BGRImgToBatch(Transformer):
    """Images -> NCHW MiniBatch in one shot (≙ image/BGRImgToBatch.scala +
    MTLabeledBGRImgToBatch.scala: the multi-thread copy becomes one
    vectorised stack)."""

    def __init__(self, batch_size: int, to_rgb: bool = True,
                 drop_last: bool = False):
        self.batch_size = batch_size
        self.to_rgb = to_rgb
        self.drop_last = drop_last

    def apply_iter(self, it):
        buf: List[LabeledBGRImage] = []
        for img in it:
            buf.append(img)
            if len(buf) == self.batch_size:
                yield self._batch(buf)
                buf = []
        if buf and not self.drop_last:
            yield self._batch(buf)

    def _batch(self, buf):
        data = np.stack([b.data for b in buf])
        if self.to_rgb:
            data = data[..., ::-1]
        x = np.ascontiguousarray(np.transpose(data, (0, 3, 1, 2)))
        y = np.asarray([b.label for b in buf], np.float32)
        return MiniBatch(x, y)


class GreyImgToBatch(Transformer):
    """≙ image/GreyImgToBatch.scala."""

    def __init__(self, batch_size: int, drop_last: bool = False):
        self.batch_size = batch_size
        self.drop_last = drop_last

    def apply_iter(self, it):
        buf: List[LabeledGreyImage] = []
        for img in it:
            buf.append(img)
            if len(buf) == self.batch_size:
                yield self._batch(buf)
                buf = []
        if buf and not self.drop_last:
            yield self._batch(buf)

    def _batch(self, buf):
        x = np.stack([b.data for b in buf])[:, None, :, :]
        y = np.asarray([b.label for b in buf], np.float32)
        return MiniBatch(np.ascontiguousarray(x), y)


# --------------------------------------------------------------------- #
# Hadoop SequenceFile interop (the reference's ImageNet storage format) #
# --------------------------------------------------------------------- #
class BGRImgToLocalSeqFile(Transformer):
    """Write images into numbered .seq shards, `block_size` per file,
    yielding each file name (≙ image/BGRImgToLocalSeqFile.scala: key =
    Text(label) [or "name\\nlabel"], value = Text(int32BE width, int32BE
    height, BGR uint8 bytes))."""

    def __init__(self, block_size: int, base_file_name: str,
                 has_name: bool = False):
        self.block_size = block_size
        self.base = base_file_name
        self.has_name = has_name
        self._index = 0

    def apply_iter(self, it):
        import struct
        from ..utils.seqfile import SequenceFileWriter
        it = iter(it)
        done = False
        while not done:
            fname = f"{self.base}_{self._index}.seq"
            with SequenceFileWriter(fname) as w:
                count = 0
                while count < self.block_size:
                    try:
                        item = next(it)
                    except StopIteration:
                        done = True
                        break
                    if isinstance(item, tuple):
                        img, name = item
                    else:
                        img, name = item, ""
                    header = struct.pack(">ii", img.width, img.height)
                    payload = header + np.clip(img.data, 0, 255) \
                        .astype(np.uint8).tobytes()
                    key = (f"{name}\n{int(img.label)}" if self.has_name
                           else f"{int(img.label)}").encode()
                    w.append(key, payload)
                    count += 1
            if count:
                self._index += 1
                yield fname
            elif done:
                os.remove(fname)


class LocalSeqFileToBytes(Transformer):
    """File names -> (HWC uint8 BGR array, label) pairs feeding
    BytesToBGRImg (≙ image/LocalSeqFileToBytes.scala)."""

    def apply_iter(self, it):
        import struct
        from ..utils.seqfile import SequenceFileReader
        for fname in it:
            for key, value in SequenceFileReader(fname):
                w, h = struct.unpack(">ii", value[:8])
                arr = np.frombuffer(value[8:8 + w * h * 3], np.uint8) \
                    .reshape(h, w, 3)
                text = key.decode()
                label = float(text.split("\n")[-1])
                yield arr, label
