"""MNIST loader (≙ pyspark/bigdl/dataset/mnist.py).

Reads the standard idx .gz files from a local directory; with no files
present (no download) generates a deterministic synthetic
set with class-dependent structure so training pipelines remain testable.
"""
from __future__ import annotations

import gzip
import os

import numpy as np

# ≙ mnist.py normalization constants
TRAIN_MEAN = 0.13066047740239506 * 255
TRAIN_STD = 0.3081078 * 255
TEST_MEAN = 0.13251460696903547 * 255
TEST_STD = 0.31048024 * 255


def _read32(stream):
    return np.frombuffer(stream.read(4),
                         dtype=np.dtype(np.uint32).newbyteorder(">"))[0]


def extract_images(path):
    with gzip.open(path, "rb") as f:
        if _read32(f) != 2051:
            raise ValueError(f"{path}: bad magic for MNIST images")
        n, rows, cols = _read32(f), _read32(f), _read32(f)
        buf = f.read(int(rows) * int(cols) * int(n))
        return np.frombuffer(buf, np.uint8).reshape(int(n), int(rows),
                                                    int(cols), 1)


def extract_labels(path):
    with gzip.open(path, "rb") as f:
        if _read32(f) != 2049:
            raise ValueError(f"{path}: bad magic for MNIST labels")
        n = _read32(f)
        return np.frombuffer(f.read(int(n)), np.uint8)


def _synthetic(n, seed):
    """Class-separable synthetic digits: class c lights a band of rows."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    images = (rng.rand(n, 28, 28, 1) * 40).astype(np.uint8)
    for c in range(10):
        rows = slice(2 + c * 2, 5 + c * 2)
        images[labels == c, rows, 4:24] = 220
    return images, labels


def read_data_sets(train_dir, data_type="train"):
    """Returns (images [N,28,28,1] uint8, labels [N] uint8 0-based)."""
    prefix = "train" if data_type == "train" else "t10k"
    if train_dir is not None:
        img = os.path.join(train_dir, f"{prefix}-images-idx3-ubyte.gz")
        lab = os.path.join(train_dir, f"{prefix}-labels-idx1-ubyte.gz")
        if os.path.exists(img) and os.path.exists(lab):
            return extract_images(img), extract_labels(lab)
    n = 2048 if data_type == "train" else 512
    return _synthetic(n, seed=0 if data_type == "train" else 1)


def load_data(train_dir=None):
    """Train and test sets from ``train_dir``; synthetic where it is None or
    holds no files."""
    xtr, ytr = read_data_sets(train_dir, "train")
    xte, yte = read_data_sets(train_dir, "test")
    return (xtr, ytr), (xte, yte)
