"""CIFAR-10 loader (≙ models/resnet/Utils.scala Cifar10DataSet's local file
path + pyspark dataset conventions).

Reads the python-pickle batches or the binary format from a local dir;
falls back to deterministic synthetic data (no download).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

# ≙ models/resnet/Utils.scala trainMean/trainStd (BGR order)
TRAIN_MEAN = (125.3, 123.0, 113.9)
TRAIN_STD = (63.0, 62.1, 66.7)


def _load_py_batch(path):
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    x = d[b"data"].reshape(-1, 3, 32, 32)
    y = np.asarray(d[b"labels"], np.uint8)
    return x, y


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    x = (rng.rand(n, 3, 32, 32) * 60).astype(np.uint8)
    for c in range(10):
        x[labels == c, c % 3, 4 + 2 * (c // 3):10 + 2 * (c // 3), :] = 200
    return x, labels


def read_data_sets(data_dir, data_type="train"):
    """Returns (images [N,3,32,32] uint8 RGB, labels [N] uint8 0-based)."""
    batch_dir = None if data_dir is None else \
        os.path.join(data_dir, "cifar-10-batches-py")
    if batch_dir is not None and os.path.isdir(batch_dir):
        if data_type == "train":
            parts = [_load_py_batch(os.path.join(batch_dir, f"data_batch_{i}"))
                     for i in range(1, 6)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        return _load_py_batch(os.path.join(batch_dir, "test_batch"))
    n = 2048 if data_type == "train" else 512
    return _synthetic(n, seed=0 if data_type == "train" else 1)


def load_data(data_dir=None):
    """Train and test sets from ``data_dir``; synthetic where it is None or
    holds no files."""
    xtr, ytr = read_data_sets(data_dir, "train")
    xte, yte = read_data_sets(data_dir, "test")
    return (xtr, ytr), (xte, yte)
