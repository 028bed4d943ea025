"""Sample and MiniBatch (≙ ``bigdl_tpu/data/minibatch.py``,
dataset/Sample.scala and MiniBatch.scala).

A ``Sample`` holds (features, labels) as host numpy arrays; a
``MiniBatch`` is a batched (input, target) pair of host arrays, which the
optimizer copies to the device.  ``samples_to_minibatch`` stacks samples,
padding to the largest shape (or to a fixed length) when their sizes
differ, as the reference does.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class Sample:
    def __init__(self, feature, label=None):
        self.features = feature if isinstance(feature, (list, tuple)) \
            else [feature]
        self.features = [np.asarray(f) for f in self.features]
        if label is None:
            self.labels = []
        else:
            labels = label if isinstance(label, (list, tuple)) else [label]
            self.labels = [np.asarray(l) for l in labels]

    def feature(self, i=0):
        return self.features[i]

    def label(self, i=0):
        return self.labels[i] if self.labels else None

    def __repr__(self):
        return (f"Sample(features={[f.shape for f in self.features]}, "
                f"labels={[l.shape for l in self.labels]})")


class PaddingParam:
    """Fixed-length padding spec (≙ dataset/MiniBatch.scala PaddingParam)."""

    def __init__(self, padding_value=0.0, fixed_length=None):
        self.padding_value = padding_value
        self.fixed_length = fixed_length


class MiniBatch:
    def __init__(self, input, target=None):
        self.input = input
        self.target = target

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target

    def size(self):
        first = self.input[0] if isinstance(self.input, (list, tuple)) \
            else self.input
        return first.shape[0]

    def slice(self, offset, length):
        """1-based offset slice, matching reference MiniBatch.slice."""
        def sl(x):
            if isinstance(x, (list, tuple)):
                return [sl(e) for e in x]
            return x[offset - 1: offset - 1 + length]
        return MiniBatch(sl(self.input),
                         None if self.target is None else sl(self.target))


def _pad_stack(arrays: Sequence[np.ndarray], padding: Optional[PaddingParam]):
    shapes = {a.shape for a in arrays}
    if len(shapes) == 1 and (padding is None or padding.fixed_length is None):
        return np.stack(arrays)
    ndim = arrays[0].ndim
    max_shape = [max(a.shape[d] for a in arrays) for d in range(ndim)]
    if padding is not None and padding.fixed_length is not None:
        fl = padding.fixed_length
        if isinstance(fl, int):
            max_shape[0] = max(max_shape[0], fl)
        else:
            for d, v in enumerate(fl):
                if v is not None and v > 0:
                    max_shape[d] = max(max_shape[d], v)
    value = 0.0 if padding is None else padding.padding_value
    out = np.full([len(arrays)] + max_shape, value, dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
    return out


def samples_to_minibatch(samples: List[Sample],
                         feature_padding: Optional[PaddingParam] = None,
                         label_padding: Optional[PaddingParam] = None) -> MiniBatch:
    n_feat = len(samples[0].features)
    feats = [_pad_stack([s.features[i] for s in samples], feature_padding)
             for i in range(n_feat)]
    n_lab = len(samples[0].labels)
    labs = [_pad_stack([s.labels[i] for s in samples], label_padding)
            for i in range(n_lab)]
    input_ = feats[0] if n_feat == 1 else feats
    target = None if n_lab == 0 else (labs[0] if n_lab == 1 else labs)
    return MiniBatch(input_, target)
