"""MiniBatch (≙ ``bigdl_tpu/data/minibatch.py``): a batched (input,
target) pair of host arrays.  ``Sample``, padding and
``samples_to_minibatch`` are not ported yet (ROADMAP queue A, item 10)."""
from __future__ import annotations


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
