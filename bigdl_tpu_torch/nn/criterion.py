"""Losses (≙ ``bigdl_tpu/nn/criterion.py``): ``ClassNLLCriterion``,
``CrossEntropyCriterion`` and ``MSECriterion``.

Targets are 1-based class indices, given as floats and truncated to
int32 as the reference does.  The gradient is autograd's through
:meth:`ClassNLLCriterion.loss`.
"""
from __future__ import annotations

import torch

from .module import Criterion


def _reduce(per_elem, size_average, weight_sum=None):
    if size_average:
        if weight_sum is not None:
            return per_elem.sum() / torch.clamp_min(weight_sum, 1e-12)
        return per_elem.mean()
    return per_elem.sum()


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood of log-probabilities, 1-based targets.
    Rows whose target equals ``padding_value`` weigh 0; ``weights`` weighs
    each class; ``size_average`` divides by the summed weights;
    ``log_prob_as_input=False`` takes probabilities."""

    def __init__(self, weights=None, size_average=True, log_prob_as_input=True,
                 padding_value=-1, zero_based_label=False, name=None):
        super().__init__(name=name)
        self.weights = None if weights is None else torch.as_tensor(
            weights, dtype=torch.float32)
        self.size_average = size_average
        self.log_prob_as_input = log_prob_as_input
        self.padding_value = padding_value
        self.zero_based_label = zero_based_label

    def loss(self, output, target):
        logp = output if self.log_prob_as_input else torch.log(
            torch.clamp_min(output, 1e-8))
        t = torch.as_tensor(target, device=output.device).to(
            torch.int32).reshape(-1)
        idx = t if self.zero_based_label else t - 1
        valid = t != self.padding_value
        idx_c = idx.clamp(0, logp.shape[-1] - 1).long()
        logp2 = logp.reshape(-1, logp.shape[-1])
        picked = torch.gather(logp2, 1, idx_c[:, None])[:, 0]
        w = (torch.ones_like(picked) if self.weights is None
             else self.weights.to(picked.device)[idx_c])
        w = w * valid.to(picked.dtype)
        return _reduce(-w * picked, self.size_average, w.sum())


class CrossEntropyCriterion(Criterion):
    """Log softmax over the last dim, then :class:`ClassNLLCriterion`
    (1-based targets unless ``zero_based_label``)."""

    def __init__(self, weights=None, size_average=True,
                 zero_based_label=False, name=None):
        super().__init__(name=name)
        self.nll = ClassNLLCriterion(weights, size_average,
                                     zero_based_label=zero_based_label)

    def loss(self, output, target):
        return self.nll.loss(torch.log_softmax(output, dim=-1), target)


class MSECriterion(Criterion):
    """mean (input - target)^2 (sum with ``size_average=False``)."""

    def __init__(self, size_average=True, name=None):
        super().__init__(name=name)
        self.size_average = size_average

    def loss(self, output, target):
        return _reduce((output - target) ** 2, self.size_average)
