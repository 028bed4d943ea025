"""Validation metrics (≙ ``bigdl_tpu/optim/validation.py``):
``Top1Accuracy``, ``Top5Accuracy``, ``Loss``, ``MAE``, ``HitRatio`` and
``NDCG``.

Each method maps ``(output, target)`` to a :class:`ValidationResult`;
results merge across batches with ``+``, as the reference's
``ValidationResult.+`` does.  The per-batch computation runs in PyTorch
ops on the output's device and ends in one host read (the count or the
sum).  Class targets are 1-based, as in the reference.
``TreeNNAccuracy`` waits for the tree modules (ROADMAP queue A, item 9).
"""
from __future__ import annotations

import numpy as np
import torch


class ValidationResult:
    def result(self):
        """(value, count)"""
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError


class AccuracyResult(ValidationResult):
    def __init__(self, correct, count):
        self.correct = int(correct)
        self.count = int(count)

    def result(self):
        return (self.correct / max(self.count, 1), self.count)

    def __add__(self, other):
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __repr__(self):
        v, n = self.result()
        return f"Accuracy({self.correct}/{n} = {v:.4f})"

    def __eq__(self, other):
        return (self.correct, self.count) == (other.correct, other.count)


class LossResult(ValidationResult):
    def __init__(self, loss, count):
        self.loss = float(loss)
        self.count = int(count)

    def result(self):
        return (self.loss / max(self.count, 1), self.count)

    def __add__(self, other):
        return LossResult(self.loss + other.loss, self.count + other.count)

    def __repr__(self):
        v, n = self.result()
        return f"Loss({v:.4f}, count={n})"


class ContiguousResult(ValidationResult):
    """Scalar sum / count result used by MAE, HitRatio, NDCG."""

    def __init__(self, total, count, name="result"):
        self.total = float(total)
        self.count = int(count)
        self._name = name

    def result(self):
        return (self.total / max(self.count, 1), self.count)

    def __add__(self, other):
        return ContiguousResult(self.total + other.total,
                                self.count + other.count, self._name)

    def __repr__(self):
        v, n = self.result()
        return f"{self._name}({v:.4f}, count={n})"


class ValidationMethod:
    name = "ValidationMethod"

    def __call__(self, output, target) -> ValidationResult:
        raise NotImplementedError

    def __repr__(self):
        return self.name


def _tensor(a, device=None):
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t if device is None else t.to(device)


def _class_target(target, device=None):
    """1-based int32 class indices: an index target truncated to int32, or
    the argmax + 1 of a one-hot / probability target."""
    t = _tensor(target, device)
    if t.ndim >= 2 and t.shape[-1] > 1:
        return torch.argmax(t, dim=-1) + 1
    return t.reshape(-1).to(torch.int32)


class Top1Accuracy(ValidationMethod):
    """Output (B, C) scores and 1-based targets; a (B,) or (B, 1) output
    is a binary score with threshold 0.5."""

    name = "Top1Accuracy"

    def __call__(self, output, target):
        output = _tensor(output)
        t = _class_target(target, output.device)
        if output.ndim == 1 or output.shape[-1] == 1:
            pred = (output.reshape(-1) > 0.5).to(torch.int32) + 1
        else:
            pred = torch.argmax(output.reshape(-1, output.shape[-1]),
                                dim=-1) + 1
        correct = int((pred == t).sum())
        return AccuracyResult(correct, int(t.shape[0]))


class Top5Accuracy(ValidationMethod):
    name = "Top5Accuracy"

    def __call__(self, output, target):
        output = _tensor(output)
        output = output.reshape(-1, output.shape[-1])
        t = _class_target(target, output.device)
        k = min(5, output.shape[-1])
        # a stable sort, as jnp.argsort: ties rank by index
        topk = torch.argsort(-output, dim=-1, stable=True)[:, :k] + 1
        correct = int(torch.any(topk == t[:, None], dim=-1).sum())
        return AccuracyResult(correct, int(t.shape[0]))


class Loss(ValidationMethod):
    """Average criterion loss (``ClassNLLCriterion`` by default)."""

    name = "Loss"

    def __init__(self, criterion=None):
        from ..nn.criterion import ClassNLLCriterion
        self.criterion = criterion or ClassNLLCriterion()

    def __call__(self, output, target):
        output = _tensor(output)
        loss = self.criterion.loss(output, _tensor(target, output.device))
        n = output.shape[0]
        return LossResult(float(loss) * n, n)


class MAE(ValidationMethod):
    """Mean absolute error."""

    name = "MAE"

    def __call__(self, output, target):
        output = _tensor(output)
        err = torch.mean(torch.abs(output - _tensor(target, output.device)))
        n = output.shape[0]
        return ContiguousResult(float(err) * n, n, "MAE")


def _positive_rank(output, neg_num):
    """Rows of ``neg_num + 1`` scores, the positive first: its 1-based
    rank among them."""
    o = _tensor(output).reshape(-1, neg_num + 1)
    return o, torch.sum(o[:, 1:] > o[:, 0:1], dim=-1) + 1


class HitRatio(ValidationMethod):
    """HR@k for recommendation: the positive item's score first in each
    row of ``neg_num + 1``; a hit when its rank is at most k."""

    name = "HitRatio"

    def __init__(self, k=10, neg_num=100):
        self.k = k
        self.neg_num = neg_num

    def __call__(self, output, target):
        o, rank = _positive_rank(output, self.neg_num)
        hits = int((rank <= self.k).sum())
        return ContiguousResult(float(hits), o.shape[0], "HitRatio")


class NDCG(ValidationMethod):
    """NDCG@k over the same rows as :class:`HitRatio`."""

    name = "NDCG"

    def __init__(self, k=10, neg_num=100):
        self.k = k
        self.neg_num = neg_num

    def __call__(self, output, target):
        o, rank = _positive_rank(output, self.neg_num)
        gain = torch.where(rank <= self.k,
                           1.0 / torch.log2(rank.to(torch.float32) + 1.0),
                           torch.zeros((), device=rank.device))
        return ContiguousResult(float(gain.sum()), o.shape[0], "NDCG")
