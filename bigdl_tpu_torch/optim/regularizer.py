"""Per-layer weight regularizers (≙ ``bigdl_tpu/optim/regularizer.py``,
optim/Regularizer.scala: L1Regularizer, L2Regularizer, L1L2Regularizer).

A layer built with ``w_regularizer`` / ``b_regularizer`` holds one; the
penalty is summed into the training loss through
``Module.regularization_loss``, so its gradient comes from autograd, as
the reference's comes from AD.
"""
from __future__ import annotations

import torch


class Regularizer:
    def __call__(self, param):
        raise NotImplementedError


class L1L2Regularizer(Regularizer):
    """l1 * sum|p| + 0.5 * l2 * sum(p * p)."""

    def __init__(self, l1=0.0, l2=0.0):
        self.l1 = l1
        self.l2 = l2

    def __call__(self, param):
        loss = 0.0
        if self.l1:
            # |p| whose gradient at 0 is +1, as the reference's (jnp.abs
            # differentiates to 1 there; torch.abs to 0)
            loss = loss + self.l1 * torch.sum(
                torch.where(param >= 0, param, -param))
        if self.l2:
            loss = loss + 0.5 * self.l2 * torch.sum(param * param)
        return loss


class L1Regularizer(L1L2Regularizer):
    def __init__(self, l1):
        super().__init__(l1=l1, l2=0.0)


class L2Regularizer(L1L2Regularizer):
    def __init__(self, l2):
        super().__init__(l1=0.0, l2=l2)
