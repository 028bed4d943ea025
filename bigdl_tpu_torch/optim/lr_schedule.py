"""Learning-rate schedules (≙ ``bigdl_tpu/optim/lr_schedule.py``).

A schedule maps ``(method, step) -> lr``, where ``step`` is the method's
device ``int32`` step tensor, so that a rate can be computed on the device
without a host sync.  Only :class:`Default` is ported so far; the other
schedules of the reference are ROADMAP queue A, item 2.
"""
from __future__ import annotations


class LearningRateSchedule:
    def rate(self, method, step):
        raise NotImplementedError


class Default(LearningRateSchedule):
    """The method's constant ``lr``."""

    def rate(self, method, step):
        return method.lr
