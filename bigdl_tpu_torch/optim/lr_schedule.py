"""Learning-rate schedules (≙ ``bigdl_tpu/optim/lr_schedule.py``,
optim/SGD.scala's LearningRateSchedule objects: Default, Step, MultiStep,
Exponential, NaturalExp, Poly, Warmup, SequentialSchedule, EpochDecay,
EpochStep and Plateau).

A schedule maps ``(method, step) -> rate``, where ``step`` is the
method's device ``int32`` step tensor: every rate that depends on the
step is an fp32 device scalar computed from it in the reference's op
order, so that a step reads its rate without a host sync.  A rate that
does not depend on the step (``Default``, ``Plateau``) is a host float,
which the method fills into a device scalar.  ``Plateau`` is driven by a
metric at each epoch's end (:meth:`Plateau.on_epoch_end`); the step reads
its current factor.
"""
from __future__ import annotations

import torch


def _fill(value, step):
    """``value`` as an fp32 scalar on ``step``'s device: a tensor as it
    is, a host float filled on the device (no copy from the host)."""
    if isinstance(value, torch.Tensor):
        return value.to(torch.float32)
    return torch.full((), value, dtype=torch.float32, device=step.device)


class LearningRateSchedule:
    def rate(self, method, step):
        raise NotImplementedError


class Default(LearningRateSchedule):
    """The method's constant ``lr``."""

    def rate(self, method, step):
        return method.lr


class Step(LearningRateSchedule):
    """lr * gamma^(floor(step / step_size)) (optim/SGD.scala Step)."""

    def __init__(self, step_size, gamma):
        self.step_size = step_size
        self.gamma = gamma

    def rate(self, method, step):
        return method.lr * torch.pow(self.gamma,
                                     torch.floor(step / self.step_size))


class MultiStep(LearningRateSchedule):
    """Decay by gamma at each listed step (optim/SGD.scala MultiStep)."""

    def __init__(self, step_sizes, gamma):
        self.step_sizes = list(step_sizes)
        self.gamma = gamma

    def rate(self, method, step):
        n = torch.zeros((), dtype=torch.int32, device=step.device)
        for s in self.step_sizes:
            n = n + (step >= s).to(torch.int32)
        return method.lr * torch.pow(self.gamma, n)


class Exponential(LearningRateSchedule):
    """lr * decay_rate^(step / decay_step) (optim/SGD.scala Exponential)."""

    def __init__(self, decay_step, decay_rate, staircase=False):
        self.decay_step = decay_step
        self.decay_rate = decay_rate
        self.staircase = staircase

    def rate(self, method, step):
        e = step / self.decay_step
        if self.staircase:
            e = torch.floor(e)
        return method.lr * torch.pow(self.decay_rate, e)


class NaturalExp(LearningRateSchedule):
    """lr * exp(-gamma * floor(step / decay_step))."""

    def __init__(self, decay_step, gamma):
        self.decay_step = decay_step
        self.gamma = gamma

    def rate(self, method, step):
        return method.lr * torch.exp(
            -self.gamma * torch.floor(step / self.decay_step))


class Poly(LearningRateSchedule):
    """lr * (1 - step / max_iteration)^power (optim/SGD.scala Poly)."""

    def __init__(self, power, max_iteration):
        self.power = power
        self.max_iteration = max_iteration

    def rate(self, method, step):
        frac = torch.clamp(step / self.max_iteration, max=1.0)
        return method.lr * torch.pow(1.0 - frac, self.power)


class Warmup(LearningRateSchedule):
    """lr + delta * step: a linear warmup, run for its ``max_iteration``
    steps inside a :class:`SequentialSchedule` (optim/SGD.scala Warmup)."""

    def __init__(self, delta):
        self.delta = delta

    def rate(self, method, step):
        return method.lr + self.delta * step


class SequentialSchedule(LearningRateSchedule):
    """Chain schedules, each active for its ``max_iteration`` steps and
    given the step counted from its own start; the last one runs on
    (optim/SGD.scala SequentialSchedule)."""

    def __init__(self, iteration_per_epoch=1):
        self.schedules = []
        self.cutoffs = []
        self.iteration_per_epoch = iteration_per_epoch

    def add(self, schedule, max_iteration):
        start = self.cutoffs[-1] if self.cutoffs else 0
        self.schedules.append(schedule)
        self.cutoffs.append(start + max_iteration)
        return self

    def rate(self, method, step):
        rate = _fill(self.schedules[-1].rate(
            method, step - (self.cutoffs[-2] if len(self.cutoffs) > 1
                            else 0)), step)
        starts = [0] + self.cutoffs[:-1]
        for sched, start, end in zip(reversed(self.schedules[:-1]),
                                     reversed(starts[:-1]),
                                     reversed(self.cutoffs[:-1])):
            local = _fill(sched.rate(method, step - start), step)
            rate = torch.where(step < end, local, rate)
        return rate


class EpochDecay(LearningRateSchedule):
    """lr * 0.1^decay_fn(epoch), the epoch counted from the step
    (optim/SGD.scala EpochDecay); ``decay_fn`` takes and returns device
    tensors."""

    def __init__(self, decay_fn, iteration_per_epoch):
        self.decay_fn = decay_fn
        self.iteration_per_epoch = iteration_per_epoch

    def rate(self, method, step):
        epoch = torch.div(step, self.iteration_per_epoch,
                          rounding_mode="floor")
        return method.lr * torch.pow(0.1, self.decay_fn(epoch))


class EpochStep(LearningRateSchedule):
    """lr * gamma^(epoch // step_size) (optim/SGD.scala EpochStep)."""

    def __init__(self, step_size, gamma, iteration_per_epoch=1):
        self.step_size = step_size
        self.gamma = gamma
        self.iteration_per_epoch = iteration_per_epoch

    def rate(self, method, step):
        epoch = torch.div(step, self.iteration_per_epoch,
                          rounding_mode="floor")
        return method.lr * torch.pow(
            self.gamma, torch.div(epoch, self.step_size,
                                  rounding_mode="floor"))


class Plateau(LearningRateSchedule):
    """Reduce the rate when a monitored metric stops improving
    (optim/SGD.scala Plateau).  The optimizer calls
    :meth:`on_epoch_end` with the epoch's validation score (or its loss
    without one); each step reads the current factor."""

    def __init__(self, monitor="score", factor=0.1, patience=10, mode="min",
                 epsilon=1e-4, cooldown=0, min_lr=0.0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.current_factor = 1.0
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def _improved(self, metric):
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best - self.epsilon
        return metric > self.best + self.epsilon

    def on_epoch_end(self, metric):
        if self._improved(metric):
            self.best = metric
            self.wait = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.current_factor *= self.factor
                self.wait = 0
                self.cooldown_counter = self.cooldown

    def rate(self, method, step):
        return max(method.lr * self.current_factor, self.min_lr)
