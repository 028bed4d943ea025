"""Triggers gating validation/checkpoint/summary/termination
(≙ optim/Trigger.scala: everyEpoch, severalIteration, maxEpoch, maxIteration,
maxScore, minLoss, and, or — plus everySeconds, the wall-clock checkpoint
cadence production jobs actually use).

A trigger is `apply(state) -> bool` where state is the optimizer's host-side
TrainingState (epoch, iteration ["neval"], loss, score).

A copy of ``bigdl_tpu/optim/trigger.py`` (plain Python): the port imports
nothing of the reference.
"""
from __future__ import annotations

import time


class Trigger:
    def __call__(self, state) -> bool:
        raise NotImplementedError

    @staticmethod
    def every_epoch():
        return _EveryEpoch()

    @staticmethod
    def several_iteration(interval):
        return _SeveralIteration(interval)

    @staticmethod
    def max_epoch(max_epoch):
        return _MaxEpoch(max_epoch)

    @staticmethod
    def max_iteration(max_iteration):
        return _MaxIteration(max_iteration)

    @staticmethod
    def max_score(max_score):
        return _MaxScore(max_score)

    @staticmethod
    def min_loss(min_loss):
        return _MinLoss(min_loss)

    @staticmethod
    def every_seconds(seconds, _clock=time.monotonic):
        """Fire when at least ``seconds`` of wall time passed since the
        last firing (armed at construction) — the common production
        checkpoint cadence: step time varies with compile/stragglers,
        but the recovery budget is measured in minutes lost."""
        return _EverySeconds(seconds, _clock)

    @staticmethod
    def and_(*triggers):
        return _And(triggers)

    @staticmethod
    def or_(*triggers):
        return _Or(triggers)


class _EveryEpoch(Trigger):
    def __init__(self):
        self.last_epoch = None

    def __call__(self, state):
        if state.epoch_finished and state.epoch != self.last_epoch:
            self.last_epoch = state.epoch
            return True
        return False


class _SeveralIteration(Trigger):
    def __init__(self, interval):
        self.interval = interval

    def __call__(self, state):
        return state.iteration > 0 and state.iteration % self.interval == 0


class _EverySeconds(Trigger):
    def __init__(self, seconds, clock):
        if seconds <= 0:
            raise ValueError("every_seconds interval must be > 0")
        self.seconds = float(seconds)
        self._clock = clock
        self._last = clock()

    def __call__(self, state):
        now = self._clock()
        if now - self._last >= self.seconds:
            # advance to NOW (not by one interval): a long stall must not
            # cause a burst of back-to-back catch-up checkpoints
            self._last = now
            return True
        return False


class _MaxEpoch(Trigger):
    def __init__(self, max_epoch):
        self.max_epoch = max_epoch

    def __call__(self, state):
        return state.epoch > self.max_epoch

class _MaxIteration(Trigger):
    def __init__(self, max_iteration):
        self.max_iteration = max_iteration

    def __call__(self, state):
        return state.iteration >= self.max_iteration


class _MaxScore(Trigger):
    def __init__(self, max_score):
        self.max_score = max_score

    def __call__(self, state):
        return state.score is not None and state.score > self.max_score


class _MinLoss(Trigger):
    def __init__(self, min_loss):
        self.min_loss = min_loss

    def __call__(self, state):
        return state.loss is not None and state.loss < self.min_loss


class _And(Trigger):
    def __init__(self, triggers):
        self.triggers = triggers

    def __call__(self, state):
        return all(t(state) for t in self.triggers)


class _Or(Trigger):
    def __init__(self, triggers):
        self.triggers = triggers

    def __call__(self, state):
        return any(t(state) for t in self.triggers)
