"""Optimization of the port (≙ ``bigdl_tpu/optim``): the optimization
methods, learning-rate schedules, triggers, gradient accumulation and the
``LocalOptimizer`` loop that the ported slices run."""
from .lr_schedule import Default, LearningRateSchedule
from .optim_method import SGD, Adam, AdamW, OptimMethod
from .optimizer import (LocalOptimizer, Optimizer, TrainingState,
                        make_accum_grads, make_train_step)
from .trigger import Trigger

__all__ = ["Adam", "AdamW", "Default", "LearningRateSchedule",
           "LocalOptimizer", "OptimMethod", "Optimizer", "SGD",
           "TrainingState", "Trigger", "make_accum_grads", "make_train_step"]
