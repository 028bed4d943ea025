"""Optimization of the port (≙ ``bigdl_tpu/optim``): the optimization
methods, learning-rate schedules and gradient accumulation that the
training slice runs."""
from .lr_schedule import Default, LearningRateSchedule
from .optim_method import Adam, AdamW, OptimMethod
from .optimizer import make_accum_grads

__all__ = ["Adam", "AdamW", "Default", "LearningRateSchedule",
           "OptimMethod", "make_accum_grads"]
