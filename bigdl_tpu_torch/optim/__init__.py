"""Optimization of the port (≙ ``bigdl_tpu/optim``): the optimization
methods, learning-rate schedules, triggers, gradient accumulation, the
``LocalOptimizer`` and ``DistriOptimizer`` loops, validation methods and
the ``Predictor`` and ``Evaluator`` entry points."""
from .distri_optimizer import DistriOptimizer
from .lr_schedule import Default, LearningRateSchedule
from .optim_method import SGD, Adam, AdamW, OptimMethod
from .optimizer import (LocalOptimizer, Optimizer, TrainingState,
                        make_accum_grads, make_eval_step, make_train_step)
from .predictor import Evaluator, LocalPredictor, Predictor
from .trigger import Trigger
from .validation import (MAE, NDCG, AccuracyResult, ContiguousResult,
                         HitRatio, Loss, LossResult, Top1Accuracy,
                         Top5Accuracy, ValidationMethod, ValidationResult)

__all__ = ["AccuracyResult", "Adam", "AdamW", "ContiguousResult", "Default",
           "DistriOptimizer", "Evaluator", "HitRatio", "LearningRateSchedule",
           "LocalOptimizer", "LocalPredictor", "Loss", "LossResult", "MAE",
           "NDCG", "OptimMethod", "Optimizer", "Predictor", "SGD",
           "Top1Accuracy", "Top5Accuracy", "TrainingState", "Trigger",
           "ValidationMethod", "ValidationResult", "make_accum_grads",
           "make_eval_step", "make_train_step"]
