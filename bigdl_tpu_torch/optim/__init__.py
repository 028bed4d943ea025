"""Optimization of the port (≙ ``bigdl_tpu/optim``): the optimization
methods, learning-rate schedules, regularizers, triggers, gradient
accumulation and clipping, the ``LocalOptimizer`` and ``DistriOptimizer``
loops, validation methods, the ``Predictor`` and ``Evaluator`` entry
points and the ``PredictionService`` facade."""
from .distri_optimizer import DistriOptimizer
from .lr_schedule import (Default, EpochDecay, EpochStep, Exponential,
                          LearningRateSchedule, MultiStep, NaturalExp,
                          Plateau, Poly, SequentialSchedule, Step, Warmup)
from .optim_method import (LAMB, LARS, LBFGS, SGD, Adadelta, Adagrad, Adam,
                           Adamax, AdamW, Ftrl, OptimMethod, RMSprop)
from .optimizer import (LocalOptimizer, Optimizer, TrainingState,
                        make_accum_grads, make_accum_train_step,
                        make_eval_step, make_train_step, mask_frozen_grads)
from .regularizer import L1L2Regularizer, L1Regularizer, L2Regularizer
from .predictor import (Evaluator, LocalPredictor, PredictionService,
                        Predictor)
from .trigger import Trigger
from .validation import (MAE, NDCG, AccuracyResult, ContiguousResult,
                         HitRatio, Loss, LossResult, Top1Accuracy,
                         Top5Accuracy, ValidationMethod, ValidationResult)

__all__ = ["AccuracyResult", "Adadelta", "Adagrad", "Adam", "Adamax",
           "AdamW", "ContiguousResult", "Default",
           "DistriOptimizer", "EpochDecay", "EpochStep", "Evaluator",
           "Exponential", "Ftrl", "HitRatio", "L1L2Regularizer", "L1Regularizer",
           "L2Regularizer", "LAMB", "LARS", "LBFGS", "LearningRateSchedule", "LocalOptimizer",
           "LocalPredictor", "Loss", "LossResult", "MAE", "MultiStep",
           "NDCG", "NaturalExp", "OptimMethod", "Optimizer", "Plateau",
           "Poly", "PredictionService", "Predictor", "RMSprop", "SGD", "SequentialSchedule", "Step",
           "Top1Accuracy", "Top5Accuracy", "TrainingState", "Trigger",
           "ValidationMethod", "ValidationResult", "Warmup",
           "make_accum_grads", "make_accum_train_step", "make_eval_step",
           "make_train_step", "mask_frozen_grads"]
