"""Training across devices (≙ ``bigdl_tpu/parallel``); so far the
single-device :class:`SpmdTrainer`."""
from .spmd import SpmdTrainer

__all__ = ["SpmdTrainer"]
