"""Utilities of the port (≙ ``bigdl_tpu/utils``)."""
from .retry import RetryPolicy

__all__ = ["RetryPolicy"]
