"""bigdl_tpu_torch — the PyTorch/CUDA port of ``bigdl_tpu``.

``bigdl_tpu`` (JAX on TPU) stays the reference; this package mirrors its
module paths so each counterpart is easy to find
(``bigdl_tpu_torch/serving/engine.py`` ≙ ``bigdl_tpu/serving/engine.py``).
It imports ``torch`` and never ``jax``, and nothing of ``bigdl_tpu``:
modules it needs from there, even JAX-free ones, are kept as copies here.

Every TPU kernel the ported path runs becomes a hand-written Hopper
kernel (``csrc/``), built with ``nvcc`` at first use.  A CUDA tensor goes
to the kernel or the call raises; the plain PyTorch version of each
kernel runs only for tensors that lie on the CPU.

Entry points put their work on ``cuda`` unless the caller passes
``device="cpu"`` (see :func:`resolve_device`).

What is ported so far, slice by slice, is listed in ``README.md`` (the
"PyTorch/CUDA port" section); what is not is ROADMAP.md's queue A.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
