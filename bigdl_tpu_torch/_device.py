"""The default-device rule of the port.

An entry point that takes ``device=None`` runs on ``cuda``.  Without a
CUDA device that call raises: the port never moves to the CPU unless the
caller asks for it with ``device="cpu"`` (the CPU tests do).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``.

    Raises ``RuntimeError`` when the answer is a CUDA device and this
    process has none.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bigdl_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def model_device(model) -> torch.device:
    """The device of a model's first tensor, in module order: whatever a
    module's ``_device_tensors()`` gives (parameters, buffers, or the
    constants an int8 module keeps), else its parameters and buffers.
    Raises ``ValueError`` for a model with none."""
    for m in model.modules():
        own = getattr(m, "_device_tensors", None)
        tensors = own() if own is not None else \
            list(m.parameters(recurse=False)) + list(m.buffers(recurse=False))
        for t in tensors:
            return t.device
    raise ValueError(f"{type(model).__name__} holds no tensors")
