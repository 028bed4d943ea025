"""Fused optimizer update: a hand-written Hopper kernel and its plain
version.

Port of ``bigdl_tpu/kernels/fused_optim.py``, the Adam/AdamW part (K4).

  * an f32 leaf on a CUDA tensor — ``csrc/fused_adam.cu``, which replaces
    the reference's Pallas ``_adam_kernel``: one launch per leaf, one pass
    that reads p, m, v and g once and writes p, m and v in place.
  * a leaf on a CPU tensor, of any dtype — :func:`adam_leaf_plain`, the
    reference's per-leaf math in plain PyTorch ops.  It is also
    ``Adam(fused=False)``'s update and what ``chip_smoke.py`` holds the
    kernel against on the card.
  * a CUDA leaf that the kernel does not take — an empty leaf is left as
    it is (there is nothing to update); a leaf that is not f32 raises.
    The reference sends such a leaf to its tree-map math (``_leaf_ok``);
    on the card the port does not fall back to the plain version without
    being asked: ``fused=False`` asks for it.  Every leaf of
    TransformerLM ``base`` is f32 and goes through the kernel.

Both compute the reference's op order, and the kernel is built without
FMA contraction, so on the card the two agree bit for bit.  Parameters
and moments are updated in place: the counterpart of the reference
trainer donating its buffers.  The step-dependent scalars ``clr``,
``bc1`` and ``bc2`` stay on the device (fp32, one value each); the kernel
reads them through a pointer, so an update costs no host sync.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, Mapping, Tuple

import torch

from ..ops import _build

KERNEL_NAME = "fused_adam"


def _kernel_takes(p, g, m, v) -> bool:
    """Whether the kernel takes a CUDA leaf: True for a non-empty f32 leaf,
    False for an empty one (nothing to update); raises for any other."""
    if p.numel() == 0:
        return False
    dtypes = {str(t.dtype).replace("torch.", "") for t in (p, g, m, v)}
    if dtypes != {"float32"}:
        raise NotImplementedError(
            f"fused_adam: the kernel takes float32 leaves; this leaf "
            f"{tuple(p.shape)} on {p.device} has p/g/m/v dtypes "
            f"{sorted(dtypes)}.  A kernel for other dtypes is not ported "
            f"yet (ROADMAP queue A, item 2); use fused=False for the "
            f"plain update")
    return True


def zip_leaves(*trees) -> Iterator[Tuple[torch.Tensor, ...]]:
    """The leaves of same-structure nested dicts, one tuple per leaf, in
    the first tree's order."""
    first = trees[0]
    if isinstance(first, Mapping):
        for key in first:
            yield from zip_leaves(*(t[key] for t in trees))
    else:
        yield tuple(trees)


# --------------------------------------------------------------------- #
# the plain version                                                     #
# --------------------------------------------------------------------- #
@torch.no_grad()
def adam_leaf_plain(p, g, m, v, *, clr, bc1, bc2, beta1, beta2, eps,
                    weight_decay=0.0) -> None:
    """One leaf of ``Adam.update`` (AdamW's decoupled decay when
    ``weight_decay``), in the reference's op order, one PyTorch op at a
    time; writes p, m and v in place."""
    new_m = beta1 * m + (1 - beta1) * g
    new_v = beta2 * v + (1 - beta2) * g * g
    new_p = p - (clr * (new_m / bc1)
                 / (torch.sqrt(new_v / bc2) + eps)).to(p.dtype)
    if weight_decay:
        new_p = new_p - clr * weight_decay * p
    p.copy_(new_p)
    m.copy_(new_m)
    v.copy_(new_v)


# --------------------------------------------------------------------- #
# the Hopper kernel                                                     #
# --------------------------------------------------------------------- #
def _kernel_fn():
    fn = _build.load(KERNEL_NAME).bigdl_fused_adam
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_float] * 6
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _device_scalar(x, name, dev):
    if not (isinstance(x, torch.Tensor) and x.device == dev
            and x.dtype == torch.float32 and x.numel() == 1):
        raise ValueError(f"fused_adam: {name} must be one float32 value on "
                         f"{dev}, got {x!r}")
    return x.contiguous()


def _adam_cuda(leaves, *, clr, bc1, bc2, beta1, beta2, eps,
               weight_decay) -> None:
    """Launch ``csrc/fused_adam.cu`` once for each ``(p, g, m, v)`` of
    ``leaves`` (f32, all on one CUDA device), on the current stream.  All
    inputs are checked before the first launch; the scalars and the
    stream are looked up once for all the leaves."""
    dev = leaves[0][0].device
    scalars = [_device_scalar(x, n, dev)
               for x, n in ((clr, "clr"), (bc1, "bc1"), (bc2, "bc2"))]
    for p, g, m, v in leaves:
        for name, t in (("m", m), ("v", v), ("g", g)):
            if t.device != dev or t.shape != p.shape:
                raise ValueError(f"fused_adam: {name} {tuple(t.shape)} on "
                                 f"{t.device} does not match p "
                                 f"{tuple(p.shape)} on {dev}")
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("fused_adam: p, m and v are updated in place "
                             "and must be contiguous")
    fn = _kernel_fn()
    tail = (*(t.data_ptr() for t in scalars), beta1, 1 - beta1, beta2,
            1 - beta2, eps, float(weight_decay), int(bool(weight_decay)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for p, g, m, v in leaves:
            g = g.contiguous()
            rc = fn(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                    p.numel(), *tail, stream)
            if rc != 0:
                raise RuntimeError(f"fused_adam kernel launch failed: "
                                   f"cudaError {rc} (leaf {tuple(p.shape)})")
            _build.count_launch(KERNEL_NAME)


def fused_adam_update(params, grads, m, v, *, clr, bc1, bc2, beta1, beta2,
                      eps, weight_decay=0.0):
    """One-pass Adam(W) update over nested dicts of leaves.

    ``clr``/``bc1``/``bc2`` are the step-dependent fp32 scalars the caller
    computed on the leaves' device; ``weight_decay`` > 0 applies AdamW's
    decoupled decay in the same pass.  Updates params, m and v in place
    and returns ``(params, m, v)``.  A CPU leaf goes to
    :func:`adam_leaf_plain`; a CUDA leaf to the kernel, or it raises if it
    is not f32 (an empty one is skipped); a leaf on any other device
    raises.
    """
    kw = dict(clr=clr, bc1=bc1, bc2=bc2, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay)
    by_device = {}
    for leaf in zip_leaves(params, grads, m, v):
        p_ = leaf[0]
        if p_.device.type == "cpu":
            adam_leaf_plain(*leaf, **kw)
        elif p_.device.type == "cuda":
            if _kernel_takes(*leaf):
                by_device.setdefault(p_.device, []).append(leaf)
        else:
            raise RuntimeError(f"fused_adam: no implementation for device "
                               f"{p_.device}")
    for leaves in by_device.values():
        _adam_cuda(leaves, **kw)
    return params, m, v


def fused_adam_update_plain(params, grads, m, v, *, clr, bc1, bc2, beta1,
                            beta2, eps, weight_decay=0.0):
    """:func:`fused_adam_update` on the plain version for every leaf, on
    any device."""
    for p_, g_, m_, v_ in zip_leaves(params, grads, m, v):
        adam_leaf_plain(p_, g_, m_, v_, clr=clr, bc1=bc1, bc2=bc2,
                        beta1=beta1, beta2=beta2, eps=eps,
                        weight_decay=weight_decay)
    return params, m, v
