"""Fused optimizer updates: hand-written Hopper kernels and their plain
versions.

Port of ``bigdl_tpu/kernels/fused_optim.py``: Adam/AdamW (K4,
``csrc/fused_adam.cu``), SGD with momentum (K5) and plain SGD (K6), both
in ``csrc/fused_sgd.cu``.  For each leaf:

  * an f32 leaf on a CUDA tensor — the kernel, which replaces the
    reference's Pallas kernel: one launch per leaf, one pass that reads
    each input once and writes the parameter (and its moments or
    velocity) in place.
  * a leaf on a CPU tensor, of any dtype — the plain version
    (:func:`adam_leaf_plain`, :func:`sgd_leaf_plain`), the reference's
    per-leaf math in plain PyTorch ops.  It is also ``fused=False``'s
    update and what ``chip_smoke.py`` holds the kernel against on the
    card.
  * a CUDA leaf that the kernel does not take — an empty leaf is left as
    it is (there is nothing to update); a leaf that is not f32 raises.
    The reference sends such a leaf to its tree-map math (``_leaf_ok``);
    on the card the port does not fall back to the plain version without
    being asked: ``fused=False`` asks for it.  Every leaf of
    TransformerLM ``base``, ResNet-50 and LeNet-5 is f32 and goes through
    a kernel.

Both compute the reference's op order, and the kernels are built without
FMA contraction, so on the card the two agree bit for bit.  Parameters,
moments and velocities are updated in place: the counterpart of the
reference trainer donating its buffers.  The step-dependent scalars
(``clr``; Adam's ``bc1`` and ``bc2``) stay on the device (fp32, one value
each); the kernels read them through a pointer, so an update costs no
host sync.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, Mapping, Tuple

import torch

from ..ops import _build

KERNEL_NAME = "fused_adam"
SGD_MOM = "fused_sgd_mom"
SGD_PLAIN = "fused_sgd_plain"


def _kernel_takes(*leaf, kernel=KERNEL_NAME) -> bool:
    """Whether ``kernel`` takes a CUDA leaf ``(p, g, ...)``: True for a
    non-empty f32 leaf, False for an empty one (nothing to update); raises
    for any other."""
    p = leaf[0]
    if p.numel() == 0:
        return False
    dtypes = {str(t.dtype).replace("torch.", "") for t in leaf}
    if dtypes != {"float32"}:
        raise NotImplementedError(
            f"{kernel}: the kernel takes float32 leaves; this leaf "
            f"{tuple(p.shape)} on {p.device} has dtypes "
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
_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
# C function -> (source, argtypes)
_C_FUNCS = {
    "bigdl_fused_adam": ("fused_adam",
                         [_P] * 4 + [_I64] + [_P] * 3 + [_F] * 6 + [_I, _P]),
    "bigdl_fused_sgd_mom": ("fused_sgd",
                            [_P] * 3 + [_I64, _P] + [_F] * 3 + [_I, _I, _P]),
    "bigdl_fused_sgd_plain": ("fused_sgd", [_P, _P, _I64, _P, _F, _I, _P]),
}


def _kernel_fn(c_name="bigdl_fused_adam"):
    source, argtypes = _C_FUNCS[c_name]
    fn = getattr(_build.load(source), c_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _device_scalar(x, name, dev, kernel=KERNEL_NAME):
    if not (isinstance(x, torch.Tensor) and x.device == dev
            and x.dtype == torch.float32 and x.numel() == 1):
        raise ValueError(f"{kernel}: {name} must be one float32 value on "
                         f"{dev}, got {x!r}")
    return x.contiguous()


def _check_leaves(leaves, kernel, in_place):
    """Every tensor of each leaf ``(p, g, ...)`` on p's device and of p's
    shape, and the tensors updated in place (p and the state after g)
    contiguous; raises before any launch otherwise."""
    for leaf in leaves:
        p, g, state = leaf[0], leaf[1], leaf[2:]
        for name, t in zip(("g",) + in_place[1:], (g,) + state):
            if t.device != p.device or t.shape != p.shape:
                raise ValueError(f"{kernel}: {name} {tuple(t.shape)} on "
                                 f"{t.device} does not match p "
                                 f"{tuple(p.shape)} on {p.device}")
        if not all(t.is_contiguous() for t in (p,) + state):
            raise ValueError(f"{kernel}: {', '.join(in_place)} are updated "
                             f"in place and must be contiguous")


def _adam_cuda(leaves, *, clr, bc1, bc2, beta1, beta2, eps,
               weight_decay) -> None:
    """Launch ``csrc/fused_adam.cu`` once for each ``(p, g, m, v)`` of
    ``leaves`` (f32, all on one CUDA device), on the current stream.  All
    inputs are checked before the first launch; the scalars and the
    stream are looked up once for all the leaves."""
    dev = leaves[0][0].device
    scalars = [_device_scalar(x, n, dev)
               for x, n in ((clr, "clr"), (bc1, "bc1"), (bc2, "bc2"))]
    _check_leaves(leaves, KERNEL_NAME, ("p", "m", "v"))
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


# --------------------------------------------------------------------- #
# SGD: K5 (momentum) and K6 (plain)                                     #
# --------------------------------------------------------------------- #
@torch.no_grad()
def sgd_leaf_plain(p, g, v=None, *, clr, momentum=0.0, dampening=0.0,
                   nesterov=False, weight_decay=0.0) -> None:
    """One leaf of ``SGD.update``, in the reference's op order, one PyTorch
    op at a time; writes p (and the velocity v, given when the method has
    momentum) in place."""
    if weight_decay > 0:
        g = g + weight_decay * p
    if v is not None:
        vel = momentum * v + (1.0 - dampening) * g
        g = g + momentum * vel if nesterov else vel
        v.copy_(vel)
    p.copy_(p - clr * g.to(p.dtype))


def _sgd_cuda(leaves, *, clr, momentum, dampening, nesterov,
              weight_decay) -> None:
    """Launch K5 (leaves ``(p, g, v)``) or K6 (leaves ``(p, g)``) once for
    each leaf (f32, all on one CUDA device), on the current stream.  All
    inputs are checked before the first launch."""
    dev = leaves[0][0].device
    mom = len(leaves[0]) == 3
    kernel = SGD_MOM if mom else SGD_PLAIN
    clr_t = _device_scalar(clr, "clr", dev, kernel)
    _check_leaves(leaves, kernel, ("p", "v") if mom else ("p",))
    decay = int(weight_decay > 0)
    if mom:
        fn = _kernel_fn("bigdl_fused_sgd_mom")
        tail = (clr_t.data_ptr(), momentum, 1.0 - dampening,
                float(weight_decay), decay, int(bool(nesterov)))
    else:
        fn = _kernel_fn("bigdl_fused_sgd_plain")
        tail = (clr_t.data_ptr(), float(weight_decay), decay)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for leaf in leaves:
            p, g = leaf[0], leaf[1].contiguous()
            ptrs = (p.data_ptr(), leaf[2].data_ptr()) if mom \
                else (p.data_ptr(),)
            rc = fn(*ptrs, g.data_ptr(), p.numel(), *tail, stream)
            if rc != 0:
                raise RuntimeError(f"{kernel} kernel launch failed: "
                                   f"cudaError {rc} (leaf {tuple(p.shape)})")
            _build.count_launch(kernel)


def fused_sgd_update(params, grads, velocity=None, *, clr, momentum=0.0,
                     dampening=0.0, nesterov=False, weight_decay=0.0):
    """One-pass SGD update over nested dicts of leaves: K5 when
    ``momentum > 0`` and a velocity is given, else K6.  ``clr`` is the
    step's fp32 learning rate on the leaves' device.  Updates params (and
    velocity) in place and returns ``(params, velocity)``.  A CPU leaf
    goes to :func:`sgd_leaf_plain`; a CUDA leaf to the kernel, or it
    raises if it is not f32 (an empty one is skipped); a leaf on any other
    device raises."""
    mom = momentum > 0 and velocity is not None
    kernel = SGD_MOM if mom else SGD_PLAIN
    kw = dict(clr=clr, momentum=momentum, dampening=dampening,
              nesterov=nesterov, weight_decay=weight_decay)
    trees = (params, grads, velocity) if mom else (params, grads)
    by_device = {}
    for leaf in zip_leaves(*trees):
        p_ = leaf[0]
        if p_.device.type == "cpu":
            sgd_leaf_plain(*leaf, **kw)
        elif p_.device.type == "cuda":
            if _kernel_takes(*leaf, kernel=kernel):
                by_device.setdefault(p_.device, []).append(leaf)
        else:
            raise RuntimeError(f"{kernel}: no implementation for device "
                               f"{p_.device}")
    for leaves in by_device.values():
        _sgd_cuda(leaves, **kw)
    return params, (velocity if mom else None)


def fused_sgd_update_plain(params, grads, velocity=None, *, clr,
                           momentum=0.0, dampening=0.0, nesterov=False,
                           weight_decay=0.0):
    """:func:`fused_sgd_update` on the plain version for every leaf, on any
    device."""
    mom = momentum > 0 and velocity is not None
    kw = dict(clr=clr, momentum=momentum, dampening=dampening,
              nesterov=nesterov, weight_decay=weight_decay)
    trees = (params, grads, velocity) if mom else (params, grads)
    for leaf in zip_leaves(*trees):
        sgd_leaf_plain(*leaf, **kw)
    return params, (velocity if mom else None)
