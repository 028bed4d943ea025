"""Fused optimizer updates: hand-written Hopper kernels and their plain
versions.

Port of ``bigdl_tpu/kernels/fused_optim.py``: Adam/AdamW (K4,
``csrc/fused_adam.cu``), SGD with momentum (K5) and plain SGD (K6), both
in ``csrc/fused_sgd.cu``.  For each leaf:

  * a leaf on a CUDA tensor whose tensors are all f32, or all bf16 — the
    kernel, which replaces the reference's Pallas kernel: one pass that
    reads each input once and writes the parameter (and its moments or
    velocity) in place.  Each kernel launches once per update and dtype
    over a table of all the leaves of that dtype on one device
    (:func:`leaf_tables`), split into ``ceil(leaves / capacity)``
    launches only past the table's size (:data:`ADAM_CAPACITY`,
    :data:`SGD_CAPACITY`).  A bf16 leaf takes the kernel's bf16
    instantiation: the reference's per-leaf math for a leaf that is not
    f32 (its ``_leaf_ok`` tree-map path), which the kernel computes as
    the plain version does.
  * a leaf on a CPU tensor, of any dtype — the plain version
    (:func:`adam_leaf_plain`, :func:`sgd_leaf_plain`), the reference's
    per-leaf math in plain PyTorch ops.  It is also ``fused=False``'s
    update and what ``chip_smoke.py`` holds the kernel against on the
    card.
  * a CUDA leaf that the kernels do not take — an empty leaf is left as
    it is (there is nothing to update); a leaf of another dtype, or of
    mixed dtypes, raises.  On the card the port does not fall back to
    the plain version without being asked: ``fused=False`` asks for it.

Both compute the reference's op order: on a bf16 leaf each Python scalar
(``beta1``, ``1 - beta1``, ``momentum``, ...) is first rounded to bf16, as
JAX rounds the reference's weakly typed scalars to the leaf's dtype, and
each op's float result is rounded to bf16, as PyTorch's eager ops round
it.  The kernels are built without FMA contraction, so on the card the
two agree bit for bit.  Parameters,
moments and velocities are updated in place: the counterpart of the
reference trainer donating its buffers.  The step-dependent scalars
(``clr``; Adam's ``bc1`` and ``bc2``) stay on the device (fp32, one value
each); the kernels read them through a pointer, so an update costs no
host sync.
"""
from __future__ import annotations

import ctypes
import functools
from array import array
from itertools import accumulate
from operator import attrgetter, or_
from typing import List, Mapping, Optional, Tuple

import torch

from ..ops import _build

KERNEL_NAME = "fused_adam"
SGD_MOM = "fused_sgd_mom"
SGD_PLAIN = "fused_sgd_plain"


_F32 = torch.float32
_BF16 = torch.bfloat16
# the dtypes a kernel takes -> (suffix of its C function, the alignment
# its vector path needs)
_KERNEL_DTYPES = {_F32: ("", 16), _BF16: ("_bf16", 8)}
# per-tensor reads, mapped over a column of leaves
_dtype, _shape = attrgetter("dtype"), attrgetter("shape")
_numel, _data_ptr = torch.Tensor.numel, torch.Tensor.data_ptr
_get_device, _is_contiguous = (torch.Tensor.get_device,
                               torch.Tensor.is_contiguous)
_is_cuda = attrgetter("is_cuda")


def _kernel_takes(leaves, kernel):
    """The CUDA ``leaves`` (each ``(p, g, ...)``) that ``kernel`` takes,
    by dtype: ``{dtype: leaves}``, the non-empty ones (nothing to update
    in an empty one), each f32 throughout or bf16 throughout; raises for
    a leaf of any other dtype or of mixed dtypes.  A tree of one dtype is
    checked one column of leaves at a time."""
    numels = list(map(_numel, (leaf[0] for leaf in leaves)))
    if 0 in numels:
        leaves = [leaf for leaf, n in zip(leaves, numels) if n]
    if not leaves:
        return {}
    first = leaves[0][0].dtype
    if first in _KERNEL_DTYPES and all(
            set(map(_dtype, col)) == {first} for col in zip(*leaves)):
        return {first: leaves}
    groups = {}
    for leaf in leaves:
        dtypes = set(map(_dtype, leaf))
        if len(dtypes) != 1 or leaf[0].dtype not in _KERNEL_DTYPES:
            p = leaf[0]
            names = sorted(str(t).replace("torch.", "") for t in dtypes)
            raise NotImplementedError(
                f"{kernel}: the kernel takes float32 leaves or bfloat16 "
                f"leaves, each of one dtype throughout; this leaf "
                f"{tuple(p.shape)} "
                f"on {p.device} has dtypes {names}; use fused=False for "
                f"the plain update")
        groups.setdefault(leaf[0].dtype, []).append(leaf)
    return groups


def zip_leaves(*trees) -> List[Tuple[torch.Tensor, ...]]:
    """The leaves of same-structure nested dicts, one tuple per leaf, in
    the first tree's order."""
    if not _is_node(trees[0]):
        return [trees]
    out: List[Tuple[torch.Tensor, ...]] = []
    _zip_into(trees, out)
    return out


def _is_node(x) -> bool:
    # a dict first: the ABC check alone costs a few hundred ns a leaf
    return isinstance(x, dict) or (not isinstance(x, torch.Tensor)
                                   and isinstance(x, Mapping))


def _zip_into(nodes, out) -> None:
    for key in nodes[0]:
        child = tuple([t[key] for t in nodes])
        if _is_node(child[0]):
            _zip_into(child, out)
        else:
            out.append(child)


# --------------------------------------------------------------------- #
# the plain version                                                     #
# --------------------------------------------------------------------- #
def _as(x, dtype):
    """A device scalar ``x`` in ``dtype`` (a Python number stays one)."""
    return x.to(dtype) if isinstance(x, torch.Tensor) else x


@functools.lru_cache(maxsize=None)
def _in(x: float, dtype: torch.dtype) -> float:
    """The Python number ``x`` rounded to ``dtype``: what a weakly typed
    scalar of the reference becomes beside a leaf of that dtype.  ``x``
    itself for f32, since an op on an f32 leaf (and the kernel's float
    argument) rounds it to f32 already."""
    if dtype == _F32:
        return x
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


@torch.no_grad()
def adam_leaf_plain(p, g, m, v, *, clr, bc1, bc2, beta1, beta2, eps,
                    weight_decay=0.0) -> None:
    """One leaf of ``Adam.update`` (AdamW's decoupled decay when
    ``weight_decay``), in the reference's op order, one PyTorch op at a
    time; writes p, m and v in place.  On a bf16 leaf the moments are
    bf16 (each op rounded, ``beta1``, ``1 - beta1``, ``beta2`` and
    ``1 - beta2`` rounded to bf16 first), and the step is f32, as the
    reference's f32 ``clr``, ``bc1`` and ``bc2`` promote it, then cast to
    the leaf's dtype; AdamW's ``clr * weight_decay`` is cast to it
    first."""
    dt = p.dtype
    new_m = _in(beta1, dt) * m + _in(1 - beta1, dt) * g
    new_v = _in(beta2, dt) * v + _in(1 - beta2, dt) * g * g
    new_p = p - (clr * (new_m.to(_F32) / bc1)
                 / (torch.sqrt(new_v.to(_F32) / bc2) + eps)).to(p.dtype)
    if weight_decay:
        new_p = new_p - _as(clr * weight_decay, p.dtype) * p
    p.copy_(new_p)
    m.copy_(new_m)
    v.copy_(new_v)


# --------------------------------------------------------------------- #
# the Hopper kernels: one launch per table of leaves                    #
# --------------------------------------------------------------------- #
# The kernels' tables (csrc/multi_tensor.cuh): leaves a launch of K4
# (csrc/fused_adam.cu) and of K5/K6 (csrc/fused_sgd.cu), and elements a
# block, one value for all three (each library's own values are checked
# against these when it is loaded)
ADAM_CAPACITY = 616
SGD_CAPACITY = 720
CHUNK = 4096
# meta of a leaf in a table: n, first chunk, I and H*W of a channels-last
# gradient (0, 0 when it is contiguous), float4 flag
_META = 5

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C function -> (source, argtypes): a table (ptrs, meta, count), then the
# kernel's scalars and the stream
_C_FUNCS = {
    "bigdl_fused_adam": ("fused_adam",
                         [_P, _P, _I] + [_P] * 3 + [_F] * 6 + [_I, _P]),
    "bigdl_fused_sgd_mom": ("fused_sgd",
                            [_P, _P, _I, _P] + [_F] * 3 + [_I, _I, _P]),
    "bigdl_fused_sgd_plain": ("fused_sgd", [_P, _P, _I, _P, _F, _I, _P]),
}
# each kernel's bf16 instantiation takes its f32 one's arguments
_C_FUNCS.update({f"{name}_bf16": spec for name, spec in _C_FUNCS.items()})
_CAPACITY = {"fused_adam": ADAM_CAPACITY, "fused_sgd": SGD_CAPACITY}
_TABLE_FNS = {}


def _table_fn(c_name):
    """The C function ``c_name``, its library's table checked against
    :data:`_CAPACITY` and :data:`CHUNK` on first use."""
    fn = _TABLE_FNS.get(c_name)
    if fn is None:
        source, argtypes = _C_FUNCS[c_name]
        lib = _build.load(source)
        got = (getattr(lib, f"bigdl_{source}_capacity")(),
               getattr(lib, f"bigdl_{source}_chunk")())
        want = (_CAPACITY[source], CHUNK)
        if got != want:
            raise RuntimeError(f"csrc/{source}.cu has (capacity, chunk) "
                               f"{got}; the wrapper expects {want}")
        fn = getattr(lib, c_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _TABLE_FNS[c_name] = fn
    return fn


def _adam_fn(dtype=_F32):
    """K4's C function for leaves of ``dtype``."""
    return _table_fn("bigdl_fused_adam" + _KERNEL_DTYPES[dtype][0])


def _device_scalar(x, name, dev, kernel=KERNEL_NAME):
    if not (isinstance(x, torch.Tensor) and x.device == dev
            and x.dtype == torch.float32 and x.numel() == 1):
        raise ValueError(f"{kernel}: {name} must be one float32 value on "
                         f"{dev}, got {x!r}")
    return x.contiguous()


def _check_leaves(leaves, kernel, in_place):
    """Every tensor of each leaf ``(p, g, ...)`` on p's device and of p's
    shape, and the tensors updated in place (p and the state after g)
    contiguous; raises before any launch otherwise.  Checked one column of
    leaves at a time."""
    cols = list(zip(*leaves))
    ps, state = cols[0], cols[2:]
    shapes, devs = list(map(_shape, ps)), list(map(_get_device, ps))
    for name, col in zip(("g",) + tuple(in_place[1:]), cols[1:]):
        if (list(map(_shape, col)) != shapes
                or list(map(_get_device, col)) != devs):
            p, t = next((p, t) for p, t in zip(ps, col)
                        if t.shape != p.shape
                        or t.get_device() != p.get_device())
            raise ValueError(f"{kernel}: {name} {tuple(t.shape)} on "
                             f"{t.device} does not match p "
                             f"{tuple(p.shape)} on {p.device}")
    if not all(all(map(_is_contiguous, col)) for col in (ps, *state)):
        raise ValueError(f"{kernel}: {', '.join(in_place)} are updated "
                         f"in place and must be contiguous")


def grad_layout(g) -> Optional[Tuple[int, int]]:
    """How the kernel reads a gradient ``g`` beside its contiguous leaf:
    ``(0, 0)`` when g is contiguous; ``(I, H*W)`` when g lies in the
    channels-last order of an OIHW leaf below 2**31 elements (cuDNN's
    weight gradient of an NHWC conv), which the kernel reads in place;
    None when g has to be made contiguous first (a copy)."""
    if g.is_contiguous():
        return 0, 0
    if (g.dim() == 4 and g.numel() < 2 ** 31
            and g.is_contiguous(memory_format=torch.channels_last)):
        return g.shape[1], g.shape[2] * g.shape[3]
    return None


def leaf_tables(leaves, kernel, in_place, align: int = 16):
    """The launch tables of K4, K5 or K6 over ``leaves`` (each ``(p, g,
    *state)``, non-empty), built column by column after
    :func:`_check_leaves` (raises before any launch).

    Returns ``(tables, kept)``.  Each table is ``(ptrs, meta, count)``
    for up to :data:`ADAM_CAPACITY` leaves of K4 ``(p, g, m, v)`` or
    :data:`SGD_CAPACITY` of K5 ``(p, g, v)`` and K6 ``(p, g)``, as int64
    arrays in leaf order: ``ptrs`` four a leaf for K4 and three for K5
    and K6, the addresses of p, g and the state (0 where K6 has none);
    ``meta`` five a leaf: n, the leaf's first chunk of :data:`CHUNK`
    elements within the table (a prefix sum), the gradient's layout
    (:func:`grad_layout`) and 1 when every pointer the kernel reads four
    elements at a time is ``align``-byte aligned (16 for f32's float4, 8
    for four bf16s).  ``kept`` holds the contiguous copies of
    the gradients that needed one; they must stay alive until the
    launches are made."""
    _check_leaves(leaves, kernel, in_place)
    cols = list(zip(*leaves))
    ps, gs, state = cols[0], list(cols[1]), cols[2:]
    count = len(ps)
    slots = max(3, len(cols))
    capacity = ADAM_CAPACITY if slots == 4 else SGD_CAPACITY
    cin, hw, kept = [0] * count, [0] * count, []
    for i, contiguous in enumerate(map(_is_contiguous, gs)):
        if not contiguous:
            tag = grad_layout(gs[i])
            if tag is None:
                gs[i] = gs[i].contiguous()
                kept.append(gs[i])
            else:
                cin[i], hw[i] = tag
    addr = [list(map(_data_ptr, col)) for col in (ps, gs, *state)]
    # the low bits of every pointer read as float4: a channels-last g is
    # gathered element by element, so its own do not matter
    low = addr[1] if not any(cin) else [0 if c else a for a, c in
                                        zip(addr[1], cin)]
    for col in (addr[0], *addr[2:]):
        low = list(map(or_, low, col))
    vec = [a & (align - 1) == 0 for a in low]
    ns = list(map(_numel, ps))
    nch = [-(-n // CHUNK) for n in ns]
    tables = []
    for lo in range(0, count, capacity):
        hi = min(lo + capacity, count)
        # interleaved by slice assignment: the fastest way to an array
        ptrs = [0] * (slots * (hi - lo))
        for j, col in enumerate(addr):
            ptrs[j::slots] = col[lo:hi]
        meta = [0] * (_META * (hi - lo))
        meta[0::_META] = ns[lo:hi]
        meta[1::_META] = accumulate(nch[lo:hi - 1], initial=0)
        meta[2::_META] = cin[lo:hi]
        meta[3::_META] = hw[lo:hi]
        meta[4::_META] = vec[lo:hi]
        tables.append((array("q", ptrs), array("q", meta), hi - lo))
    return tables, kept


def _route(leaves, kernel, plain, cuda, kw) -> None:
    """Update each CPU leaf of ``leaves`` with ``plain`` and the CUDA ones
    with ``cuda``, one call per device, after every CUDA leaf was checked
    by :func:`_kernel_takes` (empty ones dropped).  A leaf on any other
    device raises."""
    on_card = list(map(_is_cuda, (leaf[0] for leaf in leaves)))
    if not all(on_card):
        for leaf, on in zip(leaves, on_card):
            if on:
                continue
            if leaf[0].device.type != "cpu":
                raise RuntimeError(f"{kernel}: no implementation for "
                                   f"device {leaf[0].device}")
            plain(*leaf, **kw)
        leaves = [leaf for leaf, on in zip(leaves, on_card) if on]
    devs = list(map(_get_device, (leaf[0] for leaf in leaves)))
    groups = [[leaf for leaf, d in zip(leaves, devs) if d == dev]
              for dev in dict.fromkeys(devs)] if len(set(devs)) > 1 \
        else [leaves]
    # every CUDA leaf is checked before the first launch; then a launch a
    # device and dtype
    groups = [_kernel_takes(group, kernel) for group in groups]
    for by_dtype in groups:
        for dtype, group in by_dtype.items():
            cuda(group, dtype=dtype, **kw)


def _adam_cuda(leaves, *, clr, bc1, bc2, beta1, beta2, eps,
               weight_decay, dtype=_F32) -> None:
    """Launch ``csrc/fused_adam.cu`` over all ``(p, g, m, v)`` of
    ``leaves`` (all of ``dtype``, f32 or bf16, non-empty, all on one CUDA
    device) on the current stream: one launch per table of
    :data:`ADAM_CAPACITY` leaves.  All inputs are checked before the
    first launch."""
    dev = leaves[0][0].device
    scalars = [_device_scalar(x, n, dev)
               for x, n in ((clr, "clr"), (bc1, "bc1"), (bc2, "bc2"))]
    tables, kept = leaf_tables(leaves, KERNEL_NAME, ("p", "m", "v"),
                               _KERNEL_DTYPES[dtype][1])
    fn = _adam_fn(dtype)
    # the moments' scalars rounded to the leaves' dtype, as the plain
    # version rounds them; eps and weight_decay meet f32 values there
    tail = (*(t.data_ptr() for t in scalars),
            *(_in(x, dtype) for x in (beta1, 1 - beta1, beta2, 1 - beta2)),
            eps, float(weight_decay), int(bool(weight_decay)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for ptrs, meta, count in tables:
            rc = fn(ptrs.buffer_info()[0], meta.buffer_info()[0], count,
                    *tail, stream)
            if rc != 0:
                raise RuntimeError(f"{KERNEL_NAME} kernel launch failed: "
                                   f"cudaError {rc} ({count} leaves)")
            _build.count_launch(KERNEL_NAME)
    del kept


def fused_adam_update(params, grads, m, v, *, clr, bc1, bc2, beta1, beta2,
                      eps, weight_decay=0.0):
    """One-pass Adam(W) update over nested dicts of leaves.

    ``clr``/``bc1``/``bc2`` are the step-dependent fp32 scalars the caller
    computed on the leaves' device; ``weight_decay`` > 0 applies AdamW's
    decoupled decay in the same pass.  Updates params, m and v in place
    and returns ``(params, m, v)``.  A CPU leaf goes to
    :func:`adam_leaf_plain`; a CUDA leaf to the kernel (one launch per
    dtype), or it raises if it is not f32 or bf16 throughout (an empty
    one is skipped); a leaf on any other device raises.
    """
    kw = dict(clr=clr, bc1=bc1, bc2=bc2, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay)
    _route(zip_leaves(params, grads, m, v), KERNEL_NAME, adam_leaf_plain,
           _adam_cuda, kw)
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
    momentum) in place.  On a bf16 leaf every scalar is rounded to bf16
    before it is used, ``clr`` too."""
    dt = p.dtype
    if weight_decay > 0:
        g = g + _in(weight_decay, dt) * p
    if v is not None:
        mu = _in(momentum, dt)
        vel = mu * v + _in(1.0 - dampening, dt) * g
        g = g + mu * vel if nesterov else vel
        v.copy_(vel)
    p.copy_(p - _as(clr, p.dtype) * g.to(p.dtype))


def _sgd_fn(mom: bool, dtype=_F32):
    """K5's (``mom``) or K6's C function for leaves of ``dtype``."""
    return _table_fn(("bigdl_fused_sgd_mom" if mom
                      else "bigdl_fused_sgd_plain")
                     + _KERNEL_DTYPES[dtype][0])


def _sgd_cuda(leaves, *, clr, momentum, dampening, nesterov,
              weight_decay, dtype=_F32) -> None:
    """Launch K5 (leaves ``(p, g, v)``) or K6 (leaves ``(p, g)``) over all
    ``leaves`` (all of ``dtype``, f32 or bf16, non-empty, all on one CUDA
    device) on the current stream: one launch per table of
    :data:`SGD_CAPACITY` leaves.  All inputs are checked before the first
    launch."""
    dev = leaves[0][0].device
    mom = len(leaves[0]) == 3
    kernel = SGD_MOM if mom else SGD_PLAIN
    clr_t = _device_scalar(clr, "clr", dev, kernel)
    tables, kept = leaf_tables(leaves, kernel, ("p", "v") if mom else ("p",),
                               _KERNEL_DTYPES[dtype][1])
    fn = _sgd_fn(mom, dtype)
    decay = int(weight_decay > 0)
    # the scalars rounded to the leaves' dtype, as the plain version
    # rounds them (the kernel rounds clr itself)
    wd = _in(weight_decay, dtype)
    if mom:
        tail = (clr_t.data_ptr(), _in(momentum, dtype),
                _in(1.0 - dampening, dtype), wd, decay, int(bool(nesterov)))
    else:
        tail = (clr_t.data_ptr(), wd, decay)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for ptrs, meta, count in tables:
            rc = fn(ptrs.buffer_info()[0], meta.buffer_info()[0], count,
                    *tail, stream)
            if rc != 0:
                raise RuntimeError(f"{kernel} kernel launch failed: "
                                   f"cudaError {rc} ({count} leaves)")
            _build.count_launch(kernel)
    del kept


def fused_sgd_update(params, grads, velocity=None, *, clr, momentum=0.0,
                     dampening=0.0, nesterov=False, weight_decay=0.0):
    """One-pass SGD update over nested dicts of leaves: K5 when
    ``momentum > 0`` and a velocity is given, else K6.  ``clr`` is the
    step's fp32 learning rate on the leaves' device.  Updates params (and
    velocity) in place and returns ``(params, velocity)``.  A CPU leaf
    goes to :func:`sgd_leaf_plain`; a CUDA leaf to the kernel (one launch
    per dtype), or it raises if it is not f32 or bf16 throughout (an
    empty one is skipped); a leaf on any other device raises."""
    mom = momentum > 0 and velocity is not None
    kernel = SGD_MOM if mom else SGD_PLAIN
    kw = dict(clr=clr, momentum=momentum, dampening=dampening,
              nesterov=nesterov, weight_decay=weight_decay)
    trees = (params, grads, velocity) if mom else (params, grads)
    _route(zip_leaves(*trees), kernel, sgd_leaf_plain, _sgd_cuda, kw)
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
