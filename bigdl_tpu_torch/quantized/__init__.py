"""Post-training int8 (≙ ``bigdl_tpu/quantized/__init__.py``; the
reference's nn/quantized/: Linear.scala, SpatialConvolution.scala,
SpatialDilatedConvolution.scala, Quantizer.scala).

Weights are quantized offline, symmetric per output channel
(:func:`quantize_weights_symmetric`, numpy, the reference's own code);
activations per tensor, at run time from ``max |x|`` or from a scale
calibrated beforehand (:func:`calibrate_activation_absmax`).  Values are
divided by their scale with a true division (the scale is a tensor on
the activation's device, never a Python float, which CUDA would turn into
a multiply by the reciprocal), rounded half to even and clipped to ±127,
so the codes are the reference's, bit for bit.

The int8 × int8 → int32 products go through ``torch._int_mm`` (cuBLASLt
on the card): exact, as the reference's ``preferred_element_type=int32``
products are.  On CUDA it takes only more than 16 rows and inner and
output sizes that are multiples of 8, so :func:`int8_matmul` zero-pads
rows, K and N to that (padding with code 0 adds nothing).  A product it
cannot take raises; nothing falls back to a float product.  PyTorch has
no int8 convolution, so a quantized convolution is an int8 im2col (the
padded NHWC codes seen through ``as_strided``, one copy per group)
followed by that GEMM.

Quantized modules are inference-only (``backward`` raises).  Their int8
weights, scales and bias are constants of the module, not parameters or
buffers: they stay out of ``param_dict``/``initial_state`` (so out of a
registry's snapshots, ``get_weights`` and the optimizers) and move with
``.to()``.

:func:`quantize` rewrites a copy of a model: every ``Linear``,
``SpatialConvolution`` and ``SpatialDilatedConvolution`` (exact type)
becomes its quantized twin, named ``<name>_q``; every other module is
copied with owning copies of its parameters and state, so training the
float model afterwards leaves the int8 model as it was.

Weight-only int8 (:func:`quantize_weights_only`) quantizes the matrix
leaves of a parameter tree for LM serving; :func:`dequantize_weights`
materialises the full-precision tree once per call (the reference's XLA
fuses the upconvert into each matmul instead).

``quantize_rows`` / ``dequantize_rows`` are the paged KV cache's
row-wise int8: one fp32 scale per row of ``axis``.
"""
from __future__ import annotations

import copy
import itertools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .._device import model_device
from ..nn import conv as conv_mod
from ..nn import linear as linear_mod
from ..nn.conv import _same_pad
from ..nn.module import Module


def quantize_weights_symmetric(w, axis: int = 0):
    """Per-output-channel symmetric int8 over ``axis``: ``(q int8, scale
    fp32)`` with ``scale = max(|w|, 1e-8) / 127`` kept over the other axes
    (keepdims)."""
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    absmax = np.maximum(np.abs(w).max(axis=reduce_axes, keepdims=True),
                        1e-8)
    scale = absmax / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _device_of(t) -> torch.device:
    return t.device if isinstance(t, torch.Tensor) else torch.device("cpu")


def _owned_f32(t):
    """``t`` as an fp32 tensor of its own (never a view of a parameter,
    which a trainer may write in place); None stays None."""
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).clone()
    return torch.tensor(np.asarray(t), dtype=torch.float32)


def quantize_rows(x, axis: int = -1):
    """``(q int8, scale fp32)`` with ``scale`` kept over ``axis`` (keepdim,
    so that the dequantizing multiply broadcasts)."""
    xf = x.float()
    absmax = torch.clamp(xf.abs().amax(dim=axis, keepdim=True), min=1e-8)
    # a true division: CUDA would multiply by the reciprocal of a scalar
    scale = absmax / torch.full((), 127.0, device=xf.device)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_rows`: int8 × broadcast scale →
    ``dtype``."""
    return q.to(dtype) * scale.to(dtype)


def _quantize_activations(x, scale=None):
    """Per-tensor symmetric int8 codes of ``x`` and their fp32 scale (a
    0-dim tensor on ``x``'s device).  ``scale`` None: computed from
    ``max |x|`` (floor 1e-8) in this call; else the calibrated scale."""
    if scale is None:
        absmax = torch.clamp(x.abs().amax(), min=1e-8)
        scale = absmax / torch.full((), 127.0, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_weight(w2d: torch.Tensor) -> torch.Tensor:
    """An ``(N, K)`` int8 weight zero-padded to multiples of 8 both ways
    (contiguous); :func:`int8_matmul` reads it transposed."""
    n, k = w2d.shape
    return F.pad(w2d, (0, _round_up(k, 8) - k, 0, _round_up(n, 8) - n)) \
        .contiguous()


def int8_matmul(a: torch.Tensor, w_padded: torch.Tensor, n: int):
    """``a (M, K) int8 @ w (n, K)ᵀ int8 -> (M, n) int32``, exact, by
    ``torch._int_mm`` with ``w_padded`` from :func:`_pad_weight`.  Rows
    are padded to at least 17 and K to ``w_padded``'s; padding is zeros,
    so it adds nothing to the product."""
    m, k = a.shape
    kp = w_padded.shape[1]
    if a.dtype != torch.int8 or w_padded.dtype != torch.int8 or k > kp:
        raise ValueError(f"int8_matmul: ({m}, {k}) {a.dtype} by "
                         f"{tuple(w_padded.shape)} {w_padded.dtype}")
    mp = max(m, 17)
    if kp != k or mp != m:
        a = F.pad(a, (0, kp - k, 0, mp - m))
    out = torch._int_mm(a.contiguous(), w_padded.t())
    return out[:m, :n]


class QuantizedModule(Module):
    """Inference-only base (≙ nn/quantized/QuantizedModule.scala).  The
    names in ``_CONSTS`` are tensors of the module that are neither
    parameters nor buffers; ``.to()`` / ``.cuda()`` move them too."""

    _CONSTS = ("qweight", "wscale", "bias", "_wmats", "_act_scale")

    def _init_act(self, act_absmax, device):
        self.act_absmax = None if act_absmax is None else float(act_absmax)
        # the reference divides a Python float: absmax / 127.0 in double,
        # taken to fp32 where it meets the activation
        self._act_scale = None if act_absmax is None else torch.tensor(
            self.act_absmax / 127.0, dtype=torch.float32, device=device)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for k in self._CONSTS:
            v = self.__dict__.get(k)
            if isinstance(v, torch.Tensor):
                self.__dict__[k] = fn(v)
            elif isinstance(v, list):
                self.__dict__[k] = [fn(t) for t in v]
        return self

    def _device_tensors(self):
        consts = (self.__dict__.get(k) for k in self._CONSTS)
        return itertools.chain(
            super()._device_tensors(),
            (t for t in consts if isinstance(t, torch.Tensor)))

    def quantize_input(self, x):
        """``(codes int8, scale)`` of the activation ``x``: calibrated when
        the module has ``act_absmax``, else from ``max |x|``."""
        return _quantize_activations(x, self._act_scale)

    def backward(self, *a, **k):
        raise RuntimeError(
            f"{type(self).__name__} is inference-only (quantized)")


class QuantizedLinear(QuantizedModule):
    """int8 × int8 → int32 GEMM with an fp32 rescale
    (≙ nn/quantized/Linear.scala): ``y = acc · (x_scale · w_scale) + b``.
    ``act_absmax`` (from :func:`calibrate_activation_absmax`) fixes the
    activation scale, so no per-batch ``max |x|`` runs."""

    def __init__(self, weight, bias=None, act_absmax=None, name=None):
        super().__init__(name=name)
        dev = _device_of(weight)
        qw, wscale = quantize_weights_symmetric(_host(weight), axis=0)
        self.qweight = torch.from_numpy(qw).to(dev)             # (out, in)
        self.wscale = torch.from_numpy(wscale.reshape(-1)).to(dev)
        self.bias = _owned_f32(bias)
        self._wmats = [_pad_weight(self.qweight)]
        self._init_act(act_absmax, dev)

    @staticmethod
    def from_float(layer: linear_mod.Linear, params=None,
                   act_absmax=None) -> "QuantizedLinear":
        p = params if params is not None else layer.own(layer.param_dict())
        return QuantizedLinear(p["weight"], p.get("bias"),
                               act_absmax=act_absmax,
                               name=f"{layer.name}_q")

    def accumulate(self, qx):
        """The int32 accumulator ``qx @ qweightᵀ`` (leading dims kept)."""
        lead = qx.shape[:-1]
        acc = int8_matmul(qx.reshape(-1, qx.shape[-1]), self._wmats[0],
                          self.qweight.shape[0])
        return acc.reshape(lead + (acc.shape[-1],))

    def apply(self, params, x, ctx):
        qx, xscale = self.quantize_input(x)
        out = self.accumulate(qx).float() * (xscale * self.wscale)
        if self.bias is not None:
            out = out + self.bias
        return out


class QuantizedSpatialConvolution(QuantizedModule):
    """int8 convolution with int32 accumulation (≙ nn/quantized/
    SpatialConvolution.scala), NCHW or NHWC like the float layer (whose
    weight is OIHW in both).  ``padding`` -1 on an axis selects SAME on
    that axis.  The codes are padded with 0 in NHWC and seen as windows
    ``(B, Ho, Wo, kh, kw, C)``; each group's columns are one copy and one
    int8 GEMM."""

    def __init__(self, weight, bias=None, stride=(1, 1), padding=(0, 0),
                 dilation=(1, 1), n_group=1, format="NCHW",
                 act_absmax=None, name=None):
        super().__init__(name=name)
        dev = _device_of(weight)
        qw, wscale = quantize_weights_symmetric(_host(weight), axis=0)
        self.qweight = torch.from_numpy(qw).to(dev)             # OIHW
        self.wscale = torch.from_numpy(wscale.reshape(-1)).to(dev)
        self.bias = _owned_f32(bias)
        self.format = format
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.dilation = tuple(dilation)
        self.n_group = n_group
        o, cg, kh, kw = qw.shape
        og = o // n_group
        # columns run (kh, kw, c): the weight of each group as (og, K)
        self._wmats = [_pad_weight(self.qweight[g * og:(g + 1) * og]
                                   .permute(0, 2, 3, 1).reshape(og, -1))
                       for g in range(n_group)]
        self._init_act(act_absmax, dev)

    @staticmethod
    def from_float(layer, params=None,
                   act_absmax=None) -> "QuantizedSpatialConvolution":
        p = params if params is not None else layer.own(layer.param_dict())
        return QuantizedSpatialConvolution(
            p["weight"], p.get("bias"), stride=layer.stride,
            padding=layer.pad, n_group=getattr(layer, "n_group", 1),
            format=getattr(layer, "format", "NCHW"),
            act_absmax=act_absmax, name=f"{layer.name}_q")

    def _pads(self, spatial):
        ksize = self.qweight.shape[2:4]
        return [_same_pad(spatial[i], self.stride[i], ksize[i],
                          self.dilation[i]) if p == -1 else (p, p)
                for i, p in enumerate(self.padding)]

    def _acc2d(self, qx):
        """``(acc (B·Ho·Wo, O) int32, (B, Ho, Wo))`` of the codes ``qx``
        (the module's format)."""
        xh = qx.permute(0, 2, 3, 1) if self.format == "NCHW" else qx
        b, h, w, c = xh.shape
        (top, bottom), (left, right) = self._pads((h, w))
        xp = F.pad(xh, (0, 0, left, right, top, bottom)).contiguous()
        _, hp, wp, _ = xp.shape
        o, cg, kh, kw = self.qweight.shape
        (sh, sw), (dh, dw) = self.stride, self.dilation
        ho = (hp - (kh - 1) * dh - 1) // sh + 1
        wo = (wp - (kw - 1) * dw - 1) // sw + 1
        s_b, s_h, s_w, s_c = xp.stride()
        win = xp.as_strided((b, ho, wo, kh, kw, c),
                            (s_b, s_h * sh, s_w * sw, s_h * dh, s_w * dw,
                             s_c))
        og = o // self.n_group
        accs = [int8_matmul(
            win[..., g * cg:(g + 1) * cg].reshape(b * ho * wo, kh * kw * cg),
            self._wmats[g], og) for g in range(self.n_group)]
        acc = accs[0] if len(accs) == 1 else torch.cat(accs, dim=1)
        return acc, (b, ho, wo)

    def _to_format(self, y2d, bhw):
        y = y2d.reshape(bhw + (y2d.shape[-1],))
        return y.permute(0, 3, 1, 2) if self.format == "NCHW" else y

    def accumulate(self, qx):
        """The int32 accumulator of the int8 convolution of the codes
        ``qx``, in the module's format."""
        return self._to_format(*self._acc2d(qx))

    def apply(self, params, x, ctx):
        qx, xscale = self.quantize_input(x)
        acc, bhw = self._acc2d(qx)
        out = acc.float() * (xscale * self.wscale)
        if self.bias is not None:
            out = out + self.bias
        return self._to_format(out, bhw)


class QuantizedSpatialDilatedConvolution(QuantizedSpatialConvolution):
    """int8 dilated convolution with int32 accumulation
    (≙ nn/quantized/SpatialDilatedConvolution.scala): the same im2col
    with the taps ``dilation`` apart."""

    @staticmethod
    def from_float(layer, params=None, act_absmax=None) \
            -> "QuantizedSpatialDilatedConvolution":
        p = params if params is not None else layer.own(layer.param_dict())
        return QuantizedSpatialDilatedConvolution(
            p["weight"], p.get("bias"), stride=layer.stride,
            padding=layer.pad, dilation=layer.dilation,
            act_absmax=act_absmax, name=f"{layer.name}_q")


_QUANTIZABLE = {
    linear_mod.Linear: QuantizedLinear.from_float,
    conv_mod.SpatialConvolution: QuantizedSpatialConvolution.from_float,
    conv_mod.SpatialDilatedConvolution:
        QuantizedSpatialDilatedConvolution.from_float,
}


def calibrate_activation_absmax(model: Module, batches, params=None,
                                state=None) -> Dict[str, float]:
    """Per quantizable layer, the input's ``max |x|`` over ``batches`` (a
    list or iterable of model inputs, arrays or tensors), from one
    inference forward per batch, times 1.02 of headroom (floor 1e-8).

    The forward runs on a copy of the module tree that shares the
    model's tensors, whose quantizable layers' ``apply`` is shadowed to
    keep a running maximum on the device: the model itself, which a
    serving engine may be running at the same time, is never touched.
    The maxima of a batch come to the host in one copy.  The standard
    post-training caveat holds: maxima are taken on the float model's
    activations, and a later value beyond the calibrated range is
    clipped."""
    params = params if params is not None else model.param_dict()
    state = state if state is not None else model.initial_state()
    dev = model_device(model)
    runner = _copy(model, {id(t): t for t in itertools.chain(
        model.parameters(), model.buffers())})
    seen: Dict[str, torch.Tensor] = {}
    for m in runner.modules():
        if type(m) not in _QUANTIZABLE:
            continue

        def wrapped(p, x, ctx, _m=m, _orig=m.apply):
            cur = x.float().abs().amax()
            prev = seen.get(_m.name)
            seen[_m.name] = cur if prev is None else torch.maximum(prev, cur)
            return _orig(p, x, ctx)
        m.apply = wrapped
    out: Dict[str, float] = {}
    with torch.inference_mode():
        for x in batches:
            seen.clear()
            xt = x if isinstance(x, torch.Tensor) \
                else torch.from_numpy(np.ascontiguousarray(x))
            runner.run(params, xt.to(dev), state=state, training=False)
            names = list(seen)
            if not names:
                continue
            vals = torch.stack([seen[n] for n in names]).cpu().tolist()
            for n, v in zip(names, vals):
                # the runtime path's floor; 2 % headroom for the drift once
                # upstream layers are quantized themselves
                out[n] = max(out.get(n, 0.0), 1.02 * float(v), 1e-8)
    return out


# the Torch shell's per-call activity and caches: not carried into a copy
_SHELL_CACHES = ("output", "grad_input", "grad_params", "_last_pass",
                 "_shell_gen", "_predictors", "_rebound_from")


def _copy(model: Module, memo: Dict[int, object]) -> Module:
    """A deep copy of ``model`` in which each object whose id is in
    ``memo`` becomes its value there (a module's twin, or a tensor kept
    shared): every container (``Sequential``, a model's own tree, a
    ``Graph``'s nodes) is rebuilt around it with the same wiring; every
    other tensor is copied; the Torch shell's caches are left out."""
    memo = dict(memo)
    for m in model.modules():
        for k in _SHELL_CACHES:
            v = m.__dict__.get(k)
            if v is not None:
                memo[id(v)] = None
    return copy.deepcopy(model, memo)


def quantize(model: Module, calibration_data=None, *, params=None,
             state=None) -> Module:
    """A copy of ``model`` with every quantizable layer replaced by its
    int8 twin (≙ nn/quantized/Quantizer.scala quantize).  The other
    modules keep their trained parameters and state, as owning copies.

    ``calibration_data`` (an iterable of input batches) bakes static
    activation scales into the twins (:func:`calibrate_activation_absmax`);
    without it, activations are quantized per batch at run time.
    ``params`` / ``state`` (the layout of ``param_dict`` /
    ``initial_state``; default the model's own) are the weights to
    quantize, a registry snapshot's for example: the copy is bound to
    them."""
    given_params, given_state = params, state
    params = params if params is not None else model.param_dict()
    state = state if state is not None else model.initial_state()
    absmax = {}
    if calibration_data is not None:
        absmax = calibrate_activation_absmax(model, calibration_data,
                                             params=params, state=state)
    targets = [m for m in model.modules() if type(m) in _QUANTIZABLE]
    twins = {id(m): _QUANTIZABLE[type(m)](m, params.get(m.name),
                                          act_absmax=absmax.get(m.name))
             for m in targets}
    replaced = {m.name for m in targets}
    # the copy owns its tensors; given weights replace the copied ones
    new = _copy(model, twins)
    if given_params is not None:
        new.load_param_dict({k: {n: t.detach().clone()
                                 for n, t in sub.items()}
                             for k, sub in given_params.items()
                             if k not in replaced})
    if given_state is not None:
        new.set_state({k: v for k, v in given_state.items()
                       if k not in replaced})
    return new


def quantize_for_serving(model: Module, calibration_data=None, *,
                         params=None, state=None) -> Module:
    """:func:`quantize` for the serving registry
    (``ModelRegistry.register(quantize_int8=True)``): the copy comes back
    in inference mode.  Its int8 weights are constants of the modules, so
    new weights mean a new quantization and ``swap_model``, never
    ``swap_weights``."""
    return quantize(model, calibration_data=calibration_data,
                    params=params, state=state).evaluate()


# --------------------------------------------------------------------- #
# weight-only int8 (LM serving)                                          #
# --------------------------------------------------------------------- #
def _is_wq8(v) -> bool:
    return isinstance(v, dict) and set(v) == {"q8", "q8_scale"}


def _tree_map(fn, tree):
    if isinstance(tree, dict) and not _is_wq8(tree):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, dict) and not _is_wq8(tree):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def quantize_weights_only(params, min_size: int = 4096):
    """Every floating matrix leaf of ``params`` (nested dicts of tensors)
    with at least ``min_size`` elements becomes ``{"q8": int8,
    "q8_scale": fp32}``, quantized per output channel along the LAST axis
    (the LM's matmul weights are ``(in, out)``, used as ``x @ w``), on the
    leaf's device; other leaves stay as they are.  Idempotent."""
    def leaf(v):
        if _is_wq8(v) or not isinstance(v, torch.Tensor):
            return v
        if v.ndim != 2 or v.numel() < min_size \
                or not torch.is_floating_point(v):
            return v
        q, scale = quantize_weights_symmetric(_host(v), axis=1)
        return {"q8": torch.from_numpy(q).to(v.device),
                "q8_scale": torch.from_numpy(scale).to(v.device)}
    return _tree_map(leaf, params)


def dequantize_weights(qparams, dtype=torch.bfloat16):
    """Inverse of :func:`quantize_weights_only`: each int8 leaf becomes
    ``q8 · q8_scale`` in ``dtype``, a full-precision tensor."""
    def leaf(v):
        if _is_wq8(v):
            return v["q8"].to(dtype) * v["q8_scale"].to(dtype)
        return v
    return _tree_map(leaf, qparams)


def quantized_bytes(qparams) -> int:
    """The bytes of a (possibly weight-only int8) parameter tree: one per
    int8 code, four per scale, the itemsize of every other leaf."""
    total = 0
    for v in _tree_leaves(qparams):
        if _is_wq8(v):
            total += v["q8"].numel() + 4 * v["q8_scale"].numel()
        elif isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        else:
            a = np.asarray(v)
            total += a.size * a.dtype.itemsize
    return total


__all__ = ["QuantizedLinear", "QuantizedModule",
           "QuantizedSpatialConvolution",
           "QuantizedSpatialDilatedConvolution",
           "calibrate_activation_absmax", "dequantize_rows",
           "dequantize_weights", "int8_matmul", "quantize",
           "quantize_for_serving", "quantize_rows",
           "quantize_weights_only", "quantize_weights_symmetric",
           "quantized_bytes"]
