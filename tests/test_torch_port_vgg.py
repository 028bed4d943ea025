"""The port's VGG (``bigdl_tpu_torch/models/vgg.py``) held against the
reference's on the CPU: BigDL's VGG-16 for CIFAR-10 at batch 2, NCHW and
NHWC, in inference and in training with the reference's own dropout
masks fed through ``Ctx.draws``; the ImageNet VGG-16's structure and its
NHWC flatten order.

The reference model is built once per format (``vgg_models``) and its
weights and batch-norm state cross by position
(``models.convert.from_jax_weights``).  Tolerances: outputs, the ClassNLL
loss and batch-norm state within 2e-5; gradients per leaf within
max |Δg| ≤ 1e-4 · max |g|.

End to end, in inference, the fp32 outputs and loss are compared; the
gradients are compared in float64, because in fp32 one ReLU whose input
lies within 1e-7 of 0 flips between XLA's and ATen's rounding and moves
the input gradient by 0.9 % (measured at this seed).  In training the
model is compared layer by layer, each layer of both packages fed the
reference's activation and the same mask: end to end, the classifier's
BatchNormalization(512) normalizes 2 samples through the reference's
``E[x²] − mean²`` in fp32, which keeps few of the difference's digits,
and the two outputs drift by 1.9e-3 – 2.7e-3 (measured), a property of
the reference's formula, not of either package.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import vgg as JV
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import vgg as TV

from _torch_port_parity import (assert_grads, cross, layer_walk, port_run,
                                rand, ref_dropout_draws, ref_run)

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_REL = 1e-4
KEY = jax.random.PRNGKey(11)


def _pin_uids(jm):
    """Number the reference model's modules from 0, as a model built first
    in a fresh process is numbered.  A reference Dropout keys its mask by
    its module's uid (``fold_in(key, uid)``), which counts every module
    the process made before: without the pin the masks, and with them the
    inputs of the classifier's BatchNormalization(512), change with the
    tests a worker ran earlier."""
    base = min(m._uid for m in jm.modules())
    for m in jm.modules():
        m._uid -= base
    return jm


@pytest.fixture(scope="module")
def vgg_models():
    """fmt -> (reference model, its params, its state, port model)."""
    out = {}
    for fmt in ("NCHW", "NHWC"):
        jm = _pin_uids(JV.build(class_num=10, dataset="cifar10",
                                format=fmt))
        tm = TV.build(class_num=10, dataset="cifar10", format=fmt,
                      device="cpu")
        params, state = cross(jm, tm, seed=1)
        out[fmt] = (jm, params, state, tm)
    return out


def _cifar(fmt, b=2, seed=0):
    x = rand(seed, (b, 3, 32, 32))
    return x if fmt == "NCHW" else np.ascontiguousarray(
        x.transpose(0, 2, 3, 1))


def test_vgg16_cifar_structure():
    tm = TV.build(class_num=10, dataset="cifar10", format="NHWC",
                  device="cpu")
    w = tm.get_weights()
    assert len(w) == 58
    assert sum(t.numel() for t in w) == 14_991_946
    kinds = [type(m).__name__ for m in tm.modules()]
    assert kinds.count("Dropout") == 10
    assert kinds.count("SpatialConvolution") == 13
    assert all(m.ceil_mode for m in tm.modules()
               if isinstance(m, tnn.SpatialMaxPooling))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_vgg16_cifar_inference_against_the_reference(vgg_models, fmt):
    jm, params, state, tm = vgg_models[fmt]
    x = _cifar(fmt)
    y = np.array([3, 7], np.float32)
    yj = np.asarray(jm.run(params, jnp.asarray(x), state=state)[0])
    yt = tm.run(tm.param_dict(), torch.from_numpy(x),
                state=tm.initial_state())[0].detach().numpy()
    np.testing.assert_allclose(yt, yj, **TOL)
    lj = jnn.ClassNLLCriterion().loss(jnp.asarray(yj), jnp.asarray(y))
    lt = tnn.ClassNLLCriterion().loss(torch.from_numpy(yt),
                                      torch.from_numpy(y))
    np.testing.assert_allclose(float(lt), float(lj), **TOL)
    # every gradient, end to end, in float64
    dy = rand(5, (2, 10)).astype(np.float64)
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), params)
        _, gj, gxj, _ = ref_run(jm, p64, x.astype(np.float64), dy, state)
    t64 = copy.deepcopy(tm).double()
    _, gt, gxt, _ = port_run(t64, x.astype(np.float64), dy,
                             t64.initial_state())
    assert len(gt) == 58
    assert_grads([gxt] + gt, [gxj] + gj, GRAD_REL)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_vgg16_cifar_training_layer_by_layer(vgg_models, fmt):
    """Training mode with the reference's masks: every layer's output,
    gradients and batch-norm state, on the reference's activations."""
    jm, params, state, tm = vgg_models[fmt]
    x = _cifar(fmt, seed=1)
    draws = ref_dropout_draws(jm, tm, params, state, x, KEY)
    assert len(draws) == 10
    assert all(0 < int(m.sum()) < m.size for m in draws.values())
    drew = layer_walk(jm, tm, params, state, x, True, key=KEY, draws=draws)
    assert drew == 10


def test_vgg16_cifar_dropout_changes_the_training_output(vgg_models):
    """The masks reach the model: other draws give another output."""
    jm, params, state, tm = vgg_models["NCHW"]
    x = _cifar("NCHW", seed=3)
    outs = [tm.run(tm.param_dict(), torch.from_numpy(x),
                   state=tm.initial_state(), training=True,
                   draws=ref_dropout_draws(jm, tm, params, state, x,
                                           jax.random.PRNGKey(k)))[0]
            for k in (0, 1)]
    assert not torch.equal(outs[0], outs[1])


def test_vgg16_imagenet_structure_and_nhwc_flatten():
    """ImageNet VGG-16 (138.4 M weights) is built layer for layer as the
    reference's; the NHWC build flattens (c, h, w) as the NCHW one does,
    so both give the same output on the same weights."""
    tm = TV.build(class_num=1000, dataset="imagenet", depth=16,
                  device="cpu")
    assert sum(t.numel() for t in tm.get_weights()) == 138_357_544
    small = {}
    for fmt in ("NCHW", "NHWC"):
        small[fmt] = tnn.Sequential(
            tnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, format=fmt),
            tnn.SpatialMaxPooling(2, 2, 2, 2, format=fmt),
            *([tnn.Transpose([(1, 3), (2, 3)])] if fmt == "NHWC" else []),
            tnn.View(4 * 3 * 3), tnn.Linear(36, 5))
    small["NHWC"].set_weights(small["NCHW"].get_weights())
    x = _cifar("NCHW")[:, :, :6, :6].copy()
    y1 = small["NCHW"](torch.from_numpy(x))
    y2 = small["NHWC"](torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 3, 1))))
    torch.testing.assert_close(y1, y2, rtol=1e-5, atol=1e-5)
    assert sum(v != "M" for v in TV._VGG_CFG[19]) + 3 == 19
