"""The port's ResNet options held against the reference on the CPU:
``SpaceToDepthConvolution`` and ``stem="s2d"``, shortcut type A (NCHW;
NHWC raises, ROADMAP C6), ``remat=True`` and ``sync_bn_axis`` (sync BN
over 2 gloo ranks).

Tolerances: fp32 outputs, losses and batch-norm state within 2e-5;
gradients per leaf within max |Δg| ≤ 1e-4 · max |g|; sync BN over 2 ranks
against one process on the full batch within 1e-5, and the port's
2-rank ``DistriOptimizer`` step against the reference's on 2 virtual
devices within 1e-5.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import resnet as JR
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.parallel import mesh as jmesh
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import resnet as TR

from _torch_port_parity import (assert_grads, cross, port_run, rand,
                                ref_run, ref_state_list)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_REL = 1e-4
SYNC_TOL = dict(rtol=1e-5, atol=1e-5)


def _nhwc(b, c, h, w, seed=0):
    return np.ascontiguousarray(rand(seed, (b, c, h, w)).transpose(0, 2, 3, 1))


def _pair(jm, tm, x, training=False, seed=0):
    params, state = cross(jm, tm, seed)
    y = jm.run(params, jnp.asarray(x), state=state, training=training)[0]
    dy = rand(seed + 1, np.shape(y))
    yj, gj, gxj, sj = ref_run(jm, params, x, dy, state, training)
    yt, gt, gxt, st = port_run(tm, x, dy, tm.initial_state(), training)
    np.testing.assert_allclose(yt, yj, **TOL)
    assert_grads([gxt] + gt, [gxj] + gj, GRAD_REL)
    return yj, sj, st


# --------------------------------------------------------------------- #
# SpaceToDepthConvolution                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", [(7, 3, 16, 16), (7, 3, 15, 17),
                                  (3, 1, 9, 8), (4, 1, 10, 11),
                                  (5, 0, 12, 12)])
def test_space_to_depth_conv(case):
    """Against the reference's s2d conv and against the port's plain
    strided conv on the same weights (odd kernels, an even kernel, odd
    extents, no padding)."""
    k, pad, h, w = case
    args = (3, 5, k, k, 2, 2, pad, pad)
    jm = jnn.SpaceToDepthConvolution(*args, format="NHWC")
    tm = tnn.SpaceToDepthConvolution(*args, format="NHWC")
    x = _nhwc(2, 3, h, w)
    yj, _, _ = _pair(jm, tm, x)
    plain = tnn.SpatialConvolution(*args, format="NHWC")
    plain.set_weights(tm.get_weights())
    ys = tm.run(tm.param_dict(), torch.from_numpy(x))[0]
    yp = plain.run(plain.param_dict(), torch.from_numpy(x))[0]
    assert ys.shape == yp.shape == np.shape(yj)
    torch.testing.assert_close(ys, yp, rtol=2e-5, atol=2e-5)


def test_space_to_depth_conv_checks_its_arguments():
    for kw, what in ((dict(format="NCHW"), "NHWC"),
                     (dict(format="NHWC", stride_w=1, stride_h=1),
                      "stride 2"),
                     (dict(format="NHWC", pad_w=-1, pad_h=-1), "SAME")):
        a = dict(n_input_plane=2, n_output_plane=2, kernel_w=3, kernel_h=3,
                 stride_w=2, stride_h=2)
        a.update(kw)
        with pytest.raises(ValueError, match=what):
            tnn.SpaceToDepthConvolution(**a)


@pytest.mark.parametrize("training", [False, True])
def test_resnet18_s2d_stem_at_224(training):
    jm = JR.build(class_num=10, depth=18, format="NHWC", stem="s2d")
    tm = TR.build(class_num=10, depth=18, format="NHWC", stem="s2d",
                  device="cpu")
    assert type(tm[0]).__name__ == "SpaceToDepthConvolution"
    x = _nhwc(1, 3, 224, 224, seed=2)
    params, state = cross(jm, tm)
    yj = np.asarray(jm.run(params, jnp.asarray(x), state=state,
                           training=training)[0])
    yt = tm.run(tm.param_dict(), torch.from_numpy(x),
                state=tm.initial_state(), training=training)[0]
    np.testing.assert_allclose(yt.detach().numpy(), yj, **TOL)
    # the s2d stem is the conv stem's function on the same weights
    conv = TR.build(class_num=10, depth=18, format="NHWC", device="cpu")
    conv.set_weights(tm.get_weights())
    yc = conv.run(conv.param_dict(), torch.from_numpy(x),
                  state=conv.initial_state(), training=training)[0]
    torch.testing.assert_close(yc, yt, rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------- #
# shortcut type A                                                       #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("training", [False, True])
def test_cifar_resnet8_shortcut_a_nchw(training):
    jm = JR.build(class_num=10, depth=8, dataset="cifar10",
                  shortcut_type="A")
    tm = TR.build(class_num=10, depth=8, dataset="cifar10",
                  shortcut_type="A", device="cpu")
    assert sum(isinstance(m, tnn.Padding) for m in tm.modules()) == 2
    x = rand(0, (4, 3, 32, 32))
    _, sj, st = _pair(jm, tm, x, training=training)
    for a, b in zip([t for sub in st.values() for t in sub.values()],
                    [t for sub in sj.values() for t in sub.values()]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_shortcut_a_in_nhwc_raises_citing_c6():
    """The reference's NHWC shortcut A pads the batch dim (Padding(1, n, 4)
    on a 4-dim activity) and its forward fails; the port refuses to build
    it instead of copying the crash or fixing it silently."""
    jm = JR.build(class_num=10, depth=8, dataset="cifar10",
                  shortcut_type="A", format="NHWC")
    params, state = jm.init_params(0)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jm.run(params, jnp.zeros((2, 32, 32, 3)), state=state)
    with pytest.raises(ValueError, match="C6"):
        TR.build(class_num=10, depth=8, dataset="cifar10",
                 shortcut_type="A", format="NHWC", device="cpu")


# --------------------------------------------------------------------- #
# remat                                                                 #
# --------------------------------------------------------------------- #
def test_remat_resnet_crosses_the_same_weights_and_matches():
    jm = JR.build(class_num=10, depth=8, dataset="cifar10", remat=True)
    tm = TR.build(class_num=10, depth=8, dataset="cifar10", remat=True,
                  device="cpu")
    plain = TR.build(class_num=10, depth=8, dataset="cifar10", device="cpu")
    assert sum(isinstance(m, tnn.Remat) for m in tm.modules()) == 3
    assert [tuple(w.shape) for w in tm.get_weights()] == \
        [tuple(w.shape) for w in plain.get_weights()]
    x = rand(1, (2, 3, 32, 32))
    _pair(jm, tm, x, training=True)
    # bitwise the unwrapped model on the same weights
    plain.set_weights(tm.get_weights())
    outs = []
    for m in (plain, tm):
        params = m.param_dict()
        leaves = [p for sub in params.values() for p in sub.values()]
        ctx = tnn.Ctx(state=m.initial_state(), training=True)
        y = m.apply(params, torch.from_numpy(x), ctx)
        outs.append((y, torch.autograd.grad(y.sum(), leaves),
                     [t for s in ctx.new_state.values() for t in s.values()]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1] + tuple(
        outs[0][2]), outs[1][1] + tuple(outs[1][2])))


# --------------------------------------------------------------------- #
# sync BN                                                               #
# --------------------------------------------------------------------- #
def _sync_model():
    jm = JR.build(class_num=10, depth=8, dataset="cifar10",
                  sync_bn_axis="dp")
    params, state = jm.init_params(5)
    jm.set_params(params, state)
    return jm, params, state


@pytest.fixture(scope="module")
def sync_ranks(tmp_path_factory):
    """{world: [results by rank]} of 2 ranks and of 1, from one spawn."""
    d = tmp_path_factory.mktemp("syncbn")
    jm, params, state = _sync_model()
    rng = np.random.RandomState(4)
    x = rng.randn(8, 3, 32, 32).astype(np.float32)
    y = (rng.randint(0, 10, 8) + 1).astype(np.float32)
    arrays = {f"w{i}": np.asarray(w) for i, w in enumerate(jm.get_weights())}
    arrays.update({f"s{i}": s for i, s in
                   enumerate(ref_state_list(jm, state))})
    np.savez(d / "in.npz", x=x, y=y, **arrays)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    runs = [(world, r) for world in (2, 1) for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_port_syncbn_rank.py"),
         str(r), str(world), str(d / f"store{world}"), str(d / "in.npz"),
         str(d / f"out{world}_{r}.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for world, r in runs]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * len(procs), logs
    out = {1: [], 2: []}
    for world, r in runs:
        out[world].append(pickle.loads((d / f"out{world}_{r}.pkl")
                                       .read_bytes()))
    return out, (x, y)


def _close(a, b, **tol):
    assert len(a) == len(b)
    for i, (u, v) in enumerate(zip(a, b)):
        np.testing.assert_allclose(u, v, err_msg=f"entry {i}", **tol)


def test_sync_bn_two_ranks_equal_one_process_on_the_full_batch(sync_ranks):
    out, _ = sync_ranks
    one = out[1][0]["sync"]
    for r in (0, 1):
        outs, grads, state = out[2][r]["sync"]
        np.testing.assert_allclose(outs, one[0], **SYNC_TOL)
        _close(grads, one[1], **SYNC_TOL)
        _close(state, one[2], **SYNC_TOL)
    # without the sync each rank normalizes its own half: the test can fail
    outs, _, state = out[2][0]["no_sync"]
    diff = max(np.abs(outs - one[0]).max(),
               max(np.abs(a - b).max() for a, b in zip(state, one[2])))
    assert diff > 1e-3, diff


def test_sync_bn_distri_step_against_the_reference(sync_ranks):
    """One DistriOptimizer step of SGD(0.05) with sync_bn_axis='dp': the
    reference's on 2 virtual devices against the port's on 2 gloo ranks,
    weights and batch-norm state."""
    out, (x, y) = sync_ranks
    jm, params, state = _sync_model()
    w0 = [np.asarray(w) for w in jm.get_weights()]
    saved = jmesh._current_mesh
    try:
        mesh = jmesh.create_mesh({"dp": 2}, devices=jax.devices()[:2])
        (JDistri(jm, (x, y), jnn.ClassNLLCriterion(), batch_size=8,
                 mesh=mesh)
         .set_optim_method(JSGD(learning_rate=0.05))
         .set_end_when(JTrigger.max_iteration(1))).optimize()
    finally:
        jmesh.set_mesh(saved)
    w_ref = [np.asarray(w) for w in jm.get_weights()]
    s_ref = ref_state_list(jm, jm._state)
    for r in (0, 1):
        w, s = out[2][r]["distri_step"]
        _close(w, w_ref, **SYNC_TOL)
        _close(s, s_ref, **SYNC_TOL)
    assert max(np.abs(a - b).max() for a, b in zip(w_ref, w0)) > 1e-4
