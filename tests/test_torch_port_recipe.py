"""BigDL's ImageNet training recipe, ported, held against the reference on
the CPU at a small size: per-layer regularizers, ``freeze``, gradient
clipping by norm and by value, gradient accumulation, the whole path
from records on disk (the native ring, ``FileRecordDataSet``, a device
augmentation, ``SequentialSchedule(Warmup, Poly)``, validation) through
``LocalOptimizer``, and ``DistriOptimizer`` with clipping and
accumulation under dp, buckets, fsdp and zero1 over 2 gloo ranks
(``_torch_port_recipe_rank.py``) against the reference's on 2 virtual
devices.

Tolerances: both sides compute in fp32; XLA-CPU and ATen-CPU sum convs,
matmuls and reductions in other orders.  Losses within ``rtol=1e-5`` and
weights and BN state within ``rtol=1e-5, atol=1e-6``, as
``tests/test_torch_port_classifier.py`` holds its bottleneck stage;
regularization losses and their gradients within ``rtol=1e-6`` (one fp32
reduction each side).  Frozen parameters are checked bitwise against
their initial values.  Freezing, clipping and accumulation run on
LeNet-5 (no batch norm) at ``SGD(0.1, momentum 0.9, wd 1e-4)``; the
records path runs a CIFAR ResNet-8 at lr 0.002.  A ResNet-8 on a few
random images is ill-conditioned across the two backends: at lr 0.1 and
batch 8 their summation orders alone, with none of these features on,
move its weights apart by up to 7e-5 in 3 steps, above these limits.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.data import dataset as jds
from bigdl_tpu.data import device_augment as jaug
from bigdl_tpu.data import minibatch as jmb
from bigdl_tpu.data.prefetch import FileRecordDataSet as JFileRecordDataSet
from bigdl_tpu.models import lenet as JL
from bigdl_tpu.models import resnet as JR
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Top1Accuracy as JTop1
from bigdl_tpu.optim import Loss as JLoss
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.optim import lr_schedule as JS
from bigdl_tpu.optim import regularizer as JReg
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.parallel import mesh as jmesh
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.data import DeviceAugment, FileRecordDataSet, Sample
from bigdl_tpu_torch.data import SampleToMiniBatch
from bigdl_tpu_torch.kernels.fused_optim import zip_leaves
from bigdl_tpu_torch.models import lenet as TL
from bigdl_tpu_torch.models import resnet as TR
from bigdl_tpu_torch.models.convert import from_jax_weights
from bigdl_tpu_torch.optim import (SGD, L1L2Regularizer, L1Regularizer,
                                   L2Regularizer, LocalOptimizer, Loss,
                                   Top1Accuracy, Trigger)
from bigdl_tpu_torch.optim import lr_schedule as TS
from bigdl_tpu_torch.optim.optimizer import _ClippedOptim

REPO = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=1e-5)
WEIGHT_TOL = dict(rtol=1e-5, atol=1e-6)
REG_TOL = dict(rtol=1e-6, atol=0)


def _ref_state_list(jm, state):
    return [np.asarray(state[m.name][k]) for m in jm.modules()
            if m.name in state for k in sorted(state[m.name])]


def _resnet8(seed=3):
    jm = JR.build(class_num=10, depth=8, dataset="cifar10", format="NHWC")
    params, state = jm.init_params(seed)
    jm.set_params(params, state)
    tm = TR.build(class_num=10, depth=8, dataset="cifar10", format="NHWC",
                  device="cpu")
    from_jax_weights(jm.get_weights(), tm, _ref_state_list(jm, state))
    return jm, tm


def _linear(m):
    return [x for x in m.modules() if type(x).__name__ == "Linear"][-1]


def _first_conv(m):
    return [x for x in m.modules()
            if type(x).__name__ == "SpatialConvolution"][0]


def _hooked(opt, losses):
    fire = opt._fire_mid_epoch

    def hook(*a):
        losses.append(float(opt.state.loss))
        return fire(*a)
    opt._fire_mid_epoch = hook
    return opt


def _compare(jm, tm, lj, lt):
    assert len(lt) == len(lj) > 0
    np.testing.assert_allclose(lt, lj, **LOSS_TOL)
    for a, b in zip(tm.get_weights(), jm.get_weights()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **WEIGHT_TOL)
    for a, b in zip(tm.state_list(), _ref_state_list(jm, jm._state)):
        np.testing.assert_allclose(a.numpy(), b, **WEIGHT_TOL)


def _pair(jm, tm, data, batch, sgd_kw, configure, end=3):
    """The reference's and the port's LocalOptimizer from the same
    weights, each configured by ``configure(opt, side)``: per-step
    losses."""
    lj, lt = [], []
    jo = _hooked(JLocalOptimizer(jm, data, jnn.ClassNLLCriterion(),
                                 batch_size=batch), lj)
    jo.set_optim_method(JSGD(**sgd_kw)).set_end_when(
        JTrigger.max_iteration(end))
    configure(jo, "ref")
    jo.optimize()
    to = _hooked(LocalOptimizer(tm, data, tnn.ClassNLLCriterion(),
                                batch_size=batch, device="cpu"), lt)
    to.set_optim_method(SGD(**sgd_kw)).set_end_when(
        Trigger.max_iteration(end))
    configure(to, "port")
    to.optimize()
    return lj, lt


SGD_KW = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
BATCH = 16


def _lenet(seed=1):
    jm = JL.build(10)
    params, state = jm.init_params(seed)
    jm.set_params(params, state)
    tm = TL.build(10, device="cpu")
    from_jax_weights(jm.get_weights(), tm)
    return jm, tm


def _rows(seed, n=48):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 784).astype(np.float32),
            (rs.randint(0, 10, n) + 1).astype(np.float32))


def _images(seed, n=16):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 32, 32, 3).astype(np.float32),
            (rs.randint(0, 10, n) + 1).astype(np.float32))


# --------------------------------------------------------------------- #
def test_regularization_loss_and_gradients_match_the_reference():
    def build(nn, reg):
        return nn.Sequential(
            nn.SpatialConvolution(3, 4, 3, 3, w_regularizer=reg.L1L2Regularizer(
                1e-3, 2e-2), b_regularizer=reg.L2Regularizer(0.5)),
            nn.Linear(6, 5, w_regularizer=reg.L2Regularizer(0.1),
                      b_regularizer=reg.L1Regularizer(0.05)),
            nn.Linear(5, 2))
    import bigdl_tpu_torch.optim.regularizer as treg
    jm = build(jnn, JReg)
    params, _ = jm.init_params(4)
    jm.set_params(params, {})
    tm = build(tnn, treg)
    from_jax_weights(jm.get_weights(), tm)
    want = float(jm.regularization_loss(params))
    jgrads = jax.grad(jm.regularization_loss)(params)
    tp = tm.param_dict()
    got = tm.regularization_loss(tp)
    np.testing.assert_allclose(got.item(), want, **REG_TOL)
    leaves = [p for (p,) in zip_leaves(tp)]
    tgrads = torch.autograd.grad(got, leaves, allow_unused=True)
    flat = [np.asarray(jgrads[m.name][k]) for m in jm.modules()
            if m.name in jgrads for k in ("weight", "bias")]
    assert len(flat) == len(tgrads) == 6
    for t, j in zip(tgrads, flat):
        t = np.zeros_like(j) if t is None else t.numpy()
        # the weight is (out, in) on both sides for Linear and conv
        np.testing.assert_allclose(t, j, **REG_TOL)
    assert tnn.Linear(2, 2).regularization_loss({}) == 0.0
    assert isinstance(L1Regularizer(0.1), L1L2Regularizer)


@pytest.mark.parametrize("accum", [1, 2])
def test_freeze_matches_the_reference_and_keeps_frozen_weights(accum):
    """The first conv frozen on both sides, SGD with momentum and no
    weight decay (which would still move frozen weights, as in the
    reference): the frozen weights stay bitwise, the rest match."""
    kw = dict(SGD_KW, weight_decay=0.0)
    jm, tm = _lenet()
    jm.freeze([_first_conv(jm).name])
    tm.freeze([_first_conv(tm).name])
    frozen = tm.frozen_param_names()
    assert frozen == {_first_conv(tm).name}
    assert len(jm.frozen_param_names()) == 1
    before = {n: {k: v.clone() for k, v in sub.items()}
              for n, sub in tm.param_dict().items() if n in frozen}
    x, y = _rows(5)

    def configure(opt, side):
        opt.set_gradient_accumulation(accum)
    lj, lt = _pair(jm, tm, (x, y), BATCH, kw, configure)
    _compare(jm, tm, lj, lt)
    after = tm.param_dict()
    for n, sub in before.items():
        for k, v in sub.items():
            assert torch.equal(after[n][k], v), (n, k)
    tm.unfreeze()
    assert tm.frozen_param_names() == set()
    with pytest.raises(ValueError, match="no submodule"):
        tm.freeze(["nope"])


@pytest.mark.parametrize("clip", ["norm", "const"])
def test_gradient_clipping_matches_the_reference(clip):
    jm, tm = _lenet(2)
    x, y = _rows(6)

    def configure(opt, side):
        if clip == "norm":
            opt.set_gradient_clipping_by_l2_norm(0.5)
        else:
            opt.set_constant_gradient_clipping(-0.002, 0.002)
    lj, lt = _pair(jm, tm, (x, y), BATCH, SGD_KW, configure)
    _compare(jm, tm, lj, lt)


def test_clipped_optim_scales_to_the_norm_and_leaves_small_grads():
    class Keep:
        def init_state(self, params):
            return {}

        def update(self, grads, params, state):
            self.got = grads
            return params, state

    grads = {"a": {"w": torch.tensor([3.0, 4.0])},
             "b": {"w": torch.tensor([[12.0]])}}
    inner = Keep()
    c = _ClippedOptim(inner, clip_norm=6.5)
    c.update(grads, None, {})
    assert c.last_norm.item() == 13.0
    np.testing.assert_allclose(inner.got["a"]["w"].numpy(), [1.5, 2.0])
    np.testing.assert_allclose(inner.got["b"]["w"].numpy(), [[6.0]])
    c = _ClippedOptim(inner, clip_norm=20.0)
    c.update(grads, None, {})
    assert torch.equal(inner.got["a"]["w"], grads["a"]["w"])   # untouched
    c = _ClippedOptim(inner, clip_const=(-3.5, 3.5))
    c.update(grads, None, {})
    np.testing.assert_array_equal(inner.got["a"]["w"].numpy(), [3.0, 3.5])


def test_gradient_accumulation_matches_the_reference():
    """n_accum=2 with an L2 regularizer on the classifier: the reference
    adds the regularizer once, outside the microbatch loop, and so does
    the port."""
    jm, tm = _lenet(3)
    _linear(jm).w_regularizer = JReg.L2Regularizer(1e-2)
    _linear(tm).w_regularizer = L2Regularizer(1e-2)
    x, y = _rows(7)

    def configure(opt, side):
        opt.set_gradient_accumulation(2)
    lj, lt = _pair(jm, tm, (x, y), BATCH, SGD_KW, configure)
    _compare(jm, tm, lj, lt)
    with pytest.raises(ValueError, match="n_accum"):
        LocalOptimizer(tm, (x, y), tnn.ClassNLLCriterion(), batch_size=8,
                       device="cpu").set_gradient_accumulation(0)


# --------------------------------------------------------------------- #
REC_H = REC_W = 40
CROP = 32
REC_BYTES = 4 + REC_H * REC_W * 3
MEAN, STD = (125.3, 123.0, 113.9), (63.0, 62.1, 66.7)     # BGR, CIFAR's


def _write_records(d, n_files, per_file, seed):
    rs = np.random.RandomState(seed)
    paths = []
    for fi in range(n_files):
        p = d / f"part{fi}.bin"
        with open(p, "wb") as f:
            for _ in range(per_file):
                lab = int(rs.randint(1, 11))
                px = rs.randint(0, 256, (REC_H, REC_W, 3)).astype(np.uint8)
                # a class-dependent band, so that the loss can fall
                px[4 + 2 * (lab % 8):8 + 2 * (lab % 8)] = 230
                f.write(np.int32(lab).astype("<i4").tobytes() + px.tobytes())
        paths.append(str(p))
    return paths


def _decoder(sample):
    def decode(rec):
        label = np.frombuffer(rec, "<i4", 1)[0]
        px = np.frombuffer(rec, np.uint8, offset=4).reshape(REC_H, REC_W, 3)
        return sample(px, np.float32(label))
    return decode


def test_records_on_disk_recipe_matches_the_reference(tmp_path):
    """Records (4-byte label + 40x40x3 uint8 BGR) in 2 files through the
    native ring (one worker: file order) → samples → batches of 8, a
    deterministic device augmentation (center crop 32, normalize, NHWC),
    ``SGD(0.002, momentum 0.9, wd 1e-4)`` under ``SequentialSchedule(
    Warmup, Poly)``, an L2 regularizer on the classifier, clipping by
    norm, and validation on held-out records every epoch, 2 epochs:
    losses, weights, BN state and validation against the reference's
    LocalOptimizer on the same files."""
    train = _write_records(tmp_path, 2, 12, 8)
    vdir = tmp_path / "val"
    vdir.mkdir()
    val = _write_records(vdir, 1, 10, 9)
    jm, tm = _resnet8(6)
    _linear(jm).w_regularizer = JReg.L2Regularizer(1e-3)
    _linear(tm).w_regularizer = L2Regularizer(1e-3)
    jaugment = jaug.DeviceAugment(crop=(CROP, CROP), mean=MEAN, std=STD,
                                  out_format="NHWC")
    taugment = DeviceAugment(crop=(CROP, CROP), mean=MEAN, std=STD,
                             out_format="NHWC")
    sched = lambda m: m.SequentialSchedule(3).add(m.Warmup(2e-4), 3).add(
        m.Poly(0.5, 3), 3)
    sgd_kw = dict(SGD_KW, learning_rate=0.002)

    lj, lt = [], []
    jtrain = JFileRecordDataSet(train, REC_BYTES, _decoder(jmb.Sample),
                                n_workers=1) >> jds.SampleToMiniBatch(8)
    jval = JFileRecordDataSet(val, REC_BYTES, _decoder(jmb.Sample),
                              n_workers=1) >> jds.SampleToMiniBatch(4)
    jo = _hooked(JLocalOptimizer(jm, jtrain, jnn.ClassNLLCriterion()), lj)
    (jo.set_optim_method(JSGD(learning_rate_schedule=sched(JS), **sgd_kw))
     .set_end_when(JTrigger.max_epoch(2))
     .set_device_augment(lambda x, rng, training=True:
                         jaugment(x, training=False))
     .set_gradient_clipping_by_l2_norm(2.0)
     .set_validation(JTrigger.every_epoch(), jval,
                     [JTop1(), JLoss(jnn.ClassNLLCriterion())]))
    jo.optimize()

    ttrain = FileRecordDataSet(train, REC_BYTES, _decoder(Sample),
                               n_workers=1) >> SampleToMiniBatch(8)
    tval = FileRecordDataSet(val, REC_BYTES, _decoder(Sample),
                             n_workers=1) >> SampleToMiniBatch(4)
    to = _hooked(LocalOptimizer(tm, ttrain, tnn.ClassNLLCriterion(),
                                device="cpu"), lt)
    (to.set_optim_method(SGD(learning_rate_schedule=sched(TS), **sgd_kw))
     .set_end_when(Trigger.max_epoch(2))
     .set_device_augment(lambda x, gen, training=True:
                         taugment(x, training=False))
     .set_gradient_clipping_by_l2_norm(2.0)
     .set_validation(Trigger.every_epoch(), tval,
                     [Top1Accuracy(), Loss(tnn.ClassNLLCriterion())]))
    to.optimize()
    assert len(lt) == 6
    _compare(jm, tm, lj, lt)
    got = [r.result() for _, r in to.last_validation]
    assert got[0][1] == 10                       # every held-out record
    assert to.state.score == got[0][0] == jo.state.score


def test_uint8_batches_cross_to_the_device_as_uint8():
    """The host ring keeps a uint8 batch at 1 byte a pixel: neither the
    inline placement nor prefetch's staging casts it."""
    from bigdl_tpu_torch.data.device_loader import HostToDevice
    from bigdl_tpu_torch.optim.optimizer import to_device
    x = np.random.RandomState(0).randint(0, 256, (4, 8, 8, 3)).astype(
        np.uint8)
    (staged,) = HostToDevice("cpu")((x,)).take()
    assert staged.dtype == torch.uint8 and staged.element_size() == 1
    assert to_device(x, "cpu").dtype == torch.uint8
    np.testing.assert_array_equal(staged.numpy(), x)


def test_device_augment_seeded_loop_is_reproducible():
    """A random crop and flip in the step draw from the loop's generator
    (``seed + 13``): the same seed gives the same run, another seed
    another; validation runs the center crop."""
    rs = np.random.RandomState(10)
    x = rs.randint(0, 256, (16, 36, 36, 3)).astype(np.uint8)
    y = (rs.randint(0, 10, 16) + 1).astype(np.float32)

    def run(seed):
        _, tm = _resnet8(7)
        losses = []
        opt = _hooked(LocalOptimizer(tm, (x, y), tnn.ClassNLLCriterion(),
                                     batch_size=8, seed=seed,
                                     device="cpu"), losses)
        (opt.set_optim_method(SGD(0.05)).set_end_when(Trigger.max_epoch(2))
         .set_device_augment(DeviceAugment(crop=(32, 32), flip=True,
                                           mean=MEAN, std=STD,
                                           out_format="NHWC"))
         .set_validation(Trigger.every_epoch(), (x[:8], y[:8]),
                         [Top1Accuracy()]))
        opt.optimize()
        return losses, [w.clone() for w in tm.get_weights()]

    a, b, c = run(1), run(1), run(2)
    assert a[0] == b[0] and all(torch.equal(u, v) for u, v in zip(a[1], b[1]))
    assert a[0] != c[0]


def test_plateau_reads_the_epoch_score():
    _, tm = _resnet8(8)
    x, y = _images(11)
    sched = TS.Plateau(monitor="score", factor=0.5, patience=1, mode="max")
    seen = []
    opt = (LocalOptimizer(tm, (x, y), tnn.ClassNLLCriterion(), batch_size=8,
                          device="cpu")
           .set_optim_method(SGD(0.05, learning_rate_schedule=sched))
           .set_end_when(Trigger.max_epoch(4))
           .set_validation(Trigger.every_epoch(), (x[:8], y[:8]),
                           [Loss(tnn.ClassNLLCriterion())]))
    orig = sched.on_epoch_end

    def spy(metric):
        seen.append(metric)
        orig(metric)
    sched.on_epoch_end = spy
    opt.optimize()
    assert len(seen) == 4 and seen[-1] == opt.state.score
    # a falling loss read in "max" mode never improves after the first
    assert sched.current_factor < 1.0


# --------------------------------------------------------------------- #
WORLD = 2


def _make_data(n=256, d=12, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d, 1).astype(np.float32)
    y = (x @ w + 0.01 * rng.randn(n, 1)).astype(np.float32)
    return x, y


def _make_ref_model(seed=3):
    m = jnn.Sequential(jnn.Linear(12, 8), jnn.Tanh(), jnn.Linear(8, 1))
    m.reset(seed)
    return m


def _ref_distri(kw, clip, n_accum):
    """The reference's DistriOptimizer with clipping and accumulation on
    2 of the virtual devices: (per-step losses, final weights)."""
    import _torch_port_recipe_rank as R
    saved = jmesh._current_mesh
    try:
        mesh = jmesh.create_mesh({"dp": WORLD}, devices=jax.devices()[:WORLD])
        jm = _make_ref_model()
        x, y = _make_data()
        opt = (JDistri(jm, (x, y), jnn.MSECriterion(), batch_size=R.BATCH,
                       mesh=mesh, **kw)
               .set_optim_method(JSGD(learning_rate=0.05, momentum=0.9))
               .set_end_when(JTrigger.max_epoch(R.EPOCHS))
               .set_gradient_accumulation(n_accum))
        if clip[0] == "norm":
            opt.set_gradient_clipping_by_l2_norm(clip[1])
        else:
            opt.set_constant_gradient_clipping(*clip[1])
        losses = []
        _hooked(opt, losses)
        opt.optimize()
        return losses, [np.asarray(w) for w in jm.get_weights()]
    finally:
        jmesh.set_mesh(saved)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("recipe_distri")
    w0 = [np.asarray(w) for w in _make_ref_model().get_weights()]
    np.savez(d / "w.npz", **{f"w{i}": w for i, w in enumerate(w0)})
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_port_recipe_rank.py"),
         str(r), str(WORLD), str(d / "store"), str(d / "w.npz"),
         str(d / f"out{r}.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * WORLD, logs
    return [pickle.loads((d / f"out{r}.pkl").read_bytes())
            for r in range(WORLD)]


def _run_names():
    sys.path.insert(0, str(REPO / "tests"))
    import _torch_port_recipe_rank as R
    return sorted(R.RUNS)


@pytest.mark.parametrize("name", _run_names())
def test_distri_clipping_and_accumulation_match_the_reference(ranks, name):
    import _torch_port_recipe_rank as R
    kw, clip, n_accum = R.RUNS[name]
    lj, wj = _ref_distri(kw, clip, n_accum)
    for r in ranks:
        got = r[name]
        assert len(got["losses"]) == len(lj) == 8
        np.testing.assert_allclose(got["losses"], lj, **LOSS_TOL)
        for a, b in zip(got["weights"], wj):
            np.testing.assert_allclose(a, b, **WEIGHT_TOL)
    # the ranks agree: one global norm, one update
    np.testing.assert_array_equal(ranks[0][name]["losses"],
                                  ranks[1][name]["losses"])
    if clip[0] == "norm":
        norms = ranks[0][name]["norms"]
        assert len(norms) == 8 and max(norms) > clip[1]
        assert norms == ranks[1][name]["norms"]


def test_distri_ranks_draw_from_their_own_generators(ranks):
    assert [r["generator_seed"] for r in ranks] == [18, 18 + 1000003]
    assert all(r["jax_free"] for r in ranks)
