"""Live train→serve weight streaming in the port, held against the
reference, and the snapshot invariant it rests on.

The invariant: a tensor that a registered or published ``Snapshot`` holds
is never written in place.  The reference's snapshots hold immutable JAX
arrays; the port's hold tensors, and every optimizer path of the port
writes a model's parameters in place.  The first two tests train a
registered model (AdamW fused and plain, SGD fused) and swap, train and
roll back, and hold the snapshots, and what they serve, to the bit.

Then the stream itself: exactly one of ``trigger``/``every_steps``, the
trigger's firings and versions against the reference's, owning snapshots,
skip while busy, errors and rejections counted, SpmdTrainer streaming
through a canary into a 2-replica decode set (the reference's tiny LM,
2 layers, max_len 128, its weights through ``from_jax_params``) whose
post-publish tokens equal the reference engine's for the same weights,
and LocalOptimizer streaming into a ServingEngine registry.
"""
import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import transformer as JT
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.serving import DecodeEngine as JDecodeEngine
from bigdl_tpu.serving import ModelRegistry as JModelRegistry
from bigdl_tpu.serving import WeightStreamPublisher as JWSP
from bigdl_tpu.serving.replicas import CanaryRejectedError as JRejected
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.models.convert import from_jax_params, from_jax_weights
from bigdl_tpu_torch.optim import SGD, AdamW, LocalOptimizer, Trigger
from bigdl_tpu_torch.parallel import SpmdTrainer
from bigdl_tpu_torch.serving import (CanaryPublisher, CanaryRejectedError,
                                     DecodeEngine, ModelRegistry,
                                     ServingEngine, WeightStreamPublisher,
                                     build_decode_replica_set)

TINY = dict(n_layers=2, max_len=128)
V = 256
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_torch_port_decode.py
MARGIN_TOL = 2 * LOGIT_TOL["atol"]
GEOMETRY = dict(slots=4, page_size=8, max_context=64, max_prompt=16,
                max_new_tokens=8)
OPTIMIZERS = {"adamw_fused": lambda: AdamW(learning_rate=1e-2, fused=True),
              "adamw_plain": lambda: AdamW(learning_rate=1e-2),
              "sgd_fused": lambda: SGD(learning_rate=0.5, momentum=0.9,
                                       fused=True)}


@pytest.fixture(scope="module")
def ref():
    jm = JT.build("tiny", **TINY)
    jparams = jm.ensure_initialized()
    np_params = {k: {kk: np.asarray(vv) for kk, vv in sub.items()}
                 for k, sub in jparams.items()}
    return jm, jparams, np_params


def _port_lm(np_params):
    tm = TT.build("tiny", device="cpu", **TINY)
    from_jax_params(np_params, tm)
    return tm


def _prompts(n, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, V, rs.randint(2, 13)).astype(np.int32)
            for _ in range(n)]


def _batch(seed, b=2, s=16):
    ids = np.random.RandomState(seed).randint(0, V, (b, s + 1)).astype(
        np.int32)
    return ids[:, :-1], ids[:, 1:]


def _ref_tokens(jm, jparams, prompts):
    reg = JModelRegistry()
    reg.register("lm", jm)
    if jparams is not None:
        reg.swap_weights("lm", jparams)
    eng = JDecodeEngine(reg, "lm", **GEOMETRY).warmup()
    try:
        return [np.asarray(f.result(120)) for f in
                [eng.submit("lm", p) for p in prompts]]
    finally:
        eng.shutdown()


def _assert_reference_tokens(jm, jparams, prompts, got):
    """Greedy tokens equal the reference engine's on the same weights,
    except where the reference's own top two logits are closer than two
    logit tolerances (as tests/test_torch_port_decode.py holds them)."""
    want = _ref_tokens(jm, jparams, prompts)
    params = jparams if jparams is not None else jm._params
    for p, w, g in zip(prompts, want, got):
        assert g.shape == w.shape
        diff = np.nonzero(w != g)[0]
        if diff.size:
            j = int(diff[0])
            cache = jm.init_cache(1, cache_len=len(w))
            lg, _ = jm.apply_with_cache(params, jnp.asarray(w[None]), cache,
                                        0)
            top2 = np.sort(np.asarray(lg)[0, j - 1])[-2:]
            assert j >= len(p) and top2[1] - top2[0] < MARGIN_TOL, (p, w, g)


def _clone(params):
    return {k: {kk: v.detach().clone() for kk, v in sub.items()}
            for k, sub in params.items()}


def _bitwise(a, b):
    return all(torch.equal(a[k][kk], b[k][kk]) for k in a for kk in a[k])


# --------------------------------------------------------------------- #
# the invariant: snapshots are never written after publication          #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_registered_snapshot_survives_training(ref, opt):
    jm, _, np_params = ref
    tm = _port_lm(np_params)
    reg = ModelRegistry()
    reg.register("lm", tm)
    snap = reg.get("lm").snapshot
    held = _clone(snap.params)
    eng = DecodeEngine(reg, "lm", **GEOMETRY).warmup()
    prompts = _prompts(4, 1)
    try:
        before = [eng.predict("lm", p, timeout=60) for p in prompts]
        trainer = SpmdTrainer(tm, OPTIMIZERS[opt](), device="cpu")
        losses = trainer.fit([_batch(0), _batch(1)])
        assert len(losses) == 2 and np.isfinite(losses).all()
        # the trainer moved the module's weights in place ...
        assert not _bitwise(held, _clone(tm.param_dict()))
        # ... and the registered snapshot, and what it serves, did not move
        assert reg.get("lm").snapshot is snap and snap.version == "v1"
        assert _bitwise(snap.params, held)
        after = [eng.predict("lm", p, timeout=60) for p in prompts]
    finally:
        eng.shutdown()
    for a, b in zip(before, after):
        assert np.array_equal(a, b)
    _assert_reference_tokens(jm, None, prompts, after)


def test_swap_then_train_then_rollback_stays_bitwise(ref):
    _, _, np_params = ref
    tm = _port_lm(np_params)
    reg = ModelRegistry()
    reg.register("lm", tm)
    v1 = reg.get("lm").snapshot
    held_v1 = _clone(v1.params)
    eng = DecodeEngine(reg, "lm", **GEOMETRY).warmup()
    golden = _prompts(1, 2)[0]
    try:
        gold_v1 = eng.predict("lm", golden, timeout=60)
        w2 = {k: {kk: v.detach() * 1.05 for kk, v in sub.items()}
              for k, sub in tm.param_dict().items()}
        held_w2 = _clone(w2)
        reg.swap_weights("lm", w2)
        gold_w2 = eng.predict("lm", golden, timeout=60)
        # a trainer built from the module after the swap
        SpmdTrainer(tm, AdamW(learning_rate=1e-2, fused=True),
                    device="cpu").fit([_batch(3), _batch(4)])
        assert _bitwise(w2, held_w2) and _bitwise(v1.params, held_v1)
        assert np.array_equal(eng.predict("lm", golden, timeout=60), gold_w2)
        reg.swap_weights("lm", v1.params, v1.state, version=v1.version)
        assert np.array_equal(eng.predict("lm", golden, timeout=60), gold_v1)
        assert _bitwise(v1.params, held_v1)
    finally:
        eng.shutdown()


def test_swap_model_and_sync_from_model_take_owning_copies(ref):
    _, _, np_params = ref
    tm = _port_lm(np_params)
    reg = ModelRegistry()
    reg.register("lm", tm)
    other = _port_lm(np_params)
    entry = reg.swap_model("lm", other)
    assert entry.snapshot.version == "v2" and entry.model is other
    assert entry.compiled == {} and not entry.warmed
    held = _clone(entry.snapshot.params)
    with torch.no_grad():
        for sub in other.param_dict().values():
            for p in sub.values():
                p.mul_(2.0)
    assert _bitwise(entry.snapshot.params, held)       # owning copies
    snap = reg.sync_from_model("lm")
    assert snap.version == "v3"
    assert _bitwise(snap.params, _clone(other.param_dict()))
    with torch.no_grad():
        next(iter(next(iter(other.param_dict().values())).values())).zero_()
    assert not _bitwise(snap.params, _clone(other.param_dict()))


def test_promotion_copies_a_shared_module_once_per_tree(ref):
    """Replicas share one module; swapping the same tree into each of
    their registries rebinds it to copies once, never to the tree."""
    _, _, np_params = ref
    tm = _port_lm(np_params)
    regs = [ModelRegistry() for _ in range(3)]
    for reg in regs:
        reg.register("lm", tm)
    w2 = {k: {kk: v.detach() * 1.05 for kk, v in sub.items()}
          for k, sub in tm.param_dict().items()}
    held_w2 = _clone(w2)

    def bound():
        return [t for sub in tm.param_dict().values() for t in sub.values()]

    regs[0].swap_weights("lm", w2)
    first = bound()
    for reg in regs[1:]:
        reg.swap_weights("lm", w2)
        assert all(a is b for a, b in zip(bound(), first))
    assert _bitwise(w2, _clone(tm.param_dict()))
    assert not any(t.data_ptr() == w.data_ptr() for t, w in zip(
        first, [t for sub in w2.values() for t in sub.values()]))
    # a module rebound by anyone else is copied again on the next swap
    tm.load_param_dict(_clone(w2))
    regs[0].swap_weights("lm", w2)
    assert not any(a is b for a, b in zip(bound(), first))
    SpmdTrainer(tm, AdamW(learning_rate=1e-2, fused=True),
                device="cpu").fit([_batch(5)])
    assert _bitwise(w2, held_w2)


# --------------------------------------------------------------------- #
# the stream against the reference's                                    #
# --------------------------------------------------------------------- #
def _np_tree(seed):
    rs = np.random.RandomState(seed)
    return {"m": {"weight": rs.rand(3, 2).astype(np.float32)}}


def _torch_tree(seed):
    return {"m": {"weight": torch.from_numpy(_np_tree(seed)["m"]["weight"])
                  .requires_grad_()}}


def test_exactly_one_of_trigger_or_every_steps():
    for cls, trig in ((WeightStreamPublisher, Trigger),
                      (JWSP, JTrigger)):
        with pytest.raises(ValueError, match="exactly one"):
            cls(lambda *a: None, "m")
        with pytest.raises(ValueError, match="exactly one"):
            cls(lambda *a: None, "m", every_steps=2,
                trigger=trig.several_iteration(2))


@pytest.mark.parametrize("every,trigger", [(2, None), (None, 3)])
def test_trigger_gating_and_versions_equal(every, trigger):
    runs = []
    for cls, trig, tree in ((JWSP, JTrigger, _np_tree(0)),
                            (WeightStreamPublisher, Trigger,
                             _torch_tree(0))):
        calls = []
        w = cls(lambda name, params, version: calls.append((name, version)),
                "lm", every_steps=every, sync=True,
                trigger=None if trigger is None
                else trig.several_iteration(trigger))
        fired = [w.maybe_publish(tree, step=k) for k in range(0, 8)]
        counts = {k: w.recorder.counter_value(k) for k in (
            "stream/snapshots", "stream/published", "stream/skipped_busy")}
        runs.append((fired, calls, counts, w.last_published[0]))
    assert runs[1] == runs[0]


def test_snapshot_is_an_owning_copy_on_the_parameters_device():
    got = {}
    w = WeightStreamPublisher(lambda n, p, v: got.update(p=p), "lm",
                              every_steps=1, sync=True)
    tree = _torch_tree(1)
    held = tree["m"]["weight"].detach().clone()
    assert w.maybe_publish(tree, step=1)
    snap = got["p"]["m"]["weight"]
    assert snap.data_ptr() != tree["m"]["weight"].data_ptr()
    assert snap.device == tree["m"]["weight"].device
    assert not snap.requires_grad
    with torch.no_grad():
        tree["m"]["weight"].add_(1.0)            # the next step, in place
    assert torch.equal(snap, held)
    assert w.last_published[1]["m"]["weight"] is snap


def _busy_run(cls, tree):
    gate, started = threading.Event(), threading.Event()
    calls = []

    def target(name, params, version):
        started.set()
        gate.wait(30)
        calls.append(version)

    w = cls(target, "lm", every_steps=2)
    out = [w.maybe_publish(tree, step=2)]
    started.wait(30)
    out.append(w.maybe_publish(tree, step=3))     # no firing
    out.append(w.maybe_publish(tree, step=4))     # fires while busy: skip
    gate.set()
    w.wait(30)
    out.append(w.maybe_publish(tree, step=6))
    w.wait(30)
    return out, calls, {k: w.recorder.counter_value(k) for k in (
        "stream/snapshots", "stream/published", "stream/skipped_busy")}


def test_skip_while_busy_equal():
    want = _busy_run(JWSP, _np_tree(2))
    got = _busy_run(WeightStreamPublisher, _torch_tree(2))
    assert got == want
    assert got[0] == [True, False, False, True]
    assert got[2]["stream/skipped_busy"] == 1


def _failures(cls, rejected_cls, tree):
    plan = ["error", "reject", "ok"]

    def target(name, params, version):
        what = plan.pop(0)
        if what == "error":
            raise RuntimeError("swap failed")
        if what == "reject":
            raise rejected_cls("non_finite", "poisoned")

    w = cls(target, "lm", every_steps=1, sync=True)
    for k in (1, 2, 3):
        w.maybe_publish(tree, step=k)
    return w.last_rejected, w.last_published[0], {
        k: w.recorder.counter_value(k) for k in (
            "stream/published", "stream/rejected", "stream/errors")}


def test_errors_and_rejections_counted_and_the_latch_released():
    want = _failures(JWSP, JRejected, _np_tree(3))
    got = _failures(WeightStreamPublisher, CanaryRejectedError,
                    _torch_tree(3))
    assert got == want == ("stream_iter2", "stream_iter3",
                           {"stream/published": 1, "stream/rejected": 1,
                            "stream/errors": 1})


# --------------------------------------------------------------------- #
# trainers streaming into serving                                       #
# --------------------------------------------------------------------- #
def test_spmd_trainer_streams_through_the_canary_into_a_decode_set(ref):
    jm, jparams, np_params = ref
    tm = _port_lm(np_params)
    golden = np.arange(1, 9, dtype=np.int32)
    rs = build_decode_replica_set(tm, 2, name="lm", probe_prompt=golden,
                                  engine_kw=GEOMETRY).warmup()
    prompts = _prompts(3, 7)
    try:
        pre = [r.engine.predict("lm", golden, timeout=60)
               for r in rs.replicas]
        pub = CanaryPublisher(rs, {"lm": golden})
        wsp = WeightStreamPublisher(pub, "lm", every_steps=2)
        trainer = SpmdTrainer(tm, AdamW(learning_rate=1e-2, fused=True),
                              device="cpu").set_weight_stream(wsp)
        futs = [rs.submit("lm", p) for p in prompts]
        trainer.fit([_batch(10)])
        # before the first publish the set serves the registered weights
        assert all(np.array_equal(r.engine.predict("lm", golden,
                                                   timeout=60), p)
                   for r, p in zip(rs.replicas, pre))
        trainer.fit([_batch(11)])              # step 2 fires
        wsp.wait(60)
        trainer.fit([_batch(12)])
        trainer.fit([_batch(13)])              # step 4 fires
        wsp.wait(60)
        assert [f.result(60).shape for f in futs] == [
            (len(p) + 8,) for p in prompts]
        rec = wsp.recorder
        assert rec.counter_value("stream/published") == 2
        assert rec.counter_value("stream/errors") == 0
        version, published = wsp.last_published
        assert version == "stream_iter4"
        assert [r.engine.registry.get("lm").snapshot.version
                for r in rs.replicas] == [version, version]
        got = [rs.replicas[i % 2].engine.predict("lm", p, timeout=60)
               for i, p in enumerate(prompts + [golden])]
        assert rs.recorder.counter_value("serving/canary_promoted") == 2
    finally:
        rs.shutdown()
    # the port's module names differ from the reference's in their root
    # (a per-instance counter): match them by what follows it
    by_suffix = {k.split(".", 1)[-1]: sub for k, sub in published.items()}
    jpub = {jk: {kk: jnp.asarray(by_suffix[jk.split(".", 1)[-1]][kk]
                                 .numpy()) for kk in sub}
            for jk, sub in jparams.items()}
    _assert_reference_tokens(jm, jpub, prompts + [golden], got)


def _mlp_pair():
    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2),
                        jnn.LogSoftMax())
    jm.ensure_initialized()
    tm = tnn.Sequential(tnn.Linear(4, 8), tnn.ReLU(), tnn.Linear(8, 2),
                        tnn.LogSoftMax())
    from_jax_weights([np.asarray(w) for w in jm.get_weights()], tm)
    return jm, tm


def test_local_optimizer_streams_into_a_serving_registry():
    rs = np.random.RandomState(0)
    x = rs.rand(24, 4).astype(np.float32)
    y = (rs.rand(24) > 0.5).astype(np.float32) + 1.0
    jm, tm = _mlp_pair()
    jpub = []
    (JLocalOptimizer(jm, (x, y), jnn.ClassNLLCriterion(), batch_size=4)
     .set_optim_method(JSGD(learning_rate=0.1, momentum=0.9))
     .set_end_when(JTrigger.max_iteration(5))
     .set_weight_stream(JWSP(lambda n, p, v: jpub.append((v, p)), "m",
                             every_steps=2, sync=True))
     .optimize())
    reg = ModelRegistry()
    reg.register("m", tm, input_shape=(4,))
    eng = ServingEngine(reg, max_batch=4, max_delay_ms=1.0).warmup()
    wsp = WeightStreamPublisher(reg, "m", every_steps=2, sync=True)
    try:
        (LocalOptimizer(tm, (x, y), tnn.ClassNLLCriterion(), batch_size=4,
                        device="cpu")
         .set_optim_method(SGD(learning_rate=0.1, momentum=0.9, fused=True))
         .set_end_when(Trigger.max_iteration(5))
         .set_weight_stream(wsp).optimize())
        version, published = wsp.last_published
        assert [v for v, _ in jpub] == ["stream_iter2", "stream_iter4"]
        assert version == "stream_iter4"
        assert wsp.recorder.counter_value("stream/published") == 2
        assert reg.get("m").snapshot.version == version
        served = eng.predict("m", x[:4], timeout=30)
    finally:
        eng.shutdown()
    ref_w = [np.asarray(w) for w in _weights_of(jm, jpub[-1][1])]
    tm.load_param_dict(published)
    for a, b in zip(tm.get_weights(), ref_w):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)
    with torch.inference_mode():
        want = tm.run(published, torch.from_numpy(x[:4]))[0].numpy()
    np.testing.assert_array_equal(served, want)


def _weights_of(jm, params):
    """The reference's get_weights() order over ``params``."""
    old = jm._params
    jm._params = params
    try:
        return jm.get_weights()
    finally:
        jm._params = old

