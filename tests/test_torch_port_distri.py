"""The port's ``DistriOptimizer`` on 2 gloo ranks against the reference's
on a 2-device mesh, on ``tests/test_distributed.py``'s MLP and MSE.

The ranks are spawned once for the module (``_torch_port_distri_rank.py``,
which imports neither jax nor ``bigdl_tpu``); each trains every
configuration from the reference's initial weights and writes its losses,
weights and readings.  The reference's runs happen here, on the virtual
XLA devices (``tests/conftest.py``).

Tolerances: dp against the reference and against the port's
``LocalOptimizer`` within the reference's own ``rtol=2e-4, atol=2e-5``
(``tests/test_distributed.py``); zero1 and fsdp against dp, and bucketed
against monolithic, bitwise for SGD (every exchange at 2 ranks is one
IEEE add of the same two values, then the same ÷2); zero1 against dp
for Adam within 1e-6 (``tests/test_zero1.py``'s bound); the 16-bit wire
against the reference's within ``WIRE_TOL``.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.optim.optim_method import SGD as JSGDm
from bigdl_tpu.parallel import mesh as jmesh
from bigdl_tpu.parallel.bucketer import GradBucketer as JBucketer
from bigdl_tpu.parallel.zero import Zero1Layout as JZero1
from bigdl_tpu.models import resnet as JR
from bigdl_tpu_torch.models import resnet as TR
from bigdl_tpu_torch.parallel import mesh as tmesh
from bigdl_tpu_torch.parallel.allreduce import tree_leaves
from bigdl_tpu_torch.parallel.bucketer import GradBucketer
from bigdl_tpu_torch.parallel.zero import Zero1Layout

REPO = Path(__file__).resolve().parents[1]
REF_TOL = dict(rtol=2e-4, atol=2e-5)
ADAM_TOL = dict(rtol=1e-5, atol=1e-6)
# bf16/fp16 wire, port against reference: the two sum the same 16-bit
# values, but their fp32 gradients differ in the last bits (XLA's and
# ATen's matmul orders), which can flip a 16-bit rounding.  After 12
# steps the weights read max |dw| 6.0e-8 (bf16) and 3.7e-7 (fp16); the
# port's fp32 wire reads 2.1e-3 and 1.1e-4 from the reference's bf16 and
# fp16 runs, and must fail this limit (checked below)
WIRE_TOL = dict(rtol=1e-5, atol=2e-6)
WORLD = 2


def make_data(n=256, d=12, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d, 1).astype(np.float32)
    y = (x @ w + 0.01 * rng.randn(n, 1)).astype(np.float32)
    return x, y


def make_ref_model(seed=3):
    m = jnn.Sequential(jnn.Linear(12, 8), jnn.Tanh(), jnn.Linear(8, 1))
    m.reset(seed)
    return m


def ref_run(**kw):
    """The reference's DistriOptimizer, 3 epochs of SGD(0.05) at batch 64
    on 2 of the virtual devices: (per-step losses, final weights)."""
    saved = jmesh._current_mesh
    try:
        mesh = jmesh.create_mesh({"dp": WORLD}, devices=jax.devices()[:WORLD])
        jm = make_ref_model()
        x, y = make_data()
        opt = (JDistri(jm, (x, y), jnn.MSECriterion(), batch_size=64,
                       mesh=mesh, **kw)
               .set_optim_method(JSGD(learning_rate=0.05))
               .set_end_when(JTrigger.max_epoch(3)))
        losses = []
        fire = opt._fire_mid_epoch

        def hook(*a):
            losses.append(float(opt.state.loss))
            return fire(*a)
        opt._fire_mid_epoch = hook
        opt.optimize()
        return losses, [np.asarray(w) for w in jm.get_weights()]
    finally:
        jmesh.set_mesh(saved)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results (rank 0 first), from one spawn."""
    d = tmp_path_factory.mktemp("distri")
    w0 = [np.asarray(w) for w in make_ref_model().get_weights()]
    np.savez(d / "w.npz", **{f"w{i}": w for i, w in enumerate(w0)})
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_port_distri_rank.py"),
         str(r), str(WORLD), str(d / "store"), str(d / "w.npz"),
         str(d / f"out{r}.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * WORLD, logs
    return [pickle.loads((d / f"out{r}.pkl").read_bytes())
            for r in range(WORLD)]


def _close(a, b, **tol):
    assert len(a) == len(b)
    for i, (u, v) in enumerate(zip(a, b)):
        np.testing.assert_allclose(u, v, err_msg=f"leaf {i}", **tol)


def _bitwise(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert np.array_equal(u, v)


# --------------------------------------------------------------------- #
def test_ranks_stay_jax_free_and_replicas_in_sync(ranks):
    r0, r1 = ranks
    assert r0["jax_free"] and r1["jax_free"]
    runs = [k for k, v in r0.items() if isinstance(v, dict) and "weights" in v]
    assert len(runs) == 15
    for k in runs:
        _bitwise(r0[k]["weights"], r1[k]["weights"])
        assert r0[k]["losses"] == r1[k]["losses"], k


def test_dp_matches_the_reference(ranks):
    lj, wj = ref_run()
    port = ranks[0]["dp"]
    assert len(port["losses"]) == len(lj) == 12
    np.testing.assert_allclose(port["losses"], lj, **REF_TOL)
    _close(port["weights"], wj, **REF_TOL)


def test_dp_matches_the_local_optimizer(ranks):
    r0 = ranks[0]
    np.testing.assert_allclose(r0["dp"]["losses"], r0["local"]["losses"],
                               **REF_TOL)
    _close(r0["dp"]["weights"], r0["local"]["weights"], **REF_TOL)


def test_fsdp_matches_dp_bitwise(ranks):
    r0 = ranks[0]
    _bitwise(r0["fsdp_momentum"]["weights"], r0["dp_momentum"]["weights"])
    assert r0["fsdp_momentum"]["losses"] == r0["dp_momentum"]["losses"]
    assert r0["fsdp_momentum"]["gauges"]["collective/reduce_scatter_bytes"] \
        > 0


@pytest.mark.parametrize("run,dp", [("zero1", "dp"),
                                    ("zero1_momentum", "dp_momentum")],
                         ids=["sgd", "sgd-momentum"])
def test_zero1_sgd_bitwise_to_dp(ranks, run, dp):
    r0 = ranks[0]
    _bitwise(r0[run]["weights"], r0[dp]["weights"])
    assert r0[run]["losses"] == r0[dp]["losses"]
    assert r0[run]["layout"] == ("zero1: 2 dim0-sharded leaves, 2 "
                                 "flat-bucketed leaves in 1 bucket over n=2")


def test_zero1_adam_within_1e6(ranks):
    r0 = ranks[0]
    _close(r0["zero1_adam"]["weights"], r0["dp_adam"]["weights"], **ADAM_TOL)


@pytest.mark.parametrize("run,mono", [("dp_momentum_buckets", "dp_momentum"),
                                      ("dp_fp16_buckets", "dp_fp16")],
                         ids=["fp32", "fp16-wire"])
def test_bucketed_matches_monolithic_bitwise(ranks, run, mono):
    r0 = ranks[0]
    _bitwise(r0[run]["weights"], r0[mono]["weights"])
    assert r0[run]["losses"] == r0[mono]["losses"]
    assert r0[run]["gauges"]["collective/buckets"] == 3


@pytest.mark.parametrize("compress", ["bf16", "fp16"])
def test_16bit_wire_against_the_reference(ranks, compress):
    lj, wj = ref_run(compress=compress)
    port = ranks[0][f"dp_{compress}"]
    np.testing.assert_allclose(port["losses"], lj, **WIRE_TOL)
    _close(port["weights"], wj, **WIRE_TOL)
    # the limit tells the 16-bit wire from the fp32 one
    fp32 = ranks[0]["dp"]["weights"]
    assert not all(np.allclose(a, b, **WIRE_TOL) for a, b in zip(fp32, wj))


@pytest.mark.parametrize("run,op", [("dp_fp16", "allreduce"),
                                    ("dp_fp16_buckets", "allreduce"),
                                    ("zero1_fp16", "reduce_scatter")])
def test_fp16_wire_bytes_exactly_half(ranks, run, op):
    g = ranks[0][run]["gauges"]
    raw, wire = g[f"collective/{op}_bytes"], g[f"collective/{op}_wire_bytes"]
    assert raw > 0 and wire * 2 == raw
    assert g["comm/group.dp.wire_bytes_per_step"] == \
        g["collective/wire_bytes_per_step"]


@pytest.mark.parametrize("run,method", [
    ("zero1_momentum", lambda: JSGDm(learning_rate=0.05, momentum=0.9)),
    ("zero1", lambda: JSGDm(learning_rate=0.05))], ids=["momentum", "sgd"])
def test_zero1_opt_state_at_one_over_n(ranks, run, method):
    """Each rank's optimizer state against the reference's accounting of
    its global shard space over 2."""
    jm = make_ref_model()
    params = jm._params
    lay = JZero1(params, WORLD)
    ref = lay.opt_state_bytes_per_replica(
        method().init_state(lay.global_shard_space(params)))
    assert ranks[0][run]["opt_state_bytes"] == ranks[1][run][
        "opt_state_bytes"] == ref


def test_refusals(ranks):
    ref = ranks[0]["refusals"]
    assert "zero1 cannot shard LARS" in ref["lars_zero1"]
    assert "mutually exclusive" in ref["zero1_fsdp"]
    # clipping and accumulation are ported under zero1 and fsdp too
    setters = [k for k in ref if k.startswith("set_")]
    assert len(setters) == 4
    for k in setters:
        assert ref[k] is None, (k, ref[k])


def test_prefetch_under_dp_is_bitwise(ranks):
    r0 = ranks[0]
    _bitwise(r0["dp_momentum_prefetch"]["weights"],
             r0["dp_momentum"]["weights"])
    assert r0["dp_momentum_prefetch"]["counters"]["dataloader/batches"] == 12


def test_validation_under_dp_matches_numpy(ranks):
    """The score after 2 epochs (the last validation) against the MSE of
    the final weights in numpy, in the same 32-row batches."""
    res = ranks[0]["dp_validation"]
    w1, b1, w2, b2 = res["weights"]
    x, y = make_data()
    x, y = x[:100], y[:100]
    total = 0.0
    for i in range(0, 100, 32):
        xb, yb = x[i:i + 32], y[i:i + 32]
        out = np.tanh(xb @ w1.T + b1) @ w2.T + b2
        total += float(np.mean((out - yb) ** 2, dtype=np.float32)) * len(xb)
    assert res["validation"][0][1] == 100
    np.testing.assert_allclose(res["score"], total / 100, rtol=1e-6)


# --------------------------------------------------------------------- #
# plans, without ranks                                                  #
# --------------------------------------------------------------------- #
def _resnet8_pair():
    jm = JR.build(class_num=10, depth=8, dataset="cifar10", format="NHWC")
    params, _ = jm.init_params(0)
    tm = TR.build(class_num=10, depth=8, dataset="cifar10", format="NHWC",
                  device="cpu")
    return params, tm.param_dict()


def test_leaf_order_is_the_references():
    jp, tp = _resnet8_pair()
    assert [tuple(a.shape) for a in jax.tree_util.tree_leaves(jp)] == \
        [tuple(t.shape) for t in tree_leaves(tp)]


@pytest.mark.parametrize("bucket_bytes", [4096, 1 << 16])
def test_bucket_and_zero1_plans_are_the_references(bucket_bytes):
    jp, tp = _resnet8_pair()
    jb, tb = JBucketer(jp, bucket_bytes), GradBucketer(tp, bucket_bytes)
    assert jb.buckets == tb.buckets and len(tb) > 1
    jz, tz = JZero1(jp, 4, bucket_bytes), Zero1Layout(tp, 4, bucket_bytes)
    assert jz.sharded_idx == tz.sharded_idx
    assert [(b[1], b[2], b[3]) for b in jz.buckets] == \
        [(b[1], b[2], b[3]) for b in tz.buckets]


def test_bucket_pack_unpack_roundtrip():
    _, tp = _resnet8_pair()
    tb = GradBucketer(tp, 4096)
    back = tb.unpack(tb.pack(tp))
    for a, b in zip(tree_leaves(back), tree_leaves(tp)):
        assert torch.equal(a, b)


def test_mesh_needs_a_started_group():
    assert not torch.distributed.is_initialized()
    tmesh.set_mesh(None)
    for fn in (tmesh.get_mesh, lambda: tmesh.create_mesh({"dp": 2})):
        with pytest.raises(RuntimeError, match="init_distributed"):
            fn()
    assert not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmesh.init_distributed("file:///nonexistent", 0, 1)
