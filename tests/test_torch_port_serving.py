"""The port's serving slice held against the reference on the CPU.

A narrow TransformerLM (d_model 256, 2 heads of 128, 2 layers, d_ff 512,
vocab 512, S=128) is built in ``bigdl_tpu`` and initialised there; its
weights go through numpy into ``bigdl_tpu_torch`` (``from_jax_params``).
The reference runs its Pallas flash kernel in interpret mode, the port
its plain attention.  Then the port's ServingEngine, on ``device="cpu"``,
serves mixed request sizes against the reference's logits.
"""
import ast
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu.models import transformer as JT
from bigdl_tpu.ops import flash_attention_mod as jfa
from bigdl_tpu_torch import resolve_device
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.models.convert import from_jax_params
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.serving import (EngineClosedError, LoadShedError,
                                     ModelRegistry, ServingEngine)

REPO = Path(__file__).resolve().parents[1]
NARROW = dict(vocab_size=512, d_model=256, n_heads=2, n_layers=2, d_ff=512,
              max_len=256)
S = 128
# fp32 on both sides; XLA-CPU and ATen-CPU sum the matmuls and the
# attention in different orders, and the difference grows through two
# blocks and the vocab head (logits are O(1))
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def narrow():
    """(reference model, numpy params, port model on cpu)."""
    jm = JT.build("tiny", **NARROW)
    jparams, _ = jm.init_params(seed=3)
    np_params = {k: {kk: np.asarray(vv) for kk, vv in sub.items()}
                 for k, sub in jparams.items()}
    tm = TT.build("tiny", device="cpu", seed=0, **NARROW)
    from_jax_params(np_params, tm)
    return jm, jparams, tm


def _jax_logits(jm, jparams, tokens):
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    try:
        y, _ = jm.run(jparams, jnp.asarray(tokens))
    finally:
        jfa._INTERPRET = old
    return np.asarray(y)


def _tokens(n, seed):
    return np.random.RandomState(seed).randint(
        0, NARROW["vocab_size"], (n, S)).astype(np.int32)


# --------------------------------------------------------------------- #
# model                                                                 #
# --------------------------------------------------------------------- #
def test_model_logits_match_reference(narrow):
    jm, jparams, tm = narrow
    x = _tokens(2, 0)
    want = _jax_logits(jm, jparams, x)
    with torch.inference_mode():
        got, _ = tm.run(tm.param_dict(), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, S, 512)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_rope_is_the_interleaved_form():
    x = np.random.RandomState(1).randn(1, 2, 9, 64).astype(np.float32)
    want = JT.apply_rope(jnp.asarray(x), jnp.arange(9))
    got = TT.apply_rope(torch.from_numpy(x), torch.arange(9))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_embedding_out_of_range_ids_match_jnp_take():
    v, d = 4, 8
    w = np.random.RandomState(2).randn(v, d).astype(np.float32)
    ids = np.array([[0, 4, -1, 3, 9, -4, -5]], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(w), jnp.asarray(ids), axis=0))
    emb = TT.TokenEmbedding(v, d, torch.Generator().manual_seed(0))
    got = emb.apply({emb.name: {"weight": torch.from_numpy(w)}},
                    torch.from_numpy(ids), None).numpy()
    # id >= V gives a NaN row, a negative id wraps once
    assert np.isnan(got[0, 1]).all() and np.isnan(got[0, 4]).all()
    np.testing.assert_array_equal(got[0, 2], w[3])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))


def test_from_jax_params_refuses_missing_extra_and_misshaped(narrow):
    _, jparams, tm = narrow
    np_params = {k: {kk: np.asarray(vv) for kk, vv in sub.items()}
                 for k, sub in jparams.items()}
    head = next(k for k in np_params if k.endswith(".head"))
    missing = {k: v for k, v in np_params.items() if k != head}
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(missing, tm)
    extra = dict(np_params, **{"Root.block9.attn": np_params[head]})
    with pytest.raises(ValueError, match="left over"):
        from_jax_params(extra, tm)
    bad = dict(np_params, **{head: {"weight": np.zeros((3, 3), np.float32)}})
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(bad, tm)


def test_unported_options_raise():
    # long8k's remat and ring-attention flag build on one device (its full
    # depth and vocab are the card's: a short, narrow-vocab one here); an
    # MoE model builds and serves (its forward routes the batch's tokens)
    m = TT.build("long8k", device="cpu", n_layers=1, vocab_size=64)
    assert m.cfg.remat and m.cfg.use_ring_attention
    moe = TT.build("tiny", device="cpu", moe_experts=2)
    reg = ModelRegistry()
    reg.register("moe", moe, input_shape=(S,), dtype=np.int32)
    eng = ServingEngine(reg, max_batch=2, max_delay_ms=2.0).warmup()
    try:
        x = np.random.RandomState(0).randint(0, 256, (2, S)).astype(np.int32)
        out = np.asarray(eng.predict("moe", x))
    finally:
        eng.shutdown()
    assert out.shape == (2, S, 256) and np.isfinite(out).all()


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.build("tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


# --------------------------------------------------------------------- #
# serving                                                               #
# --------------------------------------------------------------------- #
def test_engine_serves_mixed_sizes_with_reference_logits(narrow):
    jm, jparams, tm = narrow
    reg = ModelRegistry()
    entry = reg.register("lm", tm, input_shape=(S,), dtype=np.int32)
    assert entry.device.type == "cpu"
    eng = ServingEngine(reg, max_batch=4, max_delay_ms=2.0).warmup()
    try:
        assert eng.stats()["warmup_compiles"] == 3
        sizes = [1, 3, 2, 4, 1]
        xs = [_tokens(n, 10 + i) for i, n in enumerate(sizes)]
        want = _jax_logits(jm, jparams, np.concatenate(xs))
        futs = [eng.submit("lm", x) for x in xs]
        single = eng.submit("lm", xs[0][0])
        off = 0
        for x, f in zip(xs, futs):
            y = f.result(timeout=60)
            assert y.shape == (len(x), S, 512)
            np.testing.assert_allclose(y, want[off:off + len(x)],
                                       **LOGIT_TOL)
            off += len(x)
        np.testing.assert_allclose(single.result(timeout=60), want[0],
                                   **LOGIT_TOL)
        st = eng.stats()
        assert st["recompiles"] == 0 and st["errors"] == 0
        assert st["rows"] == sum(sizes) + 1 and st["batches"] >= 2
        assert '"bucket"' in eng.dump_chrome_trace()
    finally:
        eng.shutdown(drain=True)


class Scale(Module):
    """y = weight * x with a single scalar weight."""

    def __init__(self):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.ones(()))

    def apply(self, params, x, ctx):
        return x * params[self.name]["weight"]


def _scale_engine(**kw):
    reg = ModelRegistry()
    reg.register("m", Scale(), input_shape=(4,))
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_ms", 1.0)
    return reg, ServingEngine(reg, **kw)


def test_unwarmed_bucket_counts_as_recompile():
    reg, eng = _scale_engine()
    try:
        y = eng.submit("m", np.ones((3, 4), np.float32)).result(30)
        assert y.shape == (3, 4)
        assert eng.recorder.counter_value("serving.recompiles") == 1
        eng.submit("m", np.ones((4, 4), np.float32)).result(30)
        assert eng.recorder.counter_value("serving.recompiles") == 1
        big = eng.predict("m", np.full((9, 4), 2.0, np.float32), timeout=30)
        assert big.shape == (9, 4) and np.all(big == 2.0)
    finally:
        eng.shutdown(drain=True)


def test_queue_full_sheds_at_the_door():
    reg, eng = _scale_engine(max_queue_rows=8)
    gate = threading.Event()
    orig = eng._run_batch

    def gated(entry, q, batch):
        gate.wait(30)
        orig(entry, q, batch)

    eng._run_batch = gated
    try:
        eng.warmup()
        blocker = eng.submit("m", np.ones((4, 4), np.float32))
        deadline = time.monotonic() + 10
        while eng._queues["m"].depth() > 0:     # worker popped it
            assert time.monotonic() < deadline
            time.sleep(0.001)
        shed, futs = 0, [blocker]
        for _ in range(4):
            try:
                futs.append(eng.submit("m", np.ones((4, 4), np.float32)))
            except LoadShedError as e:
                assert e.reason == "queue_full"
                shed += 1
        assert shed == 2    # 8 rows admitted, the last two 4-row shed
        assert eng.stats()["shed_queue_full"] == shed
        gate.set()
        for f in futs:
            f.result(timeout=30)
    finally:
        gate.set()
        eng.shutdown(drain=True)


def test_expired_deadline_is_shed_not_executed():
    reg, eng = _scale_engine()
    try:
        eng.warmup()
        f = eng.submit("m", np.ones((2, 4), np.float32), deadline_ms=0.0)
        time.sleep(0.01)
        with pytest.raises(LoadShedError) as ei:
            f.result(timeout=30)
        assert ei.value.reason == "deadline"
        assert eng.stats()["shed_deadline"] >= 1
        assert eng.stats()["batches"] == 0
    finally:
        eng.shutdown(drain=True)
    with pytest.raises(EngineClosedError):
        eng.submit("m", np.ones((1, 4), np.float32))


def test_weight_swap_validates_and_publishes():
    reg, eng = _scale_engine()
    try:
        eng.warmup()
        entry = reg.get("m")
        key = next(iter(entry.snapshot.params))
        old = entry.snapshot
        with pytest.raises(ValueError, match="changed from"):
            reg.swap_weights("m", {key: {"weight": torch.ones((2,))}})
        with pytest.raises(ValueError, match="changed from"):
            reg.swap_weights("m", {key: {"weight": torch.ones(
                (), dtype=torch.float64)}})
        with pytest.raises(ValueError, match="structure"):
            reg.swap_weights("m", {key: {"bias": torch.ones(())}})
        assert entry.snapshot is old            # refused swaps change nothing
        snap = reg.swap_weights("m", {key: {"weight": torch.tensor(3.0)}})
        assert snap.version == "v2" and entry.snapshot is snap
        y = eng.predict("m", np.ones((2, 4), np.float32), timeout=30)
        assert np.all(y == 3.0)
        assert old.params[key]["weight"].item() == 1.0  # old left intact
        assert entry.model.weight.item() == 3.0         # module coherent
        assert eng.stats()["recompiles"] == 0
    finally:
        eng.shutdown(drain=True)


# --------------------------------------------------------------------- #
# isolation from the reference                                          #
# --------------------------------------------------------------------- #
def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys, runpy\n"
        "import bigdl_tpu_torch, bigdl_tpu_torch.serving, "
        "bigdl_tpu_torch.models.transformer, bigdl_tpu_torch.models.convert, "
        "bigdl_tpu_torch.optim, bigdl_tpu_torch.kernels, "
        "bigdl_tpu_torch.parallel, bigdl_tpu_torch.nn, bigdl_tpu_torch.data, "
        "bigdl_tpu_torch.models.resnet, bigdl_tpu_torch.models.lenet, "
        "bigdl_tpu_torch.optim.trigger, bigdl_tpu_torch.optim.optimizer, "
        "bigdl_tpu_torch.serving.decode, bigdl_tpu_torch.serving.kvcache, "
        "bigdl_tpu_torch.quantized, bigdl_tpu_torch.serving.replicas, "
        "bigdl_tpu_torch.serving.stream, bigdl_tpu_torch.serving.arrivals, "
        "bigdl_tpu_torch.faults, bigdl_tpu_torch.utils.retry, "
        "bigdl_tpu_torch.observability.tracing, "
        "bigdl_tpu_torch.observability.goodput, "
        "bigdl_tpu_torch.observability.collectives, "
        "bigdl_tpu_torch.optim.distri_optimizer, "
        "bigdl_tpu_torch.optim.validation, bigdl_tpu_torch.optim.predictor, "
        "bigdl_tpu_torch.parallel.mesh, bigdl_tpu_torch.parallel.allreduce, "
        "bigdl_tpu_torch.parallel.bucketer, bigdl_tpu_torch.parallel.zero, "
        "bigdl_tpu_torch.data.device_loader, bigdl_tpu_torch.data.prefetch, "
        "bigdl_tpu_torch.native, bigdl_tpu_torch.utils.crc32c, "
        "bigdl_tpu_torch.utils.seqfile, bigdl_tpu_torch.data.image, "
        "bigdl_tpu_torch.data.device_augment, bigdl_tpu_torch.data.mnist, "
        "bigdl_tpu_torch.data.cifar, bigdl_tpu_torch.optim.lr_schedule, "
        "bigdl_tpu_torch.optim.regularizer, bigdl_tpu_torch.data.text, "
        "bigdl_tpu_torch.data.news20, bigdl_tpu_torch.serving.registry, "
        "bigdl_tpu_torch.nn.linear, bigdl_tpu_torch.nn.shape_ops, "
        "bigdl_tpu_torch.observability.timeseries, "
        "bigdl_tpu_torch.observability.slo, "
        "bigdl_tpu_torch.observability.aggregate, "
        "bigdl_tpu_torch.observability.regress, bigdl_tpu_torch.fleet, "
        "bigdl_tpu_torch.autoscale, bigdl_tpu_torch.tensor, "
        "bigdl_tpu_torch.embedding, bigdl_tpu_torch.data.movielens, "
        "bigdl_tpu_torch.models.two_tower, bigdl_tpu_torch.nn.sparse\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke_import')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'bigdl_tpu' or m.startswith('bigdl_tpu.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_no_module_of_the_port_imports_jax_or_the_reference():
    files = sorted((REPO / "bigdl_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    names = {str(f.relative_to(REPO)) for f in files}
    for new in ("nn/conv.py", "nn/pooling.py", "nn/containers.py",
                "nn/criterion.py", "models/resnet.py", "models/lenet.py",
                "optim/trigger.py", "data/dataset.py", "data/minibatch.py",
                "serving/decode.py", "serving/kvcache.py",
                "quantized/__init__.py", "serving/replicas.py",
                "serving/stream.py", "serving/arrivals.py",
                "faults/__init__.py", "utils/retry.py",
                "observability/tracing.py", "observability/goodput.py",
                "observability/collectives.py", "optim/distri_optimizer.py",
                "optim/validation.py", "optim/predictor.py",
                "parallel/mesh.py", "parallel/allreduce.py",
                "parallel/bucketer.py", "parallel/zero.py",
                "data/device_loader.py", "data/prefetch.py",
                "native/__init__.py", "utils/crc32c.py", "utils/seqfile.py",
                "data/image.py", "data/device_augment.py", "data/mnist.py",
                "data/cifar.py", "optim/lr_schedule.py",
                "optim/regularizer.py", "data/text.py", "data/news20.py",
                "serving/registry.py", "nn/linear.py", "nn/shape_ops.py",
                "nn/module.py", "_device.py",
                "observability/timeseries.py", "observability/slo.py",
                "observability/aggregate.py", "observability/regress.py",
                "fleet/__init__.py", "fleet/pool.py",
                "autoscale/__init__.py", "autoscale/signals.py",
                "autoscale/policy.py", "autoscale/controller.py",
                "tensor/__init__.py", "tensor/_segment.py",
                "embedding/__init__.py", "embedding/sharded.py",
                "embedding/dedup.py", "embedding/optim.py",
                "embedding/serve.py", "data/movielens.py",
                "models/two_tower.py", "nn/sparse.py"):
        assert f"bigdl_tpu_torch/{new}" in names
    assert len(files) > 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "bigdl_tpu"), (f, n)
