"""The rest of TransformerLM training in the port, held against the
reference on the CPU: the chunked loss, remat, dropout at given draws,
``SpmdTrainer``'s step features (``loss_chunk``, ``grad_accum``, frozen
modules, ``seed``, the input transform), ``evaluate``, telemetry, health
and the trace context.

Weights are drawn by ``bigdl_tpu`` and cross through numpy
(``from_jax_params``).  The small config (head dim 16) keeps the
reference on its blockwise attention; the narrow one (head dim 128) runs
its Pallas kernels in interpret mode.  Tolerances, fp32 on both sides:
losses 1e-6 relative where only the order of a sum differs (a chunked
sum, a token-weighted mean), 1e-5 through a trainer step; gradients 1e-5
relative with an absolute floor of 1e-6, 1e-5 of their largest entries
(~1e-1): XLA-CPU and ATen-CPU sum in other orders, and an entry that
cancels to ~1e-2 keeps the absolute error of the sum.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu.models import transformer as JT
from bigdl_tpu.ops import flash_attention_mod as jfa
from bigdl_tpu.optim.optim_method import SGD as JSGD
from bigdl_tpu.parallel.mesh import create_mesh
from bigdl_tpu.parallel.spmd import SpmdTrainer as JSpmdTrainer
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.models.convert import from_jax_params
from bigdl_tpu_torch.nn.containers import Remat
from bigdl_tpu_torch.nn.module import Ctx
from bigdl_tpu_torch.observability import (DivergenceError, InMemorySink,
                                           Recorder, TraceContext, Tracer)
from bigdl_tpu_torch.optim import SGD, AdamW
from bigdl_tpu_torch.parallel import SpmdTrainer
from bigdl_tpu_torch.parallel.spmd import _step_generator

SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_len=64)
NARROW = dict(vocab_size=512, d_model=256, n_heads=2, n_layers=2, d_ff=512,
              max_len=256)
B, S = 2, 40
SUM_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return {k: {kk: np.array(vv) for kk, vv in sub.items()}
            for k, sub in tree.items()}


def _pair(seed=5, **kw):
    """(reference model, its numpy params, the port model on them)."""
    cfg = {**SMALL, **kw}
    jm = JT.build("tiny", **cfg)
    jparams, _ = jm.init_params(seed=seed)
    np_params = _np(jparams)
    tm = TT.build("tiny", device="cpu", **cfg)
    from_jax_params(np_params, tm)
    return jm, np_params, tm


def _batch(seed, vocab=SMALL["vocab_size"], b=B, s=S, holes=True):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, s + 1)).astype(np.int32)
    tokens, targets = ids[:, :-1], ids[:, 1:].copy()
    if holes:       # ignore_index across chunk boundaries
        targets[0, 3] = targets[1, 15] = targets[1, 16] = -1
    return tokens, targets


def _suffix(tree):
    return {k[k.index("."):]: v for k, v in tree.items()}


def _port_grads(tm, fn):
    params = tm.param_dict()
    leaves = [p for sub in params.values() for p in sub.values()]
    out = fn(params)
    grads = torch.autograd.grad(out, leaves)
    it = iter(grads)
    return out.detach(), {n: {k: next(it) for k in sub}
                          for n, sub in params.items()}


def _assert_grads(got, want, tol=GRAD_TOL):
    want = _suffix(want)
    for name, sub in got.items():
        for k, g in sub.items():
            np.testing.assert_allclose(
                g.numpy(), np.asarray(want[name[name.index("."):]][k]),
                **tol, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("chunk", [8, 16, 24, 64])
def test_chunked_nll_matches_the_reference_and_the_full_loss(tie, chunk):
    """chunk 8 divides S=40; 16 and 24 leave a ragged tail (padded with
    ignore_index); 64 > S is clamped to one chunk."""
    jm, np_params, tm = _pair(tie_embeddings=tie)
    tokens, targets = _batch(1)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    want = jm.token_nll(jparams, jnp.asarray(tokens), jnp.asarray(targets),
                        loss_chunk=chunk)
    t, y = torch.from_numpy(tokens), torch.from_numpy(targets)
    params = tm.param_dict()
    got = tm.token_nll(params, t, y, loss_chunk=chunk)
    full = tm.token_nll(params, t, y)
    for a, b, c in zip(got, want, full):
        a = a.detach()
        np.testing.assert_allclose(float(a), float(b), **SUM_TOL)
        np.testing.assert_allclose(float(a), float(c), **SUM_TOL)
    assert float(got[1]) == (targets != -1).sum()
    # gradients: chunked = full in the port, and = the reference's chunked
    _, g_chunk = _port_grads(tm, lambda p: tm.loss(p, t, y,
                                                   loss_chunk=chunk))
    _, g_full = _port_grads(tm, lambda p: tm.loss(p, t, y))
    for name, sub in g_full.items():
        for k, g in sub.items():
            torch.testing.assert_close(g_chunk[name][k], g, **GRAD_TOL)
    want_g = jax.grad(lambda p: jm.loss(p, jnp.asarray(tokens),
                                        jnp.asarray(targets),
                                        loss_chunk=chunk))(jparams)
    _assert_grads(g_chunk, want_g)


def test_chunked_nll_keeps_at_most_a_chunk_of_logits():
    """Each chunk's head runs under checkpoint: the backward recomputes
    it, so the forward saves no (B, chunk, V) logits."""
    _, _, tm = _pair()
    calls = []
    head = tm.head.apply

    def counting(params, x, ctx):
        calls.append(tuple(x.shape))
        return head(params, x, ctx)
    tm.head.apply = counting
    t, y = (torch.from_numpy(a) for a in _batch(2))
    loss = tm.loss(tm.param_dict(), t, y, loss_chunk=16)
    assert calls == [(B, 16, SMALL["d_model"])] * 3      # 40 -> 3 chunks
    loss.backward()
    assert len(calls) == 6                                # each recomputed


def test_remat_is_bitwise_in_the_port_and_matches_the_reference():
    jm, np_params, tm = _pair()
    jr = JT.build("tiny", **SMALL, remat=True)
    tr = TT.build("tiny", device="cpu", **SMALL, remat=True)
    from_jax_params(np_params, tr)
    tokens, targets = _batch(3)
    t, y = torch.from_numpy(tokens), torch.from_numpy(targets)
    loss_p, g_p = _port_grads(tm, lambda p: tm.loss(p, t, y,
                                                    training=True))
    loss_r, g_r = _port_grads(tr, lambda p: tr.loss(p, t, y,
                                                    training=True))
    assert torch.equal(loss_p, loss_r)
    for (name, sub), sub_r in zip(g_p.items(), g_r.values()):
        for k, g in sub.items():
            assert torch.equal(g, sub_r[k]), f"{name}.{k}"
    # the wrappers are made lazily and not registered: no name shifted,
    # no parameter listed twice
    assert [b.name for b in tr.blocks] == [f"{tr.name}.block{i}"
                                          for i in range(2)]
    assert len(tr._remat_blocks) == 2
    assert not any(isinstance(m, Remat) for m in tr.modules())
    assert len(list(tr.parameters())) == len(list(tm.parameters()))
    jparams = {jr.name + k[len(jm.name):]: jax.tree_util.tree_map(
        jnp.asarray, v) for k, v in np_params.items()}
    want, want_g = jax.value_and_grad(lambda p: jr.loss(
        p, jnp.asarray(tokens), jnp.asarray(targets), training=True))(
            jparams)
    np.testing.assert_allclose(float(loss_r), float(want), rtol=1e-5)
    _assert_grads(g_r, want_g, dict(rtol=1e-5, atol=1e-5))


def _ref_block_masks(jm, tm, key, shape, rate):
    """The reference's keep mask of each block under ``key`` (one per
    block: ``_drop`` draws both sublayers from ``ctx.rng(block)``), keyed
    by the port block's name."""
    return {tb.name: np.array(jax.random.bernoulli(
        jax.random.fold_in(key, jb._uid % (2 ** 31)), 1.0 - rate, shape))
        for jb, tb in zip(jm.blocks, tm.blocks)}


@pytest.mark.parametrize("remat", [False, True])
def test_dropout_at_the_reference_draws(remat):
    rate = 0.25
    jm, np_params, tm = _pair(dropout=rate, remat=remat)
    tokens, targets = _batch(4)
    key = jax.random.PRNGKey(7)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    want, want_g = jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(tokens), jnp.asarray(targets), training=True,
        rng=key))(jparams)
    draws = _ref_block_masks(jm, tm, key, (B, S, SMALL["d_model"]), rate)
    t, y = torch.from_numpy(tokens), torch.from_numpy(targets)
    got, got_g = _port_grads(tm, lambda p: tm.loss(
        p, t, y, ctx=Ctx(training=True, draws=draws)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    _assert_grads(got_g, want_g)
    # dropout changes the loss, and inference ignores it
    with torch.no_grad():
        plain = tm.loss(tm.param_dict(), t, y)
    assert abs(float(got) - float(plain)) > 1e-4
    np.testing.assert_allclose(float(plain), float(jm.loss(
        jparams, jnp.asarray(tokens), jnp.asarray(targets))), rtol=1e-6)


def test_dropout_draws_from_the_generator_and_keeps_the_rate():
    _, _, tm = _pair(dropout=0.25)
    blk = tm.blocks[0]
    x = torch.ones(4, 256, SMALL["d_model"])
    ctx = Ctx(training=True, generator=torch.Generator().manual_seed(1))
    mask = blk._keep_mask(x, ctx)
    assert abs(1.0 - float(mask.float().mean()) - 0.25) < 0.01
    y = blk._drop(x, mask)
    assert torch.equal(y[mask], torch.full_like(y[mask], 1 / 0.75))
    assert torch.equal(y[~mask], torch.zeros_like(y[~mask]))
    assert blk._keep_mask(x, Ctx(training=False)) is None


def test_long8k_builds_and_moe_still_raises():
    """long8k's flags (remat, ring attention on one device, bf16) build;
    one block at a small vocab keeps the draw small here.  An MoE model
    (``moe_experts``) builds and runs, its aux loss in the side losses."""
    m = TT.build("long8k", device="cpu", n_layers=1, vocab_size=64)
    assert m.cfg.remat and m.cfg.use_ring_attention
    assert m.cfg.dtype == "bfloat16" and m.cfg.max_len == 8192
    tok = torch.randint(0, 64, (1, 16))
    with torch.no_grad():
        out = m.apply(m.param_dict(), tok, Ctx())
    assert out.shape == (1, 16, 64) and out.dtype == torch.float32
    moe = TT.build("tiny", device="cpu", n_layers=1, moe_experts=4,
                   moe_top_k=2)
    assert sorted(moe.param_dict()[moe.blocks[0].name + ".moe"]) == \
        ["router", "w1", "w2", "w3"]
    ctx = Ctx(training=True)
    with torch.no_grad():
        out = moe.apply(moe.param_dict(), tok % 64, ctx)
    assert out.shape == (1, 16, 256) and torch.isfinite(out).all()
    assert len(ctx.side_losses) == 1 and float(ctx.side_losses[0]) > 0


# --------------------------------------------------------------------- #
# SpmdTrainer against the reference's                                    #
# --------------------------------------------------------------------- #
@pytest.fixture
def interpret_mode():
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = old


def _ref_trainer(jm, **kw):
    return JSpmdTrainer(jm, JSGD(learning_rate=0.1),
                        mesh=create_mesh({"dp": 1},
                                         devices=jax.devices()[:1]),
                        fsdp=False, **kw).init()


def _compare_params(tm, jparams):
    final = _suffix(_np(jparams))
    for name, sub in tm.param_dict().items():
        for k, p in sub.items():
            np.testing.assert_allclose(
                p.detach().numpy(), final[name[name.index("."):]][k],
                **PARAM_TOL, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("kw", [dict(loss_chunk=16),
                                dict(loss_chunk=16, grad_accum=2),
                                dict(loss_chunk=8, remat=True)])
def test_trainer_step_features_match_the_reference(kw):
    """As tests/test_loss_chunking.py holds the reference's trainer with
    ``loss_chunk`` and ``grad_accum``: three SGD steps, each loss and
    the final weights."""
    remat = kw.pop("remat", False)
    jm = JT.build("tiny", **SMALL, remat=remat)
    jt = _ref_trainer(jm, **kw)
    tm = TT.build("tiny", device="cpu", **SMALL, remat=remat)
    from_jax_params(_np(jt.params), tm)
    tt = SpmdTrainer(tm, SGD(learning_rate=0.1), device="cpu", **kw)
    batches = [_batch(10 + i, b=4) for i in range(3)]
    want = [float(jt.step(*b)) for b in batches]
    got = tt.fit(batches)
    np.testing.assert_allclose(got, want, **STEP_TOL)
    _compare_params(tm, jt.params)


def test_trainer_chunked_step_at_head_dim_128(interpret_mode):
    """The narrow model (the reference's Pallas kernels in interpret
    mode): one chunked step of each package."""
    jm = JT.build("tiny", **NARROW)
    jt = _ref_trainer(jm, loss_chunk=32)
    tm = TT.build("tiny", device="cpu", **NARROW)
    from_jax_params(_np(jt.params), tm)
    tt = SpmdTrainer(tm, SGD(learning_rate=0.1), device="cpu",
                     loss_chunk=32)
    batch = _batch(20, vocab=NARROW["vocab_size"], s=128)
    np.testing.assert_allclose(float(tt.step(*batch)),
                               float(jt.step(*batch)), **STEP_TOL)
    _compare_params(tm, jt.params)


def test_evaluate_matches_the_reference():
    jm = JT.build("tiny", **SMALL)
    jt = _ref_trainer(jm, loss_chunk=16)
    tm = TT.build("tiny", device="cpu", **SMALL)
    from_jax_params(_np(jt.params), tm)
    tt = SpmdTrainer(tm, SGD(learning_rate=0.1), device="cpu",
                     loss_chunk=16)
    batches = [_batch(30 + i) for i in range(3)]
    want = jt.evaluate(iter(batches))
    got = tt.evaluate(iter(batches))
    assert got["tokens"] == want["tokens"] == 3 * (B * S - 3)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                               rtol=1e-6)
    assert got["perplexity"] == math.exp(got["loss"])
    # steps= takes no batch past its count from a shared iterator
    it = iter(batches)
    tt.evaluate(it, steps=2)
    assert next(it) is batches[2]
    with pytest.raises(ValueError, match="no valid tokens"):
        tt.evaluate([(batches[0][0], np.full((B, S), -1, np.int32))])


@pytest.mark.parametrize("method", ["sgd", "adamw"])
def test_a_frozen_module_stays_bitwise_through_a_step(method):
    """≙ tests/test_freeze.py's ``test_freeze_on_spmd_trainer``: the
    step zeroes a frozen module's gradients before the update.  AdamW
    without weight decay (with it, both packages decay frozen weights:
    the decay is not a gradient)."""
    tm = TT.build("tiny", device="cpu", seed=0)
    tm.freeze([tm.embed.name])
    opt = SGD(learning_rate=0.1) if method == "sgd" else \
        AdamW(learning_rate=0.1, weight_decay=0.0)
    tr = SpmdTrainer(tm, opt, device="cpu")
    w0 = tm.embed.weight.detach().clone()
    h0 = tm.head.weight.detach().clone()
    rs = np.random.RandomState(0)
    tok = rs.randint(0, 256, (8, 33))
    tr.step(tok[:, :-1], tok[:, 1:])
    tr.step(tok[:, 1:], tok[:, :-1])
    assert torch.equal(tr.params[tm.embed.name]["weight"], w0)
    assert not torch.equal(tm.head.weight, h0)


def _dropout_trainer(seed):
    tm = TT.build("tiny", device="cpu", seed=0, dropout=0.1, remat=True)
    return SpmdTrainer(tm, AdamW(learning_rate=1e-3), device="cpu",
                       seed=seed, loss_chunk=32)


def test_seed_folds_the_step_into_the_draws():
    batches = [_batch(40 + i, vocab=256, s=64) for i in range(3)]
    a = _dropout_trainer(3).fit(batches)
    b = _dropout_trainer(3).fit(batches)
    c = _dropout_trainer(4).fit(batches)
    assert a == b
    assert all(x != y for x, y in zip(a, c))
    g1 = _step_generator("cpu", 3, 1)
    assert torch.equal(torch.rand(4, generator=g1),
                       torch.rand(4, generator=_step_generator("cpu", 3, 1)))
    assert not torch.equal(torch.rand(4, generator=_step_generator(
        "cpu", 3, 2)), torch.rand(4, generator=_step_generator("cpu", 3, 1)))


def test_input_transform_runs_in_the_step_with_the_step_generator():
    seen = []

    def shift(tokens, gen):
        off = torch.randint(0, 256, (), generator=gen)
        seen.append(int(off))
        return (tokens + off) % 256

    tr = _dropout_trainer(5).set_input_transform(shift)
    tr.fit([_batch(50 + i, vocab=256, s=64) for i in range(2)])
    want = [int(torch.randint(0, 256, (), generator=_step_generator(
        "cpu", 5, i))) for i in range(2)]
    assert seen == want
    assert tr.set_input_transform(None)._input_transform is None


def test_telemetry_records_a_step_with_its_health_scalars():
    sink = InMemorySink()
    tm = TT.build("tiny", device="cpu", seed=0)
    tracer = Tracer()
    root = TraceContext.new_root()
    tr = (SpmdTrainer(tm, AdamW(learning_rate=1e-3), device="cpu")
          .set_telemetry(Recorder(sinks=[sink]))
          .set_trace_context(root, tracer=tracer))
    losses = tr.fit([_batch(60 + i, vocab=256, s=32) for i in range(3)])
    steps = [r for r in sink.records if r["type"] == "step"]
    assert [r["step"] for r in steps] == [0, 1, 2]
    for r, loss in zip(steps, losses):
        sc = r["scalars"]
        assert sc["loss"] == loss
        assert sc["records"] == B * 32
        for k in ("grad_norm", "param_norm", "update_norm", "update_ratio"):
            assert np.isfinite(sc[k]) and sc[k] > 0
        assert sc["nonfinite_grads"] == 0
        assert {"h2d", "train_step"} <= set(r["spans"])
    assert steps[-1]["counters"]["tokens_total"] == 3 * B * 32
    spans = [s for s in tracer.store.spans() if s.name == "train.step"]
    assert len(spans) == 3
    assert {s.context.trace_id for s in spans} == {root.trace_id}
    assert tr.straggler_report() is None      # one process: no hosts


def test_health_raises_on_a_nan_step():
    tm = TT.build("tiny", device="cpu", seed=0)
    tr = SpmdTrainer(tm, AdamW(learning_rate=1e-3), device="cpu") \
        .set_health(policy="raise", install_crash_hooks=False)
    tok, tgt = _batch(70, vocab=256, s=32)
    tr.step(tok, tgt)
    bad = tok.copy()
    bad[0, 0] = 10 ** 6           # out of range: a NaN embedding row
    with pytest.raises(DivergenceError):
        tr.fit([(bad, tgt)])


def _serves_metrics(tr):
    """``serve_metrics`` (ported since): /metrics and /healthz answer, the
    step records reach /records, ``stop_metrics`` leaves no thread."""
    import json
    import threading
    import urllib.request
    before = set(threading.enumerate())
    srv = tr.serve_metrics()
    try:
        tr.step(*_batch(3))
        got = {}
        for path in ("/metrics", "/healthz", "/records?type=step"):
            with urllib.request.urlopen(srv.url(path), timeout=30) as r:
                got[path] = (r.status, r.read().decode())
    finally:
        tr.stop_metrics()
    assert all(code == 200 for code, _ in got.values())
    assert "bigdl_tokens_total" in got["/metrics"][1]
    assert [r["step"] for r in json.loads(got["/records?type=step"][1])] \
        == [0]
    assert not [t for t in set(threading.enumerate()) - before
                if t.name.startswith(("introspection:", "health-watchdog"))]


def _accounts_collectives(tr):
    """``account_collectives`` (ported since): on one device no collective
    runs, and the accounting step changes nothing."""
    before = [t.clone() for t in tr.model.get_weights()]
    got = tr.account_collectives(*_batch(3))
    assert got["ops"] == {} and got["wire_bytes_per_step"] == 0.0
    assert tr._step_count == 0
    assert all(torch.equal(a, b)
               for a, b in zip(before, tr.model.get_weights()))


@pytest.mark.parametrize("call", [
    lambda tr: tr.set_checkpoint("/nonexistent", layout="orbax"),
    lambda tr: tr.save_checkpoint("/nonexistent", layout="orbax"),
    lambda tr: tr.set_checkpoint("/nonexistent", layout="tensorstore"),
    _serves_metrics, _accounts_collectives],
    ids=[f"<lambda>{i}" for i in range(5)])     # the ids it always had
def test_unported_features_raise_and_name_their_item(call):
    """The orbax layouts (ROADMAP queue A, item 7) raise and name their
    item; ``serve_metrics`` and ``account_collectives`` are ported and are
    driven instead."""
    if call in (_serves_metrics, _accounts_collectives):
        model = TT.build("tiny", device="cpu", seed=0, **SMALL)
        call(SpmdTrainer(model, AdamW(), device="cpu"))
        return
    tr = SpmdTrainer(None, AdamW(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue A, item"):
        call(tr)
