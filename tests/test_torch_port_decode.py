"""The port's continuous-batching ``DecodeEngine`` on the CPU, held against
the reference's ``DecodeEngine`` and against its own contracts.

The load-bearing claims, as in ``tests/test_decode.py``: mixed prompt
lengths run no shape after warmup; concurrent output equals sequential;
eviction and readmission (re-prefill + replay) give bitwise the tokens of
an uncontended run; pool exhaustion backpressures into queue sheds; a
deadline shed finishes its trace before the future fails; poisoned
weights fail loudly and a swap back recovers bitwise.  Greedy tokens
agree with the reference engine's on the same weights, except where the
reference's own top two logits are closer than two logit tolerances.
"""
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu.models import transformer as JT
from bigdl_tpu.serving import DecodeEngine as JDecodeEngine
from bigdl_tpu.serving import ModelRegistry as JModelRegistry
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.models.convert import from_jax_params
from bigdl_tpu_torch.serving import (DecodeEngine, EngineClosedError,
                                     LoadShedError, ModelRegistry)
from bigdl_tpu_torch.serving import decode as decode_mod

TINY = dict(n_layers=2, max_len=128)
V = 256
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN_TOL = 2 * LOGIT_TOL["atol"]
GEOMETRY = dict(slots=4, page_size=8, max_context=64, max_prompt=16,
                max_new_tokens=8)


@pytest.fixture(scope="module")
def lm():
    jm = JT.build("tiny", **TINY)
    jparams = jm.ensure_initialized()
    tm = TT.build("tiny", device="cpu", **TINY)
    from_jax_params({k: {kk: np.asarray(vv) for kk, vv in sub.items()}
                     for k, sub in jparams.items()}, tm)
    return jm, jparams, tm


def small_engine(tm, **kw):
    reg = ModelRegistry()
    reg.register("lm", tm)
    kw = {**GEOMETRY, "max_context": 32, "max_new_tokens": 12, **kw}
    return DecodeEngine(reg, "lm", **kw).warmup()


@pytest.fixture(scope="module")
def eng64(lm):
    reg = ModelRegistry()
    reg.register("lm", lm[2])
    eng = DecodeEngine(reg, "lm", **GEOMETRY).warmup()
    yield eng
    eng.shutdown()


def _prompts(n, seed, lo=1, hi=17):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, V, rs.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


# --------------------------------------------------------------------- #
# engine against its contracts                                          #
# --------------------------------------------------------------------- #
def test_warmup_runs_every_bucket_and_the_step_once(eng64):
    st = eng64.stats()
    assert st["warmup_compiles"] == len(eng64.ladder) + 1 == 6
    assert st["recompiles"] == 0
    # warmup wrote only to the sink page
    for layer in eng64._pool.values():
        for t in layer.values():
            assert not t[:eng64.kv.n_pages].any()


def test_mixed_lengths_zero_recompiles_and_deterministic(eng64):
    reqs = _prompts(10, 0)
    base = eng64.recorder.counter_value("decode/recompiles")
    futs = [eng64.submit("lm", p, max_new_tokens=6) for p in reqs]
    first = [f.result(60) for f in futs]
    again = [eng64.submit("lm", p, max_new_tokens=6).result(60)
             for p in reqs]
    for o, p in zip(first, reqs):
        assert o.dtype == np.int32 and o.shape == (len(p) + 6,)
        assert np.array_equal(o[:len(p)], p)
    for a, b in zip(first, again):
        assert np.array_equal(a, b)      # concurrent == sequential
    assert eng64.recorder.counter_value("decode/recompiles") == base
    eng64.kv.check_invariants()
    assert eng64.kv.pages_in_use() == 0


def test_engine_tokens_are_generate_tokens(eng64, lm):
    """A greedy request through the engine (paged cache) gives the tokens
    of TransformerLM.generate (contiguous cache) on the same weights."""
    tm = lm[2]
    params = tm.param_dict()
    for p in _prompts(4, 5):
        out = eng64.predict("lm", p, timeout=60, max_new_tokens=8)
        assert np.array_equal(out, tm.generate(params, p[None], 8)[0].numpy())


def test_stream_iterator_and_stats(eng64):
    p = np.arange(1, 6, dtype=np.int32)
    stream = eng64.stream("lm", p, max_new_tokens=5)
    toks = list(stream.tokens())
    out = stream.result(10)
    assert len(toks) == 5
    assert np.array_equal(out, np.concatenate([p, np.asarray(toks)]))
    st = eng64.stats()
    assert st["finished"] >= 1 and st["tokens"] > 0
    assert 0 < st["occupancy"] <= 1
    assert st["ttft_p50_ms"] > 0 and st["intertoken_p99_ms"] > 0
    assert "token" in eng64.dump_chrome_trace()


def test_request_validation(eng64):
    with pytest.raises(KeyError):
        eng64.submit("other", [1, 2])
    with pytest.raises(ValueError, match="empty"):
        eng64.submit("lm", [])
    with pytest.raises(ValueError, match="max_prompt"):
        eng64.submit("lm", np.ones(17, np.int32))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng64.submit("lm", [1], max_new_tokens=0)
    with pytest.raises(ValueError, match="max_context"):
        eng64.submit("lm", np.ones(16, np.int32), max_new_tokens=49)


def test_eviction_readmission_replay_exact(lm):
    """Forced evictions (a pool of 6 pages, far below the working set)
    give BITWISE the tokens of the same engine without contention: the
    re-prefill at the same bucket and the replay through the decode
    step."""
    tm = lm[2]
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, V, (n,)) for n in (6, 10, 14, 8)]
    e = small_engine(tm, pool_pages=6)
    solo = [e.submit("lm", p, max_new_tokens=12).result(120)
            for p in prompts]
    assert e.recorder.counter_value("kv/evictions") == 0
    e.shutdown()
    e = small_engine(tm, pool_pages=6)
    futs = [e.submit("lm", p, max_new_tokens=12) for p in prompts]
    outs = [f.result(120) for f in futs]
    ev = e.recorder.counter_value("kv/evictions")
    re = e.recorder.counter_value("decode/readmissions")
    e.kv.check_invariants()
    e.shutdown()
    assert ev > 0 and re > 0, "pool pressure must actually evict"
    assert e.recorder.counter_value("decode/replayed_tokens") > 0
    for a, b in zip(solo, outs):
        assert np.array_equal(a, b)


def test_pool_exhaustion_backpressure(lm):
    e = small_engine(lm[2], slots=2, pool_pages=3, max_waiting=2,
                     max_new_tokens=8)
    long = []
    deadline = time.time() + 30.0
    while len(long) < 3:
        try:
            long.append(e.submit("lm", np.arange(8, dtype=np.int32) + 1,
                                 max_new_tokens=8))
        except LoadShedError:
            assert time.time() < deadline, "admission never drained"
            time.sleep(0.01)
    with pytest.raises(LoadShedError):
        for _ in range(8):
            long.append(e.submit("lm", np.arange(8, dtype=np.int32) + 1,
                                 max_new_tokens=8))
    assert e.recorder.counter_value("decode/shed_queue_full") >= 1
    for f in long:
        f.result(120)                    # backpressured work still lands
    # a request the whole pool cannot hold is rejected at the door
    with pytest.raises(ValueError, match="pages"):
        e.submit("lm", np.arange(16, dtype=np.int32) + 1,
                 max_new_tokens=16)      # 4 pages > the 3-page pool
    e.shutdown()


def test_deadline_shed_finishes_trace_before_future(eng64):
    seen = []
    fut = eng64.submit("lm", np.arange(1, 7, dtype=np.int32),
                       deadline_ms=0.0, max_new_tokens=4)
    fut.add_done_callback(lambda f: seen.append(
        [t.meta.get("cause") for t in eng64.trace_ring.traces()]))
    with pytest.raises(LoadShedError):
        fut.result(30)
    assert "deadline" in seen[0]         # in the ring when the future failed
    stream = eng64.stream("lm", np.arange(1, 7, dtype=np.int32),
                          deadline_ms=0.0, max_new_tokens=4)
    with pytest.raises(LoadShedError):
        for _ in stream.tokens():
            pass
    assert eng64.recorder.counter_value("decode/shed_deadline") >= 2


def test_poisoned_weights_fail_loudly_and_hot_swap_back(lm):
    e = small_engine(lm[2], slots=2)
    p = np.arange(1, 5, dtype=np.int32)
    good = e.predict("lm", p, timeout=60, max_new_tokens=4)
    reg = e.registry
    snap = reg.get("lm").snapshot
    poison = {k: {kk: vv.detach() * float("nan") for kk, vv in sub.items()}
              for k, sub in snap.params.items()}
    reg.swap_weights("lm", poison, version="poison")
    with pytest.raises(RuntimeError, match="non-finite"):
        e.predict("lm", p, timeout=60, max_new_tokens=4)
    assert e.recorder.counter_value("decode/nonfinite") >= 1
    reg.swap_weights("lm", snap.params, version="restored")
    back = e.predict("lm", p, timeout=60, max_new_tokens=4)
    assert np.array_equal(good, back)    # the restore is bitwise
    e.kv.check_invariants()
    e.shutdown()


def test_failed_step_fails_live_requests_and_recovers(lm, monkeypatch):
    """A decode step that raises mid-layer fails the live requests, counts
    decode/errors and leaves a zeroed pool: the next request decodes as
    before."""
    tm = lm[2]
    e = small_engine(tm, slots=2)
    p = np.arange(3, 9, dtype=np.int32)
    good = e.predict("lm", p, timeout=60, max_new_tokens=5)
    calls = {"n": 0}
    real = tm.decode_tokens

    def flaky(params, tokens, positions, kv_io):
        calls["n"] += 1
        if calls["n"] == 2:
            kv_io(tm.blocks[0].attn.name, *([torch.ones(
                2, 2, 1, 64)] * 2))      # a layer's write, then failure
            raise RuntimeError("step failed")
        return real(params, tokens, positions, kv_io)

    monkeypatch.setattr(tm, "decode_tokens", flaky)
    with pytest.raises(RuntimeError, match="step failed"):
        e.predict("lm", p, timeout=60, max_new_tokens=5)
    assert e.recorder.counter_value("decode/errors") == 1
    assert e.kv.pages_in_use() == 0
    assert np.array_equal(e.predict("lm", p, timeout=60, max_new_tokens=5),
                          good)
    e.shutdown()


def test_recompile_after_warmup_is_counted(lm):
    e = small_engine(lm[2])
    with e._lock:
        e._programs.pop(("prefill", 4))
    e.predict("lm", np.arange(1, 4, dtype=np.int32), timeout=60,
              max_new_tokens=2)
    assert e.stats()["recompiles"] == 1
    e.shutdown()


def test_replica_protocol_and_shutdown_without_drain(lm):
    e = small_engine(lm[2], slots=1, max_waiting=8)
    assert DecodeEngine.row_splittable is False
    assert e.pending_rows() == 0 and e.max_queue_fill() == 0.0
    assert e.telemetry_sources() == [("lm", e.recorder)]
    gate = threading.Event()
    real = e._tick

    def held_tick():
        gate.wait(30)
        return real()

    e._tick = held_tick
    futs = [e.submit("lm", np.arange(1, 5, dtype=np.int32),
                     max_new_tokens=4) for _ in range(3)]
    assert e.pending_rows() == 3 * (4 + 4)
    assert e.max_queue_fill() == 3 / 8
    e.shutdown(drain=False, timeout=0.0)
    gate.set()
    for f in futs:
        with pytest.raises(EngineClosedError):
            f.result(30)
    with pytest.raises(EngineClosedError):
        e.submit("lm", [1, 2])


def test_engine_over_a_cuda_entry_raises_without_a_gpu(lm, monkeypatch):
    """No fallback: an entry on the card and no card is an error, not a
    CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = ModelRegistry()
    entry = reg.register("lm", lm[2])
    entry.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(reg, "lm", **GEOMETRY)


# --------------------------------------------------------------------- #
# sampling                                                              #
# --------------------------------------------------------------------- #
def test_sampling_is_seeded_and_rows_are_independent(lm):
    """Temperature > 0: the same seed gives the same tokens, another seed
    others; a greedy request decoding beside sampled ones keeps its
    greedy tokens."""
    tm = lm[2]
    prompts = _prompts(3, 8, lo=3, hi=8)

    def run(seed, temps):
        e = small_engine(tm, seed=seed)
        futs = [e.submit("lm", p, temperature=t, max_new_tokens=10)
                for p, t in zip(prompts, temps)]
        out = [f.result(60) for f in futs]
        e.shutdown()
        return out

    a = run(1, (1.0, 1.0, 0.0))
    b = run(1, (1.0, 1.0, 0.0))
    c = run(2, (1.0, 1.0, 0.0))
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not all(np.array_equal(x, y) for x, y in zip(a[:2], c[:2]))
    greedy = tm.generate(tm.param_dict(), prompts[2][None], 10)[0].numpy()
    assert np.array_equal(a[2], greedy) and np.array_equal(c[2], greedy)


def test_select_tokens_greedy_and_sampled_rows():
    logits = torch.tensor([[0.0, 5.0, 1.0], [3.0, 0.0, 3.0]])
    temps = torch.tensor([0.0, 0.0])
    assert decode_mod._select_tokens(logits, temps, None).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    rows = decode_mod._select_tokens(
        logits.repeat(2000, 1), torch.tensor([0.0, 1.0]).repeat(2000), gen)
    assert set(rows[0::2].tolist()) == {1}            # greedy rows
    freq = np.bincount(rows[1::2].numpy(), minlength=3) / 2000
    # softmax([3, 0, 3]) = [0.488, 0.024, 0.488]
    np.testing.assert_allclose(freq, [0.488, 0.024, 0.488], atol=0.04)


# --------------------------------------------------------------------- #
# against the reference engine                                          #
# --------------------------------------------------------------------- #
def test_greedy_engine_tokens_match_the_reference_engine(lm):
    jm, jparams, tm = lm
    prompts = _prompts(8, 11)
    jreg = JModelRegistry()
    jreg.register("lm", jm)
    jeng = JDecodeEngine(jreg, "lm", **GEOMETRY).warmup()
    try:
        want = [f.result(120) for f in
                [jeng.submit("lm", p) for p in prompts]]
    finally:
        jeng.shutdown()
    e = small_engine(tm, max_context=64, max_new_tokens=8)
    got = [f.result(60) for f in [e.submit("lm", p) for p in prompts]]
    e.shutdown()
    for p, w, g in zip(prompts, want, got):
        w, s0 = np.asarray(w), len(p)
        assert g.shape == w.shape == (s0 + 8,)
        diff = np.nonzero(w != g)[0]
        if diff.size:
            j = int(diff[0])
            cache = jm.init_cache(1, cache_len=len(w))
            lg, _ = jm.apply_with_cache(jparams, jnp.asarray(w[None]),
                                        cache, 0)
            top2 = np.sort(np.asarray(lg)[0, j - 1])[-2:]
            assert j >= s0 and top2[1] - top2[0] < MARGIN_TOL, (p, w, g)


def test_int8_kv_engine(lm):
    """int8 KV through the engine: valid tokens, the first token (from the
    unquantized prefill) equal to the fp engine's, and the pool stores
    int8 codes with fp32 scales."""
    tm = lm[2]
    prompts = _prompts(4, 12, lo=4, hi=12)
    fp = small_engine(tm)
    q8 = small_engine(tm, int8_kv=True)
    a = [fp.predict("lm", p, timeout=60) for p in prompts]
    b = [q8.predict("lm", p, timeout=60) for p in prompts]
    layer = next(iter(q8._pool.values()))
    assert layer["k"].dtype == torch.int8
    assert layer["k_scale"].dtype == torch.float32
    for p, x, y in zip(prompts, a, b):
        assert y.shape == x.shape and np.all((y >= 0) & (y < V))
        assert x[len(p)] == y[len(p)]
    fp.shutdown()
    q8.shutdown()
