"""The port's ``PagedKVCache`` held against the reference's on the CPU.

The allocator cases mirror ``tests/test_decode.py`` and run on both
allocators, which must agree table for table.  The device side (pages
written in place, a sink page for every dropped write, ``-1`` gathered as
zeros) is held against the reference's functional scatter and gather,
and the slot-batched ``decode_tokens`` through the port's cache against
the reference's ``decode_tokens`` through the reference's cache on the
same tables.  The paged path against the contiguous cache is held within
a tolerance (the reference's bitwise claim fails under jax 0.9.0).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu.models import transformer as JT
from bigdl_tpu.observability import Recorder as JRecorder
from bigdl_tpu.serving import PagedKVCache as JKV
from bigdl_tpu.serving import PagePoolError as JPagePoolError
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.models.convert import from_jax_params
from bigdl_tpu_torch.serving import PagedKVCache, PagePoolError

TINY = dict(n_layers=2, max_len=128)
V = 256
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# int8 KV against the reference's int8 KV: a k/v value that float
# rounding puts on the other side of a rounding boundary takes the next
# int8 code, one step of 1/127 of its row's absmax, which moves the
# logits by up to ~1e-2 here (logits are O(0.1-1))
INT8_TOL = dict(rtol=1e-2, atol=1e-2)
# the port's paged decode against its own contiguous cache: the same ops
# on one device, at other batch shapes (slots against 1), so at most
# float rounding apart
PAGED_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def lm():
    jm = JT.build("tiny", **TINY)
    jparams = jm.ensure_initialized()
    tm = TT.build("tiny", device="cpu", **TINY)
    from_jax_params({k: {kk: np.asarray(vv) for kk, vv in sub.items()}
                     for k, sub in jparams.items()}, tm)
    return jm, jparams, tm, tm.param_dict()


def _pair(n_pages=8, n_slots=3, page=4, ctx=16, **kw):
    geo = dict(n_heads=1, head_dim=2, n_pages=n_pages, page_size=page,
               n_slots=n_slots, max_context=ctx)
    return (JKV(["a"], **geo, recorder=JRecorder(annotate=False), **kw),
            PagedKVCache(["a"], **geo, device="cpu", **kw))


# --------------------------------------------------------------------- #
# allocator                                                             #
# --------------------------------------------------------------------- #
def _invariants(kv):
    assert kv.alloc_for(0, 5)            # 2 pages
    assert kv.alloc_for(1, 9)            # 3 pages
    assert kv.pages_in_use() == 5 and kv.fill() == 5 / 8
    kv.check_invariants()
    assert kv.alloc_for(0, 5)            # idempotent below the watermark
    assert kv.pages_in_use() == 5
    assert kv.free_slot(0) == 2
    assert kv.pages_in_use() == 3
    assert np.all(kv.tables[0] == -1)
    assert kv.alloc_for(2, 16)           # reuses the freed low pages first
    kv.check_invariants()


def _exhaustion(kv):
    assert kv.alloc_for(0, 12)           # 3 of 4 pages
    assert not kv.alloc_for(1, 8)        # needs 2, 1 free: takes nothing
    assert kv.pages_in_use() == 3
    assert kv.alloc_for(1, 4)
    assert not kv.can_fit(4)
    kv.check_invariants()


def _double_free(kv):
    kv.alloc_for(0, 4)
    page = int(kv.tables[0, 0])
    kv.free_slot(0)
    kv._owned[0] = [page]                # corrupt the ledger on purpose
    with pytest.raises((PagePoolError, JPagePoolError)):
        kv.free_slot(0)


def _oversize(kv):
    with pytest.raises(ValueError, match="max_pages_per_slot"):
        kv.alloc_for(0, 17)              # > 16 = max_context


@pytest.mark.parametrize("case,n_pages", [
    (_invariants, 8), (_exhaustion, 4), (_double_free, 8), (_oversize, 8)],
    ids=["invariants", "exhaustion", "double_free", "oversize"])
def test_allocator_matches_the_reference(case, n_pages):
    ref, port = _pair(n_pages=n_pages)
    case(ref)
    case(port)
    np.testing.assert_array_equal(port.tables, ref.tables)
    assert port._owned == ref._owned and port._free == ref._free
    assert port.recorder.counter_value("kv/page_allocs") \
        == ref.recorder.counter_value("kv/page_allocs")


def test_evictions_counted_and_peak_fill_kept():
    _, kv = _pair()
    kv.alloc_for(0, 16)
    kv.free_slot(0, evict=True)
    kv.alloc_for(1, 4)
    rec = kv.recorder
    assert rec.counter_value("kv/evictions") == 1
    assert rec.gauge_value("kv/peak_fill") == 0.5
    assert rec.gauge_value("kv/pool_fill") == 1 / 8


def test_check_invariants_catches_a_stale_table_entry():
    _, kv = _pair()
    kv.alloc_for(0, 4)
    kv.tables[0, 1] = 5
    with pytest.raises(PagePoolError, match="past its pages"):
        kv.check_invariants()


def test_pool_on_the_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(["a"], n_heads=1, head_dim=2, n_pages=2)


# --------------------------------------------------------------------- #
# write / gather                                                        #
# --------------------------------------------------------------------- #
def _numbered_pool(kv):
    k = np.arange(kv.n_pages * kv.page_size * kv.n_heads * kv.head_dim,
                  dtype=np.float32).reshape(kv.n_pages, kv.page_size,
                                            kv.n_heads, kv.head_dim)
    pool = kv.init_pool()["a"]
    pool["k"][:kv.n_pages] = torch.from_numpy(k)
    pool["v"][:kv.n_pages] = torch.from_numpy(-k)
    return k, pool


def test_gather_window_orders_pages_and_fills_zero():
    ref, kv = _pair(n_pages=6, n_slots=2, page=4, ctx=16)
    k, pool = _numbered_pool(kv)
    pool["k"][6] = float("nan")          # the sink is never read
    tables = np.array([[5, 2, -1, -1], [-1, -1, -1, -1]], np.int32)
    kw, vw = kv.gather_window(pool, torch.from_numpy(tables))
    w = kw.numpy()[0, 0, :, 0]
    np.testing.assert_array_equal(w[:4], k[5, :, 0, 0])   # page 5 first
    np.testing.assert_array_equal(w[4:8], k[2, :, 0, 0])  # then page 2
    assert np.all(w[8:] == 0) and np.all(kw.numpy()[1] == 0)
    jk, jv = ref.gather_window({"k": jnp.asarray(k), "v": jnp.asarray(-k)},
                               jnp.asarray(tables))
    np.testing.assert_array_equal(kw.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vw.numpy(), np.asarray(jv))


def test_negative_table_entries_never_alias_the_last_page():
    """A dead slot's -1 table entry must not write into page n_pages - 1
    (torch wraps -1 onto it, as jax did): its write goes to the sink, and
    a gather through -1 reads zeros."""
    ref, kv = _pair(n_pages=6, n_slots=4, page=8, ctx=32)
    k, pool = _numbered_pool(kv)
    tables = np.array([[-1, -1, -1, -1], [1, 2, -1, -1], [3, 4, -1, -1],
                       [5, 0, -1, -1]], np.int32)
    lengths = np.array([0, 10, 14, 8], np.int32)
    new = np.full((4, 1, 1, 2), -1000.0, np.float32)
    kv.write_token(pool, torch.from_numpy(tables),
                   torch.from_numpy(lengths), torch.from_numpy(new),
                   torch.from_numpy(new))
    kp = pool["k"].numpy()
    np.testing.assert_array_equal(kp[5, 0], k[5, 0])   # slot 3's prompt row
    assert np.all(kp[2, 2] == -1000.0)                 # slot 1: len 10
    assert np.all(kp[4, 6] == -1000.0)                 # slot 2: len 14
    assert np.all(kp[0, 0] == -1000.0)                 # slot 3: len 8
    assert np.all(kp[6, 0] == -1000.0)                 # the dead slot: sink
    out = ref.write_token({"k": jnp.asarray(k), "v": jnp.asarray(-k)},
                          jnp.asarray(tables), jnp.asarray(lengths),
                          jnp.asarray(new), jnp.asarray(new))
    np.testing.assert_array_equal(kp[:6], np.asarray(out["k"]))
    kw, _ = kv.gather_window(pool, torch.full((4, 4), -1, dtype=torch.int32))
    assert not kw.any()


def test_write_past_the_window_goes_to_the_sink():
    _, kv = _pair(n_pages=6, n_slots=1, page=4, ctx=8)
    k, pool = _numbered_pool(kv)
    kv.write_token(pool, torch.tensor([[1, 2]], dtype=torch.int32),
                   torch.tensor([8], dtype=torch.int32),
                   torch.ones(1, 1, 1, 2), torch.ones(1, 1, 1, 2))
    np.testing.assert_array_equal(pool["k"][:6].numpy(), k)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("lb", [5, 8, 16])
def test_write_prefill_matches_the_reference(int8, lb):
    """A prefill of Lb rows lands in the table's pages; -1 entries past the
    slot's pages (prompt padding) drop."""
    geo = dict(n_heads=2, head_dim=4, n_pages=5, page_size=4, n_slots=2,
               max_context=8, int8=int8)
    ref, kv = JKV(["a"], **geo), PagedKVCache(["a"], device="cpu", **geo)
    rs = np.random.RandomState(lb)
    kk = rs.randn(1, 2, lb, 4).astype(np.float32)
    vv = rs.randn(1, 2, lb, 4).astype(np.float32)
    table = np.full(-(-lb // 4), -1, np.int32)
    table[:2] = [3, 1][:table.size]
    pool = kv.init_pool()["a"]
    kv.write_prefill(pool, torch.from_numpy(table), torch.from_numpy(kk),
                     torch.from_numpy(vv))
    out = ref.write_prefill(ref.init_pool()["a"], jnp.asarray(table),
                            jnp.asarray(kk), jnp.asarray(vv))
    for key in out:
        np.testing.assert_array_equal(pool[key][:5].numpy(),
                                      np.asarray(out[key]), err_msg=key)
    tb = np.array([[3, 1], [-1, -1]], np.int32)
    tw = kv.gather_window(pool, torch.from_numpy(tb))
    jw = ref.gather_window(out, jnp.asarray(tb))
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------------------------------- #
# decode through the cache                                              #
# --------------------------------------------------------------------- #
def _bucket(n):
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _paged_run(side, model, params, kv, prompts, steps, feed=None):
    """Prefill each ``prompts[slot]`` into its pages (bucketed, as the
    engine does), then decode every slot together for ``steps`` steps.
    Returns the logits of each step (slots, V) as numpy (the prefill's
    last-position logits first, zeros for empty slots).  Tokens fed are
    each slot's argmax, or ``feed[step]`` when given.  Returns
    ``(logits, pool)``."""
    asarr = torch.from_numpy if side == "port" else jnp.asarray
    pool = kv.init_pool()
    S = kv.n_slots
    first = np.zeros((S, V), np.float32)
    lengths = np.zeros(S, np.int32)
    for slot, p in prompts.items():
        L = len(p)
        assert kv.alloc_for(slot, L)
        b = _bucket(L)
        toks = np.zeros((1, b), np.int32)
        toks[0, :L] = p
        cache = model.init_cache(1, dtype=kv.dtype, cache_len=b) \
            if side == "ref" else model.init_cache(1, cache_len=b)
        lg, cache = model.apply_with_cache(params, asarr(toks), cache, 0)
        n = -(-b // kv.page_size)
        table = np.full(n, -1, np.int32)
        m = min(n, kv.max_pages_per_slot)
        table[:m] = kv.tables[slot, :m]
        for name in kv.layer_names:
            w = kv.write_prefill(pool[name], asarr(table), cache[name]["k"],
                                 cache[name]["v"])
            if side == "ref":
                pool[name] = w
        first[slot] = np.asarray(lg[0, L - 1])
        lengths[slot] = L
    logits = [first]
    last = first.argmax(-1).astype(np.int32)
    for i in range(steps):
        if feed is not None:
            last = feed[i]
        for slot in prompts:
            kv.alloc_for(slot, int(lengths[slot]) + 1)
        tb, ln = asarr(kv.tables.copy()), asarr(lengths.copy())

        def kv_io(name, k, v, _tb=tb, _ln=ln):
            w = kv.write_token(pool[name], _tb, _ln, k, v)
            if side == "ref":
                pool[name] = w
            return kv.gather_window(pool[name], _tb)

        lg = np.array(model.decode_tokens(params, asarr(last), ln, kv_io))
        lg[[s for s in range(S) if s not in prompts]] = 0.0
        logits.append(lg)
        last = lg.argmax(-1).astype(np.int32)
        for slot in prompts:
            lengths[slot] += 1
    return logits, pool


def _geometry(lm_model, **kw):
    return dict(n_heads=lm_model.cfg.n_heads, head_dim=lm_model.cfg.head_dim,
                **kw)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_tokens_through_the_paged_cache_matches_reference(lm, int8):
    """Three slots at other lengths (a dead one between them), the same
    tables on both sides, the reference's tokens fed to both."""
    jm, jparams, tm, tparams = lm
    geo = dict(n_pages=24, page_size=8, n_slots=4, max_context=64,
               int8=int8)
    ref = JKV([b.attn.name for b in jm.blocks], **_geometry(jm, **geo))
    kv = PagedKVCache([b.attn.name for b in tm.blocks], device="cpu",
                      **_geometry(tm, **geo))
    rs = np.random.RandomState(3)
    prompts = {0: rs.randint(0, V, 5), 2: rs.randint(0, V, 13),
               3: rs.randint(0, V, 1)}
    want, jpool = _paged_run("ref", jm, jparams, ref, prompts, 10)
    feed = [w.argmax(-1).astype(np.int32) for w in want]
    with torch.inference_mode():
        got, pool = _paged_run("port", tm, tparams, kv, prompts, 10,
                               feed=feed)
    np.testing.assert_array_equal(kv.tables, ref.tables)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, err_msg=f"step {i}",
                                   **(INT8_TOL if int8 else LOGIT_TOL))
    if int8:
        for jn, tn in zip(ref.layer_names, kv.layer_names):
            codes = pool[tn]["k"][:ref.n_pages].numpy().astype(int)
            diff = np.abs(codes - np.asarray(jpool[jn]["k"]).astype(int))
            assert diff.max() <= 1 and diff.mean() < 1e-3, diff.mean()


def _contiguous(tm, tparams, prompt, steps, window):
    with torch.inference_mode():
        cache = tm.init_cache(1, cache_len=window)
        lg, cache = tm.apply_with_cache(
            tparams, torch.from_numpy(prompt[None].astype(np.int32)), cache, 0)
        out = [lg[0, -1].numpy()]
        tok, pos = lg[:, -1].argmax(-1).int(), len(prompt)
        for _ in range(steps):
            lg, cache = tm.apply_with_cache(tparams, tok[:, None], cache, pos)
            out.append(lg[0, 0].numpy())
            tok, pos = lg[:, 0].argmax(-1).int(), pos + 1
    return out


def test_paged_decode_against_the_contiguous_cache(lm):
    """ROADMAP C3: the paged path against the contiguous cache at a
    matched window, for two slots decoding together, within PAGED_TOL.
    (Whether the bits also agree is reported by chip_smoke.py on the
    card; it is not part of the contract.)"""
    _, _, tm, tparams = lm
    kv = PagedKVCache([b.attn.name for b in tm.blocks], device="cpu",
                      **_geometry(tm, n_pages=24, page_size=8, n_slots=3,
                                  max_context=64))
    rs = np.random.RandomState(1)
    prompts = {1: rs.randint(0, V, 5), 2: rs.randint(0, V, 11)}
    with torch.inference_mode():
        got, _ = _paged_run("port", tm, tparams, kv, prompts, 6)
    for slot, p in prompts.items():
        want = _contiguous(tm, tparams, p, 6, kv.window)
        for i, w in enumerate(want):
            np.testing.assert_allclose(got[i][slot], w, **PAGED_TOL,
                                       err_msg=f"slot {slot} step {i}")


def test_int8_kv_drift_bounded_and_not_hidden(lm):
    """int8 KV is lossy by design: drift > 0 and within the reference's
    documented envelope (relative logit drift < 0.05)."""
    _, _, tm, tparams = lm
    rs = np.random.RandomState(2)
    prompts = {0: rs.randint(0, V, 7)}
    runs = []
    for int8 in (False, True):
        kv = PagedKVCache([b.attn.name for b in tm.blocks], device="cpu",
                          **_geometry(tm, n_pages=16, page_size=8, n_slots=2,
                                      max_context=64, int8=int8))
        with torch.inference_mode():
            runs.append([lg[0] for lg in _paged_run(
                "port", tm, tparams, kv, prompts, 4)[0]])
    fp, q8 = runs
    drift = max(float(np.max(np.abs(a - b))) for a, b in zip(fp, q8))
    scale = max(float(np.max(np.abs(a))) for a in fp)
    assert drift > 0.0
    assert drift / scale < 0.05, drift / scale
