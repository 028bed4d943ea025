"""The port's cache paths, ``generate`` and ``generate_beam`` held against
the reference on the CPU.

A ``tiny`` TransformerLM (2 layers, max_len 128) is initialised in
``bigdl_tpu``; its weights go through numpy into ``bigdl_tpu_torch``
(``from_jax_params``).  Inputs come from numpy seeds.  The cached
attention is plain fp32 on both sides (einsums under XLA, ``einsum`` in
ATen), so logits agree to float rounding; greedy tokens agree except
where the reference's own top two logits are closer than two logit
tolerances, which the tests check instead of skipping.  Sampling draws
are not ``jax.random``'s: sampled tokens are held by their properties.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

from bigdl_tpu import quantized as jq
from bigdl_tpu.models import transformer as JT
from bigdl_tpu_torch import quantized as tq
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.models.convert import from_jax_params

TINY = dict(n_layers=2, max_len=128)
V = 256
# fp32 on both sides; XLA-CPU and ATen-CPU sum the projections and the
# attention in different orders (logits are O(1))
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# two logits each within atol of the reference's can swap their order
# only when the reference's gap between them is below 2 * atol
MARGIN_TOL = 2 * LOGIT_TOL["atol"]


@pytest.fixture(scope="module")
def lm():
    """(reference model, its params, port model on the CPU, its params)."""
    jm = JT.build("tiny", **TINY)
    jparams = jm.ensure_initialized()
    tm = TT.build("tiny", device="cpu", **TINY)
    from_jax_params({k: {kk: np.asarray(vv) for kk, vv in sub.items()}
                     for k, sub in jparams.items()}, tm)
    return jm, jparams, tm, tm.param_dict()


def _prompt(b, s, seed):
    return np.random.RandomState(seed).randint(0, V, (b, s)).astype(np.int32)


def _ref_teacher_logits(jm, jparams, seq):
    """The reference's logits at every position of ``seq`` (B, S), one
    contiguous-cache prefill."""
    cache = jm.init_cache(seq.shape[0], cache_len=seq.shape[1])
    lg, _ = jm.apply_with_cache(jparams, jnp.asarray(seq), cache, 0)
    return np.asarray(lg)


def assert_greedy_agrees(ref, got, s0, ref_logits):
    """Greedy tokens equal the reference's up to each row's first
    difference, where the reference's top-two margin must be below
    MARGIN_TOL (after it the rows continue from different tokens)."""
    np.testing.assert_array_equal(got[:, :s0], ref[:, :s0])
    for r in range(ref.shape[0]):
        diff = np.nonzero(ref[r, s0:] != got[r, s0:])[0]
        if diff.size:
            j = s0 + int(diff[0])
            top2 = np.sort(ref_logits[r, j - 1])[-2:]
            assert top2[1] - top2[0] < MARGIN_TOL, (
                f"row {r} position {j}: port {got[r, j]} against reference "
                f"{ref[r, j]} with a margin {top2[1] - top2[0]:.3e}")


# --------------------------------------------------------------------- #
# rope rows, quantize rows                                              #
# --------------------------------------------------------------------- #
def test_apply_rope_rows_matches_reference():
    rs = np.random.RandomState(0)
    x = rs.randn(5, 2, 1, 64).astype(np.float32)
    pos = np.array([0, 3, 17, 100, 511], np.int32)
    want = np.asarray(JT.apply_rope_rows(jnp.asarray(x), jnp.asarray(pos)))
    got = TT.apply_rope_rows(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_apply_rope_rows_is_apply_rope_at_each_row():
    """A row at position p is the row apply_rope gives at p (same op
    sequence, so bitwise on one device)."""
    x = torch.from_numpy(np.random.RandomState(1).randn(
        1, 2, 40, 32).astype(np.float32))
    full = TT.apply_rope(x, torch.arange(40))
    pos = torch.tensor([0, 7, 39])
    rows = TT.apply_rope_rows(x[0, :, pos].permute(1, 0, 2)[:, :, None],
                              pos)                     # (3, H, 1, D)
    for i, p in enumerate(pos.tolist()):
        assert torch.equal(rows[i, :, 0], full[0, :, p])


@pytest.mark.parametrize("shape,scale", [((4, 16, 2, 8), 1.0),
                                         ((3, 5, 64), 30.0),
                                         ((2, 7), 1e-9)])
def test_quantize_rows_bitwise_against_reference(shape, scale):
    x = (np.random.RandomState(2).randn(*shape) * scale).astype(np.float32)
    x.reshape(-1)[:3] = [0.5 * scale, -0.5 * scale, 0.0]   # exact halves
    jq_, js = jq.quantize_rows(jnp.asarray(x), axis=-1)
    q, s = tq.quantize_rows(torch.from_numpy(x), axis=-1)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.dequantize_rows(q, s).numpy(),
        np.asarray(jq.dequantize_rows(jq_, js)))
    assert int(q.abs().max()) <= 127


def test_quantize_rows_rounds_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]])
    q, s = tq.quantize_rows(x)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]


# --------------------------------------------------------------------- #
# contiguous cache                                                      #
# --------------------------------------------------------------------- #
def test_apply_with_cache_prefill_and_steps_match_reference(lm):
    jm, jparams, tm, tparams = lm
    toks = _prompt(2, 16, 0)
    jcache = jm.init_cache(2, cache_len=32)
    tcache = tm.init_cache(2, cache_len=32)
    with torch.inference_mode():
        jl, jcache = jm.apply_with_cache(jparams, jnp.asarray(toks[:, :7]),
                                         jcache, 0)
        tl, tcache = tm.apply_with_cache(tparams, torch.from_numpy(
            toks[:, :7]), tcache, 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        for i in range(7, 16):
            jl, jcache = jm.apply_with_cache(
                jparams, jnp.asarray(toks[:, i:i + 1]), jcache, i)
            tl, tcache = tm.apply_with_cache(
                tparams, torch.from_numpy(toks[:, i:i + 1]), tcache, i)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       err_msg=f"position {i}", **LOGIT_TOL)
    name = tm.blocks[0].attn.name
    jname = jm.blocks[0].attn.name
    np.testing.assert_allclose(tcache[name]["k"].numpy(),
                               np.asarray(jcache[jname]["k"]), **LOGIT_TOL)
    assert tcache[name]["k"].shape == (2, 2, 32, 64)


def test_cached_logits_match_the_full_forward(lm):
    """Teacher-forced through the cache one token at a time, every
    position's logits are the one-shot forward's (which runs the flash
    attention's plain version on the CPU)."""
    _, _, tm, tparams = lm
    toks = torch.from_numpy(_prompt(2, 12, 1))
    with torch.inference_mode():
        full, _ = tm.run(tparams, toks)
        cache = tm.init_cache(2)
        lg, cache = tm.apply_with_cache(tparams, toks[:, :5], cache, 0)
        torch.testing.assert_close(lg, full[:, :5], rtol=2e-5, atol=2e-5)
        for i in range(5, 12):
            lg, cache = tm.apply_with_cache(tparams, toks[:, i:i + 1],
                                            cache, i)
            torch.testing.assert_close(lg[:, 0], full[:, i], rtol=2e-5,
                                       atol=2e-5)


def test_init_cache_dtype_and_device(lm):
    _, _, tm, _ = lm
    c = tm.init_cache(3, dtype="bfloat16", cache_len=10)
    assert set(c) == {b.attn.name for b in tm.blocks}
    k = c[tm.blocks[1].attn.name]["k"]
    assert k.dtype == torch.bfloat16 and k.device.type == "cpu"
    assert k.shape == (3, 2, 10, 64) and not k.any()


# --------------------------------------------------------------------- #
# generate                                                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("b,s0,new,seed", [(2, 7, 9, 0), (3, 5, 12, 4),
                                            (1, 1, 20, 5)])
def test_greedy_generate_matches_reference(lm, b, s0, new, seed):
    jm, jparams, tm, tparams = lm
    prompt = _prompt(b, s0, seed)
    ref = np.asarray(jm.generate(jparams, prompt, new))
    got = tm.generate(tparams, prompt, new)
    assert got.dtype == torch.int32 and got.shape == (b, s0 + new)
    assert_greedy_agrees(ref, got.numpy(), s0,
                         _ref_teacher_logits(jm, jparams, ref))


def test_generate_matches_manual_cached_loop(lm):
    """generate writes token j at ITS position j: a hand-written loop over
    apply_with_cache gives the same tokens (same path, so exact)."""
    _, _, tm, tparams = lm
    prompt = torch.from_numpy(_prompt(2, 6, 4))
    got = tm.generate(tparams, prompt, 7)
    with torch.inference_mode():
        cache = tm.init_cache(2, cache_len=13)
        lg, cache = tm.apply_with_cache(tparams, prompt, cache, 0)
        tok = lg[:, -1].argmax(-1).int()
        out = [tok]
        for j in range(6, 12):
            lg, cache = tm.apply_with_cache(tparams, tok[:, None], cache, j)
            tok = lg[:, -1].argmax(-1).int()
            out.append(tok)
    assert torch.equal(got, torch.cat([prompt, torch.stack(out, 1)], 1))


def test_generate_limits_and_zero_tokens(lm):
    jm, jparams, tm, tparams = lm
    prompt = _prompt(2, 5, 5)
    assert torch.equal(tm.generate(tparams, prompt, 0),
                       torch.from_numpy(prompt))
    with pytest.raises(ValueError, match="max_len"):
        tm.generate(tparams, np.zeros((1, 120), np.int32), 10)
    with pytest.raises(ValueError, match="max_len"):
        jm.generate(jparams, np.zeros((1, 120), np.int32), 10)
    with pytest.raises(ValueError, match="top_k"):
        tm.generate(tparams, prompt, 2, temperature=1.0, top_k=0)


def test_generate_params_transform(lm):
    """params_transform maps the params before the first step: scaling the
    head by 2 leaves every argmax where it was."""
    _, _, tm, tparams = lm
    head = tm.head.name
    calls = []

    def double_head(p):
        calls.append(1)
        return {**p, head: {"weight": p[head]["weight"] * 2.0}}

    prompt = _prompt(2, 4, 6)
    got = tm.generate(tparams, prompt, 5, params_transform=double_head)
    assert calls == [1]
    assert torch.equal(got, tm.generate(tparams, prompt, 5))


def test_sampled_generate_properties(lm):
    """Same seed, same tokens; another seed, other tokens; top_k=1 and a
    tiny top_p are greedy."""
    _, _, tm, tparams = lm
    prompt = _prompt(2, 4, 3)
    a = tm.generate(tparams, prompt, 12, temperature=1.0, rng=7)
    b = tm.generate(tparams, prompt, 12, temperature=1.0, rng=7)
    c = tm.generate(tparams, prompt, 12, temperature=1.0, rng=8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    greedy = tm.generate(tparams, prompt, 6)
    for kw in (dict(top_k=1), dict(top_p=1e-6)):
        assert torch.equal(greedy, tm.generate(tparams, prompt, 6,
                                               temperature=1.0, rng=0, **kw))
    gen = torch.Generator().manual_seed(3)
    k8 = tm.generate(tparams, prompt, 6, temperature=1.0, rng=gen, top_k=8)
    assert k8.shape == (2, 10)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.5, None, None), (1.0, 3, None), (1.0, None, 0.6)])
def test_sampler_frequencies_match_the_softmax(temperature, top_k, top_p):
    """A chi-square test of 40000 draws over a vocab of 8 against the
    softmax of the filtered, tempered logits (p > 1e-3)."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.25])
    lg = TT._filter_logits(logits[None] / temperature, top_k, top_p)[0]
    probs = torch.softmax(lg, -1).double().numpy()
    n = 40000
    draws = TT.gumbel_sample(lg.expand(n, -1).contiguous(),
                       torch.Generator().manual_seed(11))
    counts = np.bincount(draws.numpy(), minlength=8)
    keep = probs > 0
    assert counts[~keep].sum() == 0
    if top_k is not None:
        assert keep.sum() == top_k
    if top_p is not None:
        assert keep.sum() == 2      # 0.36 + 0.22 reaches 0.6
    _, p = stats.chisquare(counts[keep],
                           probs[keep] / probs[keep].sum() * n)
    assert p > 1e-3, (counts, probs * n)


# --------------------------------------------------------------------- #
# beam search                                                           #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("b,s0,new,K,penalty", [
    (2, 5, 6, 4, 0.0), (1, 8, 10, 3, 0.7), (2, 3, 5, 1, 0.0)])
def test_beam_search_matches_reference(lm, b, s0, new, K, penalty):
    jm, jparams, tm, tparams = lm
    prompt = _prompt(b, s0, 7 + K)
    jseq, jsc = jm.generate_beam(jparams, prompt, new, beam_size=K,
                                 length_penalty=penalty)
    seq, sc = tm.generate_beam(tparams, prompt, new, beam_size=K,
                               length_penalty=penalty)
    assert seq.dtype == torch.int32 and seq.shape == (b, s0 + new)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("penalty", [0.0, 1.0])
def test_beam_search_eos_freezes_like_the_reference(lm, penalty):
    """With the greedy first token as eos, beams freeze on it; without a
    length penalty the best beam is one of them (it costs nothing more),
    with one the longer live beams may win, as in the reference."""
    jm, jparams, tm, tparams = lm
    prompt = _prompt(1, 4, 8)
    first = int(tm.generate(tparams, prompt, 1)[0, -1])
    jseq, jsc = jm.generate_beam(jparams, prompt, 8, beam_size=3,
                                 eos_id=first, length_penalty=penalty)
    seq, sc = tm.generate_beam(tparams, prompt, 8, beam_size=3,
                               eos_id=first, length_penalty=penalty)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=1e-4,
                               atol=1e-4)
    s = seq.numpy()[0, 4:]
    at = np.nonzero(s == first)[0]
    assert at.size or penalty
    if at.size:
        assert np.all(s[at[0]:] == first)


def test_beam_scores_are_the_sequence_log_probs(lm):
    """The best beam's score is its tokens' summed log-prob under the
    full forward, and at least the greedy sequence's."""
    _, _, tm, tparams = lm
    prompt = _prompt(2, 5, 9)
    n_new = 6

    def seq_logprob(tokens):
        with torch.inference_mode():
            logits, _ = tm.run(tparams, tokens[:, :-1])
        logp = torch.log_softmax(logits, -1)
        per = torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
        return per[:, -n_new:].sum(1)

    seq, sc = tm.generate_beam(tparams, prompt, n_new, beam_size=4)
    greedy = tm.generate(tparams, prompt, n_new)
    torch.testing.assert_close(sc, seq_logprob(seq), rtol=1e-4, atol=1e-4)
    assert torch.all(seq_logprob(seq) >= seq_logprob(greedy) - 1e-4)


def test_beam_limits(lm):
    _, _, tm, tparams = lm
    prompt = _prompt(2, 5, 10)
    seq, sc = tm.generate_beam(tparams, prompt, 0)
    assert torch.equal(seq, torch.from_numpy(prompt)) and not sc.any()
    for k in (0, V + 1):
        with pytest.raises(ValueError, match="beam_size"):
            tm.generate_beam(tparams, prompt, 3, beam_size=k)
    with pytest.raises(ValueError, match="max_len"):
        tm.generate_beam(tparams, np.zeros((1, 125), np.int32), 4)


def test_top_k_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0]])
    vals, idx = TT._top_k(x, 4)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[1, 2, 4, 5]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


def test_build_on_the_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.build("tiny", **TINY)
