"""The port's flash attention (bigdl_tpu_torch.ops.flash_attention),
forward and backward, held against the reference on the CPU.

On the CPU the port runs its plain blockwise versions; the reference runs
its Pallas kernels in interpret mode (as tests/test_flash_pallas.py does)
or its blockwise path where the kernels do not tile.  The CUDA kernels
themselves are compared with the plain versions on the card by
chip_smoke.py.  Inputs come from numpy and go through both packages.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu.ops import flash_attention_mod as jfa
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import flash_attention_mod as tfa

# fp32 on both sides, different summation order: the reference's own
# tolerance for its kernel against its quadratic reference
TOL = dict(rtol=2e-4, atol=2e-4)
# backward: the same blockwise algorithm on both sides in fp32 (the
# reference's own test holds its backward to 2e-3 against the quadratic
# version; blockwise against blockwise agrees far closer)
BWD_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def interpret_mode():
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = old


def _qkv(shape, seed, sk=None):
    rs = np.random.RandomState(seed)
    kshape = shape if sk is None else shape[:2] + (sk,) + shape[3:]
    return (rs.randn(*shape).astype(np.float32) * 0.3,
            rs.randn(*kshape).astype(np.float32) * 0.3,
            rs.randn(*kshape).astype(np.float32) * 0.3)


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_pallas_interpret(causal):
    q, k, v = _qkv((1, 2, 256, 128), 0)
    cfg = jfa._Config(causal, 1 / np.sqrt(128), 128, 128, True)
    assert jfa._pallas_ok(jnp.asarray(q), jnp.asarray(k), cfg)
    want_out, (_, _, _, _, want_lse) = jfa._flash_fwd(
        cfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, lse = tfa.flash_forward(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    # the autograd entry point gives the same forward
    np.testing.assert_allclose(
        tfa.flash_attention(*_t(q, k, v), causal=causal).numpy(),
        out.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(200, 200), (300, 300), (96, 160)])
def test_plain_forward_matches_blockwise_ragged(causal, sq, sk):
    q, k, v = _qkv((2, 2, sq, 64), 1, sk=sk)
    cfg = jfa._Config(causal, 1 / np.sqrt(64), 128, 128, False)
    want_out, want_lse = jfa._fwd_blockwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg)
    out, lse = tfa.flash_forward(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches(causal):
    q, k, v = _qkv((1, 3, 70, 64), 2)
    want = jfa.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    got = tfa.attention_reference(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain, _ = tfa.flash_forward_plain(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), **TOL)


def test_bf16_inputs_accumulate_in_fp32():
    q, k, v = _qkv((1, 2, 130, 128), 3)
    qb, kb, vb = (t.to(torch.bfloat16) for t in _t(q, k, v))
    out, lse = tfa.flash_forward(qb, kb, vb, causal=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want = tfa.attention_reference(qb.float(), kb.float(), vb.float(),
                                   causal=True)
    # one bf16 rounding of the output (8 bits of mantissa)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(),
                               rtol=1e-2, atol=1e-2)


def test_backward_raises_and_names_the_roadmap_item():
    """Autograd through ``flash_attention`` on the CPU: the backward runs,
    raises nothing, and matches the reference's blockwise backward."""
    q, k, v = _qkv((1, 1, 32, 64), 4)
    g = np.random.RandomState(40).randn(1, 1, 32, 64).astype(np.float32)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    want = _jax_grads(q, k, v, g, causal=True, use_pallas=False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, **BWD_TOL)


def _jax_grads(q, k, v, g, causal, use_pallas):
    """jax.grad of <flash_attention(q, k, v), g> in the reference."""
    def f(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, causal=causal,
                                use_pallas=use_pallas)
        return jnp.sum(o * g)
    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_pallas_interpret(causal):
    q, k, v = _qkv((1, 2, 256, 128), 6)
    g = np.random.RandomState(60).randn(1, 2, 256, 128).astype(np.float32)
    cfg = jfa._Config(causal, 1 / np.sqrt(128), 128, 128, True)
    assert jfa._pallas_ok(jnp.asarray(q), jnp.asarray(k), cfg)
    want = _jax_grads(q, k, v, g, causal, use_pallas=True)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, **BWD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(300, 300), (96, 160), (200, 72)])
def test_plain_backward_matches_blockwise_ragged(causal, sq, sk):
    """The same residuals (q, k, v, out, lse, do) into both backwards."""
    q, k, v = _qkv((2, 2, sq, 64), 7, sk=sk)
    do = np.random.RandomState(70).randn(2, 2, sq, 64).astype(np.float32)
    cfg = jfa._Config(causal, 1 / np.sqrt(64), 128, 128, False)
    out, lse = jfa._fwd_blockwise(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), cfg)
    res = tuple(jnp.asarray(a) for a in (q, k, v)) + (out, lse)
    want = jfa._flash_bwd(cfg, res, jnp.asarray(do))
    got = tfa.flash_backward(*_t(q, k, v, np.array(out), np.array(lse),
                                 do), causal=causal)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL,
                                   err_msg=f"d{name}")


def test_bf16_backward_returns_input_dtype():
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_qkv((1, 2, 130, 64), 8)))
    out, lse = tfa.flash_forward(q, k, v, causal=True)
    do = torch.ones_like(out)
    dq, dk, dv = tfa.flash_backward(q, k, v, out, lse, do, causal=True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    want = tfa.flash_backward(q.float(), k.float(), v.float(), out.float(),
                              lse, do.float(), causal=True)
    for a, b in zip((dq, dk, dv), want):
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=2e-2,
                                   atol=2e-2)


def test_plain_entry_point_matches_the_dispatching_one():
    q, k, v = _qkv((1, 2, 70, 64), 9)
    a = [t.requires_grad_() for t in _t(q, k, v)]
    b = [t.requires_grad_() for t in _t(q, k, v)]
    oa = tfa.flash_attention(*a, causal=True)
    ob = tfa.flash_attention_plain(*b, causal=True)
    assert torch.equal(oa, ob)
    ga = torch.autograd.grad(oa.sum(), a)
    gb = torch.autograd.grad(ob.sum(), b)
    for x, y in zip(ga, gb):
        assert torch.equal(x, y)


def test_cpu_calls_do_not_count_as_kernel_launches():
    tfa.reset_launch_count()
    q, k, v = (t.requires_grad_() for t in _t(*_qkv((1, 1, 64, 64), 5)))
    tfa.flash_attention(q, k, v, causal=True).sum().backward()
    assert all(tfa.launch_count(n) == 0 for n in tfa.KERNELS)
    assert tfa.launch_count() == 0


def test_no_silent_fallback_on_other_devices():
    q = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(RuntimeError, match="no implementation"):
        tfa.flash_forward(q, q, q)
    lse = torch.empty((1, 1, 8), device="meta")
    with pytest.raises(RuntimeError, match="no implementation"):
        tfa.flash_backward(q, q, q, q, lse, q)


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(d=96), "head_dim"),
    (dict(sk_mismatch=True), "does not match"),
])
def test_kernel_input_checks_raise(bad, match):
    d = bad.get("d", 64)
    q = torch.zeros((1, 2, 16, d), dtype=bad.get("dtype", torch.float32))
    k = torch.zeros((1, 3 if bad.get("sk_mismatch") else 2, 16, d),
                    dtype=q.dtype)
    with pytest.raises(ValueError, match=match):
        tfa._check_kernel_inputs(q, k, k)


@pytest.mark.parametrize("bad,match", [
    (dict(do_shape=(1, 2, 15, 64)), "must match q"),
    (dict(do_dtype=torch.bfloat16), "must match q"),
    (dict(lse_dtype=torch.bfloat16), "lse must be float32"),
    (dict(lse_shape=(1, 2, 16, 1)), "lse must be float32"),
])
def test_backward_kernel_input_checks_raise(bad, match):
    q = torch.zeros((1, 2, 16, 64))
    do = torch.zeros(bad.get("do_shape", q.shape),
                     dtype=bad.get("do_dtype", torch.float32))
    lse = torch.zeros(bad.get("lse_shape", (1, 2, 16)),
                      dtype=bad.get("lse_dtype", torch.float32))
    cfg = tfa._config(q, True, None)
    with pytest.raises(ValueError, match=match):
        tfa._bwd_prepare(q, q, q, q, lse, do, cfg)


def test_backward_prepare_lays_out_gradients_like_the_model():
    """dq, dk, dv come in (B, S, H, D) storage, so the model's transpose
    back to (B, S, H*D) reads them as views; delta is rowsum(do * out)."""
    q, k, v = _t(*_qkv((2, 3, 40, 64), 10))
    do = torch.from_numpy(np.random.RandomState(11).randn(2, 40, 3, 64)
                          .astype(np.float32)).transpose(1, 2)
    out, lse = tfa.flash_forward(q, k, v, causal=True)
    c = tfa._bwd_prepare(q, k, v, out, lse, do, tfa._config(q, True, None))
    for t in (c.dq, c.dk, c.dv):
        assert t.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(c.delta, (do * out).sum(-1))
    assert list(c.strides)[9:12] == list(do.stride()[:3])


def test_build_flags_are_per_source_and_hashed(monkeypatch):
    assert "-fmad=false" in _build._flags("fused_adam")
    assert "-fmad=false" not in _build._flags("flash_bwd")
    before = _build._target("fused_adam")
    monkeypatch.setitem(_build.EXTRA_FLAGS, "fused_adam", ("-fmad=true",))
    assert _build._target("fused_adam") != before


def test_build_target_hashes_the_included_headers(monkeypatch, tmp_path):
    """A source includes the headers under csrc/ (flash_mma.cuh): an edit
    to one names a new library for every source, so no stale build is
    loaded; an unchanged tree names the same one."""
    names = ("flash_fwd", "flash_bwd", "fused_adam")
    before = {n: _build._target(n) for n in names}
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert {n: _build._target(n) for n in names} == before
    header = tmp_path / "flash_mma.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build._target(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    (tmp_path / "extra.cuh").write_text("// a new header\n")
    assert _build._target("flash_bwd") != after["flash_bwd"]


def test_launch_counts_are_per_kernel():
    _build.reset_launch_counts()
    _build.count_launch("flash_bwd_dq")
    _build.count_launch("flash_bwd_dq")
    assert _build.launch_counts() == {"flash_bwd_dq": 2}
    assert tfa.launch_count("flash_bwd_dq") == 2
    assert tfa.launch_count() == 0
    tfa.reset_launch_count()
    assert _build.launch_counts() == {}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    # the library name carries the source hash, under build/kernels/
    target = _build._target("flash_fwd")
    assert target.parent == _build.BUILD_DIR
    assert target.name.startswith("libflash_fwd_") and target.suffix == ".so"
