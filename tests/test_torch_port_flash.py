"""The port's flash-attention forward (bigdl_tpu_torch.ops.flash_attention)
held against the reference on the CPU.

On the CPU the port runs its plain blockwise version; the reference runs
its Pallas kernel in interpret mode (as tests/test_flash_pallas.py does)
or its blockwise path where the kernel does not tile.  The CUDA kernel
itself is compared with the plain version on the card by chip_smoke.py.
Inputs come from numpy and go through both packages.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu.ops import flash_attention_mod as jfa
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import flash_attention_mod as tfa

# fp32 on both sides, different summation order: the reference's own
# tolerance for its kernel against its quadratic reference
TOL = dict(rtol=2e-4, atol=2e-4)


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
    q, k, v = (t.requires_grad_() for t in _t(*_qkv((1, 1, 32, 64), 4)))
    out = tfa.flash_attention(q, k, v, causal=True)
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        out.sum().backward()


def test_cpu_calls_do_not_count_as_kernel_launches():
    tfa.reset_launch_count()
    tfa.flash_forward(*_t(*_qkv((1, 1, 64, 64), 5)), causal=True)
    assert tfa.launch_count() == 0


def test_no_silent_fallback_on_other_devices():
    q = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(RuntimeError, match="no implementation"):
        tfa.flash_forward(q, q, q)


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


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    # the library name carries the source hash, under build/kernels/
    target = _build._target("flash_fwd")
    assert target.parent == _build.BUILD_DIR
    assert target.name.startswith("libflash_fwd_") and target.suffix == ".so"
