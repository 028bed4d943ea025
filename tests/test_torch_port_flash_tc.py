"""The arithmetic of the tensor-core flash-attention forward
(``bigdl_tpu_torch/csrc/flash_fwd.cu``, K1), emulated on the CPU.

The kernel itself runs only on the card, where ``chip_smoke.py`` holds it
against the plain forward.  What can be held here is the arithmetic it
chose and the register layouts it relies on:

  * f32 products in split TF32 (``hi = tf32_rna(x)``, ``lo = x - hi``
    read truncated to TF32; ``lo*hi + hi*lo + hi*hi``) stay within K1's f32
    limit of the plain fp32 forward, and one TF32 product does not, so
    the limit can tell the two apart;
  * P·V on m16n8k8.tf32 with the contraction index permuted (A columns
    t, t+4 take accumulator columns 2t, 2t+1; B rows 2t, 2t+1 of V) is
    the plain product;
  * on m16n8k16.bf16 the accumulator of two 8-key chunks is the A operand
    of P·V, and ``ldmatrix.trans`` at the kernel's lane addresses gives
    the B operand;
  * P split into two bf16 halves against bf16 V stays within K1's bf16
    limit of the fp32-P reference.

Inputs come from numpy seeds.  TF32 rounding is emulated as
``cvt.rna.tf32.f32`` does it: round to nearest, ties away from zero, on
the 13 low mantissa bits.  An MMA's products of TF32 or bf16 values are
exact, so they are summed here in float64 and rounded to fp32.
"""
import runpy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import flash_attention_mod as jfa
from bigdl_tpu_torch.ops import flash_attention_mod as tfa

REPO = Path(__file__).resolve().parents[1]
KERNEL_TOL = runpy.run_path(str(REPO / "chip_smoke.py"),
                            run_name="chip_smoke_import")["KERNEL_TOL"]
F32_TOL = KERNEL_TOL[torch.float32]
BF16_TOL = KERNEL_TOL[torch.bfloat16]
MASK = np.float32(tfa.DEFAULT_MASK_VALUE)


@pytest.fixture(autouse=True)
def interpret_mode():
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = old


def tf32(x):
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, round to nearest with
    ties away from zero; the 13 low bits become 0."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def trunc_tf32(x):
    """A TF32 operand as the MMA reads it: the 13 low bits ignored."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """K1's split: hi = tf32_rna(x), lo = x - hi (exact in fp32), which the
    MMA reads truncated to TF32."""
    hi = tf32(x)
    return hi, trunc_tf32(np.float32(x) - hi)


def mm_fp32(a, b):
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def mm_tf32(a, b):
    """One TF32 product: both operands rounded to TF32."""
    return mm_fp32(tf32(a), tf32(b))


def mm_split_tf32(a, b):
    """K1's f32 product: lo*hi + hi*lo, then hi*hi, into an fp32 sum."""
    ah, al = split(a)
    bh, bl = split(b)
    c = mm_fp32(al, bh) + mm_fp32(ah, bl)
    return c + mm_fp32(ah, bh)


def bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def mm_split_bf16_p(p, v):
    """K1's bf16 P·V: p = p_hi + p_lo, both bf16, against bf16 v."""
    hi = bf16(p)
    lo = bf16(p - hi)
    return mm_fp32(lo, v) + mm_fp32(hi, v)


def emulate_forward(q, k, v, causal, qk, pv, bk, scale_q=True):
    """K1's online softmax over key tiles of ``bk`` with the products
    ``qk`` (q·kᵀ) and ``pv`` (p·v). (B, H, S, D) float32 -> (out, lse)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = np.float32(1.0 / np.sqrt(d))
    qs = (q * scale).astype(np.float32) if scale_q else q
    m = np.full((b, h, sq), MASK, np.float32)
    l = np.zeros((b, h, sq), np.float32)
    acc = np.zeros((b, h, sq, d), np.float32)
    q_pos = np.arange(sq)[:, None]
    for k0 in range(0, sk, bk):
        kt = k[:, :, k0:k0 + bk]
        k_pos = np.arange(k0, k0 + kt.shape[2])[None, :]
        s = qk(qs, kt.transpose(0, 1, 3, 2))
        if not scale_q:
            s = (s * scale).astype(np.float32)
        ok = np.ones_like(s, bool) if not causal else (q_pos >= k_pos)
        s = np.where(ok, s, MASK)
        m_new = np.maximum(m, s.max(-1))
        p = np.exp(s - m_new[..., None]).astype(np.float32)
        corr = np.exp(m - m_new).astype(np.float32)
        l = corr * l + p.sum(-1, dtype=np.float32)
        acc = corr[..., None] * acc + pv(p, v[:, :, k0:k0 + bk])
        m = m_new
    safe_l = np.where(l == 0, np.float32(1), l)
    return acc / safe_l[..., None], m + np.log(safe_l)


def _qkv(shape, seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(*shape).astype(dtype) for _ in range(3))


def _within(got, want, tol):
    return np.allclose(got, want, rtol=tol["rtol"], atol=tol["atol"])


# --------------------------------------------------------------------- #
# f32: split TF32 keeps the fp32 contract, one TF32 product does not     #
# --------------------------------------------------------------------- #
def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                # a TF32 ulp at 1.0
    x = np.array([one + ulp / 2, one + ulp / 2 - 2 ** -23, -(one + ulp / 2),
                  one + 3 * ulp / 2], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([one + ulp, one, -(one + ulp), one + 2 * ulp],
                          np.float32))
    x = np.random.RandomState(7).randn(1000).astype(np.float32)
    hi, lo = split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    # hi is within half a TF32 ulp of x and lo carries the rest to 2^-21
    rest = np.abs(x.astype(np.float64) - hi - lo)
    assert (rest <= np.abs(x) * 2.0 ** -21).all()
    assert (np.abs(x - hi) <= np.abs(x) * 2.0 ** -11).all()


def test_split_tf32_forward_keeps_the_f32_limit_and_tf32_misses_it():
    # the main path's head shape at a smaller batch, randn as the card's
    # comparison draws its inputs; K1's f32 tiles are 32 keys
    q, k, v = _qkv((2, 6, 512, 128), 0)
    ref, ref_lse = (t.numpy() for t in tfa.flash_forward_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True))
    out, lse = emulate_forward(q, k, v, True, mm_split_tf32, mm_split_tf32,
                               bk=32)
    err = np.abs(out - ref).max()
    assert _within(out, ref, F32_TOL), err
    assert err < 2e-5 and np.abs(lse - ref_lse).max() < 1e-5
    out1, _ = emulate_forward(q, k, v, True, mm_tf32, mm_tf32, bk=32)
    assert not _within(out1, ref, F32_TOL)
    assert np.abs(out1 - ref).max() > 20 * err


@pytest.mark.parametrize("causal", [False, True])
def test_split_tf32_forward_matches_pallas_interpret(causal):
    q, k, v = _qkv((1, 2, 256, 128), 3)
    cfg = jfa._Config(causal, 1 / np.sqrt(128), 128, 128, True)
    want, (_, _, _, _, want_lse) = jfa._flash_fwd(
        cfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, lse = emulate_forward(q, k, v, causal, mm_split_tf32,
                               mm_split_tf32, bk=32)
    np.testing.assert_allclose(out, np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(lse, np.asarray(want_lse), **F32_TOL)


# --------------------------------------------------------------------- #
# register layouts of the MMAs (PTX ISA, mma.m16n8k8 / m16n8k16)         #
# --------------------------------------------------------------------- #
def _lanes():
    return [(lane, lane // 4, lane % 4) for lane in range(32)]


def mma_m16n8k8(a_frag, b_frag):
    """D = A·B of one m16n8k8.tf32 from per-lane fragments: a (4 each),
    b (2 each). -> per-lane accumulator fragments (4 each)."""
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for lane, g, t in _lanes():
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a_frag[lane]
        b[t, g], b[t + 4, g] = b_frag[lane]
    return acc_frags(a @ b)


def acc_frags(c):
    """The accumulator layout of m16n8kX: lane (g, t) holds
    (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)."""
    return [(c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t],
             c[g + 8, 2 * t + 1]) for _, g, t in _lanes()]


def from_acc_frags(frags, n=8):
    c = np.zeros((16, n))
    for lane, g, t in _lanes():
        (c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t],
         c[g + 8, 2 * t + 1]) = frags[lane]
    return c


def test_permuted_contraction_pv_equals_the_plain_product():
    rs = np.random.RandomState(4)
    p = tf32(np.exp(rs.randn(16, 8)).astype(np.float32))   # one key chunk
    v = tf32(rs.randn(8, 16).astype(np.float32))           # two n chunks
    want = p.astype(np.float64) @ v.astype(np.float64)
    pc = acc_frags(p)                       # P as S's accumulator left it
    got = np.zeros((16, 16))
    naive = np.zeros((16, 16))
    for n in range(2):
        vn = v[:, 8 * n:8 * n + 8]
        # the kernel: a = (c0, c2, c1, c3); b0 = V[2t, g], b1 = V[2t+1, g]
        a = [(c[0], c[2], c[1], c[3]) for c in pc]
        b = [(vn[2 * t, g], vn[2 * t + 1, g]) for _, g, t in _lanes()]
        got[:, 8 * n:8 * n + 8] = from_acc_frags(mma_m16n8k8(a, b))
        # the accumulator fed as it lies, with V in its own order: wrong
        b_plain = [(vn[t, g], vn[t + 4, g]) for _, g, t in _lanes()]
        naive[:, 8 * n:8 * n + 8] = from_acc_frags(
            mma_m16n8k8([tuple(c) for c in pc], b_plain))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(naive, want)


def test_bf16_accumulators_of_two_key_chunks_are_the_a_operand():
    rs = np.random.RandomState(5)
    p = rs.randn(16, 16)
    s0, s1 = acc_frags(p[:, :8]), acc_frags(p[:, 8:])
    a = np.zeros((16, 16))
    for lane, g, t in _lanes():
        # the kernel: a_r = pack(p[2r], p[2r+1]) of (s0[0..3], s1[0..3])
        flat = list(s0[lane]) + list(s1[lane])
        regs = [(flat[2 * r], flat[2 * r + 1]) for r in range(4)]
        # m16n8k16 A: a0 (g, 2t..2t+1), a1 (g+8, ..), a2 (g, 2t+8..),
        # a3 (g+8, 2t+8..); the lower half is the lower column
        for r, (row, col) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                        (g, 2 * t + 8), (g + 8, 2 * t + 8))):
            a[row, col], a[row, col + 1] = regs[r]
    np.testing.assert_array_equal(a, p)


def test_ldmatrix_trans_at_the_kernel_addresses_gives_the_b_operand():
    v = np.arange(16 * 16, dtype=np.float64).reshape(16, 16)  # keys x dims
    # lane l gives the row address of matrix l // 8: key (l % 8) +
    # 8 * ((l // 8) % 2), dim 8 * (l // 16)
    rows = [(l % 8 + 8 * ((l // 8) % 2), 8 * (l // 16)) for l in range(32)]
    mats = [np.array([v[r, c:c + 8] for r, c in rows[8 * i:8 * i + 8]])
            for i in range(4)]
    for lane, g, t in _lanes():
        # .trans: lane (g, t) receives rows 2t, 2t+1 of column g
        regs = [(m[2 * t, g], m[2 * t + 1, g]) for m in mats]
        for n in range(2):
            b0, b1 = regs[2 * n], regs[2 * n + 1]
            # m16n8k16 B: b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
            assert b0 == (v[2 * t, 8 * n + g], v[2 * t + 1, 8 * n + g])
            assert b1 == (v[2 * t + 8, 8 * n + g], v[2 * t + 9, 8 * n + g])


# --------------------------------------------------------------------- #
# bf16: P split in two bf16 halves keeps the fp32-P reference            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [128, 100])
@pytest.mark.parametrize("d", [64, 128])
def test_split_bf16_p_stays_within_the_bf16_limit(d, s, causal):
    q, k, v = (bf16(a) for a in _qkv((2, 2, s, d), 6 + d + s))
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    ref, ref_lse = tfa.flash_forward_plain(qb, kb, vb, causal=causal)
    out, lse = emulate_forward(q, k, v, causal, mm_fp32, mm_split_bf16_p,
                               bk=64, scale_q=False)
    out = bf16(out)
    np.testing.assert_allclose(out, ref.float().numpy(), **BF16_TOL)
    np.testing.assert_allclose(lse, ref_lse.numpy(), rtol=1e-4, atol=1e-3)
    # the split keeps P to ~16 bits: far inside one bf16 rounding of out
    exact, _ = emulate_forward(q, k, v, causal, mm_fp32, mm_fp32, bk=64,
                               scale_q=False)
    assert np.abs(out - exact).max() <= np.abs(exact).max() * 2.0 ** -8


# --------------------------------------------------------------------- #
# the wrapper's operand layout                                           #
# --------------------------------------------------------------------- #
def test_operands_are_copied_only_below_4_byte_alignment():
    flat = torch.randn(2 * 2 * 8 * 64 + 1)
    q = flat[1:].view(2, 2, 8, 64)                   # f32, 4-byte aligned
    got = tfa._fwd_operands(q, q, q)
    assert all(t.data_ptr() == q.data_ptr() for t in got)
    hb = flat.to(torch.bfloat16)[1:].view(2, 2, 8, 64)  # bf16 at 2 bytes
    for t in tfa._fwd_operands(hb, hb, hb):
        assert t.data_ptr() % 4 == 0 and t.is_contiguous()
        assert torch.equal(t, hb)
    strided = torch.randn(2, 8, 2, 64).transpose(1, 2)   # (B, S, H, D)
    assert tfa._fwd_operands(strided, strided, strided)[1] is strided


def test_backward_operands_are_copied_only_below_4_byte_alignment():
    """K2 and K3 take q, k, v and do as the forward takes q, k, v: a view
    at a 4-byte offset is read in place, a bf16 view at an odd element
    offset is copied (no copy width reaches it)."""
    b, h, s, d = 2, 2, 8, 64
    flat = torch.randn(b * h * s * d + 1)
    q = flat[1:].view(b, h, s, d)                    # f32, 4-byte aligned
    lse = torch.zeros(b, h, s)
    cfg = tfa._config(q, True, None)
    c = tfa._bwd_prepare(q, q, q, q, lse, q, cfg)
    assert all(t.data_ptr() == q.data_ptr() for t in (c.q, c.k, c.v, c.do))
    hb = flat.to(torch.bfloat16)[1:].view(b, h, s, d)   # bf16 at 2 bytes
    c = tfa._bwd_prepare(hb, hb, hb, hb, lse, hb, cfg)
    for t in (c.q, c.k, c.v, c.do):
        assert t.data_ptr() % 4 == 0 and t.is_contiguous()
        assert torch.equal(t, hb)
    h2 = torch.randn(b * h * s * d + 2).to(torch.bfloat16)[2:].view(
        b, h, s, d)                                      # bf16 at 4 bytes
    c = tfa._bwd_prepare(h2, h2, h2, h2, lse, h2, cfg)
    assert all(t.data_ptr() == h2.data_ptr() for t in (c.q, c.k, c.v, c.do))
    strided = torch.randn(b, s, h, d).transpose(1, 2)    # (B, S, H, D)
    c = tfa._bwd_prepare(strided, strided, strided, strided, lse, strided,
                         cfg)
    assert c.k is strided and c.do is strided
