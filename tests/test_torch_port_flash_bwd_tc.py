"""The arithmetic of the tensor-core flash-attention backward
(``bigdl_tpu_torch/csrc/flash_bwd.cu``, K2 and K3), emulated on the CPU.

The kernels run only on the card, where ``chip_smoke.py`` holds them
against the plain backward.  What can be held here is the arithmetic they
chose and the register layouts they rely on:

  (a) K3's three products (S = Q Kᵀ, dP = dO Vᵀ, dQ += dS K) and K2's four
      (Sᵀ = K Qᵀ, dPᵀ = V dOᵀ, dV += Pᵀ dO, dK += dSᵀ Q) in split TF32, each
      summed over its tile and added to the running sums in fp32, stay
      within the f32 backward limit of the Pallas kernels (interpret mode)
      and of the plain backward, causal or not, ragged S included; one TF32
      pass misses that limit at the same shape;
  (b) K2's Sᵀ = K Qᵀ for a warp's 16 keys on m16n8k8 fragments, with lse
      and delta indexed per q column, handed to dV += Pᵀ dO and
      dK += dSᵀ Q through the permuted contraction, is the plain product;
  (c) bf16 inputs with P and dS split into two bf16 halves stay within the
      bf16 backward limit;
  (d) q rows past Sq (staged with lse = 0) and masked keys give finite
      zeros through the select after the exp, where masking by a product
      would give NaN.

Inputs come from numpy seeds; products of TF32 or bf16 values are exact,
so they are summed in float64 and rounded to fp32 (tests of K1's forward:
``tests/test_torch_port_flash_tc.py``, whose helpers these reuse).
"""
import runpy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import flash_attention_mod as jfa
from bigdl_tpu_torch.ops import flash_attention_mod as tfa
from test_torch_port_flash_tc import (_lanes, bf16, from_acc_frags, mm_fp32,
                                      mm_split_tf32, mm_tf32, mma_m16n8k8,
                                      tf32)

REPO = Path(__file__).resolve().parents[1]
BWD_TOL = runpy.run_path(str(REPO / "chip_smoke.py"),
                         run_name="chip_smoke_import")["BWD_TOL"]
F32_TOL = BWD_TOL[torch.float32]
BF16_TOL = BWD_TOL[torch.bfloat16]
BR = 64                     # rows a block owns (q rows in K3, keys in K2)


@pytest.fixture(autouse=True)
def interpret_mode():
    old = jfa._INTERPRET
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = old


def _pad(x, n, axis=2):
    """Zero rows up to n along ``axis``, as the kernels' copies fill them."""
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n - x.shape[axis])
    return np.pad(x, pad)


def _mask(q_pos, k_pos, sq, sk, causal):
    ok = (q_pos[:, None] < sq) & (k_pos[None, :] < sk)
    return ok & (q_pos[:, None] >= k_pos[None, :]) if causal else ok


def _t(x):
    return np.swapaxes(x, -1, -2)


def k3_tile(q, do, lse, delta, kt, vt, q_pos, k_pos, sq, sk, causal, scale,
            mm):
    """One key tile of K3 for a block's q rows: ds, the select after the
    exp included.  lse/delta: (..., rows) as staged (0 past Sq)."""
    s = mm(q, _t(kt))
    dp = mm(do, _t(vt))
    p = np.exp(s * scale - lse[..., None], dtype=np.float32)
    p = np.where(_mask(q_pos, k_pos, sq, sk, causal), p, np.float32(0))
    return (p * (dp - delta[..., None]) * scale).astype(np.float32)


def k2_tile(k, v, qt, dot, lse, delta, k_pos, q_pos, sq, sk, causal, scale,
            mm):
    """One q tile of K2 for a block's keys: (pᵀ, dsᵀ), with lse and delta
    per q column.  lse/delta: (..., tile rows) as staged (0 past Sq)."""
    st = mm(k, _t(qt))
    dpt = mm(v, _t(dot))
    pt = np.exp(st * scale - lse[..., None, :], dtype=np.float32)
    pt = np.where(_mask(q_pos, k_pos, sq, sk, causal).T, pt, np.float32(0))
    dst = (pt * (dpt - delta[..., None, :]) * scale).astype(np.float32)
    return pt, dst


def emulate_backward(q, k, v, out, lse, do, causal, mm, mm_grad=None, bk=32,
                     bq=32):
    """K2 and K3 as the kernels compute them, with the score-shaped
    products ``mm`` and the gradient products ``mm_grad`` (default ``mm``):
    blocks of 64 rows, inner tiles of ``bk`` keys (K3) and ``bq`` q rows
    (K2; both 32 at f32 D = 128), each tile's product added to the running
    sums in fp32.
    (B, H, S, D) float32 -> (dq, dk, dv)."""
    mm_grad = mm_grad or mm
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = np.float32(1.0 / np.sqrt(d))
    delta = (do * out).sum(-1, dtype=np.float32)
    nq = -(-sq // BR) * BR
    nk = -(-sk // BR) * BR
    qp, dop = _pad(q, nq), _pad(do, nq)
    lsep, deltap = _pad(lse, nq), _pad(delta, nq)       # staged as 0
    kp, vp = _pad(k, nk), _pad(v, nk)
    dq = np.zeros(qp.shape, np.float32)
    for q0 in range(0, nq, BR):
        rows = slice(q0, q0 + BR)
        q_pos = np.arange(q0, q0 + BR)
        for k0 in range(0, -(-sk // bk) * bk, bk):
            if causal and k0 > min(q0 + BR, sq) - 1:
                break                                  # _causal_hi
            cols = slice(k0, k0 + bk)
            ds = k3_tile(qp[:, :, rows], dop[:, :, rows], lsep[:, :, rows],
                         deltap[:, :, rows], kp[:, :, cols], vp[:, :, cols],
                         q_pos, np.arange(k0, k0 + bk), sq, sk, causal,
                         scale, mm)
            dq[:, :, rows] += mm_grad(ds, kp[:, :, cols])
    dk = np.zeros(kp.shape, np.float32)
    dv = np.zeros(kp.shape, np.float32)
    for k0 in range(0, nk, BR):
        keys = slice(k0, k0 + BR)
        k_pos = np.arange(k0, k0 + BR)
        lo = k0 // bq if causal else 0
        for q0 in range(lo * bq, nq, bq):
            if q0 >= sq:
                break
            rows = slice(q0, q0 + bq)
            pt, dst = k2_tile(kp[:, :, keys], vp[:, :, keys], qp[:, :, rows],
                              dop[:, :, rows], lsep[:, :, rows],
                              deltap[:, :, rows], k_pos,
                              np.arange(q0, q0 + bq), sq, sk, causal, scale,
                              mm)
            dv[:, :, keys] += mm_grad(pt, dop[:, :, rows])
            dk[:, :, keys] += mm_grad(dst, qp[:, :, rows])
    return dq[:, :, :sq], dk[:, :, :sk], dv[:, :, :sk]


def _inputs(shape, sk, seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    b, h, sq, d = shape
    q = rs.randn(b, h, sq, d).astype(dtype)
    k = rs.randn(b, h, sk, d).astype(dtype)
    v = rs.randn(b, h, sk, d).astype(dtype)
    do = rs.randn(b, h, sq, d).astype(dtype)
    return q, k, v, do


def _plain(q, k, v, do, causal, dtype=torch.float32):
    """(out, lse) and (dq, dk, dv) of the plain versions, as numpy."""
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    out, lse = tfa.flash_forward_plain(tq, tk, tv, causal=causal)
    grads = tfa.flash_backward_plain(tq, tk, tv, out, lse, tdo,
                                     causal=causal)
    return (out.float().numpy(), lse.numpy(),
            [g.float().numpy() for g in grads])


def _within(got, want, tol):
    return all(np.allclose(a, b, rtol=tol["rtol"], atol=tol["atol"])
               for a, b in zip(got, want))


# --------------------------------------------------------------------- #
# (a) split TF32 keeps the f32 limit, one TF32 pass does not             #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [False, True])
def test_split_tf32_backward_matches_pallas_interpret(causal):
    q, k, v, do = _inputs((1, 2, 256, 128), 256, 11)
    cfg = jfa._Config(causal, 1 / np.sqrt(128), 128, 128, True)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    assert jfa._pallas_ok(jq, jk, cfg)
    out, (_, _, _, _, lse) = jfa._flash_fwd(cfg, jq, jk, jv)
    want = [np.asarray(g) for g in jfa._bwd_pallas(jq, jk, jv, out, lse,
                                                    jdo, cfg)]
    out, lse = np.asarray(out), np.asarray(lse)
    got = emulate_backward(q, k, v, out, lse, do, causal, mm_split_tf32)
    assert _within(got, want, F32_TOL)
    one_pass = emulate_backward(q, k, v, out, lse, do, causal, mm_tf32)
    assert not _within(one_pass, want, F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(512, 512), (300, 300), (200, 328),
                                   (384, 128)])
def test_split_tf32_backward_keeps_the_f32_limit_and_tf32_misses_it(
        causal, sq, sk):
    # the main path's head shape, randn as the card's comparison draws it
    q, k, v, do = _inputs((1, 2, sq, 128), sk, 12 + sq + sk)
    out, lse, want = _plain(q, k, v, do, causal)
    got = emulate_backward(q, k, v, out, lse, do, causal, mm_split_tf32)
    assert all(np.isfinite(g).all() for g in got)
    assert _within(got, want, F32_TOL)
    err = max(np.abs(a - b).max() for a, b in zip(got, want))
    assert err < 2e-5
    one_pass = emulate_backward(q, k, v, out, lse, do, causal, mm_tf32)
    assert not _within(one_pass, want, F32_TOL)
    assert max(np.abs(a - b).max() for a, b in zip(one_pass, want)) > \
        10 * err


def test_split_tf32_backward_matches_the_reference_blockwise_ragged():
    q, k, v, do = _inputs((1, 2, 200, 64), 72, 13)
    cfg = jfa._Config(True, 1 / np.sqrt(64), 128, 128, False)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out, lse = jfa._fwd_blockwise(jq, jk, jv, cfg)
    want = [np.asarray(g) for g in jfa._flash_bwd(
        cfg, (jq, jk, jv, out, lse), jnp.asarray(do))]
    got = emulate_backward(q, k, v, np.asarray(out), np.asarray(lse), do,
                           True, mm_split_tf32, bk=64, bq=32)
    assert _within(got, want, F32_TOL)


# --------------------------------------------------------------------- #
# (b) K2's layouts: Sᵀ per 16-key warp, per-column lse and delta,        #
#     the permuted contraction into dV and dK                            #
# --------------------------------------------------------------------- #
def _a_frags(rows, c):
    """m16n8k8 A fragments of 16 rows x columns c..c+7 (row major)."""
    return [(rows[g, c + t], rows[g + 8, c + t], rows[g, c + t + 4],
             rows[g + 8, c + t + 4]) for _, g, t in _lanes()]


def _row_product(a_rows, b_rows):
    """a_rows (16 x D) . b_rows (N x D)ᵀ on m16n8k8 fragments: the B
    fragment of chunk j takes rows 8j + g of the tile, b0 at column c + t,
    b1 at c + t + 4 (the kernel's row_products)."""
    n, d = b_rows.shape
    frags = [[(0.0,) * 4] * 32 for _ in range(n // 8)]
    for c in range(0, d, 8):
        a = _a_frags(a_rows, c)
        for j in range(n // 8):
            b = [(b_rows[8 * j + g, c + t], b_rows[8 * j + g, c + t + 4])
                 for _, g, t in _lanes()]
            step = mma_m16n8k8(a, b)
            frags[j] = [tuple(x + y for x, y in zip(f, s))
                        for f, s in zip(frags[j], step)]
    return frags


def _gradient_product(p_frags, b_rows):
    """(16 x N) in accumulator fragments . b_rows (N x D): the permuted
    contraction, a = (c0, c2, c1, c3), b0 = row 2t, b1 = row 2t+1 of each
    8-row chunk, column 8n + g (the kernel's accumulate)."""
    n, d = b_rows.shape
    out = np.zeros((16, d))
    for j, pf in enumerate(p_frags):
        a = [(f[0], f[2], f[1], f[3]) for f in pf]
        chunk = b_rows[8 * j:8 * j + 8]
        for n0 in range(d // 8):
            b = [(chunk[2 * t, 8 * n0 + g], chunk[2 * t + 1, 8 * n0 + g])
                 for _, g, t in _lanes()]
            out[:, 8 * n0:8 * n0 + 8] += from_acc_frags(mma_m16n8k8(a, b))
    return out


def test_k2_fragments_per_column_lse_and_permuted_contraction():
    rs = np.random.RandomState(14)
    d, bq = 32, 16                          # one warp's 16 keys, one q tile
    kw, vw = (tf32(rs.randn(16, d).astype(np.float32)) for _ in range(2))
    qt, dot = (tf32(rs.randn(bq, d).astype(np.float32)) for _ in range(2))
    lse = rs.randn(bq) + 3.0
    delta = rs.randn(bq)
    scale = 1 / np.sqrt(d)
    st = _row_product(kw, qt)                # Sᵀ = K Qᵀ (keys x q)
    dpt = _row_product(vw, dot)              # dPᵀ = V dOᵀ
    pt_f, dst_f = [], []
    for j in range(bq // 8):
        pf, df = [], []
        for (lane, g, t), s, dp in zip(_lanes(), st[j], dpt[j]):
            # the thread's q columns: 2t and 2t+1 of chunk j, for e % 2
            cols = [8 * j + 2 * t + e % 2 for e in range(4)]
            p = [np.exp(s[e] * scale - lse[cols[e]]) for e in range(4)]
            pf.append(tuple(p))
            df.append(tuple(p[e] * (dp[e] - delta[cols[e]]) * scale
                            for e in range(4)))
        pt_f.append(pf)
        dst_f.append(df)
    got_dv = _gradient_product(pt_f, dot)
    got_dk = _gradient_product(dst_f, qt)
    k64, q64 = kw.astype(np.float64), qt.astype(np.float64)
    pt = np.exp(k64 @ q64.T * scale - lse[None, :])
    dst = pt * (vw.astype(np.float64) @ dot.astype(np.float64).T
                - delta[None, :]) * scale
    np.testing.assert_allclose(got_dv, pt @ dot, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_dk, dst @ q64, rtol=1e-12, atol=1e-12)
    # lse indexed per row instead of per column is a different product
    wrong = np.exp(k64 @ q64.T * scale - lse[:16, None]) @ dot
    assert not np.allclose(got_dv, wrong)


def test_k3_row_layout_is_k1s_scores_and_pv_with_one_more_product():
    rs = np.random.RandomState(15)
    d, bk = 16, 16
    qw, dow = (tf32(rs.randn(16, d).astype(np.float32)) for _ in range(2))
    kt, vt = (tf32(rs.randn(bk, d).astype(np.float32)) for _ in range(2))
    lse, delta = rs.randn(16) + 3.0, rs.randn(16)
    scale = 1 / np.sqrt(d)
    s, dp = _row_product(qw, kt), _row_product(dow, vt)
    ds = []
    for j in range(bk // 8):
        # the thread's q rows: g for e < 2, g + 8 for e >= 2
        ds.append([tuple(np.exp(sv[e] * scale - lse[g + 8 * (e // 2)])
                         * (dv[e] - delta[g + 8 * (e // 2)]) * scale
                         for e in range(4))
                   for (_, g, t), sv, dv in zip(_lanes(), s[j], dp[j])])
    got = _gradient_product(ds, kt)
    q64 = qw.astype(np.float64)
    p = np.exp(q64 @ kt.T.astype(np.float64) * scale - lse[:, None])
    want = p * (dow.astype(np.float64) @ vt.T.astype(np.float64)
                - delta[:, None]) * scale @ kt.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------------- #
# (c) bf16: P and dS split into two bf16 halves                          #
# --------------------------------------------------------------------- #
def mm_bf16_split_a(a, b):
    """A gradient product of the bf16 kernels: a (fp32 P or dS) split as
    a_hi = bf16(a), a_lo = bf16(a - a_hi), against the bf16 operand b."""
    hi = bf16(a)
    lo = bf16(a - hi)
    return mm_fp32(lo, b) + mm_fp32(hi, b)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,s,bk,bq", [(128, 160, 32, 16), (64, 100, 64, 32)])
def test_split_bf16_backward_stays_within_the_bf16_limit(causal, d, s, bk,
                                                         bq):
    q, k, v, do = (bf16(a) for a in _inputs((1, 2, s, d), s, 16 + d))
    out, lse, want = _plain(q, k, v, do, causal, torch.bfloat16)
    # S and dP: exact products of bf16 values, fp32 sums
    got = [bf16(g) for g in emulate_backward(
        q, k, v, bf16(out), lse, do, causal, mm_fp32, mm_bf16_split_a,
        bk=bk, bq=bq)]
    assert _within(got, want, BF16_TOL)
    # the split keeps P and dS to ~16 bits: far inside one bf16 rounding
    exact = emulate_backward(q, k, v, bf16(out), lse, do, causal, mm_fp32,
                             bk=bk, bq=bq)
    for a, e in zip(got, exact):
        assert np.abs(a - e).max() <= np.abs(e).max() * 2.0 ** -7


# --------------------------------------------------------------------- #
# (d) the select after the exp                                           #
# --------------------------------------------------------------------- #
def test_rows_past_sq_and_masked_keys_give_finite_zeros():
    sq, sk, d = 20, 24, 64
    q, k, v, do = _inputs((1, 1, sq, d), sk, 17)
    # keys 20..23 lie after every q row: each of their pairs is masked,
    # and they score far above any row's lse
    k[:, :, sq:] *= 200.0
    out, lse, want = _plain(q, k, v, do, True)
    scale = np.float32(1 / np.sqrt(d))
    delta = (do * out).sum(-1, dtype=np.float32)
    # K2's first tile, padded as the kernel stages it: q rows past Sq are
    # zero with lse = delta = 0, keys past Sk zero
    qt, dot = _pad(q, 32), _pad(do, 32)
    lt, dt = _pad(lse, 32), _pad(delta, 32)
    kb, vb = _pad(k, BR), _pad(v, BR)
    q_pos, k_pos = np.arange(32), np.arange(BR)
    with np.errstate(over="ignore"):
        raw = np.exp(mm_fp32(kb, _t(qt)) * scale - lt[..., None, :],
                     dtype=np.float32)
        assert np.isinf(raw).any()  # masked pairs overflow before the select
        with np.errstate(invalid="ignore"):
            by_product = raw * _mask(q_pos, k_pos, sq, sk, True).T
        assert np.isnan(by_product).any()                   # inf * 0
        pt, dst = k2_tile(kb, vb, qt, dot, lt, dt, k_pos, q_pos, sq, sk, True,
                          scale, mm_split_tf32)
        assert np.isfinite(pt).all() and np.isfinite(dst).all()
        assert not pt[..., sq:].any() and not dst[..., sq:].any()   # rows > Sq
        assert not pt[..., sk:, :].any()                            # keys > Sk
        assert not np.tril(pt[0, 0, :sq, :sq], -1).any()            # future
    with np.errstate(over="ignore"):
        got = emulate_backward(q, k, v, out, lse, do, True, mm_split_tf32)
    assert all(np.isfinite(g).all() for g in got)
    assert _within(got, want, F32_TOL)
