#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``).

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases (each raises on failure; the script exits 0 only if all pass):

  1. build   — compile every kernel of the port from ``bigdl_tpu_torch/csrc``
               with nvcc for sm_90a (one nvcc per source, all at once).
  2. kernels — each kernel against its plain PyTorch version on the card,
               on the same inputs, with the tolerance stated; times of the
               kernel, the plain version and one PyTorch library call,
               and the bound for the work at the serving shape.
  3. slice   — TransformerLM ``base`` (d_model 768, 12 layers, 6 heads of
               128, vocab 32000, fp32, weights from a seed) registered in
               a ``ModelRegistry`` and served by ``ServingEngine(max_batch=8)``
               to 12 requests of 1-5 rows of 512 tokens from 3 client
               threads.  Every answer is checked against the same model
               run directly on the card with the plain attention.  The
               launch counts show that every batch went through the kernel.

Output: a ``{"slice": {...}}`` line, a ``{"kernels": [...]}`` line, the
card's name and power limit as nvidia-smi gives them, and last
``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repo, it exits with
another code and prints no result.

fp32 matmuls run in full fp32: TF32 is switched off explicitly for
cuBLAS and cuDNN (the model's dtype is float32).
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

H100_FP32_FLOPS = 67e12       # data sheet, SXM, CUDA cores, 700 W
H100_BF16_FLOPS = 989e12      # data sheet, SXM, dense tensor cores, 700 W
H100_HBM_BYTES_S = 3.35e12    # data sheet, SXM
N_REQUESTS, N_CLIENTS, SEQ = 12, 3, 512
MODEL_TOL = dict(rtol=1e-3, atol=1e-3)
KERNEL_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
              torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
LSE_TOL = dict(rtol=1e-4, atol=1e-3)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def attention_bound(b, h, sq, sk, d, causal, dtype):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move (q, k, v read once, out and lse written once) over the HBM rate
    and the multiply-adds of the (q, k) pairs this mask attends (two
    products, 4·D operations a pair) over the peak rate of the dtype."""
    if causal:
        pairs = sum(min(i + 1, sk) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 4 * b * h * d * pairs
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * b * h * d * (2 * sq + 2 * sk) + 4 * b * h * sq
    peak = H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --------------------------------------------------------------------- #
def phase_build():
    from bigdl_tpu_torch.ops import _build
    t0 = time.monotonic()
    _build.build_all(["flash_fwd"])
    secs = time.monotonic() - t0
    log(f"build: {secs:.1f} s")
    for line in _build.build_log("flash_fwd").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")
    return secs


def _qkv(b, h, sq, sk, d, dtype, seed, layout="contig"):
    """q, k, v of shape (B, H, S, D).  ``layout``: "contig" (all three
    contiguous), "strided" (all three (B, S, H, D) storage seen as
    (B, H, S, D)) or "main" (the model's own: RoPE hands q and k over
    contiguous, v is the strided view of its projection)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def one(s, strided):
        if strided:
            t = torch.randn((b, s, h, d), generator=g, device="cuda")
            return t.to(dtype).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=g, device="cuda").to(dtype)
    qk_strided = layout == "strided"
    v_strided = layout in ("strided", "main")
    return (one(sq, qk_strided), one(sk, qk_strided), one(sk, v_strided))


def _compare(fa, q, k, v, causal):
    """flash_fwd against its plain version on one input:
    (max_abs_err, lse_max_abs_err, tolerance, ok)."""
    out, lse = fa.flash_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_forward_plain(q, k, v, causal=causal)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    tol = KERNEL_TOL[q.dtype]
    ok = (torch.isfinite(out.float()).all().item()
          and torch.allclose(out.float(), ref.float(), **tol)
          and torch.allclose(lse, ref_lse, **LSE_TOL))
    return err, lse_err, tol, bool(ok)


def phase_kernels(card: str):
    from bigdl_tpu_torch.ops import flash_attention_mod as fa
    cases = [
        # (label, B, H, Sq, Sk, D, dtype, causal, layout)
        ("slice f32 causal", 8, 6, 512, 512, 128, torch.float32, True,
         "main"),
        ("slice bf16 causal", 8, 6, 512, 512, 128, torch.bfloat16, True,
         "main"),
        ("slice f32 causal, q/k/v all strided", 8, 6, 512, 512, 128,
         torch.float32, True, "strided"),
        ("f32 non-causal", 8, 6, 512, 512, 128, torch.float32, False,
         "contig"),
        ("ragged S=300 f32 causal", 2, 6, 300, 300, 128, torch.float32, True,
         "contig"),
        ("ragged S=300 bf16 non-causal", 2, 6, 300, 300, 128, torch.bfloat16,
         False, "contig"),
        ("head_dim 64 f32 causal", 4, 8, 512, 512, 64, torch.float32, True,
         "contig"),
        ("head_dim 64 bf16 ragged S=300 causal", 2, 4, 300, 300, 64,
         torch.bfloat16, True, "strided"),
        ("cross Sq=128 Sk=384 f32 causal", 2, 2, 128, 384, 128,
         torch.float32, True, "contig"),
    ]
    results = []
    for i, (label, b, h, sq, sk, d, dt, causal, layout) in enumerate(cases):
        q, k, v = _qkv(b, h, sq, sk, d, dt, seed=100 + i, layout=layout)
        err, lse_err, tol, ok = _compare(fa, q, k, v, causal)
        results.append({"case": label, "shape": [b, h, sq, sk, d],
                        "dtype": str(dt).replace("torch.", ""),
                        "causal": causal, "layout": layout,
                        "max_abs_err": err, "lse_max_abs_err": lse_err,
                        "tolerance": tol, "ok": ok})
        log(f"kernel vs plain [{label}]: max_abs_err {err:.3e} "
            f"(lse {lse_err:.3e}) tol {tol} -> {'ok' if ok else 'FAIL'}")
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_fwd disagrees with its plain version: "
                             f"{bad}")

    # times at the serving shape (B=8 bucket, H=6, S=512, D=128, causal)
    q, k, v = _qkv(8, 6, SEQ, SEQ, 128, torch.float32, seed=7, layout="main")
    ms = cuda_ms(lambda: fa.flash_forward(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: fa.flash_forward_plain(q, k, v, causal=True),
                       iters=5)
    library_ms = cuda_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(q, k, v,
                                                       is_causal=True))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    bf16_ms = cuda_ms(lambda: fa.flash_forward(qb, kb, vb, causal=True))
    bound_ms, bound_by = attention_bound(8, 6, SEQ, SEQ, 128, True,
                                         torch.float32)
    bf16_bound, bf16_by = attention_bound(8, 6, SEQ, SEQ, 128, True,
                                          torch.bfloat16)
    log(f"flash_fwd f32 (8,6,512,128) causal: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by}); bf16 kernel {bf16_ms:.4f} ms, bound "
        f"{bf16_bound:.4f} ms ({bf16_by}); {card}")
    main = results[0]
    return {"name": "flash_fwd", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "bigdl_tpu/ops/flash_attention.py:212",
            "launches": None, "max_abs_err": main["max_abs_err"],
            "tolerance": main["tolerance"], "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_call": "torch.nn.functional.scaled_dot_product_attention"
                            "(is_causal=True), f32",
            "shape": [8, 6, SEQ, SEQ, 128], "dtype": "float32",
            "bf16_ms": bf16_ms, "bf16_bound_ms": bf16_bound,
            "cases": results, "card": card}


# --------------------------------------------------------------------- #
def phase_slice(card: str):
    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.ops import flash_attention_mod as fa
    from bigdl_tpu_torch.ops.flash_attention import flash_forward_plain
    from bigdl_tpu_torch.serving import ModelRegistry, ServingEngine

    t0 = time.monotonic()
    model = T.build("base", device="cuda", seed=0)
    cfg = model.cfg
    n_layers = cfg.n_layers
    reg = ModelRegistry()
    reg.register("lm", model, input_shape=(SEQ,), dtype=np.int32)
    eng = ServingEngine(reg, max_batch=8)
    log(f"model built on {reg.get('lm').device}: {cfg}, "
        f"{sum(p.numel() for p in model.parameters())} params, "
        f"{time.monotonic() - t0:.1f} s")

    rs = np.random.RandomState(0)
    rows = rs.randint(1, 6, N_REQUESTS)
    xs = [rs.randint(0, cfg.vocab_size, (int(n), SEQ)).astype(np.int32)
          for n in rows]
    results = [None] * N_REQUESTS
    errors = []

    def client(c):
        try:
            for i in range(c, N_REQUESTS, N_CLIENTS):
                results[i] = eng.submit("lm", xs[i]).result(timeout=300)
        except Exception as e:   # reported below, fails the phase
            errors.append(repr(e))

    torch.cuda.reset_peak_memory_stats()
    # the main path: counts from 0, warmup included
    fa.reset_launch_count()
    t_w = time.monotonic()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t_w
    warm_launches = fa.launch_count()
    t_s = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.monotonic() - t_s
    launches = fa.launch_count()
    st = eng.stats()
    eng.shutdown(drain=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serving failed: {errors}")
    n_buckets = len(eng.ladder)
    if warm_launches != n_layers * n_buckets:
        raise AssertionError(f"warmup launched flash_fwd {warm_launches} "
                             f"times, expected {n_layers} x {n_buckets}")
    if st["recompiles"] != 0 or st["errors"] != 0:
        raise AssertionError(f"serving stats: {st}")
    served = launches - warm_launches
    if served != n_layers * st["batches"] or st["batches"] < 1:
        raise AssertionError(f"flash_fwd launched {served} times after "
                             f"warmup for {st['batches']} batches; expected "
                             f"{n_layers} per batch")

    # every answer against the same model with the plain attention; the
    # first layer's q, k, v of the largest request are kept, to hold the
    # kernel against its plain version on exactly what the model hands it
    captured = {}

    def plain_attention(q, k, v):
        return flash_forward_plain(q, k, v, causal=True)[0]

    def plain_attention_capture(q, k, v):
        if q.shape[0] == int(rows.max()) and not captured:
            captured.update(q=q.clone(memory_format=torch.preserve_format),
                            k=k.clone(memory_format=torch.preserve_format),
                            v=v.clone(memory_format=torch.preserve_format))
        return plain_attention(q, k, v)

    for blk in model.blocks:
        blk.attn.attention_fn = plain_attention
    model.blocks[0].attn.attention_fn = plain_attention_capture
    worst = 0.0
    with torch.inference_mode():
        params = model.param_dict()
        for i, (x, y) in enumerate(zip(xs, results)):
            if y.shape != (len(x), SEQ, cfg.vocab_size):
                raise AssertionError(f"request {i}: shape {y.shape}")
            got = torch.from_numpy(y).cuda()
            if not torch.isfinite(got).all():
                raise AssertionError(f"request {i}: non-finite logits")
            want, _ = model.run(params, torch.from_numpy(x).cuda())
            worst = max(worst, (got - want).abs().max().item())
            if not torch.allclose(got, want, **MODEL_TOL):
                raise AssertionError(f"request {i}: served logits differ "
                                     f"from the plain-attention run by "
                                     f"{worst:.3e}")
            results[i] = None
    for blk in model.blocks:
        blk.attn.attention_fn = None
    q, k, v = captured["q"], captured["k"], captured["v"]
    with torch.inference_mode():
        err, lse_err, tol, ok = _compare(fa, q, k, v, causal=True)
    layer_case = {"case": "served layer 0 q/k/v",
                  "shape": [q.shape[0], q.shape[1], SEQ, SEQ, q.shape[3]],
                  "dtype": "float32", "causal": True,
                  "strides": [list(t.stride()) for t in (q, k, v)],
                  "max_abs_err": err, "lse_max_abs_err": lse_err,
                  "tolerance": tol, "ok": ok}
    log(f"kernel vs plain [served layer 0 q/k/v, strides "
        f"{layer_case['strides']}]: max_abs_err {err:.3e} (lse "
        f"{lse_err:.3e}) tol {tol} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_fwd disagrees with its plain version on "
                             "the served layer's q, k, v")
    del captured, q, k, v

    # where a full batch's time goes (after the counts were read)
    with torch.inference_mode():
        x8 = torch.from_numpy(
            rs.randint(0, cfg.vocab_size, (8, SEQ)).astype(np.int32)).cuda()
        fwd_ms = cuda_ms(lambda: model.run(params, x8), iters=5, warm=1)
        y8, _ = model.run(params, x8)
        d2h_ms = cuda_ms(lambda: y8.cpu(), iters=3, warm=1)
        pinned = torch.empty(y8.shape, dtype=y8.dtype, pin_memory=True)
        pinned_d2h_ms = cuda_ms(lambda: pinned.copy_(y8), iters=3, warm=1)
        del y8, pinned
    breakdown = {"forward_ms_b8": fwd_ms, "d2h_pageable_ms_b8": d2h_ms,
                 "d2h_pinned_ms_b8": pinned_d2h_ms,
                 "execute_span_s": eng.recorder.span_value("serving.execute")}
    tokens = int(rows.sum()) * SEQ
    out = {"requests": N_REQUESTS, "rows": int(rows.sum()),
           "batches": int(st["batches"]), "batch_fill": st.get("batch_fill"),
           "recompiles": int(st["recompiles"]), "warmup_s": warm_s,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "p50_ms": st.get("p50_ms"), "p99_ms": st.get("p99_ms"),
           "launches": launches, "launches_after_warmup": served,
           "max_abs_err_vs_plain": worst, "tolerance": MODEL_TOL,
           "peak_mem_gb": peak_gb, "breakdown": breakdown,
           "layer_case": layer_case, "card": card}
    log(f"slice: {json.dumps(out)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU", file=sys.stderr)
        return 1
    # the model's dtype is float32: full-precision matmuls, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    build_s = phase_build()
    kernel = phase_kernels(card)
    kernel["build_s"] = build_s
    slice_ = phase_slice(card)
    kernel["launches"] = slice_["launches"]
    kernel["cases"].append(slice_["layer_case"])
    log(f"total {time.monotonic() - t0:.1f} s")
    print(json.dumps({"slice": slice_}), flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
