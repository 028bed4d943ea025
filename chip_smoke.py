#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``).

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases (each raises on failure; the script exits 0 only if all pass):

  1. build    — compile every kernel of the port from ``bigdl_tpu_torch/csrc``
                with nvcc for sm_90a (one nvcc per source, all at once);
                print ptxas's registers and spills (a spill in K1, K2 or
                K3 fails) and the HMMA instructions of K1, K2 and K3 from
                ``cuobjdump -sass`` (a kernel without any fails).
  2. kernels  — each kernel against its plain PyTorch version on the card,
                on the same inputs, with the tolerance stated; times of the
                kernel, the plain version and one PyTorch library call,
                and the bound for the work at the main path's shape:
                K1 flash_fwd (ten cases, one with q/k/v one element into
                their storage so that the kernel takes 4-byte copies; the
                plain forward on TF32 must fail K1's f32 limit; f32 and
                bf16 times beside SDPA's and the split-TF32 floor); K2
                flash_bwd_dkv and K3 flash_bwd_dq (thirteen cases, three
                with q/k/v/do one or two elements into their storage, so
                that the kernels take 4-byte copies or the wrapper copies
                a bf16 operand below 4-byte alignment; the plain backward
                on TF32 must fail the f32 limit; two runs on the same
                inputs must give the same bits; f32 and bf16 times beside
                SDPA's backward and the split-TF32 floor); K4
                fused_adam (bitwise, Adam and AdamW: single leaves, all
                111 of base's leaf shapes in one launch, more leaves than
                one table holds, a leaf at a 4-byte offset, ragged tails,
                an empty leaf and channels-last conv gradients, with
                their launch counts; timed by events with the host, with
                the host queued ahead and cold, beside
                torch.optim.AdamW(fused=True) read the same ways, with
                the wrapper's host time by part); K5 fused_sgd_mom and K6
                fused_sgd_plain (bitwise, over every static choice:
                dampening, nesterov, weight decay; one leaf at a time,
                and trees of many leaves with their launch counts: six
                shapes in one launch, leaves at a 4-byte offset,
                channels-last conv gradients read in place, and more
                leaves than one launch's table holds).  K5, K6 and their
                library call are also timed on the device with a cold
                L2 (a 256 MB read before each call), beside the rate a
                plain copy reaches, back to back over two alternating
                trees (events beside CUPTI), and the profiler's raw device
                records of one cold call.  One SGD.update and one
                AdamW.update run under
                ``torch.cuda.set_sync_debug_mode("error")``: neither may
                synchronize the host.
  3. serving  — TransformerLM ``base`` (d_model 768, 12 layers, 6 heads of
                128, vocab 32000, fp32, weights from a seed) registered in
                a ``ModelRegistry`` and served by ``ServingEngine(max_batch=8)``
                to 12 requests of 1-5 rows of 512 tokens from 3 client
                threads.  Every answer is checked against the same model
                run directly on the card with the plain attention.  The
                launch counts show that every batch went through K1.
  4. training — the same ``base`` trained by ``SpmdTrainer`` with
                ``AdamW(learning_rate=3e-4, fused=True)`` for 6 steps on
                one repeated batch of 8 x 512 tokens, and again from the
                same weights with the plain attention (forward and
                backward) and ``fused=False``.  Step-1 gradients and every
                step's loss of the two runs agree within the stated
                tolerance, the loss falls, and the launch counts show that
                each step ran K1, K2 and K3 once a layer and K4 once
                (one multi-tensor launch per table of
                fused_optim.ADAM_CAPACITY leaves).  The same steps with the matmuls on TF32 must fall
                outside the limits, so that the limits can see a drop
                below fp32.
  5. classifier — ResNet-50 (ImageNet, NHWC, 1000 classes, full width and
                depth, fp32, weights from a seed) trained by
                ``LocalOptimizer`` with ``SGD(learning_rate=0.1,
                momentum=0.9, weight_decay=1e-4, fused=True)`` for 6 steps
                on one repeated batch of 64 synthetic 224x224x3 images,
                and again from the same weights with ``fused=False`` (twice,
                for the run-to-run noise) and with TF32 convolutions, which
                must fall outside the training phase's loss limit (2e-5);
                the fp32 runs must agree to the last bit.  K5 must launch
                once a step over all 161 leaves (one multi-tensor launch
                per table of fused_optim.SGD_CAPACITY leaves) and the loss
                must fall; K5 is also held bitwise on the model's own
                step-1 gradients, whose 17 channels-last conv gradients
                must be read in place (no copy).  Then LeNet-5 with
                ``SGD(learning_rate=0.05, fused=True)`` at batch 128 over
                512 images for 2 epochs on K6 (one launch a step over its
                8 leaves), against ``fused=False`` (bitwise).  cuDNN runs
                deterministic algorithms chosen without benchmarking.

Output: a ``{"slice": {...}}`` line, a ``{"training": {...}}`` line, a
``{"classifier": {...}}`` line, a ``{"host_sync": {...}}`` line, a
``{"kernels": [...]}`` line (all six
kernels), the card's name and power limit as nvidia-smi gives them, and
last ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repo, it exits with
another code and prints no result.

fp32 matmuls and convolutions run in full fp32: TF32 is switched off
explicitly for cuBLAS and cuDNN (the models' dtype is float32).
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

H100_FP32_FLOPS = 67e12       # data sheet, SXM, CUDA cores, 700 W
H100_BF16_FLOPS = 989e12      # data sheet, SXM, dense tensor cores, 700 W
H100_TF32_FLOPS = 495e12      # data sheet, SXM, dense tensor cores, 700 W
H100_HBM_BYTES_S = 3.35e12    # data sheet, SXM
N_REQUESTS, N_CLIENTS, SEQ = 12, 3, 512
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 8, 6, 3e-4
MODEL_TOL = dict(rtol=1e-3, atol=1e-3)
KERNEL_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
              torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
LSE_TOL = dict(rtol=1e-4, atol=1e-3)
# K2/K3 against the plain backward: both sum fp32 products, in another
# order, over up to 512 terms (gradients are O(1)-O(10) at these inputs);
# bf16 outputs are one bf16 rounding (8 bits of mantissa) of the sum.
# The f32 limits are about 20x the worst reading of a sound run; a TF32
# run of the plain version must read above them (see tf32 below).
BWD_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# per gradient, max |d - d_plain| <= BWD_REL_TOL * max |d_plain|: for
# gradients far below 1 (those of a training step's mean loss)
BWD_REL_TOL = 1e-5
# kernel run against plain run of the training step (fp32, TF32 off): the
# attention differs by fp32 rounding only (~1e-6), which the 12 layers,
# the head and 6 AdamW steps carry into the loss (~10.9 at step 1, where
# one ulp is 9.5e-7).  Both limits are about 20x a sound run's reading
# and must fail a run with the model's matmuls on TF32.
GRAD_REL_TOL = 1e-4          # per leaf, max |dg| <= GRAD_REL_TOL * max |g|
LOSS_TOL = 2e-5              # |loss_kernel - loss_plain| per step


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


def queued_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Device time per call of ``fn`` by CUDA events, with the host ahead:
    the card first spins for ~30 ms, in which the host queues all ``iters``
    calls, so the host's time between calls is not counted where it is
    the slower side (as :func:`cuda_ms` counts it)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10 * SPIN_CYCLES)
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


def split_tf32_floor(b, h, sq, sk, d, causal):
    """The least time of the f32 forward on the tensor cores as K1 does
    it: three TF32 products for each fp32 one, at the TF32 peak."""
    flops = 4 * b * h * d * _pairs(sq, sk, causal)
    return 3 * flops / H100_TF32_FLOPS * 1e3


# --------------------------------------------------------------------- #
SOURCES = ("flash_fwd", "flash_bwd", "fused_adam", "fused_sgd")
MMA_SOURCES = ("flash_fwd", "flash_bwd")     # on the tensor cores


def phase_build():
    from bigdl_tpu_torch.ops import _build
    t0 = time.monotonic()
    libs = _build.build_all(SOURCES)
    secs = time.monotonic() - t0
    log(f"build: {secs:.1f} s")
    spills = []
    for name in SOURCES:
        for line in _build.build_log(name).splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling" in line):
                log(f"  ptxas [{name}]: {line.strip()}")
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
            if (name in MMA_SOURCES and found
                    and found.groups() != ("0", "0")):
                spills.append(f"{name}: {line.strip()}")
    if spills:
        raise AssertionError(f"a tensor-core kernel spills registers: "
                             f"{spills}")
    for name in MMA_SOURCES:
        log(f"sass of {name}: {sass_mma_counts(libs[name], name)}")
    return secs


def sass_mma_counts(lib, name: str) -> dict:
    """``{kernel: HMMA instructions}`` in the SASS of a built library, from
    ``cuobjdump -sass``; raises if a kernel has none."""
    import shutil
    from pathlib import Path
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {"cuobjdump": "not found"}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    if not counts or not all(counts.values()):
        raise AssertionError(f"{name}: a kernel without HMMA: {counts}")
    return counts


def _offset_view(shape, dtype, g, offset):
    """A contiguous randn tensor ``offset`` elements into its storage."""
    n = int(np.prod(shape))
    flat = torch.randn(n + offset, generator=g, device="cuda").to(dtype)
    return flat[offset:].view(*shape)


def _qkv(b, h, sq, sk, d, dtype, seed, layout="contig"):
    """q, k, v of shape (B, H, S, D).  ``layout``: "contig" (all three
    contiguous), "strided" (all three (B, S, H, D) storage seen as
    (B, H, S, D)), "main" (the model's own: RoPE hands q and k over
    contiguous, v is the strided view of its projection), "offset" or
    "offset2" (all three contiguous views one or two elements into their
    storage)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def one(s, strided):
        if layout in OFFSETS:
            return _offset_view((b, h, s, d), dtype, g, OFFSETS[layout])
        if strided:
            t = torch.randn((b, s, h, d), generator=g, device="cuda")
            return t.to(dtype).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=g, device="cuda").to(dtype)
    qk_strided = layout == "strided"
    v_strided = layout in ("strided", "main")
    return (one(sq, qk_strided), one(sk, qk_strided), one(sk, v_strided))


OFFSETS = {"offset": 1, "offset2": 2}


def fwd_ok(out, lse, ref, ref_lse):
    """``out`` and ``lse`` within K1's limits of the plain forward's."""
    return bool(torch.isfinite(out.float()).all().item()
                and torch.allclose(out.float(), ref.float(),
                                   **KERNEL_TOL[ref.dtype])
                and torch.allclose(lse, ref_lse, **LSE_TOL))


def _compare(fa, q, k, v, causal):
    """flash_fwd against its plain version on one input:
    (max_abs_err, lse_max_abs_err, tolerance, ok, plain out and lse)."""
    out, lse = fa.flash_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_forward_plain(q, k, v, causal=causal)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    return (err, lse_err, KERNEL_TOL[q.dtype],
            fwd_ok(out, lse, ref, ref_lse), (ref, ref_lse))


def tf32_fwd_reading(fa, q, k, v, causal, want):
    """The plain forward with its matmuls on TF32 tensor cores (one pass),
    read against K1's limits: a kernel that dropped below fp32 this way
    must fail them.  Returns (max_abs_err, lse_max_abs_err, passes)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out, lse = fa.flash_forward_plain(q, k, v, causal=causal)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ref, ref_lse = want
    return ((out.float() - ref.float()).abs().max().item(),
            (lse - ref_lse).abs().max().item(),
            fwd_ok(out, lse, ref, ref_lse))


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
        ("slice f32 causal, q/k/v one element into their storage", 8, 6,
         512, 512, 128, torch.float32, True, "offset"),
    ]
    results = []
    for i, (label, b, h, sq, sk, d, dt, causal, layout) in enumerate(cases):
        q, k, v = _qkv(b, h, sq, sk, d, dt, seed=100 + i, layout=layout)
        width = fa.copy_bytes(q, k, v)
        err, lse_err, tol, ok, want = _compare(fa, q, k, v, causal)
        case = {"case": label, "shape": [b, h, sq, sk, d],
                "dtype": str(dt).replace("torch.", ""), "causal": causal,
                "layout": layout, "copy_bytes": width, "max_abs_err": err,
                "lse_max_abs_err": lse_err, "tolerance": tol, "ok": ok}
        if i == 0:
            case["tf32"] = tf32_fwd_reading(fa, q, k, v, causal, want)
        results.append(case)
        log(f"kernel vs plain [{label}]: {width}-byte copies, max_abs_err "
            f"{err:.3e} (lse {lse_err:.3e}) tol {tol} -> "
            f"{'ok' if ok else 'FAIL'}")
        del want
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_fwd disagrees with its plain version: "
                             f"{bad}")
    widths = {r["copy_bytes"] for r in results}
    if widths != {4, 16}:
        raise AssertionError(f"flash_fwd cases took copy widths {widths}, "
                             f"not both 16 and 4 bytes")
    tf32_err, tf32_lse_err, tf32_passes = results[0]["tf32"]
    check_tf32_fails("K1 [slice f32 causal]",
                     {"max_abs_err": tf32_err, "lse_max_abs_err":
                      tf32_lse_err}, tf32_passes,
                     {"out": KERNEL_TOL[torch.float32], "lse": LSE_TOL})

    # times at the serving shape (B=8 bucket, H=6, S=512, D=128, causal)
    q, k, v = _qkv(8, 6, SEQ, SEQ, 128, torch.float32, seed=7, layout="main")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = cuda_ms(lambda: fa.flash_forward(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: fa.flash_forward_plain(q, k, v, causal=True),
                       iters=5)
    library_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    bf16_ms = cuda_ms(lambda: fa.flash_forward(qb, kb, vb, causal=True))
    bf16_library_ms = cuda_ms(lambda: sdpa(qb, kb, vb, is_causal=True))
    bound_ms, bound_by = attention_bound(8, 6, SEQ, SEQ, 128, True,
                                         torch.float32)
    tc_floor_ms = split_tf32_floor(8, 6, SEQ, SEQ, 128, True)
    bf16_bound, bf16_by = attention_bound(8, 6, SEQ, SEQ, 128, True,
                                          torch.bfloat16)
    log(f"flash_fwd f32 (8,6,512,128) causal: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by}), split-TF32 tensor-core floor {tc_floor_ms:.4f} "
        f"ms; bf16 kernel {bf16_ms:.4f} ms, sdpa {bf16_library_ms:.4f} ms, "
        f"bound {bf16_bound:.4f} ms ({bf16_by}); {card}")
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
            "split_tf32_floor_ms": tc_floor_ms,
            "bf16_ms": bf16_ms, "bf16_bound_ms": bf16_bound,
            "bf16_library_ms": bf16_library_ms,
            "cases": results, "card": card}


# --------------------------------------------------------------------- #
def _pairs(sq, sk, causal):
    return sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk


def bwd_bounds(b, h, sq, sk, d, causal, dtype):
    """{kernel: (bound_ms, bound_by)} for K2 and K3: the larger of the
    bytes each must move (q, k, v, do, lse and delta read once, its
    gradients written once) over the HBM rate, and its multiply-adds over
    the attended pairs (K2: four products, 8·D operations a pair; K3:
    three, 6·D) over the peak rate of the dtype."""
    item = torch.tensor([], dtype=dtype).element_size()
    pairs = _pairs(sq, sk, causal) * b * h
    peak = H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    qs, ks = b * h * sq * d * item, b * h * sk * d * item
    rows = 2 * 4 * b * h * sq
    out = {}
    for name, flops, nbytes in (
            ("flash_bwd_dkv", 8 * d * pairs, 2 * qs + 2 * ks + rows + 2 * ks),
            ("flash_bwd_dq", 6 * d * pairs, 2 * qs + 2 * ks + rows + qs)):
        t_ops = flops / peak * 1e3
        t_bytes = nbytes / H100_HBM_BYTES_S * 1e3
        out[name] = ((t_ops, "operations") if t_ops >= t_bytes
                     else (t_bytes, "bytes"))
    return out


def _grad_out(q, layout, seed):
    """A random output gradient of q's shape; for the model's layouts it
    is the (B, S, H, D)-storage view autograd hands the backward."""
    b, h, s, d = q.shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout in OFFSETS:
        return _offset_view(q.shape, q.dtype, g, OFFSETS[layout])
    if layout in ("main", "strided"):
        t = torch.randn((b, s, h, d), generator=g, device="cuda")
        return t.to(q.dtype).transpose(1, 2)
    return torch.randn((b, h, s, d), generator=g, device="cuda").to(q.dtype)


def grad_errors(got, want):
    """{name: (max |got - want|, max |want|)} for dq, dk, dv."""
    return {name: ((a.float() - r.float()).abs().max().item(),
                   r.float().abs().max().item())
            for name, a, r in zip(("dq", "dk", "dv"), got, want)}


def bwd_ok(got, want, errs, relative):
    """Finite and within BWD_TOL (allclose), or, when ``relative``, within
    BWD_REL_TOL of each gradient's own largest value."""
    if not all(torch.isfinite(a.float()).all().item() for a in got):
        return False
    if relative:
        return all(e <= BWD_REL_TOL * m for e, m in errs.values())
    tol = BWD_TOL[want[0].dtype]
    return all(torch.allclose(a.float(), r.float(), **tol)
               for a, r in zip(got, want))


def compare_bwd(fa, q, k, v, do, causal, relative=False):
    """K2 + K3 against the plain backward on one (q, k, v, out, lse, do):
    (max_abs_err over dq/dk/dv, {grad: (err, max |ref|)}, tolerance, ok,
    the plain backward's result)."""
    out, lse = fa.flash_forward_plain(q, k, v, causal=causal)
    got = fa.flash_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    want = fa.flash_backward_plain(q, k, v, out, lse, do, causal=causal)
    errs = grad_errors(got, want)
    tol = ({"max_abs_err/max_abs_ref": BWD_REL_TOL} if relative
           else BWD_TOL[q.dtype])
    ok = bwd_ok(got, want, errs, relative)
    return max(e for e, _ in errs.values()), errs, tol, ok, want


def tf32_bwd_reading(fa, q, k, v, do, causal, want, relative=False):
    """The plain backward with its matmuls on TF32 tensor cores, read
    against the same limit as K2/K3: a variant that dropped below fp32
    this way must fail the check.  Returns (errors, passes_the_limit)."""
    out, lse = fa.flash_forward_plain(q, k, v, causal=causal)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = fa.flash_backward_plain(q, k, v, out, lse, do, causal=causal)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    errs = grad_errors(got, want)
    return errs, bwd_ok(got, want, errs, relative)


def bwd_split_tf32_floors(b, h, sq, sk, d, causal):
    """{kernel: least time of the f32 backward on the tensor cores as K2
    and K3 do it}: three TF32 products for each fp32 one (K2 8·D
    operations a pair, K3 6·D), at the TF32 peak."""
    pairs = _pairs(sq, sk, causal) * b * h
    return {"flash_bwd_dkv": 3 * 8 * d * pairs / H100_TF32_FLOPS * 1e3,
            "flash_bwd_dq": 3 * 6 * d * pairs / H100_TF32_FLOPS * 1e3}


BWD_KERNELS = ("flash_bwd_dkv", "flash_bwd_dq")


def bwd_times(fa, q, k, v, do):
    """{kernel: ms} of K2 and K3 on one causal input, and what the library
    takes for dq, dk and dv: SDPA's backward alone, through autograd from
    one forward whose graph is kept; all by events with the host queued
    ahead.  (By cuda_ms, SDPA's forward + backward less its forward, or
    its backward alone, read 0.43 to 0.76 ms for f32 and 0.11 to 0.72 ms
    for bf16 on one H100: the host's time through autograd, not SDPA's.)"""
    out, lse = fa.flash_forward_plain(q, k, v, causal=True)
    call = fa._bwd_prepare(q, k, v, out, lse, do, fa._config(q, True, None))
    ms = {name: queued_ms(lambda n=name: fa._bwd_launch(call, n))
          for name in BWD_KERNELS}
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg,
                                                         is_causal=True)
    library_ms = queued_ms(lambda: torch.autograd.grad(
        o, (qg, kg, vg), do, retain_graph=True))
    return ms, library_ms, (out, lse)


def bwd_repeats_bitwise(fa, q, k, v, do):
    """K2 + K3 twice on the same inputs: the same bits (no atomics)."""
    out, lse = fa.flash_forward_plain(q, k, v, causal=True)
    first = fa.flash_backward(q, k, v, out, lse, do, causal=True)
    second = fa.flash_backward(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, second))


def phase_flash_bwd(card: str):
    """K2 and K3 against the plain backward, their repeatability, and
    their times."""
    from bigdl_tpu_torch.ops import flash_attention_mod as fa
    cases = [
        # (label, B, H, Sq, Sk, D, dtype, causal, layout)
        ("slice f32 causal", 8, 6, 512, 512, 128, torch.float32, True,
         "main"),
        ("slice bf16 causal", 8, 6, 512, 512, 128, torch.bfloat16, True,
         "main"),
        ("f32 non-causal", 8, 6, 512, 512, 128, torch.float32, False,
         "contig"),
        ("ragged S=300 f32 causal", 2, 6, 300, 300, 128, torch.float32, True,
         "contig"),
        ("ragged S=300 bf16 non-causal", 2, 6, 300, 300, 128, torch.bfloat16,
         False, "strided"),
        ("head_dim 64 f32 causal", 4, 8, 512, 512, 64, torch.float32, True,
         "contig"),
        ("head_dim 64 bf16 ragged S=300 causal", 2, 4, 300, 300, 64,
         torch.bfloat16, True, "strided"),
        ("cross Sq=128 Sk=384 f32 causal", 2, 2, 128, 384, 128,
         torch.float32, True, "contig"),
        ("cross Sq=384 Sk=128 f32 causal", 2, 2, 384, 128, 128,
         torch.float32, True, "contig"),
        ("cross Sq=200 Sk=328 bf16 non-causal", 2, 2, 200, 328, 64,
         torch.bfloat16, False, "contig"),
        ("slice f32 causal, q/k/v/do one element into their storage", 8, 6,
         512, 512, 128, torch.float32, True, "offset"),
        ("ragged S=300 bf16 causal, q/k/v/do one element into their "
         "storage (copied by the wrapper)", 2, 6, 300, 300, 128,
         torch.bfloat16, True, "offset"),
        ("ragged S=300 bf16 non-causal head_dim 64, q/k/v/do two elements "
         "into their storage", 2, 4, 300, 300, 64, torch.bfloat16, False,
         "offset2"),
    ]
    results = []
    for i, (label, b, h, sq, sk, d, dt, causal, layout) in enumerate(cases):
        q, k, v = _qkv(b, h, sq, sk, d, dt, seed=200 + i, layout=layout)
        do = _grad_out(q, layout, seed=300 + i)
        width = fa.bwd_copy_bytes(q, k, v, do)
        err, errs, tol, ok, want = compare_bwd(fa, q, k, v, do, causal)
        case = {"case": label, "shape": [b, h, sq, sk, d],
                "dtype": str(dt).replace("torch.", ""), "causal": causal,
                "layout": layout, "copy_bytes": width, "max_abs_err": err,
                "errors_and_max_ref": errs, "tolerance": tol, "ok": ok}
        if i == 0:
            case["tf32"], case["tf32_passes"] = tf32_bwd_reading(
                fa, q, k, v, do, causal, want)
        results.append(case)
        log(f"K2+K3 vs plain [{label}]: {width}-byte copies, max_abs_err "
            f"{err:.3e} (err, max|ref|) {errs} tol {tol} -> "
            f"{'ok' if ok else 'FAIL'}")
        del want
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_bwd disagrees with its plain version: "
                             f"{bad}")
    widths = {r["copy_bytes"] for r in results}
    if widths != {4, 16}:
        raise AssertionError(f"flash_bwd cases took copy widths {widths}, "
                             f"not both 16 and 4 bytes")
    check_tf32_fails("K2+K3 [slice f32 causal]", results[0]["tf32"],
                     results[0]["tf32_passes"], BWD_TOL[torch.float32])

    # times at the training shape (B=8, H=6, S=512, D=128, causal, f32)
    b, h, d = TRAIN_BATCH, 6, 128
    q, k, v = _qkv(b, h, SEQ, SEQ, d, torch.float32, seed=9, layout="main")
    do = _grad_out(q, "main", seed=10)
    bitwise = bwd_repeats_bitwise(fa, q, k, v, do)
    log(f"K2+K3 twice on the slice's f32 inputs: "
        f"{'the same bits' if bitwise else 'DIFFERENT bits'}")
    if not bitwise:
        raise AssertionError("K2+K3 are not deterministic")
    ms, library_ms, (out, lse) = bwd_times(fa, q, k, v, do)
    delta_ms = cuda_ms(lambda: (do.float() * out.float()).sum(-1))
    plain_ms = cuda_ms(lambda: fa.flash_backward_plain(q, k, v, out, lse, do,
                                                       causal=True), iters=5)
    bf16_ms, bf16_library_ms, _ = bwd_times(
        fa, *(t.to(torch.bfloat16) for t in (q, k, v, do)))
    bounds = bwd_bounds(b, h, SEQ, SEQ, d, True, torch.float32)
    floors = bwd_split_tf32_floors(b, h, SEQ, SEQ, d, True)
    bf16_bounds = bwd_bounds(b, h, SEQ, SEQ, d, True, torch.bfloat16)
    for name in BWD_KERNELS:
        log(f"{name} f32 ({b},{h},{SEQ},{d}) causal: {ms[name]:.4f} ms "
            f"(bound {bounds[name][0]:.4f} {bounds[name][1]}, split-TF32 "
            f"floor {floors[name]:.4f}); bf16 {bf16_ms[name]:.4f} ms "
            f"(bound {bf16_bounds[name][0]:.4f} {bf16_bounds[name][1]})")
    log(f"K2+K3 f32 {sum(ms.values()):.4f} ms, delta {delta_ms:.4f} ms, "
        f"plain backward {plain_ms:.4f} ms, SDPA backward {library_ms:.4f} "
        f"ms; bf16 K2+K3 {sum(bf16_ms.values()):.4f} ms, SDPA backward "
        f"{bf16_library_ms:.4f} ms; {card}")
    main = results[0]
    replaces = {"flash_bwd_dkv": "bigdl_tpu/ops/flash_attention.py:285",
                "flash_bwd_dq": "bigdl_tpu/ops/flash_attention.py:325"}
    return [{"name": name, "route": "cuda",
             "source": "bigdl_tpu_torch/csrc/flash_bwd.cu",
             "replaces": replaces[name], "launches": None,
             "max_abs_err": main["max_abs_err"],
             "tolerance": main["tolerance"], "ms": ms[name],
             "kernel_ms": ms[name], "plain_ms": plain_ms,
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
             "split_tf32_floor_ms": floors[name],
             "library_ms": library_ms,
             "library_call": "autograd.grad of torch.nn.functional."
                             "scaled_dot_product_attention(is_causal=True)'s"
                             " output, its graph kept: the backward alone, "
                             "f32",
             "plain_and_library_cover": "dq, dk and dv (K2 and K3 "
                                        "together, delta included)",
             "bf16_ms": bf16_ms[name], "bf16_bound_ms": bf16_bounds[name][0],
             "bf16_library_ms": bf16_library_ms,
             "repeat_bitwise": bitwise,
             "delta_ms": delta_ms, "shape": [b, h, SEQ, SEQ, d],
             "dtype": "float32", "cases": results, "card": card}
            for name in BWD_KERNELS]


def check_tf32_fails(what, reading, passes, limit):
    """The check has teeth only if a TF32 variant fails it."""
    log(f"tf32 variant of {what}: {reading} against {limit} -> "
        f"{'passes (the check cannot see TF32)' if passes else 'fails'}")
    if passes:
        raise AssertionError(f"{what}: the limit {limit} does not tell a "
                             f"TF32 run from fp32: {reading}")


# --------------------------------------------------------------------- #
def _ulps(a, b):
    """Largest distance in units in the last place between two f32
    tensors of one sign pattern (0 when bitwise equal)."""
    ai, bi = a.view(torch.int32).long(), b.view(torch.int32).long()
    return int((ai - bi).abs().max().item()) if a.numel() else 0


def _base_shapes():
    """The shapes of TransformerLM ``base``'s leaves, in the order of its
    parameter dict (built on the meta device: no weights)."""
    from bigdl_tpu_torch.models import transformer as T
    with torch.device("meta"):
        model = T.TransformerLM(T.TransformerConfig(**T.PRESETS["base"]),
                                torch.Generator().manual_seed(0))
    return [tuple(p.shape) for sub in model.param_dict().values()
            for p in sub.values()]


def _adam_trees(fo, kw, p0s, g0s, m0s, v0s):
    """The fused update (the kernel) and the plain one over one tree of
    leaves, on copies of (p0s, m0s, v0s) at their offsets, with the
    gradients g0s as they are: ([p, m, v] kernel, [p, m, v] plain, the
    kernel's launches), each of p, m and v all the tree's leaves end to
    end."""
    out, launches = [], None
    for fn in (fo.fused_adam_update, fo.fused_adam_update_plain):
        ps, ms, vs = ({f"l{i}": _copy_at(t) for i, t in enumerate(ts)}
                      for ts in (p0s, m0s, v0s))
        gs = {f"l{i}": t for i, t in enumerate(g0s)}
        before = fo._build.launch_counts().get(fo.KERNEL_NAME, 0)
        fn(ps, gs, ms, vs, **kw)
        torch.cuda.synchronize()
        if launches is None:
            launches = fo._build.launch_counts().get(fo.KERNEL_NAME, 0) \
                - before
        out.append([torch.cat([t.flatten() for t in tree.values()])
                    for tree in (ps, ms, vs)])
    return out[0], out[1], launches


def _adam_tree_cases(fo):
    """The trees of phase_adam: (label, shapes, float offset of each leaf
    from a 16-byte boundary, channels-last gradients, launches).  Each
    leaf's p, g, m and v lie at its offset."""
    cap = fo.ADAM_CAPACITY
    cl = [(512, 512, 3, 3), (64, 3, 7, 7)]
    return [
        ("n=1", [(1,)], [0], False, 1),
        ("n=127", [(127,)], [0], False, 1),
        ("n=768", [(768,)], [0], False, 1),
        ("n=3072*768", [(3072 * 768,)], [0], False, 1),
        ("TransformerLM base's 111 leaves", _base_shapes(), None, False,
         1),
        (f"{cap + 1} leaves (capacity {cap})",
         [(int(n),) for n in np.random.RandomState(8).randint(
             1, 301, size=cap + 1)], None, False, 2),
        ("a leaf at a 4-byte offset", [(768,), (1_000_003,)], [0, 1], False,
         1),
        ("n % 4 != 0 (ragged tails)", [(4099,), (3,), (4097 * 3,)], None,
         False, 1),
        ("an empty leaf", [(0,), (768,)], None, False, 1),
        ("channels-last 3x3 and 7x7 conv gradients", cl, None, True, 1),
    ]


def phase_adam(card: str):
    """K4 against the plain update, bitwise, on Adam and AdamW at steps 1
    and 1000: single leaves of 1, 127, 768 and 3072*768 values, all 111
    of TransformerLM base's leaf shapes in one call, more leaves than one
    table holds (two launches), a leaf at a 4-byte offset (the scalar
    path), ragged tails, an empty leaf (skipped) and channels-last conv
    gradients (read in place), each with its launch count."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.optim import Adam, AdamW
    results = []
    gen = torch.Generator(device="cuda")
    for method in (Adam(learning_rate=1e-3, fused=True),
                   AdamW(learning_rate=TRAIN_LR, fused=True)):
        for step in (1, 1000):
            state = {"step": torch.tensor(step - 1, dtype=torch.int32,
                                          device="cuda")}
            kw = method.update_scalars(state)
            for i, (case, shapes, shifts, channels_last, want) in \
                    enumerate(_adam_tree_cases(fo)):
                gen.manual_seed(step * 100 + i)
                shifts = shifts or [0] * len(shapes)

                def rnd(shape, scale, shift):
                    """randn of ``shape`` at ``shift`` floats past an
                    aligned address."""
                    n = int(np.prod(shape))
                    base = torch.randn(n + shift, generator=gen,
                                       device="cuda")
                    return base[shift:].mul_(scale).view(shape)
                p0s, g0s, m0s, v0s = ([rnd(s, scale, k) for s, k in
                                       zip(shapes, shifts)]
                                      for scale in (0.05, 1e-2, 1e-3, 1e-3))
                v0s = [t.square_() for t in v0s]
                if channels_last:
                    g0s = [t.contiguous(memory_format=torch.channels_last)
                           for t in g0s]
                leaves = [leaf for leaf in zip(p0s, g0s, m0s, v0s)
                          if leaf[0].numel()]
                tables, kept = fo.leaf_tables(leaves, fo.KERNEL_NAME,
                                              ("p", "m", "v"))
                meta = _meta_rows(tables)
                plan = {"tables": len(tables),
                        "scalar_path": int((meta[:, 4] == 0).sum()),
                        "channels_last_in_place": int((meta[:, 2] > 0)
                                                      .sum()),
                        "copies": len(kept)}
                del tables, kept, leaves
                kern, plain, launches = _adam_trees(fo, kw, p0s, g0s, m0s,
                                                    v0s)
                del p0s, g0s, m0s, v0s
                ulps = {name: _ulps(a, b) for name, a, b in
                        zip(("p", "m", "v"), kern, plain)}
                err = max(((a - b).abs().max().item() if a.numel() else 0.0)
                          for a, b in zip(kern, plain))
                ok = all(torch.equal(a, b) for a, b in zip(kern, plain))
                want_plan = (want, want, sum(1 for k in shifts if k),
                             len(shapes) if channels_last else 0, 0)
                planned = (launches, plan["tables"], plan["scalar_path"],
                           plan["channels_last_in_place"], plan["copies"])
                label = f"{type(method).__name__} step {step} {case}"
                results.append({"case": label, "max_abs_err": err,
                                "ulps": ulps, "bitwise": ok,
                                "launches": launches,
                                "launches_expected": want, **plan,
                                "ok": ok and planned == want_plan})
                log(f"K4 vs plain [{label}]: max_abs_err {err:.3e} ulps "
                    f"{ulps}, {launches} launch(es), plan {plan} -> "
                    f"{'bitwise' if ok else 'FAIL'}"
                    f"{'' if planned == want_plan else f'; expected {want_plan}'}")
                del kern, plain
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"fused_adam is not bitwise equal to its plain "
                             f"version, or did not launch as planned: "
                             f"{bad}")
    # a leaf the kernel does not take raises on the card, before any launch
    xb = torch.ones(8, dtype=torch.bfloat16, device="cuda")
    before = fo._build.launch_counts().get(fo.KERNEL_NAME, 0)
    try:
        fo.fused_adam_update({"x": xb}, {"x": xb}, {"x": xb.clone()},
                             {"x": xb.clone()}, **kw)
    except NotImplementedError as e:
        log(f"K4 on a bf16 leaf raises: {e}")
    else:
        raise AssertionError("fused_adam took a bf16 leaf on the card")
    if fo._build.launch_counts().get(fo.KERNEL_NAME, 0) != before \
            or not torch.equal(xb, torch.ones_like(xb)):
        raise AssertionError("fused_adam touched a bf16 leaf it refused")
    torch.cuda.empty_cache()
    return {"name": "fused_adam", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/fused_adam.cu",
            "replaces": "bigdl_tpu/kernels/fused_optim.py:124",
            "launches": None, "max_abs_err": max(r["max_abs_err"]
                                                 for r in results),
            "tolerance": "bitwise", "cases": results, "card": card}


def time_adam(k4: dict, leaves, card: str):
    """K4, its plain version and torch.optim.AdamW(fused=True) over leaves
    of the shapes of ``leaves`` (all of the model's), one update each: by
    CUDA events with the host (``cuda_ms``), with the host queued ahead
    (``queued_ms``), cold on the device (``cold_ms``: events and CUPTI),
    with the launches an update makes and the wrapper's host time by
    part."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.optim import AdamW
    shapes = [tuple(p.shape) for p in leaves]
    n = sum(int(np.prod(s)) for s in shapes)
    g = torch.Generator(device="cuda").manual_seed(11)
    tree = {f"l{i}": {"w": torch.randn(s, generator=g, device="cuda") * 0.05}
            for i, s in enumerate(shapes)}
    grads = {k: {"w": torch.randn_like(v["w"]) * 1e-2}
             for k, v in tree.items()}
    method = AdamW(learning_rate=TRAIN_LR, fused=True)
    state = method.init_state(tree)
    kw = method.update_scalars(state)
    m, v = state["m"], state["v"]

    def kernel_run():
        fo.fused_adam_update(tree, grads, m, v, **kw)
    before = fo._build.launch_counts().get(fo.KERNEL_NAME, 0)
    kernel_run()
    per_update = fo._build.launch_counts().get(fo.KERNEL_NAME, 0) - before
    ms = cuda_ms(kernel_run, iters=10)
    q_ms = queued_ms(kernel_run, iters=10)
    cold = cold_ms(kernel_run, "fused_adam_kernel")
    plain_ms = cuda_ms(lambda: fo.fused_adam_update_plain(tree, grads, m, v,
                                                          **kw), iters=3)
    # the wrapper's host time, part by part (the launch is the rest)
    trs = (tree, grads, m, v)
    flat = fo.zip_leaves(*trs)
    in_place = ("p", "m", "v")
    (ptrs, meta, count), = fo.leaf_tables(flat, fo.KERNEL_NAME, in_place)[0]
    fn = fo._adam_fn()
    stream = torch.cuda.current_stream().cuda_stream
    args = (*(kw[k].data_ptr() for k in ("clr", "bc1", "bc2")), 0.9, 0.1,
            0.999, 0.001, 1e-8, 0.01, 1, stream)

    def c_call():
        fn(ptrs.buffer_info()[0], meta.buffer_info()[0], count, *args)
    host = {"update": _host_us(kernel_run, 50),
            "zip_leaves": _host_us(lambda: fo.zip_leaves(*trs)),
            "f32_check": _host_us(lambda: fo._kernel_takes(flat,
                                                           fo.KERNEL_NAME)),
            "leaf_tables": _host_us(lambda: fo.leaf_tables(
                flat, fo.KERNEL_NAME, in_place)),
            "c_call_and_launch": _host_us(c_call, 20, idle=True)}
    torch.cuda.synchronize()
    del flat, ptrs, meta
    params = [t["w"].clone().requires_grad_() for t in tree.values()]
    for p_, gt in zip(params, (t["w"] for t in grads.values())):
        p_.grad = gt
    ref = torch.optim.AdamW(params, lr=TRAIN_LR, weight_decay=0.01,
                            fused=True)
    library_ms = cuda_ms(ref.step, iters=10)
    library_queued_ms = queued_ms(ref.step, iters=10)
    library_cold = cold_ms(ref.step, "adam")
    del ref, tree, grads, m, v, params
    torch.cuda.empty_cache()
    bound_ms = n * 28 / H100_HBM_BYTES_S * 1e3
    log(f"fused_adam over {len(shapes)} leaves, {n} params: {per_update} "
        f"launch(es) an update; kernel {ms:.4f} ms by events, queued "
        f"{q_ms:.4f} ms, cold {cold}; plain {plain_ms:.4f} ms; "
        f"torch.optim.AdamW(fused) {library_ms:.4f} ms by events, queued "
        f"{library_queued_ms:.4f} ms, cold {library_cold}; bound "
        f"{bound_ms:.4f} ms (bytes); host µs {host}; {card}")
    k4.update(ms=ms, kernel_ms=ms, queued_ms=q_ms, device_cold=cold,
              plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
              library_ms=library_ms, library_queued_ms=library_queued_ms,
              library_cold=library_cold,
              library_call="torch.optim.AdamW(fused=True).step(), f32",
              leaves=len(shapes), params=n,
              launches_per_update=per_update, host_us=host)


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
        err, lse_err, tol, ok, _ = _compare(fa, q, k, v, causal=True)
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


# --------------------------------------------------------------------- #
KERNEL_CLASSES = (("flash_fwd", "K1 flash_fwd"),
                  ("flash_bwd_dkv", "K2 flash_bwd_dkv"),
                  ("flash_bwd_dq", "K3 flash_bwd_dq"),
                  ("fused_adam_kernel", "K4 fused_adam"),
                  ("gemm", "matmul (cuBLAS)"), ("cutlass", "matmul (cuBLAS)"),
                  ("reduce", "reductions"), ("elementwise", "elementwise"))


def _device_us(ev):
    if getattr(ev, "is_user_annotation", False):
        # a range the profiler draws on the GPU's track (for example
        # torch.optim's "Optimizer.step#SGD.step"), not device work: it
        # spans the kernels it holds, which count on their own
        return 0.0
    us = getattr(ev, "device_time_total", None)
    if us is None:
        us = getattr(ev, "cuda_time_total", 0.0)
    return us if ev.device_type == torch.autograd.DeviceType.CUDA else 0.0


def profile_steps(run_steps, steps: int = 2, classes=KERNEL_CLASSES,
                  top: int = 0):
    """Device time by kernel class and the device's busy share over
    ``run_steps()``, which runs ``steps`` training steps, from
    torch.profiler (CUPTI); with ``top``, also the ``top`` kernels by
    device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run_steps()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_class, by_name, device_us = {}, {}, 0.0
    for ev in prof.key_averages():
        us = _device_us(ev)
        if not us:
            continue
        device_us += us
        name = ev.key.lower()
        cls = next((c for key, c in classes if key in name), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3 / steps
        by_name[ev.key[:120]] = us / 1e3 / steps
    if device_us == 0.0:
        log("profile: the profiler saw no device time (not measured)")
        return None
    busy = device_us / 1e3 / wall_ms
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_ms_per_step": device_us / 1e3 / steps,
           "device_busy_share": busy,
           "device_ms_by_class": dict(sorted(by_class.items(),
                                             key=lambda kv: -kv[1]))}
    if top:
        out["top_kernels_ms_per_step"] = dict(sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top])
    log(f"profile: {json.dumps(out)}")
    return out


L2_FLUSH_BYTES = 256 << 20   # read before each cold call: > 5x the 50 MB L2
SPIN_CYCLES = 6_000_000      # ~3 ms at the H100's clock: the host gets ahead


def cold_ms(fn, key: Optional[str] = None, iters: int = 10) -> dict:
    """Device time of one call of ``fn`` with a cold L2.  Before each call
    the card spins (so that the host queues the rest ahead of the card)
    and then reads a 256 MB buffer, which evicts every line the previous
    call left in L2 (writing back the dirty ones) and leaves only clean
    lines there.  ``events_ms``: median by CUDA events around the call.
    With ``key``, also ``profiler_ms``: the device time per call of the
    kernels whose name holds ``key``, from torch.profiler (CUPTI), and
    ``records``, the kernel records it saw.  What the call leaves dirty in
    L2 when it ends is written back outside its time, as in any kernel
    timing: at most 50 MB."""
    from torch.profiler import ProfilerActivity, profile
    buf = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
    out = torch.empty((), device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for e0, e1 in pairs:
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.sum(buf, dim=0, out=out)
            e0.record()
            fn()
            e1.record()
        torch.cuda.synchronize()
    res = {"events_ms": float(np.median([e0.elapsed_time(e1)
                                         for e0, e1 in pairs]))}
    if key is not None:
        evs = [ev for ev in prof.key_averages()
               if key in ev.key.lower() and _device_us(ev)]
        res["profiler_ms"] = (sum(map(_device_us, evs)) / 1e3 / iters
                              if evs else None)
        res["records"] = sum(ev.count for ev in evs)
    del buf
    return res


def device_ms(fns, key: str, iters: int = 6) -> dict:
    """Time per call of ``fns`` (a callable, or a list of callables run in
    turn, so that consecutive calls can touch disjoint bytes), back to
    back after one warm call of each: ``cupti_ms``, the device time of the
    kernels whose name holds ``key`` from torch.profiler (CUPTI; None when
    it saw none), and ``events_ms``, CUDA events around the same calls."""
    from torch.profiler import ProfilerActivity, profile
    fns = fns if isinstance(fns, (list, tuple)) else [fns]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        e0.record()
        for i in range(iters):
            fns[i % len(fns)]()
        e1.record()
        torch.cuda.synchronize()
    us = sum(_device_us(ev) for ev in prof.key_averages()
             if key in ev.key.lower())
    return {"cupti_ms": us / 1e3 / iters if us else None,
            "events_ms": e0.elapsed_time(e1) / iters}


def kernel_records(fn, key: str) -> dict:
    """One call of ``fn`` with a cold L2 (as :func:`cold_ms` makes it)
    under torch.profiler: the raw device records it saw (name, stream,
    start and end in µs), and for the records whose name holds ``key``
    the sum of their durations (annotations left out), the span from the
    first start to the last end and what ``key_averages()`` makes of them,
    beside CUDA events around the call."""
    from torch.profiler import ProfilerActivity, profile
    buf = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
    out = torch.empty((), device="cuda")
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        torch.sum(buf, dim=0, out=out)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
    del buf
    recs = sorted(({"name": ev.name, "stream": getattr(
                        ev, "device_resource_id", None),
                    "annotation": getattr(ev, "is_user_annotation", None),
                    "start_us": ev.time_range.start,
                    "end_us": ev.time_range.end}
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: r["start_us"])
    mine = [r for r in recs if key in r["name"].lower()
            and not r["annotation"]]
    for r in recs:
        r["name"] = r["name"][:60]
    avg_us = sum(_device_us(ev) for ev in prof.key_averages()
                 if key in ev.key.lower())
    return {"events_ms": e0.elapsed_time(e1),
            "records_sum_ms": sum(r["end_us"] - r["start_us"]
                                  for r in mine) / 1e3,
            "records_span_ms": (mine[-1]["end_us"] - mine[0]["start_us"])
            / 1e3 if mine else None,
            "key_averages_ms": avg_us / 1e3, "records": recs}


def phase_training(card: str, k4: dict):
    """SpmdTrainer on base: the kernel run (counted), the plain run from
    the same weights, step-1 gradients of both, and the breakdown."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import flash_attention_mod as fa
    from bigdl_tpu_torch.optim import AdamW, make_accum_grads
    from bigdl_tpu_torch.parallel import SpmdTrainer

    t0 = time.monotonic()
    model = T.build("base", device="cuda", seed=0)
    cfg = model.cfg
    params = model.param_dict()
    leaves = [p for sub in params.values() for p in sub.values()]
    w0 = [p.detach().clone() for p in leaves]
    n_leaves = len(leaves)
    log(f"training model built: {n_leaves} leaves, "
        f"{sum(p.numel() for p in leaves)} params, "
        f"{time.monotonic() - t0:.1f} s")
    rs = np.random.RandomState(1)
    ids = rs.randint(0, cfg.vocab_size, (TRAIN_BATCH, SEQ + 1)).astype(
        np.int32)
    tokens, targets = ids[:, :-1], ids[:, 1:]
    tok_d = torch.from_numpy(tokens).cuda()
    tgt_d = torch.from_numpy(targets).cuda()

    def set_attention(fn):
        for blk in model.blocks:
            blk.attn.attention_fn = fn

    def plain_attention(q, k, v):
        return fa.flash_attention_plain(q, k, v, causal=True)

    captured = {}

    def capture_attention(q, k, v):
        captured.update(q=q.detach().clone(
            memory_format=torch.preserve_format),
            k=k.detach().clone(memory_format=torch.preserve_format),
            v=v.detach().clone(memory_format=torch.preserve_format))
        o = plain_attention(q, k, v)
        o.register_hook(lambda g: captured.update(
            do=g.detach().clone(memory_format=torch.preserve_format)))
        return o

    grads_fn = make_accum_grads(
        lambda p, st, x, y: (model.loss(p, x, y, training=True), st), 1)

    # step-1 gradients: kernels against the plain attention
    (loss_k, _), g_k = grads_fn(params, {}, tok_d, tgt_d)
    set_attention(plain_attention)
    model.blocks[0].attn.attention_fn = capture_attention
    (loss_p, _), g_p = grads_fn(params, {}, tok_d, tgt_d)
    set_attention(None)

    def worst_rel_diff(g_a):
        worst_rel, worst_leaf = 0.0, None
        for name, sub in g_p.items():
            for pname, gp in sub.items():
                ga = g_a[name][pname]
                if not torch.isfinite(ga).all():
                    raise AssertionError(f"non-finite gradient "
                                         f"{name}.{pname}")
                rel = ((ga - gp).abs().max() /
                       gp.abs().max().clamp(min=1e-30)).item()
                if rel > worst_rel:
                    worst_rel, worst_leaf = rel, f"{name}.{pname}"
        return worst_rel, worst_leaf

    worst_rel, worst_leaf = worst_rel_diff(g_k)
    log(f"step-1 gradients, kernels vs plain attention: loss "
        f"{loss_k.item():.6f} vs {loss_p.item():.6f}; worst leaf "
        f"{worst_leaf} max|dg|/max|g| {worst_rel:.3e} (tol {GRAD_REL_TOL})")
    if worst_rel > GRAD_REL_TOL:
        raise AssertionError(f"step-1 gradients differ: {worst_leaf} "
                             f"{worst_rel:.3e}")
    del g_k
    # the same kernel step with the model's matmuls on TF32 tensor cores
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        (loss_t, _), g_t = grads_fn(params, {}, tok_d, tgt_d)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_rel, tf32_leaf = worst_rel_diff(g_t)
    del g_t, g_p
    check_tf32_fails("step-1 gradients", {"worst_leaf": tf32_leaf,
                                          "max_rel_diff": tf32_rel},
                     tf32_rel <= GRAD_REL_TOL, GRAD_REL_TOL)

    # K2/K3 on exactly what layer 0 of a training step hands them: its
    # gradients are far below 1, so each is held relative to its own size
    q, k, v, do = (captured[n] for n in ("q", "k", "v", "do"))
    err, errs, tol, ok, want = compare_bwd(fa, q, k, v, do, causal=True,
                                           relative=True)
    tf32_errs, tf32_passes = tf32_bwd_reading(fa, q, k, v, do, True, want,
                                              relative=True)
    layer_case = {"case": "training layer 0 q/k/v/do",
                  "shape": [q.shape[0], q.shape[1], SEQ, SEQ, q.shape[3]],
                  "dtype": "float32", "causal": True,
                  "strides": [list(t.stride()) for t in (q, k, v, do)],
                  "max_abs_err": err, "errors_and_max_ref": errs,
                  "tolerance": tol, "ok": ok, "tf32": tf32_errs,
                  "tf32_passes": tf32_passes}
    log(f"K2+K3 vs plain [training layer 0 q/k/v/do, strides "
        f"{layer_case['strides']}]: max_abs_err {err:.3e} (err, max|ref|) "
        f"{errs} tol {tol} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_bwd disagrees with its plain version on "
                             "the training layer's q, k, v, do")
    check_tf32_fails("K2+K3 [training layer 0]", tf32_errs, tf32_passes, tol)
    del captured, q, k, v, do, want

    # the main path: counts from 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    _build.reset_launch_counts()
    trainer = SpmdTrainer(model, AdamW(learning_rate=TRAIN_LR, fused=True))
    losses_k, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t_s = time.monotonic()
        losses_k.append(trainer.step(tokens, targets))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t_s)
    launches = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses_k = [float(x) for x in losses_k]
    want = {"flash_fwd": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dkv": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dq": cfg.n_layers * TRAIN_STEPS,
            # one K4 launch an update per table of ADAM_CAPACITY leaves
            "fused_adam": -(-n_leaves // fo.ADAM_CAPACITY) * TRAIN_STEPS}
    got = {name: launches.get(name, 0) for name in want}
    log(f"training launches {got}, expected {want}")
    if got != want:
        raise AssertionError(f"training launches {got}, expected {want}")

    # the same steps from the same weights on the plain versions
    def restore_weights():
        with torch.no_grad():
            for p_, w in zip(leaves, w0):
                p_.copy_(w)
    restore_weights()
    set_attention(plain_attention)
    plain_trainer = SpmdTrainer(model, AdamW(learning_rate=TRAIN_LR,
                                             fused=False))
    losses_p = [float(plain_trainer.step(tokens, targets))
                for _ in range(TRAIN_STEPS)]
    set_attention(None)
    if _build.launch_counts() != launches:
        raise AssertionError("the plain run launched a kernel")
    diffs = [abs(a - b) for a, b in zip(losses_k, losses_p)]
    log(f"losses kernels {losses_k}; plain {losses_p}; max |diff| "
        f"{max(diffs):.3e} (tol {LOSS_TOL})")
    if not all(np.isfinite(losses_k + losses_p)):
        raise AssertionError("non-finite loss")
    if max(diffs) > LOSS_TOL:
        raise AssertionError(f"kernel and plain runs differ: {diffs}")
    if not losses_k[-1] < losses_k[0]:
        raise AssertionError(f"loss did not fall: {losses_k}")
    del plain_trainer

    # the kernel run again with the model's matmuls on TF32 (after the
    # counts were read): the loss limit must tell it from fp32
    restore_weights()
    del w0
    tf32_trainer = SpmdTrainer(model, AdamW(learning_rate=TRAIN_LR,
                                            fused=True))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        losses_t = [float(tf32_trainer.step(tokens, targets))
                    for _ in range(TRAIN_STEPS)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_diffs = [abs(a - b) for a, b in zip(losses_t, losses_p)]
    check_tf32_fails("the losses", {"max_diff": max(tf32_diffs),
                                    "diffs": tf32_diffs},
                     max(tf32_diffs) <= LOSS_TOL, LOSS_TOL)
    del tf32_trainer

    # where a step's time goes (after the counts were read)
    state = trainer.opt_state
    opt = trainer.optim

    def part_times():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = model.loss(params, tok_d, tgt_d, training=True)
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
        ev[2].record()
        it = iter(grads)
        tree = {n: {k: next(it) for k in sub} for n, sub in params.items()}
        opt.update(tree, params, state)
        ev[3].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    parts = [part_times() for _ in range(3)]
    fwd_ms, bwd_ms, opt_ms = (float(np.median([p[i] for p in parts]))
                              for i in range(3))
    profile = profile_steps(lambda: [trainer.step(tokens, targets)
                                     for _ in range(2)])
    time_adam(k4, leaves, card)
    step_ms = float(np.median(step_s)) * 1e3
    out = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": SEQ,
           "tokens_per_step": TRAIN_BATCH * SEQ,
           "step_ms_median": step_ms,
           "step_ms": [x * 1e3 for x in step_s],
           "tokens_per_s": TRAIN_BATCH * SEQ / (step_ms / 1e3),
           "losses": losses_k, "losses_plain": losses_p,
           "max_loss_diff": max(diffs), "loss_tol": LOSS_TOL,
           "grad_max_rel_diff": worst_rel, "grad_worst_leaf": worst_leaf,
           "grad_rel_tol": GRAD_REL_TOL, "launches": got,
           "tf32": {"grad_max_rel_diff": tf32_rel, "grad_worst_leaf":
                    tf32_leaf, "step1_loss": loss_t.item(),
                    "losses": losses_t, "max_loss_diff": max(tf32_diffs)},
           "peak_mem_gb": peak_gb, "resident_before_gb": resident_gb,
           "breakdown_ms": {"forward": fwd_ms, "backward": bwd_ms,
                            "optimizer": opt_ms},
           "profile": profile,
           "layer_case": layer_case, "card": card}
    log(f"training: {json.dumps(out)}")
    del trainer, model, params, leaves, state
    torch.cuda.empty_cache()
    return out

# --------------------------------------------------------------------- #
SGD_CONFIGS = (
    # (label, SGD keywords without weight decay); K5 when momentum > 0
    ("K5 momentum 0.9, dampening 0.9 (default)", dict(momentum=0.9)),
    ("K5 momentum 0.9, dampening 0", dict(momentum=0.9, dampening=0.0)),
    ("K5 nesterov", dict(momentum=0.9, dampening=0.0, nesterov=True)),
    ("K6", dict()),
)
SGD_SHAPES = ((1,), (127,), (768,), (3072 * 768,), (64, 3, 7, 7),
              (2048, 512, 1, 1))


def _copy_at(t):
    """A contiguous copy of ``t`` at ``t``'s offset from a 16-byte
    boundary (a fresh tensor is aligned; a view need not be)."""
    shift = (t.data_ptr() % 16) // t.element_size()
    base = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    out = base[shift:].view(t.shape)
    out.copy_(t)
    return out


def _sgd_trees(fo, method, clr, p0s, g0s, v0s):
    """The fused update (the kernel) and the plain one of ``method`` over
    one tree of leaves, on copies of (p0s, v0s) at their offsets, with
    the gradients g0s as they are: ([p, v] kernel, [p, v] plain, the
    kernel's launches), each p and v all the tree's leaves end to end."""
    kw = dict(clr=clr, momentum=method.momentum,
              dampening=method.dampening, nesterov=method.nesterov,
              weight_decay=method.weight_decay)
    name = fo.SGD_MOM if method.momentum > 0 else fo.SGD_PLAIN
    out, launches = [], None
    for fn in (fo.fused_sgd_update, fo.fused_sgd_update_plain):
        ps = {f"l{i}": _copy_at(t) for i, t in enumerate(p0s)}
        vs = {f"l{i}": _copy_at(t) for i, t in enumerate(v0s)}
        gs = {f"l{i}": t for i, t in enumerate(g0s)}
        before = fo._build.launch_counts().get(name, 0)
        fn(ps, gs, vs if method.momentum > 0 else None, **kw)
        torch.cuda.synchronize()
        if launches is None:
            launches = fo._build.launch_counts().get(name, 0) - before
        out.append([torch.cat([t.flatten() for t in tree.values()])
                    for tree in (ps, vs)])
    return out[0], out[1], launches


def _meta_rows(tables):
    """fused_optim.leaf_tables' meta of every leaf, one row a leaf: n,
    first chunk, I and H*W of a channels-last gradient, float4 flag."""
    return np.concatenate([np.asarray(m).reshape(-1, 5)
                           for _, m, _ in tables])


def _sgd_tree_cases(fo, rnd):
    """The multi-leaf trees of phase_sgd: (label, p0s, g0s, v0s, leaves
    that must take the scalar path, leaves whose channels-last gradient
    is read in place, launches)."""
    cap = fo.SGD_CAPACITY
    p_off = [rnd((1_000_003,), 0.05, 1), rnd((768,), 0.05),
             rnd((127,), 0.05, 1)]
    cl = [(512, 512, 3, 3), (64, 3, 7, 7)]
    sizes = np.random.RandomState(5).randint(1, 301, size=2000)
    return [
        ("six SGD_SHAPES in one tree", [rnd(s, 0.05) for s in SGD_SHAPES],
         [rnd(s, 1e-2) for s in SGD_SHAPES],
         [rnd(s, 1e-3) for s in SGD_SHAPES], 0, 0, 1),
        ("4-byte offsets (two of three leaves)", p_off,
         [rnd(t.shape, 1e-2, 1 if t.data_ptr() % 16 else 0)
          for t in p_off],
         [rnd(t.shape, 1e-3, 1 if t.data_ptr() % 16 else 0)
          for t in p_off], 2, 0, 1),
        ("channels-last 3x3 and 7x7 conv gradients",
         [rnd(s, 0.05) for s in cl],
         [rnd(s, 1e-2).contiguous(memory_format=torch.channels_last)
          for s in cl], [rnd(s, 1e-3) for s in cl], 0, 2, 1),
        (f"{len(sizes)} leaves of 1-300 values (capacity {cap})",
         [rnd((int(n),), 0.05) for n in sizes],
         [rnd((int(n),), 1e-2) for n in sizes],
         [rnd((int(n),), 1e-3) for n in sizes], 0, 0,
         -(-len(sizes) // cap)),
    ]


def _bitwise(label, kern, plain, results):
    ulps = {name: _ulps(a, b) for name, a, b in zip(("p", "v"), kern, plain)}
    err = max((a - b).abs().max().item() for a, b in zip(kern, plain))
    ok = all(torch.equal(a, b) for a, b in zip(kern, plain))
    results.append({"case": label, "max_abs_err": err, "ulps": ulps,
                    "bitwise": ok, "ok": ok})
    log(f"SGD kernel vs plain [{label}]: max_abs_err {err:.3e} ulps {ulps}"
        f" -> {'bitwise' if ok else 'FAIL'}")
    return results[-1]


def phase_sgd(card: str):
    """K5 and K6 against the plain update, bitwise: momentum with the
    reference's default dampening, dampening 0 and nesterov (K5), none
    (K6); weight decay 0 and 1e-4.  One leaf at a time: sizes 1, 127,
    768, 3072*768 and ResNet-50's (64, 3, 7, 7) and (2048, 512, 1, 1),
    steps 1 and 1000 (a per-step learning-rate decay makes clr differ).
    Then trees of many leaves, with their launch counts: the six shapes
    in one launch; leaves at a 4-byte offset (the scalar path); conv
    leaves whose gradient is channels-last (read in place, no copy); and
    more leaves than one table holds (ceil(leaves / capacity) launches)."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.optim import SGD
    results = {fo.SGD_MOM: [], fo.SGD_PLAIN: []}
    for label, kw in SGD_CONFIGS:
        for wd in (0.0, 1e-4):
            method = SGD(learning_rate=0.1, learning_rate_decay=1e-4,
                         weight_decay=wd, **kw)
            kernel = fo.SGD_MOM if method.momentum > 0 else fo.SGD_PLAIN
            for step in (1, 1000):
                clr = method.get_learning_rate({"step": torch.tensor(
                    step - 1, dtype=torch.int32, device="cuda")})
                for i, shape in enumerate(SGD_SHAPES):
                    g = torch.Generator(device="cuda").manual_seed(
                        step * 10 + i)

                    def rnd(scale):
                        return torch.randn(shape, generator=g,
                                           device="cuda") * scale
                    p0, g0, v0 = rnd(0.05), rnd(1e-2), rnd(1e-3)
                    kern, plain, _ = _sgd_trees(fo, method, clr, [p0],
                                                [g0], [v0])
                    _bitwise(f"{label} wd {wd} step {step} "
                             f"{list(shape)}", kern, plain,
                             results[kernel])
            gen = torch.Generator(device="cuda").manual_seed(77)

            def rnd(shape, scale, shift=0):
                """randn of ``shape`` at ``shift`` floats past an aligned
                address."""
                n = int(np.prod(shape))
                base = torch.randn(n + shift, generator=gen, device="cuda")
                return base[shift:].mul_(scale).view(shape)
            for case, p0s, g0s, v0s, scalar, in_place, want in \
                    _sgd_tree_cases(fo, rnd):
                leaves = list(zip(p0s, g0s, v0s))
                tables, kept = fo.leaf_tables(leaves, kernel, ("p", "v"))
                meta = _meta_rows(tables)
                plan = {"tables": len(tables),
                        "scalar_path": int((meta[:, 4] == 0).sum()),
                        "channels_last_in_place": int((meta[:, 2] > 0)
                                                      .sum()),
                        "copies": len(kept)}
                kern, plain, launches = _sgd_trees(fo, method, clr, p0s,
                                                   g0s, v0s)
                r = _bitwise(f"{label} wd {wd} {case}", kern, plain,
                             results[kernel])
                r.update(plan, launches=launches, launches_expected=want)
                if (launches, plan["tables"], plan["scalar_path"],
                        plan["channels_last_in_place"], plan["copies"]) \
                        != (want, want, scalar, in_place, 0):
                    r["ok"] = False
                    log(f"  FAIL: {launches} launches, plan {plan}; "
                        f"expected {want} launches, {scalar} scalar, "
                        f"{in_place} channels-last in place, 0 copies")
    bad = [r["case"] for rs in results.values() for r in rs if not r["ok"]]
    if bad:
        raise AssertionError(f"fused_sgd is not bitwise equal to its plain "
                             f"version, or did not launch as planned: "
                             f"{bad}")
    # a leaf the kernels do not take raises on the card, before any launch
    xb = torch.ones(8, dtype=torch.bfloat16, device="cuda")
    clr = torch.ones((), device="cuda")
    for kernel, vel in ((fo.SGD_MOM, {"x": xb.clone()}),
                        (fo.SGD_PLAIN, None)):
        before = fo._build.launch_counts().get(kernel, 0)
        try:
            fo.fused_sgd_update({"x": xb}, {"x": xb}, vel, clr=clr,
                                momentum=0.9 if vel else 0.0)
        except NotImplementedError as e:
            log(f"{kernel} on a bf16 leaf raises: {e}")
        else:
            raise AssertionError(f"{kernel} took a bf16 leaf on the card")
        if fo._build.launch_counts().get(kernel, 0) != before \
                or not torch.equal(xb, torch.ones_like(xb)):
            raise AssertionError(f"{kernel} touched a bf16 leaf it refused")
    replaces = {fo.SGD_MOM: "bigdl_tpu/kernels/fused_optim.py:174",
                fo.SGD_PLAIN: "bigdl_tpu/kernels/fused_optim.py:186"}
    return [{"name": name, "route": "cuda",
             "source": "bigdl_tpu_torch/csrc/fused_sgd.cu",
             "replaces": replaces[name], "launches": None,
             "max_abs_err": max(r["max_abs_err"] for r in results[name]),
             "tolerance": "bitwise", "cases": results[name], "card": card}
            for name in (fo.SGD_MOM, fo.SGD_PLAIN)]


def _host_us(fn, iters: int = 200, idle: bool = False) -> float:
    """Host time of ``fn`` in µs a call (host clock); with ``idle``, the
    median of calls each made on an idle device, so that a launch is not
    held back by the ones queued before it."""
    fn()
    if idle:
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e6
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def time_sgd(k5: dict, k6: dict, resnet_shapes, lenet_shapes, card: str):
    """K5 and K6, their plain versions and torch.optim.SGD(fused=True)
    over leaves of ResNet-50's shapes (one update each: K5 with momentum
    0.9, dampening 0.9, wd 1e-4; K6 with none), by CUDA events and by
    device time, with the launches an update makes and the host time of
    the wrapper's parts; and K6 against the library at LeNet-5's 8
    leaves."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.optim import SGD
    n = sum(int(np.prod(s)) for s in resnet_shapes)
    g = torch.Generator(device="cuda").manual_seed(12)

    def trees(shapes):
        p = {f"l{i}": {"w": torch.randn(s, generator=g, device="cuda")
                       * 0.05} for i, s in enumerate(shapes)}
        grads = {k: {"w": torch.randn_like(v["w"]) * 1e-2}
                 for k, v in p.items()}
        return p, grads

    def library_step(params, grads, lib_kw):
        """torch.optim.SGD(fused=True).step on copies of params."""
        flat = [t["w"].clone().requires_grad_() for t in params.values()]
        for p_, gt in zip(flat, (t["w"] for t in grads.values())):
            p_.grad = gt
        ref = torch.optim.SGD(flat, fused=True, **lib_kw)
        ref.step()                               # builds its momentum buffers
        return ref.step

    def library_ms(params, grads, other, lib_kw):
        """The library step on copies of params: (ms by events, its
        :func:`device_ms` (its kernels are named *FusedSgd*) alternating
        with the second tree ``other``, its :func:`cold_ms` and the raw
        records of one cold call)."""
        step = library_step(params, grads, lib_kw)
        return (cuda_ms(step, iters=10),
                device_ms([step, library_step(*other, lib_kw)], "sgd"),
                cold_ms(step, "sgd"), kernel_records(step, "sgd"))

    # the rate a plain copy reaches on this card, cold: what the bound's
    # data-sheet rate is worth in practice
    src = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = cold_ms(lambda: dst.copy_(src))["events_ms"]
    copy_tb_s = 2 * L2_FLUSH_BYTES / copy_ms / 1e9
    del src, dst
    log(f"copy of {L2_FLUSH_BYTES >> 20} MB, cold: {copy_ms:.4f} ms, "
        f"{copy_tb_s:.3f} TB/s read + write; {card}")

    for k, kw, lib_kw, nbytes in (
            (k5, dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4),
             dict(lr=0.1, momentum=0.9, dampening=0.9, weight_decay=1e-4),
             20),
            (k6, dict(learning_rate=0.05), dict(lr=0.05), 12)):
        method = SGD(fused=True, **kw)
        params, grads = trees(resnet_shapes)
        state = method.init_state(params)
        clr = method.get_learning_rate(state)
        upd = dict(clr=clr, momentum=method.momentum,
                   dampening=method.dampening, nesterov=method.nesterov,
                   weight_decay=method.weight_decay)
        vel = state.get("velocity")
        # a second tree, so that back-to-back calls can alternate between
        # disjoint bytes
        params_b, grads_b = trees(resnet_shapes)
        vel_b = method.init_state(params_b).get("velocity")

        def kernel_run():
            fo.fused_sgd_update(params, grads, vel, **upd)

        def kernel_run_b():
            fo.fused_sgd_update(params_b, grads_b, vel_b, **upd)
        before = fo._build.launch_counts().get(k["name"], 0)
        kernel_run()
        per_update = fo._build.launch_counts().get(k["name"], 0) - before
        ms = cuda_ms(kernel_run, iters=10)
        dev_ms = device_ms(kernel_run, "sgd_")
        dev_alt = device_ms([kernel_run, kernel_run_b], "sgd_")
        cold = cold_ms(kernel_run, "sgd_")
        records = kernel_records(kernel_run, "sgd_")
        plain_ms = cuda_ms(lambda: fo.fused_sgd_update_plain(
            params, grads, vel, **upd), iters=3)
        lib_ms, lib_dev_ms, lib_cold, lib_records = library_ms(
            params, grads, (params_b, grads_b), lib_kw)
        # the wrapper's host time, part by part (the launch is the rest)
        trs = (params, grads, vel) if vel is not None else (params, grads)
        leaves = fo.zip_leaves(*trs)
        in_place = ("p", "v") if vel is not None else ("p",)
        (ptrs, meta, count), = fo.leaf_tables(leaves, k["name"],
                                              in_place)[0]
        fn = fo._sgd_fn(vel is not None)
        stream = torch.cuda.current_stream().cuda_stream
        args = (clr.data_ptr(), *((0.9, 0.1, 1e-4, 1, 0) if vel is not None
                                  else (0.0, 0)), stream)

        def c_call():
            fn(ptrs.buffer_info()[0], meta.buffer_info()[0], count, *args)
        host = {"update": _host_us(kernel_run),
                "zip_leaves": _host_us(lambda: fo.zip_leaves(*trs)),
                "f32_check": _host_us(lambda: fo._kernel_takes(
                    leaves, k["name"])),
                "leaf_tables": _host_us(lambda: fo.leaf_tables(
                    leaves, k["name"], in_place)),
                "c_call_and_launch": _host_us(c_call, 50, idle=True)}
        torch.cuda.synchronize()
        del params, grads, state, vel, leaves, params_b, grads_b, vel_b
        bound_ms = n * nbytes / H100_HBM_BYTES_S * 1e3
        for who, rec in (("kernel", records), ("library", lib_records)):
            log(f"{k['name']} raw device records of one cold {who} call: "
                f"events {rec['events_ms']:.4f} ms, records sum "
                f"{rec['records_sum_ms']:.4f} ms, span "
                f"{rec['records_span_ms']} ms, key_averages "
                f"{rec['key_averages_ms']:.4f} ms; {rec['records']}")
        k.update(ms=ms, kernel_ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                 device_ms_alternating=dev_alt, device_cold=cold,
                 cold_records=records, library_cold_records=lib_records,
                 bound_ms=bound_ms, bound_by="bytes",
                 copy_tb_s=copy_tb_s, library_ms=lib_ms,
                 library_device_ms=lib_dev_ms, library_cold=lib_cold,
                 library_call=f"torch.optim.SGD({lib_kw}, fused=True)"
                              f".step(), f32",
                 leaves=len(resnet_shapes), params=n,
                 launches_per_update=per_update, host_us=host)
        log(f"{k['name']} over {len(resnet_shapes)} leaves, {n} params: "
            f"{per_update} launch(es) an update; kernel {ms:.4f} ms by "
            f"events, back to back {dev_ms} on one tree and {dev_alt} "
            f"alternating two, cold L2 {cold}, plain {plain_ms:.4f} ms, "
            f"torch.optim.SGD(fused) {lib_ms:.4f} ms (back to back "
            f"alternating two trees {lib_dev_ms}, cold L2 {lib_cold}), bound "
            f"{bound_ms:.4f} ms (bytes); host µs {host}; {card}")
    params, grads = trees(lenet_shapes)
    clr = torch.full((), 0.05, device="cuda")
    lenet_ms = cuda_ms(lambda: fo.fused_sgd_update(params, grads, clr=clr),
                       iters=50)
    k6["lenet_ms_per_update"] = lenet_ms
    k6["lenet_library_ms"] = cuda_ms(library_step(params, grads,
                                                  dict(lr=0.05)), iters=50)
    k6["lenet_bound_ms"] = sum(int(np.prod(s)) for s in lenet_shapes) \
        * 12 / H100_HBM_BYTES_S * 1e3
    log(f"fused_sgd_plain at LeNet-5's {len(lenet_shapes)} leaves: "
        f"{lenet_ms:.4f} ms an update, torch.optim.SGD(fused) "
        f"{k6['lenet_library_ms']:.4f} ms (bound "
        f"{k6['lenet_bound_ms']:.6f} ms); {card}")


def _syncs(fn) -> Optional[str]:
    """None when ``fn()`` runs under ``torch.cuda.set_sync_debug_mode
    ("error")`` without a synchronizing call, else the error it raised."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        return str(e).splitlines()[0][:200]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return None


def phase_host_sync() -> dict:
    """One SGD.update (K5) and one AdamW.update (K4) on the card must make
    no host sync: each runs under ``set_sync_debug_mode("error")`` after a
    warm update.  The mode must catch a read of a device value
    (``.item()``), so that the check can see a sync at all; whether it
    also reports a device scalar made from a host float, as the updates
    built theirs before (``torch.as_tensor(rate, device=...)``), is
    logged."""
    from bigdl_tpu_torch.optim import SGD, AdamW
    g = torch.Generator(device="cuda").manual_seed(14)

    def tree():
        return {"a": {"w": torch.randn(4096, generator=g, device="cuda")},
                "b": {"w": torch.randn(64, 64, generator=g, device="cuda")}}
    out = {}
    for name, method in (
            ("SGD(0.1, momentum=0.9, weight_decay=1e-4, fused=True)",
             SGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
                 fused=True)),
            ("AdamW(3e-4, fused=True)", AdamW(learning_rate=3e-4,
                                              fused=True))):
        params, grads = tree(), tree()
        state = [method.init_state(params)]
        state[0] = method.update(grads, params, state[0])[1]

        def update():
            state[0] = method.update(grads, params, state[0])[1]
        out[name] = _syncs(update)
    out["control: .item() of a device value"] = _syncs(
        lambda: torch.ones((), device="cuda").item())
    out["torch.as_tensor(0.1, device='cuda')"] = _syncs(
        lambda: torch.as_tensor(0.1, dtype=torch.float32, device="cuda"))
    log(f"host sync under set_sync_debug_mode('error') (None: no sync): "
        f"{out}")
    if out["control: .item() of a device value"] is None:
        raise AssertionError("set_sync_debug_mode did not report .item()")
    bad = [k for k in list(out)[:2] if out[k] is not None]
    if bad:
        raise AssertionError(f"an optimizer update synchronizes the host: "
                             f"{ {k: out[k] for k in bad} }")
    return out


# --------------------------------------------------------------------- #
CLS_BATCH, CLS_EPOCHS = 64, 6          # ResNet-50: 6 steps on one batch
LENET_BATCH, LENET_ROWS, LENET_EPOCHS = 128, 512, 2
RESNET_SGD = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
LENET_SGD = dict(learning_rate=0.05)
# kernel run against plain run of a classifier (fp32, TF32 off,
# deterministic cuDNN): K5/K6 are bitwise equal to the plain update and
# every other op is deterministic, so the runs must agree to the last bit
# (they did on an H100: 0.0 between kernel and plain, and between two
# plain runs).  The TF32 run is read against the training phase's loss
# limit, about 20x a sound fp32 reading there, and must fall outside it.
CLS_LOSS_TOL = 2e-5                  # |loss_tf32 - loss_plain|, some step
CLS_CLASSES = (("sgd_mom", "K5 fused_sgd_mom"),
               ("sgd_plain", "K6 fused_sgd_plain"),
               ("memcpy htod", "memcpy H2D"), ("memcpy", "memcpy, other"),
               ("dgrad", "cuDNN conv backward"),
               ("wgrad", "cuDNN conv backward"),
               ("bprop", "cuDNN conv backward"),
               ("fprop", "cuDNN conv forward"),
               ("conv", "cuDNN conv, other"), ("gemm", "matmul (cuBLAS)"),
               ("reduce", "reductions"), ("pool", "pooling"),
               ("elementwise", "elementwise (BN, ReLU, add)"))


def _classifier_run(model, data, method, epochs, w0, s0):
    """Train ``model`` from the weights ``w0`` and BN state ``s0`` with
    LocalOptimizer and ``method`` for ``epochs`` epochs; returns (losses,
    step ms by CUDA events between the ends of consecutive steps)."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import LocalOptimizer, Trigger

    class Recording(LocalOptimizer):
        """Keeps each step's loss (on the device) and an event at its
        end."""
        def _fire_mid_epoch(self):
            self.losses.append(self.state.loss)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            return super()._fire_mid_epoch()

    with torch.no_grad():
        for dst, src in zip(model.get_weights() + model.state_list(),
                            w0 + s0):
            dst.copy_(src)
    x, y, batch = data
    opt = Recording(model, (x, y), ClassNLLCriterion(), batch_size=batch)
    opt.losses, opt.events = [], [torch.cuda.Event(enable_timing=True)]
    opt.set_optim_method(method).set_end_when(Trigger.max_epoch(epochs))
    opt.events[0].record()
    opt.optimize()
    torch.cuda.synchronize()
    ev = opt.events
    return ([float(v) for v in opt.losses],
            [ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)])


def _check_losses(what, losses_k, losses_p, limit):
    diffs = [abs(a - b) for a, b in zip(losses_k, losses_p)]
    log(f"{what}: losses {losses_k}; against {losses_p}; max |diff| "
        f"{max(diffs):.3e} ({limit})")
    if not all(np.isfinite(losses_k + losses_p)):
        raise AssertionError(f"{what}: non-finite loss")
    return diffs


def phase_classifier(card: str, k5: dict, k6: dict):
    """ResNet-50 (ImageNet, NHWC, fp32) through LocalOptimizer with
    SGD(momentum, fused=True) on K5, and LeNet-5 with SGD(fused=True) on
    K6; each against the same run with fused=False, with exact launch
    counts, and ResNet-50's breakdown."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.models import lenet, resnet
    from bigdl_tpu_torch.nn import ClassNLLCriterion, Ctx
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import SGD

    t0 = time.monotonic()
    model = resnet.build(class_num=1000, depth=50, dataset="imagenet",
                         format="NHWC", seed=0)
    w0 = [w.clone() for w in model.get_weights()]
    s0 = [s.clone() for s in model.state_list()]
    n_leaves, n_params = len(w0), sum(w.numel() for w in w0)
    log(f"ResNet-50 built: {n_leaves} leaves, {n_params} params, "
        f"{len(s0)} BN state tensors, {time.monotonic() - t0:.1f} s")
    rs = np.random.RandomState(2)
    x = rs.randn(CLS_BATCH, 224, 224, 3).astype(np.float32)
    y = (rs.randint(0, 1000, CLS_BATCH) + 1).astype(np.float32)
    data = (x, y, CLS_BATCH)

    # the main path: counts from 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses_k, step_ms = _classifier_run(
        model, data, SGD(fused=True, **RESNET_SGD), CLS_EPOCHS, w0, s0)
    launches = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # one K5 launch an update per table of SGD_CAPACITY leaves
    per_update = -(-n_leaves // fo.SGD_CAPACITY)
    want = {fo.SGD_MOM: per_update * CLS_EPOCHS, fo.SGD_PLAIN: 0}
    got = {name: launches.get(name, 0) for name in want}
    log(f"ResNet-50 launches {launches}, expected {want}")
    if got != want or sum(launches.values()) != sum(want.values()):
        raise AssertionError(f"ResNet-50 launches {launches}, expected "
                             f"{want}")

    # the same steps on the plain update, twice (run-to-run noise), and
    # with TF32 convolutions and matmuls
    losses_p, _ = _classifier_run(model, data, SGD(**RESNET_SGD),
                                  CLS_EPOCHS, w0, s0)
    losses_p2, _ = _classifier_run(model, data, SGD(**RESNET_SGD),
                                   CLS_EPOCHS, w0, s0)
    if _build.launch_counts() != launches:
        raise AssertionError("the plain runs launched a kernel")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        losses_t, _ = _classifier_run(model, data,
                                      SGD(fused=True, **RESNET_SGD),
                                      CLS_EPOCHS, w0, s0)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    noise = _check_losses("ResNet-50 plain vs plain", losses_p2, losses_p,
                          "bitwise")
    diffs = _check_losses("ResNet-50 kernel vs plain", losses_k, losses_p,
                          "bitwise")
    tf32_diffs = _check_losses("ResNet-50 TF32 vs plain", losses_t,
                               losses_p, f"must exceed {CLS_LOSS_TOL}")
    bitwise_runs = {"plain_vs_plain": losses_p2 == losses_p,
                    "kernel_vs_plain": losses_k == losses_p}
    log(f"ResNet-50 losses bitwise equal: {bitwise_runs}")

    # K5 on the model's own step-1 gradients (channels-last conv weight
    # gradients included), two updates, against the plain update
    with torch.no_grad():
        for dst, src in zip(model.get_weights() + model.state_list(),
                            w0 + s0):
            dst.copy_(src)
    params = model.param_dict()
    leaves = [p for sub in params.values() for p in sub.values()]
    xd = torch.from_numpy(x).cuda()
    yd = torch.from_numpy(y).cuda()
    crit = ClassNLLCriterion()

    def loss_and_grads():
        ctx = Ctx(state=model.initial_state(), training=True)
        loss = crit.loss(model.apply(params, xd, ctx), yd)
        return loss, torch.autograd.grad(loss, leaves)
    _, grads = loss_and_grads()
    layouts = sum(not gr.is_contiguous() for gr in grads)
    # the channels-last conv gradients are read in place: no copy
    tables, kept = fo.leaf_tables(
        [(w, gr, w) for w, gr in zip(leaves, grads)], fo.SGD_MOM, ("p", "v"))
    in_place = int((_meta_rows(tables)[:, 2] > 0).sum())
    copies = len(kept)
    del tables, kept
    method = SGD(**RESNET_SGD)
    clr = method.get_learning_rate(method.init_state(params))
    upd = dict(clr=clr, momentum=method.momentum, dampening=method.dampening,
               nesterov=method.nesterov, weight_decay=method.weight_decay)
    runs = []
    for fn in (fo.fused_sgd_update, fo.fused_sgd_update_plain):
        p = {f"l{i}": {"w": w.detach().clone()} for i, w in enumerate(leaves)}
        v = {k: {"w": torch.zeros_like(t["w"])} for k, t in p.items()}
        gtree = {f"l{i}": {"w": gr} for i, gr in enumerate(grads)}
        for _ in range(2):
            fn(p, gtree, v, **upd)
        torch.cuda.synchronize()
        runs.append([t["w"] for t in p.values()] + [t["w"] for t in
                                                    v.values()])
    step1_ok = all(torch.equal(a, b) for a, b in zip(*runs))
    step1_err = max((a - b).abs().max().item() for a, b in zip(*runs))
    log(f"K5 vs plain on ResNet-50's step-1 gradients ({layouts} of "
        f"{len(grads)} not contiguous, {in_place} read in place, {copies} "
        f"copied), two updates: max_abs_err {step1_err:.3e} -> "
        f"{'bitwise' if step1_ok else 'FAIL'}")
    k5["cases"].append({"case": "ResNet-50 step-1 gradients, two updates",
                        "max_abs_err": step1_err, "bitwise": step1_ok,
                        "ok": step1_ok,
                        "non_contiguous_grads": layouts,
                        "channels_last_in_place": in_place,
                        "copies": copies})
    del runs, grads

    # where a step's time goes (after the counts were read)
    opt = SGD(fused=True, **RESNET_SGD)
    opt_state = opt.init_state(params)

    def part_times():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        xb = torch.from_numpy(x).to("cuda")
        yb = torch.from_numpy(y).to("cuda")
        ev[1].record()
        ctx = Ctx(state=model.initial_state(), training=True)
        loss = crit.loss(model.apply(params, xb, ctx), yb)
        ev[2].record()
        gr = torch.autograd.grad(loss, leaves)
        ev[3].record()
        it = iter(gr)
        gtree = {n: {k: next(it) for k in sub} for n, sub in params.items()}
        opt.update(gtree, params, opt_state)
        ev[4].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    parts = [part_times() for _ in range(3)]
    h2d_ms, fwd_ms, bwd_ms, opt_ms = (float(np.median([p[i] for p in parts]))
                                      for i in range(4))
    profile = profile_steps(
        lambda: _classifier_run(model, data, SGD(fused=True, **RESNET_SGD),
                                2, w0, s0),
        steps=2, classes=CLS_CLASSES, top=15)
    shapes = [tuple(w.shape) for w in w0]
    del model, params, leaves, opt_state, xd, yd, w0, s0
    torch.cuda.empty_cache()

    # LeNet-5 on K6: labels a fixed function of the images, so that two
    # epochs can lower the loss
    lnet = lenet.build(10, seed=0)
    lw0 = [w.clone() for w in lnet.get_weights()]
    rs = np.random.RandomState(3)
    lx = rs.randn(LENET_ROWS, 1, 28, 28).astype(np.float32)
    proj = rs.randn(784, 10).astype(np.float32)
    ly = (np.argmax(lx.reshape(LENET_ROWS, -1) @ proj, 1) + 1).astype(
        np.float32)
    ldata = (lx, ly, LENET_BATCH)
    lenet_steps = LENET_EPOCHS * LENET_ROWS // LENET_BATCH
    _build.reset_launch_counts()
    l_losses_k, l_step_ms = _classifier_run(
        lnet, ldata, SGD(fused=True, **LENET_SGD), LENET_EPOCHS, lw0, [])
    l_launches = _build.launch_counts()
    l_want = {fo.SGD_PLAIN: -(-len(lw0) // fo.SGD_CAPACITY) * lenet_steps}
    log(f"LeNet-5 launches {l_launches}, expected {l_want}")
    if l_launches != l_want:
        raise AssertionError(f"LeNet-5 launches {l_launches}, expected "
                             f"{l_want}")
    l_losses_p, _ = _classifier_run(lnet, ldata, SGD(**LENET_SGD),
                                    LENET_EPOCHS, lw0, [])
    if _build.launch_counts() != l_launches:
        raise AssertionError("the plain LeNet-5 run launched a kernel")
    l_diffs = _check_losses("LeNet-5 kernel vs plain", l_losses_k,
                            l_losses_p, "bitwise")
    lenet_shapes = [tuple(w.shape) for w in lw0]
    del lnet, lw0

    time_sgd(k5, k6, shapes, lenet_shapes, card)
    if profile:
        k5["device_ms_per_step"] = profile["device_ms_by_class"].get(
            "K5 fused_sgd_mom")

    # every check, after every reading was taken
    fails = []
    if not all(bitwise_runs.values()):
        fails.append(f"ResNet-50 runs are not bitwise equal: {bitwise_runs}"
                     f"; kernel vs plain {diffs}, plain vs plain {noise}")
    if max(tf32_diffs) <= CLS_LOSS_TOL:
        fails.append(f"ResNet-50: the limit {CLS_LOSS_TOL} does not tell a "
                     f"TF32 run from fp32: {tf32_diffs}")
    if not losses_k[-1] < losses_k[0]:
        fails.append(f"ResNet-50 loss did not fall: {losses_k}")
    if not step1_ok:
        fails.append("K5 is not bitwise equal to the plain update on "
                     "ResNet-50's step-1 gradients")
    if copies or in_place != layouts or not layouts:
        fails.append(f"ResNet-50's {layouts} non-contiguous gradients: "
                     f"{in_place} read in place, {copies} copied")
    if l_losses_k != l_losses_p:
        fails.append(f"LeNet-5 kernel and plain runs are not bitwise equal:"
                     f" {l_diffs}")
    if not l_losses_k[-1] < l_losses_k[0]:
        fails.append(f"LeNet-5 loss did not fall: {l_losses_k}")

    step_med = float(np.median(step_ms))
    out = {"resnet50": {
               "config": "resnet.build(class_num=1000, depth=50, dataset="
                         "'imagenet', format='NHWC', seed=0), fp32, "
                         "LocalOptimizer, SGD(learning_rate=0.1, momentum="
                         "0.9, weight_decay=1e-4, fused=True)",
               "leaves": n_leaves, "params": n_params, "batch": CLS_BATCH,
               "steps": CLS_EPOCHS, "step_ms": step_ms,
               "step_ms_median": step_med,
               "images_per_s": CLS_BATCH / (step_med / 1e3),
               "losses": losses_k, "losses_plain": losses_p,
               "losses_plain_again": losses_p2,
               "max_loss_diff": max(diffs),
               "max_loss_noise_plain_vs_plain": max(noise),
               "bitwise": bitwise_runs, "loss_limit": "bitwise",
               "tf32": {"losses": losses_t, "max_loss_diff":
                        max(tf32_diffs), "must_exceed": CLS_LOSS_TOL},
               "launches": got, "peak_mem_gb": peak_gb,
               "breakdown_ms": {"h2d": h2d_ms, "forward": fwd_ms,
                                "backward": bwd_ms, "optimizer": opt_ms},
               "profile": profile},
           "lenet5": {
               "config": "lenet.build(10, seed=0), LocalOptimizer, "
                         "SGD(learning_rate=0.05, fused=True)",
               "batch": LENET_BATCH, "rows": LENET_ROWS,
               "steps": lenet_steps, "step_ms": l_step_ms,
               "step_ms_median": float(np.median(l_step_ms)),
               "losses": l_losses_k, "losses_plain": l_losses_p,
               "max_loss_diff": max(l_diffs),
               "bitwise": l_losses_k == l_losses_p,
               "launches": l_launches},
           "launches": {fo.SGD_MOM: got[fo.SGD_MOM],
                        fo.SGD_PLAIN: l_launches.get(fo.SGD_PLAIN, 0)},
           "card": card}
    log(f"classifier: {json.dumps(out)}")
    if fails:
        raise AssertionError("classifier phase: " + "; ".join(fails))
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
    k1 = phase_kernels(card)
    k1["build_s"] = build_s
    k23 = phase_flash_bwd(card)
    k4 = phase_adam(card)
    k5, k6 = phase_sgd(card)
    host_sync = phase_host_sync()
    slice_ = phase_slice(card)
    k1["cases"].append(slice_["layer_case"])
    train = phase_training(card, k4)
    if train["profile"]:
        # K4's own device time a step (one launch), without host gaps
        k4["device_ms_per_step"] = train["profile"]["device_ms_by_class"] \
            .get("K4 fused_adam")
    for k in k23:
        k["cases"].append(train["layer_case"])
    # image classifiers: deterministic cuDNN algorithms, chosen without
    # benchmarking, so that two runs can be compared step by step
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    classifier = phase_classifier(card, k5, k6)
    by_path = {"serving": {"flash_fwd": slice_["launches"]},
               "training": train["launches"],
               "classifier": classifier["launches"]}
    kernels = [k1, *k23, k4, k5, k6]
    for k in kernels:
        k["launches_by_path"] = {path: counts.get(k["name"], 0)
                                 for path, counts in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    log(f"total {time.monotonic() - t0:.1f} s")
    print(json.dumps({"slice": slice_}), flush=True)
    print(json.dumps({"training": train}), flush=True)
    print(json.dumps({"classifier": classifier}), flush=True)
    print(json.dumps({"host_sync": host_sync}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
