#!/usr/bin/env python3
"""Time variants of the flash-attention backward kernels (K2, K3) on a GPU.

    python3 scripts/flash_bwd_variants.py        # from the root of a checkout

Each variant is ``bigdl_tpu_torch/csrc/flash_bwd.cu`` with a few text
substitutions (VARIANTS: tile rows and stages at f32 D = 128, stages at
the other tiles, or how the MMAs accumulate), written to
``build/kernels/variants/`` and built with the port's nvcc flags, one nvcc
each, all at once.  For each variant it prints ptxas's registers and
spills, the largest error against the plain backward on f32 and bf16
cases (and whether BWD_TOL of ``chip_smoke.py`` holds), and K2's and K3's
times at (8, 6, 512, D) causal for f32 and bf16 at D = 64 and 128, by
events with the host queued ahead, the variants in turns (four rounds,
the order reversed every other round).  Then one JSON line per variant
and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

F32_128 = "static constexpr int DP = 132, BK = 32, KS = 1, BQ = 32, QS = 1; };"
OTHER_TILES = (
    "static constexpr int DP = 68, BK = 64, KS = 2, BQ = 32, QS = 2; };",
    "static constexpr int DP = 136, BK = 32, KS = 2, BQ = 16, QS = 2; };",
    "static constexpr int DP = 72, BK = 64, KS = 2, BQ = 32, QS = 2; };")


def _tiles(bk, ks, bq, qs):
    return [(F32_128, F32_128.replace(
        "BK = 32, KS = 1, BQ = 32, QS = 1",
        f"BK = {bk}, KS = {ks}, BQ = {bq}, QS = {qs}"))]


VARIANTS = {
    "shipped": [],
    # f32 D = 128: two-stage rings of 16-row tiles (99 KB, two blocks an
    # SM), of 32-row tiles (132 KB, one block an SM), one stage of 16
    "ring16": _tiles(16, 2, 16, 2),
    "ring32": _tiles(32, 2, 32, 2),
    "one16": _tiles(16, 1, 16, 1),
    # every other tile in one stage too
    "one_stage_all": [(t, t.replace("KS = 2", "KS = 1")
                       .replace("QS = 2", "QS = 1")) for t in OTHER_TILES],
    # each product chained through the MMAs' own accumulators: S and dP
    # over all of D, the gradients over the whole loop
    "chained": [("constexpr int CG = N <= 32 ? 32 : D;",
                 "constexpr int CG = D;"),
                ("mma_3xtf32<G>(c, phi[j], plo[j], b);",
                 "mma_3xtf32<G>(o + n0, phi[j], plo[j], b);")],
}
CASES = [
    # (label, B, H, Sq, Sk, D, dtype, causal, layout)
    ("slice f32 causal", 8, 6, 512, 512, 128, "float32", True, "main"),
    ("f32 non-causal", 8, 6, 512, 512, 128, "float32", False, "contig"),
    ("head_dim 64 f32 causal", 4, 8, 512, 512, 64, "float32", True,
     "contig"),
    ("ragged S=300 f32 causal", 2, 6, 300, 300, 128, "float32", True,
     "contig"),
    ("slice bf16 causal", 8, 6, 512, 512, 128, "bfloat16", True, "main"),
    ("head_dim 64 bf16 ragged S=300 causal", 2, 4, 300, 300, 64, "bfloat16",
     True, "strided"),
]
TIMED = [(d, dt) for d in (128, 64) for dt in ("float32", "bfloat16")]


def variant_sources(src: str) -> dict:
    """{name: source}; each substitution must match exactly once."""
    out = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise ValueError(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        out[name] = text
    return out


def _ptxas(log: str) -> dict:
    """{kernel<type, D>: (registers, spill bytes)} from nvcc -Xptxas -v."""
    out, fn, spill = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = re.sub(r".*?(flash_bwd_\w+?_kernel)I(\w+?)EE.*", r"\1<\2>",
                        m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = (int(m.group(1)), spill)
    return out


def build(sources: dict) -> dict:
    """{name: (ctypes library, ptxas readings)}, one nvcc each, at once."""
    from bigdl_tpu_torch.ops import _build
    vdir = _build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        src, lib = vdir / f"flash_bwd_{name}.cu", vdir / f"lib{name}.so"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build._flags("flash_bwd"), "-I",
               str(_build.CSRC), "-o", str(lib), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    tail = [ctypes.c_int64] * 5 + [ctypes.c_void_p, ctypes.c_float,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    out = {}
    for name, (proc, lib) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        cdll = ctypes.CDLL(str(lib))
        dkv, dq = cdll.bigdl_flash_bwd_dkv, cdll.bigdl_flash_bwd_dq
        dkv.argtypes, dq.argtypes = ([ctypes.c_void_p] * 8 + tail,
                                     [ctypes.c_void_p] * 7 + tail)
        dkv.restype = dq.restype = ctypes.c_int
        out[name] = ((dkv, dq), _ptxas(log))
    return out


def main() -> int:
    import torch
    import chip_smoke as c
    from bigdl_tpu_torch.ops import flash_attention_mod as fa
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = c.card_line()
    src = (REPO / "bigdl_tpu_torch/csrc/flash_bwd.cu").read_text()
    libs = build(variant_sources(src))
    res = {name: {"variant": name, "ptxas": ptx, "errors": {}, "ok": True,
                  "ms": {}} for name, (_, ptx) in libs.items()}
    for i, (label, b, h, sq, sk, d, dt, causal, layout) in enumerate(CASES):
        dtype = getattr(torch, dt)
        q, k, v = c._qkv(b, h, sq, sk, d, dtype, seed=200 + i, layout=layout)
        do = c._grad_out(q, layout, seed=300 + i)
        for name, (fns, _) in libs.items():
            fa._bwd_lib = lambda fns=fns: fns
            err, _, _, ok, _ = c.compare_bwd(fa, q, k, v, do, causal)
            res[name]["errors"][label] = err
            res[name]["ok"] = res[name]["ok"] and ok
    order = list(libs)
    for d, dt in TIMED:
        dtype = getattr(torch, dt)
        q, k, v = c._qkv(8, 6, 512, 512, d, dtype, seed=9, layout="main")
        do = c._grad_out(q, "main", seed=10)
        out, lse = fa.flash_forward_plain(q, k, v, causal=True)
        call = fa._bwd_prepare(q, k, v, out, lse, do,
                               fa._config(q, True, None))
        key = f"{dt} D={d}"
        for r in range(4):
            for name in order if r % 2 == 0 else order[::-1]:
                fa._bwd_lib = lambda fns=libs[name][0]: fns
                ms = res[name]["ms"].setdefault(key, {n: [] for n in
                                                      c.BWD_KERNELS})
                for n in c.BWD_KERNELS:
                    ms[n].append(c.queued_ms(
                        lambda n=n: fa._bwd_launch(call, n), iters=50))
    for name in order:
        print(json.dumps(res[name]), flush=True)
    print(card, flush=True)
    return 0 if all(r["ok"] for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
