"""Where the first step's cost pass (``observability.profile
.capture_step``) spends its time on ResNet-50 b256, bf16, on one GPU.

    PYTHONPATH=. python3 scripts/capture_cost_probe.py

Times the plain forward and backward (three runs, the first cold), then
the same under the FLOP counter alone, the bytes mode alone (without and
with the per-op memory read), and the whole capture; prints them as one
JSON line with the card's name and power limit, then the capture's
``cProfile`` by internal time.  The first dispatch mode of a process
pays a one-time cost, which the second run of each mode does not.
"""
import contextlib
import cProfile
import io
import json
import pstats
import subprocess
import time

import torch

import chip_smoke as c
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.observability.profile import capture as cap
from bigdl_tpu_torch.optim.optimizer import make_loss_fn, to_bf16, zip_leaves
from torch.utils.flop_counter import FlopCounterMode


def main():
    c._durable_setup("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    m = resnet.build(class_num=1000, depth=50, dataset="imagenet",
                     format="NHWC", seed=0, device="cuda")
    x, y = c._durable_resnet_data(256)
    x = to_bf16(torch.from_numpy(x).cuda())
    y = torch.from_numpy(y).cuda()
    params = m.param_dict()
    st = m.initial_state()
    leaves = [p for (p,) in zip_leaves(params)]

    def run():
        gen = torch.Generator(device="cuda").manual_seed(0)
        loss, _ = make_loss_fn(m, nn.ClassNLLCriterion(), generator=gen)(
            params, st, x, y)
        torch.autograd.grad(loss, leaves)

    def timed(ctx_fn, n=1):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with ctx_fn():
                run()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
        return out
    res = {"card": card}
    res["plain_warm"] = timed(contextlib.nullcontext, 3)
    res["flop_counter"] = timed(lambda: FlopCounterMode(display=False), 2)
    res["bytes_mode"] = timed(lambda: cap._BytesMode(None), 2)
    res["bytes_mode_mem"] = timed(lambda: cap._BytesMode(torch.device("cuda")), 2)
    t = time.perf_counter()
    cost = cap.capture_step(run, m, "cuda")
    res["capture_step"] = time.perf_counter() - t
    res["cost"] = cost
    pr = cProfile.Profile()
    pr.enable()
    cap.capture_step(run, m, "cuda")
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("tottime").print_stats(25)
    print(json.dumps(res))
    print(s.getvalue()[:6000])


if __name__ == "__main__":
    main()
