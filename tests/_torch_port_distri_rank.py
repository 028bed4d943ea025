"""One gloo rank of ``tests/test_torch_port_distri.py``.

    python tests/_torch_port_distri_rank.py RANK WORLD STORE_FILE IN_NPZ OUT_PKL

Starts a gloo process group through ``file://STORE_FILE``, trains the
MLP of ``tests/test_distributed.py`` (weights from ``IN_NPZ``) through
the port's ``DistriOptimizer`` in each configuration of ``RUNS`` and
through ``LocalOptimizer``, and writes each run's per-step losses, final
weights and readings to ``OUT_PKL``.  Imports neither jax nor
``bigdl_tpu``; it checks so before it writes.
"""
import faulthandler
import sys

# armed before torch is imported: a fatal signal (an abort at exit
# included) leaves every thread's stack in the rank's log
if not faulthandler.is_enabled():
    faulthandler.enable(all_threads=True)

import pickle

import numpy as np
import torch

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.convert import from_jax_weights
from bigdl_tpu_torch.optim import (SGD, Adam, DistriOptimizer,
                                   LocalOptimizer, Loss, Trigger)
from bigdl_tpu_torch.parallel import mesh as mesh_lib

BATCH = 64


def make_data(n=256, d=12, seed=0):
    """``tests/test_distributed.py``'s data."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d, 1).astype(np.float32)
    y = (x @ w + 0.01 * rng.randn(n, 1)).astype(np.float32)
    return x, y


def make_model(weights):
    m = tnn.Sequential(tnn.Linear(12, 8), tnn.Tanh(), tnn.Linear(8, 1))
    from_jax_weights(list(weights), m)
    return m


def sgd(**kw):
    return lambda: SGD(learning_rate=0.05, **kw)


# name -> (optim method, epochs, DistriOptimizer keywords, extra set-up)
RUNS = {
    "dp": (sgd(), 3, {}, None),
    "dp_momentum": (sgd(momentum=0.9), 3, {}, None),
    "fsdp_momentum": (sgd(momentum=0.9), 3, dict(fsdp=True), None),
    "zero1": (sgd(), 3, dict(zero1=True), None),
    "zero1_momentum": (sgd(momentum=0.9), 3, dict(zero1=True), None),
    "dp_adam": (lambda: Adam(1e-2), 3, {}, None),
    "zero1_adam": (lambda: Adam(1e-2), 3, dict(zero1=True), None),
    # 64-byte buckets: the 4 leaves (384, 32, 32, 4 bytes) in 3 buckets
    "dp_momentum_buckets": (sgd(momentum=0.9), 3, dict(bucket_bytes=64),
                            None),
    "dp_bf16": (sgd(), 3, dict(compress="bf16"), None),
    "dp_fp16": (sgd(), 3, dict(compress="fp16"), None),
    "dp_fp16_buckets": (sgd(), 3, dict(compress="fp16", bucket_bytes=64),
                        None),
    "zero1_fp16": (sgd(), 3, dict(compress="fp16", zero1=True), None),
    "dp_momentum_prefetch": (sgd(momentum=0.9), 3, {}, "prefetch"),
    "dp_validation": (sgd(), 2, {}, "validation"),
}


def train(opt):
    losses = []
    fire = opt._fire_mid_epoch

    def hook():
        losses.append(float(opt.state.loss))
        return fire()
    opt._fire_mid_epoch = hook
    model = opt.optimize()
    return losses, [w.detach().numpy().copy() for w in model.get_weights()]


def main():
    rank, world, store, src, dst = sys.argv[1:6]
    rank, world = int(rank), int(world)
    mesh_lib.init_distributed(f"file://{store}", rank, world, device="cpu")
    mesh = mesh_lib.create_mesh({"dp": world}, device="cpu")
    w0 = [a for _, a in sorted(np.load(src).items(),
                               key=lambda kv: int(kv[0][1:]))]
    x, y = make_data()
    out = {}
    local = (LocalOptimizer(make_model(w0), (x, y), tnn.MSECriterion(),
                            batch_size=BATCH, device="cpu")
             .set_optim_method(SGD(learning_rate=0.05))
             .set_end_when(Trigger.max_epoch(3)))
    out["local"] = dict(zip(("losses", "weights"), train(local)))
    for name, (method, epochs, kw, extra) in RUNS.items():
        opt = (DistriOptimizer(make_model(w0), (x, y), tnn.MSECriterion(),
                               batch_size=BATCH, mesh=mesh, **kw)
               .set_optim_method(method())
               .set_end_when(Trigger.max_epoch(epochs)))
        if extra == "prefetch":
            opt.set_prefetch(2)
        if extra == "validation":
            opt.set_validation(Trigger.every_epoch(), (x[:100], y[:100]),
                               [Loss(tnn.MSECriterion())], batch_size=32)
        losses, weights = train(opt)
        rec = opt.recorder
        res = {"losses": losses, "weights": weights,
               "gauges": dict(rec._gauges), "counters": dict(rec._counters)}
        if opt.zero1:
            res["opt_state_bytes"] = opt._z1.opt_state_bytes_per_replica(
                opt.opt_state)
            res["layout"] = opt._z1.describe()
        if extra == "validation":
            res["score"] = opt.state.score
            res["validation"] = [r.result() for _, r in opt.last_validation]
        out[name] = res

    # refusals
    class LARS(SGD):
        pass
    refusals = {}
    for what, make in (
            ("lars_zero1", lambda: DistriOptimizer(
                make_model(w0), (x, y), tnn.MSECriterion(), batch_size=BATCH,
                mesh=mesh, zero1=True).set_optim_method(LARS(0.1))),
            ("zero1_fsdp", lambda: DistriOptimizer(
                make_model(w0), (x, y), tnn.MSECriterion(), batch_size=BATCH,
                mesh=mesh, zero1=True, fsdp=True))):
        try:
            make().optimize()
            refusals[what] = None
        except ValueError as e:
            refusals[what] = str(e)
    for mode in (dict(zero1=True), dict(fsdp=True)):
        opt = DistriOptimizer(make_model(w0), (x, y), tnn.MSECriterion(),
                              batch_size=BATCH, mesh=mesh, **mode)
        for setter in ("set_gradient_clipping_by_l2_norm",
                       "set_gradient_accumulation"):
            try:
                getattr(opt, setter)(1)
                refusals[f"{setter} {mode}"] = None
            except NotImplementedError as e:
                refusals[f"{setter} {mode}"] = str(e)
    out["refusals"] = refusals
    out["jax_free"] = not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                              or m == "bigdl_tpu"
                              or m.startswith("bigdl_tpu.")
                              for m in sys.modules)
    with open(dst, "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
