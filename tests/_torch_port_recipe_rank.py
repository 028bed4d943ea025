"""One gloo rank of ``tests/test_torch_port_recipe.py``'s data-parallel
cases.

    python tests/_torch_port_recipe_rank.py RANK WORLD STORE_FILE IN_NPZ OUT_PKL

Starts a gloo process group through ``file://STORE_FILE`` and trains the
MLP of ``tests/test_distributed.py`` (weights from ``IN_NPZ``) through
the port's ``DistriOptimizer`` with gradient clipping and accumulation
in each configuration of ``RUNS``; writes each run's per-step losses,
final weights and the clipping wrapper's last norm to ``OUT_PKL``.
Imports neither jax nor ``bigdl_tpu``; it checks so before it writes.
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
from bigdl_tpu_torch.data import DeviceAugment
from bigdl_tpu_torch.models.convert import from_jax_weights
from bigdl_tpu_torch.optim import SGD, DistriOptimizer, Trigger
from bigdl_tpu_torch.parallel import mesh as mesh_lib

BATCH, EPOCHS, CLIP = 64, 2, 1.0

# name -> (DistriOptimizer keywords, clipping, n_accum)
RUNS = {
    "dp": ({}, ("norm", CLIP), 2),
    "dp_buckets": (dict(bucket_bytes=64), ("norm", CLIP), 2),
    "fsdp": (dict(fsdp=True), ("norm", CLIP), 2),
    "zero1": (dict(zero1=True), ("norm", CLIP), 2),
    "dp_const": ({}, ("const", (-0.05, 0.05)), 1),
    "zero1_const": (dict(zero1=True), ("const", (-0.05, 0.05)), 2),
}


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


def main():
    rank, world, store, src, dst = sys.argv[1:6]
    rank, world = int(rank), int(world)
    mesh_lib.init_distributed(f"file://{store}", rank, world, device="cpu")
    mesh = mesh_lib.create_mesh({"dp": world}, device="cpu")
    w0 = [a for _, a in sorted(np.load(src).items(),
                               key=lambda kv: int(kv[0][1:]))]
    x, y = make_data()
    out = {}
    for name, (kw, (kind, clip), n_accum) in RUNS.items():
        opt = (DistriOptimizer(make_model(w0), (x, y), tnn.MSECriterion(),
                               batch_size=BATCH, mesh=mesh, **kw)
               .set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
               .set_end_when(Trigger.max_epoch(EPOCHS))
               .set_gradient_accumulation(n_accum))
        if kind == "norm":
            opt.set_gradient_clipping_by_l2_norm(clip)
        else:
            opt.set_constant_gradient_clipping(*clip)
        losses, norms = [], []
        fire = opt._fire_mid_epoch
        clipped = []

        def hook():
            losses.append(float(opt.state.loss))
            if clipped and clipped[0].last_norm is not None:
                norms.append(float(clipped[0].last_norm))
            return fire()
        opt._fire_mid_epoch = hook
        wrap = opt._wrap_optim

        def keep(params):
            optim = wrap(params)
            clipped.append(getattr(optim, "inner", None)
                           if opt.zero1 else optim)
            return optim
        opt._wrap_optim = keep
        model = opt.optimize()
        out[name] = {"losses": losses, "norms": norms,
                     "weights": [w.detach().numpy().copy()
                                 for w in model.get_weights()]}
    # each rank's augmentation generator is its own
    opt = DistriOptimizer(make_model(w0), (x, y), tnn.MSECriterion(),
                          batch_size=BATCH, mesh=mesh, seed=5)
    opt.set_device_augment(DeviceAugment())
    gen = opt._step_options()["generator"]
    out["generator_seed"] = gen.initial_seed()
    out["jax_free"] = not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                              or m == "bigdl_tpu"
                              or m.startswith("bigdl_tpu.")
                              for m in sys.modules)
    with open(dst, "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
