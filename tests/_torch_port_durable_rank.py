"""One gloo rank of ``tests/test_torch_port_durable.py``'s checkpoint
legs under ``DistriOptimizer``.

    python tests/_torch_port_durable_rank.py RANK WORLD STORE_FILE ROOT OUT_PKL

Starts a gloo process group through ``file://STORE_FILE`` and trains
``tests/test_distributed.py``'s MLP (12 → 8 → 1, named layers, weights
from ``RandomState(5)``) with ``SGD(0.05, momentum=0.9)`` at a global
batch of 64, checkpointing under ``ROOT``:

  world 2:  ``fsdp`` and ``zero1`` from scratch for 6 iterations, a
            checkpoint every 3 (``ROOT/fsdp``, ``ROOT/zero1``); ``fsdp9``
            uninterrupted for 9 (the band's baseline); ``fsdp_same``:
            fsdp resumed from ``fsdp``'s iteration-3 checkpoint to 6;
            ``fsdp2zero1``: zero1 resumed from ``fsdp``'s iteration 6 to 9;
            ``zero12fsdp``: fsdp from ``zero1``'s iteration 6 to 9;
  world 1:  ``fsdp2dp`` and ``zero12dp``: dp from each iteration-6
            checkpoint to 9.

Rank 0 writes each run's per-step losses, final weights and its momentum
gathered whole to ``OUT_PKL``.  Imports neither jax nor ``bigdl_tpu``; it
checks so before it writes.
"""
import os
import pickle
import shutil
import sys

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.optim import SGD, DistriOptimizer, Trigger
from bigdl_tpu_torch.parallel import mesh as mesh_lib
from bigdl_tpu_torch.parallel.allreduce import allgather_params, tree_leaves

BATCH = 64


def make_data(n=256, d=12, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d, 1).astype(np.float32)
    y = (x @ w + 0.01 * rng.randn(n, 1)).astype(np.float32)
    return x, y


def make_model():
    m = tnn.Sequential(tnn.Linear(12, 8, name="fc1"), tnn.Tanh(),
                       tnn.Linear(8, 1, name="fc2"))
    rng = np.random.RandomState(5)
    m.set_weights([(0.5 * rng.randn(*w.shape)).astype(np.float32)
                   for w in m.get_weights()])
    return m


def run(mesh, layout, ckpt, iters, data):
    model = make_model()
    opt = DistriOptimizer(model, data, tnn.MSECriterion(), batch_size=BATCH,
                          mesh=mesh, fsdp=layout == "fsdp",
                          zero1=layout == "zero1")
    opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(iters))
    opt.set_checkpoint(ckpt, Trigger.several_iteration(3))
    losses = []
    fire = opt._fire_mid_epoch

    def hook():
        losses.append(float(opt.state.loss))
        return fire()
    opt._fire_mid_epoch = hook
    opt.optimize()
    vel = opt.opt_state["velocity"]
    if layout == "fsdp":
        vel = allgather_params(vel, mesh, mask=opt._shardable)
    elif layout == "zero1":
        vel = opt._z1.gather_params(vel, mesh)
    return {"losses": losses,
            "weights": [w.numpy().copy() for w in model.get_weights()],
            "velocity": [t.numpy().copy() for t in tree_leaves(vel)]}


def copy_ckpt(src, dst, keep, rank, group):
    """``dst`` holding only ``src``'s checkpoint ``keep``; rank 0 copies,
    every rank waits for it."""
    if rank == 0:
        os.makedirs(dst)
        shutil.copytree(os.path.join(src, keep), os.path.join(dst, keep))
    dist.barrier(group=group)


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, root, out = sys.argv[3], sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    mesh_lib.init_distributed(f"file://{store}", rank, world, device="cpu")
    mesh = mesh_lib.create_mesh({"dp": world}, device="cpu")
    data = make_data()
    j = lambda name: os.path.join(root, name)
    results = {}
    if world == 2:
        results["fsdp"] = run(mesh, "fsdp", j("fsdp"), 6, data)
        results["zero1"] = run(mesh, "zero1", j("zero1"), 6, data)
        results["fsdp9"] = run(mesh, "fsdp", j("fsdp9"), 9, data)
        copy_ckpt(j("fsdp"), j("fsdp_same"), "ckpt_iter_3", rank, mesh.group)
        results["fsdp_same"] = run(mesh, "fsdp", j("fsdp_same"), 6, data)
        copy_ckpt(j("fsdp"), j("fsdp2zero1"), "ckpt_iter_6", rank,
                  mesh.group)
        results["fsdp2zero1"] = run(mesh, "zero1", j("fsdp2zero1"), 9, data)
        copy_ckpt(j("zero1"), j("zero12fsdp"), "ckpt_iter_6", rank,
                  mesh.group)
        results["zero12fsdp"] = run(mesh, "fsdp", j("zero12fsdp"), 9, data)
    else:
        for src, name in (("fsdp", "fsdp2dp"), ("zero1", "zero12dp")):
            copy_ckpt(j(src), j(name), "ckpt_iter_6", rank, mesh.group)
            results[name] = run(mesh, "dp", j(name), 9, data)
    dist.destroy_process_group()
    assert not any(m == "jax" or m.startswith(("jax.", "bigdl_tpu."))
                   or m == "bigdl_tpu" for m in sys.modules)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(results, f)


if __name__ == "__main__":
    main()
