"""One gloo rank of the sync-BN cases of
``tests/test_torch_port_resnet_variants.py``.

    python tests/_torch_port_syncbn_rank.py RANK WORLD STORE_FILE IN_NPZ OUT_PKL

Starts a gloo process group of WORLD ranks through ``file://STORE_FILE``
and builds the CIFAR ResNet-8 with the weights and batch-norm state of
``IN_NPZ`` (its ``w*`` and ``s*`` arrays, the reference's order).  This
rank takes its block of the batch ``x``, ``y``.  For ``sync_bn_axis="dp"``
and for no sync, one training forward and backward: the ClassNLL loss of
its block, the gradients averaged over the ranks, the outputs gathered
into the global batch's order, and the new batch-norm state.  Then, with
the sync, one ``DistriOptimizer`` step of ``SGD(0.05)`` over the global
batch: the weights and state after it.  Writes all of it to ``OUT_PKL``.
Imports neither jax nor ``bigdl_tpu``; it checks so before it writes.
"""
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.models.convert import from_jax_weights
from bigdl_tpu_torch.optim import SGD, DistriOptimizer, Trigger
from bigdl_tpu_torch.parallel import mesh as mesh_lib


def build(data, sync):
    m = resnet.build(class_num=10, depth=8, dataset="cifar10",
                     sync_bn_axis="dp" if sync else None, device="cpu")
    n_w = sum(k.startswith("w") for k in data.files)
    n_s = sum(k.startswith("s") for k in data.files)
    from_jax_weights([data[f"w{i}"] for i in range(n_w)], m,
                     [data[f"s{i}"] for i in range(n_s)])
    return m


def one_pass(model, x, y, world):
    """(gathered outputs, mean gradients, new state) of one training
    forward and backward on this rank's block."""
    params = model.param_dict()
    leaves = [p for sub in params.values() for p in sub.values()]
    ctx = tnn.Ctx(state=model.initial_state(), training=True)
    out = model.apply(params, x, ctx)
    loss = tnn.ClassNLLCriterion().loss(out, y)
    grads = [g.clone() for g in torch.autograd.grad(loss, leaves)]
    for g in grads:
        dist.all_reduce(g)
        g /= world
    parts = [torch.empty_like(out) for _ in range(world)]
    dist.all_gather(parts, out.detach().contiguous())
    state = [t.detach().numpy().copy() for sub in ctx.new_state.values()
             for t in sub.values()]
    return (torch.cat(parts).numpy(), [g.numpy() for g in grads], state)


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, in_npz, out_pkl = sys.argv[3:6]
    mesh_lib.init_distributed(f"file://{store}", rank, world, device="cpu")
    mesh = mesh_lib.create_mesh({"dp": world}, device="cpu")
    data = np.load(in_npz)
    x, y = data["x"], data["y"]
    xs = torch.from_numpy(mesh_lib.shard_rows(x, rank, world).copy())
    ys = torch.from_numpy(mesh_lib.shard_rows(y, rank, world).copy())
    out = {name: one_pass(build(data, sync), xs, ys, world)
           for name, sync in (("sync", True), ("no_sync", False))}
    model = build(data, True)
    (DistriOptimizer(model, (x, y), tnn.ClassNLLCriterion(),
                     batch_size=len(x), mesh=mesh)
     .set_optim_method(SGD(learning_rate=0.05))
     .set_end_when(Trigger.max_iteration(1))).optimize()
    out["distri_step"] = ([w.numpy().copy() for w in model.get_weights()],
                          [s.numpy().copy() for s in model.state_list()])
    dist.destroy_process_group()
    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "bigdl_tpu")
                    or m.startswith(("jax.", "bigdl_tpu.")))
    if leaked:
        raise SystemExit(f"the rank imported {leaked}")
    with open(out_pkl, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
