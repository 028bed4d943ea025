"""One gloo rank of ``tests/test_torch_port_operate_collectives.py``.

    python tests/_torch_port_collectives_rank.py RANK WORLD STORE OUT_PKL

Starts a gloo process group of WORLD ranks through ``file://STORE`` and
runs, every rank the same:

  * ``SpmdTrainer.account_collectives`` for TransformerLM ``tiny`` on the
    meshes ``{"dp": W}``, ``{"fsdp": W}`` (every leaf sharded) and
    ``{"tp": W}``, each on one seeded batch, then a real step on the same
    batch (the accounting must have changed nothing);
  * ``DistriOptimizer`` at dp = W with telemetry over 96 rows at batch 64
    (a ragged last batch of 32): the step records' ``collective/*``
    gauges and totals;
  * a tap opened on the main thread while Megatron's *f* runs its
    backward on another thread (as the CUDA autograd engine runs every
    backward), and while a whole fsdp step runs on another thread.

Writes rank 0's results to ``OUT_PKL``.  Imports neither jax nor
``bigdl_tpu``.
"""
import faulthandler
import sys

# armed before torch is imported: a fatal signal (an abort at exit
# included) leaves every thread's stack in the rank's log
if not faulthandler.is_enabled():
    faulthandler.enable(all_threads=True)

import pickle
import threading

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.data.dataset import DataSet
from bigdl_tpu_torch.models import transformer as T
from bigdl_tpu_torch.observability import InMemorySink, Recorder
from bigdl_tpu_torch.observability.collectives import CollectiveTap
from bigdl_tpu_torch.optim import SGD, AdamW, DistriOptimizer, Trigger
from bigdl_tpu_torch.parallel import SpmdTrainer
from bigdl_tpu_torch.parallel import mesh as mesh_lib
from bigdl_tpu_torch.parallel import tp_ops
from bigdl_tpu_torch.parallel.allreduce import tree_leaves


def _batch(world):
    ids = np.random.RandomState(5).randint(0, 256, (2 * world, 33)) \
        .astype(np.int32)
    return ids[:, :-1], ids[:, 1:]


def accounted(axes, world):
    """account_collectives on one batch, then the same batch's real step
    from the same state: the accounting's effects must be undone."""
    mesh = mesh_lib.create_mesh({axes: world}, device="cpu")
    model = T.build("tiny", device="cpu", seed=0)
    tr = SpmdTrainer(model, AdamW(1e-3), mesh=mesh, seed=0,
                     min_fsdp_size=1, device="cpu")
    rec = Recorder()
    tr.set_telemetry(rec, health=False, capture_cost=False)
    tok, tgt = _batch(world)
    tr.init()
    before = [t.detach().clone() for t in tree_leaves(tr.params)]
    got = tr.account_collectives(tok, tgt)
    unchanged = tr._step_count == 0 and all(
        torch.equal(a, b) for a, b in zip(before, tree_leaves(tr.params)))
    records = len(rec.recent_records(rec_type="step"))
    gauges = {k: v for k, v in rec.snapshot()["gauges"].items()
              if k.startswith(("collective/", "comm/group."))}
    loss = float(tr.step(tok, tgt))
    full = tr.full_params()
    grad_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(full))
    return {"acct": got, "unchanged": unchanged, "records_before": records,
            "gauges": gauges, "loss": loss, "grad_bytes": grad_bytes}


def _on_another_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(120)
    assert not t.is_alive(), "the other thread did not finish"


def elsewhere(world):
    """Collectives issued on threads other than the one that opened the
    tap: *f*'s backward all-reduce, and an fsdp step's gathers and
    scatters (held against ``account_collectives`` on one thread)."""
    mesh = mesh_lib.create_mesh({"tp": world}, device="cpu")
    x = torch.ones(4, 8, requires_grad=True)
    with CollectiveTap(mesh.group_labels()) as tap:
        y = tp_ops.copy_to_group(x, mesh.group_of(("tp",)))
        forward = list(tap.ops)
        _on_another_thread(lambda: y.sum().backward())
    backward = list(tap.ops)
    mesh = mesh_lib.create_mesh({"fsdp": world}, device="cpu")
    tr = SpmdTrainer(T.build("tiny", device="cpu", seed=0), AdamW(1e-3),
                     mesh=mesh, seed=0, min_fsdp_size=1, device="cpu")
    tok, tgt = _batch(world)
    same_thread = tr.account_collectives(tok, tgt)
    with CollectiveTap(mesh.group_labels()) as step_tap:
        _on_another_thread(lambda: tr.step(tok, tgt))
    return {"forward": forward, "backward": backward,
            "step_same_thread": same_thread,
            "step_other_thread": step_tap.publish(None)}


def ragged(world):
    mesh = mesh_lib.create_mesh({"dp": world}, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((96, 12)).astype(np.float32)
    y = (rng.integers(0, 3, 96) + 1).astype(np.float32)
    model = nn.Sequential(nn.Linear(12, 16), nn.ReLU(), nn.Linear(16, 3),
                          nn.LogSoftMax())
    ds = DataSet.minibatch_arrays(x, y, 64, shuffle=False, drop_last=False)
    mem = InMemorySink()
    rec = Recorder(sinks=[mem])
    opt = (DistriOptimizer(model, ds, nn.ClassNLLCriterion(), batch_size=64,
                           mesh=mesh)
           .set_optim_method(SGD(learning_rate=0.1))
           .set_end_when(Trigger.max_epoch(1))
           .set_telemetry(rec))
    opt.optimize()
    return [{"gauges": {k: v for k, v in r["gauges"].items()
                        if k.startswith("collective/")},
             "counters": {k: v for k, v in r["counters"].items()
                          if k.startswith("collective/")}}
            for r in mem.steps()]


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, out_file = sys.argv[3:5]
    torch.set_num_threads(1)
    mesh_lib.init_distributed(f"file://{store}", rank, world, device="cpu")
    out = {name: accounted(name, world) for name in ("dp", "fsdp", "tp")}
    out["ragged"] = ragged(world)
    out["elsewhere"] = elsewhere(world)
    out["jax_free"] = not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                              or m == "bigdl_tpu"
                              or m.startswith("bigdl_tpu.")
                              for m in sys.modules)
    torch.distributed.destroy_process_group()
    if rank == 0:
        with open(out_file, "wb") as f:
            pickle.dump(out, f)


if __name__ == "__main__":
    main()
