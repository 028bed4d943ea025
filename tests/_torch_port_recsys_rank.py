"""One gloo rank of ``tests/test_torch_port_recsys.py``'s spawned world
(4 ranks, started once for the module):

  ``python _torch_port_recsys_rank.py RANK WORLD STORE CFG_JSON OUT_PKL``

Every rank runs, in order:

  * ``exchange(4)``: ``ShardedEmbeddingBag`` over a ``{"tp": 4}`` mesh of
    the whole world: this rank's block of the output and of the table's
    gradient for the plain path (every combiner, per-id weights, twice
    for the repeat), the dedup path, and the exchange's accounting (a
    ``CollectiveTap`` and a recorder handed in);
  * ``exchange(2)``: the same bag over the ``tp`` axis of a
    ``{"dp": 2, "tp": 2}`` mesh (2 shards on subgroups);
  * ``distri``: a dp=2 ``DistriOptimizer`` of the two-tower over
    ``sharded_rating_dataset`` on a subgroup of 2 ranks: ranks 0 and 1
    train straight through, ranks 2 and 3 train one epoch with a
    checkpoint and resume it in a fresh optimizer.

The inputs come from :func:`inputs` (numpy seeds, the test draws the
same) and from ``CFG_JSON`` (the two-tower's initial weights and the
rating shards the test wrote).  Writes its results to ``OUT_PKL``.
Imports neither jax nor ``bigdl_tpu``; it checks so before it writes."""
import faulthandler
import sys

# armed before torch is imported: a fatal signal (an abort at exit
# included) leaves every thread's stack in the rank's log
if not faulthandler.is_enabled():
    faulthandler.enable(all_threads=True)

import json
import os
import pickle
import subprocess
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
V, D, B, L = 100, 16, 32, 12
CASES = ("sum", "mean", "sqrtn", "weighted", "dedup")


def inputs():
    """The exchange's inputs: an unpadded (V, D) table, (B, L) 1-based ids
    with padding (20 distinct ids, so that dedup bites), per-id weights
    and the output's gradient."""
    r = np.random.RandomState(0)
    table = r.randn(V, D).astype(np.float32)
    ids = np.random.RandomState(3).randint(0, 21, (B, L)).astype(np.int32)
    ids[:, -2:] = 0
    wts = np.random.RandomState(11).rand(B, L).astype(np.float32)
    gout = np.random.RandomState(7).randn(B, D).astype(np.float32)
    return table, ids, wts, gout


def spawn(world, cfg, d):
    """Start ``world`` ranks with the config ``cfg`` in the directory
    ``d``; returns what :func:`collect` takes (the ranks run
    meanwhile)."""
    d = Path(d)
    (d / "cfg.json").write_text(json.dumps(cfg))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return d, [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(r), str(world),
         str(d / "store"), str(d / "cfg.json"), str(d / f"out{r}.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def collect(started, timeout=240):
    """Every rank's results (rank 0 first); raises with each rank's log
    tail if a rank failed."""
    d, procs = started
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"ranks exited {codes}:\n" + "\n".join(
            log[-3000:] for log in logs))
    return [pickle.loads((d / f"out{r}.pkl").read_bytes())
            for r in range(len(procs))]


def exchange(mesh, axis="tp"):
    """This rank's output block and table-gradient block for every case,
    and the accounting of one plain lookup."""
    import torch
    from bigdl_tpu_torch.embedding import (ShardedEmbeddingBag,
                                           dedup_for_mesh, pad_table)
    from bigdl_tpu_torch.observability import Recorder
    from bigdl_tpu_torch.observability.collectives import CollectiveTap

    table, ids, wts, gout = inputs()
    out = {}
    for case in CASES:
        combiner = case if case in ("mean", "sqrtn") else "sum"
        bag = ShardedEmbeddingBag(V, D, mesh=mesh, axis=axis,
                                  combiner=combiner,
                                  gen=torch.Generator().manual_seed(0))
        lo, hi = bag.row_bounds()
        full = pad_table(torch.from_numpy(table), bag.n_shards)
        k, n = bag._axis.k, bag.n_shards
        g_blk = torch.from_numpy(gout[k * B // n:(k + 1) * B // n])
        if case == "dedup":
            uniq, inv = dedup_for_mesh(ids, n)
            x = (torch.from_numpy(uniq), torch.from_numpy(inv))
        elif case == "weighted":
            x = (torch.from_numpy(ids), torch.from_numpy(wts))
        else:
            x = torch.from_numpy(ids)

        def run():
            w = full[lo:hi].clone().requires_grad_()
            y = bag.run({bag.name: {"weight": w}}, x)[0]
            (g,) = torch.autograd.grad((y * g_blk).sum(), [w])
            return y.detach().numpy(), g.numpy()
        if case == "sum":
            rec = Recorder()
            bag.set_recorder(rec)
            with CollectiveTap(mesh.group_labels()) as tap:
                y, g = run()
            bag.set_recorder(None)
            out["accounting"] = {
                "ops": [(op, rb) for op, rb, _, _ in tap.ops],
                "labels": sorted({lab for _, _, _, lab in tap.ops}),
                "gauges": {k2: v for k2, v in
                           rec.snapshot()["gauges"].items()
                           if k2.startswith(("embedding/", "comm/group."))}}
            y2, g2 = run()
            out["repeat"] = bool(np.array_equal(y, y2)
                                 and np.array_equal(g, g2))
        else:
            y, g = run()
        out[case] = {"y": y, "g": g, "rows": (lo, hi), "k": k, "n": n}
    return out


def distri(cfg, rank):
    """ranks 0, 1: 2 epochs straight; ranks 2, 3: 1 epoch with a
    checkpoint, then a fresh optimizer resumes it to 2 epochs.  Per-step
    losses, final weights and the data cursor."""
    import torch
    import torch.distributed as dist
    from bigdl_tpu_torch.data import movielens as ml
    from bigdl_tpu_torch.models import two_tower
    from bigdl_tpu_torch.models.convert import from_jax_params
    from bigdl_tpu_torch.nn import BCECriterion
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, Trigger
    from bigdl_tpu_torch.parallel.mesh import Mesh

    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = rank // 2
    mesh = Mesh({"dp": 2}, groups[pair], torch.device("cpu"))
    w0 = dict(np.load(cfg["weights"]))

    def run(epochs, ck=None):
        model = two_tower.build(cfg["n_users"], cfg["n_items"], cfg["dim"],
                                device="cpu")
        from_jax_params({"TwoTower": w0}, model)
        ds = ml.sharded_rating_dataset(cfg["shards"], batch_size=cfg["batch"],
                                       n_workers=2, seed=7)
        opt = (DistriOptimizer(model, ds, BCECriterion(), mesh=mesh)
               .set_optim_method(SGD(learning_rate=cfg["lr"]))
               .set_end_when(Trigger.max_epoch(epochs)))
        if ck is not None:
            opt.set_checkpoint(ck)
        losses = []
        fire = opt._fire_mid_epoch

        def hook():
            losses.append(float(opt.state.loss))
            return fire()
        opt._fire_mid_epoch = hook
        opt.optimize()
        return {"losses": losses,
                "weights": {k: v.detach().numpy().copy() for k, v in
                            model.param_dict()["TwoTower"].items()},
                "cursor": ds.state(), "iteration": opt.state.iteration}
    if pair == 0:
        return {"straight": run(2)}
    ck = os.path.join(cfg["dir"], "ck")
    first = run(1, ck)
    return {"first": first, "resumed": run(2, ck)}


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, cfg_file, out_file = sys.argv[3:6]
    import torch
    from bigdl_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    cfg = json.loads(Path(cfg_file).read_text())
    mesh_lib.init_distributed(f"file://{store}", rank, world, device="cpu")
    out = {"tp4": exchange(mesh_lib.create_mesh({"tp": world},
                                                device="cpu")),
           "tp2": exchange(mesh_lib.create_mesh({"dp": 2, "tp": 2},
                                                device="cpu"))}
    mesh_lib.set_mesh(None)
    out["distri"] = distri(cfg, rank)
    out["jax_free"] = not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                              or m == "bigdl_tpu"
                              or m.startswith("bigdl_tpu.")
                              for m in sys.modules)
    torch.distributed.destroy_process_group()
    with open(out_file, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
