"""One gloo rank of the port's mesh tests (``tests/test_torch_port_spmd.py``
and the mesh cases of ``test_torch_port_training.py`` and
``test_torch_port_lm_durable.py``).

    python tests/_torch_port_spmd_rank.py RANK WORLD STORE_FILE JOB_JSON OUT_PKL

Starts a gloo process group through ``file://STORE_FILE`` and runs each
job of ``JOB_JSON`` in order, every rank the same jobs:

  * ``"train"``: TransformerLM (``model``: preset and overrides; weights
    from ``weights``, the reference's, through ``from_jax_params``)
    trained by the port's ``SpmdTrainer`` on the mesh ``mesh`` with the
    trainer keywords ``trainer`` and the optimizer ``optim`` for ``steps``
    steps on the batch ``batch`` (or on a list of them in turn);
    optionally restored from ``load`` first and saved to ``save`` after;
    with ``telemetry``, the last step record's scalars (the health
    norms); with ``count_saved``, how many tensors saved for the backward
    the fsdp hooks replaced by a shard (``marks``) and kept (``kept``).
    Rank 0 keeps the losses, the global
    parameters, and every rank the local shapes of its optimizer state;
  * ``"ring"``: ``ring_attention`` over a mesh ``{"sp": WORLD}`` on the
    blocks of ``qkv`` (forward and the gradients of ``out.sum()``), each
    rank its block;
  * ``"refuse"``: a trainer that must raise ``ValueError`` (zero1 without
    dp > 1).

Writes the results to ``OUT_PKL``.  Imports neither jax nor
``bigdl_tpu``; it checks so before it writes.
"""
import faulthandler
import sys

# armed before torch is imported: a fatal signal (an abort at exit
# included) leaves every thread's stack in the rank's log
if not faulthandler.is_enabled():
    faulthandler.enable(all_threads=True)

import contextlib
import json
import os
import pickle
import subprocess
from pathlib import Path

import numpy as np
import torch

from bigdl_tpu_torch.models import transformer as T
from bigdl_tpu_torch.models.convert import from_jax_params
from bigdl_tpu_torch.optim import SGD, Adam, AdamW
from bigdl_tpu_torch.parallel import SpmdTrainer
from bigdl_tpu_torch.parallel import mesh as mesh_lib
from bigdl_tpu_torch.parallel import spmd
from bigdl_tpu_torch.parallel.ring_attention import ring_attention

OPTIMS = {"SGD": SGD, "Adam": Adam, "AdamW": AdamW}
REPO = Path(__file__).resolve().parents[1]


def spawn(world, jobs, d):
    """Start ``world`` ranks on ``jobs`` in the directory ``d``; returns
    what :func:`collect` takes (the ranks run meanwhile)."""
    d = Path(d)
    (d / "jobs.json").write_text(json.dumps(jobs))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return d, [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(r), str(world),
         str(d / "store"), str(d / "jobs.json"), str(d / f"out{r}.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def collect(started, timeout=300):
    """Every rank's results (rank 0 first); raises with the logs if a rank
    failed."""
    d, procs = started
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"ranks exited {codes}:\n" + "\n".join(
            log[-3000:] for log in logs))
    return [pickle.loads((d / f"out{r}.pkl").read_bytes())
            for r in range(len(procs))]


def save_npz(path, params):
    """``{module: {key: array}}`` as an npz of ``module|key`` arrays."""
    np.savez(path, **{f"{mod}|{k}": np.asarray(a)
                      for mod, sub in params.items() for k, a in sub.items()})


def load_npz(path):
    """``{module: {key: array}}`` from an npz of ``module|key`` arrays."""
    out = {}
    with np.load(path) as z:
        for name in z.files:
            mod, k = name.split("|")
            out.setdefault(mod, {})[k] = z[name]
    return out


@contextlib.contextmanager
def _count_saved(counts):
    """The trainer's fsdp saved-tensor hooks, counting what their pack
    returns: a shard to gather again (``marks``) or the tensor itself
    (``kept``)."""
    hooks = spmd._Gathering.hooks

    def counted(self):
        cm = hooks(self)
        pack = cm.pack_hook

        def pack_counted(t):
            out = pack(t)
            counts["marks" if isinstance(out, tuple) else "kept"] += 1
            return out
        cm.pack_hook = pack_counted
        return cm
    spmd._Gathering.hooks = counted
    try:
        yield counts
    finally:
        spmd._Gathering.hooks = hooks


def train(job, rank):
    spec = job["model"]
    model = T.build(spec["preset"], device="cpu", **spec.get("overrides", {}))
    if job.get("weights"):
        from_jax_params(load_npz(job["weights"]), model)
    name, kw = job["optim"]
    tr = SpmdTrainer(model, OPTIMS[name](**kw), mesh=job["mesh"], seed=0,
                     device="cpu", **job.get("trainer", {}))
    if job.get("telemetry"):
        from bigdl_tpu_torch.observability import Recorder
        tr.set_telemetry(Recorder())
    tr.init()
    if job.get("load"):
        tr.load_checkpoint(job["load"])
    paths = job["batch"] if isinstance(job["batch"], list) \
        else [job["batch"]]
    batches = []
    for path in paths:
        with np.load(path) as z:
            batches.append((z["x"], z["y"]))
    counts = {"marks": 0, "kept": 0}
    with (_count_saved(counts) if job.get("count_saved")
          else contextlib.nullcontext()):
        losses = [float(tr.step(*batches[i % len(batches)]))
                  for i in range(job["steps"])]
    if job.get("save"):
        tr.save_checkpoint(job["save"], sync=True)
    ev = tr.evaluate(batches[:1]) if job.get("evaluate") else None
    full = tr.full_params()
    health = None
    if job.get("telemetry"):
        health = tr.recorder.recent_records(rec_type="step")[-1]["scalars"]
    out = {"losses": losses, "evaluate": ev, "step": tr._step_count,
           "health": health, "saved": counts,
           "opt_shapes": {"/".join(p): tuple(t.shape)
                          for p, t in _paths(tr.opt_state)}}
    if rank == 0:
        out["params"] = {mod: {k: t.detach().numpy().copy()
                               for k, t in sub.items()}
                         for mod, sub in full.items()}
    tr.detach()
    return out


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, torch.Tensor) and tree.dim() > 0:
        yield prefix, tree


def ring(job, rank, world):
    mesh = mesh_lib.create_mesh({"sp": world}, device="cpu")
    with np.load(job["qkv"]) as z:
        q, k, v = (torch.from_numpy(z[n]) for n in ("q", "k", "v"))
    s = q.shape[2] // world
    blk = [t[:, :, rank * s:(rank + 1) * s].clone().requires_grad_(True)
           for t in (q, k, v)]
    out = ring_attention(*blk, mesh.group_of(("sp",)), causal=job["causal"],
                         block_k=job.get("block_k"))
    out.sum().backward()
    return {"out": out.detach().numpy(),
            "grads": [t.grad.numpy() for t in blk]}


def refuse(job):
    model = T.build("tiny", device="cpu")
    try:
        SpmdTrainer(model, Adam(1e-3), mesh=job["mesh"], zero1=True,
                    device="cpu")
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, job_file, out_file = sys.argv[3:6]
    torch.set_num_threads(1)
    mesh_lib.init_distributed(f"file://{store}", rank, world, device="cpu")
    with open(job_file) as f:
        jobs = json.load(f)
    out = {}
    for job in jobs:
        kind = job.get("kind", "train")
        if kind == "train":
            out[job["name"]] = train(job, rank)
        elif kind == "ring":
            out[job["name"]] = ring(job, rank, world)
        else:
            out[job["name"]] = refuse(job)
    out["jax_free"] = not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                              or m == "bigdl_tpu"
                              or m.startswith("bigdl_tpu.")
                              for m in sys.modules)
    torch.distributed.destroy_process_group()
    with open(out_file, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
