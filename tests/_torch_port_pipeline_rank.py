"""One gloo rank of the port's pipeline tests
(``tests/test_torch_port_pipeline.py``).

    python tests/_torch_port_pipeline_rank.py RANK WORLD STORE_FILE JOB_JSON OUT_PKL

Starts a gloo process group through ``file://STORE_FILE`` and runs each
job of ``JOB_JSON`` in order, every rank the same jobs:

  * ``"pipe"``: a TransformerLM (``cfg``: ``TransformerConfig`` keywords;
    weights ``weights``, the reference's, through ``from_jax_params``)
    trained by the port's ``PipelineLMTrainer`` on the mesh ``mesh`` with
    the trainer keywords ``trainer`` and the optimizer ``optim`` for
    ``steps`` steps on the batch ``batch``; with ``telemetry``, the last
    step record's scalars and the recorder's gauges.  Every rank keeps
    the losses and the local shapes of its optimizer state, rank 0 the
    merged parameters;
  * ``"compose"``: ``compose.build_trainer`` on the template ``template``
    (``config``: more ``ComposedConfig`` keywords), its type and the
    losses of ``steps`` steps;
  * ``"step_refusals"``: the messages of ``step`` (None where it took the
    batch) on the batch cut to one row fewer, two rows fewer and one
    position fewer;
  * ``"pipelined"``: ``pipelined`` over a mesh ``{"pp": WORLD}`` on the
    stage function ``tanh(x @ w)``, rank r holding ``ws[r]``: the output
    (last rank), the gradient of every rank's ``w`` and of ``x`` (rank
    0) for ``out.sum()``.

Writes the results to ``OUT_PKL``.  Imports neither jax nor
``bigdl_tpu``; it checks so before it writes.
"""
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
import torch

from bigdl_tpu_torch.models.convert import from_jax_params
from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerLM)
from bigdl_tpu_torch.observability import Recorder
from bigdl_tpu_torch.optim import SGD, Adam, AdamW
from bigdl_tpu_torch.parallel import mesh as mesh_lib
from bigdl_tpu_torch.parallel.compose import ComposedConfig, build_trainer
from bigdl_tpu_torch.parallel.pipeline import PipelineLMTrainer, pipelined

OPTIMS = {"SGD": SGD, "Adam": Adam, "AdamW": AdamW}


def spawn(world, jobs, d):
    """Start ``world`` ranks on ``jobs`` in the directory ``d``; returns
    what :func:`collect` takes (the ranks run meanwhile)."""
    d = Path(d)
    (d / "jobs.json").write_text(json.dumps(jobs))
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))
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


def _model(job):
    model = TransformerLM(TransformerConfig(**job["cfg"]))
    with np.load(job["weights"]) as z:
        w = {}
        for name in z.files:
            mod, k = name.split("|")
            w.setdefault(mod, {})[k] = z[name]
    from_jax_params(w, model)
    return model


def _batch(job):
    with np.load(job["batch"]) as z:
        return z["x"], z["y"]


def _shapes(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _shapes(tree[k], prefix + (k,))
    elif isinstance(tree, torch.Tensor) and tree.dim() > 0:
        yield "/".join(prefix), tuple(tree.shape)


def pipe(job, rank):
    name, kw = job["optim"]
    tr = PipelineLMTrainer(_model(job), OPTIMS[name](**kw),
                           mesh_lib.create_mesh(job["mesh"], device="cpu"),
                           seed=0, **job.get("trainer", {}))
    rec = None
    if job.get("telemetry"):
        rec = Recorder()
        tr.set_telemetry(rec)
    x, y = _batch(job)
    losses = [float(tr.step(x, y)) for _ in range(job["steps"])]
    merged = tr.merge()
    out = {"losses": losses, "opt_shapes": dict(_shapes(tr.opt_state)),
           "stage_modules": sorted(tr._blocks)}
    if rec is not None:
        out["health"] = rec.recent_records(rec_type="step")[-1]["scalars"]
        out["gauges"] = dict(rec.snapshot()["gauges"])
    if rank == 0:
        out["merged"] = {mod: {k: t.detach().numpy().copy()
                               for k, t in sub.items()}
                         for mod, sub in merged.items()}
    return out


def compose(job):
    cfg = ComposedConfig(job["template"], **job.get("config", {}))
    tr = build_trainer(_model(job), SGD(learning_rate=0.1), cfg,
                       device="cpu")
    x, y = _batch(job)
    return {"type": type(tr).__name__,
            "losses": [float(tr.step(x, y)) for _ in range(job["steps"])]}


def step_refusals(job):
    tr = PipelineLMTrainer(_model(job), SGD(learning_rate=0.1),
                           mesh_lib.create_mesh(job["mesh"], device="cpu"),
                           **job.get("trainer", {}))
    x, y = _batch(job)
    out = []
    for rows, cols in ((x.shape[0] - 1, x.shape[1]),
                       (x.shape[0] - 2, x.shape[1]),
                       (x.shape[0], x.shape[1] - 1)):
        try:
            tr.step(x[:rows, :cols], y[:rows, :cols])
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def run_pipelined(job, rank, world):
    mesh = mesh_lib.create_mesh({"pp": world}, device="cpu")
    with np.load(job["data"]) as z:
        ws, x = z["ws"], z["x"]
    w = torch.tensor(ws[rank], requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    f = pipelined(lambda p, h: torch.tanh(h @ p["w"]), mesh,
                  job["n_micro"])
    out = f({"w": w}, xt)
    if rank == world - 1:
        out.sum().backward()
    else:
        out.backward(torch.zeros_like(out))
    return {"out": out.detach().numpy(), "gw": w.grad.numpy(),
            "gx": None if xt.grad is None else xt.grad.numpy()}


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, job_file, out_file = sys.argv[3:6]
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    mesh_lib.init_distributed(f"file://{store}", rank, world, device="cpu")
    with open(job_file) as f:
        jobs = json.load(f)
    out = {}
    for job in jobs:
        kind = job.get("kind", "pipe")
        if kind == "pipe":
            out[job["name"]] = pipe(job, rank)
        elif kind == "compose":
            out[job["name"]] = compose(job)
        elif kind == "step_refusals":
            out[job["name"]] = step_refusals(job)
        else:
            out[job["name"]] = run_pipelined(job, rank, world)
    out["jax_free"] = not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                              or m == "bigdl_tpu"
                              or m.startswith("bigdl_tpu.")
                              for m in sys.modules)
    torch.distributed.destroy_process_group()
    with open(out_file, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
