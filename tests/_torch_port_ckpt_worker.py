"""Worker of ``tests/test_torch_port_ckpt_faults.py``: one deterministic
training run of the port with async manifest checkpointing, killable
mid-write (the port's counterpart of ``tests/_ckpt_worker.py``'s local
mode).

    python tests/_torch_port_ckpt_worker.py CKPT_DIR OUT_NPZ [iters=<n>]
        [ckpt_every=<n>] [preempt] [step_sleep=<ms>]

The run: the reference worker's fixture (256 × 10 inputs from
``RandomState(0)``, a linear target, batches of 32 under the
epoch-seeded shuffle of seed 4, ``Linear(10, 16) → Tanh → Linear(16,
1)`` with weights from ``RandomState(11)``, MSE, ``Adam(1e-2)``), on the
CPU, checkpointing every ``ckpt_every`` iterations and resuming from
whatever intact checkpoint the directory holds.  The parent arms
``BIGDL_CKPT_FAULT`` (``bigdl_tpu_torch.checkpoint.faults``) to kill the
process at a byte offset inside a shard or manifest write (exit code
42).  With ``preempt`` the run trains until the parent's SIGTERM, prints
``iter <n>`` each iteration, commits a final checkpoint and exits 0.
The final weights and Adam moments land in ``OUT_NPZ``.  Imports
neither jax nor ``bigdl_tpu``; it checks so before it writes.
"""
import sys
import time

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.data.dataset import DataSet
from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger
from bigdl_tpu_torch.parallel.allreduce import tree_leaves


def build():
    rng = np.random.RandomState(0)
    x = rng.randn(256, 10).astype(np.float32)
    w = rng.randn(10, 1).astype(np.float32)
    y = (x @ w).astype(np.float32)
    ds = DataSet.minibatch_arrays(x, y, batch_size=32, shuffle=True, seed=4)
    model = nn.Sequential(nn.Linear(10, 16, name="fc1"), nn.Tanh(),
                          nn.Linear(16, 1, name="fc2"))
    wr = np.random.RandomState(11)
    model.set_weights([(0.3 * wr.randn(*w.shape)).astype(np.float32)
                       for w in model.get_weights()])
    return model, ds


def main():
    ckpt_dir, out = sys.argv[1], sys.argv[2]
    opts = dict(kv.split("=", 1) for kv in sys.argv[3:] if "=" in kv)
    flags = {a for a in sys.argv[3:] if "=" not in a}
    iters = int(opts.get("iters", 9))
    ckpt_every = int(opts.get("ckpt_every", 2))
    step_sleep = float(opts.get("step_sleep", 0)) / 1e3
    preempt = "preempt" in flags
    torch.set_num_threads(1)

    model, ds = build()
    end = Trigger.max_iteration(10_000 if preempt else iters)

    class _Tattle(Trigger):
        """The end trigger, announcing each iteration (the parent
        times its SIGTERM on these lines)."""

        def __call__(self, state):
            print(f"iter {state.iteration}", flush=True)
            if step_sleep:
                time.sleep(step_sleep)
            return end(state)

    opt = (LocalOptimizer(model, ds, nn.MSECriterion(), batch_size=32,
                          device="cpu")
           .set_optim_method(Adam(learning_rate=1e-2))
           .set_end_when(_Tattle())
           .set_checkpoint(ckpt_dir,
                           trigger=Trigger.several_iteration(ckpt_every),
                           handle_preemption=preempt))
    pre = opt._ckpt_mgr.restore_latest()
    if pre is not None:
        print(f"RESUME iteration={pre[2]['iteration']} "
              f"epoch={pre[2]['epoch']}", flush=True)
    opt.optimize()

    leaves = [w.numpy().copy() for w in model.get_weights()]
    leaves += [t.numpy().copy() for k in ("m", "v")
               for t in tree_leaves(opt.opt_state[k])]
    assert not any(m == "jax" or m.startswith(("jax.", "bigdl_tpu."))
                   or m == "bigdl_tpu" for m in sys.modules)
    np.savez(out, *leaves)
    print(f"WORKER DONE iteration={opt.state.iteration}", flush=True)


if __name__ == "__main__":
    main()
