"""Trainer factories for the elastic supervisor's rank processes in
``tests/test_torch_port_elastic.py``: module-level (each rank imports
this module), and importing no JAX."""
import numpy as np
import torch

from bigdl_tpu_torch.models import transformer as T
from bigdl_tpu_torch.models.convert import from_jax_params
from bigdl_tpu_torch.optim import Adam
from bigdl_tpu_torch.parallel.spmd import SpmdTrainer

CFG = dict(n_layers=1, d_model=64, n_heads=2, d_ff=128, vocab_size=64,
           max_len=32)


def batch(s):
    rs = np.random.RandomState(1234 + s)
    t = rs.randint(0, 64, (8, 17))
    return t[:, :-1], t[:, 1:]


def factory(mesh, weights=None):
    """TransformerLM (a cut ``tiny``) under ``Adam(1e-3)`` on ``mesh``;
    with ``weights``, its initial parameters from that ``.npz`` of the
    reference's flat params (``<module>::<param>`` keys)."""
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    model = T.build("tiny", device=mesh.device, seed=0, dropout=0.0, **CFG)
    if weights is not None:
        tree = {}
        with np.load(weights) as z:
            for key in z.files:
                mod, name = key.split("::")
                tree.setdefault(mod, {})[name] = z[key]
        from_jax_params(tree, model)
    return SpmdTrainer(model, Adam(learning_rate=1e-3), mesh=mesh,
                       fsdp=False, seed=0, device=mesh.device)


class Factory:
    """:func:`factory` with ``weights`` bound (a picklable callable)."""

    def __init__(self, weights):
        self.weights = weights

    def __call__(self, mesh):
        return factory(mesh, self.weights)
