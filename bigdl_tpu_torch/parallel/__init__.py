"""Training across devices (≙ ``bigdl_tpu/parallel``): the single-device
:class:`SpmdTrainer`, and the data-parallel pieces of ``DistriOptimizer``
over ``torch.distributed`` (``mesh``, ``allreduce``, ``bucketer``,
``zero``)."""
from .allreduce import (allgather_params, allreduce_gradients,
                        reduce_scatter_gradients, shardable_mask_dim0)
from .bucketer import GradBucketer
from .mesh import (Mesh, create_mesh, data_sharding, get_mesh,
                   init_distributed, set_mesh, shard_batch)
from .spmd import SpmdTrainer
from .zero import Zero1Layout, Zero1Optim

__all__ = ["GradBucketer", "Mesh", "SpmdTrainer", "Zero1Layout", "Zero1Optim",
           "allgather_params", "allreduce_gradients", "create_mesh",
           "data_sharding", "get_mesh", "init_distributed",
           "reduce_scatter_gradients", "set_mesh", "shard_batch",
           "shardable_mask_dim0"]
