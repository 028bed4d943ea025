"""Training across devices (≙ ``bigdl_tpu/parallel``) over
``torch.distributed``: the composed dp×fsdp×tp×sp×ep :class:`SpmdTrainer`
(``mesh``, ``tp_ops``, ``ring_attention``, ``compose``), the GPipe
``PipelineLMTrainer`` over ``pp`` (``pipeline``), and the
data-parallel pieces of ``DistriOptimizer`` (``allreduce``, ``bucketer``,
``zero``)."""
from .allreduce import (allgather_params, allreduce_gradients,
                        reduce_scatter_gradients, shardable_mask_dim0)
from .bucketer import GradBucketer
from .compose import ComposedConfig, build_trainer
from .mesh import (Mesh, create_mesh, data_sharding, get_mesh,
                   init_distributed, parse_template, set_mesh, shard_batch)
from .pipeline import pipeline_run, pipelined
from .ring_attention import ring_attention, ring_attention_shmap
from .spmd import SpmdTrainer
from .zero import Zero1Layout, Zero1Optim

__all__ = ["ComposedConfig", "GradBucketer", "Mesh", "SpmdTrainer",
           "Zero1Layout", "Zero1Optim", "allgather_params",
           "allreduce_gradients", "build_trainer", "create_mesh",
           "data_sharding", "get_mesh", "init_distributed",
           "parse_template", "pipeline_run", "pipelined",
           "reduce_scatter_gradients", "ring_attention",
           "ring_attention_shmap", "set_mesh", "shard_batch",
           "shardable_mask_dim0"]
