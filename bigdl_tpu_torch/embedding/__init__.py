"""Row-sharded embedding tables over the mesh (≙ ``bigdl_tpu/embedding``).

The recommendation workload's sparse side: model-parallel sharding of a
table's rows with an all-to-all lookup exchange (:mod:`.sharded`), a
host-side dedup stage with static bucket ladders (:mod:`.dedup`),
touched-rows gradient application that composes with the zero1 shard
space (:mod:`.optim`), and int8 row-quantized tables for serving
(:mod:`.serve`).
"""
from .sharded import (ShardedEmbeddingBag, dense_bag, pad_table,
                      row_shard_spec, reference_table)
from .dedup import (bucket_ladder, pad_ragged, dedup_for_mesh,
                    exchange_ids_without_dedup, DEFAULT_LADDER)
from .optim import (SparseRowGrad, SparseSGD, SparseAdam,
                    combine_duplicates, touched_fraction,
                    zero1_row_bounds, slice_grad_rows)
from .serve import (quantize_table, dequantize_table, quantized_dense_bag,
                    table_bytes, quantized_table_bytes)
