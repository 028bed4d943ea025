"""bigdl_tpu_torch.serving — dynamic-batching inference engine
(≙ ``bigdl_tpu/serving``).

  * :class:`BucketLadder` — the fixed power-of-two batch sizes the
    engine ever runs; requests pad up to the next bucket.
  * :class:`BatchingQueue` — bounded FIFO coalescing concurrent
    requests into micro-batches under a max-latency deadline, shedding
    (:class:`LoadShedError`) at admission when full.
  * :class:`ModelRegistry` — named, versioned models with immutable
    weight :class:`Snapshot` s and atomic hot-swap; an entry can serve
    the model's post-training int8 copy (``quantize_int8=True``).
  * :class:`ServingEngine` — warmup of every bucket, per-request
    deadline propagation, graceful drain, Recorder wiring.
  * :class:`DecodeEngine` + :class:`PagedKVCache` — token-streaming
    continuous batching for LMs: requests join and leave the decode
    batch per step, the KV cache is paged from a device pool (youngest-
    first eviction with re-prefill and replay, optional int8), per-token
    TTFT / inter-token accounting.
  * :class:`ReplicaSet` + :class:`OverloadController` — N engines behind
    one submit API: health-gated routing, wedge ejection and budgeted
    failover, exactly-once completion, probe readmission, priority shed
    and brownout, to an int8 entry with ``build_replica_set(
    int8_degrade=True)`` (``build_replica_set``,
    ``build_decode_replica_set``).
  * :class:`CanaryPublisher` — weight publication through one quiesced
    canary with a golden gate, fleet-wide promotion, bitwise rollback.
  * :class:`WeightStreamPublisher` — trigger-fired live train→serve
    weight streaming through the canary gate.
  * :mod:`arrivals` — seeded open-loop arrival traces in virtual time.

Quick start::

    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.serving import ModelRegistry, ServingEngine

    reg = ModelRegistry()
    reg.register("lm", T.build("base", seed=0), input_shape=(512,),
                 dtype=np.int32)
    eng = ServingEngine(reg, max_batch=8).warmup()
    logits = eng.predict("lm", tokens)        # or submit(...) -> Future
    eng.shutdown(drain=True)

    dec = DecodeEngine(reg, "lm", slots=8, max_context=1024,
                       max_prompt=512, max_new_tokens=64).warmup()
    out = dec.predict("lm", prompt)           # prompt + 64 new tokens
    for tok in dec.stream("lm", prompt).tokens():
        ...
    dec.shutdown()
"""
from . import arrivals
from .buckets import BucketLadder
from .decode import DecodeEngine, DecodeStream, build_decode_replica_set
from .engine import ServingEngine
from .kvcache import PagedKVCache, PagePoolError
from .queue import BatchingQueue, EngineClosedError, LoadShedError, Request
from .registry import ModelEntry, ModelRegistry, Snapshot
from .replicas import (CanaryPublisher, CanaryRejectedError,
                       NoHealthyReplicaError, OverloadController,
                       ReplicaSet, build_replica_set)
from .stream import WeightStreamPublisher

__all__ = ["BatchingQueue", "BucketLadder", "CanaryPublisher",
           "CanaryRejectedError", "DecodeEngine", "DecodeStream",
           "EngineClosedError", "LoadShedError", "ModelEntry",
           "ModelRegistry", "NoHealthyReplicaError", "OverloadController",
           "PagePoolError", "PagedKVCache", "ReplicaSet", "Request",
           "ServingEngine", "Snapshot", "WeightStreamPublisher", "arrivals",
           "build_decode_replica_set", "build_replica_set"]
