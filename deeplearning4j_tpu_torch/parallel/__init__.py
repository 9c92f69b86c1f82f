"""Parallelism and distribution (DL4J deeplearning4j-scaleout parity).

Counterpart of the JAX package's `parallel/`. The port runs one process
per rank in a `torch.distributed` process group (`distributed.py`) and
builds its mesh over that group's world (`mesh.py`). Data parallelism
runs in the containers' own fit under a `ShardingPlan` (`plan.py`, with
ZeRO stages and rule sharding; with ``model > 1`` the layers compute
tensor- and expert-parallel with their pieces, `tensor.py`), which
`ParallelWrapper` (SYNC_GRADIENTS and AVERAGING) drives; `SharedGradientsTrainer` exchanges
threshold-encoded gradients (`encoding.py`) over a socket transport
(`transport.py`); `ParallelInference` serves one replica per device,
or a tensor-parallel servable under a plan.
Sequence parallelism runs ring attention over the mesh's ``seq`` axis
(`ring.py`, `ContextParallelTrainer` in `context.py`); pipeline
parallelism splits a transformer torso over its ``stage`` axis
(`pipeline.py`). Names resolve lazily (`util/lazy.py`).
"""
from deeplearning4j_tpu_torch.util.lazy import lazy_exports

_EXPORTS = {
    "MeshConfig": "mesh", "build_mesh": "mesh", "data_sharding": "mesh",
    "replicated_sharding": "mesh",
    "ParallelWrapper": "wrapper", "TrainingMode": "wrapper",
    "InferenceMode": "inference", "ParallelInference": "inference",
    "EncodingHandler": "encoding", "bitmap_decode": "encoding",
    "bitmap_encode": "encoding", "threshold_decode": "encoding",
    "threshold_encode": "encoding", "threshold_encode_values": "encoding",
    "values_decode": "encoding",
    "SocketTransport": "transport",
    "ShardingRules": "sharding", "shard_params": "sharding",
    "logical_to_mesh": "sharding",
    "DistributedConfig": "distributed",
    "initialize_distributed": "distributed",
    "blockwise_attention": "ring", "make_ring_attention": "ring",
    "ring_self_attention": "ring",
    "ContextParallelTrainer": "context",
    "PipelineParallelTrainer": "pipeline",
    "LoopbackTransport": "shared", "SharedGradientsTrainer": "shared",
    "sharded_fraction": "zero", "zero_place": "zero", "zero_spec": "zero",
    "ShardingPlan": "plan", "active_plan": "plan", "parse_plan": "plan",
    "use_mesh": "plan",
}

__all__ = [
    "MeshConfig", "build_mesh", "data_sharding", "replicated_sharding",
    "ParallelWrapper", "TrainingMode",
    "ParallelInference", "InferenceMode",
    "EncodingHandler", "threshold_encode", "threshold_decode",
    "threshold_encode_values", "values_decode",
    "bitmap_encode", "bitmap_decode", "SocketTransport",
    "ShardingRules", "shard_params", "logical_to_mesh",
    "DistributedConfig", "initialize_distributed",
    "ring_self_attention", "make_ring_attention", "blockwise_attention",
    "ContextParallelTrainer", "PipelineParallelTrainer",
    "SharedGradientsTrainer", "LoopbackTransport",
    "zero_place", "zero_spec", "sharded_fraction",
    "ShardingPlan", "use_mesh", "active_plan", "parse_plan",
]
__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
