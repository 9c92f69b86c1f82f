"""Serving on PyTorch/CUDA: batcher, registry, HTTP server, CLI, the
decode engine and its KV cache, quantized variants, and the fleet — the
replica supervisor (`fleet`), the resilient router (`router`) and the
SLO-gated rollout controller (`rollout`).

The reference's names are exported lazily (`util/lazy.py`): this package
imports none of its submodules eagerly.

    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
    registry = ModelRegistry()
    registry.deploy("lenet", "zoo:LeNet")
    server = ModelServer(registry, port=8500)
"""
from deeplearning4j_tpu_torch.util.lazy import lazy_exports

_EXPORTS = {
    **dict.fromkeys((
        "DEFAULT_BUCKETS", "DeadlineExceededError", "ServerDrainingError",
        "ServerOverloadedError", "ServingError", "ShapeBucketedBatcher"),
        "batcher"),
    **dict.fromkeys(("DecodeConfig", "DecodeEngine", "DecodeScheduler",
                     "GenerateRequest", "ServedLM"), "decode"),
    **dict.fromkeys(("AutoscaleConfig", "InProcessReplica", "Replica",
                     "ReplicaSpec", "ReplicaSupervisor", "SubprocessReplica"),
                    "fleet"),
    "KVCacheState": "kvcache",
    **dict.fromkeys(("QTensor", "quality_delta", "quantize_params"),
                    "quantize"),
    **dict.fromkeys(("ModelLoadError", "ModelRegistry", "ServedModel",
                     "ServableVersion", "load_servable"), "registry"),
    **dict.fromkeys(("RolloutController", "read_blessed"), "rollout"),
    **dict.fromkeys(("CircuitBreaker", "ResilientRouter", "RouterServer"),
                    "router"),
    **dict.fromkeys(("ModelServer", "retry_after_seconds"), "server"),
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
