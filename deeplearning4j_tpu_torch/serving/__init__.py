"""Serving on PyTorch/CUDA: batcher, registry, HTTP server, CLI, the
decode engine and its KV cache, quantized variants.

The reference's names of the ported modules are exported lazily
(`util/lazy.py`): this package imports none of its submodules eagerly.
The fleet, router and rollout (ROADMAP A.14) are not ported, so their
names are absent.

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
    "KVCacheState": "kvcache",
    **dict.fromkeys(("QTensor", "quality_delta", "quantize_params"),
                    "quantize"),
    **dict.fromkeys(("ModelLoadError", "ModelRegistry", "ServedModel",
                     "ServableVersion", "load_servable"), "registry"),
    **dict.fromkeys(("ModelServer", "retry_after_seconds"), "server"),
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
