"""Parallel execution. The port has `ParallelInference` on one device;
the rest of the reference's `parallel/` (wrapper, plans, meshes, ring
attention, the distributed trainers) is ROADMAP A.15."""
from deeplearning4j_tpu_torch.parallel.inference import (
    InferenceMode, ParallelInference,
)

__all__ = ["InferenceMode", "ParallelInference"]
