"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

The module paths mirror the JAX package one for one, so each module's
counterpart is found under the same name. The port imports torch and never
jax, and nothing from the JAX package: where it needs code from a
framework-neutral module there, it keeps its own copy.

Entry points (`MultiLayerNetwork(conf, device=None)`, `load_model`,
`load_servable`, the serving CLI) run on CUDA unless the caller asks for
the CPU, and raise when no CUDA device is present.

This module imports no layer of the port (only `util/lazy.py`, which
needs the standard library alone): `import deeplearning4j_tpu_torch`
stays light, and each layer is imported where it is used. The
reference's top-level names (`MultiLayerNetwork`, `ComputationGraph`)
resolve on first access.
"""

__version__ = "0.1.0"

from deeplearning4j_tpu_torch.util.lazy import lazy_exports

_EXPORTS = {"MultiLayerNetwork": "nn.multilayer",
            "ComputationGraph": "nn.graph"}
__all__ = ["MultiLayerNetwork", "ComputationGraph", "__version__"]
__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
