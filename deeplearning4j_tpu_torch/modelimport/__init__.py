"""Model import (DL4J deeplearning4j-modelimport parity) + the DL4J
checkpoint artifact bridge (ModelSerializer zip format, both directions):
the port's counterpart of the JAX package's `modelimport/`. Exports
resolve lazily (`util/lazy.py`)."""
from deeplearning4j_tpu_torch.util.lazy import lazy_exports

_EXPORTS = {
    "KerasModelImport": "keras",
    **dict.fromkeys(("add_normalizer_to_model", "restore_computation_graph",
                     "restore_multilayer_network", "restore_normalizer",
                     "save_dl4j_model"), "dl4j"),
}
__all__ = ["KerasModelImport", "add_normalizer_to_model",
           "restore_computation_graph", "restore_multilayer_network",
           "restore_normalizer", "save_dl4j_model"]
__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
