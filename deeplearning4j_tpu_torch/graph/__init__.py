"""Graph data structures + embeddings (DL4J deeplearning4j-graph parity).

Reference: `deeplearning4j-graph/.../graph/{api,data,iterator,models}/`:
IGraph, random-walk iterators, DeepWalk with hierarchical softmax. The
port of the JAX package's `graph/`: DeepWalk reuses the batched
SequenceVectors trainer on the card; walks are "sentences", vertices are
"words" (exactly the DeepWalk reduction). Names are exported lazily.
"""
from deeplearning4j_tpu_torch.util.lazy import lazy_exports

_EXPORTS = {"Graph": "graph", "DeepWalk": "deepwalk",
            "GraphVectors": "deepwalk"}
__all__ = ["Graph", "DeepWalk", "GraphVectors"]
__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
