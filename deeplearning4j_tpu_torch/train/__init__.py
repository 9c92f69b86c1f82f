"""Training: the listeners, checkpoint manifests and the CLI entry point.

The reference's names of the ported modules are exported lazily
(`util/lazy.py`): this package imports none of its submodules eagerly.
The rest of the listeners, the resilient trainer and the solvers
(ROADMAP A.12) are not ported, so their names are absent.
"""
from deeplearning4j_tpu_torch.util.lazy import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("TrainingListener", "ScoreIterationListener",
                     "PerformanceListener", "CollectScoresIterationListener"),
                    "listeners"),
    "CheckpointManager": "resilience",
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
