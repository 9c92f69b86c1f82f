"""Training: the listeners, the resilient trainer with its checkpoint
manifests, the full-batch solvers and the CLI entry point.

The reference's names are exported lazily (`util/lazy.py`): this package
imports none of its submodules eagerly.
"""
from deeplearning4j_tpu_torch.util.lazy import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("TrainingListener", "ScoreIterationListener",
                     "PerformanceListener", "CollectScoresIterationListener",
                     "TimeIterationListener", "EvaluativeListener",
                     "CheckpointListener", "ProfilerListener",
                     "DivergenceListener", "TrainingDivergedError"),
                    "listeners"),
    **dict.fromkeys(("CheckpointManager", "FaultPolicy", "FitReport",
                     "PreemptionGuard", "ResilientTrainer"), "resilience"),
    **dict.fromkeys(("BackTrackLineSearch", "LineGradientDescent",
                     "ConjugateGradient", "LBFGS"), "solvers"),
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
