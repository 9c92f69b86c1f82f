"""graftlint — project-native static analysis for the bug classes this
repo actually shipped: the port's copy of the reference's analyzer, with
a profile that knows the port's names.

The reference's review rounds kept finding the same defect families:
donated numpy-aliased buffers (the serde-resume segfault), hand-rolled
env kill-switch truthiness, blocking calls held under supervisor/router
locks, host syncs and recompile hazards inside the compiled step. Every
one is visible in the AST — this package turns that review knowledge
into a machine-enforced invariant.

Entry points:

- CLI: ``python -m deeplearning4j_tpu_torch.tools.graftlint
  [--profile torch|jax] [paths]`` (human, ``--json``, ``--baseline``
  burn-down; exit 2 on unsuppressed findings) — wired into tier-1 via
  tests/test_torch_analysis.py.
- Library: `run(paths, profile=)` -> RunResult; `ALL_RULES`;
  `extract_metric_families`.
- Suppression: ``# graftlint: disable=<rule> -- <justification>`` —
  the justification is mandatory and checked.
- Profiles (core.py): ``torch``, the default, reads the port
  (``DL4J_CUDA_*`` knobs, CUDA graph captures); ``jax`` reproduces the
  reference's analyzer exactly.

The reference's rule catalog: docs/STATIC_ANALYSIS.md; the torch
profile's rules: README.md, "The port's static analyzer".
"""
from deeplearning4j_tpu_torch.analysis.core import (
    DEFAULT_PROFILE, PROFILES, Finding, ModuleInfo, PRAGMA_RULE, Project,
    ProjectRule, Rule, RunResult, apply_baseline, iter_py_files,
    load_module, run as _run, write_baseline,
)
from deeplearning4j_tpu_torch.analysis.rules import ALL_RULES
from deeplearning4j_tpu_torch.analysis.rules.telemetry import (
    extract_metric_families, metric_families_in,
)


def run(paths, rules=None, select=None, module_findings=None,
        profile=DEFAULT_PROFILE) -> RunResult:
    """Run the full registered suite (or `rules`) over `paths` under
    `profile`. `module_findings` feeds the CLI's multiprocess per-module
    pass (core.run docstring)."""
    return _run(paths, ALL_RULES if rules is None else rules,
                select=select, module_findings=module_findings,
                profile=profile)


__all__ = [
    "ALL_RULES", "DEFAULT_PROFILE", "Finding", "ModuleInfo", "PRAGMA_RULE",
    "PROFILES", "Project", "ProjectRule", "Rule", "RunResult",
    "apply_baseline", "extract_metric_families", "iter_py_files",
    "load_module", "metric_families_in", "run", "write_baseline",
]
