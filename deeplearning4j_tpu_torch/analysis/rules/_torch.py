"""Detection of captured regions for the torch profile (used by the
hot-path and telemetry rules through `_jax.compiled_regions`): the port's
compiled region is a CUDA graph capture.

Best-effort and module-local, as rules/_jax.py finds jit bodies. A
region is

(a) the body of ``with torch.cuda.graph(...)``;
(b) a function passed by name (or an inline lambda) as the first
    argument of a ``capture``/``warm_up`` call (``StepGraph.capture``;
    ``StepGraph.warm_up`` runs eagerly the very function the capture
    then records);
(c) the ``fn`` handed to ``_run_step`` (third positional argument, or
    ``fn=``): the fit loop warms it up, captures it and replays it.

Inside a capture a host sync is not only slow: it fails the capture, and
a Python branch on a tensor's value records one arm that every replay
repeats.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from deeplearning4j_tpu_torch.analysis.core import ModuleInfo

GRAPH_NAMES = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
CAPTURE_METHODS = {"capture", "warm_up"}
RUN_STEP = "_run_step"


def captured_regions(mod: ModuleInfo) -> Dict[ast.AST, str]:
    """region node (a function, a lambda, or the ``with`` statement of a
    capture) -> human reason it is captured."""
    by_name: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, []).append(node)

    regions: Dict[ast.AST, str] = {}

    def mark(arg, why):
        if isinstance(arg, ast.Name):
            for fn in by_name.get(arg.id, []):
                regions[fn] = f"function passed to {why}"
        elif isinstance(arg, ast.Lambda):
            regions[arg] = f"lambda passed to {why}"

    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call) and \
                        mod.call_name(expr) in GRAPH_NAMES:
                    regions[node] = "body of torch.cuda.graph()"
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in CAPTURE_METHODS and node.args:
                mark(node.args[0], f"{attr}()")
            elif attr == RUN_STEP:
                fn = node.args[2] if len(node.args) > 2 else next(
                    (kw.value for kw in node.keywords if kw.arg == "fn"),
                    None)
                if fn is not None:
                    mark(fn, f"{RUN_STEP}()")
    return regions
