"""Shared detection of compiled-code regions (used by the hot-path and
telemetry rules). Under the jax profile: which functions in a module run
under `jax.jit` tracing, and which are `lax` control-flow bodies; under
the torch profile, the CUDA graph captures of rules/_torch.py.

Best-effort and module-local, like the rest of graftlint: a function is
"jitted" when it is (a) decorated with jit/pjit (directly or through
functools.partial), (b) passed by name to a jit call in the same module
(the repo's dominant idiom: ``def step(...): ...; return jax.jit(step,
donate_argnums=...)``), or (c) passed by name (or as an inline lambda)
to lax.scan / fori_loop / while_loop / cond / map / switch.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Union

from deeplearning4j_tpu_torch.analysis.core import ModuleInfo
from deeplearning4j_tpu_torch.analysis.rules._torch import captured_regions

JIT_NAMES = {"jax.jit", "jit", "pjit", "jax.pjit"}
PARTIAL_NAMES = {"functools.partial", "partial"}
LAX_BODY_NAMES = {
    "jax.lax.scan", "lax.scan", "jax.lax.fori_loop", "lax.fori_loop",
    "jax.lax.while_loop", "lax.while_loop", "jax.lax.cond", "lax.cond",
    "jax.lax.map", "lax.map", "jax.lax.switch", "lax.switch",
    "jax.lax.associative_scan", "lax.associative_scan",
}

#: a region: a function or lambda; under torch also a capture's `with`
FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                 ast.With]


def _is_jit_ref(mod: ModuleInfo, node: ast.AST) -> bool:
    """`jax.jit`, `partial(jax.jit, ...)`, or `jax.jit(...)` (a
    configured jit used as a decorator)."""
    if mod.dotted(node) in JIT_NAMES:
        return True
    if isinstance(node, ast.Call):
        name = mod.call_name(node)
        if name in JIT_NAMES:
            return True
        if name in PARTIAL_NAMES and node.args and \
                mod.dotted(node.args[0]) in JIT_NAMES:
            return True
    return False


def compiled_regions(mod: ModuleInfo) -> Dict[FuncNode, str]:
    """function/lambda node -> human reason it runs under tracing.
    Memoized on the ModuleInfo: three rules call this per file, and the
    two ast.walk passes are the expensive part of the run."""
    cached = getattr(mod, "_compiled_regions", None)
    if cached is not None:
        return cached
    regions = (captured_regions(mod) if mod.profile == "torch"
               else _compiled_regions_uncached(mod))
    mod._compiled_regions = regions
    return regions


def _compiled_regions_uncached(mod: ModuleInfo) -> Dict[FuncNode, str]:
    by_name: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, []).append(node)

    regions: Dict[FuncNode, str] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _is_jit_ref(mod, dec):
                    regions[node] = "jit-decorated function"
        elif isinstance(node, ast.Call):
            name = mod.call_name(node)
            if name in JIT_NAMES:
                for arg in node.args[:1]:
                    if isinstance(arg, ast.Name):
                        for fn in by_name.get(arg.id, []):
                            regions[fn] = f"function passed to {name}()"
                    elif isinstance(arg, ast.Lambda):
                        regions[arg] = f"lambda passed to {name}()"
            elif name in LAX_BODY_NAMES:
                for arg in node.args:
                    if isinstance(arg, ast.Name):
                        for fn in by_name.get(arg.id, []):
                            regions[fn] = f"{name} body"
                    elif isinstance(arg, ast.Lambda):
                        regions[arg] = f"{name} body"
    return regions


def walk_region(fn: FuncNode):
    """Walk a compiled region's body — nested defs/lambdas INCLUDED
    (they trace too), other regions' duplicates are the caller's concern
    (regions() maps distinct nodes). A capture's `with` region walks its
    body."""
    if isinstance(fn, ast.Lambda):
        yield from ast.walk(fn.body)
    else:
        for stmt in fn.body:
            yield from ast.walk(stmt)
