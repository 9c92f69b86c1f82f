"""Rules: host-sync-in-hot-path + recompile-hazard — compiled-step
hygiene (the defect family ROADMAP item 2's MFU work hunts dynamically;
these two catch the statically-visible cases at review time).

host-sync-in-hot-path: ``float()/int()/bool()/.item()/np.asarray()`` on
traced values inside a compiled region stalls the dispatch pipeline
(device->host sync per step — the exact tax PERF.md measured), and in
fit inner loops an *extra* sync beyond the one deliberate loss fetch
serializes host and device. Shape/dtype reads are static under tracing
and exempt.

recompile-hazard: Python ``if``/``while`` on runtime array VALUES inside
a jitted function either crashes at trace time (TracerBoolConversion) or
— via shape-dependent rebuilding — recompiles per distinct value.
Branching on shapes/dtypes/None-ness is static and fine; use lax.cond /
jnp.where for value branches.

Under the torch profile the compiled region is a CUDA graph capture
(rules/_torch.py). There a host sync — ``.item()``, ``.cpu()``,
``.numpy()``, ``.tolist()``, ``float()/int()/bool()`` of a tensor,
``np.asarray``, ``torch.cuda.synchronize()`` — fails the capture, and a
Python branch on a tensor's value is recorded once and replayed for
every later value. Shape, dim, numel, device and dtype reads stay exempt.
The fit-loop check is the same under both profiles.
"""
from __future__ import annotations

import ast
import re
from typing import Iterable, Set

from deeplearning4j_tpu_torch.analysis.core import Finding, ModuleInfo, Rule
from deeplearning4j_tpu_torch.analysis.rules._jax import (
    compiled_regions, walk_region,
)

_SYNC_BUILTINS = {"float", "int", "bool"}
_NP_SYNC = {"numpy.asarray", "np.asarray", "numpy.array", "np.array"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size"}
#: tensor metadata a capture reads without a sync (torch profile)
_TORCH_STATIC_ATTRS = _STATIC_ATTRS | {"dim", "numel", "device", "is_cuda"}
#: no-argument tensor methods that copy to the host (torch profile)
_TORCH_SYNC_METHODS = {"cpu", "numpy", "tolist"}
_TORCH_SYNC = {"torch.cuda.synchronize"}
#: fit-loop functions: the product hot loops around the compiled step
_FIT_LOOP_RE = re.compile(r"^(fit|_fit\w*|do_fit|_run_scan_pipeline)$")


def _static_attrs(mod: ModuleInfo):
    return _TORCH_STATIC_ATTRS if mod.profile == "torch" else _STATIC_ATTRS


def _mentions_static_only(node: ast.AST, attrs=_STATIC_ATTRS) -> bool:
    """True when the expression reads only static facts: .shape/.ndim/
    .dtype/.size chains (`attrs`), len(), constants."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in attrs:
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                and sub.func.id == "len":
            return True
    return False


def _sync_call_kind(mod: ModuleInfo, call: ast.Call):
    """None, or a description of the host-sync this call performs."""
    name = mod.call_name(call)
    torch_profile = mod.profile == "torch"
    if isinstance(call.func, ast.Name) and call.func.id in _SYNC_BUILTINS:
        if call.args and not _mentions_static_only(
                call.args[0], _static_attrs(mod)) \
                and not isinstance(call.args[0], ast.Constant):
            return f"{call.func.id}() forces a device->host transfer"
        return None
    if name in _NP_SYNC:
        return f"{name}() materializes the value on host"
    if isinstance(call.func, ast.Attribute) and call.func.attr == "item" \
            and not call.args:
        return ".item() forces a device->host transfer"
    if torch_profile:
        if name in _TORCH_SYNC:
            return f"{name}() blocks the host on the device"
        if isinstance(call.func, ast.Attribute) and not call.args \
                and call.func.attr in _TORCH_SYNC_METHODS:
            return f".{call.func.attr}() copies the value to the host"
        return None
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr == "block_until_ready":
        return ".block_until_ready() stalls the dispatch pipeline"
    return None


class HostSyncInHotPathRule(Rule):
    name = "host-sync-in-hot-path"
    summary = ("float()/int()/bool()/.item()/np.asarray() on traced "
               "values inside jitted functions, lax bodies, or fit "
               "inner loops (torch profile: also .cpu()/.numpy()/"
               ".tolist()/torch.cuda.synchronize() inside a CUDA graph "
               "capture)")
    historical = ("PERF.md round-5: the dispatch-tax investigation; every "
                  "accidental per-step sync serializes host and device — "
                  "the fit loops budget exactly ONE deliberate loss fetch")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        regions = compiled_regions(mod)
        seen: Set[int] = set()
        for fn, why in regions.items():
            for node in walk_region(fn):
                if id(node) in seen or not isinstance(node, ast.Call):
                    continue
                kind = _sync_call_kind(mod, node)
                if kind:
                    seen.add(id(node))
                    yield self.finding(
                        mod, node,
                        f"{kind} inside a captured region ({why}) — a "
                        "host sync fails the CUDA graph capture; hoist "
                        "it out of the captured step"
                        if mod.profile == "torch" else
                        f"{kind} inside a compiled region ({why}) — "
                        "hoist it out of the traced code")
        yield from self._check_fit_loops(mod, regions, seen)

    def _check_fit_loops(self, mod: ModuleInfo, regions, seen: Set[int]
                         ) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node in regions or not _FIT_LOOP_RE.match(node.name):
                continue
            for loop in ast.walk(node):
                if not isinstance(loop, (ast.For, ast.While)):
                    continue
                for sub in ast.walk(loop):
                    if id(sub) in seen or not isinstance(sub, ast.Call):
                        continue
                    # fit loops: only the unambiguous sync vectors —
                    # host-side numpy parsing is legitimate ETL there,
                    # and bool()/int() overwhelmingly hit Python values
                    if isinstance(sub.func, ast.Name) \
                            and sub.func.id == "float" \
                            and sub.args \
                            and not isinstance(sub.args[0], ast.Constant) \
                            and not _mentions_static_only(sub.args[0]):
                        kind = (f"{sub.func.id}() is a device->host sync "
                                "point")
                    elif isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr == "item" and not sub.args:
                        kind = ".item() is a device->host sync point"
                    else:
                        continue
                    seen.add(id(sub))
                    yield self.finding(
                        mod, sub,
                        f"{kind} inside the {node.name}() inner loop — "
                        "the loop budgets ONE deliberate loss fetch; "
                        "anything else serializes host and device "
                        "(suppress with a justification if deliberate)")


class RecompileHazardRule(Rule):
    name = "recompile-hazard"
    summary = ("Python branching on runtime array values (not shapes) "
               "inside jitted functions (torch profile: inside a CUDA "
               "graph capture)")
    historical = ("PERF.md: recompiles inside the hot path wipe out the "
                  "compile-cache guarantees the serving bucket ladder "
                  "and scan pipeline are built on")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        attrs = _static_attrs(mod)
        for fn, why in compiled_regions(mod).items():
            if isinstance(fn, ast.Lambda):
                continue
            params = self._traced_names(mod, fn)
            for node in walk_region(fn):
                if not isinstance(node, (ast.If, ast.While)):
                    continue
                test = node.test
                if not self._references_params(test, params):
                    continue
                if self._static_test(test, attrs):
                    continue
                yield self.finding(
                    mod, node,
                    f"Python branch on a tensor's value inside a captured "
                    f"region ({why}) — the capture records one branch and "
                    "every replay repeats it; use torch.where, or branch "
                    "on .shape/.dim()/.dtype (static under capture)"
                    if mod.profile == "torch" else
                    f"Python branch on a traced value inside a compiled "
                    f"region ({why}) — trace-time crash or a recompile "
                    "per value; use lax.cond/jnp.where, or branch on "
                    ".shape/.ndim/.dtype (static under tracing)")

    @staticmethod
    def _traced_names(mod: ModuleInfo, fn: ast.AST) -> Set[str]:
        """The region's values: a function's parameters; for a capture's
        `with` body, the enclosing function's parameters and every name
        the body assigns."""
        if isinstance(fn, ast.With):
            names = {t.id for st in walk_region(fn)
                     if isinstance(st, (ast.Assign, ast.AugAssign,
                                        ast.AnnAssign))
                     for tgt in (st.targets if isinstance(st, ast.Assign)
                                 else [st.target])
                     for t in ast.walk(tgt) if isinstance(t, ast.Name)}
            outer = mod.enclosing_function(fn)
            if outer is None:
                return names
            return names | RecompileHazardRule._traced_names(mod, outer)
        return {a.arg for a in list(fn.args.args)
                + list(fn.args.posonlyargs) + list(fn.args.kwonlyargs)
                if a.arg not in ("self", "cls")}

    @staticmethod
    def _references_params(test: ast.AST, params: Set[str]) -> bool:
        return any(isinstance(n, ast.Name) and n.id in params
                   for n in ast.walk(test))

    @staticmethod
    def _static_test(test: ast.AST, attrs=_STATIC_ATTRS) -> bool:
        """Shape/dtype reads, None-ness, isinstance — static facts."""
        if _mentions_static_only(test, attrs):
            return True
        for n in ast.walk(test):
            if isinstance(n, ast.Compare) and any(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
                return True
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                    and n.func.id in ("isinstance", "callable", "hasattr",
                                      "getattr", "len"):
                return True
        return False
