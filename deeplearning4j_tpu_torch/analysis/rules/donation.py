"""Rule: donated-aliasing — the serde-resume segfault class.

``jnp.asarray`` on a numpy array can be ZERO-COPY on CPU backends: the
jax array aliases numpy-owned memory. DONATING that buffer into a jitted
step (``donate_argnums``) lets XLA free/reuse memory it does not own —
heap corruption that surfaces as garbage params or a segfault at a
random later point. The historical crash: checkpoint-restored
(deserialized, numpy-backed) params donated by the first train step
after resume. The fix is `util/params.own_tree` (copy into XLA-owned
buffers) at every fit entry.

Two checks, both from the AST:

1. **Module contract**: a module that creates donating programs
   (``jit(..., donate_argnums=...)`` / ``device_put(..., donate=...)``)
   must reference `own_tree`/`owned_leaf` somewhere — the laundering
   step has to live next to the donation, not in tribal memory.
2. **Lightweight dataflow** (the resume shape): inside one function,
   values produced by numpy / deserialization (``np.*``, ``*.from_bytes``,
   ``np.load``, ``pickle.load(s)``) and *assigned* (incl. to
   ``self.<attr>``) are host-tainted; simple-name propagation follows
   ``x = y``; passing through `own_tree`/`owned_leaf`/
   ``jnp.array(..., copy=True)`` clears the taint. A call of a
   known-donating callable (a name bound to a donating `jit` in the
   same module) with a tainted argument in a donated position is
   flagged even when the module passes check 1.

Under the torch profile the rule does not apply: PyTorch has no buffer
donation, so no program can free memory it was handed. The port's
aliasing hazard of the same family — a zero-copy tensor view of a
restored array that the fit then writes in place — is
unlaundered-restore-placement's under that profile.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from deeplearning4j_tpu_torch.analysis.core import Finding, ModuleInfo, Rule

_JIT_NAMES = {"jax.jit", "jit", "pjit", "jax.pjit"}
_DEVICE_PUT = {"jax.device_put", "device_put"}
_OWNING = {"own_tree", "owned_leaf"}
_TAINT_CALLS_SUFFIX = (".from_bytes",)
_TAINT_CALLS = {"numpy.load", "np.load", "pickle.load", "pickle.loads"}


def _is_donating_jit(mod: ModuleInfo, call: ast.Call) -> bool:
    name = mod.call_name(call)
    if name not in _JIT_NAMES:
        return False
    return any(kw.arg in ("donate_argnums", "donate_argnames")
               for kw in call.keywords)


def _is_donating_device_put(mod: ModuleInfo, call: ast.Call) -> bool:
    name = mod.call_name(call)
    if name not in _DEVICE_PUT:
        return False
    return any(kw.arg in ("donate", "donate_argnums") for kw in call.keywords)


def _donated_argnums(call: ast.Call) -> Optional[Set[int]]:
    for kw in call.keywords:
        if kw.arg == "donate_argnums":
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                return {v.value}
            if isinstance(v, (ast.Tuple, ast.List)):
                out = set()
                for el in v.elts:
                    if isinstance(el, ast.Constant) and isinstance(el.value, int):
                        out.add(el.value)
                return out
    return None   # donate_argnames / non-literal: treat every arg as donated


def _target_name(t: ast.AST) -> Optional[str]:
    """`x` or `self.params` as a taint key; None for complex targets."""
    if isinstance(t, ast.Name):
        return t.id
    if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name):
        return f"{t.value.id}.{t.attr}"
    return None


class DonatedAliasingRule(Rule):
    name = "donated-aliasing"
    summary = ("donated buffers must be XLA-owned: numpy-backed or "
               "deserialized leaves reach donate_argnums without "
               "util/params.own_tree")
    historical = ("checkpoint-restored numpy-aliased params were "
                  "donated by the first post-resume train step — heap "
                  "corruption, the serde-resume segfault")
    not_applicable = {
        "torch": ("PyTorch has no buffer donation (no donate_argnums); "
                  "the port's zero-copy views of restored arrays are "
                  "checked by unlaundered-restore-placement")}

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        donation_sites: List[ast.Call] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and (
                    _is_donating_jit(mod, node)
                    or _is_donating_device_put(mod, node)):
                donation_sites.append(node)
        if not donation_sites:
            return
        # AST-based reference check: a docstring MENTIONING own_tree is
        # not laundering — only a real Name/Attribute reference counts
        launders = any(
            (isinstance(n, ast.Name) and n.id in _OWNING)
            or (isinstance(n, ast.Attribute) and n.attr in _OWNING)
            for n in ast.walk(mod.tree))
        if not launders:
            for site in donation_sites:
                yield self.finding(
                    mod, site,
                    "donating program in a module that never launders "
                    "host buffers through util/params.own_tree/owned_leaf "
                    "— restored/numpy-backed leaves donated here corrupt "
                    "the heap (the PR-3 serde-resume segfault)")
        # lightweight dataflow, per function scope (and module top level)
        scopes = [mod.tree] + [n for n in ast.walk(mod.tree)
                               if isinstance(n, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef))]
        donating: Dict[str, Optional[Set[int]]] = {}
        for scope in scopes:
            for stmt in ast.walk(scope):
                if isinstance(stmt, ast.Assign) and isinstance(
                        stmt.value, ast.Call) and _is_donating_jit(
                            mod, stmt.value):
                    for t in stmt.targets:
                        tn = _target_name(t)
                        if tn:
                            donating[tn] = _donated_argnums(stmt.value)
        for scope in scopes:
            yield from self._scope_taint(mod, scope, donating)

    def _scope_taint(self, mod: ModuleInfo, scope: ast.AST,
                     donating: Dict[str, Optional[Set[int]]]
                     ) -> Iterable[Finding]:
        tainted: Set[str] = set()
        body = scope.body if hasattr(scope, "body") else []
        for stmt in body:
            yield from self._walk_stmt(mod, stmt, tainted, donating)

    def _walk_stmt(self, mod: ModuleInfo, stmt: ast.AST, tainted: Set[str],
                   donating: Dict[str, Optional[Set[int]]]
                   ) -> Iterable[Finding]:
        # nested defs are their own scope — visited via `scopes`
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.Assign):
            taints = self._expr_taints(mod, stmt.value, tainted)
            for t in stmt.targets:
                tn = _target_name(t)
                if tn is not None:
                    (tainted.add if taints else tainted.discard)(tn)
        # check calls in this statement's own expressions (not in nested
        # statements — recursion below visits those exactly once)
        for expr in self._own_exprs(stmt):
            for node in ast.walk(expr):
                if isinstance(node, ast.Call):
                    yield from self._check_donating_call(
                        mod, node, tainted, donating)
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                yield from self._walk_stmt(mod, child, tainted, donating)

    @staticmethod
    def _own_exprs(stmt: ast.AST) -> Iterable[ast.expr]:
        """The statement's direct expression children (a compound
        statement's nested statement bodies are excluded)."""
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                yield child
            elif isinstance(child, (ast.withitem, ast.keyword)):
                for sub in ast.iter_child_nodes(child):
                    if isinstance(sub, ast.expr):
                        yield sub

    def _expr_taints(self, mod: ModuleInfo, expr: ast.AST,
                     tainted: Set[str]) -> bool:
        """Does `expr` produce a host-owned (numpy/deserialized) value
        that has NOT been laundered?"""
        if isinstance(expr, ast.Call):
            name = mod.call_name(expr) or ""
            base = name.split(".")[-1]
            if base in _OWNING:
                return False
            if name in ("jax.numpy.array", "jnp.array",
                        "jax.numpy.asarray", "jnp.asarray"):
                copy_kw = next((kw.value.value for kw in expr.keywords
                                if kw.arg == "copy"
                                and isinstance(kw.value, ast.Constant)),
                               None)
                # jnp.array defaults to copy=True (XLA-owned) — clears
                # taint unless copy=False; jnp.asarray on numpy is
                # ZERO-COPY on CPU (the resume alias) — it TRANSPORTS
                # taint unless forced to copy
                copies = (copy_kw is True
                          or (base == "array" and copy_kw is None))
                if copies:
                    return False
                return bool(expr.args) and self._expr_taints(
                    mod, expr.args[0], tainted)
            if (name.startswith("numpy.") or name.startswith("np.")
                    or name in _TAINT_CALLS
                    or name.endswith(_TAINT_CALLS_SUFFIX)):
                return True
            # a call we can't see through clears nothing but produces a
            # fresh value: conservatively untainted
            return False
        if isinstance(expr, ast.Name):
            return expr.id in tainted
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            return f"{expr.value.id}.{expr.attr}" in tainted
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self._expr_taints(mod, e, tainted) for e in expr.elts)
        return False

    def _check_donating_call(self, mod: ModuleInfo, call: ast.Call,
                             tainted: Set[str],
                             donating: Dict[str, Optional[Set[int]]]
                             ) -> Iterable[Finding]:
        fname = _target_name(call.func) if isinstance(
            call.func, (ast.Name, ast.Attribute)) else None
        if fname is None or fname not in donating:
            return
        argnums = donating[fname]
        for i, arg in enumerate(call.args):
            if argnums is not None and i not in argnums:
                continue
            if self._expr_taints(mod, arg, tainted):
                yield self.finding(
                    mod, call,
                    f"argument {i} of donating call {fname!r} is "
                    "numpy-backed/deserialized and was never passed "
                    "through own_tree — XLA will free memory it does "
                    "not own (the PR-3 segfault shape)")
