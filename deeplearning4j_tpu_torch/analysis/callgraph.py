"""Package-local call graph for interprocedural graftlint rules.

The lexical rules are per-module; the dominant bug class of four of the
reference's review rounds was *interprocedural* — a blocking launch one call below the
supervisor tick lock, a lock acquired by a helper three frames under
another lock. This module gives rules the one fact those bugs share:
"calling F may execute G".

Resolution is deliberately the cheap 95%: dotted module-level names
through each module's import map (``fleet.http_probe``,
``from x import y``), ``self.``/``cls.``-method calls within the
defining class, plain names against the enclosing function's nested
defs then the module's top level. Anything duck-typed (``replica.kill()``
on a parameter) stays unresolved — rules built on this graph are
therefore under-approximate: they miss dynamic dispatch, they never
invent calls that cannot happen. Precision notes live with each rule.

Qualified names (``qual``) look like
``deeplearning4j_tpu.serving.fleet.ReplicaSupervisor.tick`` —
module dotted path (repo-relative; basename for out-of-tree fixture
files) + class chain + function name. Nested functions append their own
name (``...SubprocessReplica.launch._read_stdout``).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from deeplearning4j_tpu_torch.analysis.core import ModuleInfo, _ROOT


def module_dotted(path: str) -> str:
    """``<repo>/deeplearning4j_tpu/serving/fleet.py`` ->
    ``deeplearning4j_tpu.serving.fleet``; files outside the repo (temp
    fixtures) key by basename so fixture graphs are self-contained."""
    ap = os.path.abspath(path)
    if ap.startswith(_ROOT + os.sep):
        rel = os.path.relpath(ap, _ROOT)
    else:
        rel = os.path.basename(ap)
    rel = rel[:-3] if rel.endswith(".py") else rel
    dotted = rel.replace(os.sep, ".")
    if dotted.endswith(".__init__"):
        dotted = dotted[: -len(".__init__")]
    return dotted


class FunctionInfo:
    """One function/method definition and where it lives."""

    __slots__ = ("qual", "node", "module", "cls", "name")

    def __init__(self, qual: str, node: ast.AST, module: ModuleInfo,
                 cls: Optional[str]):
        self.qual = qual
        self.node = node
        self.module = module
        self.cls = cls                      # enclosing class qual, if any
        self.name = node.name               # type: ignore[attr-defined]

    def __repr__(self):                     # pragma: no cover - debug aid
        return f"FunctionInfo({self.qual})"


def _collect_functions(mod: ModuleInfo) -> List[FunctionInfo]:
    base = module_dotted(mod.path)
    out: List[FunctionInfo] = []

    def visit(node: ast.AST, prefix: str, cls: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}.{child.name}",
                      f"{prefix}.{child.name}")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}"
                out.append(FunctionInfo(qual, child, mod, cls))
                # nested defs (thread bodies, spawn closures) get their
                # own node keyed under the enclosing function
                visit(child, qual, cls)

    visit(mod.tree, base, None)
    return out


class CallGraph:
    """Dotted-name + ``self.``-method call edges over a set of modules."""

    def __init__(self, modules: Sequence[ModuleInfo]):
        self.modules = list(modules)
        self.functions: Dict[str, FunctionInfo] = {}
        #: method name -> quals (for last-resort same-name diagnostics;
        #: NOT used for edge building — too imprecise)
        self._by_module: Dict[str, str] = {}
        for mod in self.modules:
            self._by_module[module_dotted(mod.path)] = mod.path
            for fi in _collect_functions(mod):
                self.functions[fi.qual] = fi
        #: caller qual -> {callee qual}
        self.edges: Dict[str, Set[str]] = {}
        #: (caller, callee) -> first call site node (for findings)
        self.sites: Dict[Tuple[str, str], ast.Call] = {}
        for fi in self.functions.values():
            self._index_calls(fi)

    # ------------------------------------------------------------ building
    def _index_calls(self, fi: FunctionInfo):
        callees = self.edges.setdefault(fi.qual, set())
        for node in self._own_nodes(fi):
            if isinstance(node, ast.Call):
                target = self.resolve(fi, node.func)
                if target is not None and target in self.functions \
                        and target != fi.qual:
                    callees.add(target)
                    self.sites.setdefault((fi.qual, target), node)

    @staticmethod
    def _own_nodes(fi: FunctionInfo) -> Iterable[ast.AST]:
        """Walk `fi`'s body WITHOUT descending into nested function/class
        definitions — their statements execute on their own activation
        (often a different thread), not as part of `fi`."""
        stack: List[ast.AST] = list(ast.iter_child_nodes(fi.node))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(node, ast.Lambda):
                # a lambda body runs when CALLED, not at definition —
                # but spawn-site lambdas (`lambda: self._relaunch(r)`)
                # are how the fleet moved launches off the tick lock; treat
                # the body as part of the function for reachability
                # (over-approximate in the safe direction for rules
                # that ask "can this be reached from here").
                stack.extend(ast.iter_child_nodes(node))
                yield node
                continue
            stack.extend(ast.iter_child_nodes(node))
            yield node

    # ---------------------------------------------------------- resolution
    def resolve(self, fi: FunctionInfo, func: ast.AST) -> Optional[str]:
        """Resolve a call/reference expression inside `fi` to a known
        function qual, or None. Handles:

        - ``self.method`` / ``cls.method``  -> method on the defining class
        - plain ``name``                    -> nested def in the enclosing
          function chain, else module-level def, else import-resolved
        - dotted ``pkg.mod.fn`` via the module's import map
        """
        mod = fi.module
        base = module_dotted(mod.path)
        # self.method / cls.method
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name) and \
                func.value.id in ("self", "cls") and fi.cls:
            cand = f"{fi.cls}.{func.attr}"
            return cand if cand in self.functions else None
        dotted = mod.dotted(func)
        if dotted is None:
            return None
        if "." not in dotted:
            # plain name: nested def in the enclosing function chain
            # first (shadowing), then module level
            prefix = fi.qual
            while True:
                cand = f"{prefix}.{dotted}"
                if cand in self.functions:
                    return cand
                if prefix == base or "." not in prefix:
                    return None
                prefix = prefix.rsplit(".", 1)[0]
        # import-resolved dotted name: "fleet.http_probe" already came
        # back import-expanded from ModuleInfo.dotted
        if dotted in self.functions:
            return dotted
        # `from deeplearning4j_tpu.serving import fleet; fleet.f()` gives
        # "deeplearning4j_tpu.serving.fleet.f" directly; a class-method
        # path like "mod.Class.method" is already the qual shape. One
        # more chance: the head segment may alias a module by basename
        # (fixture files import each other bare).
        head, _, rest = dotted.partition(".")
        if head in self._by_module:
            cand = f"{head}.{rest}"
            return cand if cand in self.functions else None
        return None

    # --------------------------------------------------------- reachability
    def reach_chains(self, start: str, depth: int
                     ) -> Dict[str, List[str]]:
        """BFS: every function reachable from `start` within `depth` call
        edges, mapped to ONE shortest call chain ``[start, ..., target]``
        (for human-readable findings)."""
        chains: Dict[str, List[str]] = {start: [start]}
        frontier = [start]
        for _ in range(depth):
            nxt: List[str] = []
            for q in frontier:
                for callee in sorted(self.edges.get(q, ())):
                    if callee not in chains:
                        chains[callee] = chains[q] + [callee]
                        nxt.append(callee)
            frontier = nxt
            if not frontier:
                break
        return chains
