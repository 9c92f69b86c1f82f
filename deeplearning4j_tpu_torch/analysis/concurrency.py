"""Concurrency model: lock regions, may-block facts, thread entry points.

The shared fact base for the four interprocedural concurrency rules
(rules/lockorder.py, rules/threads.py, rules/pairing.py) and the
``--lock-graph`` CLI export. Built once per graftlint run from the
parsed modules + the package call graph (callgraph.py).

Per function it records:

- **lock acquisition regions** — every lock-ish ``with`` (the
  blocking-under-lock notion: last name segment contains ``lock`` /
  ``mutex``; condition variables deliberately excluded) with a
  cross-module *lock identity* (below);
- **may-block facts** — direct blocking operations (subprocess, socket/
  HTTP IO, sleeps, thread joins, launch-family calls — the
  ``_blocking_kind`` table), excluding code inside nested defs, which
  runs on its own activation;
- **thread entry points** — ``threading.Thread(target=...)`` sites plus
  ``spawn``-family indirections (``self._spawn(lambda: f(), name)``),
  with daemon/name/join bookkeeping for the thread-lifecycle rule.

Lock identity
-------------
A lock is named by *where it lives*, so the acquisition-order graph can
join acquisitions from different modules:

- ``with self._lock`` in class ``C`` of module ``m`` -> ``m.C._lock``
- module-global ``with _lock`` in ``m``              -> ``m._lock``
- a local ``lock = threading.Lock()``                -> ``m.f.<local>lock``
  (function-scoped: never shared, never merges across functions)
- an import-resolved dotted chain (``REGISTRY._lock``) keeps the
  resolved dotted text.

The acquisition-order graph has an edge ``A -> B`` when B is acquired
while A is held: lexically nested ``with``s, or a call chain of at most
`depth` edges from inside A's region reaching a function that acquires
B. Cycles in that graph are lock-order inversions (two threads taking
the same pair in opposite orders can deadlock) — the runtime witness
(util/locks.DiagnosedLock) records the same edges from live executions
so tests can cross-check the model.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from deeplearning4j_tpu_torch.analysis.callgraph import (
    CallGraph, FunctionInfo, module_dotted,
)
from deeplearning4j_tpu_torch.analysis.core import ModuleInfo
from deeplearning4j_tpu_torch.analysis.rules.locks import _blocking_kind, _lockish

#: default interprocedural horizon: how many call edges a rule follows
#: out of a lock region / toward another acquisition
DEFAULT_DEPTH = 4


@dataclasses.dataclass
class LockRegion:
    lock_id: str                 # cross-module lock identity
    lock_name: str               # the lexical name (`_tick_lock`)
    node: ast.AST                # the `with` statement


@dataclasses.dataclass
class BlockFact:
    node: ast.AST
    kind: str                    # human description from _blocking_kind


@dataclasses.dataclass
class ThreadSpawn:
    node: ast.Call               # the Thread(...)/spawn(...) call
    module: ModuleInfo
    owner: FunctionInfo          # function containing the spawn
    target_qual: Optional[str]   # resolved entry point (None = opaque)
    target_text: str             # source text of the target expression
    daemon: Optional[bool]       # constant daemon= value, None if absent/dynamic
    named: bool                  # has a name= kwarg
    assigned_attr: Optional[str]  # "self.<attr>" the Thread is stored to


class FunctionConcurrency:
    __slots__ = ("info", "regions", "blocks", "acquired_ids")

    def __init__(self, info: FunctionInfo):
        self.info = info
        self.regions: List[LockRegion] = []
        self.blocks: List[BlockFact] = []
        self.acquired_ids: Set[str] = set()


def _unwrap_with_expr(item: ast.withitem) -> ast.AST:
    expr = item.context_expr
    if isinstance(expr, ast.Call):
        expr = expr.func
    return expr


def lock_identity(mod: ModuleInfo, fi: Optional[FunctionInfo],
                  expr: ast.AST) -> str:
    """Cross-module identity for a lock expression (module docstring)."""
    base = module_dotted(mod.path)
    dotted = mod.dotted(expr)
    if dotted is None:
        return f"{base}.<expr>"
    if dotted.startswith("self.") or dotted.startswith("cls."):
        attr = dotted.split(".", 1)[1]
        if fi is not None and fi.cls:
            return f"{fi.cls}.{attr}"
        return f"{base}.{attr}"
    if "." not in dotted:
        # module-global vs function-local: a name assigned at module
        # level is shared state; anything else is function-scoped
        if fi is not None and not _is_module_global(mod, dotted):
            return f"{fi.qual}.<local>{dotted}"
        return f"{base}.{dotted}"
    return dotted


def _is_module_global(mod: ModuleInfo, name: str) -> bool:
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return True
        elif isinstance(stmt, ast.AnnAssign):
            if isinstance(stmt.target, ast.Name) and stmt.target.id == name:
                return True
    return False


#: call names (dotted suffixes) that construct a lock object — the graph
#: counts every one of these as a node even before any edge touches it
_LOCK_CTORS = ("threading.Lock", "threading.RLock",
               "locks.DiagnosedLock", "DiagnosedLock",
               "multiprocessing.Lock", "multiprocessing.RLock")

#: cheap prefilter before the (dotted-resolution) _blocking_kind test:
#: every blocking shape ends in one of these attribute/name segments, or
#: hangs off a subprocess/requests import — checked via dict lookups so
#: the model doesn't pay a dotted-chain walk for every call in the tree
_MAYBE_BLOCKING_TAILS = frozenset(
    {"connect", "accept", "recv", "recv_into", "sendall", "getresponse",
     "urlopen", "sleep", "join", "get", "put"})


def _maybe_blocking(mod: ModuleInfo, call: ast.Call) -> bool:
    func = call.func
    if isinstance(func, ast.Attribute):
        if func.attr in _MAYBE_BLOCKING_TAILS or "launch" in func.attr.lower():
            return True
        base = func.value
        while isinstance(base, ast.Attribute):
            base = base.value
        if isinstance(base, ast.Name):
            origin = mod.imports.get(base.id, base.id)
            return origin.split(".")[0] in ("subprocess", "requests")
        return False
    if isinstance(func, ast.Name):
        origin = mod.imports.get(func.id, func.id)
        tail = origin.split(".")[-1]
        return (tail in _MAYBE_BLOCKING_TAILS
                or "launch" in func.id.lower()
                or origin.split(".")[0] in ("subprocess", "requests"))
    return False


@dataclasses.dataclass
class OrderEdge:
    src: str                      # held lock id
    dst: str                      # acquired-while-held lock id
    module: ModuleInfo            # where the evidence starts
    node: ast.AST                 # the inner acquisition or the call site
    via: Tuple[str, ...]          # call chain quals ([] = lexical nesting)


class ConcurrencyModel:
    """All concurrency facts for one analyzed tree."""

    def __init__(self, modules: Sequence[ModuleInfo],
                 graph: Optional[CallGraph] = None,
                 depth: int = DEFAULT_DEPTH):
        self.modules = list(modules)
        self.graph = graph if graph is not None else CallGraph(self.modules)
        self.depth = int(depth)
        self.functions: Dict[str, FunctionConcurrency] = {}
        #: every lock the tree declares or acquires (graph nodes)
        self.locks: Dict[str, Tuple[str, int]] = {}     # id -> (path, line)
        self.spawns: List[ThreadSpawn] = []
        self._by_node: Dict[int, FunctionInfo] = {
            id(fi.node): fi for fi in self.graph.functions.values()}
        self._chain_cache: Dict[str, Dict[str, List[str]]] = {}
        #: a->b edges from `with lock_a, lock_b:` co-items (semantically
        #: identical to nesting: items acquire left to right)
        self._co_item_edges: List[OrderEdge] = []
        for fi in self.graph.functions.values():
            self.functions[fi.qual] = self._analyze_function(fi)
        for mod in self.modules:
            self._collect_module_facts(mod)
        self.order_edges: List[OrderEdge] = self._build_order_edges()

    # ------------------------------------------------------- per-function
    def _analyze_function(self, fi: FunctionInfo) -> FunctionConcurrency:
        fc = FunctionConcurrency(fi)
        for node in self.graph._own_nodes(fi):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                held_here: List[str] = []
                for item in node.items:
                    lock_name = _lockish(fi.module, item)
                    if lock_name:
                        lid = lock_identity(fi.module, fi,
                                            _unwrap_with_expr(item))
                        fc.regions.append(LockRegion(lid, lock_name, node))
                        fc.acquired_ids.add(lid)
                        self._note_lock(lid, fi.module, node)
                        # `with a, b:` acquires left to right — exactly
                        # nested semantics, so earlier co-items order
                        # before later ones
                        for prior in held_here:
                            if prior != lid:
                                self._co_item_edges.append(OrderEdge(
                                    prior, lid, fi.module, node, ()))
                        held_here.append(lid)
            elif isinstance(node, ast.Call) and _maybe_blocking(
                    fi.module, node):
                kind = _blocking_kind(fi.module, node)
                if kind:
                    fc.blocks.append(BlockFact(node, kind))
        return fc

    def _note_lock(self, lid: str, mod: ModuleInfo, node: ast.AST):
        self.locks.setdefault(
            lid, (mod.path, getattr(node, "lineno", 1)))

    def _collect_module_facts(self, mod: ModuleInfo):
        """One walk per module for both remaining fact families:
        declared locks (graph nodes even when never seen acquired — the
        --lock-graph artifact must name the fleet's full lock
        population, not just the contended ones) and thread spawns."""
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                name = mod.call_name(node.value) or ""
                if any(name == c or name.endswith("." + c)
                       for c in _LOCK_CTORS):
                    for t in node.targets:
                        fn = mod.enclosing_function(node)
                        fi = self._owning_info(mod, fn)
                        self._note_lock(lock_identity(mod, fi, t),
                                        mod, node)
            if isinstance(node, ast.Call):
                self._maybe_spawn(mod, node)

    def _owning_info(self, mod: ModuleInfo,
                     fn_node: Optional[ast.AST]) -> Optional[FunctionInfo]:
        if fn_node is None:
            return None
        return self._by_node.get(id(fn_node))

    # ------------------------------------------------------ thread spawns
    def _maybe_spawn(self, mod: ModuleInfo, node: ast.Call):
        name = mod.call_name(node) or ""
        short = name.split(".")[-1]
        is_thread = name.endswith("threading.Thread") or short == "Thread"
        # spawn-helper indirection (fleet's `self._spawn(fn, name)` /
        # `_threaded_spawn`): exact names only — a fuzzy "contains
        # spawn" match would swallow unrelated helpers
        is_spawn = (not is_thread
                    and short.lower() in ("spawn", "_spawn", "spawn_fn",
                                          "_threaded_spawn",
                                          "threaded_spawn",
                                          "spawn_thread")
                    and (node.args or any(k.arg == "target"
                                          for k in node.keywords)))
        if not (is_thread or is_spawn):
            return
        fn_node = mod.enclosing_function(node)
        fi = self._owning_info(mod, fn_node)
        target = None
        for kw in node.keywords:
            if kw.arg == "target":
                target = kw.value
                break
        if target is None and is_spawn and node.args:
            target = node.args[0]
        if target is None:
            return                            # Thread subclass/opaque use
        tq = self._resolve_target(mod, fi, target)
        daemon: Optional[bool] = None
        named = False
        for kw in node.keywords:
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                daemon = bool(kw.value.value)
            elif kw.arg == "name":
                named = True
        if is_spawn and not named:
            # spawn helpers take the name positionally (fleet's
            # `_threaded_spawn(fn, name)`): 2+ args = named
            named = len(node.args) >= 2
        owner = fi if fi is not None else _ModuleLevel(mod)
        self.spawns.append(ThreadSpawn(
            node=node, module=mod, owner=owner, target_qual=tq,
            target_text=_expr_text(mod, target),
            daemon=daemon, named=named,
            assigned_attr=self._assigned_attr(mod, node)))

    def _resolve_target(self, mod: ModuleInfo, fi: Optional[FunctionInfo],
                        target: ast.AST) -> Optional[str]:
        if isinstance(target, ast.Lambda):
            # `lambda: self._relaunch(r)` — resolve the single call body
            body = target.body
            if isinstance(body, ast.Call):
                target = body.func
            else:
                return None
        if fi is None:
            # module-level spawn: resolve against a synthetic module fn
            dotted = mod.dotted(target)
            if dotted and dotted in self.graph.functions:
                return dotted
            if dotted and "." not in dotted:
                cand = f"{module_dotted(mod.path)}.{dotted}"
                if cand in self.graph.functions:
                    return cand
            return None
        return self.graph.resolve(fi, target)

    @staticmethod
    def _assigned_attr(mod: ModuleInfo, call: ast.Call) -> Optional[str]:
        parent = mod.parent(call)
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
            t = parent.targets[0]
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and t.value.id == "self":
                return t.attr
        return None

    # ------------------------------------------------- acquisition ordering
    def _build_order_edges(self) -> List[OrderEdge]:
        edges: List[OrderEdge] = []
        seen: Set[Tuple[str, str, int]] = set()
        for e in self._co_item_edges:
            key = (e.src, e.dst, getattr(e.node, "lineno", 0))
            if key not in seen:
                seen.add(key)
                edges.append(e)
        for fc in self.functions.values():
            for region in fc.regions:
                self._edges_from_region(fc, region, edges, seen)
        return edges

    def _edges_from_region(self, fc: FunctionConcurrency, region: LockRegion,
                           edges: List[OrderEdge],
                           seen: Set[Tuple[str, str, int]]):
        mod = fc.info.module
        held = region.lock_id

        def note(dst: str, node: ast.AST, via: Tuple[str, ...]):
            if dst == held:
                return               # re-entrant self-acquire: not an order
            key = (held, dst, getattr(node, "lineno", 0))
            if key in seen:
                return
            seen.add(key)
            edges.append(OrderEdge(held, dst, mod, node, via))

        # lexical scan of the region body (nested defs skipped: they run
        # on their own activation, usually another thread)
        for stmt in getattr(region.node, "body", []):
            for node in _region_walk(stmt):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        if _lockish(mod, item):
                            note(lock_identity(mod, fc.info,
                                               _unwrap_with_expr(item)),
                                 node, ())
                elif isinstance(node, ast.Call):
                    tq = self.graph.resolve(fc.info, node.func)
                    if tq is None:
                        continue
                    if tq not in self._chain_cache:
                        self._chain_cache[tq] = self.graph.reach_chains(
                            tq, self.depth - 1)
                    for reached, chain in self._chain_cache[tq].items():
                        rfc = self.functions.get(reached)
                        if rfc is None:
                            continue
                        for lid in sorted(rfc.acquired_ids):
                            note(lid, node, tuple(chain))

    # ------------------------------------------------------------- queries
    def cycles(self) -> List[List[str]]:
        """Strongly-connected components of the acquisition-order graph
        with more than one lock — each is a potential deadlock (two
        threads can take the pair in opposite orders)."""
        return find_cycles((e.src, e.dst) for e in self.order_edges)

    # ----------------------------------------------------------- artifact
    def lock_graph_doc(self) -> dict:
        """The --lock-graph JSON artifact (docs/STATIC_ANALYSIS.md)."""
        from deeplearning4j_tpu_torch.analysis.core import _portable
        return {
            "version": 1,
            "locks": {
                lid: {"declared_at": f"{_portable(p)}:{line}"}
                for lid, (p, line) in sorted(self.locks.items())},
            "edges": [
                {"from": e.src, "to": e.dst,
                 "site": f"{_portable(e.module.path)}:"
                         f"{getattr(e.node, 'lineno', 0)}",
                 "via": list(e.via)}
                for e in sorted(self.order_edges,
                                key=lambda e: (e.src, e.dst))],
            "cycles": self.cycles(),
        }


def find_cycles(edge_pairs) -> List[List[str]]:
    """SCCs with more than one node over (src, dst) pairs — shared by
    the static rule and the runtime-witness cross-check (which runs it
    over static ∪ observed edges: the combined graph must stay
    acyclic)."""
    adj: Dict[str, Set[str]] = {}
    for src, dst in edge_pairs:
        adj.setdefault(src, set()).add(dst)
        adj.setdefault(dst, set())
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str):
        # iterative Tarjan (the lock graph is small, but recursion
        # limits are not a failure mode a linter should have)
        work = [(v, iter(sorted(adj.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                elif w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    out.append(sorted(comp))

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)
    return out


class _ModuleLevel:
    """Placeholder owner for spawns outside any function."""

    cls = None

    def __init__(self, mod: ModuleInfo):
        self.module = mod
        self.qual = module_dotted(mod.path) + ".<module>"
        self.node = mod.tree
        self.name = "<module>"


def _region_walk(stmt: ast.AST) -> Iterable[ast.AST]:
    """Yield `stmt` and descendants, skipping nested def/class bodies."""
    stack = [stmt]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _expr_text(mod: ModuleInfo, expr: ast.AST) -> str:
    try:
        return ast.unparse(expr)
    except Exception:                         # pragma: no cover
        return "<expr>"
