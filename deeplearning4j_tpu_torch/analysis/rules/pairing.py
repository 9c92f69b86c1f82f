"""Rule: resource-pairing — the half-open-slot-leak class.

Some resources in this tree are acquired by one call and MUST be given
back by a matching call on **every** path: a circuit breaker's
half-open probe slot (``allow()`` -> exactly one of ``release()`` /
``record_success()`` / ``record_failure()``), a kvcache slot
(``admit``/``admit_prompt`` -> ``release``), a shared-memory segment
(``SharedMemory(create=True)`` -> ``unlink``). The reference shipped the
canonical miss: a half-open probe answered with a 429 hit a branch that
recorded *neither* success nor failure nor release — the slot leaked
and the breaker wedged half-open FOREVER, silently excluding a healthy
replica until a generation bump.

The check is per-function and deliberately narrow (no interprocedural
protocol tracking — a scheduler that admits in one method and releases
in another is out of scope and stays silent):

- it engages only when a function contains BOTH an acquire and at least
  one matching release on the *same receiver expression* — that is the
  "this function owns the pairing" signal;
- releases inside a ``finally`` block satisfy every path at once;
- otherwise, any ``return`` / ``raise`` / ``continue`` / ``break``
  between the acquire and the function's last release that has no
  release on its own branch path is flagged — that early exit walks
  away holding the resource;
- denied-acquire branches (``if not x.allow(): return`` and the
  ``while not x.allow():`` pick loop) are exempt: a denied acquire
  holds nothing.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, List, Optional, Tuple

from deeplearning4j_tpu_torch.analysis.core import Finding, ModuleInfo, Rule

#: (acquire attr, release attrs, what leaks) — attribute-call pairs
#: matched on identical receiver source text
_ATTR_PAIRS = (
    ("allow", ("release", "record_success", "record_failure"),
     "the breaker's half-open probe slot"),
    ("admit", ("release",), "the kvcache slot + its pages"),
    ("admit_prompt", ("release",), "the kvcache slot + its pages"),
)

#: constructor-style acquire: SharedMemory(create=True) must meet
#: .unlink() (the owner side) in the same function or a finally
_SHM_RELEASES = ("unlink", "close")


@dataclasses.dataclass
class _Acquire:
    node: ast.Call
    recv: str                     # receiver source text ("" for ctor)
    releases: Tuple[str, ...]
    what: str


def _recv_text(call: ast.Call) -> Optional[str]:
    if not isinstance(call.func, ast.Attribute):
        return None
    try:
        return ast.unparse(call.func.value)
    except Exception:             # pragma: no cover
        return None


class ResourcePairingRule(Rule):
    name = "resource-pairing"
    summary = ("declared acquire/release pairs (breaker allow/release, "
               "kvcache admit/release, SharedMemory create/unlink) must "
               "pair on every path or sit in try/finally")
    historical = ("a half-open probe slot consumed by allow() "
                  "leaked on the 429 branch (neither release nor "
                  "record_*) and wedged the breaker half-open forever, "
                  "excluding a healthy replica until a generation bump")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_function(mod, node)

    # ---------------------------------------------------------- function
    def _check_function(self, mod: ModuleInfo, fn: ast.AST
                        ) -> Iterable[Finding]:
        acquires: List[_Acquire] = []
        # collect this function's own calls — nested defs excluded for
        # ACQUIRES (they run later, on their own activation) but
        # included for RELEASES (a completion callback owning the
        # release is a legitimate pairing pattern, e.g. the router's
        # stream done() closure)
        for call in _walk_skip_defs(fn):
            if not isinstance(call, ast.Call):
                continue
            if isinstance(call.func, ast.Attribute):
                for acq, rels, what in _ATTR_PAIRS:
                    if call.func.attr == acq:
                        recv = _recv_text(call) or ""
                        acquires.append(_Acquire(call, recv, rels, what))
            if isinstance(call.func, (ast.Name, ast.Attribute)):
                name = mod.call_name(call) or ""
                if name.endswith("SharedMemory") and any(
                        kw.arg == "create" and
                        isinstance(kw.value, ast.Constant) and
                        kw.value.value is True for kw in call.keywords):
                    acquires.append(_Acquire(call, "", _SHM_RELEASES,
                                             "the shared-memory segment"))
        if not acquires:
            return                # the overwhelmingly common fast path
        all_calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
        for acq in acquires:
            yield from self._check_acquire(mod, fn, acq, all_calls)

    def _check_acquire(self, mod: ModuleInfo, fn: ast.AST, acq: _Acquire,
                       all_calls: List[ast.Call]) -> Iterable[Finding]:
        if acq.recv:
            releases = [c for c in all_calls
                        if isinstance(c.func, ast.Attribute)
                        and c.func.attr in acq.releases
                        and _recv_text(c) == acq.recv]
        else:
            # ctor acquire: match any release-named call in the function
            releases = [c for c in all_calls
                        if isinstance(c.func, ast.Attribute)
                        and c.func.attr in acq.releases]
        if not releases:
            return                # cross-function protocol: out of scope
        if all(_in_finally(mod, r) for r in releases):
            return                # every path pays on the way out
        a_line = acq.node.lineno
        last_release = max(r.lineno for r in releases)
        for exit_node in _walk_skip_defs(fn):
            if not isinstance(exit_node, (ast.Return, ast.Raise,
                                          ast.Continue, ast.Break)):
                continue
            e_line = exit_node.lineno
            if not (a_line < e_line < last_release):
                continue
            if _in_denied_branch(mod, exit_node, acq.node):
                continue
            if any(r.lineno <= e_line and _on_path(mod, r, exit_node)
                   for r in releases):
                continue
            if _in_finally(mod, exit_node):
                continue
            kind = type(exit_node).__name__.lower()
            yield self.finding(
                mod, exit_node,
                f"this {kind} exits while still holding {acq.what} "
                f"acquired at line {a_line} ({acq.recv or 'ctor'}."
                f"{_attr_of(acq.node)}) — no "
                f"{'/'.join(acq.releases)} on this path (the PR-8 "
                "half-open-slot leak shape); release on every path or "
                "move the release into try/finally")


def _attr_of(call: ast.Call) -> str:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return getattr(call.func, "id", "<call>")


def _walk_skip_defs(fn: ast.AST) -> Iterable[ast.AST]:
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _in_finally(mod: ModuleInfo, node: ast.AST) -> bool:
    child = node
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.Try) and child in _subtree_set(anc.finalbody):
            return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        child = anc
    return False


def _subtree_set(stmts) -> set:
    out = set()
    for s in stmts:
        for n in ast.walk(s):
            out.add(n)
    return out


def _assigned_name(mod: ModuleInfo, call: ast.Call) -> Optional[str]:
    """`info = x.admit_prompt(p)` -> "info" (single-Name assignment)."""
    parent = mod.parent(call)
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1 and \
            isinstance(parent.targets[0], ast.Name):
        return parent.targets[0].id
    return None


def _in_denied_branch(mod: ModuleInfo, exit_node: ast.AST,
                      acquire: ast.Call) -> bool:
    """`if not x.allow(): return` / `while not x.allow(): ...continue` /
    `info = x.admit(n); if info is None: return` — the exit lives in a
    branch where the acquire was DENIED, so nothing is held."""
    result_name = _assigned_name(mod, acquire)
    for anc in mod.ancestors(exit_node):
        if isinstance(anc, (ast.If, ast.While)):
            test = anc.test
            if isinstance(test, ast.UnaryOp) and \
                    isinstance(test.op, ast.Not) and \
                    acquire in set(ast.walk(test)):
                return True
            if result_name is not None and isinstance(test, ast.Compare) \
                    and isinstance(test.left, ast.Name) \
                    and test.left.id == result_name \
                    and len(test.ops) == 1 \
                    and isinstance(test.ops[0], ast.Is) \
                    and isinstance(test.comparators[0], ast.Constant) \
                    and test.comparators[0].value is None:
                return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
    return False


def _on_path(mod: ModuleInfo, release: ast.AST, exit_node: ast.AST) -> bool:
    """Approximate 'release executes before this exit': true unless the
    release sits in a DIFFERENT branch of the lowest common If/Try
    ancestor (then one of the two paths skips it)."""
    r_anc = [release] + list(mod.ancestors(release))
    e_anc = set([exit_node] + list(mod.ancestors(exit_node)))
    lca = next((a for a in r_anc if a in e_anc), None)
    if lca is None or not isinstance(lca, (ast.If, ast.Try)):
        return True
    # which branch of the LCA holds each node?
    def branch_of(node):
        fields = [("body", lca.body)]
        if isinstance(lca, ast.If):
            fields.append(("orelse", lca.orelse))
        else:
            fields.append(("handlers", lca.handlers))
            fields.append(("orelse", lca.orelse))
            fields.append(("finalbody", lca.finalbody))
        for fname, stmts in fields:
            if node in _subtree_set(stmts):
                return fname
        return None

    return branch_of(release) == branch_of(exit_node)
