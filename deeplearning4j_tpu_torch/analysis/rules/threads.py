"""Rule: thread-lifecycle — the silent-thread-death class.

Three checks over every discovered thread entry point
(``threading.Thread(target=...)`` plus spawn-helper indirections like
fleet's ``_threaded_spawn``):

1. **Unguarded target.** A worker thread's uncaught exception kills ONLY
   that thread: the process lives on, the component keeps reporting
   healthy, and the work silently never happens again. The reference shipped
   exactly this — the decode scheduler (the only thread that reclaims
   KV slots) died on an admission error while the servable still said
   "ready"; review added the fail-loud guard. Resolvable project
   targets must have a top-level ``try/except`` (directly, or at the
   top of their main loop). Opaque targets (``serve_forever`` on an
   stdlib object) can't be checked and are skipped.
2. **Non-daemon thread never joined.** A non-daemon worker with no
   ``join()`` in any ``stop``/``shutdown``/``close``/``drain``-family
   method blocks interpreter exit forever when someone forgets it —
   and a *daemonized* fix would trade that for silent mid-write kills.
   Threads stored on ``self`` are matched against the owning class's
   teardown methods.
3. **Unnamed thread.** The trace tracks and the deadlock sentinel's
   stack dumps key on thread names; an unnamed ``Thread-23`` makes both
   unreadable. Every spawn must pass ``name=`` (spawn helpers: a
   positional name argument).
"""
from __future__ import annotations

import ast
from typing import Iterable

from deeplearning4j_tpu_torch.analysis.core import (
    Finding, Project, ProjectRule,
)

#: method-name fragments that count as a teardown surface for check 2
_TEARDOWN_HINTS = ("stop", "shutdown", "close", "drain", "join", "__exit__")


def _has_top_level_guard(fn_node: ast.AST) -> bool:
    """True when the function body has a try/except at its top level, or
    at the top level of a directly-nested With / main loop (the
    transport-reader idiom: ``while ...: try: ... except: ...``)."""
    def guarded(stmts, depth: int) -> bool:
        for stmt in stmts:
            if isinstance(stmt, ast.Try) and stmt.handlers:
                return True
            if depth > 0 and isinstance(
                    stmt, (ast.While, ast.For, ast.With, ast.If)):
                if guarded(stmt.body, depth - 1):
                    return True
        return False

    return guarded(getattr(fn_node, "body", []), 2)


class ThreadLifecycleRule(ProjectRule):
    name = "thread-lifecycle"
    summary = ("thread targets without a fail-loud top-level exception "
               "guard; non-daemon threads never joined in any teardown "
               "method; unnamed threads")
    historical = ("the decode scheduler thread — the only place "
                  "KV slots are reclaimed — died silently on an "
                  "unguarded admission error while the servable kept "
                  "reporting ready; the fleet's threads so "
                  "traces and stack dumps are attributable")

    def check_project(self, project: Project) -> Iterable[Finding]:
        model = project.concurrency()
        for spawn in model.spawns:
            line = getattr(spawn.node, "lineno", 1)
            col = getattr(spawn.node, "col_offset", 0)

            def mk(msg: str) -> Finding:
                return Finding(rule=self.name, path=spawn.module.path,
                               line=line, col=col, message=msg)

            if not spawn.named:
                yield mk(
                    f"unnamed thread (target={spawn.target_text}) — "
                    "trace tracks and deadlock-sentinel stack dumps "
                    "key on thread names (the PR-13 policy); pass "
                    "name=")
            if spawn.target_qual is not None:
                ti = model.graph.functions.get(spawn.target_qual)
                if ti is not None and not _has_top_level_guard(ti.node):
                    short = spawn.target_qual.rsplit(".", 1)[-1]
                    yield mk(
                        f"thread target {short}() has no top-level "
                        "exception guard — an uncaught exception kills "
                        "only this thread while the process keeps "
                        "reporting healthy (the PR-11 decode-scheduler "
                        "death); wrap the body in try/except that "
                        "records the failure loudly")
            if spawn.daemon is not True and spawn.assigned_attr and \
                    not self._joined_somewhere(model, spawn):
                yield mk(
                    f"non-daemon thread self.{spawn.assigned_attr} is "
                    "never join()ed in any stop/shutdown/close method "
                    "— it blocks interpreter exit forever if teardown "
                    "forgets it; join it in the owner's teardown (or "
                    "daemonize AND guard it)")

    @staticmethod
    def _joined_somewhere(model, spawn) -> bool:
        """Is ``self.<attr>.join`` (or ``<local> = self.<attr> ...
        .join``) called in any teardown-named method of the owning
        class?"""
        cls = getattr(spawn.owner, "cls", None)
        attr = spawn.assigned_attr
        candidates = [
            fi for fi in model.graph.functions.values()
            if fi.cls == cls and any(h in fi.name.lower()
                                     for h in _TEARDOWN_HINTS)
        ] if cls else []
        for fi in candidates:
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "join":
                    base = node.func.value
                    if isinstance(base, ast.Attribute) and \
                            base.attr == attr:
                        return True
                    if isinstance(base, ast.Name):
                        # `t = self._thread; ...; t.join()` — accept a
                        # join on any local in a teardown method whose
                        # body also reads self.<attr> (cheap dataflow)
                        if _reads_self_attr(fi.node, attr):
                            return True
        return False


def _reads_self_attr(fn_node: ast.AST, attr: str) -> bool:
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Attribute) and node.attr == attr and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self":
            return True
    return False
