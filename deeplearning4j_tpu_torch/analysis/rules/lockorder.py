"""Interprocedural lock rules: lock-order-inversion and
transitive-blocking-under-lock.

Both consume the shared ConcurrencyModel (analysis/concurrency.py): a
cross-module lock acquisition-order graph and per-function may-block
facts stitched together by the package call graph.

**lock-order-inversion** — if thread 1 takes A then B while thread 2
takes B then A, each can end up holding one lock and waiting forever on
the other. The acquisition-order graph has an edge A->B for every place
B is acquired while A is held (lexically nested ``with``s OR a call
chain from inside A's region reaching a function that acquires B);
a cycle in that graph is the deadlock precondition. The fleet's original
supervisor shape was one `kill`+`join` away from exactly this — tick()
held the supervisor lock while relaunch paths re-entered registry
locks.

**transitive-blocking-under-lock** — the blocking-under-lock rule is
lexical: it sees ``time.sleep`` inside ``with lock:`` but not
``self._relaunch()`` inside ``with lock:`` where _relaunch -> launch ->
``Popen.wait``. That one-call-below shape froze the whole fleet once
and was only caught in review. This rule follows the call graph up
to K edges out of every held region and reports the chain.

Precision: the call graph resolves dotted + self.-method calls only
(callgraph.py); duck-typed dispatch is invisible, so these rules
under-approximate — they can miss, they don't invent. A reported chain
is a real static call path.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from deeplearning4j_tpu_torch.analysis.core import (
    Finding, Project, ProjectRule,
)
from deeplearning4j_tpu_torch.analysis.rules.locks import _blocking_kind

#: call-edge horizon for the transitive blocking scan ("within K call
#: edges of a held lock"); the fleet-freeze shape (tick -> _relaunch -> launch
#: -> Popen.wait) needs 3
TRANSITIVE_DEPTH = 3


class LockOrderInversionRule(ProjectRule):
    name = "lock-order-inversion"
    summary = ("cycles in the cross-module lock acquisition-order graph "
               "(two threads can take the locks in opposite orders and "
               "deadlock)")
    historical = ("supervisor tick lock held across replica "
                  "relaunch/registry paths — one re-entered lock away "
                  "from an AB/BA deadlock; found twice in review")

    def check_project(self, project: Project) -> Iterable[Finding]:
        model = project.concurrency()
        for cycle in model.cycles():
            desc = " -> ".join(cycle + [cycle[0]])
            # report every edge that participates in the cycle, at its
            # own acquisition site, so each site can be individually
            # fixed or pragma-justified
            members = set(cycle)
            for e in model.order_edges:
                if e.src in members and e.dst in members:
                    via = (" via " + " -> ".join(e.via)) if e.via else \
                        " (lexically nested)"
                    yield Finding(
                        rule=self.name, path=e.module.path,
                        line=getattr(e.node, "lineno", 1),
                        col=getattr(e.node, "col_offset", 0),
                        message=(
                            f"acquires {e.dst!r} while holding "
                            f"{e.src!r}{via}, completing the cycle "
                            f"[{desc}] — another thread taking these "
                            "locks in the opposite order deadlocks "
                            "both; pick ONE global order (see the "
                            "--lock-graph artifact)"))


class TransitiveBlockingUnderLockRule(ProjectRule):
    name = "transitive-blocking-under-lock"
    summary = ("a may-block call reachable within "
               f"{TRANSITIVE_DEPTH} call edges of a held lock "
               "(the lexical blocking-under-lock rule generalized "
               "through the call graph)")
    historical = ("SubprocessReplica relaunch — Popen.wait one "
                  "call below the supervisor tick lock — froze probing "
                  "of the whole fleet; lexically invisible, hand-found "
                  "in review twice")

    def check_project(self, project: Project) -> Iterable[Finding]:
        from deeplearning4j_tpu_torch.analysis.concurrency import _region_walk
        model = project.concurrency()
        graph = model.graph
        seen = set()
        for fc in model.functions.values():
            mod = fc.info.module
            for region in fc.regions:
                for stmt in getattr(region.node, "body", []):
                    for node in _region_walk(stmt):
                        if not isinstance(node, ast.Call):
                            continue
                        if _blocking_kind(mod, node):
                            continue          # lexical rule's territory
                        tq = graph.resolve(fc.info, node.func)
                        if tq is None:
                            continue
                        f = self._first_blocking_chain(
                            model, tq, region.lock_name, mod, node)
                        if f is not None:
                            key = (f.path, f.line, f.message)
                            if key not in seen:
                                seen.add(key)
                                yield f

    def _first_blocking_chain(self, model, start: str, lock_name: str,
                              mod, call_node) -> "Finding | None":
        chains = model.graph.reach_chains(start, TRANSITIVE_DEPTH - 1)
        best: "tuple[int, List[str], str] | None" = None
        for reached, chain in chains.items():
            rfc = model.functions.get(reached)
            if rfc is None or not rfc.blocks:
                continue
            kind = rfc.blocks[0].kind
            cand = (len(chain), chain, kind)
            if best is None or cand[0] < best[0]:
                best = cand
        if best is None:
            return None
        _, chain, kind = best
        shown = " -> ".join(q.rsplit(".", 2)[-1] if q.count(".") < 2
                            else ".".join(q.rsplit(".", 2)[-2:])
                            for q in chain)
        # edge count includes the call FROM the lock region into
        # chain[0] — `with lock: helper()` where helper sleeps is
        # 1 edge below the with, not 0
        return Finding(
            rule=self.name, path=mod.path,
            line=getattr(call_node, "lineno", 1),
            col=getattr(call_node, "col_offset", 0),
            message=(
                f"call chain {shown} reaches {kind} while holding "
                f"{lock_name!r} ({len(chain)} call edge(s) below "
                "the `with` — lexically invisible, the PR-8 "
                "fleet-freeze shape); move the blocking work outside "
                "the critical section or cap it with a deadline"))
