"""Rule: bare-except-swallow — silent failure in process-boundary code.

In worker / replica / supervisor processes an exception swallowed with
``except: pass`` doesn't crash anything visibly — the process keeps
running wedged, and the parent's only signal is a probe timeout minutes
later. The resilience layer's whole design is that failures
are OBSERVED: counted, logged, or re-raised. This rule flags, in
process-boundary modules (parallel/, serving/, data/pipeline.py,
train/resilience.py):

- bare ``except:`` anywhere (also catches SystemExit/KeyboardInterrupt,
  breaking clean preemption);
- ``except Exception/BaseException`` handlers whose body does NOTHING
  (only pass/continue/break): no re-raise, no logging, no metric, no
  state recorded. A handler that logs, counts, or assigns is fine —
  best-effort cleanup with a recorded decision gets a pragma.
"""
from __future__ import annotations

import ast
from typing import Iterable

from deeplearning4j_tpu_torch.analysis.core import Finding, ModuleInfo, Rule

_SCOPE_MARKERS = ("/parallel/", "/serving/", "/data/pipeline.py",
                  "/train/resilience.py", "/monitor/", "/clustering/")
_BROAD = {"Exception", "BaseException"}


def _in_scope(path: str) -> bool:
    p = path.replace("\\", "/")
    return any(m in p for m in _SCOPE_MARKERS)


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Name) and t.id in _BROAD:
        return True
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name) and e.id in _BROAD
                   for e in t.elts)
    return False


def _swallows(handler: ast.ExceptHandler) -> bool:
    """Body does nothing observable: only pass/continue/break (a leading
    docstring-style constant allowed)."""
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                     ast.Constant):
            continue
        return False
    return True


class BareExceptSwallowRule(Rule):
    name = "bare-except-swallow"
    summary = ("bare `except:` / silent `except Exception: pass` in "
               "worker/replica/supervisor process code")
    historical = ("a wedged replica's only failure signal was a "
                  "probe timeout — swallowed exceptions in process-"
                  "boundary code turn crashes into silent hangs")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        if not _in_scope(mod.path):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield self.finding(
                    mod, node,
                    "bare `except:` also catches SystemExit/"
                    "KeyboardInterrupt — clean preemption (PR 3) relies "
                    "on those propagating; catch Exception at most")
            elif _is_broad(node) and _swallows(node):
                yield self.finding(
                    mod, node,
                    "broad exception swallowed with no log/metric/"
                    "re-raise in process-boundary code — failures here "
                    "must be observed (count it, log it, or narrow the "
                    "type); suppress with a justification if this "
                    "cleanup is genuinely best-effort")
