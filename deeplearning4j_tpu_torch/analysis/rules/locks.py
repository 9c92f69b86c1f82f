"""Rule: blocking-under-lock — the supervisor-freeze class.

A blocking call lexically inside a ``with <lock>:`` body holds the lock
for the call's full duration: one hung replica launch froze probing of
the WHOLE fleet and deadlocked supervisor.stop (fixed twice in
review — relaunches, then probes, moved off the tick lock). The rule
flags calls that can block unboundedly — subprocess spawns,
socket/HTTP IO, sleeps, thread joins, launch-family calls — while a
lock-ish context is held.

Precision notes:

- lock-ish = a `with` context whose expression's last name segment
  contains ``lock``/``mutex`` (``self._tick_lock``, ``_swap_lock``,
  ``REGISTRY._lock`` ...). Condition variables are deliberately NOT
  lock-ish (``with cv: cv.wait()`` is the correct idiom).
- nested function definitions inside the body do not RUN under the
  lock — they are skipped (the fix moved launches into exactly
  such spawn threads).
- ``.join``: a thread/process/queue join blocks; ``str.join`` doesn't.
  A join with no args, a numeric timeout, or a timeout kwarg is the
  blocking kind; ``sep.join(iterable)`` is exempt.
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional

from deeplearning4j_tpu_torch.analysis.core import Finding, ModuleInfo, Rule

_BLOCKING_ATTRS = {"connect", "accept", "recv", "recv_into", "sendall",
                   "getresponse", "urlopen"}
_LAUNCH_HINTS = ("launch", "relaunch")


def _lockish(mod: ModuleInfo, item: ast.withitem) -> Optional[str]:
    expr = item.context_expr
    if isinstance(expr, ast.Call):     # `with self._lock_for(x):` style
        expr = expr.func
    name = None
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    if name is None:
        return None
    low = name.lower()
    if "lock" in low or "mutex" in low:
        return name
    return None


def _blocking_kind(mod: ModuleInfo, call: ast.Call) -> Optional[str]:
    name = mod.call_name(call) or ""
    base = name.split(".")[-1]
    if name == "time.sleep" or base == "sleep":
        return "sleep"
    if name.startswith("subprocess."):
        return name
    if name.startswith("requests.") or base == "urlopen":
        return "HTTP request"
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr in _BLOCKING_ATTRS:
            return f"socket/HTTP .{attr}()"
        if attr == "join":
            if not call.args and not call.keywords:
                return "thread/process join"
            if any(kw.arg == "timeout" for kw in call.keywords):
                return "thread/process join"
            if len(call.args) == 1 and isinstance(call.args[0], ast.Constant) \
                    and isinstance(call.args[0].value, (int, float)):
                return "thread/process join"
            return None
        if attr in ("get", "put") and any(
                kw.arg == "timeout" and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value in (0, 0.0))
                for kw in call.keywords):
            return f"queue .{attr}(timeout=...)"
    if any(h in base.lower() for h in _LAUNCH_HINTS):
        return f"{base}() (launch-family)"
    return None


class BlockingUnderLockRule(Rule):
    name = "blocking-under-lock"
    summary = ("subprocess/socket/HTTP/sleep/join/launch-family calls "
               "lexically inside a `with <lock>` body")
    historical = ("a hung SubprocessReplica relaunch under the "
                  "supervisor tick lock froze probing of the whole fleet "
                  "and deadlocked stop(); fixed twice in review")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            lock_name = None
            for item in node.items:
                lock_name = _lockish(mod, item)
                if lock_name:
                    break
            if not lock_name:
                continue
            for stmt in node.body:
                yield from self._scan(mod, stmt, lock_name)

    def _scan(self, mod: ModuleInfo, node: ast.AST, lock_name: str
              ) -> Iterable[Finding]:
        # code inside nested defs does not run while the lock is held
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        # a nested lock-ish `with` gets its own visit from check()'s
        # outer walk — recursing into it here would double-report every
        # blocking call once per enclosing lock
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _lockish(mod, item) for item in node.items):
            return
        if isinstance(node, ast.Call):
            kind = _blocking_kind(mod, node)
            if kind:
                yield self.finding(
                    mod, node,
                    f"{kind} while holding {lock_name!r} — every other "
                    "thread contending on the lock stalls for the call's "
                    "full duration (the PR-8 fleet-freeze class); move "
                    "the blocking work outside the critical section")
        for child in ast.iter_child_nodes(node):
            yield from self._scan(mod, child, lock_name)
