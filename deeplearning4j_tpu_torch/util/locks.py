"""DiagnosedLock — the runtime witness for graftlint's static lock graph.

The static side (analysis/concurrency.py) derives a cross-module lock
acquisition-order graph from the AST; cycles in it gate tier-1
(lock-order-inversion). This module is the other half of the contract:

- `DiagnosedLock` is a drop-in ``threading.Lock``/``RLock`` wrapper
  (``with``, ``acquire``/``release``, ``locked``) carrying the lock's
  *static identity* (``deeplearning4j_tpu_torch.serving.registry.
  ModelRegistry._lock``). When recording is on it notes, per
  acquisition, every (held -> acquired) pair observed on the acquiring
  thread plus a live holder table.
- Tests cross-check: every edge the runtime actually witnessed must
  appear in the static graph — if live execution takes a lock order the
  analyzer never derived, the model (or the code) is wrong, and the
  test says which pair.
- The pytest deadlock sentinel (tests/conftest.py) dumps
  `holder_table()` + every thread's stack when a test wedges, so a
  tier-1 deadlock reads as "thread A holds X wants Y; thread B holds Y
  wants X" instead of a mute timeout kill.

Cost model: recording is OFF by default (``DL4J_CUDA_LOCK_DIAG`` opt-in,
only ``"1"`` enables — util/env.py contract) and the recording ops are
single dict/set mutations, GIL-atomic in CPython, so no extra lock is
taken around the user's lock — the witness must never reorder or
serialize what it watches. Tests arm it via `enable_recording()`.
"""
from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Dict, Optional, Set, TextIO, Tuple

from deeplearning4j_tpu_torch.util.env import env_flag

#: observed acquisition-order pairs (held_name, acquired_name)
_order_edges: Set[Tuple[str, str]] = set()
#: (lock name, instance id) -> (holder thread name, monotonic acquire
#: time). Keyed per INSTANCE: many locks share one static identity
#: (every CircuitBreaker's `_lock`, every Replica's `_inflight_lock`),
#: and one instance's release must not evict a sibling still held by
#: another thread from the sentinel's table
_holders: Dict[Tuple[str, int], Tuple[str, float]] = {}
#: per-thread stack of currently-held DiagnosedLock names
_held = threading.local()

_recording = env_flag("DL4J_CUDA_LOCK_DIAG", default=False)


def enable_recording(on: bool = True) -> None:
    """Arm/disarm edge + holder recording (tests; production uses the
    DL4J_CUDA_LOCK_DIAG opt-in)."""
    global _recording
    _recording = bool(on)


def recording_enabled() -> bool:
    return _recording


def reset() -> None:
    """Clear recorded edges/holders (test isolation)."""
    _order_edges.clear()
    _holders.clear()


def observed_edges() -> Set[Tuple[str, str]]:
    """Every (held -> acquired) pair witnessed since the last reset()."""
    return set(_order_edges)


def holder_table() -> Dict[str, Tuple[str, float]]:
    """lock name -> (holder thread, seconds held so far), live. When
    several INSTANCES sharing one static identity are held at once,
    later ones display as ``name#2``, ``name#3`` …"""
    now = time.monotonic()
    out: Dict[str, Tuple[str, float]] = {}
    for (name, _inst), (thread, t0) in sorted(list(_holders.items()),
                                              key=lambda kv: kv[1][1]):
        display, n = name, 1
        while display in out:
            n += 1
            display = f"{name}#{n}"
        out[display] = (thread, now - t0)
    return out


class DiagnosedLock:
    """Drop-in Lock/RLock with a static-graph identity.

    ``name`` should be the lock's static identity so the witness
    cross-check can compare runtime edges against the analyzer's graph
    verbatim; ``reentrant=True`` wraps an RLock.
    """

    __slots__ = ("name", "_lock", "_reentrant", "_count")

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self._reentrant = bool(reentrant)
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self._count = 0          # RLock depth (RLock has no locked())

    # ------------------------------------------------------ lock protocol
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            if self._reentrant:
                self._count += 1          # safe: we hold the lock
            if _recording:
                self._note_acquire()
        return ok

    def release(self) -> None:
        if self._reentrant:
            self._count -= 1              # safe: we still hold the lock
        if _recording:
            self._note_release()
        self._lock.release()

    def __enter__(self) -> "DiagnosedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        if self._reentrant:
            # RLock has no locked() before 3.12; the tracked depth is
            # exact for the owner and a best-effort probe for others
            return self._count > 0
        return self._lock.locked()

    def __repr__(self) -> str:                # pragma: no cover - debug
        return f"DiagnosedLock({self.name!r})"

    # --------------------------------------------------------- recording
    def _note_acquire(self) -> None:
        stack = getattr(_held, "stack", None)
        if stack is None:
            stack = _held.stack = []    # entries: (name, instance id)
        for held_name, _inst in stack:
            # same-name pairs are skipped: the static graph has one node
            # per identity, so instance-vs-instance ordering of one
            # attribute would be a self-loop there (a KNOWN limitation —
            # cross-instance AB/BA of a single attr is invisible to both
            # halves)
            if held_name != self.name:
                _order_edges.add((held_name, self.name))
        _holders[(self.name, id(self))] = (
            threading.current_thread().name, time.monotonic())
        stack.append((self.name, id(self)))

    def _note_release(self) -> None:
        key = (self.name, id(self))
        stack = getattr(_held, "stack", None)
        if stack:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == key:
                    del stack[i]
                    break
        if not stack or key not in stack:
            # this thread no longer holds THIS instance (re-entrant
            # depth exhausted); sibling instances keep their own entries
            _holders.pop(key, None)


# --------------------------------------------------------- sentinel dump
def dump_diagnostics(out: Optional[TextIO] = None,
                     reason: str = "deadlock suspected") -> None:
    """The deadlock-sentinel payload: the lock-holder table plus every
    live thread's current stack (names included — the thread-naming
    policy is what makes this readable). Written to `out` (default
    stderr) in one pass so an ensuing hard exit cannot truncate the
    interesting half."""
    out = out if out is not None else sys.stderr
    lines = [f"==== graftlint deadlock sentinel: {reason} ====",
             "---- lock holder table ----"]
    table = holder_table()
    if table:
        for name in sorted(table):
            thread, held_for = table[name]
            lines.append(f"  {name}  held by {thread!r} "
                         f"for {held_for:.1f}s")
    else:
        lines.append("  (no DiagnosedLock held, or recording is off)")
    lines.append("---- all thread stacks ----")
    frames = sys._current_frames()
    for t in threading.enumerate():
        lines.append(f"-- thread {t.name!r} "
                     f"(daemon={t.daemon}, ident={t.ident}) --")
        frame = frames.get(t.ident)
        if frame is None:
            lines.append("   <no frame>")
            continue
        lines.extend(
            "   " + ln.rstrip("\n")
            for entry in traceback.format_stack(frame)
            for ln in entry.splitlines())
    lines.append("==== end sentinel dump ====")
    out.write("\n".join(lines) + "\n")
    out.flush()
