"""Pytest deadlock sentinel — a wedged test dies WITH diagnostics.

Before this plugin, a deadlocked test was a mute hang: the tier-1
``timeout`` wrapper eventually killed the whole run and CI showed
nothing but the kill. The sentinel watches per-test wall time from a
daemon thread; past the budget it writes util/locks.dump_diagnostics()
— every thread's stack plus the DiagnosedLock holder table, so the
failure reads as "thread A holds X and wants Y; thread B holds Y and
wants X" — then hard-exits 3.

Loaded two ways:

- tests/conftest.py imports the hook (tier-1 gets it automatically);
- ``pytest -p deeplearning4j_tpu_torch.util.sentinel`` loads it standalone
  (how the deliberate-deadlock regression test drives it).

Knobs (util/env.py contract — only the literal ``"0"`` disables):

- ``DL4J_CUDA_DEADLOCK_SENTINEL``: kill switch for the whole plugin.
- ``DL4J_CUDA_SENTINEL_TIMEOUT``: per-test budget in seconds
  (default 300 — comfortably above the slowest legitimate test, far
  below the tier-1 run budget).

Arming the sentinel also arms util/locks recording, so the holder
table is populated when the dump fires.
"""
from __future__ import annotations

import os
import sys
import threading
import time

import pytest

from deeplearning4j_tpu_torch.util import locks as _locks
from deeplearning4j_tpu_torch.util.env import env_flag, env_float

SENTINEL_EXIT_CODE = 3

#: the running test as ONE atomically-replaced (nodeid, t0) tuple —
#: separate keys would let the watchdog pair a new test's id with the
#: previous test's start time and spuriously kill a healthy run
_state = {"cur": None}
_thread = None


def _enabled() -> bool:
    return env_flag("DL4J_CUDA_DEADLOCK_SENTINEL", default=True)


def _timeout_s() -> float:
    return float(env_float("DL4J_CUDA_SENTINEL_TIMEOUT", 300.0))


def _loop(timeout_s: float):
    try:
        poll = max(0.05, min(5.0, timeout_s / 4))
        while True:
            time.sleep(poll)
            cur = _state["cur"]
            if cur is None:
                continue
            test, t0 = cur
            if time.monotonic() - t0 > timeout_s:
                # the REAL stderr: pytest's capture buffers sys.stderr
                # in memory, which os._exit would discard — the dump is
                # the whole point of dying
                _locks.dump_diagnostics(
                    out=sys.__stderr__ or sys.stderr,
                    reason=f"test {test} exceeded {timeout_s:.0f}s — "
                           "presumed deadlocked "
                           "(DL4J_CUDA_SENTINEL_TIMEOUT raises the "
                           "budget, DL4J_CUDA_DEADLOCK_SENTINEL=0 "
                           "disables)")
                # hard exit: a deadlocked run cannot unwind itself, and
                # a prompt loud death beats the outer timeout's mute kill
                os._exit(SENTINEL_EXIT_CODE)
    except Exception:                         # noqa: BLE001 — fail loud:
        # a dead watchdog silently un-arms deadlock detection for the
        # rest of the run
        import traceback
        print("deadlock sentinel watchdog crashed:\n"
              + traceback.format_exc(),
              file=sys.__stderr__ or sys.stderr)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    global _thread
    if _enabled():
        if _thread is None:
            # arm the lock witness along with the sentinel: the holder
            # table is what turns "hung" into "who holds what"
            _locks.enable_recording(True)
            _thread = threading.Thread(
                target=_loop, args=(_timeout_s(),), daemon=True,
                name="deadlock-sentinel")
            _thread.start()
        _state["cur"] = (item.nodeid, time.monotonic())
    yield
    _state["cur"] = None
