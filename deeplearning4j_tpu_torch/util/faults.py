"""Deterministic fault-injection harness for resilience testing.

The production story (docs/FAULT_TOLERANCE.md) is only credible if the
recovery paths are exercised: this module injects the three failure
families a preemptible accelerator fleet actually produces —

- **divergence**: a NaN/Inf loss at a chosen step (optimizer state or
  data corruption, bf16 overflow);
- **transient errors**: a retryable exception raised at a chosen step
  (DCN hiccup, preempted host, flaky storage);
- **hard faults**: a simulated crash (kill -9 analog, raised as a
  ``BaseException`` so no recovery layer can swallow it), a simulated
  preemption notice (SIGTERM analog), and dropped transport messages.

Everything is deterministic — schedules are explicit step sets (or an
``every=n`` cadence), so tests and the chaos tool reproduce bit-for-bit.
``FaultInjector.from_env()`` reads ``DL4J_CUDA_FAULTS`` so any entry point
(CLI, chaos tool, CI) can be run under faults without code changes:

    DL4J_CUDA_FAULTS="nan_at=3,4;transient_every=5;crash_at=11"

`ResilientTrainer` (train/resilience.py) consults the injector at its
step boundaries; `attach_transport_faults` wires the message-drop
schedule into a `SocketTransport`.
"""
from __future__ import annotations

import logging
import os
from typing import Iterable, Optional, Set, Tuple

from deeplearning4j_tpu_torch.util.env import env_str

log = logging.getLogger("deeplearning4j_tpu_torch")


class TransientFaultError(RuntimeError):
    """A retryable failure (network hiccup / preempted peer / flaky IO).
    The resilience layer's backoff-and-retry policy treats this class —
    and real ConnectionError/TimeoutError/OSError — as transient."""


class SimulatedCrash(BaseException):
    """A hard kill (SIGKILL / machine loss analog). Derives from
    BaseException ON PURPOSE: no except-Exception recovery path may
    swallow it — exactly like a real kill, the process dies with
    whatever checkpoints already landed on disk."""


def _parse_steps(spec: str) -> Set[int]:
    return {int(tok) for tok in spec.split(",") if tok.strip() != ""}


class FaultInjector:
    """Deterministic, schedule-driven fault source.

    Step indices refer to the trainer's global *dispatch* counter (batches
    consumed across the whole fit, starting at 0). Each scheduled fault
    fires exactly once per step index — a retry of the same step does not
    re-fire the fault, which is what makes transient-retry testable.

    Parameters
    ----------
    nan_at:           steps whose loss is replaced with NaN (divergence).
    transient_at:     steps that raise TransientFaultError before dispatch.
    transient_every:  additionally raise every n-th step (n > 0).
    crash_at:         step that raises SimulatedCrash (uncatchable by the
                      retry layer; the test harness catches it).
    preempt_at:       step at which `should_preempt` turns True (SIGTERM
                      analog delivered through the trainer's flag).
    drop_send_at:     0-based outbound message ordinals a wrapped
                      SocketTransport silently drops.
    etl_stall_at:     steps whose batch fetch is delayed by
                      ``etl_stall_s`` (a throttled input pipeline — the
                      goodput ledger must bill it to data_wait and the
                      step-time anomaly detector must trip on it).
    etl_stall_s:      the injected fetch delay in seconds.
    """

    def __init__(self, nan_at: Iterable[int] = (),
                 transient_at: Iterable[int] = (),
                 transient_every: Optional[int] = None,
                 crash_at: Optional[int] = None,
                 preempt_at: Optional[int] = None,
                 drop_send_at: Iterable[int] = (),
                 etl_stall_at: Iterable[int] = (),
                 etl_stall_s: float = 0.0):
        self.nan_at = set(nan_at)
        self.transient_at = set(transient_at)
        self.transient_every = transient_every
        self.crash_at = crash_at
        self.preempt_at = preempt_at
        self.drop_send_at = set(drop_send_at)
        self.etl_stall_at = set(etl_stall_at)
        self.etl_stall_s = float(etl_stall_s)
        self._fired: Set[Tuple[str, int]] = set()
        self.nans_injected = 0
        self.transients_injected = 0
        self.sends_dropped = 0
        self.stalls_injected = 0

    # ------------------------------------------------------------- parsing
    @classmethod
    def from_env(cls, var: str = "DL4J_CUDA_FAULTS") -> Optional["FaultInjector"]:
        """Build an injector from ``nan_at=..;transient_every=..`` env
        syntax; None when the variable is unset/empty."""
        spec = env_str(var, "").strip()
        if not spec:
            return None
        kw: dict = {}
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            key = key.strip()
            if key in ("nan_at", "transient_at", "drop_send_at",
                       "etl_stall_at"):
                kw[key] = _parse_steps(val)
            elif key in ("transient_every", "crash_at", "preempt_at"):
                kw[key] = int(val)
            elif key == "etl_stall_s":
                kw[key] = float(val)
            else:
                raise ValueError(f"{var}: unknown fault key {key!r}")
        log.warning("fault injection ACTIVE from $%s: %s", var, spec)
        return cls(**kw)

    def _once(self, kind: str, step: int) -> bool:
        if (kind, step) in self._fired:
            return False
        self._fired.add((kind, step))
        return True

    # ----------------------------------------------------------- injection
    def before_step(self, step: int):
        """Called before dispatching step `step`; may raise."""
        if self.crash_at is not None and step == self.crash_at \
                and self._once("crash", step):
            log.warning("injecting simulated crash at step %d", step)
            raise SimulatedCrash(f"injected crash at step {step}")
        transient = step in self.transient_at or (
            self.transient_every and step > 0
            and step % self.transient_every == 0)
        if transient and self._once("transient", step):
            self.transients_injected += 1
            log.warning("injecting transient fault at step %d", step)
            raise TransientFaultError(f"injected transient fault at step {step}")

    def before_fetch(self, step: int):
        """Called inside the trainer's ETL window (before pulling step
        `step`'s batch): sleeps ``etl_stall_s`` on scheduled steps, once
        each — a deterministic throttled-input-pipeline analog."""
        if step in self.etl_stall_at and self.etl_stall_s > 0 \
                and self._once("etl_stall", step):
            self.stalls_injected += 1
            log.warning("injecting %.3fs ETL stall at step %d",
                        self.etl_stall_s, step)
            import time
            time.sleep(self.etl_stall_s)

    def corrupt_loss(self, step: int, loss: float) -> float:
        """Replace the loss with NaN on scheduled steps (the observable
        signature of a NaN gradient — the skip-step guard keys off it)."""
        if step in self.nan_at:
            self.nans_injected += 1
            log.warning("injecting NaN loss at step %d", step)
            return float("nan")
        return loss

    def should_preempt(self, step: int) -> bool:
        return self.preempt_at is not None and step >= self.preempt_at

    # ------------------------------------------------------------ transport
    def send_filter(self, peer: int, ordinal: int) -> bool:
        """False = drop this outbound message (ordinal counts every send
        attempt on the transport, across peers, starting at 0)."""
        if ordinal in self.drop_send_at:
            self.sends_dropped += 1
            log.warning("dropping transport message %d to peer %d",
                        ordinal, peer)
            return False
        return True


# --------------------------------------------------------------- serving
class ServingFaults:
    """Deterministic fault points for the serving fleet (serving/fleet.py,
    serving/router.py, tools/serve_chaos.py).

    Unlike the step-scheduled trainer faults above, serving faults are
    *toggles*: a replica is wedged or it is not, a probe path is
    blackholed or it is not. The process-global instance (``serving_
    faults()``) is consulted by the serving hot paths:

    - ``probe_delay_s`` / ``probe_error``: /healthz and /readyz handlers
      sleep (probe deadline blows -> supervisor sees a wedged replica)
      or return 500 (probe blackhole without paying wall-clock).
    - ``predict_delay_s`` / ``predict_error``: the predict path of THIS
      process turns into a straggler (hedging/breaker fodder) or fails
      outright with TransientFaultError (breaker fodder).

    Three ways to engage it, all reaching the same singleton:

    - tests: ``serving_faults().set(predict_delay_s=0.2)`` (and
      ``clear()`` in teardown);
    - env (subprocess replicas wedged from birth):
      ``DL4J_CUDA_SERVING_FAULTS="probe_delay_s=5;predict_delay_s=5"``;
    - HTTP (chaos tools wedging a live replica mid-traffic): ``POST
      /v1/faults`` on a ModelServer started with fault injection
      enabled (``--enable-fault-injection``; never on by default).
    """

    _FIELDS = ("probe_delay_s", "predict_delay_s", "probe_error",
               "predict_error")

    def __init__(self):
        self.clear()

    def clear(self):
        self.probe_delay_s = 0.0
        self.predict_delay_s = 0.0
        self.probe_error = False
        self.predict_error = False

    def set(self, **kw) -> "ServingFaults":
        for key, val in kw.items():
            if key not in self._FIELDS:
                raise ValueError(f"unknown serving fault {key!r} "
                                 f"(known: {self._FIELDS})")
            cur = getattr(self, key)
            if isinstance(cur, bool):
                if isinstance(val, str):
                    # env path hands us strings: "0"/"false"/"off" mean
                    # off, not bool("0") == True
                    val = val.strip().lower() not in (
                        "", "0", "false", "no", "off")
                setattr(self, key, bool(val))
            else:
                setattr(self, key, float(val))
        if self.active():
            log.warning("serving fault injection ACTIVE: %s",
                        self.describe())
        return self

    def active(self) -> bool:
        return bool(self.probe_delay_s or self.predict_delay_s
                    or self.probe_error or self.predict_error)

    def describe(self) -> dict:
        return {f: getattr(self, f) for f in self._FIELDS}

    def apply_env(self, var: str = "DL4J_CUDA_SERVING_FAULTS"
                  ) -> "ServingFaults":
        """``probe_delay_s=5;predict_error=1`` env syntax; unset/empty
        leaves the toggles untouched."""
        spec = env_str(var, "").strip()
        if not spec:
            return self
        kw = {}
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            key, sep, val = part.partition("=")
            if not sep:
                raise ValueError(f"{var}: expected key=value, got {part!r}")
            kw[key.strip()] = val.strip()
        return self.set(**kw)

    # ------------------------------------------------------ fault points
    def on_probe(self):
        """Consulted by /healthz and /readyz handlers. Sleeps or raises."""
        if self.probe_delay_s > 0:
            import time
            time.sleep(self.probe_delay_s)
        if self.probe_error:
            raise TransientFaultError("injected probe blackhole")

    def on_predict(self):
        """Consulted by the predict path before dispatch."""
        if self.predict_delay_s > 0:
            import time
            time.sleep(self.predict_delay_s)
        if self.predict_error:
            raise TransientFaultError("injected predict fault")


_SERVING_FAULTS = ServingFaults()


def serving_faults() -> ServingFaults:
    """The process-global serving fault toggles (see ServingFaults)."""
    return _SERVING_FAULTS


def attach_transport_faults(transport, injector: FaultInjector):
    """Wire the injector's message-drop schedule into a SocketTransport
    (its `broadcast` consults `send_filter` per outbound message)."""
    ordinal = {"n": 0}

    def fltr(peer: int) -> bool:
        i = ordinal["n"]
        ordinal["n"] += 1
        return injector.send_filter(peer, i)

    transport.send_filter = fltr
    return transport
