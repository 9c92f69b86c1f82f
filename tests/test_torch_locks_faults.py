"""The port's framework-neutral utilities (`util/locks.py`,
`util/faults.py`, `util/sentinel.py`) held to the JAX package's.

- `DiagnosedLock`: the same acquisition-order edges and holder table for
  the same lock choreography, re-entrancy and sibling instances of one
  static identity; `dump_diagnostics()` writes the reference's sections.
- `FaultInjector.from_env`: the same spec strings parse to the same
  schedules (the same faults at the same steps), and malformed ones fail
  the same way; `ServingFaults` toggles as the reference's.
- The port's pytest sentinel, loaded in a subprocess only (the
  reference's is armed in every tier-1 worker, and the two must never
  share a process): a deliberate deadlock exits 3 with the holder table
  naming both locks.
"""
import io
import os
import subprocess
import sys
import textwrap
import threading

import pytest

from deeplearning4j_tpu.util import faults as jfaults
from deeplearning4j_tpu.util import locks as jlocks
from deeplearning4j_tpu_torch.util import faults, locks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def recording():
    """Recording on and a clean slate in both packages; restored after
    (the reference's sentinel keeps recording on in tier-1)."""
    saved = (locks.recording_enabled(), jlocks.recording_enabled())
    for mod in (locks, jlocks):
        mod.enable_recording(True)
        mod.reset()
    yield
    for mod, on in zip((locks, jlocks), saved):
        mod.reset()
        mod.enable_recording(on)


def _choreography(mod):
    a = mod.DiagnosedLock("pkg.A._lock")
    b = mod.DiagnosedLock("pkg.B._lock", reentrant=True)
    c1 = mod.DiagnosedLock("pkg.C._lock")
    c2 = mod.DiagnosedLock("pkg.C._lock")
    with a:
        with b:
            with b:                     # re-entrant depth 2
                assert b.locked()
            with c1:
                pass
    with c1:
        with c2:                        # sibling instances: no self edge
            held = sorted(mod.holder_table())
        with a:
            pass
    assert not a.locked() and not b.locked()
    return mod.observed_edges(), held


def test_lock_edges_and_holder_table_match(recording):
    assert _choreography(locks) == _choreography(jlocks)
    edges, held = _choreography(locks)
    assert edges == {("pkg.A._lock", "pkg.B._lock"),
                     ("pkg.A._lock", "pkg.C._lock"),
                     ("pkg.B._lock", "pkg.C._lock"),
                     ("pkg.C._lock", "pkg.A._lock")}
    assert held == ["pkg.C._lock", "pkg.C._lock#2"]
    assert locks.holder_table() == {}


def test_recording_off_records_nothing():
    saved = locks.recording_enabled()
    locks.enable_recording(False)
    locks.reset()
    try:
        lk = locks.DiagnosedLock("pkg.X._lock")
        with lk:
            assert locks.holder_table() == {}
        assert locks.observed_edges() == set()
    finally:
        locks.enable_recording(saved)


def _sections(text):
    return [ln for ln in text.splitlines() if ln.startswith(("====",
                                                             "----"))]


def test_dump_diagnostics_has_the_references_sections(recording):
    outs = []
    for mod in (locks, jlocks):
        lk = mod.DiagnosedLock("pkg.D._lock")
        ready, release = threading.Event(), threading.Event()

        def hold(lk=lk):
            with lk:
                ready.set()
                release.wait(5)

        t = threading.Thread(target=hold, name="holder-thread")
        t.start()
        ready.wait(5)
        buf = io.StringIO()
        mod.dump_diagnostics(out=buf, reason="test")
        release.set()
        t.join()
        outs.append(buf.getvalue())
    mine, ref = outs
    assert _sections(mine) == _sections(ref)
    for text in outs:
        assert "pkg.D._lock  held by 'holder-thread'" in text
        assert "-- thread 'holder-thread'" in text


SPECS = ["nan_at=3,4;transient_every=5;crash_at=11",
         "transient_at=0,2; preempt_at=7 ;drop_send_at=1,3",
         "etl_stall_at=2,5;etl_stall_s=0;nan_at=",
         ""]


def _schedule(mod, var, spec, monkeypatch):
    monkeypatch.setenv(var, spec)
    inj = mod.FaultInjector.from_env()
    if inj is None:
        return None
    out = []
    for step in range(14):
        events = []
        for _ in range(2):                # a retry never re-fires
            try:
                inj.before_step(step)
                events.append("ok")
            except mod.TransientFaultError:
                events.append("transient")
            except mod.SimulatedCrash:
                events.append("crash")
        inj.before_fetch(step)
        loss = inj.corrupt_loss(step, 1.0)
        out.append((step, tuple(events), loss != loss,
                    inj.should_preempt(step), inj.send_filter(0, step)))
    return out, (inj.nans_injected, inj.transients_injected,
                 inj.sends_dropped, inj.stalls_injected)


@pytest.mark.parametrize("spec", SPECS)
def test_fault_specs_parse_to_the_same_schedules(spec, monkeypatch):
    assert _schedule(faults, "DL4J_CUDA_FAULTS", spec, monkeypatch) \
        == _schedule(jfaults, "DL4J_TPU_FAULTS", spec, monkeypatch)


@pytest.mark.parametrize("spec", ["bogus=1", "nan_at=x", "crash_at=1.5"])
def test_malformed_fault_specs_fail_as_the_reference(spec, monkeypatch):
    monkeypatch.setenv("DL4J_CUDA_FAULTS", spec)
    monkeypatch.setenv("DL4J_TPU_FAULTS", spec)
    with pytest.raises(ValueError):
        faults.FaultInjector.from_env()
    with pytest.raises(ValueError):
        jfaults.FaultInjector.from_env()


def test_serving_fault_toggles_match(monkeypatch):
    monkeypatch.setenv("DL4J_CUDA_SERVING_FAULTS",
                       "probe_delay_s=0;predict_error=1")
    monkeypatch.setenv("DL4J_TPU_SERVING_FAULTS",
                       "probe_delay_s=0;predict_error=1")
    mine = faults.ServingFaults().apply_env()
    ref = jfaults.ServingFaults().apply_env()
    assert mine.describe() == ref.describe()
    assert mine.active() and ref.active()
    with pytest.raises(faults.TransientFaultError):
        mine.on_predict()
    mine.set(predict_error="off")
    mine.on_predict()
    with pytest.raises(ValueError):
        mine.set(nope=1)
    assert faults.serving_faults() is faults.serving_faults()
    assert faults.serving_faults() is not jfaults.serving_faults()


def test_attach_transport_faults_drops_the_scheduled_sends():
    class Transport:
        send_filter = None

    inj = faults.FaultInjector(drop_send_at=(1, 3))
    t = faults.attach_transport_faults(Transport(), inj)
    assert [t.send_filter(0) for _ in range(5)] \
        == [True, False, True, False, True]
    assert inj.sends_dropped == 2


DEADLOCK_TEST = '''
import threading

from deeplearning4j_tpu_torch.util.locks import DiagnosedLock

A = DiagnosedLock("tests.deadlock.A._lock")
B = DiagnosedLock("tests.deadlock.B._lock")


def test_ab_ba_deadlock():
    both = threading.Barrier(2)

    def ab():
        with A:
            both.wait()
            with B:
                pass

    def ba():
        with B:
            both.wait()
            with A:
                pass

    ts = [threading.Thread(target=f, name=n, daemon=True)
          for f, n in ((ab, "worker-ab"), (ba, "worker-ba"))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
'''


def test_sentinel_in_a_subprocess_exits_3_with_the_holder_table(tmp_path):
    (tmp_path / "test_deadlock.py").write_text(textwrap.dedent(
        DEADLOCK_TEST))
    env = dict(os.environ, PYTHONPATH=REPO,
               DL4J_CUDA_SENTINEL_TIMEOUT="2")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-s", "-p",
         "no:cacheprovider", "--noconftest", "-p",
         "deeplearning4j_tpu_torch.util.sentinel",
         str(tmp_path / "test_deadlock.py")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 3, r.stdout + r.stderr
    err = r.stderr
    assert "deadlock sentinel" in err and "test_ab_ba_deadlock" in err
    assert "tests.deadlock.A._lock  held by 'worker-ab'" in err
    assert "tests.deadlock.B._lock  held by 'worker-ba'" in err
    assert "-- thread 'worker-ab'" in err
    # the reference's plugin was never loaded in that process
    assert "deeplearning4j_tpu.util.sentinel" not in r.stdout


def test_sentinel_kill_switch_leaves_the_run_alone(tmp_path):
    (tmp_path / "test_ok.py").write_text("def test_ok():\n    pass\n")
    env = dict(os.environ, PYTHONPATH=REPO,
               DL4J_CUDA_DEADLOCK_SENTINEL="0")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "--noconftest", "-p", "deeplearning4j_tpu_torch.util.sentinel",
         str(tmp_path / "test_ok.py")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
