"""`deeplearning4j_tpu_torch.tools.stack_sample`: a program run under the
sampler keeps its arguments and exit code, its slow function shows in
the samples and the report, a stdout mark is timed, and a server that
never returns is ended after --stop-after with its samples written."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from deeplearning4j_tpu_torch.tools import stack_sample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env_path=()):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((REPO,) + env_path))
    return subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.tools.stack_sample",
         *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120)


def test_script_exit_code_arguments_samples_and_mark(tmp_path):
    (tmp_path / "prog.py").write_text(textwrap.dedent("""
        import sys, time
        def slow_part():
            time.sleep(0.8)
        if __name__ == "__main__":
            print("READY", sys.argv[1:], flush=True)
            slow_part()
            sys.exit(3)
    """))
    out = tmp_path / "s.json"
    r = _run(["--out", str(out), "--interval", "0.02", "--mark", "READY",
              "prog.py", "a", "--flag", "-m"], tmp_path)
    assert r.returncode == 3, r.stderr
    assert "READY ['a', '--flag', '-m']" in r.stdout
    doc = json.loads(out.read_text())
    assert doc["interval"] == 0.02 and 0 <= doc["marks"]["mark"] < 0.8
    slow = [c for _, c in doc["samples"] if c and "slow_part" in c[-1]]
    assert len(slow) >= 10
    assert slow[0][0].endswith("prog.py:<module>:7")
    rep = _run(["--report", str(out)], tmp_path)
    assert rep.returncode == 0
    assert "prog.py:slow_part" in rep.stdout.split(
        "seconds by innermost frame:")[1]


def test_module_stopped_after_its_time(tmp_path):
    (tmp_path / "forever.py").write_text(textwrap.dedent("""
        import time
        def serve():
            print("serving", flush=True)
            while True:
                time.sleep(0.01)
        serve()
    """))
    out = tmp_path / "s.json"
    r = _run(["--out", str(out), "--interval", "0.02", "--match",
              "forever", "--mark", "serving", "--stop-after", "0.5", "-m",
              "forever"], tmp_path, (str(tmp_path),))
    assert r.returncode == 0, r.stderr
    doc = json.loads(out.read_text())
    assert "mark" in doc["marks"]
    assert any(c and "forever.py:serve" in c[-1] for _, c in doc["samples"])


@pytest.mark.parametrize("argv, want", [
    (["--out", "x", "p.py", "--out", "y"], (["--out", "x"], None,
                                            ["p.py", "--out", "y"])),
    (["--interval", "0.1", "-m", "a.b", "--model", "m"],
     (["--interval", "0.1"], "a.b", ["--model", "m"])),
    (["--report", "s.json"], (["--report", "s.json"], None, [])),
])
def test_split_own_arguments_from_the_program(argv, want):
    assert stack_sample._split(argv) == want
