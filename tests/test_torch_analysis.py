"""The port's static analyzer: the tier-1 gate over the port's tree, the
``jax`` profile held to the reference's analyzer over the reference's
tree, and the ``torch`` profile's own fixtures.

- `test_port_tree_is_clean` IS the port's gate, as tests/test_lint.py's
  `test_live_tree_is_clean` is the reference's: the full registry under
  the torch profile over `deeplearning4j_tpu_torch/` finds nothing
  unsuppressed. Fix a finding, or suppress it with a justified
  ``# graftlint: disable=<rule> -- <why>`` pragma.
- Under the jax profile, the port's `run()` over `deeplearning4j_tpu/`,
  `tools/` and `bench.py` gives the reference's result: the same files,
  the same suppressed findings (rule, path, line, column, message), the
  same lock graph; the two runners print the same JSON.
- tests/fixtures/torch_graftlint/: a `*_pos.py` with ``# EXPECT`` on
  every line the rule must flag and a `*_neg.py` of near-misses, per
  rule that knows the framework's names.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from deeplearning4j_tpu import analysis as ref_analysis
from deeplearning4j_tpu_torch import analysis
from deeplearning4j_tpu_torch.analysis import core

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "deeplearning4j_tpu_torch")
REF_PATHS = [os.path.join(REPO, p)
             for p in ("deeplearning4j_tpu", "tools", "bench.py")]
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_graftlint")
RULES = {r.name: r for r in analysis.ALL_RULES}


def _key(f):
    return (f.rule, os.path.relpath(f.path, REPO), f.line, f.col, f.message)


# --------------------------------------------------------- the tier-1 gate
def test_port_tree_is_clean():
    """Zero unsuppressed findings over the port's tree, under the torch
    profile, with the FULL registry (a select= or trimmed registry would
    silently narrow the invariant)."""
    for required in ("lock-order-inversion",
                     "transitive-blocking-under-lock",
                     "thread-lifecycle", "resource-pairing",
                     "host-sync-in-hot-path", "recompile-hazard",
                     "env-knob-contract", "unlaundered-restore-placement"):
        assert RULES[required].applies("torch"), required
    res = analysis.run([PORT])
    rendered = "\n".join(f.render(REPO) for f in res.all_unsuppressed)
    assert not res.all_unsuppressed, f"graftlint findings:\n{rendered}"
    assert res.files > 100
    assert len(res.suppressed) >= 1
    # the user scripts are in the gated tree: every example and tool
    scanned = {os.path.relpath(p, PORT)
               for p in analysis.iter_py_files([PORT])}
    for sub in ("examples", "tools"):
        want = {os.path.join(sub, f) for f in os.listdir(
            os.path.join(PORT, sub)) if f.endswith(".py")}
        assert len(want) >= 12 and want <= scanned, sub


# ------------------------------------------- the jax profile = the reference
@pytest.fixture(scope="module")
def reference_run():
    return ref_analysis.run(REF_PATHS)


@pytest.fixture(scope="module")
def jax_profile_run():
    return analysis.run(REF_PATHS, profile="jax")


def test_jax_profile_reproduces_the_reference_tree(reference_run,
                                                   jax_profile_run):
    ref, port = reference_run, jax_profile_run
    assert port.files == ref.files == 173
    assert port.all_unsuppressed == [] and ref.all_unsuppressed == []
    assert len(ref.suppressed) == 30
    assert sorted(map(_key, port.suppressed)) == \
        sorted(map(_key, ref.suppressed))


def test_jax_profile_lock_graph_equals_the_references(reference_run,
                                                      jax_profile_run):
    want = reference_run.project.concurrency().lock_graph_doc()
    got = jax_profile_run.project.concurrency().lock_graph_doc()
    assert got == want
    assert len(got["locks"]) >= 20 and got["cycles"] == []


def _json(cmd):
    r = subprocess.run([sys.executable, *cmd], capture_output=True,
                       text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(r.stdout)
    for k in ("version", "elapsed_seconds"):
        doc.pop(k)
    return doc


def test_cli_jax_profile_json_equals_the_reference_cli():
    want = _json([os.path.join("tools", "graftlint.py"), "--json",
                  "--jobs", "2"])
    got = _json(["-m", "deeplearning4j_tpu_torch.tools.graftlint",
                 "--profile", "jax", "--json", "--jobs", "2",
                 "deeplearning4j_tpu", "tools", "bench.py"])
    assert got == want
    assert (got["files"], got["findings"], got["suppressed"]) == \
        (173, [], 30)


# ------------------------------------------------ the torch profile's rules
TORCH_MATRIX = [
    ("host-sync-in-hot-path", "host_sync_pos.py"),
    ("host-sync-in-hot-path", "host_sync_neg.py"),
    ("recompile-hazard", "recompile_hazard_pos.py"),
    ("recompile-hazard", "recompile_hazard_neg.py"),
    ("env-knob-contract", "env_knob_pos.py"),
    ("env-knob-contract", "env_knob_neg.py"),
    ("unlaundered-restore-placement", "restore_placement_pos.py"),
    ("unlaundered-restore-placement", "restore_placement_neg.py"),
    ("telemetry-zero-cost", "telemetry_zero_cost_pos.py"),
    ("telemetry-zero-cost", "telemetry_zero_cost_neg.py"),
]


def _expect_lines(path):
    with open(path, encoding="utf-8") as fh:
        return sorted(i for i, line in enumerate(fh.read().splitlines(), 1)
                      if "# EXPECT" in line)


@pytest.mark.parametrize("rule_name,fixture", TORCH_MATRIX,
                         ids=[f"{r}:{f}" for r, f in TORCH_MATRIX])
def test_torch_profile_fixture_golden(rule_name, fixture):
    path = os.path.join(FIXTURES, fixture)
    mod = core.load_module(path)
    assert mod is not None and mod.profile == "torch"
    assert sorted(f.line for f in RULES[rule_name].check(mod)) == \
        _expect_lines(path)


def test_torch_profile_messages_name_the_capture():
    mod = core.load_module(os.path.join(FIXTURES, "host_sync_pos.py"))
    msgs = {f.line: f.message
            for f in RULES["host-sync-in-hot-path"].check(mod)}
    assert all("fails the CUDA graph capture" in m for m in msgs.values())
    reasons = " ".join(msgs.values())
    for why in ("body of torch.cuda.graph()", "function passed to capture()",
                "lambda passed to warm_up()", "function passed to _run_step()"):
        assert why in reasons, why


def test_torch_profile_does_not_read_jax_names():
    """The reference's jit/lax and DL4J_TPU_ positives are another
    framework's: under the torch profile the region and knob rules
    leave them alone (the fit-loop check is the same under both)."""
    fixtures = os.path.join(REPO, "tests", "fixtures", "graftlint")
    for rule, fixture in (("recompile-hazard", "recompile_hazard_pos.py"),
                          ("env-knob-contract", "env_knob_pos.py"),
                          ("telemetry-zero-cost",
                           "telemetry_zero_cost_pos.py")):
        torch_mod = core.load_module(os.path.join(fixtures, fixture))
        jax_mod = core.load_module(os.path.join(fixtures, fixture),
                                   profile="jax")
        assert list(RULES[rule].check(jax_mod)), fixture
        assert [f for f in RULES[rule].check(torch_mod)
                if "span attr" not in f.message] == [], fixture


def test_donation_has_no_torch_counterpart_and_says_so(tmp_path):
    """donated-aliasing does not run under torch, and says why: the
    runner's --list-rules marks it, and a pragma naming it suppresses
    nothing (a stale suppression is a finding)."""
    rule = RULES["donated-aliasing"]
    assert not rule.applies("torch") and rule.applies("jax")
    assert [r.name for r in analysis.ALL_RULES if not r.applies("torch")] \
        == ["donated-aliasing"]
    r = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.tools.graftlint",
         "--list-rules"], capture_output=True, text=True, cwd=REPO,
        timeout=120)
    assert r.returncode == 0
    assert "not applicable under the torch profile: PyTorch has no " \
        "buffer donation" in r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.tools.graftlint",
         "--list-rules", "--profile", "jax"], capture_output=True,
        text=True, cwd=REPO, timeout=120)
    assert "not applicable" not in r.stdout
    pos = os.path.join(REPO, "tests", "fixtures", "graftlint",
                       "donated_aliasing_pos.py")
    assert [f for f in analysis.run([pos]).findings
            if f.rule == "donated-aliasing"] == []
    assert analysis.run([pos], profile="jax").findings
    p = tmp_path / "m.py"
    p.write_text(textwrap.dedent("""\
        x = 1  # graftlint: disable=donated-aliasing -- nothing to donate
        """))
    res = analysis.run([str(p)])
    assert any("suppresses nothing" in f.message
               for f in res.pragma_findings)


def test_unknown_profile_is_refused(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("x = 1\n")
    with pytest.raises(ValueError, match="profile"):
        analysis.run([str(p)], profile="tpu")
    r = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.tools.graftlint",
         "--profile", "tpu", str(p)], capture_output=True, text=True,
        cwd=REPO, timeout=120)
    assert r.returncode != 0 and "invalid choice" in r.stderr


def test_analyzer_imports_no_framework():
    """The analyzer and its runner are stdlib only: importing them (and
    the port's package root) leaves torch, jax and the JAX package out of
    sys.modules, so the gate and the CLI start without torch."""
    code = textwrap.dedent("""\
        import sys
        import deeplearning4j_tpu_torch.analysis
        import deeplearning4j_tpu_torch.tools.graftlint
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("torch", "jax", "jaxlib",
                                            "deeplearning4j_tpu"))
        print(bad)
        """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
