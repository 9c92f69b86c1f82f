"""The port's static analyzer (`deeplearning4j_tpu_torch/analysis`) and
its runner held to the reference's: every case of tests/test_lint.py
runs against them.

- Under the ``jax`` profile, every case of the reference's file, over the
  same fixtures in tests/fixtures/graftlint/ and the same live tree
  (`deeplearning4j_tpu/`, `tools/`, `bench.py`); the CLI cases run
  ``python -m deeplearning4j_tpu_torch.tools.graftlint --profile jax``.
- Under the ``torch`` profile (the default), the framework and CLI cases
  with the port's ``DL4J_CUDA_`` knob names.
- Per fixture, the port's findings (rule, line, column, message) equal
  the reference's, not only their lines.
"""
import os

import pytest

from _torch_reference_cases import case_names, port_cases, run_case
from deeplearning4j_tpu import analysis as ref_analysis
from deeplearning4j_tpu.analysis import core as ref_core
from deeplearning4j_tpu.analysis.rules.telemetry import (
    MetricFamilyRegistrationRule as RefMetricRule,
)
from deeplearning4j_tpu_torch import analysis
from deeplearning4j_tpu_torch.analysis import core
from deeplearning4j_tpu_torch.analysis.rules.telemetry import (
    MetricFamilyRegistrationRule,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "graftlint")

_CLI = 'os.path.join(REPO, "tools", "graftlint.py"),'
_RUNNER = '"-m", "deeplearning4j_tpu_torch.tools.graftlint",'

JAX = port_cases("tests/test_lint.py", module_name="port_of_test_lint_jax",
                 extra_subs=(
    ("DL4J_CUDA_", "DL4J_TPU_"),
    ("lint_core.load_module(os.path.join(FIXTURES, fixture))",
     'lint_core.load_module(os.path.join(FIXTURES, fixture), profile="jax")'),
    ("analysis.run([p])", 'analysis.run([p], profile="jax")'),
    ('os.path.join(REPO, "bench.py")])',
     'os.path.join(REPO, "bench.py")], profile="jax")'),
    (_CLI, _RUNNER + ' "--profile", "jax",')))

_FRAMEWORK = (
    "test_pragma_suppresses_with_justification",
    "test_pragma_without_justification_is_a_finding",
    "test_stale_and_unknown_pragmas_are_findings",
    "test_cli_exit_2_and_json_on_findings",
    "test_unparseable_file_is_a_finding_not_clean",
    "test_cli_refuses_empty_path_glob", "test_cli_exit_0_on_clean",
    "test_cli_baseline_burn_down_workflow",
    "test_cli_list_rules_names_all_thirteen")
TORCH = port_cases("tests/test_lint.py", module_name="port_of_test_lint_torch",
                   extra_subs=((_CLI, _RUNNER),))


@pytest.mark.parametrize("name", [n for n in case_names(JAX)
                                  if n != "test_fixture_golden"])
def test_reference_case_under_jax_profile(name, request):
    run_case(JAX, name, request)


@pytest.mark.parametrize("name", _FRAMEWORK)
def test_reference_case_under_torch_profile(name, request):
    run_case(TORCH, name, request)


def _key(f):
    return (f.rule, os.path.relpath(f.path, REPO), f.line, f.col, f.message)


def _findings(ana, lcore, rule, path, profile=None):
    kw = {} if profile is None else {"profile": profile}
    mod = lcore.load_module(path, **kw)
    assert mod is not None
    if isinstance(rule, ana.ProjectRule):
        out = rule.check_project(lcore.Project([mod]))
    else:
        out = rule.check(mod)
    return sorted(map(_key, out))


@pytest.mark.parametrize("rule_name,fixture", JAX.FIXTURE_MATRIX,
                         ids=[f"{r}:{os.path.basename(f)}"
                              for r, f in JAX.FIXTURE_MATRIX])
def test_fixture_findings_equal_the_references(rule_name, fixture):
    """The reference's fixture golden, then the findings themselves."""
    JAX.test_fixture_golden(rule_name, fixture)
    path = os.path.join(FIXTURES, fixture)
    ref_rule = {r.name: r for r in ref_analysis.ALL_RULES}[rule_name]
    rule = {r.name: r for r in analysis.ALL_RULES}[rule_name]
    want = _findings(ref_analysis, ref_core, ref_rule, path)
    got = _findings(analysis, core, rule, path, profile="jax")
    assert got == want


@pytest.mark.parametrize("fixture", ["metric_family_pos.py",
                                     "metric_family_neg.py"])
def test_metric_family_findings_equal_the_references(fixture):
    catalog = os.path.join(FIXTURES, "fixture_catalog.md")
    path = os.path.join(FIXTURES, fixture)
    want = _findings(ref_analysis, ref_core,
                     RefMetricRule(catalog_path=catalog), path)
    got = _findings(analysis, core,
                    MetricFamilyRegistrationRule(catalog_path=catalog), path,
                    profile="jax")
    assert got == want


def test_metric_family_extraction_equals_the_references():
    trees = [os.path.join(REPO, "deeplearning4j_tpu")]
    assert analysis.extract_metric_families(trees) == \
        ref_analysis.extract_metric_families(trees)
    # the port emits the reference's families under the same names
    port = analysis.extract_metric_families(
        [os.path.join(REPO, "deeplearning4j_tpu_torch")])
    for expected in ("train_iterations_total", "etl_fetch_wait_seconds",
                     "serving_requests_total",
                     "serving_fleet_restarts_total"):
        assert expected in port, expected
