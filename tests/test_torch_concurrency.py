"""The port's interprocedural concurrency analysis (`analysis/callgraph.py`,
`analysis/concurrency.py`, the lock-order rule), its runtime witness
(`util/locks.DiagnosedLock`) and sentinel knobs: every case of
tests/test_concurrency.py run against the port.

The live-tree cases read the port's own tree: its lock graph names the
same serving locks under ``deeplearning4j_tpu_torch.…`` and has no cycle,
and the runtime witness drives the port's registry on the CPU. The
deliberate-deadlock case is slow-marked in the reference and left out
here; tests/test_torch_locks_faults.py drives the port's sentinel in a
subprocess. The reference's lock graph through the port's analyzer is
held equal to the reference's in tests/test_torch_analysis.py.
"""
import pytest

from _torch_reference_cases import case_names, port_cases, run_case

REF = port_cases("tests/test_concurrency.py", extra_subs=(
    ('os.path.join(REPO, "deeplearning4j_tpu")',
     'os.path.join(REPO, "deeplearning4j_tpu_torch")'),
    ("MultiLayerNetwork(conf).init()",
     'MultiLayerNetwork(conf, device="cpu").init()'),
    ("reg = ModelRegistry()", 'reg = ModelRegistry(device="cpu")'),
    ('os.path.join(REPO, "tools", "graftlint.py"),',
     '"-m", "deeplearning4j_tpu_torch.tools.graftlint",'),
    # the knob helper is framework-neutral: the reference's sets the
    # port's DL4J_CUDA_ names as well
    ("from deeplearning4j_tpu_torch.util.env import scoped",
     "from deeplearning4j_tpu.util.env import scoped")))


@pytest.fixture
def recording():
    yield from REF.recording.__wrapped__()


@pytest.mark.parametrize("name", case_names(REF))
def test_reference_case(name, request):
    run_case(REF, name, request)
