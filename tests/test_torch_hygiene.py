"""Standing guards of the PyTorch/CUDA port.

- No file of `deeplearning4j_tpu_torch/`, nor `chip_smoke.py` or
  `tests/test_torch_cuda.py`, imports jax, jaxlib, flax, optax, msgpack,
  ml_dtypes (the card machine has none: bf16 KV frames travel as raw
  int16 words) or the JAX package (AST scan), and importing the serving
  and training CLIs leaves them out of `sys.modules`.
- The package calls no library attention or compiler in place of its own
  kernels: no `scaled_dot_product_attention`, no `torch.compile`.
- Entry points default to CUDA and raise without it; they never fall
  back to the CPU (the predict and training paths, the decode path:
  `--lm`, `deploy_lm`, and the swap path: `POST /swap`, a redeploy of a
  live name, `ParallelInference` on a named device).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "deeplearning4j_tpu_torch"
BANNED_ROOTS = {"jax", "jaxlib", "flax", "optax", "msgpack", "ml_dtypes",
                "deeplearning4j_tpu"}
BANNED_TEXT = ("scaled_dot_product_attention", "torch.compile")


def _port_sources():
    # the card-only tests run where JAX is not installed
    extra = [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py"]
    files = sorted(PKG.rglob("*.py")) + extra
    assert len(files) > 20 and all(f.exists() for f in extra)
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_nothing_of_jax():
    bad = {str(p.relative_to(REPO)): sorted(set(_imported_roots(p))
                                            & BANNED_ROOTS)
           for p in _port_sources()}
    assert {k: v for k, v in bad.items() if v} == {}


def test_the_scan_covers_the_examples_and_the_tools():
    """The user scripts (`examples/`, `tools/`) are port files like any
    other: each of them is in the banned-import scan."""
    for sub in ("examples", "tools"):
        files = sorted((PKG / sub).glob("*.py"))
        assert len(files) >= 13, sub
        assert set(files) <= set(_port_sources())


def test_no_library_attention_or_compile_in_the_package():
    hits = []
    for path in sorted(PKG.rglob("*")):
        if path.suffix in (".py", ".cu", ".cuh", ".h", ".cpp"):
            text = path.read_text()
            hits += [(str(path.relative_to(REPO)), t) for t in BANNED_TEXT
                     if t in text]
    assert hits == []


def test_no_library_rnn_in_the_package():
    """The recurrent layers are the reference's step math in PyTorch ops
    (masked steps zero the state, peepholes, any gate activation); cuDNN's
    fused RNNs are not called."""
    banned = ("nn.LSTM", "nn.GRU", "nn.RNN", "_VF.lstm", "_VF.gru",
              "torch.lstm", "torch.gru", "_cudnn_rnn")
    hits = [(str(p.relative_to(REPO)), t) for p in sorted(PKG.rglob("*.py"))
            for t in banned if t in p.read_text()]
    assert hits == []


def test_importing_the_port_pulls_in_no_jax():
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.serving.cli\n"
            "import deeplearning4j_tpu_torch.serving.server\n"
            "import deeplearning4j_tpu_torch.serving.decode\n"
            "import deeplearning4j_tpu_torch.serving.kvcache\n"
            "import deeplearning4j_tpu_torch.serving.kvfabric\n"
            "import deeplearning4j_tpu_torch.parallel.inference\n"
            "import deeplearning4j_tpu_torch.parallel.wrapper\n"
            "import deeplearning4j_tpu_torch.parallel.shared\n"
            "import deeplearning4j_tpu_torch.parallel.transport\n"
            "import deeplearning4j_tpu_torch.parallel.zero\n"
            "import deeplearning4j_tpu_torch.train.resilience\n"
            "import deeplearning4j_tpu_torch.serving.quantize\n"
            "import deeplearning4j_tpu_torch.util.serialization\n"
            "import deeplearning4j_tpu_torch.models.transformer\n"
            "import deeplearning4j_tpu_torch.ops.flash_attention\n"
            "import deeplearning4j_tpu_torch.train.cli\n"
            "import deeplearning4j_tpu_torch.nn.multilayer\n"
            "import deeplearning4j_tpu_torch.nn.graph\n"
            "import deeplearning4j_tpu_torch.nn.regularization\n"
            "import deeplearning4j_tpu_torch.models.zoo\n"
            "import deeplearning4j_tpu_torch.nn.transferlearning\n"
            "import deeplearning4j_tpu_torch.gradientcheck\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(BANNED_ROOTS)!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import cli
    from deeplearning4j_tpu_torch.serving.registry import (
        ModelRegistry, load_servable,
    )
    from deeplearning4j_tpu_torch.util.platform import (
        is_hopper, resolve_device,
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = model_by_name("TransformerLM", n_layers=1, n_embd=32,
                         n_heads=4).conf()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiLayerNetwork(conf)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_servable("zoo:TransformerLM?n_layers=1&n_embd=32")
    args = cli.build_parser().parse_args(["--model", "m=zoo:TransformerLM"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.build(args)
    args = cli.build_parser().parse_args(["--lm", "g=zoo:TransformerLM"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.build(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRegistry().deploy_lm("g", "zoo:TransformerLM?n_layers=1")
    assert resolve_device("cpu") == torch.device("cpu")
    assert not is_hopper()
    assert MultiLayerNetwork(conf, device="cpu").device.type == "cpu"


def test_train_cli_defaults_to_cuda_and_never_falls_back(monkeypatch,
                                                         tmp_path):
    """Without CUDA, the train CLI with no --device raises before it
    trains anything or writes an output."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.train import cli
    from deeplearning4j_tpu_torch.util.serialization import save_model
    lm = model_by_name("TransformerLM", vocab_size=16, seq_length=8,
                       n_layers=1, n_embd=16, n_heads=2).init(device="cpu")
    src = save_model(lm, str(tmp_path / "lm.zip"))
    data = str(tmp_path / "t.npz")
    np.savez(data, features=np.zeros((4, 8, 1), "float32"),
             labels=np.zeros((4, 8, 16), "float32"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--model", src, "--dataset", data, "--output",
            str(tmp_path / "o.zip")]
    assert cli.build_parser().parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
    assert not (tmp_path / "o.zip").exists()


def test_swap_entry_points_never_fall_back_to_the_cpu(monkeypatch):
    """A servable deployed with the default device swaps onto CUDA: with
    no card, `POST /swap` and a redeploy of the live name raise (the live
    version keeps serving) — neither loads the replacement onto the CPU.
    ParallelInference on a named CUDA device raises too."""
    import json
    import urllib.error
    import urllib.request

    import numpy as np
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.serving.registry import (
        ModelRegistry, ServedModel,
    )
    from deeplearning4j_tpu_torch.serving.server import ModelServer
    src = "zoo:TransformerLM?vocab_size=16&seq_length=8&n_layers=1" \
          "&n_embd=16&n_heads=2"
    net = model_by_name("TransformerLM", vocab_size=16, seq_length=8,
                        n_layers=1, n_embd=16, n_heads=2).init(device="cpu")
    served = ServedModel("m", net, "live", buckets=(1,))   # device None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    registry = ModelRegistry()
    registry._models["m"] = served
    server = ModelServer(registry, port=0)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            registry.deploy("m", src, buckets=(1,))
        req = urllib.request.Request(
            f"{server.url}/v1/models/m/swap",
            data=json.dumps({"source": src}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 500
        assert "CUDA is not available" in e.value.read().decode()
        assert served.describe()["active_version"] == 1
        assert served.model is net
        served.predict(np.zeros((1, 8, 1), "float32"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ParallelInference(net, mesh="cuda")
    finally:
        server.stop()
        served.shutdown(drain=False)


NEUTRAL_DATA = ("shards", "pipeline", "records", "utility_iterators")


@pytest.mark.parametrize("module", NEUTRAL_DATA)
def test_data_plane_modules_import_no_torch_at_module_level(module):
    """Spawned ETL workers import these modules: no torch (and no CUDA)
    at module level, by the AST and in a fresh interpreter, where the
    package `__init__` files must not pull it in either."""
    tree = ast.parse((PKG / "data" / f"{module}.py").read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    roots = set()
    for node in top:
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif node.module:
            roots.add(node.module.split(".")[0])
            if node.module.startswith("deeplearning4j_tpu_torch"):
                roots |= {f"{node.module}.{a.name}" for a in node.names}
    assert "torch" not in roots and "PIL" not in roots
    code = ("import sys\n"
            f"import deeplearning4j_tpu_torch.data.{module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'PIL', 'jax'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# the names of ported modules that the port does not define yet, each
# with the item that brings it
KNOWN_GAPS = {
    "data": {"host_cast"},      # prefetch ships source dtypes (ROADMAP)
    "train": set(),
}


def _reference_exports(package: str):
    """(name, reference module) of each name the reference's __init__
    imports from its own package."""
    init = REPO / "deeplearning4j_tpu" / package / "__init__.py"
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith("deeplearning4j_tpu."):
            for alias in node.names:
                yield alias.name, node.module


@pytest.mark.parametrize("package", ["", "data", "serving", "train",
                                     "models", "parallel"])
def test_package_exports_are_the_references_minus_unported(package):
    """Each port `__init__` exports the reference's names whose modules
    are ported (lazily, PEP 562), and no name of a module that is not."""
    import importlib
    port_name = "deeplearning4j_tpu_torch" + (f".{package}" if package else "")
    pkg = importlib.import_module(port_name)
    want, absent = set(), set()
    for name, module in _reference_exports(package):
        rel = module[len("deeplearning4j_tpu."):].replace(".", "/")
        if (PKG / f"{rel}.py").exists() \
                and name not in KNOWN_GAPS.get(package, ()):
            want.add(name)
        else:
            absent.add(name)
    exported = set(pkg.__all__) - {"__version__"}
    assert exported == want
    for name in sorted(want):
        value = getattr(pkg, name)
        if hasattr(value, "__module__"):        # classes and functions
            assert value.__module__.startswith("deeplearning4j_tpu_torch")
        assert name in dir(pkg)
    for name in sorted(absent):
        assert not hasattr(pkg, name), name


# the sequence-and-stage half of `parallel/` landed with ring, context
# and pipeline parallelism: no name of the reference's is left out
PARALLEL_LATER_SLICE = set()


def test_parallel_exports_the_references_all_but_the_later_slice():
    """`parallel.__all__` is the reference's whole `__all__`, in its
    order (ring, context and pipeline parallelism included); importing
    the package imports none of its modules (the names resolve
    lazily)."""
    from deeplearning4j_tpu import parallel as jparallel
    from deeplearning4j_tpu_torch import parallel
    assert parallel.__all__ == [n for n in jparallel.__all__
                                if n not in PARALLEL_LATER_SLICE]
    assert parallel.__all__ == list(jparallel.__all__)
    for name in parallel.__all__:
        assert getattr(parallel, name).__module__.startswith(
            "deeplearning4j_tpu_torch.parallel.")
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.parallel\n"
            "mods = sorted(m for m in sys.modules if m.startswith("
            "'deeplearning4j_tpu_torch.parallel.'))\n"
            "assert mods == [], mods\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_importing_the_package_imports_no_layer():
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch as p\n"
            "mods = sorted(m for m in sys.modules "
            "if m.startswith('deeplearning4j_tpu_torch.'))\n"
            "assert mods == ['deeplearning4j_tpu_torch.util', "
            "'deeplearning4j_tpu_torch.util.lazy'], mods\n"
            "assert 'torch' not in sys.modules\n"
            "from deeplearning4j_tpu_torch import MultiLayerNetwork\n"
            "assert MultiLayerNetwork.__module__ == "
            "'deeplearning4j_tpu_torch.nn.multilayer'\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_monitor_exports_the_references_names():
    from deeplearning4j_tpu import monitor as jmonitor
    from deeplearning4j_tpu_torch import monitor
    assert monitor.__all__ == jmonitor.__all__
    for name in monitor.__all__:
        assert hasattr(monitor, name), name


def test_monitor_locks_and_faults_import_no_torch():
    """Spawned ETL workers reach these modules through data/pipeline.py:
    importing them (and the pipeline) must leave torch out."""
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.monitor\n"
            "import deeplearning4j_tpu_torch.monitor.xla\n"
            "import deeplearning4j_tpu_torch.monitor.goodput\n"
            "import deeplearning4j_tpu_torch.util.locks\n"
            "import deeplearning4j_tpu_torch.util.faults\n"
            "import deeplearning4j_tpu_torch.data.pipeline\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'deeplearning4j_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_port_file_names_the_references_native_sources():
    """The port builds its own copy of the native library
    (`native/src/`): no file of the package, the smoke run or the card
    tests points at the JAX package's sources, by path or by parts."""
    needles = ("deeplearning4j_tpu/native/src",
               "deeplearning4j_tpu\\native\\src",
               "\"deeplearning4j_tpu\", \"native\", \"src\"",
               "'deeplearning4j_tpu', 'native', 'src'")
    hits = []
    for path in sorted(PKG.rglob("*")) + _port_sources()[-2:]:
        if path.suffix in (".py", ".cpp", ".cu", ".cuh", ".h", ".md"):
            text = path.read_text()
            hits += [(str(path.relative_to(REPO)), n) for n in needles
                     if n in text]
    assert hits == []
    assert sorted(p.name for p in (PKG / "native" / "src").glob("*.cpp")) \
        == sorted(p.name for p in (REPO / "deeplearning4j_tpu" / "native"
                                   / "src").glob("*.cpp"))


@pytest.mark.parametrize("package", ["text", "embeddings", "graph"])
def test_nlp_packages_export_the_references_names(package):
    """`text`, `embeddings` and `graph` export the reference's `__all__`
    lazily, each name defined in the port."""
    import importlib
    ref = importlib.import_module(f"deeplearning4j_tpu.{package}")
    pkg = importlib.import_module(f"deeplearning4j_tpu_torch.{package}")
    assert sorted(pkg.__all__) == sorted(ref.__all__)
    for name in pkg.__all__:
        value = getattr(pkg, name)
        if hasattr(value, "__module__"):        # classes and functions
            assert value.__module__.startswith(
                f"deeplearning4j_tpu_torch.{package}."), name


def test_nlp_slice_imports_no_jax_and_text_no_torch():
    """The native library, the text pipeline and the embedding trainers
    import neither jax nor the JAX package; the native loader and the
    text pipeline (host string processing) import no torch either."""
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.native.ndarray\n"
            "import deeplearning4j_tpu_torch.text.vectorizers\n"
            "import deeplearning4j_tpu_torch.text.native_tokenizer\n"
            "import deeplearning4j_tpu_torch.text.cjk\n"
            "assert 'torch' not in sys.modules\n"
            "import deeplearning4j_tpu_torch.embeddings.distributed\n"
            "import deeplearning4j_tpu_torch.embeddings.glove\n"
            "import deeplearning4j_tpu_torch.embeddings.paragraphvectors\n"
            "import deeplearning4j_tpu_torch.graph.deepwalk\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(BANNED_ROOTS)!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
