"""Standing guards of the PyTorch/CUDA port.

- No file of `deeplearning4j_tpu_torch/`, nor `chip_smoke.py` or
  `tests/test_torch_cuda.py`, imports jax, jaxlib, flax, optax, msgpack or
  the JAX package (AST scan), and importing the serving and training
  CLIs leaves them out of `sys.modules`.
- The package calls no library attention or compiler in place of its own
  kernels: no `scaled_dot_product_attention`, no `torch.compile`.
- Entry points default to CUDA and raise without it; they never fall
  back to the CPU.
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
BANNED_ROOTS = {"jax", "jaxlib", "flax", "optax", "msgpack",
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


def test_no_library_attention_or_compile_in_the_package():
    hits = []
    for path in sorted(PKG.rglob("*")):
        if path.suffix in (".py", ".cu", ".cuh", ".h", ".cpp"):
            text = path.read_text()
            hits += [(str(path.relative_to(REPO)), t) for t in BANNED_TEXT
                     if t in text]
    assert hits == []


def test_importing_the_port_pulls_in_no_jax():
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.serving.cli\n"
            "import deeplearning4j_tpu_torch.serving.server\n"
            "import deeplearning4j_tpu_torch.util.serialization\n"
            "import deeplearning4j_tpu_torch.models.transformer\n"
            "import deeplearning4j_tpu_torch.ops.flash_attention\n"
            "import deeplearning4j_tpu_torch.train.cli\n"
            "import deeplearning4j_tpu_torch.nn.multilayer\n"
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
    from deeplearning4j_tpu_torch.serving.registry import load_servable
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
