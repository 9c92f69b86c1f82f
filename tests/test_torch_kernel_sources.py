"""The port's CUDA sources as files: what can be checked without nvcc.

- Both flash-attention sources take the Hopper helpers from the one
  shared header, `ops/csrc/sm90_common.cuh`.
- The forward runs no bf16 product on mma.sync (every one is a wgmma).
- A library's build key covers the headers beside its source, so an edit
  of the shared header rebuilds both libraries.
"""
import shutil

import pytest

from deeplearning4j_tpu_torch.ops import _build

HEADER = "sm90_common.cuh"


def _source(name):
    return (_build.CSRC / name).read_text()


@pytest.mark.parametrize("source", _build.KERNEL_SOURCES)
def test_each_source_includes_the_shared_header(source):
    assert f'#include "{HEADER}"' in _source(f"{source}.cu")


def test_forward_has_no_mma_sync():
    text = _source("flash_attention_fwd.cu")
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert "mma.sync" not in code


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.KERNEL_SOURCES}
    assert before == {n: _build.library_path(n)
                      for n in _build.KERNEL_SOURCES}
    header = csrc / HEADER
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.KERNEL_SOURCES}
    for n in _build.KERNEL_SOURCES:
        assert after[n] != before[n]
        assert after[n].name.startswith(f"lib{n}-")
