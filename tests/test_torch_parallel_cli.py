"""The train CLI's data-parallel modes across OS processes.

Two `python -m deeplearning4j_tpu_torch.train --device cpu` processes
join one gloo group from the reference's variables (COORDINATOR_ADDRESS,
NUM_PROCESSES, PROCESS_ID) or torchrun's (MASTER_ADDR/MASTER_PORT,
WORLD_SIZE, RANK): `--mode sync` (the default), `--mode averaging
--averaging-frequency 2` and `--mesh data=2,zero=1`. Only rank 0 saves
the model and prints the result line; its parameters are within 1e-5
relative of the reference's ParallelWrapper over two devices on the same
data (the SYNC runs also of each other's). `--mesh data=2,zero=1
--ui-port 0` finishes with one dashboard, on rank 0. `--mesh` with
averaging is refused as the reference refuses it.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_dist import (
    assert_params_close, blobs, ref_flat, ref_mesh, ref_mlp, save_ref,
)
from deeplearning4j_tpu.data.iterator import ArrayDataSetIterator as JIt
from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper
from deeplearning4j_tpu.util.serialization import load_model as jload
from deeplearning4j_tpu_torch.parallel.distributed import free_port
from deeplearning4j_tpu_torch.train import cli
from deeplearning4j_tpu_torch.util.serialization import load_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    model = save_ref(ref_mlp(), d / "m.zip")
    X, Y = blobs(n=96)
    data = str(d / "d.npz")
    np.savez(data, features=X, labels=Y)
    return d, model, data, X, Y


def _run_two(extra, out, model, data, torchrun=False):
    port = free_port()
    procs = []
    for r in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("COORDINATOR_ADDRESS", "MASTER_ADDR",
                            "WORLD_SIZE", "RANK", "PROCESS_ID",
                            "NUM_PROCESSES", "MASTER_PORT")}
        env["PYTHONPATH"] = REPO
        env["OMP_NUM_THREADS"] = "1"
        if torchrun:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r))
        else:
            env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       NUM_PROCESSES="2", PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.train",
             "--model", model, "--dataset", data, "--output", out,
             "--device", "cpu", "--batch-size", "32", "--epochs", "2",
             "--score-every", "1"] + extra, env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            o, e = p.communicate(timeout=240)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == 0, e[-3000:]
        outs.append((o, e))
    return outs


def _ref(model, X, Y, **kw):
    net = jload(model)
    JWrapper(net, mesh=ref_mesh(2), **kw).fit(JIt(X, Y, batch_size=32),
                                              epochs=2)
    return net


@pytest.mark.parametrize("name,extra,kw,torchrun", [
    ("sync", [], {}, False),
    ("averaging", ["--mode", "averaging", "--averaging-frequency", "2"],
     dict(mode="averaging", averaging_frequency=2), True),
    ("mesh_zero1", ["--mesh", "data=2,zero=1"], dict(zero_stage=1), False),
    # the dashboard's capture gathers the ZeRO pieces on every rank: a
    # listener on the coordinator alone would leave it in the gathers
    ("mesh_zero1_ui", ["--mesh", "data=2,zero=1", "--ui-port", "0"],
     dict(zero_stage=1), False),
], ids=["sync", "averaging", "mesh_zero1", "mesh_zero1_ui"])
def test_two_process_cli_matches_the_reference(setup, name, extra, kw,
                                               torchrun):
    d, model, data, X, Y = setup
    out = str(d / f"{name}.zip")
    (o0, e0), (o1, e1) = _run_two(extra, out, model, data, torchrun)
    line = json.loads(o0.strip().splitlines()[-1])
    assert (line["iterations"], line["epochs"]) == (6, 2)
    assert not any(ln.startswith('{"output"') for ln in o1.splitlines())
    record = json.loads([ln for ln in e0.splitlines()
                         if ln.startswith('{"parallel"')][-1])["parallel"]
    assert record["world"] == 2 and record["backend"] == "gloo"
    if name.startswith("mesh"):
        assert record["plan"]["zero_stage"] == 1
        assert any(ln.startswith("mesh plan:") for ln in e0.splitlines())
    # one dashboard, on the coordinator
    assert [ln.startswith("dashboard: ") for ln in e0.splitlines()].count(
        True) == ("--ui-port" in extra)
    assert not any(ln.startswith("dashboard: ") for ln in e1.splitlines())
    ref = _ref(model, X, Y, **kw)
    assert_params_close(load_model(out, device="cpu").params_flat().numpy(),
                        ref_flat(ref))


def test_mesh_with_averaging_is_refused(setup):
    d, model, data, _, _ = setup
    with pytest.raises(SystemExit, match="--mesh applies to --mode "
                                         "single\\|sync"):
        cli.main(["--model", model, "--dataset", data, "--output",
                  str(d / "x.zip"), "--device", "cpu", "--mode",
                  "averaging", "--mesh", "data=1"])
    with pytest.raises(SystemExit, match="--mesh: unknown --mesh key"):
        cli.main(["--model", model, "--dataset", data, "--output",
                  str(d / "x.zip"), "--device", "cpu", "--mesh", "dta=1"])
    with pytest.raises(SystemExit, match="--mesh: mesh 2x1x1x1 != "
                                         "available devices 1"):
        cli.main(["--model", model, "--dataset", data, "--output",
                  str(d / "x.zip"), "--device", "cpu", "--mesh", "data=2"])
    with pytest.raises(SystemExit, match="AVERAGING replica state"):
        cli.main(["--model", model, "--dataset", data, "--output",
                  str(d / "x.zip"), "--device", "cpu", "--mode",
                  "averaging", "--checkpoint-dir", str(d / "ck")])
