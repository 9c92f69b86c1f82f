"""The port's encoded-gradient exchange (`parallel/transport.py`,
`parallel/shared.py`) against the reference's.

- `DTPU` frames are byte for byte the reference's (int8 signs and f32
  values), and a port `SocketTransport` and a reference one, in two OS
  processes, exchange messages both ways.
- `SharedGradientsTrainer` over the loopback transport (a
  MultiLayerNetwork and a ComputationGraph) ends within 1e-5 relative of
  the reference's, with the same bytes on the wire.
- Over sockets in two OS processes (`tests/_torch_dist` ranks) the port's
  replicas end bitwise equal.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist import (
    RankPool, assert_params_close, blobs, ref_flat, ref_graph, ref_mlp,
    ref_source, save_ref,
)
from deeplearning4j_tpu.parallel import transport as jtransport
from deeplearning4j_tpu.parallel import SharedGradientsTrainer as JShared
from deeplearning4j_tpu.util.serialization import load_model as jload
from deeplearning4j_tpu_torch.parallel import (
    SharedGradientsTrainer, SocketTransport, transport,
)
from deeplearning4j_tpu_torch.util.serialization import load_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ports() -> int:
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", p + 1))
            except OSError:
                continue
        return p
    raise RuntimeError("no two adjacent free ports")


MESSAGES = [
    (np.array([3, 0, -1], np.int32), np.array([1, -1, 0], np.int8), 0.25),
    (np.array([7, 2], np.int64), np.array([0.5, -2.0], np.float32), 1e-3),
]


@pytest.mark.parametrize("msg", MESSAGES, ids=["signs", "values"])
def test_frames_are_byte_for_byte_the_references(msg):
    ours = transport._encode_message(
        (torch.as_tensor(msg[0]), torch.as_tensor(msg[1]), msg[2]))
    assert ours == jtransport._encode_message(msg)
    assert transport._HEADER.format == jtransport._HEADER.format == "<4sIBf"


_REF_PEER = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from deeplearning4j_tpu.parallel.transport import SocketTransport
base = int(sys.argv[2])
with SocketTransport(rank=1, n_workers=2, base_port=base) as t:
    t.broadcast(1, (np.array([5, 9], np.int32),
                    np.array([-0.5, 4.0], np.float32), 0.125))
    (idx, payload, scalar), = t.recv(1, timeout=60)
    print(json.dumps({"idx": idx.tolist(), "payload": payload.tolist(),
                      "dtype": str(payload.dtype), "scalar": scalar}))
"""


def test_port_and_reference_transports_exchange_both_ways():
    base = _ports()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    peer = subprocess.Popen([sys.executable, "-c", _REF_PEER, REPO,
                             str(base)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        with SocketTransport(rank=0, n_workers=2, base_port=base) as t:
            t.broadcast(0, (torch.tensor([1, 4, -1]),
                            torch.tensor([1, -1, 0], dtype=torch.int8),
                            0.5))
            (idx, payload, scalar), = t.recv(1, timeout=60)
        out, err = peer.communicate(timeout=90)
    finally:
        if peer.poll() is None:
            peer.kill()
    assert peer.returncode == 0, err[-2000:]
    got = json.loads(out.strip().splitlines()[-1])
    assert got == {"idx": [1, 4, -1], "payload": [1, -1, 0],
                   "dtype": "int8", "scalar": 0.5}
    np.testing.assert_array_equal(idx, [5, 9])
    np.testing.assert_array_equal(payload, np.float32([-0.5, 4.0]))
    assert payload.dtype == np.float32 and scalar == 0.125
    assert t.messages_sent == 1
    assert t.bytes_sent == transport._HEADER.size + 3 * 4 + 3


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_loopback_trainer_matches_the_reference(tmp_path, graph):
    path = save_ref(ref_graph() if graph else ref_mlp(),
                    tmp_path / "m.zip", graph=graph)
    X, Y = blobs(n=128)
    ref = jload(path)
    jt = JShared(ref, n_workers=2, threshold=5e-4)
    net = load_model(path, device="cpu")
    pt = SharedGradientsTrainer(net, n_workers=2, threshold=5e-4)
    for _ in range(2):
        jt.fit(ref_source(ref, X, Y, 64) if graph else (X, Y),
               epochs=1, batch_size=64)
        pt.fit(__import__("_torch_jobs")._source(net, X, Y, 64)
               if graph else (X, Y), epochs=1, batch_size=64)
    assert_params_close(net.params_flat().numpy(), ref_flat(ref))
    assert pt.transport.bytes_sent == jt.transport.bytes_sent
    assert pt.transport.messages_sent == jt.transport.messages_sent
    assert pt.compression_ratio() == jt.compression_ratio()
    np.testing.assert_allclose(net.score(), ref.score(), rtol=1e-5)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


def test_socket_replicas_are_bitwise_equal(pool, tmp_path):
    """Two OS processes, one worker each, over SocketTransport: every
    replica applies the same ordered sum, so they end bitwise equal; the
    run tracks the reference's two-process loopback within 1e-5."""
    path = save_ref(ref_mlp(), tmp_path / "m.zip")
    X, Y = blobs(n=128)
    out = pool.run("shared_socket", 2, zip_path=path, X=X, Y=Y, batch=64,
                   base_port=_ports())
    np.testing.assert_array_equal(out[0]["flat"], out[1]["flat"])
    assert out[0]["messages_sent"] == 4
    assert out[0]["compression_ratio"] < 0.5
    ref = jload(path)
    jt = JShared(ref, n_workers=2, threshold=5e-4)
    jt.fit((X, Y), epochs=2, batch_size=64)
    assert_params_close(out[0]["flat"], ref_flat(ref))
