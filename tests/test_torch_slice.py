"""The whole slice: a JAX TransformerLM(attention_impl="flash") -> its
checkpoint zip -> the port's network -> the port's HTTP predict, held to
the JAX output.

The JAX network on the CPU takes its blockwise attention path
(nn/layers/attention.py), the oracle for the port's flash path.
Tolerance on the softmax outputs: atol 2e-5, rtol 1e-4 — two layers of
f32 matmuls, layer norms and softmaxes summed in other orders.
"""
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import model_by_name as jax_model_by_name
from deeplearning4j_tpu.util.serialization import (
    load_model as jax_load_model, save_model as jax_save_model,
)
from deeplearning4j_tpu_torch.models.zoo import model_by_name
from deeplearning4j_tpu_torch.serving import cli
from deeplearning4j_tpu_torch.serving.registry import (
    ModelLoadError, ModelRegistry, load_servable, parse_zoo_source,
)
from deeplearning4j_tpu_torch.serving.batcher import ServerDrainingError
from deeplearning4j_tpu_torch.serving.server import ModelServer
from deeplearning4j_tpu_torch.util.serialization import (
    load_model, params_from_numpy, save_model,
)

TOL = dict(atol=2e-5, rtol=1e-4)
LM = dict(vocab_size=64, seq_length=40, n_layers=2, n_embd=32, n_heads=4,
          mlp_ratio=2, attention_impl="flash", block_size=16, seed=5)


@pytest.fixture(scope="module")
def jax_lm(tmp_path_factory):
    """A JAX LM with perturbed (non-init) weights, its zip, an input batch
    and the JAX output on it."""
    net = jax_model_by_name("TransformerLM", **LM).init()
    rs = np.random.RandomState(0)
    net.params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rs.randn(*a.shape).astype("float32"),
        net.params)
    path = str(tmp_path_factory.mktemp("ckpt") / "lm.zip")
    jax_save_model(net, path)
    x = rs.randint(0, 64, (3, 40, 1)).astype("float32")
    return net, path, x, np.asarray(net.output(x))


def test_zip_from_jax_loads_and_matches(jax_lm):
    _, path, x, ref = jax_lm
    net = load_model(path, device="cpu")
    assert net.device == torch.device("cpu")
    y = net.output(x)
    assert y.shape == (3, 40, 64)
    np.testing.assert_allclose(y.numpy(), ref, **TOL)


def test_params_from_numpy_matches(jax_lm):
    jnet, _, x, ref = jax_lm
    tree = jax.tree_util.tree_map(np.asarray, jnet.params)
    net = model_by_name("TransformerLM", **LM).init(device="cpu")
    net.params = params_from_numpy(tree, "cpu", template=net.params)
    np.testing.assert_allclose(net.output(x).numpy(), ref, **TOL)
    # without a template the tree converts as it is
    loose = params_from_numpy(tree, "cpu", dtype=torch.float64)
    assert loose["1"]["attn"]["Wq"].dtype == torch.float64
    assert tuple(loose["1"]["attn"]["Wq"].shape) == (32, 32)


def test_params_from_numpy_rejects_mismatched_trees(jax_lm):
    jnet, _, _, _ = jax_lm
    tree = jax.tree_util.tree_map(np.asarray, jnet.params)
    net = model_by_name("TransformerLM", **LM).init(device="cpu")
    bad = dict(tree, **{"1": dict(tree["1"], W1=tree["1"]["W1"].T)})
    with pytest.raises(ValueError, match="1/W1: shape"):
        params_from_numpy(bad, "cpu", template=net.params)
    extra = dict(tree, **{"1": dict(tree["1"], Wx=tree["1"]["W1"])})
    with pytest.raises(ValueError, match="unexpected keys"):
        params_from_numpy(extra, "cpu", template=net.params)


def test_port_zip_loads_in_jax(jax_lm, tmp_path):
    _, path, x, ref = jax_lm
    net = load_model(path, device="cpu")
    out = save_model(net, str(tmp_path / "port.zip"))
    back = jax_load_model(out)
    np.testing.assert_allclose(np.asarray(back.output(x)), ref, **TOL)
    again = load_model(out, device="cpu")
    np.testing.assert_array_equal(again.output(x).numpy(),
                                  net.output(x).numpy())


def _post(url, body, ctype="application/json", accept=None):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    if accept:
        req.add_header("Accept", accept)
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a, allow_pickle=False)
    return buf.getvalue()


def _http_error(fn):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    body = json.loads(e.value.read())
    return e.value.code, e.value.headers, body


def test_http_predict_matches_jax(jax_lm):
    _, path, x, ref = jax_lm
    registry = ModelRegistry(device="cpu")
    served = registry.deploy("lm", path, buckets=(1, 4), max_delay_ms=2)
    srv = ModelServer(registry, port=0)
    url = f"{srv.url}/v1/models/lm/predict"
    try:
        status, ctype, body = _post(
            url, json.dumps({"inputs": x[:2].tolist()}).encode())
        assert status == 200 and ctype == "application/json"
        doc = json.loads(body)
        assert doc["model"] == "lm" and doc["version"] == 1
        np.testing.assert_allclose(np.asarray(doc["outputs"]), ref[:2], **TOL)

        status, ctype, body = _post(url, _npy(x), "application/octet-stream",
                                    accept="application/octet-stream")
        assert status == 200 and ctype == "application/octet-stream"
        y = np.load(io.BytesIO(body), allow_pickle=False)
        assert y.shape == (3, 40, 64)     # batch 3 padded to bucket 4
        np.testing.assert_allclose(y, ref, **TOL)

        # one unbatched example comes back unbatched
        _, _, body = _post(url, _npy(x[0]), "application/octet-stream",
                           accept="application/octet-stream")
        np.testing.assert_allclose(np.load(io.BytesIO(body)), ref[0], **TOL)

        models = json.loads(urllib.request.urlopen(f"{srv.url}/v1/models",
                                                   timeout=10).read())
        assert models["models"][0]["input_shape"] == [40, 1]
        assert urllib.request.urlopen(f"{srv.url}/readyz",
                                      timeout=10).status == 200

        code, _, doc = _http_error(lambda: _post(
            f"{srv.url}/v1/models/nope/predict", b'{"inputs": [[0]]}'))
        assert code == 404 and "nope" in doc["error"]
        code, _, doc = _http_error(lambda: _post(
            url, json.dumps({"inputs": np.zeros((2, 39, 1)).tolist()})
            .encode()))
        assert code == 400 and "shape" in doc["error"]
        code, _, _ = _http_error(lambda: _post(url, b"not json"))
        assert code == 400
        code, _, doc = _http_error(lambda: _post(
            url, json.dumps({"inputs": np.full((1, 40, 1), 99).tolist()})
            .encode()))
        assert code == 400 and "token ids" in doc["error"]
        assert served.batcher.dispatches >= 5

        # a drained batcher answers 503 with a Retry-After hint
        served.batcher.drain(timeout=5)
        code, headers, _ = _http_error(lambda: _post(url, _npy(x[:1]),
                                                     "application/octet-stream"))
        assert code == 503 and 1 <= int(headers["Retry-After"]) <= 5
    finally:
        srv.drain(timeout=5)
    assert srv.draining and not srv.ready()
    with pytest.raises(ServerDrainingError):
        served.predict(x[:1])


def test_cli_build_serves_a_zoo_model(capsys):
    args = cli.build_parser().parse_args([
        "--model", "tiny=zoo:TransformerLM?vocab_size=32&seq_length=16"
                   "&n_layers=1&n_embd=32&n_heads=4&attention_impl=flash",
        "--port", "0", "--buckets", "1,2", "--device", "cpu"])
    registry, server = cli.build(args)
    try:
        first = json.loads(capsys.readouterr().out.splitlines()[0])
        assert first["serving"] == server.url and first["models"] == ["tiny"]
        assert "/v1/models/{name}/predict" in first["endpoints"]
        ids = np.arange(16, dtype="float32").reshape(1, 16, 1)
        _, _, body = _post(f"{server.url}/v1/models/tiny/predict", _npy(ids),
                           "application/octet-stream",
                           accept="application/octet-stream")
        y = np.load(io.BytesIO(body))
        assert y.shape == (1, 16, 32)
        np.testing.assert_allclose(y.sum(-1), 1.0, atol=1e-5)
        # the served network is the zoo one: same output in-process
        net = registry.get("tiny").model
        np.testing.assert_array_equal(y, net.output(ids).numpy())
        # redeploying the name is a version swap onto the same servable
        served = registry.get("tiny")
        assert registry.deploy("tiny", net, buckets=(1, 2)) is served
        assert served.describe()["active_version"] == 2
        registry.undeploy("tiny")
        code, _, _ = _http_error(lambda: _post(
            f"{server.url}/v1/models/tiny/predict", b'{"inputs": [[0]]}'))
        assert code == 404 and registry.names() == []
    finally:
        server.drain(timeout=5)


def test_http_backpressure_429_and_deadline_504():
    """A stalled runner fills the one-slot queue: the next request gets 429
    with Retry-After, and the queued one, whose 50 ms deadline passes while
    it waits, gets 504 once the runner frees."""
    registry = ModelRegistry(device="cpu")
    served = registry.deploy(
        "bp", "zoo:TransformerLM?vocab_size=32&seq_length=16&n_layers=1"
              "&n_embd=32&n_heads=4", buckets=(1,), max_delay_ms=0,
        queue_limit=1)
    srv = ModelServer(registry, port=0)
    url = f"{srv.url}/v1/models/bp/predict"
    real, entered, release = served.batcher.runner, threading.Event(), \
        threading.Event()

    def stalled(x):
        entered.set()
        assert release.wait(30)
        return real(x)

    served.batcher.runner = stalled
    body = _npy(np.zeros((1, 16, 1), "float32"))
    codes = {}

    def send(key, suffix=""):
        try:
            codes[key] = _post(url + suffix, body,
                               "application/octet-stream")[0]
        except urllib.error.HTTPError as e:
            e.read()
            codes[key] = e.code

    try:
        first = threading.Thread(target=send, args=("first",))
        first.start()
        assert entered.wait(30)                 # the worker holds "first"
        late = threading.Thread(target=send, args=("late", "?deadline_ms=50"))
        late.start()
        for _ in range(500):
            if served.batcher._queue.full():
                break
            time.sleep(0.01)
        assert served.batcher._queue.full()
        code, headers, doc = _http_error(lambda: _post(
            url, body, "application/octet-stream"))
        assert code == 429 and 1 <= int(headers["Retry-After"]) <= 5
        time.sleep(0.1)                         # "late" is past its deadline
        release.set()
        first.join(30)
        late.join(30)
        assert codes == {"first": 200, "late": 504}
    finally:
        release.set()
        srv.drain(timeout=5)


def test_sources_and_errors():
    assert parse_zoo_source("TransformerLM?n_layers=2&causal=false") == (
        "TransformerLM", {"n_layers": 2, "causal": False})
    with pytest.raises(ModelLoadError, match="unknown zoo model"):
        load_servable("zoo:NoSuchNet", device="cpu")
    with pytest.raises(ModelLoadError, match="bad constructor"):
        load_servable("zoo:TransformerLM?bogus=1", device="cpu")
    with pytest.raises(ModelLoadError, match="not found"):
        load_servable("/nonexistent/model.zip", device="cpu")


def test_batcher_is_a_context_manager_like_the_reference():
    """`with ShapeBucketedBatcher(...)` answers inside and stops its
    worker on exit, in both packages."""
    from deeplearning4j_tpu.serving.batcher import (
        ShapeBucketedBatcher as JBatcher,
    )
    from deeplearning4j_tpu_torch.serving.batcher import ShapeBucketedBatcher
    x = np.arange(6, dtype="float32").reshape(2, 3)
    outs = []
    for cls in (ShapeBucketedBatcher, JBatcher):
        with cls(lambda a: a * 2.0, (3,), buckets=(1, 4)) as b:
            assert b._worker.is_alive()
            outs.append(np.asarray(b.predict(x)))
        assert not b._worker.is_alive()
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], x * 2.0)
