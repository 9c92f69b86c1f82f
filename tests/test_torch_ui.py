"""The port's UI stack (`ui/*`), the fit's gradient capture and the train
CLI's `--ui-port`, against the JAX package's.

- Every case of `tests/test_ui.py` runs against the port
  (`_torch_reference_cases.port_cases`, networks on the CPU): the
  storages, the listener, every dashboard route, the t-SNE and word2vec
  views, the i18n catalog, and the remote router across two processes
  (the worker, `tests/_torch_remote_stats_worker.py`, posts through the
  port's storage).
- `StatsListener._summarize` on the same arrays (non-finite values,
  constant leaves, leaves of large magnitude, a range whose edges repeat)
  gives the reference's numbers: histogram counts and bounds exactly,
  norms and mean magnitudes within 1e-12 relative.
- The same seeded 4-step fit with a StatsListener in each package (the
  per-call path and the accumulate path) gives records whose params,
  gradients and updates summaries agree: counts exactly, norms within
  1e-6 relative (an f64 network: 1e-10).
- Under a data-parallel plan (two gloo ranks, ZeRO 0, 1 and 3) each
  rank's records carry the whole gradients and updates, gathered from its
  pieces, within 1e-5 of one process fitting the same global batches.
- The train CLI with `--ui-port 0` serves the dashboard (port 0 is a free
  port, not "no dashboard") and its records carry gradients and updates.
"""
import contextlib
import io
import json
import re
import urllib.request

import jax
import numpy as np
import pytest
import torch

from _torch_reference_cases import port_cases, run_case
from deeplearning4j_tpu.nn.conf.base import InputType as RIT
from deeplearning4j_tpu.nn.conf.network import (
    NeuralNetConfiguration as RNNC,
)
from deeplearning4j_tpu.nn.layers import (
    DenseLayer as RDense, OutputLayer as ROut,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as RMLN
from deeplearning4j_tpu.nn.updaters import Adam as RAdam
from deeplearning4j_tpu.ui import (
    InMemoryStatsStorage as RStorage, StatsListener as RListener,
)
from deeplearning4j_tpu.ui import stats as rstats
from deeplearning4j_tpu.util.serialization import save_model as r_save
from deeplearning4j_tpu_torch.ui import (
    InMemoryStatsStorage, StatsListener, UIServer,
)
from deeplearning4j_tpu_torch.ui import stats as pstats
from deeplearning4j_tpu_torch.util.serialization import load_model

_REF = port_cases("tests/test_ui.py", extra_subs=(
    ("MultiLayerNetwork(conf).init()",
     "MultiLayerNetwork(conf, device='cpu').init()"),
    ("_remote_stats_worker.py", "_torch_remote_stats_worker.py")))
REFERENCE_CASES = sorted(n for n in vars(_REF) if n.startswith("test_"))


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_reference_case(name, request):
    run_case(_REF, name, request)


# ------------------------------------------------------------- summaries
def _arrays(seed):
    rs = np.random.RandomState(seed)
    a = rs.randn(37, 5).astype(np.float32)
    b = rs.randn(1000).astype(np.float32) * 1e-3
    b[[3, 17, 500]] = [np.nan, np.inf, -np.inf]
    return {
        "0/W": a,
        "0/b": b,
        "1/const": np.full((7,), 0.75, np.float32),
        "1/big": np.full((4,), 12345.5, np.float32),
        # lo + 1e-12 is 9 ulps above lo: the 21 edges repeat
        "1/mid": np.full((5,), 1000.25, np.float32),
        "2/nan": np.full((3,), np.nan, np.float32),
        # values on the bin edges of their own range
        "2/edges": np.linspace(-1, 1, 41).astype(np.float32),
        "3/f64": rs.randn(9, 3),
    }


@pytest.mark.parametrize("histograms", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_summaries_equal_the_reference(seed, histograms):
    arrays = _arrays(seed)
    want = rstats._summarize({k: np.asarray(v) for k, v in arrays.items()},
                             20, histograms)
    got = pstats._summarize({k: torch.from_numpy(v)
                             for k, v in arrays.items()}, 20, histograms)
    assert list(got) == list(want)
    for k in want:
        w, g = want[k], got[k]
        assert list(g) == list(w), k
        assert g["n_non_finite"] == w["n_non_finite"], k
        for f in ("norm", "mean_mag"):
            assert abs(g[f] - w[f]) <= 1e-12 * max(abs(w[f]), 1e-300), (k, f)
        if histograms:
            assert g["hist"] == w["hist"], k
            assert (g["lo"], g["hi"]) == (w["lo"], w["hi"]), k


def test_leaf_paths_match_the_reference():
    tree = {"1": {"b": np.ones(2)}, "0": {"fwd": {"W": np.ones((2, 2))},
                                          "e": np.zeros((0,))}}
    want = rstats._leaf_paths(tree)
    got = pstats._leaf_paths(tree)
    assert list(got) == list(want) == ["0/fwd/W", "1/b"]


# --------------------------------------------------- the listener in a fit
def _conf_ref(seed=7):
    return (RNNC.Builder().seed(seed).updater(RAdam(0.01)).list()
            .layer(RDense(n_out=8, activation="tanh"))
            .layer(ROut(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(RIT.feed_forward(5)).build())


@contextlib.contextmanager
def _x64(on):
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _compare_records(ref_records, port_records, tol):
    assert len(ref_records) == len(port_records) == 4
    for a, b in zip(ref_records, port_records):
        assert a.data["iteration"] == b.data["iteration"]
        for group in ("params", "gradients", "updates"):
            assert list(a.data[group]) == list(b.data[group]), group
            for leaf, ea in a.data[group].items():
                eb = b.data[group][leaf]
                assert eb["hist"] == ea["hist"], (group, leaf)
                assert eb["n_non_finite"] == ea["n_non_finite"]
                for f in ("norm", "mean_mag"):
                    assert abs(eb[f] - ea[f]) <= tol * abs(ea[f]), \
                        (group, leaf, f, ea[f], eb[f])


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("float64", 1e-10)])
@pytest.mark.parametrize("accumulate", [1, 2])
def test_fit_records_match_the_reference(accumulate, dtype, tol):
    """Per-call (accumulate 1) and accumulate (2 micro-batches a step)
    fits of 4 steps with StatsListener(frequency=1) in each package, from
    the same weights: the records' summaries agree."""
    import dataclasses
    rs = np.random.RandomState(0)
    bs = 16 // accumulate
    X = rs.randn(64, 5).astype(dtype)
    Y = np.eye(3, dtype=dtype)[rs.randint(0, 3, 64)]
    with _x64(dtype == "float64"):
        ref = RMLN(dataclasses.replace(_conf_ref(), dtype=dtype)).init()
        buf = io.BytesIO()
        r_save(ref, buf)
        buf.seek(0)
        port = load_model(buf, device="cpu")
        rst, pst = RStorage(), InMemoryStatsStorage()
        ref.set_listeners(RListener(rst, session_id="s"))
        port.set_listeners(StatsListener(pst, session_id="s"))
        ref.fit((X, Y), epochs=1, batch_size=bs, accumulate_steps=accumulate)
        port.fit((X, Y), epochs=1, batch_size=bs,
                 accumulate_steps=accumulate)
    _compare_records(
        rst.get_all_updates_after("s", "StatsListener", "worker-0", 0),
        pst.get_all_updates_after("s", "StatsListener", "worker-0", 0), tol)


def test_captured_updates_are_the_updaters_output():
    """`on_gradients` gets the step's gradients and the updater's output
    before it is applied (p_new = p_old + updates), on capture iterations
    only; other steps run as before."""
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    rs = np.random.RandomState(3)
    X = rs.randn(48, 5).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 48)]
    ref = RMLN(_conf_ref()).init()
    buf = io.BytesIO()
    r_save(ref, buf)
    buf.seek(0)
    net = load_model(buf, device="cpu")
    seen = []

    class Spy:
        wants_gradients = True

        def should_capture(self, it):
            return it % 2 == 1

        def on_gradients(self, model, it, epoch, grads, updates):
            seen.append((it, [t.clone() for t in tree_leaves(grads)],
                         [t.clone() for t in tree_leaves(updates)]))

        def iteration_done(self, model, it, *a, **kw):
            params.append([t.clone() for t in tree_leaves(model.params)])

        def on_epoch_start(self, *a):
            pass

        on_epoch_end = on_epoch_start
    params = [[t.clone() for t in tree_leaves(net.params)]]
    net.set_listeners(Spy())
    net.fit((X, Y), epochs=1, batch_size=16)
    assert [it for it, _, _ in seen] == [1]
    it, grads, updates = seen[0]
    for before, after, u in zip(params[it], params[it + 1], updates):
        torch.testing.assert_close(after, before + u, rtol=0, atol=1e-7)
    ds_grads = net.compute_gradient_and_score  # exists: the same function
    assert callable(ds_grads) and all(torch.isfinite(g).all() for g in grads)


def test_graph_records_carry_no_gradients():
    """The reference's ComputationGraph delivers no gradients to
    listeners; the port's graph keeps that."""
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    conf = (NeuralNetConfiguration.Builder().seed(1).graph_builder()
            .add_inputs("in")
            .add_layer("d", DenseLayer(n_out=4, activation="tanh"), "in")
            .add_layer("out", OutputLayer(n_out=2), "d")
            .set_outputs("out").set_input_types(InputType.feed_forward(3))
            .build())
    net = ComputationGraph(conf, device="cpu").init()
    st = InMemoryStatsStorage()
    net.set_listeners(StatsListener(st, session_id="g"))
    rs = np.random.RandomState(0)
    X = rs.randn(8, 3).astype(np.float32)
    Y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 8)]
    net.fit([(X[:4], Y[:4]), (X[4:], Y[4:])])
    ups = st.get_all_updates_after("g", "StatsListener", "worker-0", 0)
    assert len(ups) == 2
    assert all("params" in u.data and "gradients" not in u.data
               for u in ups)


# ----------------------------------------------------------- the train CLI
def test_train_cli_ui_port_zero_serves_the_dashboard(tmp_path, capsys,
                                                     monkeypatch):
    """`--ui-port 0` starts the dashboard on a free port (a falsy port
    used to go unserved): its pages answer while the run is live, and its
    records carry params, gradients and updates for every leaf."""
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.train import cli
    from deeplearning4j_tpu_torch.ui import server as ui_server
    from deeplearning4j_tpu_torch.util.serialization import save_model
    lm = dict(vocab_size=16, seq_length=8, n_layers=1, n_embd=16,
              n_heads=2, attention_impl="flash", seed=3)
    model = save_model(model_by_name("TransformerLM", **lm).init(
        device="cpu"), str(tmp_path / "lm.zip"))
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 16, (8, 8))
    np.savez(str(tmp_path / "t.npz"),
             features=ids[..., None].astype(np.float32),
             labels=np.eye(16, dtype=np.uint8)[np.roll(ids, -1, 1)])
    live = {}
    real_stop = ui_server.UIServer.stop

    def stop(self):             # answer the pages once more, then stop
        for path in ("train", "train/system", "train/model"):
            body = urllib.request.urlopen(self.url + path, timeout=10).read()
            live[path] = body.decode()
        sid = json.loads(urllib.request.urlopen(
            self.url + "train/sessions", timeout=10).read())["sessions"][0]
        live["data"] = json.loads(urllib.request.urlopen(
            f"{self.url}train/data?sid={sid}&after=0", timeout=10).read())
        real_stop(self)
    monkeypatch.setattr(ui_server.UIServer, "stop", stop)
    assert cli.main(["--model", model, "--dataset", str(tmp_path / "t.npz"),
                     "--output", str(tmp_path / "o.zip"), "--mode", "single",
                     "--device", "cpu", "--batch-size", "2",
                     "--score-every", "1", "--ui-port", "0"]) == 0
    err = capsys.readouterr().err
    url = re.search(r"dashboard: (http://127\.0\.0\.1:(\d+)/)", err)
    assert url and int(url.group(2)) > 0
    assert "Training Dashboard" in live["train"]
    assert "Iteration time" in live["train/system"]
    updates = live["data"]["updates"]
    assert len(updates) == 4
    leaves = set(pstats._leaf_paths(load_model(
        str(tmp_path / "o.zip"), device="cpu").params))
    for u in updates:
        for group in ("params", "gradients", "updates"):
            assert set(u["data"][group]) == leaves, group
    # the last record's params are the output zip's
    out = load_model(str(tmp_path / "o.zip"), device="cpu")
    want = rstats._summarize({k: v.numpy() for k, v in
                              pstats._leaf_paths(out.params).items()},
                             20, True)
    last = updates[-1]["data"]["params"]
    for leaf, w in want.items():
        assert last[leaf]["hist"] == w["hist"]
        assert abs(last[leaf]["norm"] - w["norm"]) <= 1e-6 * w["norm"]


def test_ui_exports_are_lazy():
    import subprocess
    import sys
    code = ("import sys, deeplearning4j_tpu_torch.ui as u; "
            "assert 'torch' not in sys.modules, 'torch'; "
            "u.UIServer; assert 'torch' not in sys.modules; "
            "u.StatsListener; assert 'torch' in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=str(__import__("pathlib").Path(__file__)
                               .resolve().parent.parent))
    assert r.returncode == 0, r.stderr


@pytest.fixture(scope="module")
def pool():
    from _torch_dist import RankPool
    p = RankPool(2)
    yield p
    p.close()


@pytest.mark.parametrize("zero", [0, 1, 3])
def test_plan_fit_records_gather_whole_trees(pool, zero, tmp_path):
    from deeplearning4j_tpu_torch.util.serialization import save_model
    ref = RMLN(_conf_ref()).init()
    path = str(tmp_path / "m.zip")
    r_save(ref, path)
    rs = np.random.RandomState(4)
    X = rs.randn(32, 5).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 32)]
    one = load_model(path, device="cpu")
    st = InMemoryStatsStorage()
    one.set_listeners(StatsListener(st, session_id="o"))
    one.fit((X, Y), batch_size=8)
    want = st.get_all_updates_after("o", "StatsListener", "worker-0", 0)
    ranks = pool.run("stats_plan", 2, zip_path=path, X=X, Y=Y, batch=8,
                     plan={"data": 2, "zero_stage": zero})
    for records in ranks:
        assert len(records) == len(want) == 4
        for got, w in zip(records, want):
            for group in ("gradients", "updates"):
                assert set(got[group]) == set(w.data[group])
                for leaf, e in w.data[group].items():
                    g = got[group][leaf]
                    assert sum(g["hist"]) == sum(e["hist"])
                    assert abs(g["norm"] - e["norm"]) <= 1e-5 * e["norm"], \
                        (group, leaf)
