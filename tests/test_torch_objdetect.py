"""The port's Yolo2OutputLayer and its host-side decoding against the JAX
package, on the CPU.

The same seeded numpy predictions and labels go through both layers:
labels with boxes, empty cells, and a cell whose label overlaps none of
its predicted boxes (every IOU 0: both take the first anchor as the
responsible one). `apply`, `score` and the gradient of the score with
respect to the input agree within 1e-5 relative in f32 and 1e-10 in f64
(JAX x64 toggled by a fixture); under bf16 input the port's loss stays
f32. `decode_detections` gives the same boxes (rtol 1e-6: the port
computes corners in f64 and rounds once), scores and classes, and
`non_max_suppression` keeps the same indices. The reference's
`test_yolo_loss_prefers_accurate_boxes` is ported as it is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import objdetect as jod
from deeplearning4j_tpu_torch.nn.layers import objdetect as pod

ANCHORS = ((1.0, 1.2), (2.5, 1.5), (0.6, 0.4))
N_CLASSES = 3
B, H, W = 2, 5, 4


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _case(dtype, seed=0):
    """Predictions (B, H, W, A*(5+C)) and labels (B, H, W, 4+C)."""
    rs = np.random.RandomState(seed)
    n_a = len(ANCHORS)
    x = rs.randn(B, H, W, n_a * (5 + N_CLASSES)).astype(dtype)
    labels = np.zeros((B, H, W, 4 + N_CLASSES), dtype)
    for b, yy, xx, cls in ((0, 0, 0, 0), (0, 2, 3, 1), (1, 4, 1, 2),
                           (1, 1, 2, 0)):
        x1 = xx + rs.rand() * 0.5
        y1 = yy + rs.rand() * 0.5
        labels[b, yy, xx, :4] = [x1, y1, x1 + 0.4 + 2 * rs.rand(),
                                 y1 + 0.4 + 2 * rs.rand()]
        labels[b, yy, xx, 4 + cls] = 1
    # a label box that no predicted box of its cell overlaps: a tiny box
    # in the cell's corner, every predicted box shrunk to ~0 at the centre
    labels[1, 3, 3, :4] = [3.0, 3.0, 3.05, 3.05]
    labels[1, 3, 3, 4 + 1] = 1
    pred = x[1, 3, 3].reshape(n_a, 5 + N_CLASSES)
    pred[:, 0:2] = 0.0
    pred[:, 2:4] = -30.0
    return x, labels


def _layers():
    return (jod.Yolo2OutputLayer(anchors=ANCHORS, n_classes=N_CLASSES),
            pod.Yolo2OutputLayer(anchors=ANCHORS, n_classes=N_CLASSES))


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("anchor", [0, 2])
def test_the_zero_iou_cell_takes_the_first_anchor(anchor):
    """A one-cell grid whose label box no predicted box overlaps: every
    IOU is 0 and anchor 0 is the responsible one, whichever anchor's
    confidence is highest. The loss is computed here by hand."""
    n_a = len(ANCHORS)
    x = np.zeros((1, 1, 1, n_a, 5 + N_CLASSES))
    x[..., 2:4] = -30.0                   # every predicted box ~ 0 wide
    x[..., 4] = -1.0
    x[..., anchor, 4] = 2.0
    x[..., 5:] = np.random.RandomState(1).randn(n_a, N_CLASSES)
    x = x.reshape(1, 1, 1, -1)
    labels = np.zeros((1, 1, 1, 4 + N_CLASSES))
    labels[..., :4] = [0.0, 0.0, 0.05, 0.05]
    labels[..., 4 + 2] = 1
    _, pl = _layers()
    got = float(pl.score({}, torch.from_numpy(x), torch.from_numpy(labels)))
    conf = 1 / (1 + np.exp(-x.reshape(n_a, -1)[:, 4]))
    logits = x.reshape(n_a, -1)[0, 5:]
    probs = np.exp(logits) / np.exp(logits).sum()
    coord = 5.0 * (2 * (0.5 - 0.025) ** 2
                   + 2 * (np.sqrt(1e-9) - np.sqrt(0.05)) ** 2)
    want = (coord + conf[0] ** 2 + 0.5 * (conf[1:] ** 2).sum()
            + ((probs - np.eye(N_CLASSES)[2]) ** 2).sum())
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("float64", 1e-10)])
def test_apply_score_and_input_gradient_match(dtype, tol, request):
    if dtype == "float64":
        request.getfixturevalue("x64")
    x, labels = _case(dtype)
    jl, pl = _layers()
    jy, _ = jl.apply(None, {}, jnp.asarray(x))
    py, _ = pl.apply({}, {}, torch.from_numpy(x))
    assert py.dtype == torch.from_numpy(x).dtype
    assert _rel(py.numpy(), np.asarray(jy)) <= tol
    jscore, jgrad = jax.value_and_grad(
        lambda xx: jl.score(None, xx, jnp.asarray(labels)))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    pscore = pl.score({}, tx, torch.from_numpy(labels))
    (pgrad,) = torch.autograd.grad(pscore, tx)
    assert pscore.dtype == tx.dtype
    assert abs(float(pscore.detach()) - float(jscore)) \
        <= tol * abs(float(jscore))
    assert _rel(pgrad.numpy(), np.asarray(jgrad)) <= tol


def test_the_loss_accumulates_in_f32_under_bf16():
    x, labels = _case("float32")
    _, pl = _layers()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    score = pl.score({}, xb, torch.from_numpy(labels).to(torch.bfloat16))
    assert score.dtype == torch.float32
    ref = pl.score({}, xb.float(), torch.from_numpy(labels).to(
        torch.bfloat16).float())
    assert float(score) == float(ref)


def test_empty_labels_score_only_the_no_object_term():
    x, _ = _case("float32", seed=3)
    labels = np.zeros((B, H, W, 4 + N_CLASSES), "float32")
    jl, pl = _layers()
    pscore = float(pl.score({}, torch.from_numpy(x),
                            torch.from_numpy(labels)))
    conf = 1 / (1 + np.exp(-x.reshape(B, H, W, len(ANCHORS), -1)[..., 4]
                           .astype("float64")))
    np.testing.assert_allclose(pscore, 0.5 * (conf ** 2).sum() / B,
                               rtol=1e-5)
    np.testing.assert_allclose(
        pscore, float(jl.score(None, jnp.asarray(x), jnp.asarray(labels))),
        rtol=1e-5)


def test_yolo_loss_prefers_accurate_boxes():
    """A well-aimed prediction scores lower than a badly-aimed one (the
    reference's tests/test_zoo.py case, on the port)."""
    layer = pod.Yolo2OutputLayer(anchors=((1.0, 1.0), (2.0, 2.0)),
                                 n_classes=2)
    h = w = 2
    labels = np.zeros((1, h, w, 4 + 2), "float32")
    labels[0, 0, 0] = [0.0, 0.0, 1.0, 1.0, 1, 0]   # unit box, class 0
    good = np.zeros((1, h, w, 2 * 7), "float32")
    good[0, 0, 0, 0:2] = 0.0      # sigmoid(0) = 0.5: the cell's centre
    good[0, 0, 0, 2:4] = 0.0      # wh = anchor (1, 1) * exp(0): exact
    good[0, 0, 0, 4] = 4.0        # high confidence
    good[0, 0, 0, 5] = 4.0        # class 0
    bad = good.copy()
    bad[0, 0, 0, 2:4] = 2.0       # wh e^2 ~ 7.4x too large
    bad[0, 0, 0, 5:7] = [0.0, 4.0]  # the wrong class
    l_good = float(layer.score({}, torch.from_numpy(good),
                               torch.from_numpy(labels)))
    l_bad = float(layer.score({}, torch.from_numpy(bad),
                              torch.from_numpy(labels)))
    assert l_good < l_bad, (l_good, l_bad)


@pytest.mark.parametrize("threshold", [0.3, 0.6])
def test_decode_and_nms_match_the_reference(threshold):
    x, _ = _case("float32", seed=5)
    jl, pl = _layers()
    activated = np.array(jl.apply(None, {}, jnp.asarray(x))[0])
    ref = jod.decode_detections(activated, ANCHORS, N_CLASSES, threshold)
    port = pod.decode_detections(torch.from_numpy(activated), ANCHORS,
                                 N_CLASSES, threshold)
    assert len(port) == len(ref) == B
    n_boxes = 0
    for (pb, ps, pc), (rb, rs_, rc) in zip(port, ref):
        assert len(pb) == len(rb)
        n_boxes += len(pb)
        if len(rb):
            np.testing.assert_allclose(pb, rb, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ps, rs_)
        np.testing.assert_array_equal(pc, rc)
        for classes in (None, rc):
            for iou in (0.2, 0.45):
                assert pod.non_max_suppression(pb, ps, classes, iou) == \
                    jod.non_max_suppression(rb, rs_, classes, iou)
    assert n_boxes > 3


def test_nms_is_class_wise():
    boxes = np.asarray([[0, 0, 2, 2], [0.1, 0.1, 2, 2], [0, 0, 2, 2.1]],
                       np.float32)
    scores = np.asarray([0.9, 0.8, 0.7], np.float32)
    assert pod.non_max_suppression(boxes, scores) == [0]
    assert pod.non_max_suppression(boxes, scores, [0, 1, 0]) == [0, 1]
    assert pod.non_max_suppression(np.zeros((0, 4)), np.zeros(0)) == []


def test_the_layer_round_trips_the_reference_json():
    from deeplearning4j_tpu.nn.conf.base import layer_to_dict as j_to_dict
    from deeplearning4j_tpu_torch.nn.conf.base import (
        layer_from_dict, layer_to_dict,
    )
    jl, pl = _layers()
    assert layer_to_dict(pl) == j_to_dict(jl)
    back = layer_from_dict(j_to_dict(jl))
    assert isinstance(back, pod.Yolo2OutputLayer)
    assert [tuple(a) for a in back.anchors] == list(ANCHORS)


# --------------------------------------------------------------- TinyYOLO
def _yolo_labels(n, grid, classes, seed):
    """1-2 boxes an image in grid units, each in the cell of its centre."""
    rs = np.random.RandomState(seed)
    y = np.zeros((n, grid, grid, 4 + classes))
    for i in range(n):
        for _ in range(1 + i % 2):
            cx, cy = rs.uniform(0.2, grid - 0.2, 2)
            w, h = rs.uniform(0.3, 1.5, 2)
            y[i, int(cy), int(cx), :4] = [cx - w / 2, cy - h / 2,
                                         cx + w / 2, cy + h / 2]
            y[i, int(cy), int(cx), 4:] = np.eye(classes)[rs.randint(classes)]
    return y


def _leaf_rel(port_tree, ref_tree, before=None):
    """The worst over leaves of |port - ref| over the leaf's largest
    value (or, with `before`, over its largest update)."""
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    worst = 0.0
    for path, leaf in iter_leaves(port_tree):
        ref = ref_tree
        for k in path:
            ref = ref[k]
        ref = np.asarray(ref)
        scale = np.abs(ref).max() if before is None else \
            (leaf - before[path]).abs().max().item()
        worst = max(worst, np.abs(leaf.numpy() - ref).max() / scale)
    return worst


def test_tinyyolo_from_the_reference_zip_in_float64(tmp_path, x64):
    """TinyYOLO (3 classes, 64², a 2x2 grid) from the reference's zip:
    the f32 output; then in f64, the training score and gradients of a
    batch with labelled boxes within 1e-10 (of each leaf's largest
    gradient), and one fit step with the model's Adam. Adam's first step
    is g / (|g| + 1e-8) an entry, which multiplies the error of entries
    with |g| near 1e-8 by up to max|g| / 1e-8: the step is held within
    1e-6 of each leaf's largest update (9.5e-8 seen), the batch norm
    state within 1e-10."""
    import dataclasses
    from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS
    from deeplearning4j_tpu.models import zoo as jzoo
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.util.serialization import save_model as jax_save
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.nn.conf.network import (
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, params_from_numpy,
    )
    rs = np.random.RandomState(0)
    conf = jzoo.TinyYOLO(num_classes=3, input_shape=(64, 64, 3)).conf()
    j32 = JCG(conf)
    j32._vertex_types = j32._resolve_types()
    # the reference's parameter shapes (its init traced, not run) with
    # seeded values; the BN state off 0 and 1
    params, state = jax.eval_shape(
        lambda: (lambda n: (n.params, n.state))(JCG(conf).init()))
    j32.params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(0.05 * rs.randn(*s.shape), jnp.float32),
        params)
    j32.state = jax.tree_util.tree_map(
        lambda s: jnp.asarray(0.5 + np.abs(rs.randn(*s.shape)), jnp.float32),
        state)
    j32._build_optimizer()
    path = str(tmp_path / "tinyyolo.zip")
    jax_save(j32, path)
    p32 = load_model(path, device="cpu")
    X = np.random.RandomState(2).rand(4, 64, 64, 3)
    np.testing.assert_allclose(p32.output(X.astype("float32")).numpy(),
                               np.asarray(j32.output(X.astype("float32"))),
                               atol=1e-4)
    # the same network in f64 on both sides
    c64 = dataclasses.replace(conf, dtype="float64")
    j64 = JCG(c64)
    j64._vertex_types = j64._resolve_types()
    j64.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)), j32.params)
    j64.state = j32.state
    j64._build_optimizer()
    p64 = ComputationGraph(ComputationGraphConfiguration.from_json(
        c64.to_json()), device="cpu").init()
    p64.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, j64.params), "cpu",
        template=p64.params)
    p64.state = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, j64.state), "cpu",
        template=p64.state)
    Y = _yolo_labels(4, 2, 3, seed=3)
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda p: j64._score_fn(
        p, j64.state, (jnp.asarray(X),), (jnp.asarray(Y),), None, None,
        True, None)[0]))(j64.params)
    ploss, pgrad, _ = p64.compute_gradient_and_score(
        MultiDataSet((X,), (Y,)))
    assert abs(float(ploss) - float(jloss)) <= 1e-10 * abs(float(jloss))
    assert _leaf_rel(pgrad, jgrad) <= 1e-10
    before = {p: t.clone() for p, t in iter_leaves(p64.params)}
    j64.fit(JMDS((X,), (Y,)), scan_steps=1)
    p64.fit(MultiDataSet((X,), (Y,)))
    np.testing.assert_allclose(p64.score(), j64._score, rtol=1e-10)
    assert _leaf_rel(p64.params, j64.params, before) <= 1e-6
    assert _leaf_rel(p64.state, j64.state) <= 1e-10
