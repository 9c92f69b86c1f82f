"""The rest of the port's zoo against the JAX package, on the CPU: AlexNet,
VGG16, VGG19, GoogLeNet, Darknet19, TinyYOLO, YOLO2, InceptionResNetV1,
FaceNetNN4Small2 and UNet.

- Each model's configuration JSON (defaults and a resized one) equals
  the reference's, and a graph's topological order is the reference's.
- Each model at the smallest input its configuration accepts (YOLO2,
  TinyYOLO and Darknet19 at 64²): the port's parameter count equals the
  reference's own (counted from the shapes its init makes); the port's
  parameters and batch norm state, moved off their init, go into the
  reference network as numpy arrays, and `output()` agrees within 1e-4
  of the output's largest value (inference: batch norm from its running
  state). YOLO2's count is also taken at its default 80 classes and
  608² (it does not depend on the input size).

TinyYOLO's zip and its f64 fit step are held in tests/test_torch_objdetect.py.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf.network import (
    ComputationGraphConfiguration as JCGConf,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.models import zoo as pzoo
from deeplearning4j_tpu_torch.util.params import iter_leaves

NEW = ("AlexNet", "VGG16", "VGG19", "GoogLeNet", "Darknet19", "TinyYOLO",
       "YOLO2", "InceptionResNetV1", "FaceNetNN4Small2", "UNet")
# the smallest square input each accepts (64 for the YOLO family and its
# backbone), with few classes
SMALL = {"AlexNet": (67, 10), "VGG16": (32, 10), "VGG19": (32, 10),
         "GoogLeNet": (8, 10), "Darknet19": (64, 10), "TinyYOLO": (64, 3),
         "YOLO2": (64, 3), "InceptionResNetV1": (75, 10),
         "FaceNetNN4Small2": (75, 10), "UNet": (16, 1)}


@pytest.mark.parametrize("name", NEW)
def test_conf_is_the_reference_conf(name):
    for kw in ({}, dict(num_classes=7, input_shape=(96, 80, 3))):
        port = pzoo.model_by_name(name, **kw).conf()
        ref = jzoo.model_by_name(name, **kw).conf()
        assert port.to_dict() == ref.to_dict()
        if hasattr(ref, "topological_order"):
            assert port.topological_order() == ref.topological_order()
    assert set(NEW) <= set(pzoo.zoo_models())


def _small(name, **kw):
    hw, classes = SMALL[name]
    return dict(num_classes=classes, input_shape=(hw, hw, 3), **kw)


def _reference_count(name, **kw):
    """The reference's own parameter count, from the shapes its init makes
    (jax.eval_shape: nothing is allocated)."""
    model = jzoo.model_by_name(name, **kw)
    shapes = jax.eval_shape(lambda: model.init().params)
    return sum(math.prod(leaf.shape)
               for leaf in jax.tree_util.tree_leaves(shapes))


def _perturbed(pnet, seed=0):
    """The port's network moved off its init constants (parameters and
    batch norm state), and the same values as numpy trees."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for _, t in iter_leaves(pnet.params):
            t.add_(torch.from_numpy(0.01 * rs.randn(*t.shape)).to(t.dtype))
        for _, t in iter_leaves(pnet.state):
            t.add_(torch.from_numpy(0.1 * np.abs(rs.randn(*t.shape))).to(
                t.dtype))

    def numpy_tree(tree):
        return {k: numpy_tree(v) if isinstance(v, dict) else v.numpy().copy()
                for k, v in tree.items()}
    return numpy_tree(pnet.params), numpy_tree(pnet.state)


def _reference_net(jconf, params, state):
    """The reference network of `jconf` holding the given numpy trees (its
    own init is not run: it takes tens of seconds for the deep graphs)."""
    if isinstance(jconf, JCGConf):
        jnet = JCG(jconf)
        jnet._vertex_types = jnet._resolve_types()
    else:
        jnet = JMLN(jconf)
        jnet._input_types = jnet._resolve_types()
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    jnet.state = jax.tree_util.tree_map(jnp.asarray, state)
    jnet._build_optimizer()
    return jnet


@pytest.mark.parametrize("name", NEW)
def test_output_and_parameter_count_match(name):
    pnet = pzoo.model_by_name(name, **_small(name)).init(device="cpu")
    assert pnet.num_params() == _reference_count(name, **_small(name))
    jconf = jzoo.model_by_name(name, **_small(name)).conf()
    jnet = _reference_net(jconf, *_perturbed(pnet))
    hw = SMALL[name][0]
    X = np.random.RandomState(1).rand(2, hw, hw, 3).astype("float32")
    got = pnet.output(X).numpy()
    ref = np.asarray(jnet.output(X))
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


def test_yolo2_parameter_count_at_80_classes():
    pnet = pzoo.YOLO2(input_shape=(64, 64, 3)).init(device="cpu")
    assert pnet.num_params() == _reference_count("YOLO2") \
        == _reference_count("YOLO2", input_shape=(64, 64, 3))
    assert 39e6 < pnet.num_params() < 40e6
