"""The port's updaters and schedules against optax, through the JAX
package's `build_optimizer`, and `updaterState.bin` between the packages.

Each case takes 5 steps on one fixed sequence of gradient trees, made
from a numpy seed, through both, and compares the parameters and the
whole optimizer state (the port keeps it in optax's state-dict layout).
Tolerance rtol 1e-6, atol 1e-7: both compute in f32 with the same order
of operations; XLA and torch may differ by an ulp in pow/exp/rsqrt.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu_torch.nn import updaters as PU
from deeplearning4j_tpu_torch.util import serialization as port_ser

TOL = dict(rtol=1e-6, atol=1e-7)


def _params(seed=0):
    rs = np.random.RandomState(seed)
    return {"0": {"W": rs.randn(3, 4).astype("float32"),
                  "b": rs.randn(4).astype("float32")},
            "1": {"attn": {"Wq": rs.randn(4, 4).astype("float32")},
                  "gamma": (1 + 0.1 * rs.randn(4)).astype("float32")},
            "2": {}}


def _grads(step, scale=1.0):
    rs = np.random.RandomState(100 + step)
    return jax.tree_util.tree_map(
        lambda a: (scale * rs.randn(*a.shape)).astype("float32"), _params())


def _np_state(tree):
    """optax state -> its flax state dict as numpy leaves."""
    return jax.tree_util.tree_map(np.asarray,
                                  serialization.to_state_dict(tree))


def _torch_tree(tree):
    return PU.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees_close(port, ref, path=""):
    assert isinstance(port, dict) == isinstance(ref, dict), path
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), (path, sorted(port), sorted(ref))
        for k in ref:
            _assert_trees_close(port[k], ref[k], f"{path}/{k}")
    else:
        got = port.detach().cpu().numpy()
        assert got.dtype == np.asarray(ref).dtype, path
        np.testing.assert_allclose(got, np.asarray(ref), err_msg=path, **TOL)


def _run_both(updater, clip_norm=None, clip_value=None, steps=5,
              grad_scale=1.0):
    jtx = JU.build_optimizer(updater[0], clip_norm, clip_value)
    ptx = PU.build_optimizer(updater[1], clip_norm, clip_value)
    jp = jax.tree_util.tree_map(jnp.asarray, _params())
    pp = _torch_tree(_params())
    js, ps = jtx.init(jp), ptx.init(pp)
    for step in range(steps):
        g = _grads(step, grad_scale)
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        pu, ps = ptx.update(_torch_tree(g), ps, pp)
        with torch.no_grad():
            PU.apply_updates(pp, pu)
    return (pp, ps), (jax.tree_util.tree_map(np.asarray, jp), _np_state(js))


def _pair(name, **kw):
    return (getattr(JU, name)(**kw), getattr(PU, name)(**kw))


UPDATER_NAMES = sorted({cls.__name__ for cls in PU.UPDATERS.values()})


@pytest.mark.parametrize("name", UPDATER_NAMES)
def test_updater_alone_matches_optax(name):
    (pp, ps), (jp, js) = _run_both(_pair(name))
    _assert_trees_close(pp, jp)
    _assert_trees_close(ps, js)


@pytest.mark.parametrize("name", ["Adam", "AdamW", "Sgd", "Nadam", "Lars"])
@pytest.mark.parametrize("clip_norm,clip_value", [(1.0, None), (None, 0.5),
                                                  (1.0, 0.5), (100.0, None)])
def test_updater_in_clipped_chain_matches_optax(name, clip_norm, clip_value):
    """Gradients of norm ~4 against clip norm 1 (clipping fires) and 100
    (it does not)."""
    (pp, ps), (jp, js) = _run_both(_pair(name), clip_norm, clip_value)
    _assert_trees_close(pp, jp)
    _assert_trees_close(ps, js)


SCHEDULES = [
    ("FixedSchedule", dict(value=0.05)),
    ("StepSchedule", dict(initial=0.1, decay_rate=0.5, step=2)),
    ("ExponentialSchedule", dict(initial=0.1, gamma=0.9)),
    ("InverseSchedule", dict(initial=0.1, gamma=0.5, power=2.0)),
    ("PolySchedule", dict(initial=0.1, power=2.0, max_iter=4)),
    ("SigmoidSchedule", dict(initial=0.1, gamma=0.5, step_size=2)),
    ("WarmupCosineSchedule", dict(peak=0.1, warmup_steps=2, total_steps=5,
                                  end_value=0.01)),
]


@pytest.mark.parametrize("sched,kw", SCHEDULES, ids=[s for s, _ in SCHEDULES])
@pytest.mark.parametrize("upd", ["Sgd", "Adam"])
def test_schedules_match_optax(sched, kw, upd):
    """A schedule runs at its own transformation's count, which the state
    carries (a `count` beside the LR scaling)."""
    pair = (getattr(JU, upd)(schedule=getattr(JU, sched)(**kw)),
            getattr(PU, upd)(schedule=getattr(PU, sched)(**kw)))
    (pp, ps), (jp, js) = _run_both(pair, clip_norm=1.0, steps=6)
    _assert_trees_close(pp, jp)
    _assert_trees_close(ps, js)


def test_slice_chain_state_layout():
    """TransformerLM's optimizer: clip_by_global_norm(1.0) then AdamW(3e-4),
    weight decay on every leaf, in optax's own layout."""
    tx = PU.build_optimizer(PU.AdamW(3e-4), grad_clip_norm=1.0)
    st = tx.init(_torch_tree(_params()))
    assert sorted(st) == ["0", "1"] and st["0"] == {}
    assert sorted(st["1"]) == ["0", "1", "2"]
    assert sorted(st["1"]["0"]) == ["count", "mu", "nu"]
    assert st["1"]["0"]["count"].dtype == torch.int32
    assert st["1"]["1"] == {} and st["1"]["2"] == {}
    assert st["1"]["0"]["mu"]["2"] == {}


def test_every_config_field_round_trips_through_the_serde():
    from deeplearning4j_tpu_torch.nn.conf.base import (
        layer_from_dict, layer_to_dict,
    )
    for cls in PU.UPDATERS.values():
        u = cls(schedule=PU.StepSchedule(0.1, 0.5, 3))
        assert layer_from_dict(layer_to_dict(u)) == u
        assert [f.name for f in dataclasses.fields(cls)] == \
            [f.name for f in dataclasses.fields(getattr(JU, cls.__name__))]


def test_updater_state_bytes_from_flax_load_in_the_port():
    (_, _), (_, js) = _run_both(_pair("AdamW"), clip_norm=1.0)
    tx = JU.build_optimizer(JU.AdamW(), 1.0, None)
    state = tx.init(jax.tree_util.tree_map(jnp.asarray, _params()))
    state = serialization.from_state_dict(state, js)
    data = serialization.to_bytes(state)
    template = PU.build_optimizer(PU.AdamW(), 1.0).init(
        _torch_tree(_params()))
    loaded = port_ser.updater_state_from_bytes(data, template)
    _assert_trees_close(loaded, js)


def test_updater_state_bytes_from_the_port_load_in_flax():
    (_, ps), (_, js) = _run_both(_pair("Adam"), clip_norm=1.0)
    data = port_ser.updater_state_to_bytes(ps)
    target = JU.build_optimizer(JU.Adam(), 1.0, None).init(
        jax.tree_util.tree_map(jnp.asarray, _params()))
    back = serialization.from_bytes(target, data)
    _assert_trees_close(ps, _np_state(back))
    # the same state, written by flax, gives the same bytes
    assert data == serialization.to_bytes(
        serialization.from_state_dict(target, _np_state(back)))


# ------------------------------------------------------------- msgpack
MSGPACK_CASES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
    -1, -32, -33, -128, -129, -2 ** 31, -2 ** 40, 1.5, -0.0, "", "key",
    "x" * 31, "x" * 32, "y" * 300, b"", b"\x00\x01", b"z" * 70000, [],
    [1, "a", None], list(range(20)), {}, {"a": 1, "b": {"c": [1, 2]}},
    {str(i): i for i in range(20)}, (1, (2, 3)),
]


@pytest.mark.parametrize("obj", MSGPACK_CASES,
                         ids=[f"case{i}" for i in range(len(MSGPACK_CASES))])
def test_msgpack_codec_matches_the_msgpack_package(obj):
    """The port's own codec writes what `msgpack.packb(use_bin_type=True)`
    writes, and reads it back."""
    import msgpack
    from deeplearning4j_tpu_torch.util import msgpack as pm
    data = pm.packb(obj)
    assert data == msgpack.packb(obj, use_bin_type=True)
    back = pm.unpackb(data)
    want = msgpack.unpackb(data, raw=False)
    assert back == want


def test_msgpack_ext_types_and_errors():
    import msgpack
    from deeplearning4j_tpu_torch.util import msgpack as pm
    for n in (1, 2, 3, 4, 8, 16, 17, 300, 70000):
        ext = pm.ExtType(5, bytes(range(256)) * (n // 256) + bytes(n % 256))
        data = pm.packb([ext])
        assert data == msgpack.packb([msgpack.ExtType(5, ext.data)])
        assert pm.unpackb(data) == [ext]
        assert pm.unpackb(data, ext_hook=lambda c, d: (c, len(d))) == \
            [(5, n)]
    with pytest.raises(ValueError, match="trailing"):
        pm.unpackb(b"\x01\x02")
    with pytest.raises(ValueError, match="ends inside"):
        pm.unpackb(b"\xa5ab")
    with pytest.raises(TypeError, match="cannot serialize"):
        pm.packb(object())
