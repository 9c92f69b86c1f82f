"""The port's recurrent layers against the JAX package's, on the CPU.

The same numpy parameters (the reference's init, perturbed) and inputs go
through each JAX layer and its port: outputs and final carries, masked
(a valid prefix, a valid suffix and a fully masked row) and unmasked,
within 1e-5 (f32); the gradients of sum(y * g) with respect to every
parameter within 1e-5 of each leaf's largest |gradient|. Then the
stateful entry points: `rnn_step` stepped along a sequence equals the
full forward and the reference's steps, `apply_seq` in two chunks equals
one pass, and the wrappers (Bidirectional with a LastTimeStep inside,
MaskZeroLayer, FrozenLayerWrapper, SameDiffLayer) and the configs'
JSON.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.base import InputType as JIT
from deeplearning4j_tpu.nn.conf.base import layer_to_dict as j_to_dict
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.layers import samediff as jsd
from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, layer_from_dict, layer_to_dict,
)
from deeplearning4j_tpu_torch.nn.layers import recurrent as prec
from deeplearning4j_tpu_torch.nn.layers import samediff as psd

from _torch_parity import perturbed, to_torch

TOL = dict(atol=1e-5, rtol=0)
B, T, F, H = 3, 7, 4, 5
JTYPE = JIT.recurrent(F, T)
PTYPE = InputType.recurrent(F, T)


def _x(seed=0, t=T):
    return np.random.RandomState(seed).randn(B, t, F).astype(np.float32)


def _masks():
    m = np.ones((B, T), np.float32)
    m[0, 4:] = 0                 # a valid prefix
    m[1, :3] = 0                 # a valid suffix
    m[2, :] = 0                  # a fully masked row
    return {"unmasked": None, "masked": m}


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


def _grads_close(port_grads, ref_grads):
    """Each leaf within 1e-5 of its largest |gradient|."""
    assert len(port_grads) == len(ref_grads)
    for p, r in zip(port_grads, ref_grads):
        r = np.asarray(r)
        p = np.zeros_like(r) if p is None else p.numpy()
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(p - r).max()) <= 1e-5 * scale, (
            float(np.abs(p - r).max()), scale)


def _both(jl, pl, params, x, mask, seq, seed=9):
    """Forward (and final carry with `seq`) of both layers, and the
    gradients of sum(y * g) + sum(carry * g') with respect to the
    parameters."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)

    def jfwd(p, xx):
        if seq:
            return jl.apply_seq(p, xx, None, mask=jm)
        return jl.apply(p, {}, xx, mask=jm)[0], ()

    jy, jc = jax.jit(jfwd)(jp, jnp.asarray(x))
    rs = np.random.RandomState(seed)
    g = rs.randn(*jy.shape).astype(np.float32)
    gc = [rs.randn(*c.shape).astype(np.float32)
          for c in jax.tree_util.tree_leaves(jc)]

    def jloss(p):
        y, c = jfwd(p, jnp.asarray(x))
        return (y * g).sum() + sum((a * b).sum() for a, b in
                                   zip(jax.tree_util.tree_leaves(c), gc))

    jgrads = jax.tree_util.tree_leaves(jax.jit(jax.grad(jloss))(jp))
    tp = to_torch(params, grad=True)
    if seq:
        y, c = pl.apply_seq(tp, torch.from_numpy(x), None, mask=tm)
    else:
        y, c = pl.apply(tp, {}, torch.from_numpy(x), mask=tm)[0], ()
    carries = list(c) if isinstance(c, tuple) else [c]
    loss = (y * torch.from_numpy(g)).sum() + sum(
        (a * torch.from_numpy(b)).sum() for a, b in zip(carries, gc))
    leaves = jax.tree_util.tree_leaves(tp)
    pgrads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return (y, carries, pgrads), (jy, jax.tree_util.tree_leaves(jc), jgrads)


RECURRENT = {
    "LSTM": lambda m: m.LSTM(n_out=H),
    "LSTM_hardsigmoid_fgb3": lambda m: m.LSTM(
        n_out=H, gate_activation="hardsigmoid", forget_gate_bias_init=3.0),
    "GravesLSTM": lambda m: m.GravesLSTM(n_out=H, activation="softsign"),
    "SimpleRnn": lambda m: m.SimpleRnn(n_out=H),
    "GRU_reset_after": lambda m: m.GRU(n_out=H),
    "GRU_classic": lambda m: m.GRU(n_out=H, reset_after=False),
}


@pytest.mark.parametrize("mask_kind", ["unmasked", "masked"])
@pytest.mark.parametrize("name", sorted(RECURRENT))
def test_recurrent_layer_output_carry_and_gradients(name, mask_kind):
    jl, pl = RECURRENT[name](jrec), RECURRENT[name](prec)
    params, _ = perturbed(jl, JTYPE)
    mask = _masks()[mask_kind]
    (y, c, pg), (jy, jc, jg) = _both(jl, pl, params, _x(), mask, seq=True)
    _close(y, jy)
    assert len(c) == len(jc)
    for a, b in zip(c, jc):
        _close(a, b)
    _grads_close(pg, jg)
    if mask is not None:
        # masked steps output zeros and zero the state: the final carry of
        # a row whose tail is masked is zero
        assert float(y[0, 4:].detach().abs().max()) == 0.0
        assert all(float(a[0].detach().abs().max()) == 0.0 for a in c)


def test_init_shapes_and_forget_gate_bias():
    for name, make in RECURRENT.items():
        jp, _ = make(jrec).init(jax.random.PRNGKey(0), JTYPE)
        pp, _ = make(prec).init(torch.Generator().manual_seed(0), PTYPE)
        assert jax.tree_util.tree_structure(jp) == \
            jax.tree_util.tree_structure(jax.tree_util.tree_map(
                lambda t: 0, pp, is_leaf=lambda t: isinstance(
                    t, torch.Tensor)))
        for a, b in zip(jax.tree_util.tree_leaves(pp),
                        jax.tree_util.tree_leaves(jp)):
            assert tuple(a.shape) == b.shape
    lstm, _ = prec.LSTM(n_out=H, forget_gate_bias_init=2.5).init(
        torch.Generator().manual_seed(0), PTYPE)
    assert torch.equal(lstm["b"][H:2 * H], torch.full((H,), 2.5))
    assert float(lstm["b"][:H].abs().max()) == 0.0
    graves, _ = prec.GravesLSTM(n_out=H).init(
        torch.Generator().manual_seed(0), PTYPE)
    assert sorted(graves) == ["R", "W", "b", "pf", "pi", "po"]
    gru, _ = prec.GRU(n_out=H).init(torch.Generator().manual_seed(0), PTYPE)
    assert tuple(gru["b"].shape) == (2, 3 * H)


@pytest.mark.parametrize("name", ["LSTM", "GravesLSTM", "SimpleRnn",
                                  "GRU_reset_after", "GRU_classic"])
def test_rnn_step_matches_full_forward_and_the_reference(name):
    """Streaming one step at a time reproduces the full forward
    (tests/test_layers.py:148) and the reference's own steps."""
    jl, pl = RECURRENT[name](jrec), RECURRENT[name](prec)
    params, _ = perturbed(jl, JTYPE)
    x = _x(3)
    tp = to_torch(params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    full, _ = pl.apply(tp, {}, torch.from_numpy(x))
    carry, jcarry = None, None
    for t in range(T):
        out, carry = pl.rnn_step(tp, torch.from_numpy(x[:, t]), carry)
        jout, jcarry = jl.rnn_step(jp, jnp.asarray(x[:, t]), jcarry)
        _close(out, full[:, t].detach().numpy())
        _close(out, jout)


@pytest.mark.parametrize("name", ["LSTM", "GravesLSTM", "SimpleRnn",
                                  "GRU_reset_after"])
def test_apply_seq_in_chunks_equals_one_pass(name):
    """tbptt's primitive: two chunks from the carried state equal the
    unchunked forward (tests/test_layers.py:162)."""
    pl = RECURRENT[name](prec)
    params, _ = perturbed(RECURRENT[name](jrec), JTYPE)
    tp = to_torch(params)
    x = torch.from_numpy(_x(4))
    full, _ = pl.apply(tp, {}, x)
    y1, carry = pl.apply_seq(tp, x[:, :3], None)
    y2, _ = pl.apply_seq(tp, x[:, 3:], carry)
    torch.testing.assert_close(torch.cat([y1, y2], 1), full, atol=1e-6,
                               rtol=0)


BIDIRECTIONAL = {
    "concat": lambda m: m.Bidirectional(layer=m.LSTM(n_out=H)),
    "add": lambda m: m.Bidirectional(layer=m.GRU(n_out=H), mode="add"),
    "mul": lambda m: m.Bidirectional(layer=m.SimpleRnn(n_out=H),
                                     mode="mul"),
    "ave": lambda m: m.Bidirectional(layer=m.GravesLSTM(n_out=H),
                                     mode="ave"),
    "graves": lambda m: m.GravesBidirectionalLSTM(n_out=H),
    "last_time_step_inside": lambda m: m.Bidirectional(
        layer=m.LastTimeStep(layer=m.LSTM(n_out=H))),
}


@pytest.mark.parametrize("mask_kind", ["unmasked", "masked"])
@pytest.mark.parametrize("name", sorted(BIDIRECTIONAL))
def test_bidirectional(name, mask_kind):
    """The time flip, the mask flip, the rank-2 backward output of a
    LastTimeStep inside, and the four combine modes."""
    jl, pl = BIDIRECTIONAL[name](jrec), BIDIRECTIONAL[name](prec)
    params, _ = perturbed(jl, JTYPE)
    (y, _, pg), (jy, _, jg) = _both(jl, pl, params, _x(5),
                                    _masks()[mask_kind], seq=False)
    _close(y, jy)
    _grads_close(pg, jg)
    assert pl.output_type(PTYPE).to_dict() == \
        jl.output_type(JTYPE).to_dict()


WRAPPERS = {
    "last_time_step": lambda m: m.LastTimeStep(layer=m.LSTM(n_out=H)),
    "last_time_step_gru": lambda m: m.LastTimeStep(layer=m.GRU(n_out=H)),
    "mask_zero": lambda m: m.MaskZeroLayer(layer=m.LSTM(n_out=H)),
    "rnn_output": lambda m: m.RnnOutputLayer(n_out=3),
}


@pytest.mark.parametrize("mask_kind", ["unmasked", "masked"])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_time_distributed_and_wrapping_layers(name, mask_kind):
    """LastTimeStep takes the argmax of mask·(t+1) (a valid suffix works;
    a fully masked row takes step 0 in both frameworks); MaskZeroLayer
    masks the all-`mask_value` steps on top of the given mask."""
    jl, pl = WRAPPERS[name](jrec), WRAPPERS[name](prec)
    params, _ = perturbed(jl, JTYPE)
    x = _x(6)
    x[0, 2] = 0.0                       # a zero step for MaskZeroLayer
    x[1, 5] = 0.0
    (y, _, pg), (jy, _, jg) = _both(jl, pl, params, x, _masks()[mask_kind],
                                    seq=False)
    _close(y, jy)
    _grads_close(pg, jg)


def test_last_time_step_picks_the_last_unmasked_step():
    pl = prec.LastTimeStep(layer=prec.SimpleRnn(n_out=H))
    params, _ = perturbed(jrec.SimpleRnn(n_out=H), JTYPE)
    tp = to_torch(params)
    x = torch.from_numpy(_x(7))
    m = _masks()["masked"]
    full, _ = prec.SimpleRnn(n_out=H).apply(tp, {}, x,
                                            mask=torch.from_numpy(m))
    y, _ = pl.apply(tp, {}, x, mask=torch.from_numpy(m))
    torch.testing.assert_close(y[0], full[0, 3])     # last of the prefix
    torch.testing.assert_close(y[1], full[1, T - 1])  # a valid suffix
    torch.testing.assert_close(y[2], full[2, 0])     # all masked: step 0


@pytest.mark.parametrize("mask_kind", ["unmasked", "masked"])
def test_rnn_loss_layer_score(mask_kind):
    jl, pl = jrec.RnnLossLayer(loss="mse"), prec.RnnLossLayer(loss="mse")
    rs = np.random.RandomState(8)
    x = rs.randn(B, T, 3).astype(np.float32)
    labels = rs.randn(B, T, 3).astype(np.float32)
    mask = _masks()[mask_kind]
    js = jl.score({}, jnp.asarray(x), jnp.asarray(labels),
                  mask=None if mask is None else jnp.asarray(mask))
    tx = torch.from_numpy(x).requires_grad_(True)
    ps = pl.score({}, tx, torch.from_numpy(labels),
                  mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(ps.detach()), float(js), rtol=1e-6)
    jgx = jax.grad(lambda xx: jl.score(
        {}, xx, jnp.asarray(labels),
        mask=None if mask is None else jnp.asarray(mask)))(jnp.asarray(x))
    (gx,) = torch.autograd.grad(ps, [tx])
    _close(gx, jgx)
    assert not pl.has_params()
    _close(pl.apply({}, {}, tx)[0], jl.apply({}, {}, jnp.asarray(x))[0])


def test_frozen_layer_wrapper_detaches_and_delegates():
    inner = prec.LSTM(n_out=H)
    frozen = psd.FrozenLayerWrapper(layer=inner)
    params, _ = perturbed(jrec.LSTM(n_out=H), JTYPE)
    tp = to_torch(params, grad=True)
    x = torch.from_numpy(_x(9))
    y, _ = frozen.apply(tp, {}, x, train=True)
    torch.testing.assert_close(y, inner.apply(tp, {}, x)[0])
    assert not y.requires_grad                  # no gradient reaches W
    ys, carry = frozen.apply_seq(tp, x, None)
    torch.testing.assert_close(ys, y)
    out, _ = frozen.rnn_step(tp, x[:, 0], None)
    torch.testing.assert_close(out, y[:, 0])
    assert frozen.n_out == H and frozen.gate_activation == "sigmoid"
    assert frozen.output_type(PTYPE).shape == (T, H)
    head = psd.FrozenLayerWrapper(layer=prec.RnnOutputLayer(n_out=2))
    assert hasattr(head, "score") and not hasattr(frozen, "score")
    with pytest.raises(AttributeError):
        psd.FrozenLayerWrapper().n_out


def _sd_params_np(seed=0):
    rs = np.random.RandomState(seed)
    return {"W": rs.randn(F, 6).astype(np.float32),
            "b": rs.randn(6).astype(np.float32)}


def test_same_diff_layer_matches_the_reference():
    """A custom layer from plain functions in each framework: the same
    forward and gradients (autodiff is the backward on both sides)."""
    jl = jsd.SameDiffLayer(
        define_params=lambda k, it, dt: jax.tree_util.tree_map(
            jnp.asarray, _sd_params_np()),
        forward=lambda p, x, train: jnp.tanh(x @ p["W"] + p["b"]),
        out_type=lambda it: JIT(it.kind, (it.shape[0], 6)))
    pl = psd.SameDiffLayer(
        define_params=lambda g, it, dt: to_torch(_sd_params_np()),
        forward=lambda p, x, train: torch.tanh(x @ p["W"] + p["b"]),
        out_type=lambda it: InputType(it.kind, (it.shape[0], 6)))
    assert pl.output_type(PTYPE).shape == (T, 6)
    pp, _ = pl.init(None, PTYPE)
    jp, _ = jl.init(None, JTYPE)
    (y, _, pg), (jy, _, jg) = _both(jl, pl, jax.tree_util.tree_map(
        np.asarray, jp), _x(10), None, seq=False)
    _close(y, jy)
    _grads_close(pg, jg)
    assert psd.SameDiffLayer().init(None, PTYPE) == ({}, {})


@pytest.mark.parametrize("name", sorted(RECURRENT) + sorted(BIDIRECTIONAL)
                         + sorted(WRAPPERS) + ["rnn_loss", "frozen"])
def test_config_json_is_the_reference_json(name):
    """Each config serializes to the reference's dict and reads back."""
    make = {**RECURRENT, **BIDIRECTIONAL, **WRAPPERS,
            "rnn_loss": lambda m: m.RnnLossLayer(loss="mse"),
            "frozen": None}[name]
    if make is None:
        jl = jsd.FrozenLayerWrapper(layer=jrec.GravesLSTM(n_out=H))
        pl = psd.FrozenLayerWrapper(layer=prec.GravesLSTM(n_out=H))
    else:
        jl, pl = make(jrec), make(prec)
    d = layer_to_dict(pl)
    assert d == j_to_dict(jl)
    assert layer_from_dict(d) == pl
