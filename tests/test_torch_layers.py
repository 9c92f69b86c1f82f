"""Each ported layer against its JAX counterpart, with the same numpy
parameters and inputs.

Tolerance f32 atol/rtol 1e-5: both compute in f32; XLA on the CPU and
torch sum in other orders and use other transcendental approximations,
which moves results by ~1e-7 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import activations as jax_act
from deeplearning4j_tpu.nn.conf.base import InputType as JInputType
from deeplearning4j_tpu.nn.layers import attention as jax_attn
from deeplearning4j_tpu.nn.layers import recurrent as jax_rec
from deeplearning4j_tpu_torch.nn import activations as port_act
from deeplearning4j_tpu_torch.nn.layers import attention as port_attn
from deeplearning4j_tpu_torch.nn.layers import recurrent as port_rec

TOL = dict(atol=1e-5, rtol=1e-5)


def _params(layer_jax, input_type, seed=0):
    """The JAX layer's parameter tree as numpy, perturbed away from the
    init constants (ones/zeros) so every parameter matters."""
    p, _ = layer_jax.init(jax.random.PRNGKey(seed), input_type)
    rs = np.random.RandomState(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rs.randn(*a.shape).astype("float32"),
        p)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a)),
                                  tree)


def _run_both(jl, pl, params, x, mask=None):
    yj, _ = jl.apply(_to_jax(params), {}, jnp.asarray(x),
                     mask=None if mask is None else jnp.asarray(mask))
    yp, _ = pl.apply(_to_torch(params), {}, torch.from_numpy(x),
                     mask=None if mask is None else torch.from_numpy(mask))
    return yp, yj


def _x(b=2, t=24, f=32, seed=3):
    return np.random.RandomState(seed).randn(b, t, f).astype("float32")


def _mask(b=2, t=24):
    m = np.ones((b, t), np.float32)
    m[0, 17:] = 0.0
    return m


@pytest.mark.parametrize("name", sorted(jax_act.ACTIVATIONS))
def test_activations_elementwise(name):
    x = np.random.RandomState(0).randn(4, 33).astype("float32") * 3
    yj = np.asarray(jax_act.get_activation(name)(jnp.asarray(x)))
    yp = port_act.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yp, yj, **TOL)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form; torch's default is erf. The
    two differ by ~1e-3 near |x| ~ 2, far above the tolerance."""
    x = torch.linspace(-4, 4, 401)
    erf_form = torch.nn.functional.gelu(x)
    assert (port_act.gelu(x) - erf_form).abs().max() > 1e-4
    np.testing.assert_allclose(
        port_act.gelu(x).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()))), **TOL)


def test_layer_norm():
    it = JInputType.recurrent(32, 24)
    params = _params(jax_attn.LayerNormLayer(), it)
    yp, yj = _run_both(jax_attn.LayerNormLayer(), port_attn.LayerNormLayer(),
                       params, _x())
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)


@pytest.mark.parametrize("batched_positions", [False, True])
def test_rope(batched_positions):
    x = np.random.RandomState(1).randn(2, 24, 4, 16).astype("float32")
    pos = np.arange(24)[None] + (np.arange(2)[:, None] * 7
                                 if batched_positions else 0)
    yj = jax_attn.rope(jnp.asarray(x), jnp.asarray(pos))
    yp = port_attn.rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_dot_product_attention(causal, masked):
    rs = np.random.RandomState(2)
    q, k, v = (rs.randn(2, 24, 4, 8).astype("float32") for _ in range(3))
    mask = _mask() if masked else None
    if masked:
        mask[1, :] = 0.0                 # a fully-masked batch row -> zeros
    yj = jax_attn.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal,
        mask=None if mask is None else jnp.asarray(mask))
    yp = port_attn.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal,
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)


@pytest.mark.parametrize("q_offset", [1, 9, 16])
def test_dot_product_attention_causal_q_offset(q_offset):
    """The decode engine's chunk path: queries at absolute positions
    q_offset.. attend a longer key sequence causally, with no mask."""
    rs = np.random.RandomState(5)
    q = rs.randn(2, 8, 4, 8).astype("float32")
    k, v = (rs.randn(2, 24, 4, 8).astype("float32") for _ in range(2))
    yj = jax_attn.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                        causal=True, q_offset=q_offset)
    yp = port_attn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                         causal=True, q_offset=q_offset)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)


@pytest.mark.parametrize("impl", ["dense", "flash", "blockwise"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention(impl, causal, masked):
    kw = dict(n_out=32, n_heads=4, causal=causal, attention_impl=impl,
              block_size=16, has_bias=impl == "blockwise")
    jl, pl = jax_attn.MultiHeadAttention(**kw), port_attn.MultiHeadAttention(**kw)
    params = _params(jl, JInputType.recurrent(32, 24))
    yp, yj = _run_both(jl, pl, params, _x(), _mask() if masked else None)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_transformer_block(impl):
    """Pins the tanh-gelu trap: an erf gelu in the MLP would miss by
    ~1e-3."""
    kw = dict(n_out=32, n_heads=4, mlp_ratio=2, attention_impl=impl,
              block_size=16)
    jl, pl = jax_attn.TransformerBlock(**kw), port_attn.TransformerBlock(**kw)
    params = _params(jl, JInputType.recurrent(32, 24))
    yp, yj = _run_both(jl, pl, params, _x(), _mask())
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)


def test_moe_feed_forward():
    kw = dict(n_out=32, n_experts=4, top_k=2, mlp_ratio=2)
    jl, pl = jax_attn.MoEFeedForward(**kw), port_attn.MoEFeedForward(**kw)
    params = _params(jl, JInputType.recurrent(32, 24))
    yp, yj = _run_both(jl, pl, params, _x(), _mask())
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)


def test_embedding_sequence_layer():
    kw = dict(n_out=16, n_in=50)
    jl, pl = (jax_attn.EmbeddingSequenceLayer(**kw),
              port_attn.EmbeddingSequenceLayer(**kw))
    params = _params(jl, JInputType.recurrent(1, 24))
    ids = np.random.RandomState(4).randint(0, 50, (2, 24, 1)) \
        .astype("float32")
    yp, yj = _run_both(jl, pl, params, ids, _mask())
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
    with pytest.raises(ValueError, match="token ids"):
        pl.apply(_to_torch(params), {}, torch.full((1, 3, 1), 50.0))


def test_positional_embedding_layer():
    jl = jax_attn.PositionalEmbeddingLayer(max_length=40)
    pl = port_attn.PositionalEmbeddingLayer(max_length=40)
    params = _params(jl, JInputType.recurrent(32, 24))
    yp, yj = _run_both(jl, pl, params, _x())
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
    with pytest.raises(ValueError, match="max_length"):
        pl.apply(_to_torch(params), {}, torch.zeros(1, 41, 32))


@pytest.mark.parametrize("activation", ["softmax", "identity"])
def test_rnn_output_layer(activation):
    kw = dict(n_out=20, activation=activation)
    jl, pl = jax_rec.RnnOutputLayer(**kw), port_rec.RnnOutputLayer(**kw)
    params = _params(jl, JInputType.recurrent(32, 24))
    yp, yj = _run_both(jl, pl, params, _x())
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)


@pytest.mark.parametrize("layer", [
    port_attn.LayerNormLayer(), port_attn.MultiHeadAttention(n_out=32, n_heads=4),
    port_attn.TransformerBlock(n_out=32, n_heads=4),
    port_attn.EmbeddingSequenceLayer(n_out=32, n_in=50),
    port_attn.PositionalEmbeddingLayer(max_length=24),
    port_rec.RnnOutputLayer(n_out=20),
], ids=lambda l: type(l).__name__)
def test_init_tree_matches_reference(layer):
    """Same keys, shapes and dtypes as the JAX layer's init: a checkpoint
    moves between the packages with no transposes."""
    jcls = getattr(jax_attn, type(layer).__name__, None) or \
        getattr(jax_rec, type(layer).__name__)
    import dataclasses
    jl = jcls(**{f.name: getattr(layer, f.name)
                 for f in dataclasses.fields(layer)})
    f = 1 if type(layer).__name__ == "EmbeddingSequenceLayer" else 32
    pj, _ = jl.init(jax.random.PRNGKey(0), JInputType.recurrent(f, 24))
    pp, _ = layer.init(torch.Generator().manual_seed(0),
                       port_attn.InputType.recurrent(f, 24))
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): a.shape
              for path, a in jax.tree_util.tree_flatten_with_path(pj)[0]}
    flat_p = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(a.shape)
              for path, a in jax.tree_util.tree_flatten_with_path(
                  jax.tree_util.tree_map(lambda t: t.numpy(), pp))[0]}
    assert flat_p == {k: tuple(v) for k, v in flat_j.items()}
