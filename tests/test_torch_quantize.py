"""The port's serving/quantize.py against the JAX package's.

`quantize_leaf` must give the reference's int8 q bit for bit (both round
half to even) and its scale exactly; `qdot`/`qtake` agree within 1e-6 of
the output's magnitude (an f32 matmul summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import (
    TransformerLMMoE as JaxLMMoE,
)
from deeplearning4j_tpu.serving import quantize as jq
from deeplearning4j_tpu_torch.models.zoo import model_by_name
from deeplearning4j_tpu_torch.serving import quantize as pq
from deeplearning4j_tpu_torch.serving.decode import DecodeConfig, DecodeEngine


def _weights():
    rs = np.random.RandomState(0)
    w = (0.05 * rs.randn(64, 48)).astype(np.float32)
    w[:, 3] = 0.0                                   # amax 0 -> 1e-12 scale
    # a column whose scale is exactly 1: x.5 values round half to even
    w[:, 7] = 0.0
    w[:8, 7] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5]
    stacked = (0.1 * rs.randn(4, 16, 8)).astype(np.float32)   # per expert
    return w, stacked


@pytest.mark.parametrize("which", [0, 1])
def test_quantize_leaf_is_bitwise_the_reference(which):
    w = _weights()[which]
    ref = jq.quantize_leaf(jnp.asarray(w))
    got = pq.quantize_leaf(torch.from_numpy(w))
    assert isinstance(got, pq.QTensor) and got.q.dtype == torch.int8
    assert got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    if which == 0:
        assert got.q[:8, 7].tolist() == [127, 0, 2, 2, 0, -2, 126, -4]
    np.testing.assert_array_equal(got.dequant().numpy(),
                                  np.asarray(ref.dequant()))
    with pytest.raises(ValueError):
        pq.quantize_leaf(torch.zeros(5))


def test_qdot_and_qtake_match_reference():
    w, _ = _weights()
    rs = np.random.RandomState(1)
    x = rs.randn(3, 5, 64).astype(np.float32)
    jw, pw = jq.quantize_leaf(jnp.asarray(w)), pq.quantize_leaf(
        torch.from_numpy(w))
    ref = np.asarray(jq.qdot(jnp.asarray(x), jw))
    got = pq.qdot(torch.from_numpy(x), pw).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    # a plain float weight is a plain product
    np.testing.assert_allclose(
        pq.qdot(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jq.qdot(jnp.asarray(x), jnp.asarray(w))), rtol=0,
        atol=1e-6 * np.abs(ref).max())
    idx = rs.randint(0, 64, (2, 7))
    np.testing.assert_allclose(
        pq.qtake(pw, torch.from_numpy(idx)).numpy(),
        np.asarray(jq.qtake(jw, jnp.asarray(idx))), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        pq.qtake(torch.from_numpy(w), torch.from_numpy(idx)).numpy(),
        np.asarray(jq.qtake(jnp.asarray(w), jnp.asarray(idx))))


@pytest.mark.parametrize("source", [
    "zoo:TransformerLM?n_layers=2@int8", "zoo:TransformerLM@bf16",
    "ckpt.zip", "ckpt@spec", "ckpt@spec:draft=int8,k=4",
    "ckpt@spec:draft=zoo:TransformerLM@int8,k=2", "a@b@bf16", "x@fp4",
    "@int8"])
def test_parse_variant_matches_reference(source):
    assert pq.parse_variant(source) == jq.parse_variant(source)
    assert pq.is_spec_variant(pq.parse_variant(source)[1]) == \
        jq.is_spec_variant(jq.parse_variant(source)[1])


def _paths(tree, pred, prefix=()):
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _paths(v, pred, prefix + (k,))
        elif pred(v):
            out.add("/".join(prefix + (k,)))
    return out


def test_quantize_params_leaf_set_matches_reference():
    """int8 quantizes the same leaves (attention projections, MLP
    matrices, embedding table, head W) and nothing of the MoE or layer
    norms; bf16 casts every float leaf; the input tree is untouched."""
    kw = dict(vocab_size=32, seq_length=16, n_layers=2, n_embd=32,
              n_heads=4, mlp_ratio=2)
    jparams = JaxLMMoE(**kw).init().params
    pparams = model_by_name("TransformerLMMoE", **kw).init(
        device="cpu").params
    jq8 = jq.quantize_params(jparams, "int8")
    pq8 = pq.quantize_params(pparams, "int8")
    want = _paths(jq8, lambda v: isinstance(v, jq.QTensor))
    got = _paths(pq8, lambda v: isinstance(v, pq.QTensor))
    assert got == want and len(got) == 2 * 6 + 2
    assert not _paths(pparams, lambda v: isinstance(v, pq.QTensor))
    b16 = pq.quantize_params(pparams, "bf16")
    assert _paths(b16, lambda v: v.dtype == torch.bfloat16) == \
        _paths(pparams, lambda v: v.is_floating_point())
    # the cast rounds to nearest even, as the reference's
    w = pparams["1"]["W1"]
    np.testing.assert_array_equal(
        b16["1"]["W1"].float().numpy(),
        np.asarray(jnp.asarray(w.numpy()).astype(jnp.bfloat16)
                   .astype(jnp.float32)))
    assert pq.quantize_params(pparams, None) is pparams
    with pytest.raises(ValueError, match="unknown quantize mode"):
        pq.quantize_params(pparams, "fp4")


def test_quality_delta_matches_reference_on_the_same_engines():
    """The reference's quality_delta only calls logits_full: run it and
    the port's over the port's own base and int8 engines — same keys,
    same numbers."""
    net = model_by_name("TransformerLM", vocab_size=32, seq_length=16,
                        n_layers=1, n_embd=32, n_heads=4).init(device="cpu")
    base = DecodeEngine(net, DecodeConfig(slots=1, page_size=8))
    i8 = DecodeEngine(net, DecodeConfig(slots=1, page_size=8,
                                        quantize="int8"))
    toks = np.random.RandomState(3).randint(0, 32, (3, 12))
    got = pq.quality_delta(base, i8, toks)
    assert got == jq.quality_delta(base, i8, toks)
    assert set(got) == {"ppl_base", "ppl_variant", "ppl_delta_pct",
                        "logit_mae"}
    assert np.isfinite(got["ppl_variant"]) and got["logit_mae"] > 0
    assert abs(got["ppl_delta_pct"]) < 25.0
    lp = np.random.RandomState(4).randn(2, 6, 32)
    ids = np.random.RandomState(5).randint(0, 32, (2, 6))
    assert pq.perplexity_from_logits(lp, ids) == \
        jq.perplexity_from_logits(lp, ids)
