"""Ring attention (`parallel/ring.py`) against the reference's.

Global (B, T, H, D) inputs made from a seed with numpy go through the
reference's `make_ring_attention` (its `ring_self_attention` under
`shard_map` over data x seq of the conftest's 8 CPU devices) and through
the port's over a gloo group of spawned ranks (`tests/_torch_dist`):
the online ring (`make_ring_attention`) and the flash ring
(`ring_flash_self_attention`: the flash forward per shard pair with its
LSE, merged by the LSE rule; the plain versions on the CPU), causal,
masked and both, with fully masked rows. Forward within atol 2e-5 and
the gradients of sum(out * w) within 5e-4, the reference's own
tolerances; in f64 the port's gradientcheck holds the ring's analytic
gradient to central differences. `blockwise_attention` is held to the
reference's on one process. The rotation's counters name the route and
the bytes.
"""
import numpy as np
import pytest
import torch

from _torch_dist import RankPool


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def inputs(b=2, t=32, h=2, d=8, seed=0, dtype="float32", dead_row=True):
    rs = np.random.RandomState(seed)
    q, k, v, w = (rs.randn(b, t, h, d).astype(dtype) for _ in range(4))
    mask = (rs.rand(b, t) > 0.3).astype(dtype)
    if dead_row:
        # the first keys of row 1 masked: its first queries see no key
        # under causality, and whole shards of it are masked
        mask[1, :3] = 0.0
        mask[1, 8:16] = 0.0
    return q, k, v, w, mask


def reference(q, k, v, w, mask, data, seq, causal):
    """The reference ring's output and the gradients of sum(out * w)."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.parallel import (
        MeshConfig, build_mesh, make_ring_attention,
    )
    mesh = build_mesh(MeshConfig(data=data, seq=seq),
                      devices=jax.devices()[:data * seq])
    attend = make_ring_attention(mesh, causal=causal)
    m = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        return jnp.sum(attend(q, k, v, m) * w)

    out = np.asarray(jax.jit(lambda q, k, v: attend(q, k, v, m))(q, k, v))
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return out, [np.asarray(g) for g in grads]


CASES = [("causal", True, False), ("masked", False, True),
         ("causal_masked", True, True)]
MESHES = [("seq2", 1, 2), ("seq4", 1, 4), ("dp2_seq2", 2, 2)]


@pytest.mark.parametrize("impl", ["online", "flash"])
@pytest.mark.parametrize("mname,data,seq", MESHES, ids=[m[0] for m in MESHES])
@pytest.mark.parametrize("cname,causal,masked", CASES,
                         ids=[c[0] for c in CASES])
def test_ring_matches_the_reference(pool, cname, causal, masked, mname,
                                    data, seq, impl):
    q, k, v, w, mask = inputs(seed=seq + 3 * causal)
    mask = mask if masked else None
    ref_out, ref_grads = reference(q, k, v, w, mask, data, seq, causal)
    out = pool.run("ring_attention", data * seq, data=data, seq=seq, q=q,
                   k=k, v=v, w=w, mask=mask, causal=causal, impl=impl)
    for o in out:
        np.testing.assert_allclose(o["out"], ref_out, atol=2e-5)
        for g, rg in zip(o["grads"], ref_grads):
            np.testing.assert_allclose(g, rg, atol=5e-4, rtol=5e-4)
    # the ring shifts K, V (and the mask) S - 1 times forward and the
    # cotangents of K and V S - 1 times back, CPU tensors through gloo
    tr = out[0]["transfers"]
    assert tr["shifts"] == 2 * (seq - 1) and tr["routes"] == {
        "gloo": 2 * (seq - 1)}
    shard = q.nbytes // seq
    fwd = 2 * shard + (0 if mask is None else mask.nbytes // seq)
    assert tr["bytes"] == (seq - 1) * (fwd + 2 * shard)
    if impl == "online":
        assert out[0]["metrics"]["ring_attention_calls_total"] == 1
        assert out[0]["metrics"]["ring_bytes_rotated_total"] == \
            (seq - 1) * fwd


def test_a_fully_masked_row_is_zero_in_both_rings(pool):
    """Rows with no live key anywhere give 0 in the port's online and
    flash rings, as in dense attention and the reference's online ring."""
    q, k, v, w, mask = inputs(seed=9)
    mask[0, :] = 0.0
    mask[1, :16] = 0.0
    ref_out, _ = reference(q, k, v, w, mask, 1, 2, True)
    assert np.abs(ref_out[0]).max() == 0.0
    assert np.abs(ref_out[1, :16]).max() == 0.0
    for impl in ("online", "flash"):
        out = pool.run("ring_attention", 2, data=1, seq=2, q=q, k=k, v=v,
                       w=w, mask=mask, causal=True, impl=impl)
        np.testing.assert_array_equal(out[0]["out"][0], 0.0)
        np.testing.assert_array_equal(out[0]["out"][1, :16], 0.0)
        np.testing.assert_allclose(out[0]["out"], ref_out, atol=2e-5)


@pytest.mark.parametrize("causal,masked", [(True, False), (True, True)],
                         ids=["causal", "causal_masked"])
def test_ring_gradient_check_f64(pool, causal, masked):
    """f64 central differences through the port's gradientcheck over q
    of the ring on four ranks (the reference's test_gc_ring_attention_fd
    holds its ring the same way)."""
    rs = np.random.RandomState(4)
    q, k, v, w = (rs.rand(1, 16, 2, 4) for _ in range(4))
    mask = (rs.rand(1, 16) > 0.25).astype("float64") if masked else None
    out = pool.run("ring_gradcheck", 4, seq=4, q=q, k=k, v=v, w=w,
                   mask=mask, causal=causal)
    for o in out:
        assert o["passed"] and o["checked"] == 24, o
        assert o["max_rel_error"] < 1e-6


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)],
                         ids=["causal", "masked"])
def test_blockwise_matches_the_reference(causal, masked):
    import jax.numpy as jnp

    from deeplearning4j_tpu.parallel import blockwise_attention as jblock
    from deeplearning4j_tpu_torch.parallel import blockwise_attention
    q, k, v, w, mask = inputs(seed=2)
    mask = mask if masked else None
    ref = np.asarray(jblock(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            block_size=8, causal=causal,
                            mask=None if mask is None else jnp.asarray(mask)))
    got = blockwise_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), block_size=8, causal=causal,
                              mask=None if mask is None
                              else torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    with pytest.raises(ValueError, match="not divisible by block"):
        blockwise_attention(torch.tensor(q), torch.tensor(k),
                            torch.tensor(v), block_size=5)


def test_blockwise_dropout_keeps_the_denominator():
    """Attention dropout in the online block drops numerator terms only:
    with every key kept (p -> 0) it is the plain accumulation, and its
    draws come from the generator given."""
    from deeplearning4j_tpu_torch.parallel import blockwise_attention
    q, k, v, _, _ = (torch.tensor(a) for a in inputs(seed=5))
    plain = blockwise_attention(q, k, v, block_size=8)
    g = torch.Generator().manual_seed(0)
    kept = blockwise_attention(q, k, v, block_size=8, dropout=1e-9,
                               generator=g)
    torch.testing.assert_close(kept, plain, rtol=0, atol=1e-6)
    a = blockwise_attention(q, k, v, block_size=8, dropout=0.5,
                            generator=torch.Generator().manual_seed(1))
    b = blockwise_attention(q, k, v, block_size=8, dropout=0.5,
                            generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, plain)


def test_a_ring_of_one_rank_shifts_nothing():
    """Without a process group the ring is one rank: the online and flash
    rings are dense attention, and nothing is sent."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        dot_product_attention,
    )
    from deeplearning4j_tpu_torch.parallel import ring as R
    q, k, v, _, mask = (torch.tensor(a) for a in inputs(seed=6))
    R.reset_transfers()
    one = R.Ring(None, 0, 1)
    dense = dot_product_attention(q, k, v, mask=mask, causal=True)
    for fn in (R.ring_self_attention, R.ring_flash_self_attention):
        torch.testing.assert_close(fn(q, k, v, ring=one, causal=True,
                                      mask=mask), dense, rtol=0, atol=2e-5)
    assert R.TRANSFERS["shifts"] == 0
    with pytest.raises(ValueError, match="no ring"):
        R.ring_self_attention(q, k, v)
