"""The port's gradient encoders (`parallel/encoding.py`) against the
reference's.

On the same seeded inputs (ties included) the sign, exact-value and
bitmap encoders give bitwise the reference's messages and residuals, the
decoders its dense updates, and `EncodingHandler` (adaptive threshold,
residual carry) the same message, residual and threshold at every step.
The magnitude-scaled variant sends the same indices and signs; its scale
(a mean over the selected values) agrees within 1e-6 relative, the sum
order being the only difference.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.parallel import encoding as J
from deeplearning4j_tpu_torch.parallel import encoding as T


def _grads(seed, n=1000, ties=False):
    rs = np.random.RandomState(seed)
    g = (rs.randn(n) * 1e-3).astype(np.float32)
    if ties:        # equal magnitudes: the tie-break must be the index
        g[::7] = np.float32(2e-3)
        g[3::11] = np.float32(-2e-3)
    return g


def _same(a, b):
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    a = np.asarray(a)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.astype(b.dtype), b)


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
@pytest.mark.parametrize("fn", ["threshold_encode",
                                "threshold_encode_values"])
def test_sparse_encoders_are_bitwise_the_references(fn, seed, ties):
    g = _grads(seed, ties=ties)
    for cap in (40, None, 2000):
        ours = getattr(T, fn)(torch.from_numpy(g), 1e-3, cap)
        theirs = getattr(J, fn)(jnp.asarray(g), 1e-3, cap)
        for a, b in zip(theirs, ours):
            _same(a, b)


def test_scaled_encoder_and_decoders():
    g = _grads(3, ties=True)
    idx, signs, scale, res = T.threshold_encode_scaled(
        torch.from_numpy(g), 1e-3, 64)
    jidx, jsigns, jscale, jres = J.threshold_encode_scaled(
        jnp.asarray(g), 1e-3, 64)
    _same(jidx, idx)
    _same(jsigns, signs)
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-6)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=1e-6,
                               atol=1e-9)
    i, v, _ = J.threshold_encode_values(jnp.asarray(g), 1e-3, 64)
    _same(J.values_decode(i, v, (1000,)),
          T.values_decode(np.asarray(i), np.asarray(v), (1000,)))
    _same(J.threshold_decode(jidx, jsigns, 1e-3, (10, 100)),
          T.threshold_decode(np.asarray(jidx), np.asarray(jsigns), 1e-3,
                             (10, 100)))


@pytest.mark.parametrize("n", [1000, 1003, 16])
def test_bitmap_roundtrip_is_bitwise_the_references(n):
    g = _grads(4, n=n)
    packed, res = T.bitmap_encode(torch.from_numpy(g), 1e-3)
    jpacked, jres = J.bitmap_encode(jnp.asarray(g), 1e-3)
    _same(np.asarray(jpacked).astype(np.int64), packed)
    _same(jres, res)
    _same(J.bitmap_decode(jpacked, 1e-3, (n,)),
          T.bitmap_decode(packed, 1e-3, (n,)))


@pytest.mark.parametrize("mode", ["values", "sign"])
def test_encoding_handler_chain_is_the_references(mode):
    """Six steps of residual carry and threshold adaptation."""
    ours = T.EncodingHandler(threshold=1e-3, boundary=0.05, mode=mode)
    theirs = J.EncodingHandler(threshold=1e-3, boundary=0.05, mode=mode)
    for step in range(6):
        g = _grads(10 + step, n=2000)
        oi, op, os_ = ours.encode(torch.from_numpy(g))
        ti, tp, ts = theirs.encode(jnp.asarray(g))
        _same(ti, oi)
        _same(tp, op)
        if mode == "values":
            assert os_ == ts
            _same(theirs._residual, ours._residual)
            assert ours.threshold == theirs.threshold
        else:
            np.testing.assert_allclose(float(os_), float(ts), rtol=1e-6)
            np.testing.assert_allclose(ours._residual.numpy(),
                                       np.asarray(theirs._residual),
                                       rtol=1e-5, atol=1e-9)
            np.testing.assert_allclose(ours.threshold, theirs.threshold,
                                       rtol=1e-6)
        assert ours.last_sparsity == theirs.last_sparsity
        assert ours.iterations == theirs.iterations
    _same(theirs.decode(ti, tp, ts, (2000,)),
          ours.decode(oi, op, os_, (2000,)))
    ours.reset()
    assert ours._residual is None and ours.iterations == 0
