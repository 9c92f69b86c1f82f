"""The port's flash attention against the JAX package's.

On the CPU the port's `flash_attention` runs its plain PyTorch versions,
forward and backward (through its autograd Function); the oracle is the
JAX Pallas kernels in interpret mode (as in tests/test_flash_attention.py),
for gradients `jax.grad` through `_flash`'s custom_vjp, which runs
`_bwd_dq_kernel` and `_bwd_dkv_kernel`. Inputs and cotangents come from
one numpy seed and go through both. The CUDA kernels themselves are
checked against the plain versions on the card by tests/test_torch_cuda.py
and by chip_smoke.py.

Tolerances: f32 atol/rtol 1e-5 for outputs — the two compute the same f32
sums in another order (dense here, blockwise online softmax there), which
moves results by ~1e-7; gradients atol 1e-5, rtol 1e-4. bf16 inputs atol
2e-2 — both accumulate in f32 and round the output to bf16 once, so they
may differ by one bf16 ulp (2^-8 relative) where the f32 sums straddle a
rounding boundary. The f64 gradchecks use torch's defaults.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import flash_attention as jax_flash
from deeplearning4j_tpu_torch.ops import flash_attention as fa_mod
from deeplearning4j_tpu_torch.ops.flash_attention import (
    KERNEL_LAUNCHES, NEG, flash_attention, flash_attention_bwd_plain,
    flash_attention_cuda, flash_attention_plain,
)
from deeplearning4j_tpu_torch.nn.layers.attention import (
    dot_product_attention,
)

F32 = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)


def _qkv(b=2, tq=48, tk=None, h=4, d=16, seed=0):
    rs = np.random.RandomState(seed)
    tk = tq if tk is None else tk
    return (rs.randn(b, tq, h, d).astype("float32"),
            rs.randn(b, tk, h, d).astype("float32"),
            rs.randn(b, tk, h, d).astype("float32"))


def _both(q, k, v, mask=None, **kw):
    """(port, jax) results on the same numpy inputs."""
    tmask = None if mask is None else torch.from_numpy(mask)
    jmask = None if mask is None else jnp.asarray(mask)
    port = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), mask=tmask, **kw)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    mask=jmask, interpret=True, **kw)
    return port, ref


@pytest.mark.parametrize("causal", [False, True])
def test_matches_jax_kernel(causal):
    q, k, v = _qkv()
    port, ref = _both(q, k, v, causal=causal, block_q=16, block_k=16)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **F32)


def test_key_mask_and_fully_masked_rows():
    q, k, v = _qkv(seed=1)
    mask = np.ones((2, 48), np.float32)
    mask[0, 20:] = 0.0
    mask[1, :] = 0.0                     # batch 1 fully masked -> zeros
    port, ref = _both(q, k, v, mask=mask, block_q=16, block_k=16)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **F32)
    assert port[1].abs().max().item() == 0.0


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_length_padding(causal):
    q, k, v = _qkv(tq=50, seed=2)        # 50 % 16 != 0 -> internal pad
    port, ref = _both(q, k, v, causal=causal, block_q=16, block_k=16)
    assert port.shape == (2, 50, 4, 16)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("tq,tk,causal", [(32, 48, False), (48, 24, False),
                                          (40, 56, True)])
def test_cross_attention_tq_ne_tk(tq, tk, causal):
    q, k, v = _qkv(tq=tq, tk=tk, seed=3)
    port, ref = _both(q, k, v, causal=causal, block_q=16, block_k=8)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **F32)


def test_return_lse_and_public_sentinel():
    q, k, v = _qkv(seed=4)
    mask = np.ones((2, 48), np.float32)
    mask[1, :] = 0.0
    (po, plse), (ro, rlse) = _both(q, k, v, mask=mask, causal=True,
                                   block_q=16, block_k=16, return_lse=True)
    np.testing.assert_allclose(po.numpy(), np.asarray(ro), **F32)
    assert plse.shape == (2, 48, 4)
    np.testing.assert_allclose(plse.numpy(), np.asarray(rlse), **F32)
    # fully-masked rows: +1e30 inside, -1e30 at the public boundary
    assert (plse[1] == NEG).all()
    assert np.isfinite(plse[0].numpy()).all() and (plse[0] > NEG / 2).all()


def test_plain_version_internal_lse_sentinel():
    q, k, v = (torch.from_numpy(a) for a in _qkv(tq=16, seed=5))
    mask = torch.ones(2, 16)
    mask[0] = 0.0
    out, lse = flash_attention_plain(q, k, v, mask, causal=False)
    assert lse.shape == (2 * 4, 16)
    assert (lse[:4] == -NEG).all()              # batch 0's four heads
    assert out[0].abs().max().item() == 0.0


@pytest.mark.parametrize("bq,bk", [(8, 8), (16, 32), (32, 16), (64, 64),
                                   (128, 128)])
def test_block_size_matrix(bq, bk):
    q, k, v = _qkv(tq=40, seed=6)
    port, ref = _both(q, k, v, causal=True, block_q=bq, block_k=bk)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **F32)


def test_env_block_override_takes_precedence(monkeypatch):
    """DL4J_CUDA_FLASH_BLOCK_Q/K beat the caller's sizes, as the
    reference's DL4J_TPU_ knobs do: seen through the padded length that
    reaches the plain version."""
    q, k, v = _qkv(tq=40, seed=7)
    seen = []
    real = fa_mod.flash_attention_plain

    def spy(q_, k_, v_, mask, causal):
        seen.append((q_.shape[1], k_.shape[1]))
        return real(q_, k_, v_, mask, causal)

    monkeypatch.setattr(fa_mod, "flash_attention_plain", spy)
    monkeypatch.setenv("DL4J_CUDA_FLASH_BLOCK_Q", "32")
    monkeypatch.setenv("DL4J_CUDA_FLASH_BLOCK_K", "64")
    monkeypatch.setenv("DL4J_TPU_FLASH_BLOCK_Q", "32")
    monkeypatch.setenv("DL4J_TPU_FLASH_BLOCK_K", "64")
    port, ref = _both(q, k, v, causal=True, block_q=16, block_k=16)
    # caller asked for 16 (-> 48); the knobs give 32 -> 64 and 40 (clamped)
    assert seen == [(64, 40)]
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **F32)
    monkeypatch.setenv("DL4J_CUDA_FLASH_BLOCK_Q", "x")
    with pytest.raises(ValueError, match="DL4J_CUDA_FLASH_BLOCK_Q"):
        flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))


def test_bf16_inputs_accumulate_in_f32():
    q, k, v = _qkv(seed=8)
    tq_, tk_, tv_ = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    port = flash_attention(tq_, tk_, tv_, causal=True, block_q=16, block_k=16)
    ref = jax_flash(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                    causal=True, block_q=16, block_k=16, interpret=True)
    assert port.dtype == torch.bfloat16
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=2e-2)


def test_cpu_path_launches_no_kernel():
    before = KERNEL_LAUNCHES["flash_fwd"]
    flash_attention(*(torch.from_numpy(a) for a in _qkv(tq=16)))
    assert KERNEL_LAUNCHES["flash_fwd"] == before


@pytest.mark.parametrize("case,exc", [("grad", NotImplementedError),
                                      ("float16", TypeError),
                                      ("head_dim_12", ValueError)])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(case, exc):
    """The checks run before anything touches the card: a gradient, an
    unsupported dtype or head dim raises instead of falling back."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(tq=16, d=32))
    if case == "grad":
        q.requires_grad_(True)
    elif case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    else:
        q, k, v = (a[..., :12].contiguous() for a in (q, k, v))
    with pytest.raises(exc):
        flash_attention_cuda(q, k, v)



# ------------------------------------------------------------- gradients
def _grads_both(q, k, v, g, mask=None, lse_g=None, **kw):
    """d/d(q, k, v) of sum(out * g) (+ sum(lse * lse_g) with return_lse)
    through the port's CPU flash path and through jax.grad of the JAX
    kernels in interpret mode."""
    tq_ = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    with_lse = lse_g is not None
    res = flash_attention(*tq_, mask=tmask, return_lse=with_lse, **kw)
    if with_lse:
        loss = (res[0] * torch.from_numpy(g)).sum() \
            + (res[1] * torch.from_numpy(lse_g)).sum()
    else:
        loss = (res * torch.from_numpy(g)).sum()
    port = torch.autograd.grad(loss, tq_)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(q_, k_, v_):
        r = jax_flash(q_, k_, v_, mask=jmask, interpret=True,
                      return_lse=with_lse, **kw)
        if with_lse:
            return (r[0] * g).sum() + (r[1] * lse_g).sum()
        return (r * g).sum()

    ref = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    return [p.numpy() for p in port], [np.asarray(r) for r in ref]


def _cot(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


@pytest.mark.parametrize("causal,tq,bq", [(False, 24, 8), (True, 24, 8),
                                          (True, 24, 16), (False, 20, 16)])
def test_gradients_match_jax_kernels(causal, tq, bq):
    """Causal or not, two block sizes, and a ragged length (20 % 16)."""
    q, k, v = _qkv(b=2, tq=tq, h=2, d=8, seed=20)
    port, ref = _grads_both(q, k, v, _cot(q.shape, 21), causal=causal,
                            block_q=bq, block_k=bq)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, r, **GRAD)


def test_gradients_with_fully_masked_rows_are_zero_and_finite():
    q, k, v = _qkv(b=2, tq=16, h=2, d=8, seed=22)
    mask = np.ones((2, 16), np.float32)
    mask[0, 10:] = 0.0
    mask[1, :] = 0.0                    # batch 1: every row fully masked
    port, ref = _grads_both(q, k, v, _cot(q.shape, 23), mask=mask,
                            causal=True, block_q=8, block_k=8)
    for p, r in zip(port, ref):
        assert np.isfinite(p).all()
        np.testing.assert_allclose(p, r, **GRAD)
    dq, dk, dv = port
    assert np.abs(dq[1]).max() == 0.0 and np.abs(dk[1]).max() == 0.0 \
        and np.abs(dv[1]).max() == 0.0
    assert np.abs(dk[0, 10:]).max() == 0.0 and np.abs(dv[0, 10:]).max() == 0.0


@pytest.mark.parametrize("tq,tk,causal", [(16, 24, False), (24, 16, False),
                                          (16, 24, True), (24, 16, True)])
def test_cross_attention_gradients_tq_ne_tk(tq, tk, causal):
    """Causal masking by absolute position, in both tq < tk and tq > tk."""
    q, k, v = _qkv(b=1, tq=tq, tk=tk, h=2, d=8, seed=24)
    port, ref = _grads_both(q, k, v, _cot(q.shape, 25), causal=causal,
                            block_q=8, block_k=8)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, r, **GRAD)


def test_return_lse_trains_through_an_lse_merge():
    """Two key shards merged by their LSEs (the ring-attention rule) give
    the gradients of attention over all keys, as in the reference's
    test_flash_lse_merge_trains_correctly; and the LSE's own cotangent
    matches the JAX kernels'."""
    q, k, v = _qkv(b=1, tq=16, tk=32, h=2, d=8, seed=26)
    g = _cot(q.shape, 27)
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_(True)
                     for a in (q, k, v))
    o1, l1 = flash_attention(tq_, tk_[:, :16], tv_[:, :16], return_lse=True,
                             block_q=8, block_k=8)
    o2, l2 = flash_attention(tq_, tk_[:, 16:], tv_[:, 16:], return_lse=True,
                             block_q=8, block_k=8)
    m = torch.maximum(l1, l2)
    w1, w2 = torch.exp(l1 - m)[..., None], torch.exp(l2 - m)[..., None]
    merged = (w1 * o1 + w2 * o2) / (w1 + w2)
    got = torch.autograd.grad((merged * torch.from_numpy(g)).sum(),
                              (tq_, tk_, tv_))
    dq_, dk_, dv_ = (torch.from_numpy(a).requires_grad_(True)
                     for a in (q, k, v))
    full = dot_product_attention(dq_, dk_, dv_)
    want = torch.autograd.grad((full * torch.from_numpy(g)).sum(),
                               (dq_, dk_, dv_))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)
    port, ref = _grads_both(q, k, v, g, lse_g=_cot((1, 16, 2), 28),
                            block_q=8, block_k=8)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, r, **GRAD)


@pytest.mark.parametrize("causal", [False, True])
def test_gradcheck_f64_plain_flash_path(causal):
    """torch.autograd.gradcheck of the autograd Function on the plain
    path, padding, a key mask with a fully-masked row, and the LSE."""
    rs = np.random.RandomState(29)
    q, k, v = (torch.from_numpy(rs.randn(2, 7, 2, 4)).requires_grad_(True)
               for _ in range(3))
    mask = torch.ones(2, 7, dtype=torch.float64)
    mask[0, 5:] = 0.0
    mask[1] = 0.0

    def f(q_, k_, v_):
        out, lse = flash_attention(q_, k_, v_, mask=mask, causal=causal,
                                   block_q=4, block_k=4, return_lse=True)
        return out, torch.where(lse > NEG / 2, lse, torch.zeros_like(lse))

    assert torch.autograd.gradcheck(f, (q, k, v))


def test_gradcheck_f64_dense_attention():
    rs = np.random.RandomState(30)
    q, k, v = (torch.from_numpy(rs.randn(2, 6, 2, 4)).requires_grad_(True)
               for _ in range(3))
    mask = torch.ones(2, 6, dtype=torch.float64)
    mask[0, 4:] = 0.0
    assert torch.autograd.gradcheck(
        lambda a, b, c: dot_product_attention(a, b, c, mask=mask,
                                              causal=True), (q, k, v))


def test_plain_backward_is_the_kernels_algorithm():
    """flash_attention_bwd_plain by itself against dense autograd, with a
    nonzero LSE cotangent: ds = p * (dp - (rowsum(dO*O) - g_lse))."""
    q, k, v = (torch.from_numpy(a).double() for a in _qkv(b=1, tq=12, h=2,
                                                           d=4, seed=31))
    g = torch.from_numpy(_cot(q.shape, 32)).double()
    g_lse = torch.from_numpy(_cot((2, 12), 33)).double()
    out, lse = flash_attention_plain(q, k, v, None, True)
    got = flash_attention_bwd_plain(q, k, v, None, out, lse, g, g_lse, True)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    o2, l2 = flash_attention_plain(qq, kk, vv, None, True)
    want = torch.autograd.grad((o2 * g).sum() + (l2 * g_lse).sum(),
                               (qq, kk, vv))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)


def test_cpu_backward_launches_no_kernel():
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(tq=16))
    before = dict(KERNEL_LAUNCHES)
    flash_attention(q, k, v, causal=True).sum().backward()
    assert dict(KERNEL_LAUNCHES) == before
    assert q.grad is not None and k.grad is not None and v.grad is not None
