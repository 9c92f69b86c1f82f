"""The port on an NVIDIA GPU: the flash kernels (forward, dQ, dK/dV)
against their plain versions, and the network on the card against the
same network on the CPU, forward and gradients.

Every test here needs a CUDA device (the kernels have no CPU mode) and
skips without one. The file imports nothing of JAX, so it runs on a
machine without it; tests/conftest.py does import JAX, so there run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: forward f32 atol 1e-4 (the kernel and the plain version sum
in other orders; observed ~5e-7); forward bf16 atol/rtol 2e-2 (the bf16
kernel rounds P to bf16 before P.V, as FlashAttention does: observed
~8e-3). Backward f32 atol 1e-4, bf16 atol/rtol 3e-2 (the backward
kernels widen bf16 to f32 and round each gradient once). Network
gradients: per leaf, 1e-4 of the leaf's largest gradient (f32 matmuls on
two devices, summed in other orders).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops.flash_attention import (
    KERNEL_LAUNCHES, flash_attention, flash_attention_bwd_cuda,
    flash_attention_bwd_plain, flash_attention_cuda, flash_attention_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(b, tq, tk, h, d, dtype, seed, device):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, t, h, d, generator=g).to(device, dtype)
                 for t in (tq, tk, tk))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,causal,masked,tq,tk", [
    (64, True, False, 200, 200), (32, False, True, 130, 250),
    (128, True, True, 250, 130), (64, False, False, 1, 77)])
def test_kernel_matches_plain(cuda, dtype, d, causal, masked, tq, tk):
    dt = getattr(torch, dtype)
    q, k, v = _qkv(2, tq, tk, 4, d, dt, 0, cuda)
    mask = None
    if masked:
        mask = torch.ones(2, tk, device=cuda)
        mask[0, tk // 2:] = 0.0
        mask[1] = 0.0                       # fully-masked rows -> 0, +1e30
    before = KERNEL_LAUNCHES["flash_fwd"]
    out, lse = flash_attention_cuda(q, k, v, mask, causal)
    assert KERNEL_LAUNCHES["flash_fwd"] == before + 1
    ref, rlse = flash_attention_plain(q, k, v, mask, causal)
    tol = dict(atol=1e-4, rtol=0.0) if dt == torch.float32 \
        else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(lse, rlse, **tol)
    if masked:
        assert out[1].abs().max().item() == 0.0


def test_public_wrapper_pads_and_maps_lse(cuda):
    q, k, v = _qkv(2, 100, 100, 4, 64, torch.float32, 1, cuda)
    out, lse = flash_attention(q, k, v, causal=True, block_q=64, block_k=64,
                               return_lse=True)
    ref, rlse = flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True,
                                return_lse=True)
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=0.0)
    torch.testing.assert_close(lse.cpu(), rlse, atol=1e-4, rtol=0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,causal,masked,tq,tk,g_lse", [
    (64, True, False, 200, 200, False), (32, False, True, 130, 250, True),
    (128, True, True, 250, 130, False), (64, True, False, 300, 700, True),
    (64, False, False, 1, 77, False)])
def test_backward_kernels_match_plain(cuda, dtype, d, causal, masked, tq, tk,
                                      g_lse):
    dt = getattr(torch, dtype)
    q, k, v = _qkv(2, tq, tk, 4, d, dt, 3, cuda)
    mask = None
    if masked:
        mask = torch.ones(2, tk, device=cuda)
        mask[0, tk // 2:] = 0.0
        mask[1] = 0.0                       # fully-masked rows: zero grads
    out, lse = flash_attention_cuda(q, k, v, mask, causal)
    gen = torch.Generator().manual_seed(4)
    g_out = torch.randn(2, 4, tq, d, generator=gen).to(cuda, dt) \
        .transpose(1, 2)                    # strided, as autograd may pass
    gl = torch.randn(8, tq, generator=gen).to(cuda) if g_lse \
        else torch.zeros(8, tq, device=cuda)
    before = dict(KERNEL_LAUNCHES)
    got = flash_attention_bwd_cuda(q, k, v, mask, out, lse, g_out, gl,
                                   causal)
    assert KERNEL_LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert KERNEL_LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    ref = flash_attention_bwd_plain(q, k, v, mask, out, lse, g_out, gl,
                                    causal)
    tol = dict(atol=1e-4, rtol=0.0) if dt == torch.float32 \
        else dict(atol=3e-2, rtol=3e-2)
    for a, r in zip(got, ref):
        assert torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), r.float(), **tol)
    if masked:
        assert got[0][1].abs().max().item() == 0.0


def test_autograd_through_flash_launches_the_backward_kernels(cuda):
    q, k, v = (t.requires_grad_(True)
               for t in _qkv(2, 100, 100, 4, 64, torch.float32, 5, cuda))
    before = dict(KERNEL_LAUNCHES)
    out, lse = flash_attention(q, k, v, causal=True, block_q=64, block_k=64,
                               return_lse=True)
    (out.square().sum() + lse.sum()).backward()
    assert {n: KERNEL_LAUNCHES[n] - before[n] for n in KERNEL_LAUNCHES} == \
        {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    qc, kc, vc = (t.detach().cpu().requires_grad_(True) for t in (q, k, v))
    oc, lc = flash_attention(qc, kc, vc, causal=True, block_q=64,
                             block_k=64, return_lse=True)
    (oc.square().sum() + lc.sum()).backward()
    for a, b in ((q, qc), (k, kc), (v, vc)):
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=1e-4,
                                   rtol=1e-4)


def test_network_gradients_on_the_card_match_the_cpu(cuda):
    """One batch's gradients of a small flash TransformerLM on the card
    (through the three kernels) against the same network on the CPU."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    kw = dict(vocab_size=128, seq_length=96, n_layers=2, n_embd=64,
              n_heads=2, attention_impl="flash", block_size=64)
    gpu = model_by_name("TransformerLM", **kw).init(device=cuda)
    cpu = model_by_name("TransformerLM", **kw).init(device="cpu")
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 128, (3, 97))
    ds = DataSet(ids[:, :96, None].astype("float32"),
                 np.eye(128, dtype="uint8")[ids[:, 1:]])
    before = dict(KERNEL_LAUNCHES)
    lg, gg, _ = gpu.compute_gradient_and_score(ds)
    assert {n: KERNEL_LAUNCHES[n] - before[n] for n in KERNEL_LAUNCHES} == \
        {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    lc, gc, _ = cpu.compute_gradient_and_score(ds)
    assert abs(lg.item() - lc.item()) <= 1e-5 * abs(lc.item())
    for a, b in zip(tree_leaves(gg), tree_leaves(gc)):
        err = (a.cpu() - b).abs().max().item()
        assert err <= 1e-4 * max(b.abs().max().item(), 1e-30)
    gpu.fit(ds)
    assert np.isfinite(gpu.score())


def test_network_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The same seed gives the same weights on either device (drawn on a
    CPU generator), so the card's forward through the kernel must match
    the CPU's through the plain version; also through the zip."""
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    kw = dict(vocab_size=128, seq_length=96, n_layers=2, n_embd=64,
              n_heads=2, attention_impl="flash", block_size=64)
    gpu = model_by_name("TransformerLM", **kw).init(device=cuda)
    cpu = model_by_name("TransformerLM", **kw).init(device="cpu")
    x = np.random.RandomState(0).randint(0, 128, (3, 96, 1)).astype("float32")
    before = KERNEL_LAUNCHES["flash_fwd"]
    y = gpu.output(x)
    assert KERNEL_LAUNCHES["flash_fwd"] == before + 2
    torch.testing.assert_close(y.cpu(), cpu.output(x), atol=1e-4, rtol=1e-4)
    path = save_model(gpu, str(tmp_path / "lm.zip"))
    again = load_model(path)                  # default device: cuda
    assert again.device.type == "cuda"
    torch.testing.assert_close(again.output(x), y, atol=0.0, rtol=0.0)
