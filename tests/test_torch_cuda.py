"""The port on an NVIDIA GPU: the flash kernels (forward, dQ, dK/dV)
against their plain versions, the network on the card against the same
network on the CPU, forward and gradients, the decode engine on the
card against the same engine on the CPU, ResNet-50's layers and a
small residual ComputationGraph on the card against the CPU, and the
fit loop's captured steps: replays bitwise equal to per-call steps (with
dropout), no host sync inside a chunk, an out-of-range id refused before
a replay, a capture error raised with no fallback, and accumulation's
graphs against the big-batch step (rtol 1e-5). Recurrent nets: tbptt and
standard LSTM steps card against CPU in f64 (each leaf within 1e-10 of
its largest update), an LSTM net's captured steps bitwise equal to its
per-call steps, and rnn_time_step equal to output() on the card (f32,
atol 1e-5). Detection and the VAE: TinyYOLO card against CPU (f32
output atol 1e-4 and score rtol 1e-4; f64 score and gradients within
1e-10, one Adam step within 1e-6 of each leaf's largest update), the
VAE's ELBO with fixed noise and its gradients in f64 within 1e-10,
f64 gradient checks on the card of a YOLO head and a VAE, and TinyYOLO's
captured steps bitwise equal to its per-call steps (f32 and bf16). The
LM serving runtime: a speculative verify bitwise equal to k+1 sequential
decode steps (both replayed CUDA graphs), every captured decode program's
replay bitwise its eager run on the card (tokens and logits; sampled
tokens for one seed and counter), the sampling noise replaying its eager
draw, a page demoted to the host spill tier and promoted back bitwise
equal, an LM swap under a live stream with only 200s and the same tokens
as runs without a swap, a swap capturing while streams decode and the
dropped version's graph pool freed, and the decode smoke holding every
gate but its timing A/Bs (whose numbers it prints). The data plane: ResNet50 at 64² fed
from the multi-process shard ring (copy=False and copy=True) and from
memory, bitwise equal parameters for scan_steps=3, accumulate_steps=2 and
per-call fits without prefetch; and the ring's view batches feeding a
CUDA fit of a small net, bitwise its in-memory fit. Telemetry: the
program ledger's FLOPs of a small flash LM on the card equal the
analytic count (the kernels added by formula), `train_mfu_pct` is set
by a scan fit, and tracing, the ledger and goodput on add no host sync
to a replayed step. Resilience: a guarded ResilientTrainer fit bitwise
the per-call fit (an MLP with dropout, a flash LM with residual
dropout), a retry after a step that ran bitwise the unfaulted run (the
card's generator restored), an async CheckpointListener zip bitwise the
synchronous one with no added sync once its pinned buffers are cached,
and memory_report's measured step leaving the network bitwise unchanged,
within 2x of the analytic total for the reference's LeNet case. The
fleet: two in-process replicas of a flash LM behind the router, every
predict through the kernel (n_layers launches a dispatch) and within
1e-4 of plain attention; a SIGKILLed subprocess replica relaunched on
the card, answering bitwise as before while the router kept answering.
Data parallelism: fit(plan=) over a one-rank NCCL group bitwise the
plain fit, per call and with the all-reduce captured in the step's graph;
a captured step under gloo refused before it starts. Sequence and
pipeline parallelism: two gloo ranks on the card (K/V through pinned host
memory): the flash ring's output within 1e-4 of the online ring on the
CPU and its gradients within 1e-4 of each tensor's largest entry, two
flash launches of each kernel a call; a context-parallel and a pipelined
LM fit with the ranks bitwise equal, the expected launches, and the
parameters within 1e-4 relative (1e-6 absolute) of the same fit's on two
CPU ranks. The embedding trainers: each word2vec step and GloVe's step on
card tables (rows repeating within the batch) within 1e-6 of the CPU's,
and Word2Vec, GloVe and ParagraphVectors fitting on the card when no
device is asked for, within 1e-5 (relative) of the CPU's fit. Model
import and the dashboard: a DL4J zip restored onto the card by default,
parameters and Adam slots bitwise the CPU restore's, a predict and 3 fit
steps within 1e-6; StatsListener's on-card summaries equal to numpy's
(histogram counts and bounds exactly); a fit's records on the card with
gradients, updates and device memory; a Keras JSON config imported onto
the card and a DL4JClassifier fitted there within 1e-5 of its network on
the CPU. Clustering and t-SNE: k-means fitted on the card with the CPU
fit's centers bitwise (data without near-tie rows; inertia within 1e-5
relative), the affinity tile
(neighbour sets equal, p within 1e-5) and the tiled gradient with pad
rows (within 1e-5 of its largest value) on the card against the CPU, and
KMeansClustering, Tsne and BarnesHutTsne on the card when no device is
asked for.

Every test here needs a CUDA device (the kernels have no CPU mode) and
skips without one. The file imports nothing of JAX, so it runs on a
machine without it; tests/conftest.py does import JAX, so there run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: forward f32 atol 1e-4 (the kernel and the plain version sum
in other orders; observed ~5e-7); forward bf16 atol/rtol 2e-2 (the bf16
kernel rounds P to bf16 before P.V, as FlashAttention does: observed
~8e-3). Backward f32 atol 1e-4, bf16 atol/rtol 3e-2 (the bf16 backward
kernels round p and ds to bf16 before their second products, as the
forward rounds P, and each gradient once). Network
gradients: per leaf, 1e-4 of the leaf's largest gradient (f32 matmuls on
two devices, summed in other orders). ResNet's layers: f32 with TF32
off, outputs and gradients within 1e-4 of each tensor's largest value
(cuDNN against the CPU's convolutions). The small graph runs in f64:
training-mode values within 1e-10 (scores) and 1e-8 (gradients).
The user scripts: each example that needs no scikit-learn, keras or
h5py asked for no device runs on the card and reaches its JAX example's
result (tests/test_examples.py's settings), 09 and 10 raise naming a
missing library, and chaos_fit, goodput_report, telemetry_smoke,
etl_smoke and mfu_probe run on the card by default and exit 0.
"""
import dataclasses
import json
import os
import time
import warnings

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


def _assert_fwd_close(got, ref, dtype):
    tol = dict(atol=1e-4, rtol=0.0) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=2e-2)
    (out, lse), (rout, rlse) = got, ref
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), rout.float(), **tol)
    torch.testing.assert_close(lse, rlse, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("tq,tk", [(190, 333), (333, 190)])
def test_forward_ragged_edges_mask_causal(cuda, dtype, d, tq, tk):
    """Tq and Tk not multiples of the 64-row tile, with a key mask and
    causal masking at once: the copy ring's zero-filled rows, the key
    validity past Tk and query rows past Tq (in bf16 a block's second
    warpgroup) must add nothing."""
    dt = getattr(torch, dtype)
    q, k, v = _qkv(2, tq, tk, 4, d, dt, 12, cuda)
    mask = torch.ones(2, tk, device=cuda)
    mask[0, tk // 3:tk // 2] = 0.0
    mask[1, :5] = 0.0                       # causal rows 0-4 fully masked
    got = flash_attention_cuda(q, k, v, mask, True)
    _assert_fwd_close(got, flash_attention_plain(q, k, v, mask, True), dt)
    assert got[0][1, :5].abs().max().item() == 0.0
    assert (got[1].reshape(2, 4, tq)[1, :, :5] == 1e30).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_single_query_row(cuda, dtype, causal):
    """Tq = 1: one block whose rows but the first lie past Tq."""
    dt = getattr(torch, dtype)
    q, k, v = _qkv(3, 1, 200, 4, 64, dt, 13, cuda)
    got = flash_attention_cuda(q, k, v, None, causal)
    _assert_fwd_close(got, flash_attention_plain(q, k, v, None, causal), dt)


def _strided_qkv(layout, dt, device, seed):
    """q, k and v as views whose T stride is not H*D: a packed (B, T, 3, H,
    D) projection, or a head dim padded by 8."""
    gen = torch.Generator().manual_seed(seed)
    if layout == "packed_qkv":
        qkv = torch.randn(2, 200, 3, 4, 64, generator=gen).to(device, dt)
        q, k, v = (qkv[:, :, i] for i in range(3))
    else:
        q, k, v = (torch.randn(2, 200, 4, 72, generator=gen)
                   .to(device, dt)[..., :64] for _ in range(3))
    assert q.stride(1) != 4 * 64
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["packed_qkv", "padded_head_dim"])
def test_forward_strided_views(cuda, dtype, layout):
    """The forward reads strided q, k and v in place, through their
    strides, as the backward does."""
    dt = getattr(torch, dtype)
    q, k, v = _strided_qkv(layout, dt, cuda, 8)
    got = flash_attention_cuda(q, k, v, None, True)
    _assert_fwd_close(got, flash_attention_plain(q, k, v, None, True), dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_is_bitwise_deterministic(cuda, dtype):
    """No atomics and a fixed order: two forward calls on the same inputs
    give bitwise-equal O and LSE."""
    dt = getattr(torch, dtype)
    q, k, v = _qkv(2, 300, 300, 4, 64, dt, 14, cuda)
    mask = torch.ones(2, 300, device=cuda)
    mask[0, 250:] = 0.0
    first = flash_attention_cuda(q, k, v, mask, True)
    again = flash_attention_cuda(q, k, v, mask, True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_public_wrapper_pads_and_maps_lse(cuda):
    """The wrapper's padding to the block and its LSE layout, against the
    plain version on the card (as every other forward test: a reference
    on the host CPU sums in another order again)."""
    q, k, v = _qkv(2, 100, 100, 4, 64, torch.float32, 1, cuda)
    out, lse = flash_attention(q, k, v, causal=True, block_q=64, block_k=64,
                               return_lse=True)
    ref, rlse = flash_attention_plain(q, k, v, None, True)
    rlse = rlse.reshape(2, 4, 100).transpose(1, 2)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0.0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0.0)


def test_f32_forward_is_bitwise_stable_over_fifty_calls(cuda):
    """The f32 forward kernel, called 50 times on one input, gives the
    first call's O and LSE bitwise every time."""
    q, k, v = _qkv(2, 100, 100, 4, 64, torch.float32, 1, cuda)
    first = flash_attention_cuda(q, k, v, None, True)
    for _ in range(49):
        again = flash_attention_cuda(q, k, v, None, True)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


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


def _bwd_case(q, k, v, mask, causal, g_lse, seed):
    """The backward kernels' and the plain backward's gradients on the
    forward kernel's outputs and seeded cotangents."""
    b, tq, h, d = q.shape
    out, lse = flash_attention_cuda(q, k, v, mask, causal)
    gen = torch.Generator().manual_seed(seed)
    g_out = torch.randn(b, tq, h, d, generator=gen).to(q.device, q.dtype)
    gl = torch.randn(b * h, tq, generator=gen).to(q.device) if g_lse \
        else torch.zeros(b * h, tq, device=q.device)
    got = flash_attention_bwd_cuda(q, k, v, mask, out, lse, g_out, gl,
                                   causal)
    ref = flash_attention_bwd_plain(q, k, v, mask, out, lse, g_out, gl,
                                    causal)
    return got, ref


def _assert_bwd_close(got, ref, dtype):
    tol = dict(atol=1e-4, rtol=0.0) if dtype == torch.float32 \
        else dict(atol=3e-2, rtol=3e-2)
    for a, r in zip(got, ref):
        assert torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), r.float(), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("tq,tk", [(190, 333), (333, 190)])
def test_backward_ragged_edges_mask_causal_g_lse(cuda, dtype, d, tq, tk):
    """Tq and Tk not multiples of the 64-row tile, with a key mask, causal
    masking and an LSE cotangent at once: the copy ring's zero-filled
    rows and the key validity past Tk must add nothing."""
    dt = getattr(torch, dtype)
    q, k, v = _qkv(2, tq, tk, 4, d, dt, 6, cuda)
    mask = torch.ones(2, tk, device=cuda)
    mask[0, tk // 3:tk // 2] = 0.0
    mask[1, :5] = 0.0                       # causal rows 0-4 fully masked
    got, ref = _bwd_case(q, k, v, mask, True, True, 7)
    _assert_bwd_close(got, ref, dt)
    assert got[0][1, :5].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["packed_qkv", "padded_head_dim"])
def test_backward_strided_views(cuda, dtype, layout):
    """q, k and v as views whose T stride is not H*D (a packed (B, T, 3, H,
    D) projection, or a head dim padded by 8): read in place, through
    their strides."""
    dt = getattr(torch, dtype)
    q, k, v = _strided_qkv(layout, dt, cuda, 8)
    got, ref = _bwd_case(q, k, v, None, True, False, 9)
    _assert_bwd_close(got, ref, dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_is_bitwise_deterministic(cuda, dtype):
    """No atomics and a fixed summation order: two backward calls on the
    same inputs give bitwise-equal dQ, dK and dV."""
    dt = getattr(torch, dtype)
    q, k, v = _qkv(2, 300, 300, 4, 64, dt, 10, cuda)
    mask = torch.ones(2, 300, device=cuda)
    mask[0, 250:] = 0.0
    out, lse = flash_attention_cuda(q, k, v, mask, True)
    gen = torch.Generator().manual_seed(11)
    g_out = torch.randn(2, 300, 4, 64, generator=gen).to(cuda, dt)
    gl = torch.randn(8, 300, generator=gen).to(cuda)
    first = flash_attention_bwd_cuda(q, k, v, mask, out, lse, g_out, gl, True)
    again = flash_attention_bwd_cuda(q, k, v, mask, out, lse, g_out, gl, True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


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


def _decode_pair(cuda, tmp_path, **cfg):
    """The decode engine on the card and on the CPU, from one zip."""
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.serving.decode import (
        DecodeConfig, DecodeEngine,
    )
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    kw = dict(vocab_size=128, seq_length=96, n_layers=2, n_embd=64,
              n_heads=2, attention_impl="flash", block_size=64)
    path = save_model(model_by_name("TransformerLM", **kw).init(device="cpu"),
                      str(tmp_path / "lm.zip"))
    conf = DecodeConfig(slots=2, page_size=16, prefill_buckets=(32, 96),
                        prefill_chunk_tokens=16, **cfg)
    return [DecodeEngine(load_model(path, device=dev), conf, name=str(dev))
            for dev in (cuda, "cpu")]


@pytest.mark.parametrize("quantize,atol", [(None, 1e-4), ("int8", 1e-4)])
def test_decode_engine_on_the_card_matches_the_cpu(cuda, tmp_path, quantize,
                                                   atol):
    """Prefill (dense and in 16-token chunks after a prefix-cache hit) and
    20 greedy steps of two slots: the card's logits within `atol` of the
    CPU's and the same tokens; the decode path launches no flash kernel
    and runs no program first on the request path."""
    gpu, cpu = _decode_pair(cuda, tmp_path, quantize=quantize)
    for e in (gpu, cpu):
        e.warm()
    before = dict(KERNEL_LAUNCHES)
    rs = np.random.RandomState(3)
    prefix = rs.randint(0, 128, 32).tolist()
    prompts = [prefix + [5, 9, 1], prefix + rs.randint(0, 128, 20).tolist()]
    slots = []
    for i, prompt in enumerate(prompts):
        infos = [e.admit_prompt(np.array(prompt)) for e in (gpu, cpu)]
        assert infos[0] == infos[1] and infos[0].cached_len == 32 * i
        slot = infos[0].slot
        if i == 0:
            (tg, lg), (tc, lc) = (e.prefill(slot, np.array(prompt), 0.0, 0)
                                  for e in (gpu, cpu))
            torch.testing.assert_close(lg.cpu(), lc, atol=atol, rtol=0)
        else:
            for start in range(32, len(prompt), 16):
                n = min(16, len(prompt) - start)
                tg, tc = (e.prefill_chunk(slot, np.array(prompt), start, n,
                                          0.0, 0) for e in (gpu, cpu))
        assert tg == tc
        for e in (gpu, cpu):
            e.cache.register_prefix(slot, prompt)
        slots.append(slot)
    for _ in range(20):
        (tg, ag, lg), (tc, ac, lc) = gpu.step(), cpu.step()
        assert (ag == ac).all() and ag[slots].all()
        torch.testing.assert_close(lg.cpu()[slots], lc[slots], atol=atol,
                                   rtol=0)
        np.testing.assert_array_equal(tg[slots], tc[slots])
    assert dict(KERNEL_LAUNCHES) == before
    assert gpu.request_path_first_runs == 0
    full = np.array([prompts[1][:40]])
    np.testing.assert_allclose(gpu.logits_full(full), cpu.logits_full(full),
                               atol=atol, rtol=0)


def test_decode_engine_bf16_and_sampling_on_the_card(cuda, tmp_path):
    """bf16 pools and weights on the card: prefill logits within 5e-2 of
    the CPU's bf16 engine; a sampled step draws only from each slot's
    top-k, and one seed gives one stream."""
    gpu, cpu = _decode_pair(cuda, tmp_path, quantize="bf16")
    assert gpu._kpool.dtype == torch.bfloat16 and gpu._kpool.is_cuda
    prompt = np.random.RandomState(4).randint(0, 128, 40)
    slot = gpu.cache.admit(40)
    assert cpu.cache.admit(40) == slot
    (_, lg), (_, lc) = (e.prefill(slot, prompt, 0.0, 0) for e in (gpu, cpu))
    torch.testing.assert_close(lg.float().cpu(), lc.float(), atol=5e-2,
                               rtol=0)
    lgf = lg.float()[None].expand(4096, -1).contiguous()
    temps = torch.full((4096,), 1.0, device=cuda)
    topks = torch.full((4096,), 5, dtype=torch.int64, device=cuda)
    draws = gpu._sample(lgf, temps, topks, 9)
    assert torch.isin(draws, torch.topk(lgf[0], 5).indices).all()
    assert torch.equal(draws, gpu._sample(lgf, temps, topks, 9))
    assert len(set(draws.tolist())) > 1


# ------------------------------------------------------ ResNet's path
def _to(tree, device, dtype=None):
    from deeplearning4j_tpu_torch.nn.multilayer import tree_to
    return tree_to(tree, torch.device(device), dtype)


def _layer_on_both(layer, params, state, x, train):
    """The layer's forward and gradients of sum(y * g) on the card and on
    the CPU, from the same CPU tensors."""
    out = []
    g = torch.randn(layer.apply(params, state, x, train=train)[0].shape,
                    generator=torch.Generator().manual_seed(3))
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
        xx = x.to(dev).requires_grad_(True)
        y, st = layer.apply(p, _to(state, dev), xx, train=train)
        grads = torch.autograd.grad((y * g.to(dev)).sum(),
                                    [xx] + list(p.values()))
        out.append((y, st, grads))
    return out


@pytest.mark.parametrize("case", ["conv_same_s1", "conv_1x1_s2",
                                  "conv_stem_7x7_s2", "bn_train", "bn_eval",
                                  "pool_same_3x3_s2", "global_avg",
                                  "relu", "output"])
def test_resnet_layers_on_the_card_match_the_cpu(cuda, case):
    """ResNet50's layers at its own shapes (batch 4, a quarter of the
    spatial size) on the card against the CPU, f32 with TF32 off:
    outputs and gradients within 1e-4 of each tensor's largest value."""
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.layers import (
        ActivationLayer, BatchNormalization, ConvolutionLayer,
        GlobalPoolingLayer, OutputLayer, SubsamplingLayer,
    )
    from deeplearning4j_tpu_torch.util.platform import set_f32_matmul_exact
    set_f32_matmul_exact()
    gen = torch.Generator().manual_seed(0)
    layers = {
        "conv_same_s1": (ConvolutionLayer(n_out=64, kernel=(3, 3),
                                          convolution_mode="same",
                                          has_bias=False), (4, 14, 14, 64)),
        "conv_1x1_s2": (ConvolutionLayer(n_out=128, kernel=(1, 1),
                                         stride=(2, 2),
                                         convolution_mode="same",
                                         has_bias=False), (4, 14, 14, 64)),
        "conv_stem_7x7_s2": (ConvolutionLayer(n_out=64, kernel=(7, 7),
                                              stride=(2, 2),
                                              has_bias=False),
                             (4, 62, 62, 3)),
        "bn_train": (BatchNormalization(), (4, 14, 14, 64)),
        "bn_eval": (BatchNormalization(), (4, 14, 14, 64)),
        "pool_same_3x3_s2": (SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                              convolution_mode="same"),
                             (4, 28, 28, 64)),
        "global_avg": (GlobalPoolingLayer(pooling_type="avg"),
                       (4, 7, 7, 256)),
        "relu": (ActivationLayer(activation="relu"), (4, 14, 14, 64)),
        "output": (OutputLayer(n_out=100), (4, 256)),
    }
    layer, shape = layers[case]
    x = torch.randn(shape, generator=gen)
    it = InputType.feed_forward(shape[-1]) if len(shape) == 2 \
        else InputType.convolutional(*shape[1:])
    params, state = layer.init(gen, it)
    params = {k: v + 0.1 * torch.randn(v.shape, generator=gen)
              for k, v in params.items()}
    (yg, sg, gg), (yc, sc, gc) = _layer_on_both(layer, params, state, x,
                                                train=case != "bn_eval")
    assert yg.is_contiguous()
    for a, b in [(yg, yc)] + list(zip(gg, gc)):
        err = (a.detach().cpu() - b).abs().max().item()
        assert err <= 1e-4 * max(b.abs().max().item(), 1e-30)
    for k in sc:
        torch.testing.assert_close(sg[k].cpu(), sc[k], atol=1e-6, rtol=1e-5)


def test_small_graph_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A small residual ComputationGraph (stem, two bottlenecks, BN,
    global pool, softmax head) from one zip on the card and on the CPU:
    output(), then one batch's score and gradients, then a fit step."""
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    conf = ResNet50(num_classes=10, input_shape=(32, 32, 3)).conf()
    import dataclasses
    keep = [n for n in conf.topological_order() if not n.startswith(
        ("res3", "res4", "res5"))]
    verts = {n: conf.vertices[n] for n in keep if n not in
             ("avgpool", "output")}
    verts["avgpool"] = dataclasses.replace(conf.vertices["avgpool"],
                                           inputs=("res2c_out",))
    verts["output"] = conf.vertices["output"]
    small = dataclasses.replace(conf, vertices=verts,
                                dtype="float64")
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    path = save_model(ComputationGraph(small, device="cpu").init(),
                      str(tmp_path / "g.zip"))
    gpu, cpu = load_model(path), load_model(path, device="cpu")
    rs = np.random.RandomState(0)
    X = rs.rand(8, 32, 32, 3)
    Y = np.eye(10)[rs.randint(0, 10, 8)]
    # inference normalizes by the f32 running variance (BN state is f32
    # in both packages): the card's f32 rsqrt may differ from the CPU's
    # by an ulp, so output() is held at f32 level even in f64
    torch.testing.assert_close(gpu.output(X).cpu(), cpu.output(X),
                               atol=1e-6, rtol=1e-5)
    mds = MultiDataSet((X,), (Y,))
    lg, gg, sg = gpu.compute_gradient_and_score(mds)
    lc, gc, sc = cpu.compute_gradient_and_score(mds)
    assert abs(lg.item() - lc.item()) <= 1e-10 * abs(lc.item())
    for a, b in zip(tree_leaves(gg), tree_leaves(gc)):
        err = (a.cpu() - b).abs().max().item()
        assert err <= 1e-8 * max(b.abs().max().item(), 1e-30)
    for a, b in zip(tree_leaves(sg), tree_leaves(sc)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-10, rtol=1e-10)
    gpu.fit(mds)
    cpu.fit(mds)
    for a, b in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-9, rtol=1e-9)


# ------------------------------------------------- the captured fit step
def _dropout_mlp(device, seed=7, dropout=0.5):
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(1e-2))
            .list().layer(DenseLayer(n_out=16, activation="relu",
                                     dropout=dropout))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _blob_iter(n=700):
    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    rs = np.random.RandomState(0)
    X = rs.randn(n, 4).astype("float32")
    Y = np.eye(3, dtype="float32")[rs.randint(0, 3, n)]
    return ArrayDataSetIterator(X, Y, batch_size=64)


def _lm(device, **kw):
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    return model_by_name("TransformerLM", vocab_size=64, seq_length=64,
                         n_layers=2, n_embd=64, n_heads=2, mlp_ratio=2,
                         attention_impl="flash", block_size=64, seed=7,
                         **kw).init(device=device)


def _lm_iter(bad_id=False):
    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    rs = np.random.RandomState(3)
    t = rs.randint(0, 64, (48, 65))
    x = t[:, :64, None].astype("float32")
    if bad_id:
        x[21, 5, 0] = 64
    return ArrayDataSetIterator(x, np.eye(64, dtype="float32")[t[:, 1:]],
                                batch_size=4)


def _same(a, b):
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                 tree_leaves(b.params)))


@pytest.mark.parametrize("model", ["mlp_dropout", "lm_dropout"])
def test_graph_fit_is_bitwise_the_per_call_fit(cuda, model):
    """Replays of the captured step equal per-call steps from one init:
    parameters, scores and the dropout stream."""
    from deeplearning4j_tpu_torch.train.listeners import (
        CollectScoresIterationListener,
    )
    nets, scores = [], []
    for scan in (1, 4):
        net = _dropout_mlp(cuda) if model == "mlp_dropout" \
            else _lm(cuda, dropout=0.1)
        lst = CollectScoresIterationListener()
        net.set_listeners(lst)
        net.fit(_blob_iter() if model == "mlp_dropout" else _lm_iter(),
                epochs=2, scan_steps=scan)
        nets.append(net)
        scores.append([s for _, s in lst.scores])
    assert scores[0] == scores[1] and _same(*nets)
    assert nets[1]._step_graphs                  # the graph path ran


def test_no_host_sync_inside_a_chunk(cuda):
    """With the graph captured, a fit of 12 steps in chunks of 4 syncs at
    most once per chunk (the loss fetch)."""
    import warnings
    net = _lm(cuda)
    net.fit(_lm_iter(), scan_steps=4)             # capture
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            net.fit(_lm_iter(), scan_steps=4, prefetch=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "called a synchronizing CUDA operation"
             in str(w.message)]
    assert len(syncs) <= 12 // 4, [str(w.message)[:120] for w in syncs]


def test_out_of_range_id_raises_before_any_replay(cuda):
    """The bad batch's chunk is checked on the host before its first
    replay: a ValueError, and the context stays usable (an index out of
    range on the card would trip a device-side assert)."""
    net = _lm(cuda)
    net.fit(_lm_iter(), scan_steps=4, prefetch=False)        # capture
    with pytest.raises(ValueError, match="token ids"):
        net.fit(_lm_iter(bad_id=True), scan_steps=4, prefetch=False)
    net.fit(_lm_iter(), scan_steps=4)
    assert np.isfinite(net.score())


def test_capture_error_propagates_and_nothing_falls_back(cuda, monkeypatch):
    from deeplearning4j_tpu_torch.nn import step_graph

    def refuse(self, fn, bound, generator=None, checked_layers=()):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(step_graph.StepGraph, "capture", refuse)
    net = _dropout_mlp(cuda)
    with pytest.raises(RuntimeError, match="capture refused"):
        net.fit(_blob_iter(), scan_steps=4)


def test_graph_accumulation_equals_the_big_batch_step(cuda):
    """Four micro-batches of 16 through the captured micro-step and update
    graphs against per-call steps on batches of 64, on the card (no
    dropout): rtol 1e-5 (the same means summed in other orders)."""
    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    rs = np.random.RandomState(3)
    X = rs.randn(128, 4).astype("float32")
    Y = np.eye(3, dtype="float32")[rs.randint(0, 3, 128)]
    nets = []
    for batch, acc in ((16, 4), (64, 1)):
        net = _dropout_mlp(cuda, dropout=0.0)
        net.fit(ArrayDataSetIterator(X, Y, batch_size=batch), epochs=2,
                accumulate_steps=acc)
        nets.append(net)
    assert nets[0].iteration_count == nets[1].iteration_count == 4
    assert nets[0]._step_graphs
    for a, b in zip(tree_leaves(nets[0].params), tree_leaves(nets[1].params)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- recurrent nets
def _lstm_net(device, dtype="float32", tbptt=None, dropout=0.0, seed=3,
              bidirectional=True):
    import dataclasses
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        LSTM, Bidirectional, GravesLSTM, RnnOutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    lb = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(1e-2))
          .list().layer(LSTM(n_out=16, dropout=dropout))
          .layer(GravesLSTM(n_out=12)))
    if bidirectional:
        lb = lb.layer(Bidirectional(layer=LSTM(n_out=8)))
    lb = (lb.layer(RnnOutputLayer(n_out=5))
          .set_input_type(InputType.recurrent(6, 12)))
    if tbptt:
        lb = lb.tbptt(tbptt)
    conf = dataclasses.replace(lb.build(), dtype=dtype)
    return MultiLayerNetwork(conf, device=device).init()


def _seq_batch(n=8, dtype=np.float32, seed=4):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 12, 6).astype(dtype)
    y = np.eye(5, dtype=dtype)[rs.randint(0, 5, (n, 12))]
    m = np.ones((n, 12), dtype)
    m[: n // 2, 5:] = 0                  # a masked tail across a boundary
    return x, y, m


def test_lstm_train_steps_on_the_card_match_the_cpu_in_f64(cuda):
    """Two tbptt chunks (a masked tail crossing the boundary) and one
    standard step, card against CPU from one init in f64: every leaf
    within 1e-10 of its largest update."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    for tbptt in (6, None):
        cpu = _lstm_net("cpu", "float64", tbptt)
        gpu = _lstm_net(cuda, "float64", tbptt)
        before = [t.clone() for t in tree_leaves(cpu.params)]
        x, y, m = _seq_batch(dtype=np.float64)
        for net in (cpu, gpu):
            net.fit(DataSet(x, y, m, m), prefetch=False)
        assert cpu.iteration_count == gpu.iteration_count == (
            2 if tbptt else 1)
        for a, b, b0 in zip(tree_leaves(gpu.params), tree_leaves(cpu.params),
                            before):
            scale = (b - b0).abs().max().item()
            assert (a.cpu() - b).abs().max().item() <= 1e-10 * scale


def test_lstm_graph_fit_is_bitwise_the_per_call_fit(cuda):
    """Standard-backprop LSTM training captures as it is: the unrolled
    loop, masks by torch.where, dropout through the registered
    generator; replays equal per-call steps bitwise."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.train.listeners import (
        CollectScoresIterationListener,
    )
    batches = []
    for s in range(8):
        x, y, m = _seq_batch(seed=s)
        batches.append(DataSet(x, y, m, m))
    nets, scores = [], []
    for scan in (1, 4):
        net = _lstm_net(cuda, dropout=0.2)
        lst = CollectScoresIterationListener()
        net.set_listeners(lst)
        net.fit(ExistingDataSetIterator(batches), epochs=2, scan_steps=scan)
        nets.append(net)
        scores.append([s for _, s in lst.scores])
    assert scores[0] == scores[1] and _same(*nets)
    assert nets[1]._step_graphs


def test_rnn_time_step_on_the_card_equals_output(cuda):
    """On the card, streaming one step and several steps at a time equals
    output() of the whole sequence (f32, atol 1e-5), which equals the
    CPU's. (A Bidirectional layer sees only the steps of each call, so
    the streamed net is the unidirectional one.)"""
    x, _, _ = _seq_batch()
    gpu = _lstm_net(cuda, bidirectional=False)
    cpu = _lstm_net("cpu", bidirectional=False)
    full = gpu.output(x)
    torch.testing.assert_close(full.cpu(), cpu.output(x), atol=1e-5, rtol=0)
    steps = torch.stack([gpu.rnn_time_step(x[:, t]) for t in range(12)], 1)
    torch.testing.assert_close(steps, full, atol=1e-5, rtol=0)
    gpu.rnn_clear_previous_state()
    first = gpu.rnn_time_step(x[:, :7])
    rest = gpu.rnn_time_step(x[:, 7:])
    torch.testing.assert_close(torch.cat([first, rest], 1), full, atol=1e-5,
                               rtol=0)


# ------------------------------------------------- detection and the VAE
def _tinyyolo(device, dtype="float32"):
    import dataclasses
    from deeplearning4j_tpu_torch.models.zoo import TinyYOLO
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    conf = TinyYOLO(num_classes=3, input_shape=(64, 64, 3)).conf()
    return ComputationGraph(dataclasses.replace(conf, dtype=dtype),
                            device=device).init()


def _yolo_batch(n=4, grid=2, classes=3, seed=5, dtype=np.float32):
    """Images and labels with 1-2 boxes an image, in grid units."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 32 * grid, 32 * grid, 3).astype(dtype)
    y = np.zeros((n, grid, grid, 4 + classes), dtype)
    for i in range(n):
        for _ in range(1 + i % 2):
            cx, cy = rs.uniform(0.2, grid - 0.2, 2)
            w, h = rs.uniform(0.3, 1.5, 2)
            y[i, int(cy), int(cx), :4] = [cx - w / 2, cy - h / 2,
                                         cx + w / 2, cy + h / 2]
            y[i, int(cy), int(cx), 4 + rs.randint(classes)] = 1
    return x, y


def _worst_rel(a_tree, b_tree, before=None):
    """max over leaves of |a - b| (b on the CPU) over b's largest value,
    or with `before`, over the leaf's largest update."""
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    b_leaves = dict(iter_leaves(b_tree))
    worst = 0.0
    for path, a in iter_leaves(a_tree):
        b = b_leaves[path]
        scale = b.abs().max().item() if before is None else \
            (b - before[path]).abs().max().item()
        worst = max(worst, (a.detach().cpu() - b).abs().max().item()
                    / max(scale, 1e-300))
    return worst


def test_tinyyolo_on_the_card_matches_the_cpu(cuda):
    """TinyYOLO (3 classes, 64²), card against CPU from one init: f32
    output within 1e-4 and score rtol 1e-4 (TF32 off); in f64 the
    training score and gradients within 1e-10 (of each leaf's largest
    gradient), one Adam step within 1e-6 of each leaf's largest update
    (Adam's first step g / (|g| + 1e-8) multiplies the error of entries
    with |g| near 1e-8), the batch norm state within 1e-10."""
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    x, y = _yolo_batch()
    gpu, cpu = _tinyyolo(cuda), _tinyyolo("cpu")
    torch.testing.assert_close(gpu.output(x).cpu(), cpu.output(x),
                               atol=1e-4, rtol=0)
    mds = MultiDataSet((x,), (y,))
    np.testing.assert_allclose(gpu.score(mds), cpu.score(mds), rtol=1e-4)
    x, y = _yolo_batch(dtype=np.float64)
    mds = MultiDataSet((x,), (y,))
    gpu, cpu = _tinyyolo(cuda, "float64"), _tinyyolo("cpu", "float64")
    g_loss, g_grads, _ = gpu.compute_gradient_and_score(mds)
    c_loss, c_grads, _ = cpu.compute_gradient_and_score(mds)
    assert abs(float(g_loss) - float(c_loss)) <= 1e-10 * abs(float(c_loss))
    assert _worst_rel(g_grads, c_grads) <= 1e-10
    before = {p: t.clone() for p, t in iter_leaves(cpu.params)}
    for net in (gpu, cpu):
        net.fit(mds)
    assert _worst_rel(gpu.params, cpu.params, before) <= 1e-6
    assert _worst_rel(gpu.state, cpu.state) <= 1e-10


def _vae_net(device):
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        OutputLayer, VariationalAutoencoder,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(4).updater(Adam(1e-3))
            .dtype("float64").list()
            .layer(VariationalAutoencoder(n_out=4, encoder_layer_sizes=(16,),
                                          decoder_layer_sizes=(16,),
                                          num_samples=2))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(10)).build())
    return MultiLayerNetwork(conf, device=device).init()


def test_vae_pretrain_score_on_the_card_matches_the_cpu(cuda):
    """The VAE's negative ELBO with one fixed noise, and its gradients,
    card against CPU in f64 within 1e-10."""
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves, tree_map
    rs = np.random.RandomState(6)
    x = rs.randn(8, 10)
    eps = [rs.randn(8, 4) for _ in range(2)]
    out = []
    for device in (cuda, "cpu"):
        net = _vae_net(device)
        live = tree_map(lambda t: t.clone().requires_grad_(True),
                        net.params["0"])
        score = net.layers[0].pretrain_score(
            live, torch.from_numpy(x).to(device),
            eps=[torch.from_numpy(e) for e in eps])
        grads = torch.autograd.grad(score, tree_leaves(live))
        out.append((score.detach().cpu(), [g.cpu() for g in grads]))
    (gs, gg), (cs, cg) = out
    assert abs(float(gs) - float(cs)) <= 1e-10 * abs(float(cs))
    for a, b in zip(gg, cg):
        assert (a - b).abs().max().item() <= 1e-10 * b.abs().max().item()


@pytest.mark.parametrize("case", ["yolo_head", "vae"])
def test_gradient_checks_pass_on_the_card(cuda, case):
    """check_gradients in f64 on the card: a conv + Yolo2OutputLayer net
    and a VAE under a softmax head."""
    from deeplearning4j_tpu_torch import gradientcheck as pgc
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer, Yolo2OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    rs = np.random.RandomState(7)
    if case == "vae":
        net = _vae_net(cuda)
        x = rs.randn(6, 10)
        y = np.eye(3)[rs.randint(0, 3, 6)]
    else:
        conf = (NeuralNetConfiguration.Builder().seed(0).updater(Sgd(1e-2))
                .list()
                .layer(ConvolutionLayer(n_out=14, kernel=(3, 3),
                                        stride=(2, 2),
                                        convolution_mode="same"))
                .layer(Yolo2OutputLayer(anchors=((1.0, 1.0), (0.5, 0.5)),
                                        n_classes=2))
                .set_input_type(InputType.convolutional(4, 4, 3)).build())
        net = MultiLayerNetwork(conf, device=cuda).init()
        x = rs.rand(2, 4, 4, 3)
        y = np.zeros((2, 2, 2, 6))
        y[0, 0, 0] = [0.1, 0.1, 0.9, 0.9, 1, 0]
        y[1, 1, 1] = [1.2, 1.2, 1.9, 1.8, 0, 1]
    res = pgc.check_gradients(net, x, y, max_per_param=8,
                              max_rel_error=2e-3)
    assert res.passed, (res.worst_param, res.max_rel_error, res.failures)
    assert res.n_params_checked >= 16


def test_tinyyolo_graph_fit_is_bitwise_the_per_call_fit(cuda):
    """The YOLO loss captures: TinyYOLO's fit(scan_steps=3) replays equal
    its per-call steps bitwise, from one init (cuDNN deterministic), in
    f32 and under bf16 compute."""
    import dataclasses
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo import TinyYOLO
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    batches = [DataSet(*_yolo_batch(seed=s)) for s in range(6)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for compute in (None, "bfloat16"):
            conf = dataclasses.replace(
                TinyYOLO(num_classes=3, input_shape=(64, 64, 3)).conf(),
                compute_dtype=compute)
            nets = []
            for scan in (1, 3):
                net = ComputationGraph(conf, device=cuda).init()
                net.fit(ExistingDataSetIterator(batches), scan_steps=scan)
                nets.append(net)
            assert nets[0].iteration_count == nets[1].iteration_count == 6
            for tree in ("params", "state"):
                for a, b in zip(tree_leaves(getattr(nets[0], tree)),
                                tree_leaves(getattr(nets[1], tree))):
                    assert torch.equal(a, b)
    finally:
        torch.backends.cudnn.deterministic = deterministic


# ------------------------------------ serving runtime: spec, spill, swap
_SERVE_LM = ("zoo:TransformerLM?vocab_size=64&seq_length=64&n_layers=2"
             "&n_embd=64&n_heads=2&mlp_ratio=2")


def test_spec_verify_on_the_card_is_bitwise_sequential_steps(cuda):
    """On the card, one k-drafted verify gives, position for position,
    the bitwise logits of k+1 sequential decode steps of the same engine
    state (k+1 unrolled step bodies: the same cuBLAS shapes), both as
    replays of the programs' captured graphs."""
    from deeplearning4j_tpu_torch.serving.decode import (
        DecodeConfig, DecodeEngine,
    )
    from deeplearning4j_tpu_torch.serving.registry import load_servable
    net = load_servable(_SERVE_LM, device=cuda)
    cfg = DecodeConfig(slots=4, page_size=16, prefill_buckets=(16, 64),
                       spec_k=4)
    a = DecodeEngine(net, cfg, name="seq")
    b = DecodeEngine(net, dataclasses.replace(cfg, spec_draft="int8"),
                     name="verify")
    try:
        for e in (a, b):
            e.warm()
        assert "decode" in a._graphs and "verify_5" in b._graphs
        replays = (a.graph_stats["replays"], b.graph_stats["replays"])
        k = 4
        prompts = [np.arange(1, 14), np.arange(5, 40) % 64]
        slots = []
        for p in prompts:
            sa, sb = a.cache.admit(len(p)), b.cache.admit(len(p))
            assert sa == sb
            assert a.prefill(sa, p, 0.0, 0)[0] == b.prefill(sb, p, 0.0, 0)[0]
            slots.append(sa)
        seq, toks = [], []
        for _ in range(k + 1):
            tk, _, lg = a.step()
            seq.append(lg.clone())
            toks.append(tk.copy())
        act = np.zeros((4,), bool)
        drafted = np.zeros((4, k), np.int64)
        for s in slots:
            assert b.cache.ensure_capacity(s, k + 1)
            act[s] = True
            drafted[s] = [toks[i][s] for i in range(k)]
        with torch.no_grad():
            vlog = b._verify(b._last_tokens, act,
                             torch.from_numpy(drafted).to(cuda),
                             np.arange(4, dtype=np.int64))
        for s in slots:
            for i in range(k + 1):
                assert torch.equal(vlog[s, i], seq[i][s]), (s, i)
        # the prefills and steps replayed a, the prefills and the verify b
        assert a.graph_stats["replays"] - replays[0] == len(prompts) + k + 1
        assert b.graph_stats["replays"] - replays[1] == len(prompts) + 1
        assert a.graph_stats["captures"] == len(a._graphs)
        assert a.request_path_first_runs == b.request_path_first_runs == 0
    finally:
        a.close()
        b.close()


def _replay_log(engine, log):
    """Make every program run of `engine` first run its function eagerly
    on the card (outputs cloned), then replay its graph: `log` gets
    (program, eager outputs, replayed outputs)."""
    real = engine._run

    def run(program, fn):
        eager = [t.clone() for t in _tensors(fn())]
        out = real(program, fn)
        log.append((program, eager, [t.clone() for t in _tensors(out)]))
        return out

    engine._run = run


def _tensors(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def test_decode_programs_replay_bitwise_their_eager_runs(cuda):
    """warm() captures every prefill and chunk bucket, decode[_sampling],
    draft_k[_sampling] and verify_{k+1}; on live traffic (prefills, a
    chunk after a cached prefix, greedy and sampled steps, greedy and
    sampled speculative rounds) each replay's tokens and logits are
    bitwise the same function run eagerly on the card for the same
    operands, one (seed, counter) giving one sample; the round stays one
    host sync and no program first runs on the request path."""
    from deeplearning4j_tpu_torch.serving.decode import (
        DecodeConfig, DecodeEngine,
    )
    from deeplearning4j_tpu_torch.serving.registry import load_servable
    net = load_servable(_SERVE_LM, device=cuda)
    k = 4
    eng = DecodeEngine(net, DecodeConfig(
        slots=2, page_size=16, prefill_buckets=(16, 64), spec_draft="int8",
        spec_k=k, prefill_chunk_tokens=16), name="graphs")
    try:
        eng.warm()
        d = eng.draft
        ladder = [f"{kind}_{tb}" for kind in ("chunk", "prefill")
                  for tb in (16, 64)]
        assert sorted(eng._graphs) == sorted(
            ladder + ["decode", "decode_sampling", f"verify_{k + 1}"])
        assert sorted(d._graphs) == sorted(
            ladder + [f"draft_{k}", f"draft_{k}_sampling"])
        g = eng.describe()["graphs"]
        assert g["pool_bytes"] > 0 and g["captures"] == len(eng._graphs)
        assert eng.describe()["spec"]["draft_graphs"]["pool_bytes"] > 0
        assert eng._pool != d._pool
        log = []
        for e in (eng, d):
            _replay_log(e, log)
        rs = np.random.RandomState(6)
        prefix = rs.randint(0, 64, 16)
        prompts = [np.concatenate([prefix, rs.randint(0, 64, 9)]),
                   np.concatenate([prefix, rs.randint(0, 64, 20)])]
        for i, prompt in enumerate(prompts):
            info = eng.admit_prompt(prompt)
            origin = eng.draft_prefill_origin(info.slot)
            if i == 0:
                eng.prefill(info.slot, prompt, 0.0, 0)
                eng.draft_prefill(info.slot, prompt, origin,
                                  len(prompt) - origin, 0.0, 0)
                eng.cache.register_prefix(info.slot, prompt)
                eng.draft_prefill_done(info.slot, prompt)
            else:
                assert info.cached_len == 16
                for start in (16, 32):          # two 16-token chunks
                    eng.prefill_chunk(info.slot, prompt, start,
                                      min(16, len(prompt) - start), 1.0, 5)
                eng.draft_prefill(info.slot, prompt, origin,
                                  len(prompt) - origin, 1.0, 5)
        for _ in range(2):
            eng.step()                          # one slot samples
        syncs = eng.spec_stats["host_syncs"]
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for _ in range(3):
                    assert eng.spec_step()      # greedy and sampled rows
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert sum("synchroniz" in str(w.message) for w in caught) <= 3
        assert eng.spec_stats["host_syncs"] - syncs == 3
        programs = {p for p, _, _ in log}
        assert {"prefill_64", "chunk_16", "chunk_64", "decode_sampling",
                f"draft_{k}_sampling", f"verify_{k + 1}"} <= programs
        for program, eager, replay in log:
            for a, b in zip(eager, replay):
                assert torch.equal(a, b), program
        assert eng.request_path_first_runs == d.request_path_first_runs == 0
        assert eng.graph_stats["captures"] == len(eng._graphs)
    finally:
        eng.close()
    assert eng._graphs == {} and eng.graph_pool_bytes() == 0


def test_decode_noise_replays_the_eager_draw(cuda):
    """The sampler's Gumbel noise on the card is a pure function of (seed,
    counter, element): eager draws repeat, a captured draw replays the
    eager one bitwise for each counter written into its operand, and the
    card's noise is the CPU's to within the two devices' log()."""
    from deeplearning4j_tpu_torch.serving.decode import gumbel_noise
    counter = torch.zeros((), dtype=torch.int64, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        gumbel_noise(3, counter, (4, 1000), cuda)
        graph.capture_begin(capture_error_mode="thread_local")
        out = gumbel_noise(3, counter, (4, 1000), cuda)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for c in (0, 7, 2 ** 33 + 5):
        counter.fill_(c)
        graph.replay()
        eager = gumbel_noise(3, c, (4, 1000), cuda)
        assert torch.equal(out, eager) and torch.isfinite(eager).all()
        torch.testing.assert_close(eager.cpu(),
                                   gumbel_noise(3, c, (4, 1000), "cpu"),
                                   atol=1e-5, rtol=1e-5)


def test_lm_swap_captures_while_streams_run_and_frees_old_graphs(cuda):
    """A swap while two streams decode: the new version warms and captures
    on the swapping thread with no error while the old version's
    scheduler keeps replaying; the streams finish on v1 with v1's tokens;
    once the old version is dropped and drained its graphs and their
    memory pool are released (no segment of it after empty_cache)."""
    import threading

    from deeplearning4j_tpu_torch.serving.decode import DecodeConfig
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    registry = ModelRegistry(device=cuda)
    served = registry.deploy_lm("g", _SERVE_LM, decode=DecodeConfig(
        slots=2, page_size=16, prefill_buckets=(16, 64)))
    try:
        old = served.scheduler.admitting_engine()
        pool = tuple(old._pool)
        assert old.graph_pool_bytes() > 0

        def tokens(prompt):
            req = served.generate(prompt, max_new_tokens=40)
            out = []
            while True:
                kind, payload = req.events.get(timeout=120)
                if kind == "token":
                    out.append(payload)
                elif kind == "done":
                    return out, payload["version"]
                else:
                    raise payload

        prompts = [[1, 2, 3], [7, 8, 9, 10]]
        want = [tokens(p)[0] for p in prompts]
        got = [None, None]

        def stream(i):
            got[i] = tokens(prompts[i])

        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(2)]
        steps, deadline = old.steps, time.monotonic() + 60
        for th in threads:
            th.start()
        while old.steps < steps + 3 and time.monotonic() < deadline:
            time.sleep(0.001)
        served.swap(_SERVE_LM + "&seed=99", keep_versions=1)
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
        assert got == [(w, 1) for w in want]
        new = served.scheduler.admitting_engine()
        assert new is not old and new.request_path_first_runs == 0
        assert new.graph_stats["captures"] == len(new._graphs) > 0
        deadline = time.monotonic() + 60
        while not old._closed and time.monotonic() < deadline:
            time.sleep(0.01)
        assert old._closed and old._graphs == {}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        assert not [seg for seg in torch.cuda.memory_snapshot()
                    if tuple(seg.get("segment_pool_id", ())) == pool]
        assert tokens([1, 2, 3])[1] == 2
    finally:
        registry.shutdown(drain=False)


def test_spilled_page_comes_back_bitwise_on_the_card(cuda):
    """A retained page demoted to the host tier (extract, frame, shared
    memory) and promoted back (pinned staging, async copy) holds the
    bitwise K/V it held before, and the prefix decodes the same tokens."""
    from deeplearning4j_tpu_torch.serving.decode import (
        DecodeConfig, DecodeEngine,
    )
    from deeplearning4j_tpu_torch.serving.registry import load_servable
    net = load_servable(_SERVE_LM, device=cuda)
    eng = DecodeEngine(net, DecodeConfig(slots=2, page_size=16,
                                         prefill_buckets=(16, 64),
                                         spill_pages=8), name="spill")
    try:
        eng.warm()
        prompt = np.arange(3, 36) % 64                   # 2 pages + 1
        info = eng.admit_prompt(prompt)
        tok0, _ = eng.prefill(info.slot, prompt, 0.0, 0)
        eng.cache.register_prefix(info.slot, prompt)
        pages = [int(p) for p in eng.cache.page_table[info.slot, :2]]
        before = [(eng._kpool[:, p].clone(), eng._vpool[:, p].clone())
                  for p in pages]
        ref = [tok0] + [int(eng.step()[0][info.slot]) for _ in range(6)]
        eng.release_slot(info.slot)
        with eng.cache._lock:
            while eng.cache._retained:
                eng.cache._evict_locked()
        assert eng.fabric["demoted"] == 2 and len(eng.spill) == 2
        info = eng.admit_prompt(prompt)
        assert info.cached_len == 32 and eng.fabric["landed"] == 2
        for i, p in enumerate(eng.cache.page_table[info.slot, :2]):
            assert torch.equal(eng._kpool[:, int(p)], before[i][0])
            assert torch.equal(eng._vpool[:, int(p)], before[i][1])
        tok = eng.prefill_chunk(info.slot, prompt, 32, 1, 0.0, 0)
        got = [tok] + [int(eng.step()[0][info.slot]) for _ in range(6)]
        assert got == ref
        assert eng.request_path_first_runs == 0
    finally:
        eng.close()


def test_lm_swap_under_a_live_stream_on_the_card(cuda):
    """POST /swap while a greedy stream runs: every answer is 200, the
    live stream's tokens are those v1 gives with no swap, and after it
    the servable answers v2 with v2's tokens."""
    import json
    import urllib.request

    from deeplearning4j_tpu_torch.serving.decode import DecodeConfig
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.serving.server import ModelServer
    registry = ModelRegistry(device=cuda)
    registry.deploy_lm("g", _SERVE_LM, decode=DecodeConfig(
        slots=2, page_size=16, prefill_buckets=(16, 64)))
    server = ModelServer(registry, port=0)

    def post(path, payload):
        return urllib.request.urlopen(urllib.request.Request(
            server.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}), timeout=300)

    def tokens(stream=False):
        with post("/v1/models/g/generate", {"prompt": [1, 2, 3],
                                            "max_tokens": 40,
                                            "stream": stream}) as r:
            assert r.status == 200
            return json.loads(r.read())

    try:
        want_v1 = tokens()["tokens"]
        r1 = post("/v1/models/g/generate", {"prompt": [1, 2, 3],
                                            "max_tokens": 40})
        assert r1.status == 200 and r1.headers["X-Model-Version"] == "1"
        first = json.loads(r1.readline()[6:])
        with post("/v1/models/g/swap",
                  {"source": _SERVE_LM + "&seed=99"}) as sw:
            assert sw.status == 200
            assert json.loads(sw.read())["active"]["version"] == 2
        rest = [json.loads(line[6:]) for line in r1
                if line.startswith(b"data: ")]
        r1.close()
        assert rest[-1]["done"] and rest[-1]["version"] == 1
        got = [first["token"]] + [e["token"] for e in rest if "token" in e]
        assert got == want_v1
        v2 = tokens()
        assert v2["version"] == 2 and v2["tokens"] == tokens()["tokens"]
        assert v2["tokens"] != want_v1
    finally:
        server.drain(timeout=30)


def _ring(tmp, x, y, batch, workers=2, copy=False):
    from deeplearning4j_tpu_torch.data.pipeline import (
        MultiProcessDataSetIterator, ShardBatchLoader,
    )
    from deeplearning4j_tpu_torch.data.shards import ShardWriter
    d = str(tmp / f"shards-{x.shape[1]}")
    with ShardWriter(d, shard_records=16) as w:
        w.add_batch(x, y.argmax(1).astype(np.int32))
        w.num_classes = y.shape[1]
    return MultiProcessDataSetIterator(ShardBatchLoader(d, batch),
                                       num_workers=workers, copy=copy)


@pytest.mark.parametrize("mode", ["scan3", "accumulate2", "per_call"])
def test_resnet_from_the_ring_is_bitwise_the_memory_fit(cuda, tmp_path,
                                                        mode, monkeypatch):
    """ResNet50 at 64², batch 4, two chunks of 3, cuDNN deterministic:
    the ring with view batches, the ring with copies and memory give
    bitwise-equal parameters and batch-norm state."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.data.normalization import (
        ImagePreProcessingScaler,
    )
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    kw = {"scan3": {"scan_steps": 3}, "accumulate2": {"accumulate_steps": 2},
          "per_call": {}}[mode]
    if mode == "per_call":
        monkeypatch.setenv("DL4J_CUDA_FIT_PREFETCH", "0")
    rs = np.random.RandomState(7)
    x8 = rs.randint(0, 256, (24, 64, 64, 3), dtype=np.uint8)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 24)]
    path = save_model(ComputationGraph(
        ResNet50(num_classes=10, input_shape=(64, 64, 3)).conf(),
        device="cpu").init(), str(tmp_path / "r.zip"))
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    nets = []
    for source in ("view", "copy", "memory"):
        if source == "memory":
            it = ExistingDataSetIterator([DataSet(x8[i:i + 4], y[i:i + 4])
                                          for i in range(0, 24, 4)])
        else:
            it = _ring(tmp_path, x8, y, 4, copy=source == "copy")
        it.set_pre_processor(ImagePreProcessingScaler())
        net = load_model(path)
        try:
            net.fit(it, **kw)
        finally:
            if source != "memory":
                assert it._copy is (source == "copy")
                it.close()
        nets.append(net)
    for other in nets[1:]:
        for a, b in zip(tree_leaves(nets[0].params) + tree_leaves(
                nets[0].state), tree_leaves(other.params)
                + tree_leaves(other.state)):
            assert torch.equal(a, b)


def test_ring_views_feed_a_cuda_fit(cuda, tmp_path):
    """copy=False ring batches through fit's default prefetch (a pinned
    host copy before the next pull) and through scan_steps=4 without
    prefetch (the ring flips to copies for the fit): bitwise the fit
    over the same batches from memory, and the ring keeps its mode."""
    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    rs = np.random.RandomState(5)
    X = rs.randn(256, 4).astype("float32")
    Y = np.eye(3, dtype="float32")[rs.randint(0, 3, 256)]
    for kw in ({}, {"scan_steps": 4, "prefetch": False}):
        mem = _dropout_mlp(cuda)
        mem.fit(ArrayDataSetIterator(X, Y, batch_size=32), epochs=2, **kw)
        net = _dropout_mlp(cuda)
        with _ring(tmp_path, X, Y, 32) as pipe:
            net.fit(pipe, epochs=2, **kw)
            assert pipe._copy is False and pipe.num_workers == 2
            assert sum(pipe.stats["batches"].values()) == 16
        assert _same(mem, net), kw


# --------------------------------------------------------------- telemetry
def _telemetry_off():
    from deeplearning4j_tpu_torch import monitor
    monitor.REGISTRY.reset()
    monitor.disable_tracing()
    monitor.clear_trace()
    monitor.goodput.disable_goodput()
    monitor.xla.disable_ledger()
    monitor.xla.clear_ledger()


@pytest.fixture
def telemetry():
    from deeplearning4j_tpu_torch import monitor
    _telemetry_off()
    yield monitor
    _telemetry_off()


def _token_batches(vocab, b, t, n, seed=0):
    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b * n, t, 1)).astype("float32")
    labels = np.eye(vocab, dtype="float32")[rs.randint(0, vocab, (b * n, t))]
    return ArrayDataSetIterator(ids, labels, batch_size=b)


def test_ledger_counts_a_flash_lms_flops_on_the_card(cuda, telemetry):
    """The flash kernels are ctypes launches the FLOP counter cannot see:
    the ledger adds them by formula, so the card's count equals the
    analytic one (every matmul, 18·D per causal live pair) as on the
    CPU; the allocator peak fills the HBM breakdown."""
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    b, t, layers, e, heads, vocab = 2, 128, 2, 64, 2, 64
    telemetry.xla.enable_ledger()
    lm = model_by_name("TransformerLM", vocab_size=vocab, seq_length=t,
                       n_layers=layers, n_embd=e, n_heads=heads,
                       attention_impl="flash").init(device=cuda)
    before = dict(KERNEL_LAUNCHES)
    lm.fit(_token_batches(vocab, b, t, 2), scan_steps=1)
    assert all(KERNEL_LAUNCHES[k] > before[k] for k in before)
    (rec,) = telemetry.xla.records()
    d = e // heads
    analytic = 6 * (12 * e * e * layers + e * vocab) * b * t \
        + 18 * d * fa.live_pairs(t, t, True) * b * heads * layers
    assert rec.flops == analytic
    assert rec.hbm["temp_bytes"] > 0 and rec.hbm["argument_bytes"] > 0
    assert rec.arg_shardings and set(rec.arg_shardings) <= {"single",
                                                            "host"}


def test_train_mfu_pct_is_set_on_the_card(cuda, telemetry, monkeypatch):
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    if torch.cuda.get_device_name(0) \
            not in telemetry.xla.PEAK_FLOPS_BY_KIND:
        monkeypatch.setenv("DL4J_CUDA_PEAK_FLOPS", "989e12")
    telemetry.xla.enable_ledger()
    lm = model_by_name("TransformerLM", vocab_size=64, seq_length=128,
                       n_layers=2, n_embd=64, n_heads=2,
                       attention_impl="flash").init(device=cuda)
    lm.fit(_token_batches(64, 2, 128, 12), scan_steps=4)
    (rec,) = telemetry.xla.records()
    assert rec.name == "mln/scan_step" and rec.steps_per_call == 4
    mfu = telemetry.REGISTRY.collect("train_mfu_pct").value()
    assert mfu > 0 and mfu == telemetry.xla.last_mfu("train")


def _syncs(fn):
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


def test_telemetry_on_adds_no_sync_to_a_replayed_step(cuda, telemetry):
    """Tracing, the ledger and goodput on: the same host syncs per fit as
    with everything off, once the step is captured."""
    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    rs = np.random.RandomState(3)
    X = rs.randn(256, 4).astype("float32")
    Y = np.eye(3, dtype="float32")[rs.randint(0, 3, 256)]
    net = _dropout_mlp(cuda)

    def fit():
        net.fit(ArrayDataSetIterator(X, Y, batch_size=32), scan_steps=4)

    fit()                                   # capture, telemetry off
    off = [_syncs(fit), _syncs(fit)]
    telemetry.enable_tracing()
    telemetry.xla.enable_ledger()
    telemetry.goodput.enable_goodput()
    fit()                                   # one eager counted step
    (rec,) = telemetry.xla.records()
    assert rec.name == "mln/scan_step" and rec.flops > 0
    on = [_syncs(fit), _syncs(fit)]         # replays only
    # a pinned block the host allocator happens to grow can add one sync
    # to a fit, on or off: compare the fewest
    assert min(on) == min(off) == 2         # one loss fetch a chunk
    cats = telemetry.goodput.last_session()["categories"]
    assert cats["step_compute"] > 0
    assert telemetry.summary()["train_iterations_total"] == 6 * 8


# ------------------------------------------------------------- resilience
def _flash_lm(device, seed=5):
    import dataclasses
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = model_by_name("TransformerLM", vocab_size=64, seq_length=128,
                         n_layers=2, n_embd=64, n_heads=2, dropout=0.1,
                         attention_impl="flash", seed=seed).conf()
    conf = dataclasses.replace(conf, layers=[
        dataclasses.replace(l, attention_dropout=0.0)
        if hasattr(l, "attention_dropout") else l for l in conf.layers])
    return MultiLayerNetwork(conf, device=device).init()


def _resilient_case(case, device):
    """(a network on the card, a fresh iterator over its data)."""
    if case == "mlp":
        return _dropout_mlp(device), lambda: _blob_iter(n=256)
    return _flash_lm(device), lambda: _token_batches(64, 2, 128, 6, seed=4)


def _same_state(a, b) -> bool:
    from deeplearning4j_tpu_torch.nn.step_graph import tree_tensors
    return all(torch.equal(x, y) for x, y in zip(
        tree_tensors(a.params, a.opt_state, a.state),
        tree_tensors(b.params, b.opt_state, b.state)))


@pytest.mark.parametrize("case", ["mlp", "flash_lm"])
def test_a_guarded_resilient_fit_on_the_card_is_the_per_call_fit(
        cuda, tmp_path, case):
    """ResilientTrainer's guarded step (device snapshot, generator state)
    is bitwise the per-call fit's step, dropout included; the flash LM's
    steps launch each kernel n_layers times."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.train.resilience import (
        FaultPolicy, ResilientTrainer,
    )
    plain, data = _resilient_case(case, cuda)
    plain.fit(data(), epochs=2, scan_steps=1)
    net, _ = _resilient_case(case, cuda)
    before = dict(fa.KERNEL_LAUNCHES)
    rep = ResilientTrainer(net, str(tmp_path), save_every_n_iterations=3,
                           policy=FaultPolicy()).fit(data(), epochs=2)
    assert rep.applied_steps == plain.iteration_count
    assert _same_state(plain, net)
    assert net.score() == plain.score()
    if case == "flash_lm":
        assert fa.KERNEL_LAUNCHES["flash_fwd"] - before["flash_fwd"] \
            == 2 * rep.applied_steps


def test_a_retry_on_the_card_restores_tensors_and_generator(
        cuda, tmp_path, monkeypatch):
    """A transient error raised after the failed attempt ran (tensors
    updated in place, dropout noise drawn on the card's generator): the
    retry is bitwise the unfaulted step, and so is the whole run."""
    from deeplearning4j_tpu_torch.train import resilience
    clean, data = _resilient_case("flash_lm", cuda)
    resilience.ResilientTrainer(clean, str(tmp_path / "a"),
                                policy=resilience.FaultPolicy(
                                    backoff_base=0.001)).fit(data(), epochs=2)
    real_step = resilience._NetDriver.step
    failed = []

    def step_then_fail(self, batch, generator):
        out = real_step(self, batch, generator)
        if self.net.iteration_count == 4 and not failed:
            failed.append(float(out[0]))
            raise resilience.TransientFaultError("after the step")
        return out

    monkeypatch.setattr(resilience._NetDriver, "step", step_then_fail)
    net, _ = _resilient_case("flash_lm", cuda)
    rep = resilience.ResilientTrainer(
        net, str(tmp_path / "b"),
        policy=resilience.FaultPolicy(backoff_base=0.001)).fit(data(),
                                                                epochs=2)
    assert rep.retries == 1 and failed
    assert _same_state(clean, net)
    assert torch.equal(clean._dropout_gen.get_state(),
                       net._dropout_gen.get_state())


def test_an_async_checkpoint_on_the_card_is_the_sync_one(cuda, tmp_path):
    """An async CheckpointListener's zip holds bitwise what a synchronous
    save at the same iteration holds, though the steps after it updated
    the card's tensors in place while the worker wrote it; once the
    pinned buffers are cached it adds no host sync to a fit."""
    import io
    import os
    import zipfile
    from deeplearning4j_tpu_torch.train import CheckpointListener

    def fit(directory, async_save):
        net, data = _resilient_case("flash_lm", cuda)
        with CheckpointListener(str(directory), save_every_n_iterations=2,
                                keep_last=10, async_save=async_save) as ck:
            net.set_listeners(ck)
            net.fit(data(), epochs=1, scan_steps=1, prefetch=False)
        return net

    fit(tmp_path / "async", True)
    fit(tmp_path / "sync", False)
    names = sorted(os.listdir(str(tmp_path / "async")))
    assert names == sorted(os.listdir(str(tmp_path / "sync"))) and names
    for name in names:
        za = zipfile.ZipFile(str(tmp_path / "async" / name))
        zb = zipfile.ZipFile(str(tmp_path / "sync" / name))
        assert sorted(za.namelist()) == sorted(zb.namelist())
        for entry in za.namelist():
            a, b = za.read(entry), zb.read(entry)
            if entry.endswith(".npz"):
                with np.load(io.BytesIO(a)) as x, np.load(io.BytesIO(b)) as y:
                    for k in x.files:
                        np.testing.assert_array_equal(x[k], y[k])
            else:
                assert a == b, entry
    net, data = _resilient_case("flash_lm", cuda)
    plain = [_syncs(lambda: net.fit(data(), scan_steps=1, prefetch=False))
             for _ in range(2)]
    with CheckpointListener(str(tmp_path / "again"),
                            save_every_n_iterations=1, keep_last=1,
                            async_save=True) as ck:
        net.set_listeners(ck)
        warm = [_syncs(lambda: net.fit(data(), scan_steps=1,
                                       prefetch=False)) for _ in range(2)]
    assert warm[-1] == plain[-1], (plain, warm)


def _lenet(device):
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-3))
            .list()
            .layer(ConvolutionLayer(n_out=20, kernel=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=50, kernel=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=120, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.convolutional(28, 28, 1)).build())
    return MultiLayerNetwork(conf, device=device).init()


def test_memory_report_on_the_card_leaves_the_network_and_measures(cuda):
    """memory_report's measured step on the card: the allocator's peak in
    the reference's hbm_stats keys, the network bitwise unchanged (with
    dropout and a live optimizer state and generator), and, for the
    reference's own case (LeNet, batch 16, tests/test_memory.py:53), the
    analytic total within 2x of the measured one."""
    from deeplearning4j_tpu_torch.nn.step_graph import tree_tensors
    net, data = _resilient_case("mlp", cuda)
    net.fit(data(), scan_steps=1)

    def state():
        return ([t.clone() for t in tree_tensors(net.params, net.opt_state,
                                                 net.state)],
                net._dropout_gen.get_state().clone(),
                (net.iteration_count, net.epoch_count, net._score))
    before = state()
    rep = net.memory_report(batch_size=64)
    after = state()
    assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
    assert torch.equal(before[1], after[1]) and before[2] == after[2]
    assert set(rep.compiled) == {"argument_bytes", "output_bytes",
                                 "temp_bytes", "alias_bytes",
                                 "generated_code_bytes"}
    assert rep.compiled["temp_bytes"] > 0
    lenet = _lenet(cuda)
    rep = lenet.memory_report(batch_size=16)
    ratio = rep.total_train_bytes / rep.compiled_total_bytes
    assert 0.5 <= ratio <= 2.0, (rep.total_train_bytes, rep.compiled)


# ------------------------------------------------------------ the fleet
def _fleet_lm_zip(path):
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.util.serialization import save_model
    net = model_by_name("TransformerLM", vocab_size=64, seq_length=128,
                        n_layers=2, n_embd=64, n_heads=2,
                        attention_impl="flash").init(device="cuda")
    save_model(net, str(path))
    return str(path)


def _fleet_predict(url, x):
    import io
    import urllib.request
    buf = io.BytesIO()
    np.save(buf, x)
    r = urllib.request.urlopen(urllib.request.Request(
        url + "/v1/models/lm/predict", data=buf.getvalue(),
        headers={"Content-Type": "application/octet-stream",
                 "Accept": "application/octet-stream"}), timeout=120)
    return r.status, np.load(io.BytesIO(r.read()))


def test_an_in_process_fleet_serves_through_the_kernel(cuda, tmp_path):
    """The CLI's fleet mode with two in-process replicas on the card:
    every predict through the router runs the flash forward kernel in the
    replica that served it (n_layers launches a batcher dispatch, both
    replicas dispatching, no backward launch), and each answer is within
    1e-4 of the same network with plain attention."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.serving import cli
    zip_path = _fleet_lm_zip(tmp_path / "lm.zip")
    args = cli.build_parser().parse_args(
        ["--model", f"lm={zip_path}", "--replicas", "2", "--replica-mode",
         "inprocess", "--buckets", "1,4", "--device", "cuda", "--port",
         "0"])
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0
    fleet = cli.build_fleet(args)
    try:
        served = [r._registry.get("lm") for r in fleet.supervisor.replicas]
        rs = np.random.RandomState(0)
        pairs = []
        for i in range(10):
            x = rs.randint(0, 64, (1 + 3 * (i % 2), 128, 1)) \
                .astype("float32")
            status, y = _fleet_predict(fleet.url, x)
            assert status == 200 and y.shape == (x.shape[0], 128, 64)
            pairs.append((x, y))
        dispatches = sum(s.batcher.dispatches for s in served)
        assert KERNEL_LAUNCHES["flash_fwd"] == 2 * dispatches
        assert KERNEL_LAUNCHES["flash_bwd_dq"] == 0
        assert KERNEL_LAUNCHES["flash_bwd_dkv"] == 0
        assert all(s.batcher.dispatches > 2 for s in served)   # 2 warms
        real = fa.flash_attention_cuda
        fa.flash_attention_cuda = \
            lambda q, k, v, mask, causal: fa.flash_attention_plain(
                q, k, v, mask, causal)
        try:
            for x, y in pairs:
                ref = served[0].model.output(x).float().cpu().numpy()
                assert np.abs(y - ref).max() <= 1e-4
        finally:
            fa.flash_attention_cuda = real
    finally:
        cli.drain_fleet(fleet, drain_timeout_s=1.0)
        monitor.flight.disable_flight()


def test_a_killed_subprocess_replica_rejoins_on_the_card(cuda, tmp_path):
    """Two subprocess replicas on one card behind the router; SIGKILL
    one: the router keeps answering 200 from the other, the supervisor
    relaunches the killed one (generation 1) on the card, and its answers
    are bitwise those before the kill."""
    import time

    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.serving import (
        ReplicaSpec, ReplicaSupervisor, ResilientRouter, RouterServer,
        SubprocessReplica,
    )
    from deeplearning4j_tpu_torch.tools.serve_chaos import replica_env
    zip_path = _fleet_lm_zip(tmp_path / "lm.zip")
    spec = ReplicaSpec([("lm", zip_path)], buckets=(1,), device="cuda")
    env = replica_env()
    sup = ReplicaSupervisor(
        lambda i: SubprocessReplica(f"replica-{i}", spec, env=env,
                                    stderr_path=str(tmp_path / f"r{i}.log")),
        2, probe_interval_s=0.5, restart_backoff_s=0.2)
    sup.start()
    server = RouterServer(ResilientRouter(sup.healthy, hedge=False))
    x = np.random.RandomState(1).randint(0, 64, (1, 128, 1)) \
        .astype("float32")
    try:
        victim = sup.replicas[0]
        _, before = _fleet_predict(victim.url, x)
        t0 = time.monotonic()
        victim.proc.kill()
        while not (victim.generation >= 1 and victim.state == "ready"):
            status, y = _fleet_predict(server.url, x)
            assert status == 200 and np.array_equal(y, before)
            assert time.monotonic() - t0 < 150, victim.describe()
            time.sleep(0.2)
        status, after = _fleet_predict(victim.url, x)
        assert status == 200 and np.array_equal(after, before)
        assert monitor.REGISTRY.collect(
            "serving_fleet_restarts_total").value(
            replica="replica-0", reason="crash") == 1
    finally:
        server.stop()
        sup.stop()


# ------------------------------------------------------ data parallelism
@pytest.fixture
def one_rank_group(cuda):
    """A one-rank process group of `backend` on the card, left after."""
    from deeplearning4j_tpu_torch.parallel.distributed import (
        DistributedConfig, free_port, initialize_distributed,
        shutdown_distributed,
    )

    def form(backend):
        initialize_distributed(DistributedConfig(
            coordinator_address=f"127.0.0.1:{free_port()}",
            num_processes=1, process_id=0, backend=backend),
            device_type="cuda")
    yield form
    shutdown_distributed()


@pytest.mark.parametrize("scan", [1, 4])
def test_a_plan_on_one_nccl_rank_is_bitwise_the_plain_fit(one_rank_group,
                                                          cuda, scan):
    """fit(plan=) over a one-rank NCCL group (the all-reduce of gradients
    and loss captured in the step's CUDA graph when scan_steps=4) is
    bitwise the plain fit, ZeRO-1's sharded update path included."""
    from deeplearning4j_tpu_torch.parallel import ShardingPlan
    one_rank_group("nccl")
    plain, planned = _lm(cuda, dropout=0.1), _lm(cuda, dropout=0.1)
    plain.fit(_lm_iter(), epochs=2, scan_steps=scan)
    planned.fit(_lm_iter(), epochs=2, scan_steps=scan,
                plan=ShardingPlan(zero_stage=1))
    assert _same(plain, planned) and plain.score() == planned.score()
    assert planned._plan_syncs > 0


def test_a_captured_step_under_gloo_is_refused(one_rank_group, cuda):
    """gloo's collectives cannot sit in a CUDA graph: a scan under a plan
    raises before any step, and per-call steps run."""
    from deeplearning4j_tpu_torch.parallel import ShardingPlan
    one_rank_group("gloo")
    net = _lm(cuda)
    with pytest.raises(RuntimeError, match="cannot"):
        net.fit(_lm_iter(), scan_steps=4, plan=ShardingPlan())
    assert net.iteration_count == 0
    net.fit(_lm_iter(), plan=ShardingPlan())
    assert net.iteration_count == 12 and np.isfinite(net.score())


# ------------------------------------------- sequence and pipeline slice
@pytest.fixture(scope="module")
def card_ranks():
    """Two spawned ranks (tests/_torch_dist): gloo groups on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from _torch_dist import RankPool
    pool = RankPool(2)
    yield pool
    pool.close()


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)],
                         ids=["causal", "masked"])
def test_the_flash_ring_on_two_card_ranks(card_ranks, causal, masked):
    """ring_flash_self_attention on two ranks of the card against the
    online ring on two CPU ranks: the same global inputs and outputs."""
    rs = np.random.RandomState(16)
    q, k, v, w = (rs.randn(2, 256, 2, 64).astype("float32")
                  for _ in range(4))
    mask = None
    if masked:
        mask = (rs.rand(2, 256) > 0.3).astype("float32")
        mask[1, 128:] = 0.0
    kw = dict(data=1, seq=2, q=q, k=k, v=v, w=w, mask=mask, causal=causal)
    card = card_ranks.run("ring_attention", 2, impl="flash", device="cuda",
                          block=128, **kw)
    cpu = card_ranks.run("ring_attention", 2, impl="online", **kw)
    for c in card:
        np.testing.assert_allclose(c["out"], cpu[0]["out"], atol=1e-4,
                                   rtol=0)
        for a, b in zip(c["grads"], cpu[0]["grads"]):
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
        assert c["launches"] == {"flash_fwd": 2, "flash_bwd_dq": 2,
                                 "flash_bwd_dkv": 2}
        assert c["transfers"]["routes"] == {"gloo_host": 2}


def _card_lm_zip(tmp_path):
    import dataclasses

    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
    from deeplearning4j_tpu_torch.util.serialization import save_model
    conf = TransformerLM(vocab_size=32, seq_length=128, n_layers=2,
                         n_embd=128, n_heads=2, seed=5,
                         attention_impl="flash").conf()
    conf = dataclasses.replace(conf, updater=Nesterovs(learning_rate=0.05,
                                                       momentum=0.9))
    path = str(tmp_path / "lm.zip")
    save_model(MultiLayerNetwork(conf, device="cpu").init(), path)
    rs = np.random.RandomState(3)
    x = rs.randint(0, 32, (12, 128)).astype("float32")
    y = np.eye(32, dtype="float32")[(x.astype(int) + 1) % 32]
    return path, x[..., None], y


@pytest.mark.parametrize("job,kw,per_step", [
    ("context_fit", dict(seq=2), 2 * 2),
    ("pipeline_fit", dict(stage=2, n_microbatches=4), (4 + 1) * 1)],
    ids=["context", "pipeline"])
def test_sequence_and_pipeline_fits_on_two_card_ranks(card_ranks, tmp_path,
                                                      job, kw, per_step):
    """Three steps of a flash LM on two card ranks: the ranks bitwise
    equal, every kernel launched `per_step` times a step and rank, the
    parameters within 1e-4 relative of two CPU ranks' fit."""
    path, x, y = _card_lm_zip(tmp_path)
    card = card_ranks.run(job, 2, zip_path=path, X=x, Y=y, batch=4,
                          device="cuda", **kw)
    cpu = card_ranks.run(job, 2, zip_path=path, X=x, Y=y, batch=4, **kw)
    np.testing.assert_array_equal(card[0]["flat"], card[1]["flat"])
    for c in card:
        assert c["iterations"] == 3
        assert c["launches"] == {n: 3 * per_step for n in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        assert set(c["routes"]) == {"gloo_host"}
    np.testing.assert_allclose(card[0]["flat"], cpu[0]["flat"], rtol=1e-4,
                               atol=1e-6)


# ------------------------------------------------------ embedding trainers
def _embedding_inputs(seed, V=40, D=16, N=64, K=5, L=6, W=8):
    rs = np.random.RandomState(seed)
    f = lambda *s: ((rs.rand(*s) - 0.5)).astype(np.float32)  # noqa: E731
    ids = lambda hi, *s: rs.randint(0, hi, s).astype(np.int64)  # noqa: E731
    labels = np.zeros((N, 1 + K), np.float32)
    labels[:, 0] = 1.0
    ctx_mask = (rs.rand(N, W) < 0.7).astype(np.float32)
    ctx_mask[:, 0] = 1.0
    # few ids for many rows: every id repeats within the batch, so the
    # card's scatter-adds sum the repeats in no fixed order
    return dict(w_in=f(V, D), w_out=f(V, D), syn1=f(V - 1, D),
                centers=ids(6, N), targets=ids(8, N, 1 + K), labels=labels,
                points=ids(V - 1, N, L),
                codes=rs.randint(0, 2, (N, L)).astype(np.float32),
                mask=(rs.rand(N, L) < 0.8).astype(np.float32),
                ctx_ids=ids(8, N, W), ctx_mask=ctx_mask)


EMBEDDING_STEPS = {
    "sg_ns": (("w_in", "w_out"), ("centers", "targets", "labels")),
    "sg_hs": (("w_in", "syn1"), ("centers", "points", "codes", "mask")),
    "cbow_hs": (("w_in", "syn1"), ("ctx_ids", "ctx_mask", "points",
                                   "codes", "mask")),
    "cbow_ns": (("w_in", "w_out"), ("ctx_ids", "ctx_mask", "targets",
                                    "labels")),
}


@pytest.mark.parametrize("step", sorted(EMBEDDING_STEPS))
def test_embedding_steps_on_the_card_match_the_cpu(cuda, step):
    """Each word2vec step in place on card tables against the same step
    on the CPU: within 1e-6 (f32, tables of magnitude <= 0.5)."""
    from deeplearning4j_tpu_torch.embeddings import sequencevectors as sv
    x = _embedding_inputs(7)
    tables, args = EMBEDDING_STEPS[step]
    out = {}
    for dev in ("cpu", cuda):
        ts = [torch.tensor(x[t], device=dev) for t in tables]
        loss = getattr(sv, f"_{step}_step")(
            *ts, *(torch.tensor(x[a], device=dev) for a in args), 0.9)
        out[str(dev)] = ([t.cpu().numpy() for t in ts], float(loss))
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert out["cuda"][1] == pytest.approx(out["cpu"][1], rel=1e-6)


def test_glove_step_on_the_card_matches_the_cpu(cuda):
    from deeplearning4j_tpu_torch.embeddings.glove import _glove_step
    rs = np.random.RandomState(8)
    V, D, N = 30, 16, 64
    tabs = [((rs.rand(V, D) - 0.5)).astype(np.float32) for _ in range(2)]
    tabs += [np.zeros(V, np.float32)] * 2
    tabs += [np.full((V, D), 1e-8, np.float32)] * 2
    tabs += [np.full(V, 1e-8, np.float32)] * 2
    rows = rs.randint(0, 5, N)
    cols = rs.randint(0, 5, N)
    logx = np.log(rs.rand(N) * 5 + 1).astype(np.float32)
    fx = rs.rand(N).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        ts = [torch.tensor(t, device=dev) for t in tabs]
        loss = _glove_step(*ts, *(torch.tensor(a, device=dev) for a in (
            rows, cols, logx, fx)), 0.05)
        out[str(dev)] = ([t.cpu().numpy() for t in ts], float(loss))
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    assert out["cuda"][1] == pytest.approx(out["cpu"][1], rel=1e-6)


def test_embedding_fits_default_to_the_card_and_match_the_cpu(cuda):
    """Word2Vec (skip-gram NS and CBOW HS), GloVe and ParagraphVectors fit
    on the card when no device is asked for, within 1e-5 (relative to
    the largest entry) of the same fit on the CPU."""
    from deeplearning4j_tpu_torch.embeddings import (
        Glove, ParagraphVectors, Word2Vec,
    )
    rs = np.random.RandomState(9)
    words = [f"w{i}" for i in range(40)]
    p = 1.0 / np.arange(1, 41)
    corpus = [" ".join(rs.choice(words, 20, p=p / p.sum()))
              for _ in range(30)]
    docs = [(f"d{i}", s) for i, s in enumerate(corpus[:8])]
    makers = {
        "sg_ns": (lambda: Word2Vec(layer_size=32, min_count=1,
                                   batch_size=64, seed=1), corpus),
        "cbow_hs": (lambda: Word2Vec(
            layer_size=32, min_count=1, batch_size=64, negative=0,
            use_hierarchic_softmax=True,
            elements_learning_algorithm="cbow", seed=2), corpus),
        "glove": (lambda: Glove(layer_size=32, min_count=1, epochs=2,
                                batch_size=64, seed=3), corpus),
        "pv": (lambda: ParagraphVectors(layer_size=32, min_count=1,
                                        batch_size=64, seed=4), docs)}
    for name, (make, src) in makers.items():
        card = make().fit(src)
        assert card.device.type == "cuda", name
        cpu = make().fit(src, device="cpu")
        for attr in ("vectors", "label_vectors"):
            if hasattr(cpu, attr):
                a, b = getattr(card, attr), getattr(cpu, attr)
                assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), \
                    (name, attr)


# ----------------------------------------- model import, estimators, the UI
def _mlp_dl4j_zip():
    """A Java DL4J MLP zip (4 -> 5 relu -> 3 softmax, Adam state)."""
    import io
    import json
    import zipfile
    from deeplearning4j_tpu_torch.modelimport.dl4j import write_nd4j_array
    rs = np.random.RandomState(4)
    n = 4 * 5 + 5 + 5 * 3 + 3
    adam = {"@class": "org.nd4j.linalg.learning.config.Adam",
            "learningRate": 1e-2}
    act = "org.nd4j.linalg.activations.impl.Activation"
    conf = {"confs": [
        {"layer": {"dense": {"activationFn": {"@class": act + "ReLU"},
                             "nin": 4, "nout": 5, "iUpdater": adam}}},
        {"layer": {"output": {
            "activationFn": {"@class": act + "Softmax"}, "nin": 5,
            "nout": 3, "iUpdater": adam, "lossFn": {
                "@class": "org.nd4j.linalg.lossfunctions.impl.LossMCXENT"}}}}]}
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf))
        for name, arr in (("coefficients.bin", rs.randn(n)),
                          ("updaterState.bin",
                           np.abs(rs.randn(2 * n)) * 1e-3)):
            b = io.BytesIO()
            write_nd4j_array(b, arr.astype(np.float32))
            zf.writestr(name, b.getvalue())
    return buf.getvalue()


def test_dl4j_restore_on_the_card_matches_the_cpu(cuda):
    """The DL4J bridge restores onto the card by default: parameters and
    Adam slots bitwise the CPU restore's, a predict and 3 fit steps
    within 1e-6 of the CPU's."""
    import io
    from deeplearning4j_tpu_torch.modelimport import (
        restore_multilayer_network,
    )
    from deeplearning4j_tpu_torch.modelimport.dl4j import _slot_holder
    blob = _mlp_dl4j_zip()
    card = restore_multilayer_network(io.BytesIO(blob))
    cpu = restore_multilayer_network(io.BytesIO(blob), device="cpu")
    assert card.device.type == "cuda"
    for a, b in ((card.params, cpu.params),
                 (_slot_holder(card, ("mu", "nu"))["mu"],
                  _slot_holder(cpu, ("mu", "nu"))["mu"])):
        for k in a:
            for name in a[k]:
                assert torch.equal(a[k][name].cpu(), b[k][name]), (k, name)
    rs = np.random.RandomState(5)
    x = rs.randn(8, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
    torch.testing.assert_close(card.output(x).cpu(), cpu.output(x),
                               rtol=0, atol=1e-6)
    for _ in range(3):
        card.fit((x, y), batch_size=8)
        cpu.fit((x, y), batch_size=8)
    for k in cpu.params:
        for name, t in cpu.params[k].items():
            torch.testing.assert_close(card.params[k][name].cpu(), t,
                                       rtol=0, atol=1e-6)


def _plain_summary(a, n_bins=20):
    """numpy's summary of one array, as the reference's StatsListener
    computes it on the host."""
    a = np.asarray(a, np.float64).ravel()
    finite = a[np.isfinite(a)]
    lo, hi = float(finite.min()), float(finite.max())
    if lo == hi:
        hi = lo + 1e-12
    counts, _ = np.histogram(finite, bins=n_bins, range=(lo, hi))
    return (float(np.linalg.norm(finite)), float(np.abs(finite).mean()),
            int(a.size - finite.size), counts.tolist(), lo, hi)


def test_stats_summaries_on_the_card_equal_numpys(cuda):
    """StatsListener's on-card summaries: histogram counts and bounds
    exactly numpy's, norms and mean magnitudes within 1e-12. A constant
    leaf of large magnitude, whose 20 edges repeat (numpy >= 2.3 refuses
    to bin it), is binned without raising."""
    from deeplearning4j_tpu_torch.ui.stats import _summarize
    rs = np.random.RandomState(6)
    arrays = {"w": rs.randn(4096, 33).astype(np.float32),
              "edges": np.linspace(-1, 1, 41).astype(np.float32)}
    arrays["w"][0, :3] = [np.nan, np.inf, -np.inf]
    got = _summarize({k: torch.from_numpy(v).cuda()
                      for k, v in {**arrays, "big": np.full(
                          5, 12345.5, np.float32)}.items()}, 20, True)
    assert sum(got["big"]["hist"]) == 5
    for k, a in arrays.items():
        norm, mean_mag, bad, hist, lo, hi = _plain_summary(a)
        g = got[k]
        assert (g["n_non_finite"], g["hist"], g["lo"], g["hi"]) \
            == (bad, hist, lo, hi), k
        assert abs(g["norm"] - norm) <= 1e-12 * norm
        assert abs(g["mean_mag"] - mean_mag) <= 1e-12 * mean_mag


def test_stats_listener_captures_on_the_card(cuda):
    """A fit on the card with a StatsListener: every record carries the
    params, gradients and updates of every leaf, and the device memory
    from torch. The last record's gradients and updates are the last
    step's: the updater on those gradients from the state before the step
    gives those updates bitwise, they added to the parameters before it
    give the parameters after it bitwise, and the record's summaries are
    numpy's of those tensors."""
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves, tree_map
    from deeplearning4j_tpu_torch.ui import (
        InMemoryStatsStorage, StatsListener,
    )
    from deeplearning4j_tpu_torch.ui.stats import _leaf_paths
    conf = (NeuralNetConfiguration.Builder().seed(2).list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(5)).build())
    net = MultiLayerNetwork(conf).init()
    st = InMemoryStatsStorage()
    net.set_listeners(StatsListener(st, session_id="c"))
    last, capturing = {}, net._capturing

    def watch(step):
        before = (tree_map(torch.clone, net.params),
                  tree_map(torch.clone, net.opt_state))
        out, grads, updates = capturing(step)
        last.update(before=before, grads=grads, updates=updates)
        return out, grads, updates
    net._capturing = watch
    rs = np.random.RandomState(0)
    net.fit((rs.randn(32, 5).astype(np.float32),
             np.eye(3, dtype=np.float32)[rs.randint(0, 3, 32)]),
            batch_size=8, accumulate_steps=2)
    ups = st.get_all_updates_after("c", "StatsListener", "worker-0", 0)
    assert len(ups) == 2
    for u in ups:
        assert set(u.data["gradients"]) == set(u.data["params"]) \
            == set(u.data["updates"]) == {"0/W", "0/b", "1/W", "1/b"}
        assert u.data["memory"]["device_bytes_in_use"] > 0
    static = st.get_static_info("c", "StatsListener", "worker-0").data
    assert static["devices"][0] == "cuda:0"
    params, opt = last["before"]
    with torch.no_grad():
        again, _ = net._tx.update(last["grads"], opt, params)
    for a, b in zip(tree_leaves(again), tree_leaves(last["updates"])):
        assert torch.equal(a, b)
    for p0, u, p in zip(tree_leaves(params), tree_leaves(last["updates"]),
                        tree_leaves(net.params)):
        assert torch.equal(p0 + u, p)
    for group in ("gradients", "updates"):
        tree = last["grads" if group == "gradients" else "updates"]
        for k, t in _leaf_paths(tree).items():
            norm, mean_mag, bad, hist, lo, hi = _plain_summary(
                t.cpu().numpy())
            g = ups[-1].data[group][k]
            assert (g["n_non_finite"], g["hist"], g["lo"], g["hi"]) \
                == (bad, hist, lo, hi), (group, k)
            assert abs(g["norm"] - norm) <= 1e-12 * norm, (group, k)
            assert abs(g["mean_mag"] - mean_mag) <= 1e-12 * mean_mag


def test_keras_config_and_estimator_on_the_card(cuda, tmp_path):
    """A Keras JSON config imports onto the card without h5py; a
    DL4JClassifier fits on the card and predicts within 1e-5 of its
    network moved to the CPU."""
    import io
    import json
    from deeplearning4j_tpu_torch.ml import DL4JClassifier
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    cfg = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "InputLayer", "config": {"batch_shape": [None, 6]}},
        {"class_name": "Dense", "config": {"name": "d", "units": 4,
                                           "activation": "relu"}},
        {"class_name": "Dense", "config": {"name": "o", "units": 2,
                                           "activation": "softmax"}}]}}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    net = KerasModelImport.import_keras_model_configuration(str(path))
    assert net.device.type == "cuda"
    net.init()
    assert tuple(net.output(np.zeros((3, 6), np.float32)).shape) == (3, 2)
    rs = np.random.RandomState(1)
    X = rs.randn(64, 6).astype(np.float32)
    y = (X[:, 0] > 0).astype(int)
    clf = DL4JClassifier(hidden=(16,), epochs=2, batch_size=16).fit(X, y)
    assert clf.network_.device.type == "cuda"
    buf = io.BytesIO()
    save_model(clf.network_, buf)
    buf.seek(0)
    cpu = load_model(buf, device="cpu")
    assert np.abs(cpu.output(X).numpy() - clf.predict_proba(X)).max() \
        <= 1e-5


def _blobs(n_per, d, n_blobs, seed):
    rs = np.random.RandomState(seed)
    centers = rs.randn(n_blobs, d) * 8
    return np.concatenate([centers[i] + rs.randn(n_per, d)
                           for i in range(n_blobs)]).astype(np.float32)


def test_kmeans_on_the_card_matches_the_cpu(cuda):
    """Assignment on the card, seeding and the center update on the host:
    the same centers bitwise as the CPU fit (the data has no near-tie
    row), predict equal, inertia within 1e-5 relative (phase 20's bound:
    the f32 expansion's per-row rounding, summed in another order, moved
    it by 2.5e-6 here)."""
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    X = _blobs(300, 32, 6, 3)
    card = KMeansClustering(k=6, seed=2).fit(X)
    assert card.device.type == "cuda"
    cpu = KMeansClustering(k=6, seed=2, device="cpu").fit(X)
    d = np.sort(np.linalg.norm(X[:, None] - cpu.centers[None], axis=-1), 1)
    assert np.all(d[:, 1] - d[:, 0] > 1e-5 * d[:, 1])
    assert np.array_equal(card.centers, cpu.centers)
    assert card.iterations_done == cpu.iterations_done
    assert np.array_equal(card.predict(X), cpu.predict(X))
    assert card.inertia(X) == pytest.approx(cpu.inertia(X), rel=1e-5)


def test_tsne_pieces_on_the_card_match_the_cpu(cuda):
    """The affinity tile (neighbour sets equal, p within 1e-5) and the
    tiled gradient with pad rows (within 1e-5 of its largest |value|, KL
    within 1e-5 relative; the card's index_add_ adds atomically)."""
    from deeplearning4j_tpu_torch.manifold import bhtsne
    from deeplearning4j_tpu_torch.util.platform import set_f32_matmul_exact
    set_f32_matmul_exact()
    rs = np.random.RandomState(4)
    X = rs.randn(2000, 50).astype(np.float32)
    rows = np.arange(512, 1024)
    out = {}
    for dev in ("cpu", cuda):
        idx, p = bhtsne._knn_affinity_tile(
            torch.as_tensor(X, device=dev), torch.as_tensor(rows, device=dev),
            30, np.float32(np.log(10.0)))
        out[str(dev)] = (idx.cpu().numpy(), p.cpu().numpy())
    (ci, cp), (gi, gp) = out["cpu"], out["cuda"]
    for i in range(len(rows)):
        assert set(ci[i]) == set(gi[i])
        o = dict(zip(gi[i], gp[i]))
        np.testing.assert_allclose([o[j] for j in ci[i]], cp[i], rtol=1e-5,
                                   atol=1e-7)
    n, n_valid, tile = 4096, 4000, 512
    Y = (rs.randn(n, 2) * 10).astype(np.float32)
    Y[n_valid:] = 1e6
    src = np.repeat(np.arange(n_valid), 12)
    dst = rs.randint(0, n_valid, len(src))
    pv = (rs.rand(len(src)) / len(src)).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda):
        t = [torch.as_tensor(a, device=dev) for a in (Y, src, dst, pv)]
        g, kl = bhtsne._tiled_forces(t[0], t[1], t[2], n // tile, t[3],
                                     n_valid)
        res[str(dev)] = (g.cpu().numpy(), float(kl))
    (cg, ck), (gg, gk) = res["cpu"], res["cuda"]
    assert np.abs(gg - cg).max() <= 1e-5 * np.abs(cg).max()
    assert np.all(gg[n_valid:] == 0.0)
    assert gk == pytest.approx(ck, rel=1e-5)


def test_clustering_and_tsne_default_to_the_card(cuda):
    """With no device asked for, the three device classes run on the card
    and hand back numpy."""
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.manifold import BarnesHutTsne, Tsne
    X = _blobs(40, 8, 3, 0)
    km = KMeansClustering(k=3, seed=1).fit(X)
    assert km.device.type == "cuda" and isinstance(km.predict(X),
                                                   np.ndarray)
    for est in (Tsne(perplexity=10, max_iter=60),
                BarnesHutTsne(perplexity=10, theta=0.0, max_iter=60,
                              tile_rows=32)):
        assert est.device.type == "cuda"
        Y = est.fit_transform(X)
        assert isinstance(Y, np.ndarray) and Y.shape == (120, 2)
        assert np.all(np.isfinite(Y)) and np.isfinite(est.kl_divergence_)


# ------------------------------------------------------------ user scripts
# the examples that run where scikit-learn, keras and h5py are missing,
# at tests/test_examples.py's reduced settings, with that file's checks
_CARD_EXAMPLES = (
    ("01_quickstart_mlp", dict(epochs=15), lambda r: r > 0.9),
    ("02_computation_graph", dict(epochs=15), lambda r: r > 0.85),
    ("03_cnn_digits", dict(epochs=2), lambda r: r > 0.7),
    ("04_char_lstm", dict(epochs=30, units=32), lambda r: len(r) == 41),
    ("05_autoencoder_anomaly", dict(epochs=40), lambda r: r > 0.8),
    ("06_early_stopping", dict(max_epochs=40),
     lambda r: r.best_model is not None),
    ("07_word2vec", dict(epochs=4),
     lambda r: "queen" in r.words_nearest("king", top_n=3)),
    ("08_parallel_training", dict(epochs=8), lambda r: r > 0.9),
    ("11_transfer_learning", dict(), lambda r: r > 0.8),
    ("12_tsne_visualization", dict(n=300, max_iter=250),
     lambda r: r > 0.75),
    ("13_custom_layer", dict(epochs=30), lambda r: r > 0.9),
    ("14_long_context_ring", dict(epochs=4), lambda r: np.isfinite(r)),
    ("15_dl4j_artifact_migration", dict(), lambda r: r > 0.9),
    ("16_zero_fsdp_training", dict(epochs=8), lambda r: r > 0.9),
    ("17_device_norm_image_pipeline", dict(epochs=10), lambda r: r > 0.9),
    ("18_gspmd_sharding_plan", dict(epochs=8), lambda r: r > 0.9),
)


@pytest.mark.parametrize("name,kwargs,check", _CARD_EXAMPLES,
                         ids=[c[0] for c in _CARD_EXAMPLES])
def test_example_on_the_card_by_default(cuda, name, kwargs, check,
                                        tmp_path):
    """Each example asked for no device runs on the card and reaches the
    JAX example's result."""
    import importlib
    mod = importlib.import_module(f"deeplearning4j_tpu_torch.examples.{name}")
    if "tmpdir" in mod.main.__code__.co_varnames:
        kwargs = dict(kwargs, tmpdir=str(tmp_path))
    result = mod.main(**kwargs)
    assert check(result), result


def test_missing_libraries_make_examples_09_and_10_say_so(cuda, tmp_path):
    """Where keras, h5py or scikit-learn is missing (the card machine),
    examples 09 and 10 raise naming what they need."""
    import importlib
    import importlib.util
    need = {"09_keras_import": ("keras", "h5py"),
            "10_hyperparameter_search": ("sklearn",)}
    for name, libs in need.items():
        if all(importlib.util.find_spec(m) for m in libs):
            continue
        mod = importlib.import_module(
            f"deeplearning4j_tpu_torch.examples.{name}")
        kw = {"tmpdir": str(tmp_path)} if name.startswith("09") else {}
        with pytest.raises(RuntimeError, match="|".join(
                "scikit-learn" if m == "sklearn" else m for m in libs)):
            mod.main(**kw)


# the decode smoke's gates that compare two timings (fault C.8 is the
# first; the others compare prefill costs that the captured programs cut
# to a few replays at the smoke's widths)
_TIMING_GATES = ("speculation did not improve", "chunked prefill did not "
                 "improve", "hot TTFT p99", "affinity routing did not beat")


def test_decode_smoke_on_the_card_holds_its_correctness_gates(cuda,
                                                               tmp_path):
    """The decode smoke on the card, its programs replayed as CUDA graphs:
    no failure but of a timing A/B — zero 5xx through the swap, the
    first-run ledger balanced, greedy speculative streams equal to the
    plain twin's with acceptance above 0.5, spill-tier parity, prefix
    hits; the A/Bs' numbers are printed."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "decode.json"
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.tools.decode_smoke",
         "--out", str(out)], cwd=repo, capture_output=True, text=True,
        timeout=900, env=dict(os.environ, PYTHONPATH=repo))
    assert out.exists(), (proc.stdout[-3000:], proc.stderr[-3000:])
    rep = json.loads(out.read_text())
    assert [f for f in rep["failures"]
            if not f.startswith(_TIMING_GATES)] == [], rep["failures"]
    assert proc.returncode == (1 if rep["failures"] else 0)
    ab = rep["spec_ab"]
    assert ab["mismatched_streams"] == 0 and ab["acceptance_rate"] > 0.5
    assert rep["ledger"]["compiles"] == rep["ledger"]["warmups"] > 0
    assert rep["spill"]["parity"] is True
    print(json.dumps({k: rep[k] for k in ("failures", "spec_ab",
                                          "interferer_itl", "prefix_ttft")}))


@pytest.mark.parametrize("name,args", [
    ("chaos_fit", ("--seed", "1")),
    ("goodput_report", ()),
    ("telemetry_smoke", ()),
    ("etl_smoke", ()),
    ("mfu_probe", ()),
])
def test_tool_on_the_card_by_default(cuda, name, args):
    """The tools with no --device run on the card and exit 0."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", f"deeplearning4j_tpu_torch.tools.{name}",
         *args], cwd=repo, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    if name == "mfu_probe":
        rows = [json.loads(x) for x in proc.stdout.splitlines()
                if x.startswith("{")]
        assert all(r["on_gpu"] for r in rows[:-1])
        print(json.dumps(rows[:-1]))
