"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run (needs one CUDA card)
    python3 chip_smoke.py --quick    # build + kernel checks only (fwd, bwd)

Phases, each printing one JSON line; any failure exits non-zero with no
result line:

1. device  — requires CUDA; prints the card's name and power limit as
             nvidia-smi gives them.
2. build   — builds every kernel of the port from ops/csrc with nvcc (one
             process per source, all started together) and prints the
             build seconds and ptxas's register/spill report.
3. kernels — holds each kernel against its plain PyTorch version on the
             card, on the same inputs: O and LSE, bf16 atol/rtol 2e-2,
             f32 atol 1e-4. Then times the kernel, the plain version and
             torch's scaled_dot_product_attention (a yardstick only; the
             port never calls it) at the repo's attention bench shape and
             at the main path's shape, beside the least time the card
             could take for the same work.
   Then the same for the two backward kernels (dQ, dK/dV) against the
             plain backward, on the forward kernel's outputs and random
             cotangents (a g_lse != 0 case included): f32 atol 1e-4, bf16
             atol/rtol 3e-2. Each backward kernel is timed alone, beside
             the plain backward (all three gradients) and SDPA's backward
             ((forward + backward) - forward).
4. serve   — the port's predict path, through the entry points a user
             calls: serving.cli.build() stands up the HTTP server over a
             full-width TransformerLM (random weights from its seed) with
             flash attention; at least 8 POST /v1/models/lm/predict
             requests go over a real socket as .npy. Every answer is
             checked (200, shape, finite, rows sum to 1), the kernel
             launch count must equal n_layers x the batcher's dispatches
             (no backward launch), and one answer must match the same
             network run with the plain attention version on the card.
5. train   — the port's training path: the same full-width LM saved as a
             zip, and train.cli.main (`--mode single`, batch 4, 2 epochs
             of a seeded 32-sequence token set = 16 steps) in-process.
             The run must exit 0 with the reference's result line, finite
             and falling scores, exactly n_layers x 16 launches of each
             kernel, and an output zip that reloads with its 16 iterations
             and updaterState.bin; one batch's gradients through the
             kernels must match those with the plain attention swapped in
             (per-leaf error <= 1e-4 of the leaf's largest gradient).
             Then 6 more steps are timed by CUDA events, and 2 more are
             profiled (torch.profiler: device time by kernel category and
             the device's idle share of the host's wall time).

Each path's counts are set to 0 just before it is driven and read just
after. The second-to-last line is the kernel table
(``{"kernels": [...]}``); the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import io
import json
import logging
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,        # CUDA cores, no tensor cores
              torch.bfloat16: 989e12}      # tensor cores

LM_SOURCE = ("zoo:TransformerLM?vocab_size=1024&seq_length=2048&n_layers=4"
             "&n_embd=512&n_heads=8&mlp_ratio=4&attention_impl=flash")
N_LAYERS, SEQ, VOCAB, HEADS, HEAD_DIM = 4, 2048, 1024, 8, 64
FLASH_SOURCE = "deeplearning4j_tpu_torch/ops/csrc/flash_attention_fwd.cu"
FLASH_REPLACES = "deeplearning4j_tpu/ops/flash_attention.py:58"
BWD_SOURCE = "deeplearning4j_tpu_torch/ops/csrc/flash_attention_bwd.cu"
BWD_REPLACES = {"flash_bwd_dq": "deeplearning4j_tpu/ops/flash_attention.py:183",
                "flash_bwd_dkv": "deeplearning4j_tpu/ops/flash_attention.py:216"}
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the train phase: 32 sequences, batch 4, 2 epochs = 16 steps
TRAIN_SEQS, TRAIN_BATCH, TRAIN_EPOCHS = 32, 4, 2
TRAIN_STEPS = TRAIN_SEQS // TRAIN_BATCH * TRAIN_EPOCHS
GRAD_REL_TOL = 1e-4     # kernels vs plain attention, per parameter leaf


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def ptxas_report(log: str):
    """Registers and spills of each kernel from nvcc's -Xptxas -v output:
    [{"kernel", "registers", "spill_stores", "spill_loads"}, ...]."""
    import re
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            k = re.search(r"(flash_(?:fwd|bwd)_[a-z0-9_]+?)I(.*?)Li(\d+)E", name)
            if k is not None:     # flash_bwd_dq<f32,D=64> from the mangling
                fn, targ, dim = k.groups()
                dtype = "bf16," if "bfloat16" in targ else \
                    "f32," if targ == "f" else ""
                name = f"{fn}<{dtype}D={dim}>"
            cur = {"kernel": name}
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return rows


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(q, k, causal):
    """Least time for the function on these (unmasked) inputs: the larger
    of its bytes (q, k, v read once; O and LSE written once) over the
    memory rate and its flops (4*D per (query, key) pair that causality
    keeps: Q.K and P.V) over the peak for the input type."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    pairs_per_head = sum(min(i + 1, tk) for i in range(tq)) if causal \
        else tq * tk
    flops = 4.0 * d * pairs_per_head * b * h
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + b * h * tq * 4
    t_ops = flops / PEAK_FLOPS[q.dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def make_qkv(b, tq, tk, h, d, dtype, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda t: torch.randn(b, t, h, d, generator=g).to("cuda", dtype)
    return mk(tq), mk(tk), mk(tk)


def check_kernel_cases(fa):
    """Phase 3a: the kernel against the plain version on the card."""
    mask_full = torch.ones(2, 384, device="cuda")
    mask_full[0, 300:] = 0.0
    mask_full[1] = 0.0                              # all rows fully masked
    mask_lead = torch.ones(2, 384, device="cuda")
    mask_lead[0, :10] = 0.0                         # causal rows 0-9 dead
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("bench_bf16_causal", make_qkv(4, 2048, 2048, 8, 64, bf16, 1), None,
         True),
        ("main_path_f32_causal", make_qkv(4, 2048, 2048, 8, 64, f32, 2),
         None, True),
    ]
    # every edge case for both kernels (f32 CUDA cores, bf16 tensor cores)
    for dt, tag in ((f32, "f32"), (bf16, "bf16")):
        qkv = torch.randn(2, 256, 3, 4, 64, device="cuda").to(dt)
        cases += [
            (f"{tag}_mask_fully_masked_rows",
             make_qkv(2, 384, 384, 8, 64, dt, 3), mask_full, False),
            (f"{tag}_mask_causal_dead_leading_rows",
             make_qkv(2, 384, 384, 8, 64, dt, 4), mask_lead, True),
            (f"{tag}_ragged_t1000_causal",
             make_qkv(2, 1000, 1000, 4, 64, dt, 5), None, True),
            (f"{tag}_tq300_tk700", make_qkv(2, 300, 700, 4, 64, dt, 6), None,
             False),
            (f"{tag}_tq700_tk300_causal",
             make_qkv(2, 700, 300, 4, 64, dt, 7), None, True),
            (f"{tag}_d32_causal", make_qkv(2, 512, 512, 4, 32, dt, 8), None,
             True),
            (f"{tag}_d128_causal", make_qkv(2, 512, 512, 4, 128, dt, 9), None,
             True),
            (f"{tag}_d128_masked", make_qkv(2, 384, 384, 8, 128, dt, 10),
             mask_full, False),
            (f"{tag}_strided_qkv_views", tuple(qkv[:, :, i] for i in range(3)),
             None, True),
        ]
    errs = {}
    for name, (q, k, v), mask, causal in cases:
        out, lse = fa.flash_attention_cuda(q, k, v, mask, causal)
        torch.cuda.synchronize()
        ref, rlse = fa.flash_attention_plain(q, k, v, mask, causal)
        tol = dict(atol=1e-4, rtol=0.0) if q.dtype == torch.float32 \
            else dict(atol=2e-2, rtol=2e-2)
        err_o = (out.float() - ref.float()).abs().max().item()
        err_l = (lse - rlse).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), **tol) and \
            torch.allclose(lse, rlse, **tol) and \
            bool(torch.isfinite(out.float()).all())
        emit({"phase": "kernel_check", "case": name,
              "shape": [list(q.shape), list(k.shape)],
              "dtype": str(q.dtype).replace("torch.", ""), "causal": causal,
              "masked": mask is not None, "max_abs_err_o": err_o,
              "max_abs_err_lse": err_l, "ok": ok})
        if not ok:
            raise AssertionError(f"flash kernel disagrees with plain: {name}")
        errs[name] = err_o
    # the public wrapper: padding to the block, the LSE boundary mapping
    q, k, v = make_qkv(2, 1000, 1000, 4, 64, torch.float32, 11)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    ref, rlse = fa.flash_attention_plain(q, k, v, None, True)
    rlse = rlse.reshape(2, 4, 1000).transpose(1, 2)
    ok = torch.allclose(out, ref, atol=1e-4, rtol=0) and \
        torch.allclose(lse, rlse, atol=1e-4, rtol=0)
    emit({"phase": "kernel_check", "case": "public_wrapper_padded_lse",
          "ok": ok})
    if not ok:
        raise AssertionError("flash_attention wrapper disagrees with plain")
    return errs


def bwd_inputs(fa, q, k, v, mask, causal, seed, with_g_lse=False):
    """The backward's inputs from the forward kernel: (out, lse, g_out,
    g_lse). g_out is a non-contiguous view with a unit D stride, as
    autograd may hand over; g_lse is zero unless asked for."""
    out, lse = fa.flash_attention_cuda(q, k, v, mask, causal)
    b, tq, h, d = q.shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    g_out = torch.randn(b, h, tq, d, generator=g).to("cuda", q.dtype) \
        .transpose(1, 2)
    g_lse = torch.randn(b * h, tq, generator=g).to("cuda") if with_g_lse \
        else torch.zeros(b * h, tq, device="cuda")
    return out, lse, g_out, g_lse


def check_bwd_cases(fa):
    """Phase 3c: the backward kernels against the plain backward on the
    card: dQ, dK and dV from the same forward outputs and cotangents."""
    mask_full = torch.ones(2, 384, device="cuda")
    mask_full[0, 300:] = 0.0
    mask_full[1] = 0.0                              # all rows fully masked
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("main_path_f32_causal", make_qkv(4, 2048, 2048, 8, 64, f32, 2),
         None, True, False),
        ("bench_bf16_causal", make_qkv(4, 2048, 2048, 8, 64, bf16, 1), None,
         True, False),
    ]
    for dt, tag in ((f32, "f32"), (bf16, "bf16")):
        qkv = torch.randn(2, 256, 3, 4, 64, device="cuda").to(dt)
        cases += [
            (f"{tag}_mask_fully_masked_rows",
             make_qkv(2, 384, 384, 8, 64, dt, 3), mask_full, False, False),
            (f"{tag}_mask_causal_g_lse",
             make_qkv(2, 384, 384, 8, 64, dt, 4), mask_full, True, True),
            (f"{tag}_ragged_t1000_causal",
             make_qkv(2, 1000, 1000, 4, 64, dt, 5), None, True, False),
        ]
        for tq, tk in ((300, 700), (700, 300)):
            for causal in (False, True):
                cases.append((f"{tag}_tq{tq}_tk{tk}_{'causal' if causal else 'full'}",
                              make_qkv(2, tq, tk, 4, 64, dt, 6), None, causal,
                              False))
        cases += [
            (f"{tag}_d32_causal", make_qkv(2, 512, 512, 4, 32, dt, 8), None,
             True, False),
            (f"{tag}_d128_causal", make_qkv(2, 512, 512, 4, 128, dt, 9), None,
             True, False),
            (f"{tag}_d128_masked", make_qkv(2, 384, 384, 8, 128, dt, 10),
             mask_full, False, True),
            (f"{tag}_strided_qkv_views", tuple(qkv[:, :, i] for i in range(3)),
             None, True, False),
        ]
    errs = {}
    for name, (q, k, v), mask, causal, with_g_lse in cases:
        out, lse, g_out, g_lse = bwd_inputs(fa, q, k, v, mask, causal, 13,
                                            with_g_lse)
        got = fa.flash_attention_bwd_cuda(q, k, v, mask, out, lse, g_out,
                                          g_lse, causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_plain(q, k, v, mask, out, lse, g_out,
                                           g_lse, causal)
        tol = dict(atol=1e-4, rtol=0.0) if q.dtype == torch.float32 \
            else dict(atol=3e-2, rtol=3e-2)
        err = {n: (a.float() - r.float()).abs().max().item()
               for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
        ok = all(torch.allclose(a.float(), r.float(), **tol)
                 and bool(torch.isfinite(a.float()).all())
                 for a, r in zip(got, ref))
        emit({"phase": "bwd_kernel_check", "case": name,
              "shape": [list(q.shape), list(k.shape)],
              "dtype": str(q.dtype).replace("torch.", ""), "causal": causal,
              "masked": mask is not None, "g_lse": with_g_lse,
              "max_abs_err": err, "ok": ok})
        if not ok:
            raise AssertionError(f"flash backward kernels disagree with "
                                 f"plain: {name}")
        errs[name] = err
    return errs


def time_attention(fa, b, t, h, d, dtype, gpu):
    """Phase 3b: kernel, plain and library times at one causal shape."""
    import torch.nn.functional as F
    q, k, v = make_qkv(b, t, t, h, d, dtype, 12)
    kernel_ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, None, True))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, None, True),
                       iters=5, warmup=1)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    bound_ms, bound_by = attention_bound_ms(q, k, True)
    row = {"phase": "kernel_time", "kernel": "flash_fwd",
           "shape": [b, t, h, d], "dtype": str(dtype).replace("torch.", ""),
           "causal": True, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "roofline_share": bound_ms / kernel_ms,
           "gpu": gpu}
    emit(row)
    return row


def live_pairs(tq, tk, causal):
    """(query, key) pairs per head that causality keeps."""
    return sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk


def bwd_bound_ms(q, k, flops_per_pair_per_d, n_outputs_q, n_outputs_k,
                 causal):
    """Least time for one backward kernel's work on these (unmasked)
    inputs: q, k, v and dO read once, LSE and delta read once, its
    outputs written once; flops per live pair over the peak for the
    type."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    flops = flops_per_pair_per_d * d * live_pairs(tq, tk, causal) * b * h
    es = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * es + 2 * b * h * tq * 4 \
        + (n_outputs_q * q.numel() + n_outputs_k * k.numel()) * es
    t_ops = flops / PEAK_FLOPS[q.dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_backward(fa, b, t, h, d, dtype, gpu):
    """Phase 3d: each backward kernel, the plain backward (all three
    gradients at once) and SDPA's backward at one causal shape."""
    import torch.nn.functional as F
    q, k, v = make_qkv(b, t, t, h, d, dtype, 12)
    out, lse, g_out, g_lse = bwd_inputs(fa, q, k, v, None, True, 14)
    g_out = g_out.contiguous()
    delta = fa._delta(out, g_out, g_lse, torch.float32)
    dq_ms = cuda_ms(lambda: fa.flash_attention_bwd_dq_cuda(
        q, k, v, None, lse, delta, g_out, True))
    dkv_ms = cuda_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
        q, k, v, None, lse, delta, g_out, True))
    whole_ms = cuda_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, None, out, lse, g_out, g_lse, True))
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, None, out, lse, g_out, g_lse, True), iters=5, warmup=1)
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_(True)
                  for a in (q, k, v))
    gt = g_out.transpose(1, 2)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.autograd.grad(o, (qt, kt, vt), gt)

    library_ms = cuda_ms(sdpa_fwd_bwd) - cuda_ms(sdpa_fwd)
    rows = {}
    for name, ms, fpp, nq, nk in (("flash_bwd_dq", dq_ms, 6, 1, 0),
                                  ("flash_bwd_dkv", dkv_ms, 8, 0, 2)):
        bound_ms, bound_by = bwd_bound_ms(q, k, fpp, nq, nk, True)
        rows[name] = {"phase": "kernel_time", "kernel": name,
                      "shape": [b, t, h, d],
                      "dtype": str(dtype).replace("torch.", ""),
                      "causal": True, "kernel_ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "roofline_share": bound_ms / ms,
                      "backward_total_ms": whole_ms, "gpu": gpu}
        emit(rows[name])
    return rows


def post_npy(url, x):
    buf = io.BytesIO()
    np.save(buf, x, allow_pickle=False)
    req = urllib.request.Request(
        url, data=buf.getvalue(), method="POST",
        headers={"Content-Type": "application/octet-stream",
                 "Accept": "application/octet-stream"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        status, body = r.status, r.read()
    ms = (time.perf_counter() - t0) * 1e3
    return status, np.load(io.BytesIO(body), allow_pickle=False), ms


def check_answer(status, y, batch):
    if status != 200:
        raise AssertionError(f"predict answered {status}")
    if y.shape != (batch, SEQ, VOCAB):
        raise AssertionError(f"predict shape {y.shape}")
    if not np.isfinite(y).all():
        raise AssertionError("predict returned non-finite values")
    if not np.allclose(y.sum(-1), 1.0, atol=1e-4):
        raise AssertionError("softmax rows do not sum to 1")


def serve(fa):
    """Phase 4: the main path, counted from zero."""
    from deeplearning4j_tpu_torch.serving import cli
    args = cli.build_parser().parse_args(
        ["--model", f"lm={LM_SOURCE}", "--port", "0", "--buckets", "1,4",
         "--max-delay-ms", "5"])
    for name in KERNELS:
        fa.KERNEL_LAUNCHES[name] = 0
    t0 = time.perf_counter()
    registry, server = cli.build(args)
    build_s = time.perf_counter() - t0
    served = registry.get("lm")
    url = f"{server.url}/v1/models/lm/predict"
    rs = np.random.RandomState(1234)
    try:
        warm_launches = fa.KERNEL_LAUNCHES["flash_fwd"]
        warm_dispatches = served.batcher.dispatches
        lat, answers = {1: [], 4: []}, {}
        for i in range(12):                        # sequential, mixed batch
            batch = 4 if i % 2 else 1
            x = rs.randint(0, VOCAB, (batch, SEQ, 1)).astype("float32")
            status, y, ms = post_npy(url, x)
            check_answer(status, y, batch)
            lat[batch].append(ms)
            answers.setdefault(batch, (x, y))
        burst = [rs.randint(0, VOCAB, (1, SEQ, 1)).astype("float32")
                 for _ in range(4)]
        results = [None] * 4

        def one(j):
            results[j] = post_npy(url, burst[j])

        threads = [threading.Thread(target=one, args=(j,)) for j in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        for r in results:
            if r is None:
                raise AssertionError("a concurrent predict never returned")
            check_answer(r[0], r[1], 1)
        launches = fa.KERNEL_LAUNCHES["flash_fwd"]
        dispatches = served.batcher.dispatches
        if fa.KERNEL_LAUNCHES["flash_bwd_dq"] or \
                fa.KERNEL_LAUNCHES["flash_bwd_dkv"]:
            raise AssertionError("the predict path launched a backward "
                                 "kernel")
        if launches != N_LAYERS * dispatches:
            raise AssertionError(f"{launches} kernel launches for {dispatches}"
                                 f" dispatches of a {N_LAYERS}-layer network")
        if launches - warm_launches != N_LAYERS * (dispatches - warm_dispatches) \
                or dispatches == warm_dispatches:
            raise AssertionError("requests did not go through the kernel")
        # one answer against the same network with plain attention
        x4, y4 = answers[4]
        real = fa.flash_attention_cuda
        fa.flash_attention_cuda = \
            lambda q, k, v, mask, causal: fa.flash_attention_plain(
                q, k, v, mask, causal)
        try:
            ref = served.model.output(x4).float().cpu().numpy()
        finally:
            fa.flash_attention_cuda = real
        if fa.KERNEL_LAUNCHES["flash_fwd"] != launches:
            raise AssertionError("the plain reference launched the kernel")
        err = float(np.abs(y4 - ref).max())
        if not err <= 1e-4:
            raise AssertionError(f"served answer vs plain attention: {err}")
        # one forward per bucket on the device timeline (CUDA events around
        # output(): no HTTP, no copy back, but the host's launch gaps are
        # inside); the rest of a request's wall time is host work
        forward_ms = {str(b): cuda_ms(lambda b=b: served.model.output(
            answers[b][0]), iters=5, warmup=1) for b in (1, 4)}
        all_ms = lat[1] + lat[4]
        emit({"phase": "serve", "source": LM_SOURCE,
              "params": served.model.num_params(),
              "build_and_warm_s": build_s, "warmup_s": served.warmup_seconds,
              "requests": len(all_ms) + len(burst),
              "p50_ms": {str(b): statistics.median(v) for b, v in lat.items()},
              "max_ms": {str(b): max(v) for b, v in lat.items()},
              "p50_ms_all": statistics.median(all_ms), "max_ms_all": max(all_ms),
              "forward_span_ms": forward_ms,
              "dispatches": dispatches, "warmup_dispatches": warm_dispatches,
              "kernel_launches": launches,
              "launches_per_forward": launches / dispatches,
              "max_abs_err_vs_plain": err})
        return launches
    finally:
        server.drain(timeout=30)


def write_tokens(path, rs):
    """A learnable token set: each row is an arithmetic sequence mod VOCAB
    (seeded start and stride); labels are the next token, one-hot uint8."""
    start = rs.randint(0, VOCAB, (TRAIN_SEQS, 1))
    stride = rs.randint(1, 8, (TRAIN_SEQS, 1))
    seq = (start + stride * np.arange(SEQ + 1)) % VOCAB
    features = seq[:, :SEQ, None].astype("float32")
    labels = np.zeros((TRAIN_SEQS, SEQ, VOCAB), np.uint8)
    np.put_along_axis(labels, seq[:, 1:, None], 1, axis=-1)
    np.savez(path, features=features, labels=labels)
    return features, labels


class _ScoreLog(logging.Handler):
    """Collects the scores ScoreIterationListener logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.scores = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("Score at iteration"):
            self.scores.append(float(msg.rsplit(" ", 1)[1]))


def grads_vs_plain(fa, net, ds):
    """One batch's gradients through the kernels against the same with
    the plain attention versions swapped in: the largest per-leaf error
    relative to that leaf's largest plain gradient."""
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    _, g_kernel, _ = net.compute_gradient_and_score(ds)
    real = (fa.flash_attention_cuda, fa.flash_attention_bwd_cuda)
    fa.flash_attention_cuda = \
        lambda q, k, v, mask, causal: fa.flash_attention_plain(
            q, k, v, mask, causal)
    fa.flash_attention_bwd_cuda = fa.flash_attention_bwd_plain
    try:
        counts = dict(fa.KERNEL_LAUNCHES)
        _, g_plain, _ = net.compute_gradient_and_score(ds)
        if dict(fa.KERNEL_LAUNCHES) != counts:
            raise AssertionError("the plain reference launched a kernel")
    finally:
        fa.flash_attention_cuda, fa.flash_attention_bwd_cuda = real
    worst = 0.0
    for a, r in zip(tree_leaves(g_kernel), tree_leaves(g_plain)):
        scale = r.abs().max().item()
        worst = max(worst, (a - r).abs().max().item() / max(scale, 1e-30))
    return worst


def _category(name: str) -> str:
    for k in KERNELS:
        if k in name:
            return k
    if "gemm" in name.lower() or "sm90_xmma" in name or "cutlass" in name:
        return "matmul"
    return "other"


def profile_steps(net, batch, gen, steps=2):
    """Device time of `steps` train steps by kernel category, from
    torch.profiler's CUDA kernel events, and the device's idle share of
    the host's wall time over the same window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            float(net._train_step(batch, gen))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"phase": "train_profile", "device_time": "not measured",
                "wall_ms": wall_ms}
    by_cat, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_cat[_category(e.name)] = by_cat.get(_category(e.name), 0) + us
        by_name[e.name] = by_name.get(e.name, 0) + us
    busy_ms = sum(by_cat.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"phase": "train_profile", "steps": steps, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernel_launches": len(kernels),
            "by_category_ms": {k: v / 1e3 for k, v in sorted(by_cat.items())},
            "top_kernels_ms": [[n[:80], v / 1e3] for n, v in top]}


def train(fa, tmp):
    """Phase 5: the training path, counted from zero: the full-width LM
    saved as a zip, trained by train.cli.main for TRAIN_STEPS steps on a
    seeded token set, its output zip reloaded and checked."""
    import contextlib
    import os
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.serving.registry import parse_zoo_source
    from deeplearning4j_tpu_torch.train import cli as train_cli
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    name, kw = parse_zoo_source(LM_SOURCE[len("zoo:"):])
    lm_zip, out_zip = os.path.join(tmp, "lm.zip"), os.path.join(tmp, "out.zip")
    tokens = os.path.join(tmp, "tokens.npz")
    save_model(model_by_name(name, **kw).init(), lm_zip)
    features, labels = write_tokens(tokens, np.random.RandomState(2024))
    log = logging.getLogger("deeplearning4j_tpu_torch")
    handler, level = _ScoreLog(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    stdout = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout):
            code = train_cli.main([
                "--model", lm_zip, "--output", out_zip, "--dataset", tokens,
                "--mode", "single", "--batch-size", str(TRAIN_BATCH),
                "--epochs", str(TRAIN_EPOCHS), "--score-every", "1"])
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    wall_s = time.perf_counter() - t0
    launches = dict(fa.KERNEL_LAUNCHES)
    lines = stdout.getvalue().strip().splitlines()
    result = json.loads(lines[-1])
    if code != 0 or set(result) != {"output", "final_score", "iterations",
                                     "epochs"}:
        raise AssertionError(f"train CLI: exit {code}, last line {lines[-1]}")
    if result["iterations"] != TRAIN_STEPS or \
            result["epochs"] != TRAIN_EPOCHS:
        raise AssertionError(f"train CLI ran {result}")
    scores = handler.scores
    if len(scores) != TRAIN_STEPS or not all(np.isfinite(scores)) or \
            not scores[-1] < scores[0]:
        raise AssertionError(f"training scores {scores}")
    if result["final_score"] != scores[-1]:
        raise AssertionError("score() is not the last training score")
    want = N_LAYERS * TRAIN_STEPS
    if any(launches[k] != want for k in KERNELS):
        raise AssertionError(f"launches {launches} != {want} per kernel")
    net = load_model(out_zip)
    if net.iteration_count != TRAIN_STEPS or net.opt_state is None or \
            int(net.opt_state["1"]["0"]["count"]) != TRAIN_STEPS:
        raise AssertionError("the output zip lost its counters or "
                             "updaterState.bin")
    ds = DataSet(features[:TRAIN_BATCH], labels[:TRAIN_BATCH])
    grad_err = grads_vs_plain(fa, net, ds)
    if not grad_err <= GRAD_REL_TOL:
        raise AssertionError(f"gradients with kernels vs plain: {grad_err}")
    # step times on the device timeline: the same step on the same
    # batch shape, CUDA events around each step's launches
    gen = torch.Generator(device="cuda").manual_seed(0)
    net._train_step(ds, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(6):
        batch = DataSet(features[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                        labels[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = net._train_step(batch, gen)
        end.record()
        float(loss)
        step_ms.append(start.elapsed_time(end))
    emit(profile_steps(net, batch, gen))
    row = {"phase": "train", "source": LM_SOURCE,
           "params": net.num_params(), "steps": TRAIN_STEPS,
           "batch": TRAIN_BATCH, "seq": SEQ, "cli_wall_s": wall_s,
           "first_score": scores[0], "last_score": scores[-1],
           "scores": scores, "launches": launches,
           "launches_per_step": {k: launches[k] / TRAIN_STEPS
                                 for k in KERNELS},
           "grad_rel_err_vs_plain": grad_err,
           "step_ms_p50": statistics.median(step_ms),
           "step_ms_max": max(step_ms), "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * SEQ / (statistics.median(step_ms)
                                                / 1e3),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(row)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only (no timing, no "
                         "serving)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.util.platform import set_f32_matmul_exact
    set_f32_matmul_exact()

    gpu = gpu_line()
    print(gpu, flush=True)
    emit({"phase": "device", "gpu": gpu,
          "kind": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [{"name": b.name, "nvcc_s": b.seconds,
                         "ptxas": ptxas_report(b.log)} for b in built]})

    errs = check_kernel_cases(fa)
    bwd_errs = check_bwd_cases(fa)
    if args.quick:
        return 0
    bench = time_attention(fa, 4, 2048, 8, 64, torch.bfloat16, gpu)
    main_row = time_attention(fa, 4, SEQ, HEADS, HEAD_DIM, torch.float32, gpu)
    bwd_bench = time_backward(fa, 4, 2048, 8, 64, torch.bfloat16, gpu)
    bwd_main = time_backward(fa, 4, SEQ, HEADS, HEAD_DIM, torch.float32, gpu)
    serve_launches = serve(fa)
    with tempfile.TemporaryDirectory() as tmp:
        trained = train(fa, tmp)
    timed = ("kernel_ms", "plain_ms", "library_ms", "bound_ms")
    table = [{
        "name": "flash_fwd", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": trained["launches"]["flash_fwd"],
        "launches_by_path": {"serve": serve_launches,
                             "train": trained["launches"]["flash_fwd"]},
        "max_abs_err": errs["main_path_f32_causal"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"], "dtype": main_row["dtype"],
        "bench_shape_bf16": {k: bench[k] for k in timed}}]
    for name, grad in (("flash_bwd_dq", "dq"), ("flash_bwd_dkv", "dk")):
        row = bwd_main[name]
        table.append({
            "name": name, "route": "cuda", "source": BWD_SOURCE,
            "replaces": BWD_REPLACES[name],
            "launches": trained["launches"][name],
            "max_abs_err": max(bwd_errs["main_path_f32_causal"][g]
                               for g in ((grad,) if grad == "dq"
                                         else ("dk", "dv"))),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            "dtype": row["dtype"],
            "bench_shape_bf16": {k: bwd_bench[name][k] for k in timed}})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:  # noqa: BLE001 — any phase failing fails the run
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
