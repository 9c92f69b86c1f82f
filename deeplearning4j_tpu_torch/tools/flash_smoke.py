"""First-contact smoke of the flash-attention kernels: forward and
backward on the card at several shapes and dtypes.

    python -m deeplearning4j_tpu_torch.tools.flash_smoke [--device cpu]
        [--small]

The port's counterpart of the JAX package's `tools/flash_smoke.py`, which
ran the Pallas kernels compiled on a TPU. Here `ops.flash_attention`
launches the hand-written `sm_90a` kernels on CUDA tensors
(`ops/csrc/flash_attention_fwd.cu`: the forward; `flash_attention_bwd.cu`:
dQ and dK/dV), and each case is held to the plain PyTorch version of the
same function on the same inputs (`flash_attention_plain` and its
autograd gradient) within the tolerances of `chip_smoke.py`'s kernel
checks: forward f32 atol 1e-4, bf16 atol/rtol 2e-2; backward f32 atol
1e-4, bf16 atol/rtol 3e-2. The cases are the JAX smoke's: the
transformer shapes, a masked non-causal f32 case, a length that is not
a multiple of the block (the padding path, forward and backward), 8192
tokens, block sizes 64 and 256, and the ``return_lse`` merge of two
half-key shards against full attention. Each row reports the kernel's
and the plain version's time (CUDA events, best of 3) and the launches
the case counted.

On the CPU (``--device cpu``) `ops.flash_attention` runs the plain
versions themselves (the kernels take only CUDA tensors); ``--small``
runs every case at a small shape. Exit 0 iff every case held.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np
import torch

FWD_TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
BWD_TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
           torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
LSE_MERGE_TOL = 2e-2

# (name, b, t, h, d, dtype, causal, masked, block_q, block_k)
FWD_CASES = (
    ("b4 t2048 h8 d64 bf16 causal", 4, 2048, 8, 64, "bf16", True, False,
     None, None),
    ("b4 t2048 h8 d64 bf16 full", 4, 2048, 8, 64, "bf16", False, False,
     None, None),
    ("b2 t1024 h8 d128 bf16 causal", 2, 1024, 8, 128, "bf16", True, False,
     None, None),
    ("b2 t512 h4 d64 f32 masked", 2, 512, 4, 64, "f32", False, True,
     None, None),
    ("b2 t300 h8 d64 bf16 causal pad", 2, 300, 8, 64, "bf16", True, False,
     None, None),
    ("b1 t8192 h8 d64 bf16 causal", 1, 8192, 8, 64, "bf16", True, False,
     None, None),
    ("blockq64 t2048 bf16", 4, 2048, 8, 64, "bf16", True, False, 64, 64),
    ("blockq256 t2048 bf16", 4, 2048, 8, 64, "bf16", True, False, 256, 256),
)
# (name, b, t, h, d, dtype, causal)
BWD_CASES = (
    ("b4 t2048 h8 d64 bf16 causal", 4, 2048, 8, 64, "bf16", True),
    ("b2 t1024 h8 d64 f32 full", 2, 1024, 8, 64, "f32", False),
    ("b1 t4096 h8 d64 bf16 causal", 1, 4096, 8, 64, "bf16", True),
    ("b2 t300 h8 d64 bf16 causal pad", 2, 300, 8, 64, "bf16", True),
)
LSE_CASE = (2, 1024, 8, 64, "bf16")
#: the same cases at a CPU-sized shape (--small): T over 8, at most 2
#: batch rows and heads, and head dim 32
SMALL_T = {2048: 128, 1024: 128, 512: 64, 300: 37, 8192: 256, 4096: 128}

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _small(b, t, h, d):
    return min(b, 2), SMALL_T.get(t, t), min(h, 2), 32


def _inputs(seed, b, t, h, d, dtype, device):
    rs = np.random.RandomState(seed)
    return [torch.as_tensor(rs.randn(b, t, h, d).astype(np.float32)
                            ).to(device=device, dtype=dtype)
            for _ in range(3)]


def _best_ms(fn, device, reps=3):
    """Best of `reps` timings of fn() in ms (CUDA events on the card)."""
    best = None
    for _ in range(reps):
        if device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            ms = t0.elapsed_time(t1)
        else:
            s = time.perf_counter()
            fn()
            ms = (time.perf_counter() - s) * 1e3
        best = ms if best is None else min(best, ms)
    return best


def _launches():
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    return dict(fa.KERNEL_LAUNCHES)


def _delta(before):
    after = _launches()
    return {k: after[k] - before[k] for k in after}


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def forward_case(case, device, small=False):
    """(kernel out, plain out, row) of one forward case."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    name, b, t, h, d, dt, causal, masked, bq, bk = case
    if small:
        b, t, h, d = _small(b, t, h, d)
    dtype = DTYPES[dt]
    q, k, v = _inputs(0, b, t, h, d, dtype, device)
    mask = None
    if masked:
        m = np.ones((b, t), np.float32)
        m[:, t - t // 4:] = 0.0
        mask = torch.as_tensor(m, device=device)
    with torch.no_grad():
        before = _launches()
        out = fa.flash_attention(q, k, v, mask=mask, causal=causal,
                                 block_q=bq, block_k=bk)
        launches = _delta(before)
        ref, _ = fa.flash_attention_plain(q, k, v, mask=mask, causal=causal)
        tol = FWD_TOL[dtype]
        ok = bool(torch.allclose(out.float(), ref.float(), **tol))
        ms = _best_ms(lambda: fa.flash_attention(
            q, k, v, mask=mask, causal=causal, block_q=bq, block_k=bk),
            device)
        plain_ms = _best_ms(lambda: fa.flash_attention_plain(
            q, k, v, mask=mask, causal=causal), device)
    return out, ref, {"kind": "fwd", "case": name, "shape": [b, t, h, d],
                      "dtype": dt, "max_abs_err": _max_err(out, ref),
                      "tol": tol, "ok": ok, "ms": ms, "plain_ms": plain_ms,
                      "launches": launches}


def backward_case(case, device, small=False):
    """(kernel grads, plain grads, row) of one backward case: the
    gradients of sum(out**2) in q, k and v."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    name, b, t, h, d, dt, causal = case
    if small:
        b, t, h, d = _small(b, t, h, d)
    dtype = DTYPES[dt]
    q, k, v = _inputs(1, b, t, h, d, dtype, device)

    def kernel_grads():
        qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = fa.flash_attention(*qkv, causal=causal)
        return torch.autograd.grad((out.float() ** 2).sum(), qkv)

    def plain_grads():
        qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out, _ = fa.flash_attention_plain(*qkv, causal=causal)
        return torch.autograd.grad((out.float() ** 2).sum(), qkv)

    before = _launches()
    got = kernel_grads()
    launches = _delta(before)
    want = plain_grads()
    tol = BWD_TOL[dtype]
    errs = [_max_err(a, r) for a, r in zip(got, want)]
    ok = all(bool(torch.allclose(a.float(), r.float(), **tol))
             for a, r in zip(got, want))
    ms = _best_ms(kernel_grads, device)
    plain_ms = _best_ms(plain_grads, device)
    return got, want, {"kind": "bwd", "case": name, "shape": [b, t, h, d],
                       "dtype": dt, "max_abs_err": max(errs),
                       "errs_dq_dk_dv": errs, "tol": tol, "ok": ok,
                       "ms": ms, "plain_ms": plain_ms, "launches": launches}


def lse_merge_case(device, small=False):
    """The return_lse path (the ring's residual): attention over two
    half-key shards merged by their LSEs equals attention over all keys."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    b, t, h, d, dt = LSE_CASE
    if small:
        b, t, h, d = _small(b, t, h, d)
    dtype = DTYPES[dt]
    q, k, v = _inputs(2, b, t, h, d, dtype, device)
    half = t // 2
    with torch.no_grad():
        before = _launches()
        out, _ = fa.flash_attention(q, k, v, causal=False, return_lse=True)
        o1, l1 = fa.flash_attention(q, k[:, :half], v[:, :half],
                                    return_lse=True)
        o2, l2 = fa.flash_attention(q, k[:, half:], v[:, half:],
                                    return_lse=True)
        launches = _delta(before)
        l1f, l2f = l1.float(), l2.float()
        m = torch.maximum(l1f, l2f)
        w1 = torch.exp(l1f - m)[..., None]
        w2 = torch.exp(l2f - m)[..., None]
        merged = (w1 * o1.float() + w2 * o2.float()) / (w1 + w2)
    err = _max_err(merged, out)
    return {"kind": "lse_merge", "case": f"b{b} t{t} h{h} d{d} {dt}",
            "shape": [b, t, h, d], "dtype": dt, "max_abs_err": err,
            "tol": {"atol": LSE_MERGE_TOL}, "ok": err < LSE_MERGE_TOL,
            "launches": launches}


def run(device="cuda", small=False) -> dict:
    """Every case; the report {"device", "cases", "failures", "ok",
    "launches"}."""
    from deeplearning4j_tpu_torch.util.platform import (
        resolve_device, set_f32_matmul_exact,
    )
    device = resolve_device(device)
    set_f32_matmul_exact()
    if device.type == "cuda":
        print("device:", torch.cuda.get_device_name(device), flush=True)
    rows, failures = [], []
    start = _launches()

    def guarded(kind, name, fn):
        try:
            row = fn()
        except Exception as e:          # noqa: BLE001 — reported, counted
            print(f"{kind} {name}: EXC {type(e).__name__}: "
                  f"{str(e)[:300]}", flush=True)
            traceback.print_exc()
            failures.append(f"{kind} {name}")
            return
        rows.append(row)
        if not row["ok"]:
            failures.append(f"{kind} {name}")
        timing = ""
        if "ms" in row:
            timing = (f" kernel={row['ms']:.3f}ms "
                      f"plain={row['plain_ms']:.3f}ms "
                      f"speedup={row['plain_ms'] / row['ms']:.2f}x")
        print(f"{kind.upper()} {name}: err={row['max_abs_err']:.2e} "
              f"{'OK' if row['ok'] else 'FAIL'}{timing} "
              f"launches={row['launches']}", flush=True)

    for case in FWD_CASES:
        guarded("fwd", case[0], lambda c=case: forward_case(
            c, device, small)[2])
    for case in BWD_CASES:
        guarded("bwd", case[0], lambda c=case: backward_case(
            c, device, small)[2])
    guarded("lse-merge", "return_lse", lambda: lse_merge_case(device, small))
    print("FAILURES:", failures, flush=True)
    return {"device": str(device), "small": small, "cases": rows,
            "failures": failures, "ok": not failures,
            "launches": _delta(start)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without it)")
    p.add_argument("--small", action="store_true",
                   help="every case at a small shape (a CPU run)")
    args = p.parse_args(argv)
    report = run(args.device, args.small)
    print(json.dumps({"ok": report["ok"], "failures": report["failures"],
                      "launches": report["launches"]}))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
