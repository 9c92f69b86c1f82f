"""Capture a torch.profiler trace of the ResNet-50 training step.

    python -m deeplearning4j_tpu_torch.tools.profile_capture \\
        [--device cpu] [--out TRACE.json] [--batch N] [--hw N]

The port's counterpart of the JAX package's `tools/profile_capture.py`
(a `jax.profiler` trace of the step on a TPU). Runs a few warm per-call
fit steps and one warm replayed fit (``fit(scan_steps=10)``: the step
captured once as a CUDA graph, then replayed), then traces 10 per-call
steps plus one replayed fit of 10 steps with `torch.profiler` (CPU and
CUDA activity) and writes the Chrome trace (default
``<tmp>/dl4j_cuda_trace.json``), loadable in ui.perfetto.dev or
chrome://tracing. A one-line summary of the wall time a step goes to
stdout, with the device's name: a CPU run (``--device cpu``, small
``--batch``/``--hw``) prints no throughput, so it can never be read as a
card's numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without it)")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="Chrome trace path (default: "
                        "<tmp>/dl4j_cuda_trace.json)")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--hw", type=int, default=224,
                   help="input height and width")
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args(argv)

    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.data.iterator import (
        ExistingDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.platform import (
        resolve_device, set_f32_matmul_exact,
    )
    device = resolve_device(args.device)
    set_f32_matmul_exact()
    out = args.out or os.path.join(tempfile.gettempdir(),
                                   "dl4j_cuda_trace.json")
    conf = dataclasses.replace(
        ResNet50(num_classes=1000,
                 input_shape=(args.hw, args.hw, 3)).conf(),
        compute_dtype="bfloat16")
    net = ComputationGraph(conf, device=device).init()
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(args.batch, args.hw, args.hw, 3, generator=g,
                   device=device)
    y = torch.nn.functional.one_hot(torch.randint(
        0, 1000, (args.batch,), generator=g, device=device), 1000).float()
    mds = MultiDataSet((x,), (y,))
    k = args.steps

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def replayed():
        net.fit(ExistingDataSetIterator([mds] * k), scan_steps=k)

    # warm both paths outside the trace window (the replayed one captures)
    for _ in range(3):
        net.fit(mds)
    replayed()
    sync()
    print("warm done", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(k):
            net.fit(mds)                 # ends in the step's loss fetch
        sync()
        t_per_call = time.perf_counter() - t0
        t1 = time.perf_counter()
        replayed()
        sync()
        t_scan = time.perf_counter() - t1
    prof.export_chrome_trace(out)
    print(f"trace saved to {out}", flush=True)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    per_call_ms = t_per_call / k * 1e3
    scan_ms = t_scan / k * 1e3
    if device.type != "cuda":
        print(f"[{kind}] CPU smoke only — throughput suppressed "
              f"(per-call {per_call_ms:.1f} ms/step, "
              f"scan{k} {scan_ms:.1f} ms/step)", flush=True)
    else:
        print(f"[{kind}] per-call: {args.batch / (per_call_ms / 1e3):.1f} "
              f"imgs/s ({per_call_ms:.2f} ms/step); scan{k}: "
              f"{args.batch / (scan_ms / 1e3):.1f} imgs/s "
              f"({scan_ms:.2f} ms/step)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
