"""CLI training entry point.

Counterpart of the JAX package's `train/cli.py` (DL4J's
ParallelWrapperMain): a model zip in, a dataset, fit, the trained model
zip out, and as the last stdout line

    {"output": ..., "final_score": ..., "iterations": ..., "epochs": ...}

Usage:
    python -m deeplearning4j_tpu_torch.train \\
        --model lm.zip --dataset tokens.npz --output out.zip \\
        --mode single --epochs 2 --batch-size 4

The parser keeps the reference's flags and defaults and adds `--device`
(default ``cuda``; ``cpu`` runs on the CPU, and without CUDA the default
raises). `--mode single` runs `net.fit`; `--mode sync` (the default) is
data parallelism, which over one worker is the same plain fit, so it runs
that when exactly one worker is visible. Every flag of a part not yet
ported (more than one worker, `averaging`, checkpoints and resume, the
dashboard, telemetry, the serve handoff, sharding plans, the fetchers
that need a download) stops the run with "not yet ported"; none is
ignored.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# flags of parts that wait, each with the slice it comes with
_UNPORTED_FLAGS = (
    ("checkpoint_dir", "--checkpoint-dir", "resilience (ResilientTrainer)"),
    ("resume", "--resume", "resilience (ResilientTrainer)"),
    ("ui_port", "--ui-port", "UI"),
    ("metrics", "--metrics", "telemetry"),
    ("trace_out", "--trace-out", "telemetry"),
    ("perf_ledger", "--perf-ledger", "telemetry"),
    ("serve_port", "--serve-port", "serving handoff"),
    ("mesh", "--mesh", "parallel"),
)

_DOWNLOADED = ("mnist", "emnist", "cifar10")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.train",
        description="Train a serialized model on PyTorch/CUDA (the "
                    "ParallelWrapperMain analog)")
    p.add_argument("--model", required=True,
                   help="input model zip (save_model format)")
    p.add_argument("--output", required=True,
                   help="where to write the trained model zip")
    p.add_argument("--dataset", required=True,
                   help="iris | path to .npz with 'features' and 'labels' "
                        "arrays (mnist | emnist | cifar10 are not yet "
                        "ported)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--mode", choices=["sync", "averaging", "single"],
                   default="sync",
                   help="sync = data parallelism (one worker: a plain fit); "
                        "averaging = DL4J AVERAGING (not yet ported); "
                        "single = plain net.fit")
    p.add_argument("--averaging-frequency", type=int, default=5)
    p.add_argument("--no-average-updaters", action="store_true",
                   help="skip averaging optimizer state (saveUpdater=false)")
    p.add_argument("--ui-port", type=int, default=None,
                   help="training dashboard (not yet ported)")
    p.add_argument("--score-every", type=int, default=10,
                   help="ScoreIterationListener frequency")
    p.add_argument("--synthetic-data", action="store_true",
                   help="synthetic data for a missing download cache (the "
                        "fetchers that need one are not yet ported)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="fault-tolerant training (not yet ported)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint-dir (not yet ported)")
    p.add_argument("--save-every-iterations", type=int, default=50,
                   help="checkpoint cadence for --checkpoint-dir runs")
    p.add_argument("--keep-last", type=int, default=3,
                   help="checkpoints retained by manifest pruning")
    p.add_argument("--metrics", action="store_true",
                   help="telemetry summary (not yet ported)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="Chrome trace of telemetry spans (not yet ported)")
    p.add_argument("--perf-ledger", default=None, metavar="PATH",
                   help="compiled-program ledger (not yet ported)")
    p.add_argument("--serve-port", type=int, default=None,
                   help="serve the trained model after the fit (not yet "
                        "ported)")
    p.add_argument("--serve-buckets", default="1,8,32,128",
                   help="batch-size bucket ladder for --serve-port")
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="sharding plan (not yet ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cpu for "
                        "the CPU)")
    return p


def _refuse_unported(args):
    for attr, flag, part in _UNPORTED_FLAGS:
        if getattr(args, attr):
            raise SystemExit(f"{flag}: not yet ported to the PyTorch port "
                             f"(comes with the {part} slice)")
    if args.mode == "averaging":
        raise SystemExit("--mode averaging: not yet ported to the PyTorch "
                         "port (comes with the parallel slice)")
    if args.dataset.lower() in _DOWNLOADED:
        raise SystemExit(f"--dataset {args.dataset}: not yet ported to the "
                         "PyTorch port (its fetcher reads a download cache; "
                         "comes with the data slice); pass an .npz")


def _workers(device) -> int:
    import torch
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _load_data(name: str, batch_size: int):
    from deeplearning4j_tpu_torch.data.fetchers import IrisDataSetIterator
    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    if name.lower() == "iris":
        return IrisDataSetIterator(batch_size=batch_size)
    with np.load(name) as data:
        if "features" not in data or "labels" not in data:
            raise SystemExit(f"{name}: npz must contain 'features' and "
                             "'labels'")
        return ArrayDataSetIterator(data["features"], data["labels"],
                                    batch_size=batch_size)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    try:
        args.serve_buckets = tuple(
            int(b) for b in args.serve_buckets.split(",") if b)
    except ValueError:
        raise SystemExit(f"--serve-buckets must be comma-separated ints, "
                         f"got {args.serve_buckets!r}")
    from deeplearning4j_tpu_torch.train.listeners import (
        PerformanceListener, ScoreIterationListener,
    )
    from deeplearning4j_tpu_torch.util.platform import resolve_device
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    device = resolve_device(args.device)
    if args.mode == "sync" and _workers(device) > 1:
        raise SystemExit(
            f"--mode sync over {_workers(device)} CUDA devices: not yet "
            "ported to the PyTorch port (comes with the parallel slice); "
            "use --mode single or make one device visible")
    net = load_model(args.model, device=device)
    iterator = _load_data(args.dataset, args.batch_size)
    net.set_listeners(ScoreIterationListener(args.score_every),
                      PerformanceListener(args.score_every))
    net.fit(iterator, epochs=args.epochs)
    save_model(net, args.output)
    print(json.dumps({"output": args.output,
                      "final_score": net.score(),
                      "iterations": net.iteration_count,
                      "epochs": net.epoch_count}))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
