"""CLI training entry point.

Counterpart of the JAX package's `train/cli.py` (DL4J's
ParallelWrapperMain): a model zip in (a MultiLayerNetwork or a
ComputationGraph, as `load_model` finds it), a dataset, fit, the trained
model zip out, and as the last stdout line

    {"output": ..., "final_score": ..., "iterations": ..., "epochs": ...}

Usage:
    python -m deeplearning4j_tpu_torch.train \\
        --model lm.zip --dataset tokens.npz --output out.zip \\
        --mode single --epochs 2 --batch-size 4

The parser keeps the reference's flags and defaults and adds `--device`
(default ``cuda``; ``cpu`` runs on the CPU, and without CUDA the default
raises). `--mode single` runs `net.fit`. `--mode sync` (the default)
trains through a SYNC_GRADIENTS `ParallelWrapper` over the process group
it finds (`parallel/distributed.py`): under torchrun's variables
(MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) or the
reference's (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID) each rank
joins it, NCCL on CUDA (rank r on ``cuda:LOCAL_RANK``) and gloo on the
CPU; launched alone it forms a one-rank group, and on a host with several
visible CUDA devices it starts one worker per device, as the reference
uses every local device. `--mode averaging` is DL4J's AVERAGING
(`--averaging-frequency`, `--no-average-updaters`). `--mesh SPEC`
("data=2,model=1,zero=1,rules=megatron", `parallel.parse_plan`) trains
under that sharding plan (`use_mesh`), in single or sync mode; averaging
refuses it, as in the reference. Only rank 0 saves the model, prints the
result line and serves `--serve-port`; with a plan or a group it also
prints ``{"parallel": {"mode", "world", "plan", "syncs"}}`` on stderr
(``syncs``: the collectives the fit issued). The fit takes `fit`'s own
defaults, as the reference's CLI does: prefetch on (DL4J_CUDA_FIT_PREFETCH,
DL4J_CUDA_PREFETCH_DEPTH) and DL4J_CUDA_SCAN_STEPS steps a chunk (default
1, per-call). `--serve-port` hands the trained network to a
`ModelServer` on that port (0 picks a free one) with `--serve-buckets`,
prints ``{"serving": url, "predict": path}`` on stderr after the result
line, and serves until SIGTERM or SIGINT, which drain it; the run then
exits 0. `--ui-port PORT` (0: a free port) attaches an
`InMemoryStatsStorage`, a `StatsListener` capturing every
`--score-every` iterations (gradients and updates included on the
per-call and accumulate paths of `--mode single`) and a `UIServer` on
that port (on rank 0 of a group), prints ``dashboard: <url>`` on stderr,
and stops the server when the run ends.

`--checkpoint-dir DIR` trains through `ResilientTrainer`
(`train/resilience.py`), over the sync-mode wrapper (averaging refuses
it, as in the reference): atomic manifest-tracked
checkpoints every `--save-every-iterations` steps and at each epoch's
end (`--keep-last` kept), SIGTERM/SIGINT handled at the next step
boundary, the per-step fault policy, and ``DL4J_CUDA_FAULTS`` fault
injection. `--resume` (which needs `--checkpoint-dir`) continues from
the newest valid checkpoint there, bitwise as if never stopped; `--epochs`
is then the total. A run that is preempted exits 3 and one that diverged
(and was rolled back to its last good checkpoint) exits 4, each with
``{"preempted": ..., "diverged": ..., "iterations": ..., "resume_with":
"--resume"}`` on stderr and no output zip.

Telemetry, as in the reference: `--metrics` prints the final
``{"metrics": monitor.summary()}`` on stderr, `--trace-out PATH` records
spans and writes a Chrome trace there, `--perf-ledger PATH` turns the
program ledger on (`monitor/xla.py`: FLOPs, bytes and HBM per step
program, live ``train_mfu_pct``) and writes its JSON there; it defaults
to ``DL4J_CUDA_PERF_LEDGER``, else to ``perf_ledger.json`` beside
`--trace-out`. With any of the three, the goodput ledger attributes the
fit's wall time (`monitor/goodput.py`). They are written in a `finally`
that never masks the fit's own exception.

`--dataset` takes `mnist`, `emnist` and `cifar10` (read from the
fetchers' cache, `data/fetchers.py`; a missing cache fails the run
unless `--synthetic-data` asks for the reference's seeded substitute),
`iris`, or an .npz of `features` and `labels` (images NHWC; a YOLO2
set is (N, 608, 608, 3) images and (N, 19, 19, 4 + classes) labels).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


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
                   help="mnist | emnist | cifar10 | iris | path to .npz "
                        "with 'features' and 'labels' arrays")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--mode", choices=["sync", "averaging", "single"],
                   default="sync",
                   help="sync = data parallelism over the process group "
                        "(ParallelWrapper SYNC_GRADIENTS); averaging = DL4J "
                        "AVERAGING; single = plain net.fit")
    p.add_argument("--averaging-frequency", type=int, default=5)
    p.add_argument("--no-average-updaters", action="store_true",
                   help="skip averaging optimizer state (saveUpdater=false)")
    p.add_argument("--ui-port", type=int, default=None,
                   help="serve the training dashboard on this port (0: a "
                        "free port)")
    p.add_argument("--score-every", type=int, default=10,
                   help="ScoreIterationListener frequency")
    p.add_argument("--synthetic-data", action="store_true",
                   help="substitute deterministic synthetic data when the "
                        "dataset cache is missing (pipeline testing only); "
                        "without this flag a missing cache is an error")
    p.add_argument("--checkpoint-dir", default=None,
                   help="fault-tolerant training (ResilientTrainer): "
                        "atomic manifest-tracked checkpoints in this "
                        "directory, SIGTERM/SIGINT preemption handling, "
                        "per-step fault policy")
    p.add_argument("--resume", action="store_true",
                   help="auto-resume from the newest valid checkpoint in "
                        "--checkpoint-dir (bitwise-identical continuation); "
                        "--epochs is then the TOTAL epoch target")
    p.add_argument("--save-every-iterations", type=int, default=50,
                   help="checkpoint cadence for --checkpoint-dir runs")
    p.add_argument("--keep-last", type=int, default=3,
                   help="checkpoints retained by manifest pruning")
    p.add_argument("--metrics", action="store_true",
                   help="print the final telemetry summary "
                        "(monitor.summary()) as JSON to stderr")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="record telemetry spans and write a Chrome "
                        "trace-event JSON to PATH on exit (load in "
                        "Perfetto / chrome://tracing)")
    p.add_argument("--perf-ledger", default=None, metavar="PATH",
                   help="enable the program ledger (monitor.xla: per-"
                        "program fingerprint, capture time, flops, bytes "
                        "accessed, HBM peak; live train_mfu_pct) and write "
                        "the ledger JSON to PATH on exit; defaults to "
                        "$DL4J_CUDA_PERF_LEDGER, else perf_ledger.json "
                        "alongside --trace-out when tracing is on")
    p.add_argument("--serve-port", type=int, default=None,
                   help="serve the trained model on this port after the "
                        "fit (0: a free port) until SIGTERM/SIGINT")
    p.add_argument("--serve-buckets", default="1,8,32,128",
                   help="batch-size bucket ladder for --serve-port")
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="sharding plan, e.g. 'data=2,zero=1' or "
                        "'data=2,model=2,rules=megatron' (keys: data, "
                        "model, zero, rules)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cpu for "
                        "the CPU)")
    return p


def _serve_trained(net, args) -> None:
    """The train -> serve handoff: publish the just-trained network on
    --serve-port and block until a signal asks for a graceful drain."""
    import signal
    import threading

    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
    registry = ModelRegistry(device=net.device)
    registry.deploy("model", net, buckets=args.serve_buckets)
    server = ModelServer(registry, port=args.serve_port)
    print(json.dumps({"serving": server.url,
                      "predict": "/v1/models/model/predict"}),
          file=sys.stderr, flush=True)
    stop = threading.Event()
    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, lambda *_: stop.set())
    stop.wait()
    server.drain()


def _spawn_local_workers(argv, n: int) -> int:
    """One worker process per visible CUDA device, joined into one group
    on a free local port (the reference drives every local device);
    rank 0's exit code, or the first failure's."""
    import os
    import subprocess

    from deeplearning4j_tpu_torch.parallel.distributed import free_port
    port = free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES=str(n), PROCESS_ID=str(r),
                   LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.train"]
            + list(argv), env=env))
    codes = [p.wait() for p in procs]
    return codes[0] if codes[0] else next((c for c in codes if c), 0)


def _join_group(args):
    """The process group this run trains in and this rank's device: (the
    device, whether this call formed the group)."""
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.distributed import (
        DistributedConfig, initialize_distributed, rank_device,
    )
    from deeplearning4j_tpu_torch.util.platform import resolve_device
    device = resolve_device(args.device)
    if dist.is_initialized():
        return device, False
    cfg = DistributedConfig.from_env()
    initialize_distributed(cfg, device_type=device.type, single=True)
    if device.type == "cuda":
        device = rank_device("cuda", cfg)
        torch.cuda.set_device(device)
    return device, True


def _parallel_record(args, net, wrapper, plan) -> dict:
    """The stderr record of a data-parallel run."""
    import torch.distributed as dist
    syncs = net._plan_syncs + (wrapper.syncs if wrapper is not None else 0)
    desc = wrapper.plan if wrapper is not None else plan
    return {"parallel": {
        "mode": args.mode,
        "world": dist.get_world_size() if dist.is_initialized() else 1,
        "backend": str(dist.get_backend()) if dist.is_initialized()
        else None,
        "plan": None if desc is None else desc.describe(),
        "syncs": syncs}}


def _load_data(name: str, batch_size: int, allow_synthetic: bool = False):
    from deeplearning4j_tpu_torch.data import fetchers
    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    # a training CLI must not train on synthetic noise unasked: the
    # fetchers' lenient default becomes a loud failure without the flag
    syn = None if allow_synthetic else False
    builtin = {
        "mnist": lambda: fetchers.MnistDataSetIterator(
            batch_size=batch_size, synthetic=syn),
        "emnist": lambda: fetchers.EmnistDataSetIterator(
            batch_size=batch_size, synthetic=syn),
        "cifar10": lambda: fetchers.Cifar10DataSetIterator(
            batch_size=batch_size, synthetic=syn),
        "iris": lambda: fetchers.IrisDataSetIterator(batch_size=batch_size),
    }
    if name.lower() in builtin:
        return builtin[name.lower()]()
    with np.load(name) as data:
        if "features" not in data or "labels" not in data:
            raise SystemExit(f"{name}: npz must contain 'features' and "
                             "'labels'")
        return ArrayDataSetIterator(data["features"], data["labels"],
                                    batch_size=batch_size)


def _enable_telemetry(args):
    """Turn on what the telemetry flags ask for; returns the emitter the
    caller runs in its `finally`."""
    import os

    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.util.env import env_str
    if args.trace_out:
        monitor.enable_tracing()
    if args.perf_ledger is None:
        args.perf_ledger = env_str("DL4J_CUDA_PERF_LEDGER")
    if args.perf_ledger is None and args.trace_out:
        # "alongside --trace-out": tracing runs double as perf-ledger runs
        # unless the user points the ledger elsewhere
        args.perf_ledger = os.path.join(
            os.path.dirname(os.path.abspath(args.trace_out)),
            "perf_ledger.json")
    if args.perf_ledger:
        monitor.xla.enable_ledger(args.perf_ledger)
    if (args.metrics or args.trace_out or args.perf_ledger) \
            and not monitor.goodput.goodput_enabled():
        monitor.goodput.enable_goodput()

    def emit_telemetry():
        # runs in a finally: a bad --trace-out path (unwritable dir, full
        # disk) must not fail an otherwise-successful run or mask the
        # fit's real exception
        if args.trace_out:
            try:
                n = monitor.save_trace(args.trace_out)
                print(f"trace: {args.trace_out} ({n} events)",
                      file=sys.stderr)
            except OSError as e:
                print(f"trace not written to {args.trace_out}: {e}",
                      file=sys.stderr)
        if args.perf_ledger:
            try:
                n = monitor.xla.save_ledger(args.perf_ledger)
                print(f"perf ledger: {args.perf_ledger} ({n} programs)",
                      file=sys.stderr)
            except OSError as e:
                print(f"perf ledger not written to {args.perf_ledger}: {e}",
                      file=sys.stderr)
        if args.metrics:
            print(json.dumps({"metrics": monitor.summary()}),
                  file=sys.stderr)
        sys.stderr.flush()

    return emit_telemetry


def _fit_resilient(net, target, iterator, args) -> int:
    """The --checkpoint-dir path: 0 when the fit completed, 3 preempted,
    4 diverged (the network then holds its last good checkpoint)."""
    from deeplearning4j_tpu_torch.train.resilience import ResilientTrainer
    trainer = ResilientTrainer(
        target, args.checkpoint_dir,
        save_every_n_iterations=args.save_every_iterations,
        keep_last=args.keep_last, resume=args.resume)
    report = trainer.fit(iterator, epochs=args.epochs,
                         batch_size=args.batch_size)
    if report.preempted or report.diverged:
        # an incomplete run: no output model, no result line, a distinct
        # exit code so a caller cannot take it for a finished job
        if _is_coordinator():
            print(json.dumps({"preempted": report.preempted,
                              "diverged": report.diverged,
                              "iterations": net.iteration_count,
                              "resume_with": "--resume"}), file=sys.stderr)
        return 3 if report.preempted else 4
    return 0


def _is_coordinator() -> bool:
    from deeplearning4j_tpu_torch.parallel.distributed import is_coordinator
    return is_coordinator()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    try:
        args.serve_buckets = tuple(
            int(b) for b in args.serve_buckets.split(",") if b)
    except ValueError:
        raise SystemExit(f"--serve-buckets must be comma-separated ints, "
                         f"got {args.serve_buckets!r}")
    mesh_plan = None
    if args.mesh:
        from deeplearning4j_tpu_torch.parallel.plan import parse_plan
        try:
            mesh_plan = parse_plan(args.mesh)
        except ValueError as e:
            raise SystemExit(f"--mesh: {e}")
        if args.mode == "averaging":
            raise SystemExit("--mesh applies to --mode single|sync "
                             "(AVERAGING keeps per-worker replicas by "
                             "definition)")
    if args.checkpoint_dir and args.mode == "averaging":
        raise SystemExit("--checkpoint-dir supports --mode single|sync "
                         "(AVERAGING replica state is not resumable)")
    from deeplearning4j_tpu_torch.parallel.distributed import (
        DistributedConfig, shutdown_distributed,
    )
    from deeplearning4j_tpu_torch.util.platform import resolve_device
    device = resolve_device(args.device)
    parallel = args.mode != "single" or mesh_plan is not None
    if parallel and device.type == "cuda" \
            and not DistributedConfig.from_env().configured:
        import torch
        import torch.distributed as dist
        if not dist.is_initialized() and torch.cuda.device_count() > 1:
            return _spawn_local_workers(
                sys.argv[1:] if argv is None else argv,
                torch.cuda.device_count())
    formed = False
    if parallel:
        device, formed = _join_group(args)
    try:
        if mesh_plan is not None:
            try:
                # the extents against the group's ranks, before the fit
                mesh_plan.mesh()
            except ValueError as e:
                raise SystemExit(f"--mesh: {e}")
        return _train(args, device, mesh_plan, parallel)
    finally:
        if formed:
            shutdown_distributed()


class _DroppedStats:
    """A StatsStorageRouter that keeps nothing: a non-coordinating rank's
    dashboard records."""

    def put_static_info(self, record):
        pass

    def put_update(self, record):
        pass


def _train(args, device, mesh_plan, parallel: bool) -> int:
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper, TrainingMode, use_mesh,
    )
    from deeplearning4j_tpu_torch.train.listeners import (
        PerformanceListener, ScoreIterationListener,
    )
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    import contextlib
    emit_telemetry = _enable_telemetry(args)
    lead = _is_coordinator()
    ui_server = None
    # telemetry emits in a finally: a fit that dies mid-run still leaves
    # the trace/metrics record — the crash case is when it is most needed
    try:
        net = load_model(args.model, device=device)
        iterator = _load_data(args.dataset, args.batch_size,
                              allow_synthetic=args.synthetic_data)
        listeners = [ScoreIterationListener(args.score_every),
                     PerformanceListener(args.score_every)]
        if args.ui_port is not None:
            # every rank captures on the same iterations (a sharded plan
            # gathers the gradients and updates there, a collective); one
            # dashboard for the group, on the rank that saves and prints
            # (the others would take the same port), the others' records
            # dropped
            from deeplearning4j_tpu_torch.ui import (
                InMemoryStatsStorage, StatsListener, UIServer,
            )
            storage = InMemoryStatsStorage() if lead else _DroppedStats()
            listeners.append(StatsListener(storage,
                                           frequency=args.score_every))
            if lead:
                ui_server = UIServer(port=args.ui_port)  # serves once built
                ui_server.attach(storage)
                print(f"dashboard: {ui_server.url}", file=sys.stderr,
                      flush=True)
        net.set_listeners(*listeners)
        wrapper = None
        # --mesh: the whole training section runs under use_mesh, so the
        # plain fit, the wrapper and ResilientTrainer all resolve it
        ctx = use_mesh(mesh_plan) if mesh_plan is not None \
            else contextlib.nullcontext()
        with ctx:
            if mesh_plan is not None and lead:
                print(f"mesh plan: {mesh_plan.describe()}", file=sys.stderr)
            if args.mode != "single":
                wrapper = ParallelWrapper(
                    net, mode=(TrainingMode.SYNC_GRADIENTS
                               if args.mode == "sync"
                               else TrainingMode.AVERAGING),
                    averaging_frequency=args.averaging_frequency,
                    average_updaters=not args.no_average_updaters)
            if args.checkpoint_dir:
                code = _fit_resilient(net, wrapper or net, iterator, args)
                if code:
                    return code
            elif wrapper is not None:
                wrapper.fit(iterator, epochs=args.epochs,
                            batch_size=args.batch_size)
            else:
                net.fit(iterator, epochs=args.epochs)
        if not lead:
            return 0
        save_model(net, args.output)
        print(json.dumps({"output": args.output,
                          "final_score": net.score(),
                          "iterations": net.iteration_count,
                          "epochs": net.epoch_count}))
        sys.stdout.flush()
        if parallel:
            print(json.dumps(_parallel_record(args, net, wrapper,
                                              mesh_plan)),
                  file=sys.stderr, flush=True)
        if args.serve_port is not None:
            _serve_trained(net, args)
        return 0
    finally:
        if ui_server is not None:
            ui_server.stop()
        emit_telemetry()


if __name__ == "__main__":
    raise SystemExit(main())
