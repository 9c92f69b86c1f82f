#!/usr/bin/env python
"""Chaos smoke: a short fit under randomized injected faults must still
converge. Usable locally and from CI:

    python -m deeplearning4j_tpu_torch.tools.chaos_fit --seed 3 \
        [--device cpu]

The port's counterpart of the JAX package's `tools/chaos_fit.py`, with
the same schedule, assertions and summary keys; the networks run on
``--device`` (CUDA by default; it raises without CUDA unless ``cpu`` is
asked).

Builds a small classifier on deterministic synthetic blobs, derives a
randomized-but-seeded fault schedule (NaN steps, transient errors, one
mid-run crash, one preemption), runs it through ResilientTrainer in a
crash/resume sequence, and asserts:

- every run survives its faults (skips + retries, no unhandled error),
- the killed-and-resumed sequence reaches bitwise-identical params to a
  clean uninterrupted run,
- the final loss improves on the initial loss (training actually worked).

Exit code 0 on success, 1 on failure; prints a JSON summary either way.
"""
import argparse
import json
import random
import tempfile

import numpy as np


def _blobs(n=240, d=8, k=3, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(k, d) * 3
    X = np.concatenate([centers[i] + rs.randn(n // k, d)
                        for i in range(k)]).astype("float32")
    Y = np.eye(k, dtype="float32")[np.repeat(np.arange(k), n // k)]
    return X, Y


def _host(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") \
        else np.asarray(a)


def _net(seed, device):
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(2e-2))
            .list()
            .layer(DenseLayer(n_out=24, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())
    return MultiLayerNetwork(conf, device=device).init()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the fault schedule AND the model")
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=24)
    p.add_argument("--checkpoint-dir", default=None,
                   help="default: a fresh temp dir")
    p.add_argument("--device", default="cuda",
                   help="torch device of the fits (default cuda; raises "
                        "without it)")
    args = p.parse_args(argv)

    from deeplearning4j_tpu_torch.util.platform import (
        resolve_device, set_f32_matmul_exact,
    )
    device = resolve_device(args.device)
    set_f32_matmul_exact()

    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.train.resilience import (
        FaultPolicy, ResilientTrainer,
    )
    from deeplearning4j_tpu_torch.util.faults import FaultInjector, SimulatedCrash

    X, Y = _blobs(seed=args.seed)
    steps_per_epoch = len(X) // args.batch_size
    total = steps_per_epoch * args.epochs
    data = lambda: ArrayDataSetIterator(X, Y, batch_size=args.batch_size)
    policy = FaultPolicy(backoff_base=0.001, backoff_max=0.01,
                         max_consecutive_skips=4)

    # randomized (seeded) schedule over the middle of the run: faults at
    # the edges are covered by the unit tests; the smoke wants overlap
    rng = random.Random(args.seed)
    pool = list(range(1, total - 1))
    rng.shuffle(pool)
    nan_at = sorted(pool[:3])
    transient_at = sorted(pool[3:6])
    crash_at = pool[6]
    summary = {"seed": args.seed, "device": str(device),
               "total_steps": total, "nan_at": nan_at,
               "transient_at": transient_at, "crash_at": crash_at}

    ckdir = args.checkpoint_dir or tempfile.mkdtemp(prefix="chaos_fit_")
    refdir = tempfile.mkdtemp(prefix="chaos_ref_")
    failures = []
    try:
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        # reference: same fault schedule minus the crash, uninterrupted
        ref = _net(args.seed, device)
        initial = float(ref.score(DataSet(X, Y)))
        rep_ref = ResilientTrainer(
            ref, refdir, save_every_n_iterations=10_000, policy=policy,
            injector=FaultInjector(nan_at=nan_at, transient_at=transient_at)
        ).fit(data(), epochs=args.epochs)
        summary["ref"] = {"skipped": rep_ref.skipped_steps,
                          "retries": rep_ref.retries,
                          "score": rep_ref.final_score}

        # chaos run: same schedule PLUS a hard crash, then auto-resume
        net = _net(args.seed, device)
        try:
            ResilientTrainer(
                net, ckdir, save_every_n_iterations=2, policy=policy,
                injector=FaultInjector(nan_at=nan_at,
                                       transient_at=transient_at,
                                       crash_at=crash_at)
            ).fit(data(), epochs=args.epochs)
            failures.append("crash did not fire")
        except SimulatedCrash:
            pass
        resumed = _net(args.seed, device)
        rep = ResilientTrainer(
            resumed, ckdir, save_every_n_iterations=2, policy=policy,
            injector=FaultInjector(nan_at=nan_at, transient_at=transient_at)
        ).fit(data(), epochs=args.epochs)
        summary["resumed"] = {"resumed_from": rep.resumed_from,
                              "skipped": rep.skipped_steps,
                              "retries": rep.retries,
                              "score": rep.final_score}

        final = rep.final_score
        if rep.resumed_from is None:
            failures.append("resume did not engage")
        if not np.array_equal(_host(ref.params_flat()),
                              _host(resumed.params_flat())):
            failures.append("crash+resume params != uninterrupted params")
        if not np.isfinite(_host(resumed.params_flat())).all():
            failures.append("non-finite params after chaos run")
        if not (final is not None and np.isfinite(final)
                and final < initial):
            failures.append(
                f"did not converge: initial {initial} -> final {final}")
        summary["initial_score"] = initial
    except Exception as e:  # noqa: BLE001 - smoke must report, not die
        failures.append(f"{type(e).__name__}: {e}")

    # attributable CI record: the run's full telemetry (skips, retries,
    # checkpoint IO, step timings) rides along in the summary JSON
    from deeplearning4j_tpu_torch import monitor
    summary["metrics"] = monitor.summary()
    summary["failures"] = failures
    summary["ok"] = not failures
    print(json.dumps(summary, indent=1))
    return 0 if not failures else 1


if __name__ == "__main__":
    raise SystemExit(main())
