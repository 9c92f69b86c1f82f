"""Goodput acceptance run: wall-clock waterfalls for a clean and a
throttled fit, the exclusivity check, and the anomaly postmortem drill.

    python -m deeplearning4j_tpu_torch.tools.goodput_report \\
        [--device cpu] [--out GOODPUT.json]

The port's counterpart of the JAX package's `tools/goodput_report.py`,
with the same assertions and report keys, the networks on ``--device``
(CUDA by default; it raises without CUDA unless ``cpu`` is asked). Two
instrumented ResilientTrainer fits (`monitor/goodput.py`):

1. **Clean** — checkpoint saves + an eval gate every 16 steps, so every
   category of the partition gets exercised. Asserts the exclusivity
   contract: the categories sum to an externally measured fit wall-clock
   within 5%.
2. **Throttled ETL** — a `FaultInjector(etl_stall_at=..., etl_stall_s=...)`
   freezes the input pipeline mid-run (no checkpoint saves scheduled
   before it, so nothing shadows the trip inside the detector cooldown).
   Asserts the stall lands in ``data_wait``, the step-time anomaly
   detector fires, and the auto-dumped flight postmortem names
   ``data_wait`` as the dominant category WITH all-thread stack
   snapshots attached.

Prints a JSON report with a bench-style "sweep" row carrying
``train_goodput_pct`` of the clean fit (a dimensionless ratio) plus the
``calib_cpu_ms`` machine-speed reference of the host. Exit 0 iff every
assertion held.
"""
import argparse
import glob
import json
import os
import sys
import tempfile
import time

N_IN, N_OUT = 6, 3
SUM_TOL_FRAC = 0.05             # acceptance: categories-vs-wall miss
SUM_TOL_ABS_S = 0.25            # floor for very short fits
STALL_STEP, STALL_S = 30, 0.5


def _blobs(n=480, seed=0):
    import numpy as np
    rs = np.random.RandomState(seed)
    X = rs.randn(n, N_IN).astype("float32")
    Y = np.eye(N_OUT, dtype="float32")[rs.randint(0, N_OUT, n)]
    return X, Y


def _net(device, seed=7):
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=N_OUT, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(N_IN)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _data():
    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    X, Y = _blobs()
    return ArrayDataSetIterator(X, Y, batch_size=10)   # 48 steps/epoch


def _waterfall(title, summary, fit_wall):
    print(f"\n{title}: wall {summary['wall_s']:.3f}s "
          f"(stopwatch {fit_wall:.3f}s), {summary['steps']} steps, "
          f"goodput {summary['goodput_pct']:.1f}%")
    cats = summary["categories"]
    for name in sorted(cats, key=cats.get, reverse=True):
        secs = cats[name]
        if secs <= 0:
            continue
        bar = "#" * max(1, int(40 * secs / max(summary["wall_s"], 1e-9)))
        print(f"  {name:<14} {secs:>8.3f}s  {bar}")


def run_clean(workdir, failures, device):
    from deeplearning4j_tpu_torch.monitor import goodput
    from deeplearning4j_tpu_torch.train import FaultPolicy, ResilientTrainer
    goodput.enable_goodput()
    try:
        trainer = ResilientTrainer(
            _net(device), os.path.join(workdir, "clean"),
            save_every_n_iterations=16,
            policy=FaultPolicy(backoff_base=0.001, backoff_max=0.004),
            eval_gate=lambda net: {"score": float(net.score() or 0.0)})
        t0 = time.perf_counter()
        report = trainer.fit(_data(), epochs=1)
        fit_wall = time.perf_counter() - t0
    finally:
        summary = goodput.last_session()
        goodput.disable_goodput()
    if summary is None or report.goodput_pct is None:
        failures.append("clean: no goodput session recorded")
        return {"error": "no session"}
    _waterfall("clean fit", summary, fit_wall)
    attributed = sum(report.time_by_category.values())
    tol = max(SUM_TOL_FRAC * fit_wall, SUM_TOL_ABS_S)
    if abs(attributed - fit_wall) > tol:
        failures.append(
            f"clean: exclusivity broken — categories sum to "
            f"{attributed:.3f}s vs {fit_wall:.3f}s stopwatch (tol {tol:.3f})")
    for name in ("checkpoint", "eval_gate", "data_wait"):
        if report.time_by_category.get(name, 0.0) <= 0.0:
            failures.append(f"clean: category {name!r} never attributed")
    return {"summary": summary, "fit_wall_s": round(fit_wall, 6),
            "attributed_s": round(attributed, 6),
            "exclusivity_miss_s": round(abs(attributed - fit_wall), 6)}


def run_throttled(workdir, failures, device):
    from deeplearning4j_tpu_torch.monitor import flight, goodput
    from deeplearning4j_tpu_torch.train import FaultPolicy, ResilientTrainer
    from deeplearning4j_tpu_torch.util.faults import FaultInjector
    pm_dir = os.path.join(workdir, "postmortems")
    flight.enable_flight(dump_dir=pm_dir)
    goodput.enable_goodput(anomaly_min_s=0.05)
    try:
        trainer = ResilientTrainer(
            _net(device, seed=11), os.path.join(workdir, "throttled"),
            save_every_n_iterations=10_000,   # nothing shadows the trip
            policy=FaultPolicy(backoff_base=0.001, backoff_max=0.004),
            injector=FaultInjector(etl_stall_at=[STALL_STEP],
                                   etl_stall_s=STALL_S))
        t0 = time.perf_counter()
        report = trainer.fit(_data(), epochs=1)
        fit_wall = time.perf_counter() - t0
    finally:
        summary = goodput.last_session()
        goodput.disable_goodput()
        docs = [d for d in flight.postmortems()
                if d["reason"] == "step_time_anomaly"]
        flight.disable_flight()
    if summary is None:
        failures.append("throttled: no goodput session recorded")
        return {"error": "no session"}
    _waterfall("throttled fit", summary, fit_wall)
    data_wait = summary["categories"]["data_wait"]
    if data_wait < STALL_S:
        failures.append(f"throttled: injected {STALL_S}s ETL stall but "
                        f"data_wait={data_wait:.3f}s")
    if summary["anomalies"] < 1:
        failures.append("throttled: the stall never tripped the "
                        "step-time anomaly detector")
    out = {"summary": summary, "fit_wall_s": round(fit_wall, 6),
           "goodput_pct": report.goodput_pct}
    if not docs:
        failures.append("throttled: no step_time_anomaly postmortem")
        return out
    doc = docs[-1]
    meta = doc["meta"]
    print(f"  postmortem: step {meta.get('step')}, "
          f"iteration wall {meta.get('iteration_wall_s')}s "
          f"(median {meta.get('median_s')}s), dominant "
          f"{meta.get('dominant_category')} "
          f"({meta.get('dominant_seconds')}s), "
          f"{len(doc.get('threads', []))} thread stacks")
    if meta.get("dominant_category") != "data_wait":
        failures.append(f"throttled: postmortem blames "
                        f"{meta.get('dominant_category')!r}, not data_wait")
    if not doc.get("threads"):
        failures.append("throttled: postmortem has no thread stacks")
    dumps = glob.glob(os.path.join(pm_dir, "*step_time_anomaly*.json"))
    if not dumps:
        failures.append("throttled: postmortem JSON not dumped to disk")
    out["postmortem"] = {
        "dominant_category": meta.get("dominant_category"),
        "step": meta.get("step"),
        "iteration_wall_s": meta.get("iteration_wall_s"),
        "n_threads": len(doc.get("threads", [])),
        "dumped": [os.path.basename(p) for p in dumps]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device the fits run on (default cuda; "
                        "raises without it)")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="also write the JSON report to PATH")
    args = p.parse_args(argv)

    from deeplearning4j_tpu_torch.tools.loadgen import calibrate
    from deeplearning4j_tpu_torch.util.platform import (
        resolve_device, set_f32_matmul_exact,
    )
    device = resolve_device(args.device)
    set_f32_matmul_exact()
    calib_start = calibrate()

    failures = []
    with tempfile.TemporaryDirectory(prefix="goodput_report_") as workdir:
        clean = run_clean(workdir, failures, device)
        throttled = run_throttled(workdir, failures, device)

    summary = {
        "device": str(device),
        "clean": clean,
        "throttled": throttled,
        "calib_cpu_ms": round((calib_start + calibrate()) / 2, 3),
        "ok": not failures,
        "failures": failures,
        "sweep": [{
            "mode": "goodput_fit", "on_gpu": device.type == "cuda",
            "batch": None,
            "train_goodput_pct":
                (clean.get("summary") or {}).get("goodput_pct"),
            "goodput_categories_s": (clean.get("summary") or {}
                                     ).get("categories"),
            "throttled_data_wait_s": (throttled.get("summary") or {}
                                      ).get("categories", {}
                                            ).get("data_wait"),
            "anomalies": (throttled.get("summary") or {}).get("anomalies"),
        }],
    }
    print("\n" + json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
            f.write("\n")
    if failures:
        print(f"\ngoodput_report: {len(failures)} FAILURE(S)",
              file=sys.stderr)
        for msg in failures:
            print(f"  - {msg}", file=sys.stderr)
        return 1
    print("\ngoodput_report: all assertions held")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
