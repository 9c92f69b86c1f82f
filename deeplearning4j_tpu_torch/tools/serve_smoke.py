#!/usr/bin/env python
"""Serving smoke: the acceptance gate for the model-serving subsystem.

    python -m deeplearning4j_tpu_torch.tools.serve_smoke [--device cpu]

The port's counterpart of the JAX package's `tools/serve_smoke.py`, with
the same assertions and summary keys; the servables run on ``--device``
(CUDA by default; it raises without CUDA unless ``cpu`` is asked). In
one process (no network egress):

1. builds a zoo LeNet, saves v1/v2 checkpoints (different seeds), deploys
   v1 behind a ModelServer with a {1, 8} bucket ladder (AOT-warmed);
2. fires >= 200 closed-loop HTTP predict requests from worker threads
   while the driver hot-swaps to v2 and then rolls back to v1
   MID-TRAFFIC — asserts ZERO failed requests (the zero-downtime
   contract) and that responses flipped versions;
3. scrapes /metrics and asserts the bucket ledger shows every bucket's
   first run happened in warmup (`serving_bucket_compiles_total` summed ==
   `serving_warmup_runs_total` summed), i.e. each bucket compiled at most
   once per model generation and never on the request path (on the card
   a bucket's first run is where its kernels load);
4. probes admission control: a saturated queue must yield 429 and an
   already-expired deadline 504 — clean JSON errors, never a 500.

Exit code 0 on success, 1 on failure; prints a JSON summary either way.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

REQUESTS = 240
WORKERS = 6
BUCKETS = (1, 8)


def _post(url, body, timeout=60):
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    r = urllib.request.urlopen(req, timeout=timeout)
    return r.status, json.loads(r.read())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device of the servables (default cuda; "
                        "raises without it)")
    args = p.parse_args(argv)

    from deeplearning4j_tpu_torch.models.zoo import LeNet
    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
    from deeplearning4j_tpu_torch.util.platform import (
        resolve_device, set_f32_matmul_exact,
    )
    from deeplearning4j_tpu_torch.util.serialization import save_model
    device = resolve_device(args.device)
    set_f32_matmul_exact()

    failures = []
    summary = {"device": str(device)}
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="serve_smoke_")
    v1_path = os.path.join(tmp, "lenet_v1.zip")
    v2_path = os.path.join(tmp, "lenet_v2.zip")
    # the checkpoints are written from the CPU: the zip is the same
    save_model(LeNet(seed=1).init(device="cpu"), v1_path)
    save_model(LeNet(seed=2).init(device="cpu"), v2_path)

    registry = ModelRegistry(device=device)
    t0 = time.perf_counter()
    served = registry.deploy("lenet", v1_path, buckets=BUCKETS,
                             max_delay_ms=3.0, queue_limit=64)
    summary["warmup_s"] = round(time.perf_counter() - t0, 2)
    server = ModelServer(registry, port=0, default_deadline_s=120.0)
    base = server.url
    predict_url = f"{base}/v1/models/lenet/predict"

    rs = np.random.RandomState(0)
    bodies = [json.dumps({"inputs": rs.rand(b, 28, 28, 1).astype(
        "float32").tolist()}).encode() for b in (1, 2, 4, 8)]

    codes = {}
    versions_seen = set()
    lock = threading.Lock()
    counter = iter(range(REQUESTS))

    def worker():
        while True:
            with lock:
                i = next(counter, None)
            if i is None:
                return
            try:
                code, out = _post(predict_url, bodies[i % len(bodies)])
                ver = out.get("version")
            except urllib.error.HTTPError as e:
                code, ver = e.code, None
                e.read()
            except Exception as e:  # noqa: BLE001
                code, ver = f"exc:{type(e).__name__}", None
            with lock:
                codes[code] = codes.get(code, 0) + 1
                if ver is not None:
                    versions_seen.add(ver)

    threads = [threading.Thread(target=worker, daemon=True,
                                name=f"smoke-worker-{w}")
               for w in range(WORKERS)]
    for t in threads:
        t.start()

    # mid-traffic: hot-swap to v2, then one-step rollback to v1 — both
    # warm off-path, so concurrent requests must all succeed
    time.sleep(0.5)
    scode, _ = _post(f"{base}/v1/models/lenet/swap",
                     json.dumps({"source": v2_path}).encode(), timeout=300)
    if scode != 200:
        failures.append(f"swap returned {scode}")
    time.sleep(0.5)
    rcode, _ = _post(f"{base}/v1/models/lenet/rollback", b"{}", timeout=300)
    if rcode != 200:
        failures.append(f"rollback returned {rcode}")
    for t in threads:
        t.join(timeout=600)

    summary["codes"] = {str(k): v for k, v in sorted(codes.items(),
                                                     key=lambda kv: str(kv))}
    summary["versions_seen"] = sorted(versions_seen)
    if codes.get(200, 0) != REQUESTS:
        failures.append(f"expected {REQUESTS} x 200 through swap+rollback, "
                        f"got {summary['codes']}")
    if 2 not in versions_seen:
        failures.append("no response ever reported v2 — swap not observed "
                        "under traffic")

    # ---- compile ledger: every compile was a warmup, never a request ----
    metrics = urllib.request.urlopen(f"{base}/metrics", timeout=10
                                     ).read().decode()
    def _total(prefix):
        tot = 0.0
        for line in metrics.splitlines():
            if line.startswith(prefix) and not line.startswith("# "):
                tot += float(line.rsplit(" ", 1)[1])
        return tot
    compiles = _total("serving_bucket_compiles_total")
    warmups = _total("serving_warmup_runs_total")
    summary["bucket_compiles"] = compiles
    summary["warmup_runs"] = warmups
    # 3 generations (deploy, swap, rollback) x len(BUCKETS) buckets
    if compiles != warmups or compiles != 3 * len(BUCKETS):
        failures.append(
            f"compile ledger: {compiles} compiles vs {warmups} warmup runs "
            f"(expected both == {3 * len(BUCKETS)}: every bucket compiled "
            "exactly once per generation, all in warmup)")
    for fam in ("serving_requests_total", "serving_request_seconds",
                "serving_batch_size", "serving_queue_depth"):
        if fam not in metrics:
            failures.append(f"/metrics missing {fam}")

    # ---- admission control: expired deadline -> 504, never a 500 --------
    try:
        _post(f"{predict_url}?deadline_ms=0.001", bodies[-1])
        failures.append("deadline_ms=0.001 did not fail")
    except urllib.error.HTTPError as e:
        e.read()
        summary["deadline_code"] = e.code
        if e.code != 504:
            failures.append(f"expired deadline returned {e.code}, want 504")

    # ---- admission control: saturated queue -> 429 ----------------------
    # stall the batcher worker with a slow runner, fill the queue past its
    # bound, and require an explicit 429 (bounded queue = backpressure)
    real_runner = served.batcher.runner
    served.batcher.runner = lambda x: (time.sleep(0.4), real_runner(x))[1]
    got_429 = 0
    try:
        def _stall():
            try:
                _post(predict_url, bodies[-1])
            except Exception:               # noqa: BLE001 — sacrificial
                pass                        # stall request; outcome unused

        stalled = [threading.Thread(target=_stall, daemon=True,
                                    name=f"smoke-stall-{s}")
                   for s in range(4)]
        for t in stalled:
            t.start()
        time.sleep(0.1)
        for _ in range(served.batcher._queue.maxsize + 8):
            try:
                served.batcher.predict(np.zeros((8, 28, 28, 1), "float32"),
                                       deadline=None, timeout=0.001)
            except Exception as e:  # noqa: BLE001
                if type(e).__name__ == "ServerOverloadedError":
                    got_429 += 1
        for t in stalled:
            t.join(timeout=60)
    finally:
        served.batcher.runner = real_runner
    summary["queue_full_rejections"] = got_429
    if got_429 == 0:
        failures.append("saturating the queue never raised overload (429)")

    server.drain(timeout=30)
    shutil.rmtree(tmp, ignore_errors=True)
    summary["wall_s"] = round(time.perf_counter() - t_start, 3)
    summary["ok"] = not failures
    summary["failures"] = failures
    print(json.dumps(summary, indent=1))
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
