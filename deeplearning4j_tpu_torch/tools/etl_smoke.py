"""ETL smoke: round-trip a dataset through writer -> shards ->
multi-process shared-memory pipeline -> fit, asserting the data plane's
two contracts.

    python -m deeplearning4j_tpu_torch.tools.etl_smoke [--device cpu]
    python -m deeplearning4j_tpu_torch.tools.etl_smoke --shards DIR

The port's counterpart of the JAX package's `tools/etl_smoke.py`, with
the same assertions and summary keys; the fit runs on ``--device``
(CUDA by default; it raises without CUDA unless ``cpu`` is asked).

1. **Bitwise parity** — every batch delivered by the multi-process ring
   (data/pipeline.MultiProcessDataSetIterator + ShardBatchLoader) equals
   the in-process reader path (ShardDataSetIterator) bit for bit, and
   the shard round-trip itself is lossless (uint8 payloads + int-id ->
   one-hot label rehydration).
2. **Telemetry** — a fit() through the full default data plane (ring ->
   AsyncDataSetIterator double-buffered device prefetch) exports the
   `etl_*` metric families, including `etl_fetch_wait_seconds` (the
   consumer-side wait that diagnoses ETL-bound fits) and the per-worker
   `etl_worker_*` series with `worker` labels.

``--shards DIR`` reads an existing shard directory of uint8 images with
one-hot labels (one `make_shards` wrote) in place of the 600 seeded
12x12 images the smoke writes itself; the round-trip check then holds
every stored batch to raw uint8 payloads and exact one-hot labels.

Exit code 0 on success, 1 on failure; the LAST stdout line is a JSON
summary either way (the preceding lines are progress notes). The ring's
workers are spawned processes: a script that calls `run` needs an
``if __name__ == "__main__":`` guard.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import traceback

import numpy as np


def _fit_through_ring(td, batch, device, summary):
    """Parity of the ring against the in-process reader, then a fit
    through the ring; returns the network."""
    from deeplearning4j_tpu_torch.data.normalization import (
        ImagePreProcessingScaler,
    )
    from deeplearning4j_tpu_torch.data.pipeline import (
        MultiProcessDataSetIterator, ShardBatchLoader,
    )
    from deeplearning4j_tpu_torch.data.shards import ShardDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    # ---- in-process reader path (the parity reference)
    ref = list(ShardDataSetIterator(td, batch_size=batch, shuffle=True,
                                    seed=11))
    with MultiProcessDataSetIterator(
            ShardBatchLoader(td, batch, shuffle=True, seed=11),
            num_workers=2, name="etl-smoke") as pipe:
        parity = 0
        for got, want in zip(pipe, ref):
            np.testing.assert_array_equal(got.features, want.features)
            np.testing.assert_array_equal(got.labels, want.labels)
            assert got.features.dtype == np.uint8
            parity += 1
        assert parity == len(ref) > 0
        summary["parity_batches"] = parity
        print(f"etl_smoke: {parity} batches bitwise-identical "
              f"(ring vs in-process)")

        # ---- fit through the FULL default data plane: ring -> async
        # double-buffered device prefetch -> device-affine normalization
        # (uint8 over the wire)
        pipe.reset()
        pipe.set_pre_processor(ImagePreProcessingScaler())
        h, w, c = ref[0].features.shape[1:]
        classes = ref[0].labels.shape[1]
        conf = (NeuralNetConfiguration.Builder().seed(0)
                .updater(Adam(1e-2)).list()
                .layer(DenseLayer(n_out=16, activation="relu"))
                .layer(OutputLayer(n_out=classes, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())
        net = MultiLayerNetwork(conf, device=device).init()
        t0 = time.perf_counter()
        net.fit(pipe, epochs=2)
        summary["fit_s"] = round(time.perf_counter() - t0, 3)
        assert np.isfinite(net.score()), net.score()
        summary["fit_score"] = float(net.score())
        summary["fit_iterations"] = net.iteration_count
    return net


def run(device="cuda", shards=None) -> dict:
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.data.shards import (
        ShardDataSetIterator, write_shards,
    )
    from deeplearning4j_tpu_torch.util.platform import (
        resolve_device, set_f32_matmul_exact,
    )
    device = resolve_device(device)
    set_f32_matmul_exact()

    summary = {"ok": False, "device": str(device)}
    batch = 50
    if shards is not None:
        # the stored payloads are raw uint8 and the labels rehydrate to
        # exact one-hot rows
        flat = list(ShardDataSetIterator(shards, batch_size=batch))
        for d in flat:
            assert d.features.dtype == np.uint8, d.features.dtype
            assert ((d.labels == 0) | (d.labels == 1)).all() \
                and (d.labels.sum(axis=1) == 1).all()
        summary["records"] = sum(len(d.features) for d in flat)
        print(f"etl_smoke: reading {summary['records']} records from "
              f"{shards}")
        _fit_through_ring(shards, batch, device, summary)
    else:
        rs = np.random.RandomState(0)
        n, h, w, c, classes = 600, 12, 12, 1, 10
        X = rs.randint(0, 256, (n, h, w, c), dtype=np.uint8)
        Y = np.eye(classes, dtype="float32")[rs.randint(0, classes, n)]
        with tempfile.TemporaryDirectory() as td:
            # ---- writer -> shards
            index = write_shards(
                ArrayDataSetIterator(X, Y, batch_size=100, drop_last=False),
                td, shard_records=128)
            assert index["n_records"] == n, index
            assert index["num_classes"] == classes
            print(f"etl_smoke: wrote {len(index['shards'])} shards, "
                  f"{n} records")
            # shard round-trip is lossless vs the source arrays
            flat_order = list(ShardDataSetIterator(td, batch_size=batch))
            np.testing.assert_array_equal(flat_order[0].features,
                                          X[:batch])
            np.testing.assert_array_equal(flat_order[0].labels, Y[:batch])
            _fit_through_ring(td, batch, device, summary)

    # ---- telemetry contract
    text = monitor.prometheus_text()
    for family in ("etl_fetch_wait_seconds", "etl_queue_depth",
                   "etl_batches_prefetched_total",
                   "etl_worker_batches_total", "etl_worker_decode_seconds",
                   "etl_ring_ready_depth"):
        assert family in text, f"metric family {family} not exported"
    assert 'worker="0"' in text or 'worker="1"' in text, \
        "per-worker ETL labels missing"
    wait = monitor.histogram("etl_fetch_wait_seconds").snapshot()
    summary["etl_fetch_wait_exported"] = True
    summary["etl_fetch_wait_count"] = int(wait.get("count", 0))
    summary["etl_fetch_wait_mean_s"] = round(
        wait["sum"] / wait["count"], 6) if wait.get("count") else 0.0
    summary["metric_families"] = sum(
        1 for line in text.splitlines() if line.startswith("# TYPE"))
    summary["ok"] = True
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device of the fit (default cuda; raises "
                        "without it)")
    p.add_argument("--shards", default=None, metavar="DIR",
                   help="read this shard directory instead of writing "
                        "the seeded one")
    args = p.parse_args(argv)
    try:
        summary = run(args.device, args.shards)
    except BaseException:
        traceback.print_exc()
        print(json.dumps({"ok": False}))
        return 1
    print(json.dumps(summary))
    return 0 if summary.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
