#!/usr/bin/env python
"""One-shot converter: any RecordReader / DataSetIterator -> the
streaming shard format (data/shards.py), the port's counterpart of the
JAX package's `tools/make_shards.py` with the same flags and output.
Decode once at conversion time; every subsequent epoch reads whole
batches off memmapped shards with zero per-sample Python — the offline
half of the line-rate data plane.

Usage (pick ONE source):

    # images-from-directories (DataVec ImageRecordReader layout:
    # root/<label>/*.png) — decoded to raw uint8 HWC at convert time
    python -m deeplearning4j_tpu_torch.tools.make_shards \\
        --out /data/shards --image-dir /data/train \\
        --height 224 --width 224 --channels 3

    # numeric CSV with a label column
    python -m deeplearning4j_tpu_torch.tools.make_shards \\
        --out /data/shards --csv data.csv --label-index 4 --num-classes 3

    # escape hatch: any DataSetIterator from a factory
    python -m deeplearning4j_tpu_torch.tools.make_shards \\
        --out /data/shards --factory mypkg.mymod:make_iterator

Labels that arrive as exact one-hot float batches are stored as int32
class ids + num_classes in the index (4 bytes/record) and rehydrate
bitwise-identically; uint8 image payloads are stored raw so they also
ship raw over the host->device link at fit time (device-side affine
normalization). Prints a JSON summary; --verify re-reads the first
batch and checks bitwise parity against the source.

The conversion is host work only (numpy, the port's `data/records.py`
and `data/shards.py`): the tool touches no device and takes no
``--device``. The shard files are byte for byte the JAX tool's.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import numpy as np


def _build_source(args):
    from deeplearning4j_tpu_torch.data.records import (
        CSVRecordReader, ImageRecordReader, RecordReaderDataSetIterator,
    )
    if args.factory:
        mod, _, fn = args.factory.partition(":")
        if not fn:
            raise SystemExit("--factory must be module.path:callable")
        factory = getattr(importlib.import_module(mod), fn)
        return factory()
    if args.image_dir:
        rr = ImageRecordReader(args.height, args.width, args.channels,
                               shuffle=args.shuffle_seed is not None,
                               seed=args.shuffle_seed or 0)
        rr.initialize(args.image_dir)
        if args.shuffle_seed is None:
            print("make_shards: NOTE --image-dir keeps directory order "
                  "(all of class 0, then class 1, ...). Shard shuffling "
                  "at fit time is batch-granular, so class-grouped shards "
                  "yield single-class batches that train poorly — pass "
                  "--shuffle-seed N to mix records at conversion time.",
                  file=sys.stderr)
        return RecordReaderDataSetIterator(
            rr, batch_size=args.batch, label_index=-1,
            num_classes=rr.num_labels())
    if args.csv:
        rr = CSVRecordReader(args.csv, skip_lines=args.skip_lines)
        return RecordReaderDataSetIterator(
            rr, batch_size=args.batch, label_index=args.label_index,
            num_classes=args.num_classes, regression=args.regression)
    raise SystemExit("provide one of --image-dir / --csv / --factory")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True, help="output shard directory")
    p.add_argument("--image-dir", help="root/<label>/*.png image tree")
    p.add_argument("--height", type=int, default=224)
    p.add_argument("--width", type=int, default=224)
    p.add_argument("--channels", type=int, default=3)
    p.add_argument("--shuffle-seed", type=int, default=None,
                   help="permute image-record order at conversion time "
                        "(fit-time shard shuffling is batch-granular, so "
                        "record-level mixing must happen here)")
    p.add_argument("--csv", help="numeric CSV path")
    p.add_argument("--label-index", type=int, default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--regression", action="store_true")
    p.add_argument("--skip-lines", type=int, default=0)
    p.add_argument("--factory", metavar="MOD:FN",
                   help="module.path:callable returning a DataSetIterator")
    p.add_argument("--batch", type=int, default=256,
                   help="conversion read batch (not the training batch)")
    p.add_argument("--shard-records", type=int, default=4096)
    p.add_argument("--verify", action="store_true",
                   help="re-read the first batch and assert bitwise parity")
    args = p.parse_args(argv)

    # keep the conversion itself in-process and quiet: the one-shot pass
    # has no compute to overlap with (for the conversion only: a caller
    # in the same process gets its environment back)
    saved = {k: os.environ.get(k) for k in ("DL4J_CUDA_ETL_WORKERS",
                                            "DL4J_CUDA_FIT_PREFETCH")}
    for k in saved:
        os.environ.setdefault(k, "0")
    try:
        return _convert(args)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _convert(args) -> int:
    from deeplearning4j_tpu_torch.data.shards import (
        ShardDataSetIterator, write_shards,
    )
    source = _build_source(args)
    index = write_shards(source, args.out,
                         shard_records=args.shard_records)
    summary = {
        "out": args.out,
        "n_records": index["n_records"],
        "shards": len(index["shards"]),
        "features": index["features"],
        "labels": index["labels"],
        "num_classes": index["num_classes"],
        "bytes": sum(os.path.getsize(os.path.join(args.out, s["file"]))
                     for s in index["shards"]),
    }
    if args.verify and not hasattr(source, "reset"):
        # the conversion drained the source and it cannot be rewound —
        # re-reading the first batch would raise StopIteration AFTER a
        # successful conversion
        print("make_shards: --verify skipped — the source (plain "
              "generator from --factory?) is not resettable",
              file=sys.stderr)
        summary["verified"] = "skipped: source not resettable"
    elif args.verify:
        first_src = next(iter(source))
        b = int(np.asarray(first_src.features).shape[0])
        first_new = next(iter(ShardDataSetIterator(args.out, batch_size=b,
                                                   drop_last=False)))
        np.testing.assert_array_equal(np.asarray(first_src.features),
                                      np.asarray(first_new.features))
        if first_src.labels is not None:
            np.testing.assert_array_equal(np.asarray(first_src.labels),
                                          np.asarray(first_new.labels))
        summary["verified"] = True
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
