"""Streaming sharded record format: the disk half of the data plane.

A copy of the JAX package's `data/shards.py` (numpy and the standard
library only, no torch), under the port's names. The format is the
reference's byte for byte, so a shard directory written by either
package is read by the other.

A per-sample Python loop over record readers cannot feed a training step
at thousands of images a second. This module stores already-decoded
fixed-shape records in fixed-size binary shards, so a whole batch is ONE
contiguous memmap slice: zero per-sample Python between the disk and
the host-to-device copy. Pixels stay uint8 on disk and over the link;
the normalizer's affine runs on the device
(`data/normalization.engaged_device_affine`).

Shard file layout (self-describing; ``MAGIC`` fences both ends):

    [8B  magic "DL4JSHD1"]
    [features block: n_records x feature_record_bytes, C order]
    [labels  block:  n_records x label_record_bytes]    (absent if unlabeled)
    [footer: JSON schema {records, features{dtype,shape}, labels, offsets}]
    [8B  little-endian uint64: footer length]
    [8B  magic "DL4JSHD1"]

Blocked (not interleaved) layout is what makes a batch read two
contiguous slices instead of a strided gather. A directory of shards
carries an ``index.json`` with the global schema, per-shard record
counts, and the optional ``num_classes`` that lets integer class labels
rehydrate to the exact one-hot float32 batches the in-process reader
path produces.

Producers: ``ShardWriter`` (record/batch appends), ``write_shards``
(drain any DataSetIterator). Consumer: ``ShardDataSetIterator``: batched
reads, deterministic per-epoch batch shuffling, and
``seek``/``tell``/``stream_state`` for exact-offset resume.
"""
from __future__ import annotations

import json
import logging
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger("deeplearning4j_tpu_torch")

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import DataSetIterator

MAGIC = b"DL4JSHD1"
INDEX_NAME = "index.json"
_TAIL = struct.calcsize("<Q") + len(MAGIC)


def _schema(arr: np.ndarray) -> dict:
    return {"dtype": np.dtype(arr.dtype).str, "shape": list(arr.shape)}


def _schema_matches(schema: dict, arr: np.ndarray) -> bool:
    return (np.dtype(schema["dtype"]) == arr.dtype
            and tuple(schema["shape"]) == tuple(arr.shape))


def _record_bytes(schema: dict) -> int:
    return int(np.dtype(schema["dtype"]).itemsize
               * int(np.prod(schema["shape"], dtype=np.int64)))


class ShardWriter:
    """Append fixed-shape records into fixed-size shard files + index.

    Every record must share the first record's feature (and label)
    dtype/shape — that invariant is what buys whole-batch reads. Use as
    a context manager or call ``close()``; the index is written last so
    a crashed conversion never leaves a readable-but-truncated dataset.
    """

    def __init__(self, out_dir: str, shard_records: int = 4096,
                 prefix: str = "shard"):
        if shard_records <= 0:
            raise ValueError("shard_records must be positive")
        self.out_dir = out_dir
        self.shard_records = int(shard_records)
        self.prefix = prefix
        os.makedirs(out_dir, exist_ok=True)
        self._feat_schema: Optional[dict] = None
        self._label_schema: Optional[dict] = None
        self._feat_buf: Optional[np.ndarray] = None
        self._label_buf: Optional[np.ndarray] = None
        self._fill = 0                  # records buffered, not yet flushed
        self._shards: List[dict] = []
        self._n_records = 0
        self.num_classes: Optional[int] = None   # advisory, lands in index
        self._closed = False
        self._final_index: Optional[dict] = None    # what close() wrote

    # ------------------------------------------------------------- appends
    def _init_schema(self, features: np.ndarray,
                     labels: Optional[np.ndarray]):
        self._feat_schema = _schema(features)
        self._feat_buf = np.empty((self.shard_records, *features.shape),
                                  features.dtype)
        if labels is not None:
            self._label_schema = _schema(labels)
            self._label_buf = np.empty((self.shard_records, *labels.shape),
                                       labels.dtype)

    def _check_open(self):
        # a record accepted here could never be flushed — fail loudly
        # instead of silently drifting from the index.json on disk
        if self._closed:
            raise RuntimeError("ShardWriter is closed — records can no "
                               "longer be added")

    def add(self, features, label=None):
        """Append ONE record (feature array + optional per-record label)."""
        self._check_open()
        features = np.asarray(features)
        label = None if label is None else np.asarray(label)
        if self._feat_schema is None:
            self._init_schema(features, label)
        if not _schema_matches(self._feat_schema, features):
            raise ValueError(
                f"record schema mismatch: expected {self._feat_schema}, "
                f"got dtype={features.dtype} shape={features.shape}")
        if (label is None) != (self._label_schema is None):
            raise ValueError("labeled and unlabeled records cannot mix")
        if label is not None and not _schema_matches(self._label_schema,
                                                     label):
            raise ValueError(
                f"label schema mismatch: expected {self._label_schema}, "
                f"got dtype={label.dtype} shape={label.shape}")
        self._feat_buf[self._fill] = features
        if label is not None:
            self._label_buf[self._fill] = label
        self._fill += 1
        self._n_records += 1
        if self._fill == self.shard_records:
            self._flush()

    def add_batch(self, features, labels=None):
        """Append a (B, ...) batch of records: ONE schema check and
        block copies into the shard buffer (no per-record Python — the
        epoch-scale conversion path)."""
        self._check_open()
        features = np.asarray(features)
        labels = None if labels is None else np.asarray(labels)
        b = features.shape[0]
        if b == 0:
            return
        if self._feat_schema is None:
            self._init_schema(features[0],
                              None if labels is None else labels[0])
        if not _schema_matches(self._feat_schema, features[0]):
            raise ValueError(
                f"record schema mismatch: expected {self._feat_schema}, "
                f"got dtype={features.dtype} shape={features.shape[1:]}")
        if (labels is None) != (self._label_schema is None):
            raise ValueError("labeled and unlabeled records cannot mix")
        if labels is not None and not _schema_matches(self._label_schema,
                                                      labels[0]):
            raise ValueError(
                f"label schema mismatch: expected {self._label_schema}, "
                f"got dtype={labels.dtype} shape={labels.shape[1:]}")
        i = 0
        while i < b:
            take = min(b - i, self.shard_records - self._fill)
            self._feat_buf[self._fill:self._fill + take] = \
                features[i:i + take]
            if labels is not None:
                self._label_buf[self._fill:self._fill + take] = \
                    labels[i:i + take]
            self._fill += take
            self._n_records += take
            i += take
            if self._fill == self.shard_records:
                self._flush()

    # --------------------------------------------------------------- flush
    def _flush(self):
        if self._fill == 0:
            return
        n = self._fill
        fname = f"{self.prefix}-{len(self._shards):05d}.shard"
        path = os.path.join(self.out_dir, fname)
        feat_block = np.ascontiguousarray(self._feat_buf[:n])
        footer = {
            "records": n,
            "features": self._feat_schema,
            "features_offset": len(MAGIC),
            "labels": self._label_schema,
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            # memoryview writes, not tobytes(): a shard block can be GBs
            # and tobytes() would materialize a full in-memory duplicate
            f.write(feat_block.data)
            if self._label_schema is not None:
                footer["labels_offset"] = (
                    len(MAGIC) + n * _record_bytes(self._feat_schema))
                f.write(np.ascontiguousarray(self._label_buf[:n]).data)
            blob = json.dumps(footer).encode()
            f.write(blob)
            f.write(struct.pack("<Q", len(blob)))
            f.write(MAGIC)
        os.replace(tmp, path)
        self._shards.append({"file": fname, "records": n})
        self._fill = 0

    def close(self) -> dict:
        """Flush the tail shard and write index.json; returns the index
        actually on disk. Idempotent after a successful close; raises if
        the writer was aborted (``__exit__`` on an exception), because
        then no index.json exists and the partial shards are unreadable."""
        if self._closed:
            if self._final_index is None:
                raise RuntimeError(
                    "ShardWriter was aborted by an exception before the "
                    "index was written — the partial dataset is "
                    "unreadable; rerun the conversion")
            return self._final_index
        self._flush()
        index = self._index()
        tmp = os.path.join(self.out_dir, INDEX_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(index, f, indent=1)
        os.replace(tmp, os.path.join(self.out_dir, INDEX_NAME))
        self._closed = True
        self._final_index = index
        return index

    def _index(self) -> dict:
        return {
            "version": 1,
            "magic": MAGIC.decode(),
            "n_records": self._n_records,
            "shard_records": self.shard_records,
            "features": self._feat_schema,
            "labels": self._label_schema,
            "num_classes": self.num_classes,
            "shards": self._shards,
        }

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            # a crashed conversion must NOT produce a readable dataset:
            # leave the partial shards index-less (ShardSet refuses a
            # directory without index.json) instead of silently
            # finalizing a truncated one
            self._closed = True
        return False


def read_footer(path: str) -> dict:
    """Parse one shard file's self-describing footer (magic-checked)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: bad shard magic (head)")
        f.seek(size - _TAIL)
        tail = f.read(_TAIL)
        (blob_len,) = struct.unpack("<Q", tail[:struct.calcsize("<Q")])
        if tail[struct.calcsize("<Q"):] != MAGIC:
            raise ValueError(f"{path}: bad shard magic (tail)")
        f.seek(size - _TAIL - blob_len)
        return json.loads(f.read(blob_len))


class ShardSet:
    """Index + lazily-memmapped shards with contiguous record-range reads.

    ``read(lo, hi)`` returns ``(features, labels_raw)`` for global records
    [lo, hi): a zero-copy memmap view when the range lives in one shard,
    a concatenation (one copy) when it crosses a boundary — at most one
    boundary per shard, so the amortized cost is ~0. Shared by the
    in-process ShardDataSetIterator and the multi-process
    ShardBatchLoader so the two paths cannot drift (their streams are
    bitwise equal)."""

    def __init__(self, shard_dir: str):
        self.dir = shard_dir
        idx_path = os.path.join(shard_dir, INDEX_NAME)
        try:
            with open(idx_path) as f:
                self.index = json.load(f)
        except OSError as e:
            raise FileNotFoundError(
                f"{idx_path} not found — not a shard dataset directory "
                f"(write one with ShardWriter or write_shards)"
            ) from e
        self.n_records = int(self.index["n_records"])
        self.feat_schema = self.index["features"]
        self.label_schema = self.index.get("labels")
        self.num_classes = self.index.get("num_classes")
        counts = [int(s["records"]) for s in self.index["shards"]]
        self._starts = np.concatenate([[0], np.cumsum(counts)])
        self._maps: dict = {}

    def _open(self, si: int):
        cached = self._maps.get(si)
        if cached is not None:
            return cached
        meta = self.index["shards"][si]
        path = os.path.join(self.dir, meta["file"])
        n = int(meta["records"])
        fdt = np.dtype(self.feat_schema["dtype"])
        fshape = tuple(self.feat_schema["shape"])
        feats = np.memmap(path, dtype=fdt, mode="r", offset=len(MAGIC),
                          shape=(n, *fshape))
        labels = None
        if self.label_schema is not None:
            ldt = np.dtype(self.label_schema["dtype"])
            lshape = tuple(self.label_schema["shape"])
            loff = len(MAGIC) + n * _record_bytes(self.feat_schema)
            labels = np.memmap(path, dtype=ldt, mode="r", offset=loff,
                               shape=(n, *lshape))
        self._maps[si] = (feats, labels)
        return self._maps[si]

    def locate(self, record: int) -> Tuple[int, int]:
        """Global record index -> (shard index, offset within shard)."""
        si = int(np.searchsorted(self._starts, record, side="right")) - 1
        si = min(max(si, 0), len(self.index["shards"]) - 1)
        return si, record - int(self._starts[si])

    def shard_file(self, si: int) -> str:
        return self.index["shards"][si]["file"]

    def read(self, lo: int, hi: int):
        if not (0 <= lo <= hi <= self.n_records):
            raise IndexError(f"record range [{lo}, {hi}) outside "
                             f"[0, {self.n_records})")
        parts_f, parts_l = [], []
        rec = lo
        while rec < hi:
            si, ofs = self.locate(rec)
            feats, labels = self._open(si)
            take = min(hi - rec, feats.shape[0] - ofs)
            parts_f.append(feats[ofs:ofs + take])
            if labels is not None:
                parts_l.append(labels[ofs:ofs + take])
            rec += take
        f = parts_f[0] if len(parts_f) == 1 else np.concatenate(parts_f)
        if self.label_schema is None:
            return f, None
        l = parts_l[0] if len(parts_l) == 1 else np.concatenate(parts_l)
        return f, l


def one_hot_labels(raw: np.ndarray, num_classes: int) -> np.ndarray:
    """int class ids -> exact {0.0, 1.0} float32 one-hot, bitwise
    identical to RecordReaderDataSetIterator's np.eye construction, so
    shard-rehydrated labels match the in-process reader path. Built by
    scatter: np.eye indexing materializes a (C, C) matrix per batch,
    which at large-vocabulary num_classes is O(C^2) time and memory on
    the hot decode path."""
    ids = np.asarray(raw).astype(int).reshape(-1)
    out = np.zeros((ids.shape[0], int(num_classes)), dtype="float32")
    out[np.arange(ids.shape[0]), ids] = 1.0
    return out


def decode_labels(raw, num_classes: Optional[int]):
    """Shared label rehydration rule (in-process iterator AND the
    multi-process ShardBatchLoader): scalar integer labels one-hot to
    num_classes when known; everything else passes through as stored."""
    if raw is None:
        return None
    if (num_classes and np.issubdtype(raw.dtype, np.integer)
            and raw.ndim == 1):
        return one_hot_labels(raw, num_classes)
    return raw


def epoch_order(n_batches: int, shuffle: bool, seed: int,
                epoch: int) -> np.ndarray:
    """Deterministic per-epoch batch order — ONE definition shared by the
    in-process iterator and the multi-process loader so a resumed or
    parallelized stream sees the identical sequence. Batch-granular (not
    record-granular) shuffling keeps every read a contiguous slice; for
    record-level mixing, shuffle at shard-write time."""
    idx = np.arange(n_batches)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(idx)
    return idx


def epoch_batches(n_records: int, batch_size: int, drop_last: bool) -> int:
    """The one epoch batch-count rule the in-process iterator and the
    multi-process ShardBatchLoader must agree on (parity-critical): drop
    the ragged tail only when at least one full batch exists."""
    if drop_last and n_records >= batch_size:
        return n_records // batch_size
    return (n_records + batch_size - 1) // batch_size


class EpochPositionMixin:
    """The ONE implementation of epoch/position semantics every batched
    stream shares (ShardDataSetIterator and the multi-process ring —
    resume parity depends on these never drifting apart): ``seek(k)``
    positions the NEXT ``__iter__`` at batch k of the current epoch and
    pins that pass to the epoch's remainder even when it is empty
    (exact-end resume must not skip ahead); ``tell()`` reports batches
    served this epoch; ``reset()`` advances to the next epoch's order; a
    pass that exhausted the epoch replays the NEXT epoch on re-iteration
    (like every other DataSetIterator) while a partially-consumed one
    resumes at its position. Subclasses set ``n_batches``, call
    ``_init_position()`` in ``__init__``, ``_begin_pass()`` at the top
    of ``__iter__``, and advance ``self._pos`` per yielded batch."""

    supports_seek = True

    def _init_position(self):
        self._epoch = 0
        self._pos = 0               # next batch ordinal within the epoch
        self._sought = False

    def reset(self):
        self._epoch += 1
        self._pos = 0
        self._sought = False

    def tell(self) -> int:
        """Batches already served in the current epoch."""
        return self._pos

    def seek(self, batch_idx: int):
        """Position the next ``__iter__`` at batch ``batch_idx`` of the
        current epoch (0 <= batch_idx <= n_batches)."""
        if not 0 <= batch_idx <= self.n_batches:
            raise IndexError(f"seek({batch_idx}) outside "
                             f"[0, {self.n_batches}]")
        self._pos = int(batch_idx)
        self._sought = True     # next __iter__ serves the remainder of
        return self             # THIS epoch, even if it is empty

    def _begin_pass(self):
        """Apply the re-``__iter__`` rule (class docstring): exhausted
        epoch auto-advances unless a seek() pinned this pass."""
        if self.n_batches and self._pos >= self.n_batches \
                and not self._sought:
            self.reset()
        self._sought = False


class ShardDataSetIterator(EpochPositionMixin, DataSetIterator):
    """Batched DataSet stream over a shard directory — whole batches with
    zero per-sample Python (one memmap slice per block), deterministic
    per-epoch shuffling, and exact-position resume.

    Position surface (`seek`/`tell`, EpochPositionMixin) plus
    ``stream_state``, which names the exact shard file/offset the next
    batch starts at: a checkpoint stores it and a resume seeks to it
    instead of replaying the stream prefix.

    uint8 features are yielded RAW (the device-norm seam ships them
    over the link as-is); attach the normalizer with
    ``set_pre_processor`` exactly as with any other iterator."""

    def __init__(self, shard_dir: str, batch_size: int,
                 num_classes: Optional[int] = None, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True):
        self._set = ShardSet(shard_dir)
        self._batch = int(batch_size)
        self.num_classes = num_classes if num_classes is not None \
            else self._set.num_classes
        self._shuffle = shuffle
        self._seed = int(seed)
        self._drop_last = drop_last
        self._init_position()
        self.batches_read = 0       # lifetime reads (resume-test witness)
        self.n_batches = epoch_batches(self._set.n_records, self._batch,
                                       drop_last)

    # ------------------------------------------------------------ contract
    def batch_size(self):
        return self._batch

    @property
    def num_records(self) -> int:
        return self._set.n_records

    def stream_state(self) -> dict:
        """The exact stream position the next batch starts at — shard
        file + record offset within it, for exact-offset resume."""
        if not self._set.n_records:     # empty set: nothing to locate
            return {"epoch": self._epoch, "next_batch": 0,
                    "record_offset": 0, "shard_file": None,
                    "offset_in_shard": 0}
        order = epoch_order(self.n_batches, self._shuffle, self._seed,
                            self._epoch)
        if self._pos >= self.n_batches:
            rec = self._set.n_records
        else:
            rec = int(order[self._pos]) * self._batch
        si, ofs = self._set.locate(min(rec, self._set.n_records - 1))
        return {"epoch": self._epoch, "next_batch": self._pos,
                "record_offset": rec,
                "shard_file": self._set.shard_file(si),
                "offset_in_shard": ofs if rec < self._set.n_records
                else int(self._set.index["shards"][si]["records"])}

    # ------------------------------------------------------------- stream
    def _read_batch(self, bi: int) -> DataSet:
        lo = bi * self._batch
        hi = min(lo + self._batch, self._set.n_records)
        feats, raw = self._set.read(lo, hi)
        self.batches_read += 1
        return DataSet(feats, decode_labels(raw, self.num_classes))

    def __iter__(self):
        self._begin_pass()
        order = epoch_order(self.n_batches, self._shuffle, self._seed,
                            self._epoch)
        while self._pos < self.n_batches:
            bi = int(order[self._pos])
            self._pos += 1
            yield self._pp(self._read_batch(bi))


# ----------------------------------------------------------------- converter
def _as_int_labels(labels: np.ndarray) -> Optional[np.ndarray]:
    """(B, C) EXACT one-hot float32 batches -> int32 class ids, or None
    when the labels are not losslessly one-hot (then they are stored
    as-is). Exactness is the bitwise-parity guarantee: rehydration
    (decode_labels/one_hot_labels) emits float32, so any other float
    width must be stored verbatim or the round-trip would silently
    change dtype."""
    if labels.ndim != 2 or labels.dtype != np.float32:
        return None
    is01 = np.all((labels == 0.0) | (labels == 1.0))
    if not is01 or not np.all(labels.sum(axis=1) == 1.0):
        return None
    return labels.argmax(axis=1).astype(np.int32)


def write_shards(source, out_dir: str, shard_records: int = 4096,
                 prefix: str = "shard", compact_labels: bool = True) -> dict:
    """Drain any DataSetIterator / iterable of DataSet into a shard
    directory (the converter core). Exact one-hot
    float label batches are stored as int32 class ids + ``num_classes``
    (4 bytes/record instead of 4*C) and rehydrate bitwise-identically;
    anything else is stored verbatim. Returns the written index."""
    if getattr(source, "pre_processor", None) is not None:
        log.warning(
            "write_shards: the source iterator has a pre_processor "
            "attached — its transform is being BAKED INTO the stored "
            "payloads (float over the wire, and a consumer that attaches "
            "the same normalizer will normalize twice). Convert from a "
            "raw iterator and attach the normalizer at fit time instead.")
    writer = ShardWriter(out_dir, shard_records=shard_records,
                         prefix=prefix)
    num_classes = None
    compact = None      # locked by the first labeled batch: the shard
    with writer:        # label schema cannot change mid-stream
        for ds in source:
            feats = np.asarray(ds.features)
            labels = None if ds.labels is None else np.asarray(ds.labels)
            if ds.features_mask is not None or ds.labels_mask is not None:
                raise ValueError(
                    "masked (variable-length) batches are not supported by "
                    "the fixed-shape shard format — pad to a fixed length "
                    "before conversion")
            # the one-hot scan is dead work once compaction locked off
            ints = _as_int_labels(labels) if (
                compact_labels and labels is not None
                and compact is not False) else None
            if labels is not None and compact is None:
                compact = ints is not None
            if compact:
                if ints is None:
                    raise ValueError(
                        "write_shards: earlier label batches were exact "
                        "one-hot and were compacted to int32 class ids, but "
                        "a later batch is not losslessly one-hot (soft or "
                        "smoothed labels?) — rerun with compact_labels=False "
                        "to store all labels verbatim")
                if num_classes is None:
                    num_classes = labels.shape[1]
                    writer.num_classes = int(num_classes)
                elif num_classes != labels.shape[1]:
                    raise ValueError("inconsistent one-hot width across "
                                     "batches")
                writer.add_batch(feats, ints)
            else:
                writer.add_batch(feats, labels)
    if hasattr(source, "reset"):
        source.reset()
    return writer._index()
