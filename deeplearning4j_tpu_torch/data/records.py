"""Record readers and the record-reader -> DataSet bridge.

A copy of the JAX package's `data/records.py` (numpy and the standard
library; PIL is imported lazily, only to decode images), under the
port's names. Parity target: DataVec's record readers and the bridge
`RecordReaderDataSetIterator.java` (single-source classification and
regression), `SequenceRecordReaderDataSetIterator.java` (time series,
incl. separate feature/label sources and ALIGN_END padding+masks), and
`RecordReaderMultiDataSetIterator.java` (named multi-source wiring).

Host-side IO in numpy; the device only ever sees finished batches.

Numeric CSV is parsed by the port's native C++ library
(`native/src/csv.cpp`, strict: anything python's float() would read
differently sends the file back to the Python csv reader), as the
reference parses it with its own; without a toolchain the Python reader
runs, the reference's path when its library is unavailable.
"""
from __future__ import annotations

import csv
import logging
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterator import DataSetIterator
from deeplearning4j_tpu_torch.util.env import env_int

log = logging.getLogger("deeplearning4j_tpu_torch")

_warned_raw_uint8 = False


def _maybe_warn_raw_uint8(it, ds):
    """One-time guard against the silent 0-255 scale regression: raw uint8
    image batches consumed with NO normalizer attached train on unscaled
    pixels (4x-off inputs, degraded convergence) with no other runtime
    signal. Skipped while a device-affine pre-processor is engaged — it is
    detached from the iterator during such fits but normalization still
    happens, on device (data/normalization.engaged_device_affine)."""
    global _warned_raw_uint8
    if (not _warned_raw_uint8
            and ds.features is not None
            and getattr(ds.features, "dtype", None) == np.uint8
            and it.pre_processor is None
            and not getattr(it, "_device_affine_active", False)):
        _warned_raw_uint8 = True
        log.warning(
            "uint8 image batches are being consumed with no pre_processor "
            "attached: the model sees raw 0-255 pixels. Attach "
            "ImagePreProcessingScaler (set_pre_processor) or construct "
            "ImageRecordReader(normalize=True) for float [0,1] batches. "
            "(warned once)")
    return ds


# -------------------------------------------------------------- record readers
class RecordReader:
    """One record = one list of values (DataVec RecordReader contract)."""

    def records(self) -> Iterator[List]:
        raise NotImplementedError

    def reset(self):
        pass


class CollectionRecordReader(RecordReader):
    """In-memory records (DataVec CollectionRecordReader)."""

    def __init__(self, rows: Sequence[Sequence]):
        self.rows = rows

    def records(self):
        return iter(self.rows)


class CSVRecordReader(RecordReader):
    """CSV lines -> float/str records (DataVec CSVRecordReader).

    `to_matrix()` is the strict numeric fast path (one parse into a
    float32 matrix), used by RecordReaderDataSetIterator; when it yields
    None (no native parser, or a file the strict parser rejects)
    consumers take the python csv path."""

    def __init__(self, path: str, skip_lines: int = 0, delimiter: str = ",",
                 numeric: bool = True):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self.numeric = numeric

    def to_matrix(self):
        """float32 (rows, cols) matrix via the native parser, or None if
        the file is not strictly numeric / too large / no native parser.
        records() itself stays on the python csv module — its contract is
        float64 lists; the float32 fast path belongs to the consumers
        that produce float32 anyway (RecordReaderDataSetIterator)."""
        if not self.numeric:
            return None
        limit = env_int("DL4J_CUDA_CSV_FAST_MAX_BYTES", 1 << 30)
        try:
            stat = os.stat(self.path)
            if stat.st_size > limit:
                return None     # keep huge files on the streaming path
        except OSError:
            return None
        key = (stat.st_mtime_ns, stat.st_size)
        cached = getattr(self, "_matrix_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]    # multi-epoch fit: parse once
        mat = parse_numeric_csv(self.path, self.delimiter,
                                self.skip_lines)
        self._matrix_cache = (key, mat)
        return mat

    def records(self):
        with open(self.path, newline="") as f:
            reader = csv.reader(f, delimiter=self.delimiter)
            for i, row in enumerate(reader):
                if i < self.skip_lines or not row:
                    continue
                yield [float(v) for v in row] if self.numeric else row


def parse_numeric_csv(path: str, delimiter: str = ",",
                      skip_lines: int = 0):
    """Strict native numeric-CSV parse -> float32 matrix, or None when
    the native library is unavailable or the file fails strict parsing
    (the caller falls back to the python reader)."""
    import ctypes

    from deeplearning4j_tpu_torch import native
    if len(delimiter.encode()) != 1 or not native.available():
        return None
    lib = native.get_lib()
    with open(path, "rb") as f:
        data = f.read()
    delim = ctypes.c_char(delimiter.encode())
    ncols = ctypes.c_int64(0)
    rows = lib.csv_parse_f32(data, len(data), delim, skip_lines, None, 0,
                             ctypes.byref(ncols))
    if rows < 0:
        return None
    out = np.empty((rows, ncols.value), np.float32)
    filled = lib.csv_parse_f32(
        data, len(data), delim, skip_lines,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows,
        ctypes.byref(ncols))
    if filled != rows:
        return None
    return out


class SequenceRecordReader:
    """One sequence = list of timestep records (DataVec SequenceRecordReader)."""

    def sequences(self) -> Iterator[List[List]]:
        raise NotImplementedError

    def reset(self):
        pass


class CollectionSequenceRecordReader(SequenceRecordReader):
    def __init__(self, seqs: Sequence[Sequence[Sequence]]):
        self.seqs = seqs

    def sequences(self):
        return iter(self.seqs)


class CSVSequenceRecordReader(SequenceRecordReader):
    """One CSV file per sequence (DataVec CSVSequenceRecordReader)."""

    def __init__(self, paths: Sequence[str], skip_lines: int = 0,
                 delimiter: str = ","):
        self.paths = list(paths)
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def sequences(self):
        for p in self.paths:
            rr = CSVRecordReader(p, self.skip_lines, self.delimiter)
            yield [row for row in rr.records()]


# ------------------------------------------------------------------- bridges
class RecordReaderDataSetIterator(DataSetIterator):
    """records -> DataSet batches (RecordReaderDataSetIterator.java).

    label_index: column holding the class index (classification, one-hot
    encoded to num_classes) — or with regression=True, label columns
    [label_index, label_index_to] stay as float targets, exactly the
    reference's two constructor families."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index_to: Optional[int] = None):
        self.reader = reader
        self._batch = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.label_index_to = label_index_to if label_index_to is not None \
            else label_index
        self._mp_pipe = None    # lazy multi-process image pipeline

    def batch_size(self):
        return self._batch

    def reset(self):
        self.reader.reset()
        if self._mp_pipe:               # False = disabled after failure
            self._mp_pipe.reset()

    def __iter__(self):
        # every batch flows through the attached pre-processor (the
        # setPreProcessor contract every DataSetIterator honors —
        # device-norm fit detaches it and normalizes on device instead)
        return (self._pp(_maybe_warn_raw_uint8(self, ds))
                for ds in self._iter_raw())

    def _iter_raw(self):
        if getattr(self.reader, "is_image", False):
            yield from self._iter_image_batches()
            return
        # native fast path: numeric CSV parsed once into a float32 matrix
        # (identical batches — _to_dataset produces float32 regardless)
        mat = getattr(self.reader, "to_matrix", lambda: None)()
        if mat is not None:
            for i in range(0, len(mat), self._batch):
                yield self._to_dataset(mat[i:i + self._batch])
            return
        buf = []
        for rec in self.reader.records():
            buf.append(rec)
            if len(buf) == self._batch:
                yield self._to_dataset(buf)
                buf = []
        if buf:
            yield self._to_dataset(buf)

    def _image_pipeline(self):
        """The multi-process hot image path (data/pipeline.py): for
        file-backed image readers on datasets big enough to amortize
        worker startup (etl_workers' auto rule, DL4J_CUDA_ETL_WORKERS
        overrides / =0 disables), decode happens in N worker processes
        filling shared-memory ring slots: the per-sample PIL loop
        leaves the training process entirely. Batch output is
        bitwise-identical to the in-process path (same load_image +
        one-hot rules)."""
        reader = self.reader
        files = getattr(reader, "_files", None)
        if self._mp_pipe is False:      # earlier startup failure: stay
            return None                 # on the in-process path
        if not files or getattr(reader, "normalize", None) is None:
            return None
        if self.label_index is not None and not self.regression \
                and self.num_classes is None:
            return None     # let the in-process path raise its error
        from deeplearning4j_tpu_torch.data.pipeline import etl_workers
        workers = etl_workers(len(files))
        if workers <= 0:
            return None
        if self._mp_pipe is None:
            from deeplearning4j_tpu_torch.data.pipeline import (
                ImageFileBatchLoader, MultiProcessDataSetIterator,
            )
            labeled = self.label_index is not None
            loader = ImageFileBatchLoader(
                files, reader.height, reader.width, reader.channels,
                self._batch,
                num_classes=self.num_classes
                if labeled and not self.regression else None,
                regression=labeled and self.regression,
                normalize=reader.normalize)
            self._mp_pipe = MultiProcessDataSetIterator(
                loader, num_workers=workers, name="image-etl")
        return self._mp_pipe

    def _iter_image_batches(self):
        pipe = self._image_pipeline()
        if pipe is not None:
            # the delegated ring is constructed copy=True: every yielded
            # batch is owned, so stacking fits need no special handling.
            # seek(0) pins each pass to a full epoch from the first file —
            # the ring's own resume-at-position semantics would otherwise
            # silently drop the already-served prefix after an abandoned
            # pass, where the in-process decode loop below restarts.
            pipe.seek(0)
            it = iter(pipe)
            try:
                first = next(it)
            except StopIteration:
                return
            except RuntimeError as e:
                # worker startup failed (most often: an unguarded user
                # script under the 'spawn' start method) — degrade to
                # the in-process decode loop instead of failing the fit
                log.warning("multi-process image ETL unavailable, "
                            "falling back to in-process decode: %s", e)
                try:
                    pipe.close()
                except Exception:
                    pass
                self._mp_pipe = False
            else:
                yield first
                yield from it
                return
        buf, labels, fill = None, [], 0
        for img, lab in self.reader.records():
            img = np.asarray(img)
            if buf is None:
                # preallocate ONE (B, H, W, C) batch and fill in place —
                # np.stack over a B-long Python list allocates B+1 arrays
                # per batch (measurable allocator churn at b128). A fresh
                # buffer per batch: the yielded DataSet escapes into the
                # prefetch queue and must not be overwritten.
                buf = np.empty((self._batch, *img.shape), img.dtype)
            buf[fill] = img
            labels.append(lab)
            fill += 1
            if fill == self._batch:
                yield self._image_dataset(buf, labels)
                buf, labels, fill = None, [], 0
        if fill:
            yield self._image_dataset(buf[:fill], labels)

    def _image_dataset(self, feats, labels) -> DataSet:
        feats = np.asarray(feats)                       # (B, H, W, C)
        if feats.dtype not in (np.uint8, np.float32):
            # raw bytes stay raw (device norm); floats stay as-is
            feats = feats.astype("float32")
        if self.label_index is None:    # unlabeled, as the tabular path
            return DataSet(feats)
        if self.regression:
            return DataSet(feats, np.asarray(labels, "float32")[:, None])
        if self.num_classes is None:
            raise ValueError("num_classes required for classification")
        from deeplearning4j_tpu_torch.data.shards import one_hot_labels
        return DataSet(feats,
                       one_hot_labels(np.asarray(labels, int),
                                      self.num_classes))

    def _to_dataset(self, rows) -> DataSet:
        arr = np.asarray(rows, "float32")
        if self.label_index is None:
            return DataSet(arr)
        lo, hi = self.label_index, self.label_index_to
        labels = arr[:, lo:hi + 1]
        feats = np.concatenate([arr[:, :lo], arr[:, hi + 1:]], axis=1)
        if not self.regression:
            if self.num_classes is None:
                raise ValueError("num_classes required for classification")
            labels = np.eye(self.num_classes,
                            dtype="float32")[labels[:, 0].astype(int)]
        return DataSet(feats, labels)


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """sequences -> padded+masked RNN batches
    (SequenceRecordReaderDataSetIterator.java, AlignmentMode.ALIGN_END).

    Single-reader mode: label column inside each timestep record.
    Dual-reader mode: separate feature and label sequence readers
    (the reference's (features, labels) constructor)."""

    def __init__(self, reader: SequenceRecordReader, batch_size: int,
                 num_classes: Optional[int], label_index: int = -1,
                 regression: bool = False,
                 labels_reader: Optional[SequenceRecordReader] = None,
                 align_end: bool = True):
        self.reader = reader
        self.labels_reader = labels_reader
        self._batch = batch_size
        self.num_classes = num_classes
        self.label_index = label_index
        self.regression = regression
        self.align_end = align_end

    def batch_size(self):
        return self._batch

    def reset(self):
        self.reader.reset()
        if self.labels_reader is not None:
            self.labels_reader.reset()

    def __iter__(self):
        # honor the setPreProcessor contract (see
        # RecordReaderDataSetIterator.__iter__)
        return (self._pp(ds) for ds in self._iter_raw())

    def _iter_raw(self):
        if self.labels_reader is None:
            seqs = ((s, None) for s in self.reader.sequences())
        else:
            seqs = zip(self.reader.sequences(),
                       self.labels_reader.sequences())
        buf = []
        for pair in seqs:
            buf.append(pair)
            if len(buf) == self._batch:
                yield self._to_dataset(buf)
                buf = []
        if buf:
            yield self._to_dataset(buf)

    def _to_dataset(self, pairs) -> DataSet:
        n = len(pairs)
        lens = [len(s) for s, _ in pairs]
        T = max(lens)
        feats_list, labs_list = [], []
        for seq, lab_seq in pairs:
            arr = np.asarray(seq, "float32")
            if lab_seq is not None:
                feats_list.append(arr)
                labs_list.append(np.asarray(lab_seq, "float32"))
            else:
                li = self.label_index if self.label_index >= 0 \
                    else arr.shape[1] - 1
                labs_list.append(arr[:, li:li + 1])
                feats_list.append(np.concatenate(
                    [arr[:, :li], arr[:, li + 1:]], axis=1))
        F = feats_list[0].shape[1]
        L = labs_list[0].shape[1]
        if not self.regression:
            if self.num_classes is None:
                raise ValueError("num_classes required for classification")
            L = self.num_classes
        x = np.zeros((n, T, F), "float32")
        y = np.zeros((n, T, L), "float32")
        mask = np.zeros((n, T), "float32")
        for i, (f, l) in enumerate(zip(feats_list, labs_list)):
            t = len(f)
            ofs = T - t if self.align_end else 0      # ALIGN_END pads front
            x[i, ofs:ofs + t] = f
            mask[i, ofs:ofs + t] = 1.0
            if self.regression:
                y[i, ofs:ofs + t] = l
            else:
                y[i, ofs:ofs + t] = np.eye(L, dtype="float32")[
                    l[:, 0].astype(int)]
        full = mask.all()
        return DataSet(x, y, None if full else mask, None if full else mask)


class RecordReaderMultiDataSetIterator(DataSetIterator):
    """Named multi-source wiring (RecordReaderMultiDataSetIterator.java):
    add readers under names, declare inputs/outputs as (reader, col_lo,
    col_hi) slices or one-hot outputs."""

    def __init__(self, batch_size: int):
        self._batch = batch_size
        self.readers: Dict[str, RecordReader] = {}
        self.inputs: List[Tuple[str, Optional[int], Optional[int]]] = []
        self.outputs: List[Tuple[str, Optional[int], Optional[int],
                                 Optional[int]]] = []

    def add_reader(self, name: str, reader: RecordReader):
        self.readers[name] = reader
        return self

    def add_input(self, name: str, col_lo: Optional[int] = None,
                  col_hi: Optional[int] = None):
        self.inputs.append((name, col_lo, col_hi))
        return self

    def add_output(self, name: str, col_lo: Optional[int] = None,
                   col_hi: Optional[int] = None):
        self.outputs.append((name, col_lo, col_hi, None))
        return self

    def add_output_one_hot(self, name: str, col: int, num_classes: int):
        self.outputs.append((name, col, col, num_classes))
        return self

    def batch_size(self):
        return self._batch

    def reset(self):
        for r in self.readers.values():
            r.reset()

    def __iter__(self):
        iters = {n: r.records() for n, r in self.readers.items()}
        while True:
            # Collect up to batch_size rows per reader, keeping the final
            # partial batch (DL4J emits it) and erroring on length-mismatched
            # readers instead of silently dropping rows.
            batch_rows = {}
            for n, it in iters.items():
                rows = []
                for _ in range(self._batch):
                    try:
                        rows.append(next(it))
                    except StopIteration:
                        break
                batch_rows[n] = rows
            counts = {n: len(v) for n, v in batch_rows.items()}
            if len(set(counts.values())) > 1:
                raise ValueError(
                    f"record readers are misaligned: {counts}")
            if not next(iter(counts.values()), 0):
                return
            arrays = {n: np.asarray(v, "float32")
                      for n, v in batch_rows.items()}
            feats = tuple(self._slice(arrays[n], lo, hi)
                          for n, lo, hi in self.inputs)
            labs = []
            for n, lo, hi, k in self.outputs:
                a = self._slice(arrays[n], lo, hi)
                if k is not None:
                    a = np.eye(k, dtype="float32")[a[:, 0].astype(int)]
                labs.append(a)
            # setPreProcessor contract (MultiDataSetPreProcessor here)
            yield self._pp(MultiDataSet(feats, tuple(labs)))

    @staticmethod
    def _slice(a, lo, hi):
        if lo is None:
            return a
        return a[:, lo:(a.shape[1] if hi is None else hi + 1)]


def load_image(path: str, height: int, width: int, channels: int,
               normalize: bool = False) -> np.ndarray:
    """THE image decode rule — PIL open/convert/resize to (H, W, C),
    uint8 raw (or float32 [0,1] with normalize). One definition shared
    by ImageRecordReader (in-process per-sample path) and
    data/pipeline.ImageFileBatchLoader (multi-process workers) so the
    two paths are bitwise-identical by construction."""
    from PIL import Image
    img = Image.open(path)
    img = img.convert("L" if channels == 1 else "RGB")
    img = img.resize((width, height))
    if normalize:
        arr = np.asarray(img, np.float32) / 255.0
    else:
        arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


class ImageRecordReader(RecordReader):
    """Images-from-directories reader (DataVec ImageRecordReader +
    ParentPathLabelGenerator): label = parent directory name, images
    resized to (height, width), RAW 0-255 uint8 NHWC — scaling is the
    attached normalizer's job, exactly as in the reference (DataVec's
    reader loads raw pixel values; the canonical quickstarts then do
    `iterator.setPreProcessor(new ImagePreProcessingScaler(0, 1))`).
    Keeping the batches uint8 also engages the device-side
    normalization seam: raw bytes cross the host->HBM link at 1/4 the
    float32 size and the scaler's affine runs on device during fit.

    normalize=True restores the pre-round-5 behavior of this class
    (float32 [0, 1] batches, no normalizer needed) for pipelines that
    relied on it.

    Usage (the canonical DL4J image-pipeline quickstart):
        rr = ImageRecordReader(32, 32, 3)
        rr.initialize("/data/train")        # train/<label>/*.png
        it = RecordReaderDataSetIterator(rr, batch_size=64,
                                         label_index=-1,
                                         num_classes=rr.num_labels())
        it.set_pre_processor(ImagePreProcessingScaler())
    """

    IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif")

    def __init__(self, height: int, width: int, channels: int = 3,
                 shuffle: bool = False, seed: int = 0,
                 normalize: bool = False):
        self.height = int(height)
        self.width = int(width)
        self.channels = int(channels)
        self.shuffle = shuffle
        self.seed = seed
        self.normalize = normalize
        self._files: List[Tuple[str, int]] = []
        self._labels: List[str] = []

    def initialize(self, root_dir: str):
        labels = sorted(
            d for d in os.listdir(root_dir)
            if os.path.isdir(os.path.join(root_dir, d)))
        self._labels = labels
        files = []
        for idx, label in enumerate(labels):
            d = os.path.join(root_dir, label)
            for fn in sorted(os.listdir(d)):
                if fn.lower().endswith(self.IMAGE_EXTENSIONS):
                    files.append((os.path.join(d, fn), idx))
        if self.shuffle:
            rs = np.random.RandomState(self.seed)
            rs.shuffle(files)
        self._files = files
        return self

    def labels(self) -> List[str]:
        return list(self._labels)

    def num_labels(self) -> int:
        return len(self._labels)

    def _load(self, path: str) -> np.ndarray:
        return load_image(path, self.height, self.width, self.channels,
                          self.normalize)

    def records(self):
        """Yields (image (H, W, C) uint8 — float32 [0,1] with
        normalize=True, label_idx) pairs; the bridge iterator recognizes
        the image shape and builds NHWC batches."""
        if not self._files:
            raise RuntimeError("call initialize(root_dir) first")
        for path, label in self._files:
            yield (self._load(path), label)

    is_image = True
