"""Native (C++/OpenMP) batch tokenizer — the host-side fast path for the
text pipeline.

The reference tokenizes on the JVM (DefaultTokenizerFactory.java +
CommonPreprocessor.java) and re-tokenizes the corpus every epoch of
Word2Vec / every TF-IDF fit pass; `native/src/tokenizer.cpp` is the C++
analog of that hot path, parallel over documents (the port's own copy of
the library: `deeplearning4j_tpu_torch/native/`).

Correctness contract: byte-identical to
`DefaultTokenizerFactory(CommonPreprocessor())` for ASCII text (the
native lowercasing is byte-level). `NativeCorpusEncoder` refuses
non-ASCII input so callers can fall back to the general Python path —
`encode_or_none`/`count_or_none` return None in that case and when no
C++ toolchain is available.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch import native


def _available() -> bool:
    return native.available()


class NativeCorpusEncoder:
    """Batch tokenize + vocab-encode a corpus of documents in C++."""

    def __init__(self, common_preprocess: bool = True):
        self.common = common_preprocess

    @staticmethod
    def available() -> bool:
        return _available()

    # -- vocab building ---------------------------------------------------
    def count_or_none(self, docs: List[str]) -> Optional[Dict[str, int]]:
        """Token counts over the corpus (the vocab-building pass), or None
        when the native path can't be used (no toolchain / non-ASCII)."""
        if not _available():
            return None
        text = "\n".join(docs)
        if not text.isascii():
            return None
        lib = native.get_lib()
        raw = text.encode()
        h = lib.dl4j_count_tokens(raw, len(raw), 1 if self.common else 0)
        if not h:
            return None
        try:
            n = lib.dl4j_counts_size(h)
            blob_len = lib.dl4j_counts_blob_len(h)
            blob = ctypes.create_string_buffer(max(blob_len, 1))
            offsets = np.zeros(n + 1, np.int64)
            counts = np.zeros(max(n, 1), np.int64)
            lib.dl4j_counts_export(
                h, blob,
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            raw_blob = blob.raw[:blob_len].decode()
            return {raw_blob[offsets[i]:offsets[i + 1]]: int(counts[i])
                    for i in range(n)}
        finally:
            lib.dl4j_counts_free(h)

    # -- encoding ---------------------------------------------------------
    def encode_or_none(self, docs: List[str], word2id: Dict[str, int],
                       keep_oov: bool = False
                       ) -> Optional[List[np.ndarray]]:
        """Per-document int32 id arrays (OOV dropped, or -1 when
        keep_oov), or None when the native path can't be used."""
        if not _available():
            return None
        if not docs:
            return []
        if any("\n" in d for d in docs):    # '\n' is the doc separator
            return None
        text = "\n".join(docs)
        if not text.isascii():
            return None
        lib = native.get_lib()

        words = list(word2id.keys())
        if any(not w.isascii() for w in words):
            return None
        ids = np.asarray([word2id[w] for w in words], np.int32)
        # vocab ids must map back: C++ assigns position index, so order
        # the blob by position and translate after
        blob = "".join(words).encode()
        offsets = np.zeros(len(words) + 1, np.int64)
        pos = 0
        for i, w in enumerate(words):
            pos += len(w.encode())
            offsets[i + 1] = pos
        vh = lib.dl4j_vocab_create(
            blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(words))
        if not vh:
            return None
        try:
            raw = text.encode()
            # worst case is single-char tokens with single-char gaps
            max_out = max((len(raw) + 1) // 2, 1)
            n_docs = len(docs)
            int64_min = np.iinfo(np.int64).min
            while True:
                out_ids = np.zeros(max_out, np.int32)
                doc_ends = np.zeros(n_docs, np.int64)
                n_docs_out = ctypes.c_int64(0)
                total = lib.dl4j_tokenize_encode(
                    vh, raw, len(raw), 1 if self.common else 0,
                    1 if keep_oov else 0,
                    out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    max_out,
                    doc_ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    n_docs, ctypes.byref(n_docs_out))
                if total == int64_min:      # doc-count overflow, not a
                    return None             # resizable condition
                if total >= 0:
                    break
                max_out = -total            # buffer was too small; resize
            result = []
            start = 0
            for d in range(n_docs_out.value):
                end = int(doc_ends[d])
                seg = out_ids[start:end]
                # translate position index -> caller's ids (keep -1 OOV);
                # empty vocab means every token is OOV
                if ids.size:
                    trans = np.where(seg >= 0, ids[np.maximum(seg, 0)], -1)
                else:
                    trans = np.full(seg.shape, -1, np.int32)
                result.append(trans.astype(np.int32))
                start = end
            # a trailing empty document yields no final '\n' segment in C++
            while len(result) < len(docs):
                result.append(np.zeros(0, np.int32))
            return result
        finally:
            lib.dl4j_vocab_free(vh)
