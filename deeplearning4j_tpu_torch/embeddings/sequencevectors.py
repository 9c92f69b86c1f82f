"""SequenceVectors: the generic embedding trainer.

Parity: DL4J `models/sequencevectors/SequenceVectors.java:109-299` (fit():
buildVocab -> epoch loop) with the learning algorithms of
`models/embeddings/learning/impl/elements/{SkipGram,CBOW}.java` (skip-gram
and CBOW, each with negative sampling and/or hierarchical softmax, dynamic
window shrinking, frequent-word subsampling, linear lr decay).

The port of the JAX package's trainer. The host samples (center, context,
negatives) id batches from the same `RandomState` in the same order as the
reference, so both packages see the same batches; each batch is one step
of PyTorch ops on the tables, which stay in device memory: gathers,
sigmoid losses and scatter-add SGD (`index_add_`) in place. A step
computes every gradient from the tables as they were before its updates,
as the reference's functional step does, so a row that repeats within a
batch gets the same update. `fit(device=)` runs on CUDA unless the caller
asks for the CPU, and raises without CUDA (`util/platform.py`).

`backend="native"` trains with the C++ HogWild kernel instead
(`native.sg_ns_train`, the reference's AggregateSkipGram architecture).
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.embeddings.vocab import VocabCache
from deeplearning4j_tpu_torch.embeddings.wordvectors import WordVectors
from deeplearning4j_tpu_torch.util.platform import resolve_device


# ------------------------------------------------------------- device steps
def _pair_loss(logits, labels):
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def _sg_ns_grads(w_in, w_out, centers, targets, labels):
    """(grad of the center rows (N, D), grad of the target rows
    (N, 1+K, D), mean loss) of a skip-gram / negative-sampling batch."""
    vc = w_in[centers]                                  # (N, D)
    ut = w_out[targets]                                 # (N, K+1, D)
    logits = torch.einsum("nd,nkd->nk", vc, ut)
    # batch-MEAN gradients: with small vocabularies the same row appears
    # many times per batch and the scatter-adds sum; per-pair word2vec
    # SGD scaled by 1/N keeps the effective step bounded
    g = (torch.sigmoid(logits) - labels) / labels.shape[0]
    grad_vc = torch.einsum("nk,nkd->nd", g, ut)
    grad_ut = g[..., None] * vc[:, None, :]
    return grad_vc, grad_ut, torch.mean(_pair_loss(logits, labels))


def _sg_ns_step(w_in, w_out, centers, targets, labels, lr):
    """Skip-gram / negative-sampling SGD step, in place on w_in and w_out.

    centers: (N,) ids; targets: (N, 1+K) [context | negatives];
    labels: (N, 1+K) 1 for the true context, 0 for negatives.
    Returns the mean loss. DL4J analog: AggregateSkipGram's inner loop,
    batched."""
    grad_vc, grad_ut, loss = _sg_ns_grads(w_in, w_out, centers, targets,
                                          labels)
    d = w_in.shape[1]
    w_in.index_add_(0, centers, -lr * grad_vc)
    w_out.index_add_(0, targets.reshape(-1), -lr * grad_ut.reshape(-1, d))
    return loss


def _hs_loss(logits, labels, mask):
    return torch.sum(mask * _pair_loss(logits, labels)) \
        / torch.clamp(torch.sum(mask), min=1.0)


def _sg_hs_step(w_in, syn1, centers, points, codes, mask, lr):
    """Skip-gram / hierarchical-softmax step, in place. points: (N, L)
    inner-node ids (0 where padded), codes: (N, L) Huffman bits, mask:
    (N, L)."""
    vc = w_in[centers]                                  # (N, D)
    un = syn1[points]                                   # (N, L, D)
    logits = torch.einsum("nd,nld->nl", vc, un)
    labels = 1.0 - codes                                # word2vec convention
    g = (torch.sigmoid(logits) - labels) * mask / codes.shape[0]
    grad_vc = torch.einsum("nl,nld->nd", g, un)
    grad_un = g[..., None] * vc[:, None, :]
    d = w_in.shape[1]
    w_in.index_add_(0, centers, -lr * grad_vc)
    syn1.index_add_(0, points.reshape(-1), -lr * grad_un.reshape(-1, d))
    return _hs_loss(logits, labels, mask)


def _context_mean(w_in, ctx_ids, ctx_mask):
    ctx = w_in[ctx_ids] * ctx_mask[..., None]           # (N, W, D)
    denom = torch.clamp(torch.sum(ctx_mask, dim=1, keepdim=True), min=1.0)
    return torch.sum(ctx, dim=1) / denom, denom         # (N, D)


def _cbow_hs_step(w_in, syn1, ctx_ids, ctx_mask, points, codes, mask, lr):
    """CBOW / hierarchical-softmax, in place: the context-window mean
    predicts the CENTER word's Huffman path (DL4J CBOW.java HS path: the
    input vector is the averaged context, not the center itself).
    ctx_ids: (N, W) 0-padded window ids, ctx_mask: (N, W);
    points/codes/mask: (N, L) for the center word's Huffman code."""
    h, denom = _context_mean(w_in, ctx_ids, ctx_mask)
    un = syn1[points]                                   # (N, L, D)
    logits = torch.einsum("nd,nld->nl", h, un)
    labels = 1.0 - codes
    g = (torch.sigmoid(logits) - labels) * mask / codes.shape[0]
    grad_h = torch.einsum("nl,nld->nd", g, un)
    grad_un = g[..., None] * h[:, None, :]
    grad_ctx = (grad_h / denom)[:, None, :] * ctx_mask[..., None]
    d = w_in.shape[1]
    w_in.index_add_(0, ctx_ids.reshape(-1), -lr * grad_ctx.reshape(-1, d))
    syn1.index_add_(0, points.reshape(-1), -lr * grad_un.reshape(-1, d))
    return _hs_loss(logits, labels, mask)


def _cbow_ns_step(w_in, w_out, ctx_ids, ctx_mask, targets, labels, lr):
    """CBOW / negative sampling, in place: the context mean predicts the
    center. ctx_ids: (N, W) window word ids (0-padded), ctx_mask: (N, W),
    targets: (N, 1+K) [center | negatives]."""
    h, denom = _context_mean(w_in, ctx_ids, ctx_mask)
    ut = w_out[targets]
    logits = torch.einsum("nd,nkd->nk", h, ut)
    g = (torch.sigmoid(logits) - labels) / labels.shape[0]
    grad_h = torch.einsum("nk,nkd->nd", g, ut)          # (N, D)
    grad_ut = g[..., None] * h[:, None, :]
    # distribute grad_h back to each context word (divided by window size)
    grad_ctx = (grad_h / denom)[:, None, :] * ctx_mask[..., None]
    d = w_in.shape[1]
    w_in.index_add_(0, ctx_ids.reshape(-1), -lr * grad_ctx.reshape(-1, d))
    w_out.index_add_(0, targets.reshape(-1), -lr * grad_ut.reshape(-1, d))
    return torch.mean(_pair_loss(logits, labels))


def _to_device(a: np.ndarray, device: torch.device, dtype=None
               ) -> torch.Tensor:
    """A host batch array on `device`. To CUDA through pinned memory and
    without a wait, so the host samples the next batch while the card
    runs this one."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _table_on(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A float32 copy of host table `a` on `device` (the steps update it
    in place: the caller's array is never written)."""
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _ids(a, device):
    return _to_device(a, device, torch.int64)


def _f32(a, device):
    return _to_device(a, device, torch.float32)


def _f32_lr(lr: float) -> float:
    """`lr` rounded to float32, as the reference passes it to its step."""
    return float(np.float32(lr))


class SequenceVectors(WordVectors):
    """Generic embedding trainer over element sequences.

    elements_learning_algorithm: "skipgram" | "cbow"
    negative > 0 enables negative sampling; use_hierarchic_softmax enables
    HS (both may be on, like DL4J; HS-only needs negative=0).

    learning_rate is batch-mean scaled (gradients divide by batch size), so
    it sits ~an order of magnitude above word2vec's classic per-pair 0.025.
    """

    def __init__(self, layer_size: int = 100, window: int = 5,
                 min_count: int = 1, negative: int = 5,
                 use_hierarchic_softmax: bool = False,
                 subsampling: float = 0.0,
                 learning_rate: float = 0.5,
                 min_learning_rate: float = 1e-4,
                 epochs: int = 1, batch_size: int = 512,
                 elements_learning_algorithm: str = "skipgram",
                 backend: str = "device", n_threads: int = 0,
                 seed: int = 42):
        super().__init__(VocabCache(), np.zeros((0, layer_size), np.float32))
        self.layer_size = layer_size
        self.window = window
        self.min_count = min_count
        self.negative = negative
        self.use_hs = use_hierarchic_softmax
        self.subsampling = subsampling
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.algorithm = elements_learning_algorithm
        # "device": batched PyTorch steps on the fit's device; "native":
        # the C++ HogWild trainer (deeplearning4j_tpu_torch.native), the
        # architecture DL4J's AggregateSkipGram path uses
        self.backend = backend
        self.n_threads = n_threads
        self.seed = seed
        self._rs = np.random.RandomState(seed)
        self.syn1 = None            # HS inner-node table
        self.w_out = None           # NS output table
        self.device = None          # the last fit's device

    # ------------------------------------------------------------ sequences
    def _sequences(self, source) -> Iterable[List[str]]:
        raise NotImplementedError

    # ----------------------------------------------------------------- fit
    def build_vocab(self, source):
        for seq in self._sequences(source):
            for tok in seq:
                self.vocab.add_token(tok)
        self.vocab.build(self.min_count)
        if self.use_hs:
            self.vocab.build_huffman()
        return self

    def fit(self, source, *, initial_syn0=None, initial_syn1neg=None,
            device=None):
        """Train on `device` (None: CUDA, raising without it; "cpu" on
        request). `initial_syn0`/`initial_syn1neg` (host arrays, never
        written) warm-start the tables: the hook the partition-parallel
        trainer (embeddings/distributed.py, the Spark word2vec analog)
        uses to continue from broadcast parameters."""
        if self.backend != "native":
            self.device = resolve_device(device)
        if len(self.vocab) == 0:
            self.build_vocab(source)
        if self.backend == "native":
            return self._fit_native(source, initial_syn0, initial_syn1neg)
        dev = self.device
        V, D = len(self.vocab), self.layer_size
        rs = self._rs
        w_in = _table_on(initial_syn0, dev) if initial_syn0 is not None \
            else _table_on((rs.rand(V, D).astype(np.float32) - 0.5) / D, dev)
        w_out = _table_on(initial_syn1neg, dev) \
            if initial_syn1neg is not None \
            else torch.zeros((V, D), dtype=torch.float32, device=dev)
        syn1 = torch.zeros((max(V - 1, 1), D), dtype=torch.float32,
                           device=dev)
        table = self.vocab.unigram_table()
        total_words = max(self.vocab.total_count(), 1)
        max_code = self.vocab.max_code_length() if self.use_hs else 0
        seen = 0
        # pairs per word ~ (window+1) with the dynamic-window average
        expected = total_words * (self.window + 1) * self.epochs
        for _ in range(self.epochs):
            for batch in self._batches(source, rs):
                frac = min(seen / expected, 1.0)
                lr = _f32_lr(max(self.min_learning_rate,
                                self.learning_rate * (1.0 - frac)))
                if self.negative > 0:
                    if self.algorithm == "cbow":
                        ctx_ids, ctx_mask, centers = batch
                        negs = rs.choice(V, (len(centers), self.negative),
                                         p=table)
                        targets = np.concatenate(
                            [centers[:, None], negs], axis=1)
                        labels = np.zeros_like(targets, np.float32)
                        labels[:, 0] = 1.0
                        _cbow_ns_step(
                            w_in, w_out, _ids(ctx_ids, dev),
                            _f32(ctx_mask, dev), _ids(targets, dev),
                            _f32(labels, dev), lr)
                        seen += len(centers)
                    else:
                        centers, contexts = batch
                        negs = rs.choice(V, (len(centers), self.negative),
                                         p=table)
                        targets = np.concatenate(
                            [contexts[:, None], negs], axis=1)
                        labels = np.zeros_like(targets, np.float32)
                        labels[:, 0] = 1.0
                        _sg_ns_step(
                            w_in, w_out, _ids(centers, dev),
                            _ids(targets, dev), _f32(labels, dev), lr)
                        seen += len(centers)
                if self.use_hs:
                    if self.algorithm == "cbow":
                        # context-window mean predicts the center word's
                        # Huffman path (DL4J CBOW.java HS path)
                        ctx_ids, ctx_mask, centers = batch
                        pts, cds, msk = self._hs_arrays(centers, max_code)
                        _cbow_hs_step(
                            w_in, syn1, _ids(ctx_ids, dev),
                            _f32(ctx_mask, dev), _ids(pts, dev),
                            _f32(cds, dev), _f32(msk, dev), lr)
                    else:
                        centers, contexts = batch
                        pts, cds, msk = self._hs_arrays(contexts, max_code)
                        _sg_hs_step(
                            w_in, syn1, _ids(centers, dev), _ids(pts, dev),
                            _f32(cds, dev), _f32(msk, dev), lr)
                    if self.negative <= 0:   # NS branch didn't count these
                        seen += len(centers)
        self.vectors = w_in.cpu().numpy()
        self.w_out = w_out.cpu().numpy()
        self.syn1 = syn1.cpu().numpy()
        return self

    # ------------------------------------------------------------- native
    def _fit_native(self, source, initial_syn0=None, initial_syn1neg=None):
        """C++ HogWild skip-gram/negative-sampling epochs (the reference's
        AggregateSkipGram architecture: lock-free threads over shared
        tables; SkipGram.java:224-272). Requires skipgram + negative
        sampling; raises when the toolchain/library is unavailable."""
        from deeplearning4j_tpu_torch import native
        if self.algorithm != "skipgram" or self.negative <= 0 or self.use_hs:
            raise ValueError("backend='native' supports skip-gram with "
                             "negative sampling (the AggregateSkipGram "
                             "path); use backend='device' otherwise")
        if not native.available():
            raise RuntimeError("native backend unavailable: g++ build "
                               "failed or no toolchain (see logs)")
        V, D = len(self.vocab), self.layer_size
        rs = self._rs
        syn0 = (np.array(initial_syn0, np.float32, order="C")
                if initial_syn0 is not None
                else ((rs.rand(V, D) - 0.5) / D).astype(np.float32))
        syn1neg = (np.array(initial_syn1neg, np.float32, order="C")
                   if initial_syn1neg is not None
                   else np.zeros((V, D), np.float32))
        p = self.vocab.unigram_table()
        cum = np.cumsum(np.asarray(p, np.float64))
        cum /= cum[-1]
        # float rounding can still push the last probe past cum[-1] and
        # searchsorted would emit the out-of-range id V: clamp (the C++
        # kernel indexes the table unchecked, as HogWild kernels do)
        table = np.minimum(
            np.searchsorted(cum, (np.arange(1_000_000) + 0.5) / 1_000_000),
            V - 1).astype(np.int32)
        # the device backend takes batch-MEAN steps (lr divided by ~batch
        # size inside the step); HogWild applies every pair individually,
        # so the same knob maps into the per-pair regime by 0.05: the 0.5
        # default becomes 0.025, word2vec.c's canonical skip-gram rate.
        # Without this, per-pair lr 0.5 diverges to NaN.
        pair_lr = self.learning_rate * 0.05
        pair_lr_min = self.min_learning_rate * 0.05
        self.last_loss = 0.0
        for epoch in range(self.epochs):
            ids, offsets = [], [0]
            for seq in self._sequences(source):
                enc = self._encode(seq, rs)
                if len(enc) < 2:
                    continue
                ids.append(enc)
                offsets.append(offsets[-1] + len(enc))
            if not ids:
                break
            corpus = np.concatenate(ids).astype(np.int32)
            offs = np.asarray(offsets, np.int64)
            frac0 = epoch / self.epochs
            lr_start = max(pair_lr_min, pair_lr * (1.0 - frac0))
            # within-call decay slope matches the global schedule when the
            # counter horizon spans all remaining epochs
            horizon = len(corpus) * max(self.epochs - epoch, 1)
            self.last_loss = native.sg_ns_train(
                syn0, syn1neg, corpus, offs, self.window, self.negative,
                table, lr_start, pair_lr_min, horizon,
                seed=self.seed + epoch, n_threads=self.n_threads)
        self.vectors = syn0
        self.w_out = syn1neg
        return self

    # ------------------------------------------------------------- sampling
    def _encode(self, seq: List[str], rs) -> np.ndarray:
        ids = [self.vocab.index_of(t) for t in seq]
        ids = [i for i in ids if i >= 0]
        if self.subsampling > 0 and ids:
            total = self.vocab.total_count()
            keep = []
            for i in ids:
                f = self.vocab.count_of(self.vocab.word_for(i)) / total
                p = (np.sqrt(f / self.subsampling) + 1) * self.subsampling / f
                if rs.rand() < p:
                    keep.append(i)
            ids = keep
        return np.asarray(ids, np.int32)

    def _batches(self, source, rs):
        if self.algorithm == "cbow":
            yield from self._cbow_batches(source, rs)
            return
        centers, contexts = [], []
        for seq in self._sequences(source):
            ids = self._encode(seq, rs)
            n = len(ids)
            for pos in range(n):
                b = rs.randint(1, self.window + 1)    # dynamic window
                for off in range(-b, b + 1):
                    j = pos + off
                    if off == 0 or j < 0 or j >= n:
                        continue
                    centers.append(ids[pos])
                    contexts.append(ids[j])
                    if len(centers) == self.batch_size:
                        yield (np.asarray(centers, np.int32),
                               np.asarray(contexts, np.int32))
                        centers, contexts = [], []
        if centers:
            yield (np.asarray(centers, np.int32),
                   np.asarray(contexts, np.int32))

    def _cbow_batches(self, source, rs):
        W = 2 * self.window
        ctx_rows, mask_rows, centers = [], [], []
        for seq in self._sequences(source):
            ids = self._encode(seq, rs)
            n = len(ids)
            for pos in range(n):
                b = rs.randint(1, self.window + 1)
                row = [ids[pos + off] for off in range(-b, b + 1)
                       if off != 0 and 0 <= pos + off < n]
                if not row:
                    continue
                pad = W - len(row)
                ctx_rows.append(row + [0] * pad)
                mask_rows.append([1.0] * len(row) + [0.0] * pad)
                centers.append(ids[pos])
                if len(centers) == self.batch_size:
                    yield (np.asarray(ctx_rows, np.int32),
                           np.asarray(mask_rows, np.float32),
                           np.asarray(centers, np.int32))
                    ctx_rows, mask_rows, centers = [], [], []
        if centers:
            yield (np.asarray(ctx_rows, np.int32),
                   np.asarray(mask_rows, np.float32),
                   np.asarray(centers, np.int32))

    def _hs_arrays(self, word_ids, max_code):
        n = len(word_ids)
        pts = np.zeros((n, max_code), np.int32)
        cds = np.zeros((n, max_code), np.float32)
        msk = np.zeros((n, max_code), np.float32)
        vws = self.vocab.vocab_words()
        for r, wid in enumerate(word_ids):
            vw = vws[int(wid)]
            L = len(vw.codes or [])
            pts[r, :L] = vw.points
            cds[r, :L] = vw.codes
            msk[r, :L] = 1.0
        return pts, cds, msk
