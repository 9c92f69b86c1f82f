"""GloVe (DL4J `models/glove/Glove.java` + `learning/impl/elements/GloVe.java`).

Co-occurrence counting on the host (the reference's AbstractCoOccurrences),
then batched AdaGrad weighted-least-squares updates on device:

    J = f(X_ij) (w_i . w~_j + b_i + b~_j - log X_ij)^2,
    f(x) = (x / x_max)^alpha clipped at 1.

The final vectors are w + w~ (standard GloVe practice; DL4J exposes syn0).

The port's step updates the eight tables in place on the fit's device,
in the reference's order: each AdaGrad accumulator takes its batch's
squares before it is read for the update.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Iterable, List

import numpy as np
import torch

from deeplearning4j_tpu_torch.embeddings.sequencevectors import (
    SequenceVectors, _f32, _f32_lr, _ids, _table_on,
)
from deeplearning4j_tpu_torch.util.platform import resolve_device


def _glove_step(w, wc, b, bc, gw, gwc, gb, gbc, rows, cols, logx, fx, lr):
    """One AdaGrad batch update, in place on the eight tables. rows/cols:
    (N,) ids; logx/fx: (N,). Returns the batch's loss (a device scalar)."""
    wi = w[rows]
    wj = wc[cols]
    diff = torch.einsum("nd,nd->n", wi, wj) + b[rows] + bc[cols] - logx
    fdiff = fx * diff                                   # (N,)
    loss = 0.5 * torch.mean(fx * diff * diff)
    grad_wi = fdiff[:, None] * wj
    grad_wj = fdiff[:, None] * wi
    # AdaGrad accumulators: added to before they are read below
    gw.index_add_(0, rows, grad_wi ** 2)
    gwc.index_add_(0, cols, grad_wj ** 2)
    gb.index_add_(0, rows, fdiff ** 2)
    gbc.index_add_(0, cols, fdiff ** 2)
    w.index_add_(0, rows, -lr * grad_wi / torch.sqrt(gw[rows] + 1e-8))
    wc.index_add_(0, cols, -lr * grad_wj / torch.sqrt(gwc[cols] + 1e-8))
    b.index_add_(0, rows, -lr * fdiff / torch.sqrt(gb[rows] + 1e-8))
    bc.index_add_(0, cols, -lr * fdiff / torch.sqrt(gbc[cols] + 1e-8))
    return loss


class Glove(SequenceVectors):
    def __init__(self, tokenizer=None, x_max: float = 100.0,
                 alpha: float = 0.75, symmetric: bool = True, **kwargs):
        kwargs.setdefault("learning_rate", 0.05)
        kwargs.setdefault("epochs", 25)
        super().__init__(**kwargs)
        if tokenizer is None:
            from deeplearning4j_tpu_torch.text.tokenization import (
                DefaultTokenizerFactory,
            )
            tokenizer = DefaultTokenizerFactory()
        self.tokenizer = tokenizer
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric

    def _sequences(self, source) -> Iterable[List[str]]:
        if hasattr(source, "reset"):
            source.reset()
        for sentence in source:
            toks = self.tokenizer.tokenize(sentence) \
                if isinstance(sentence, str) else list(sentence)
            if toks:
                yield toks

    def _cooccurrences(self, source):
        """Distance-weighted co-occurrence counts (AbstractCoOccurrences)."""
        co = defaultdict(float)
        for toks in self._sequences(source):
            ids = [self.vocab.index_of(t) for t in toks]
            ids = [i for i in ids if i >= 0]
            n = len(ids)
            for pos in range(n):
                for off in range(1, self.window + 1):
                    j = pos + off
                    if j >= n:
                        break
                    w = 1.0 / off
                    co[(ids[pos], ids[j])] += w
                    if self.symmetric:
                        co[(ids[j], ids[pos])] += w
        return co

    def fit(self, source, device=None):
        self.device = dev = resolve_device(device)
        if len(self.vocab) == 0:
            self.build_vocab(source)
        co = self._cooccurrences(source)
        if not co:
            raise ValueError("empty co-occurrence matrix")
        pairs = np.asarray(list(co.keys()), np.int32)
        counts = np.asarray(list(co.values()), np.float32)
        logx = np.log(counts)
        fx = np.minimum((counts / self.x_max) ** self.alpha, 1.0) \
            .astype(np.float32)
        V, D = len(self.vocab), self.layer_size
        rs = self._rs
        w = _table_on((rs.rand(V, D).astype(np.float32) - 0.5) / D, dev)
        wc = _table_on((rs.rand(V, D).astype(np.float32) - 0.5) / D, dev)
        b = torch.zeros((V,), dtype=torch.float32, device=dev)
        bc = torch.zeros((V,), dtype=torch.float32, device=dev)
        gw = torch.full((V, D), 1e-8, dtype=torch.float32, device=dev)
        gwc = torch.full((V, D), 1e-8, dtype=torch.float32, device=dev)
        gb = torch.full((V,), 1e-8, dtype=torch.float32, device=dev)
        gbc = torch.full((V,), 1e-8, dtype=torch.float32, device=dev)
        lr = _f32_lr(self.learning_rate)
        n = len(pairs)
        bs = self.batch_size
        self.last_loss = None
        for _ in range(self.epochs):
            order = rs.permutation(n)
            for lo in range(0, n, bs):
                sel = order[lo:lo + bs]
                if len(sel) < bs:       # pad to static shape (weight 0)
                    pad = rs.randint(0, n, bs - len(sel))
                    selp = np.concatenate([sel, pad])
                    fxb = np.concatenate(
                        [fx[sel], np.zeros(bs - len(sel), np.float32)])
                else:
                    selp = sel
                    fxb = fx[sel]
                loss = _glove_step(
                    w, wc, b, bc, gw, gwc, gb, gbc,
                    _ids(pairs[selp, 0], dev), _ids(pairs[selp, 1], dev),
                    _f32(logx[selp], dev), _f32(fxb, dev), lr)
                # the step's one loss fetch, as the reference's
                self.last_loss = float(loss)
        self.vectors = w.cpu().numpy() + wc.cpu().numpy()
        return self
