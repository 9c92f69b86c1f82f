"""Word2Vec (DL4J `models/word2vec/Word2Vec.java:32`).

SequenceVectors specialization over a sentence iterator + tokenizer —
the classic skip-gram / CBOW with negative sampling and/or hierarchical
softmax. Usage mirrors DL4J's builder:

    w2v = Word2Vec(layer_size=100, window=5, min_count=5, negative=5,
                   tokenizer=DefaultTokenizerFactory(CommonPreprocessor()))
    w2v.fit(BasicLineIterator("corpus.txt"))
    w2v.words_nearest("day", 10)
"""
from __future__ import annotations

from typing import Iterable, List

from deeplearning4j_tpu_torch.embeddings.sequencevectors import SequenceVectors


class Word2Vec(SequenceVectors):
    def __init__(self, tokenizer=None, stop_words=(), **kwargs):
        super().__init__(**kwargs)
        if tokenizer is None:
            from deeplearning4j_tpu_torch.text.tokenization import (
                DefaultTokenizerFactory,
            )
            tokenizer = DefaultTokenizerFactory()
        self.tokenizer = tokenizer
        self.stop_words = frozenset(stop_words)

    def _sequences(self, source) -> Iterable[List[str]]:
        if hasattr(source, "reset"):
            source.reset()
        for sentence in source:
            toks = self.tokenizer.tokenize(sentence) \
                if isinstance(sentence, str) else list(sentence)
            if self.stop_words:
                toks = [t for t in toks if t not in self.stop_words]
            if toks:
                yield toks

    # ------------------------------------------------- native vocab pass
    def _native_counts(self, source):
        """C++ batch token counting (native/src/tokenizer.cpp) when the
        corpus and tokenizer allow it: a list of ASCII sentences under the
        DefaultTokenizerFactory with CommonPreprocessor (or none). Returns
        None to fall back to the per-sentence Python pass — only list/
        tuple sources qualify so a generator is never half-consumed."""
        from deeplearning4j_tpu_torch.text.native_tokenizer import (
            NativeCorpusEncoder,
        )
        from deeplearning4j_tpu_torch.text.tokenization import (
            CommonPreprocessor, DefaultTokenizerFactory,
        )
        if not isinstance(source, (list, tuple)):
            return None
        if type(self.tokenizer) is not DefaultTokenizerFactory:
            return None
        pp = self.tokenizer.preprocessor
        if pp is not None and type(pp) is not CommonPreprocessor:
            return None
        if not all(isinstance(s, str) for s in source):
            return None
        enc = NativeCorpusEncoder(common_preprocess=pp is not None)
        return enc.count_or_none(list(source))

    def build_vocab(self, source):
        counts = self._native_counts(source)
        if counts is None:
            return super().build_vocab(source)
        for w, c in counts.items():
            if w not in self.stop_words:
                self.vocab.add_token(w, c)
        self.vocab.build(self.min_count)
        if self.use_hs:
            self.vocab.build_huffman()
        return self
