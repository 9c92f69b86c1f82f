"""Tokenizers + token preprocessors.

Parity: DL4J `text/tokenization/tokenizerfactory/DefaultTokenizerFactory`,
`NGramTokenizerFactory`, and `tokenization/tokenizer/preprocessor/
{CommonPreprocessor,LowCasePreprocessor}` — the pieces Word2Vec's pipeline
actually exercises. A factory produces a `tokenize(str) -> list[str]`
callable; preprocessors normalize each token.
"""
from __future__ import annotations

import re
from typing import List


class CommonPreprocessor:
    """Strip punctuation + lowercase (DL4J CommonPreprocessor)."""
    _PUNCT = re.compile(r"[\d.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token).lower()


class LowCasePreprocessor:
    def pre_process(self, token: str) -> str:
        return token.lower()


class DefaultTokenizerFactory:
    """Whitespace tokenizer with optional preprocessor (DL4J
    DefaultTokenizerFactory wraps a StreamTokenizer; whitespace split is the
    observable behavior for plain text)."""

    def __init__(self, preprocessor=None):
        self.preprocessor = preprocessor

    def set_token_pre_processor(self, p):
        self.preprocessor = p

    def tokenize(self, text: str) -> List[str]:
        toks = text.split()
        if self.preprocessor is not None:
            toks = [self.preprocessor.pre_process(t) for t in toks]
        return [t for t in toks if t]

    def create(self, text: str):
        return self.tokenize(text)


class RegexTokenizerFactory:
    def __init__(self, pattern: str = r"\w+", preprocessor=None):
        self.pattern = re.compile(pattern)
        self.preprocessor = preprocessor

    def tokenize(self, text: str) -> List[str]:
        toks = self.pattern.findall(text)
        if self.preprocessor is not None:
            toks = [self.preprocessor.pre_process(t) for t in toks]
        return [t for t in toks if t]


class NGramTokenizerFactory:
    """Emit n-grams of an underlying tokenizer (DL4J NGramTokenizerFactory)."""

    def __init__(self, base=None, min_n: int = 1, max_n: int = 2,
                 joiner: str = " "):
        self.base = base or DefaultTokenizerFactory()
        self.min_n = min_n
        self.max_n = max_n
        self.joiner = joiner

    def tokenize(self, text: str) -> List[str]:
        toks = self.base.tokenize(text)
        out = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(toks) - n + 1):
                out.append(self.joiner.join(toks[i:i + n]))
        return out
