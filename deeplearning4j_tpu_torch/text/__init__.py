"""Text pipeline (DL4J deeplearning4j-nlp text/ parity).

The port's copy of the JAX package's `text/` (the standard library and
numpy; no torch). Reference: `deeplearning4j-nlp-parent/deeplearning4j-nlp/
.../text/` {tokenization, sentenceiterator, documentiterator, stopwords}.
String processing stays on the host; the card only sees tokenized id
batches (`embeddings/`).
"""
from deeplearning4j_tpu_torch.util.lazy import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("DefaultTokenizerFactory", "NGramTokenizerFactory",
                     "RegexTokenizerFactory", "CommonPreprocessor",
                     "LowCasePreprocessor"), "tokenization"),
    **dict.fromkeys(("BasicLineIterator", "CollectionSentenceIterator",
                     "FileSentenceIterator"), "sentenceiterator"),
    "STOP_WORDS": "stopwords",
    **dict.fromkeys(("BasicLabelAwareIterator", "FileLabelAwareIterator",
                     "FilenamesLabelAwareIterator", "LabelAwareIterator",
                     "LabelledDocument", "LabelsSource",
                     "SimpleLabelAwareIterator"), "documentiterator"),
    "InMemoryInvertedIndex": "invertedindex",
    **dict.fromkeys(("ChineseTokenizerFactory", "JapaneseTokenizerFactory",
                     "KoreanTokenizerFactory"), "cjk"),
    **dict.fromkeys(("BagOfWordsVectorizer", "BaseTextVectorizer",
                     "TfidfVectorizer"), "vectorizers"),
}

__all__ = [
    "DefaultTokenizerFactory", "NGramTokenizerFactory",
    "RegexTokenizerFactory", "CommonPreprocessor", "LowCasePreprocessor",
    "BasicLineIterator", "CollectionSentenceIterator",
    "FileSentenceIterator", "STOP_WORDS",
    "LabelledDocument", "LabelsSource", "LabelAwareIterator",
    "SimpleLabelAwareIterator", "BasicLabelAwareIterator",
    "FileLabelAwareIterator", "FilenamesLabelAwareIterator",
    "InMemoryInvertedIndex",
    "ChineseTokenizerFactory", "JapaneseTokenizerFactory",
    "KoreanTokenizerFactory",
    "BaseTextVectorizer", "BagOfWordsVectorizer", "TfidfVectorizer",
]
__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
