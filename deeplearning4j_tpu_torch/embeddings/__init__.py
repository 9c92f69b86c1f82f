"""Word/sequence embeddings (DL4J deeplearning4j-nlp models/ parity).

Reference: `models/sequencevectors/SequenceVectors.java:109-299`,
`models/word2vec/Word2Vec.java`, `models/paragraphvectors/`,
`models/glove/Glove.java`, `models/embeddings/` (lookup tables, loaders).

The port of the JAX package's `embeddings/`. The reference trains with
lock-free HogWild host threads over a shared table (`SkipGram.java:224-272`
native aggregates); here training is mini-batched device compute: the host
builds the vocabulary and samples (center, context, negative) id batches,
and each batch is one step of PyTorch ops (embedding gathers, sigmoid
losses, scatter-add updates) on tables that stay on the card. The C++
HogWild trainer stays available as `backend="native"`. Same models, same
hyperparameters, same output artifact (word vectors, similarity queries,
the word2vec text format).

The names are exported lazily (`util/lazy.py`).
"""
from deeplearning4j_tpu_torch.util.lazy import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("VocabCache", "VocabWord"), "vocab"),
    "WordVectors": "wordvectors",
    "SequenceVectors": "sequencevectors",
    "Word2Vec": "word2vec",
    "SparkWord2Vec": "distributed",
    "ParagraphVectors": "paragraphvectors",
    "Glove": "glove",
}
__all__ = ["VocabCache", "VocabWord", "WordVectors", "SequenceVectors",
           "Word2Vec", "SparkWord2Vec", "ParagraphVectors", "Glove"]
__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
