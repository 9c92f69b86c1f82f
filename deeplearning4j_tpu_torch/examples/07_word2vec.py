"""Word2Vec skip-gram + nearest words (the Word2VecRawTextExample role).
Run: python -m deeplearning4j_tpu_torch.examples.07_word2vec
[--device cpu]"""
from deeplearning4j_tpu_torch.embeddings.word2vec import Word2Vec
from deeplearning4j_tpu_torch.examples._common import cli, device_of
from deeplearning4j_tpu_torch.text.sentenceiterator import (
    CollectionSentenceIterator,
)

CORPUS = (
    ["the king rules the castle with the queen"] * 25
    + ["the queen rules the castle with the king"] * 25
    + ["dogs chase cats through the garden"] * 25
    + ["cats flee dogs across the garden"] * 25
)


def main(epochs=8, device=None):
    dev = device_of(device)
    w2v = Word2Vec(min_count=5, layer_size=24, seed=1, window=3,
                   epochs=epochs)
    w2v.fit(CollectionSentenceIterator(CORPUS), device=dev)
    print("nearest to 'king':", w2v.words_nearest("king", top_n=3))
    print("king~queen similarity:",
          round(w2v.similarity("king", "queen"), 3))
    print("king~dogs similarity:", round(w2v.similarity("king", "dogs"), 3))
    return w2v


if __name__ == "__main__":
    cli(main)
