"""Manifold learning (DL4J deeplearning4j-manifold parity)."""
from deeplearning4j_tpu_torch.manifold.tsne import Tsne
from deeplearning4j_tpu_torch.manifold.bhtsne import BarnesHutTsne

__all__ = ["Tsne", "BarnesHutTsne"]
