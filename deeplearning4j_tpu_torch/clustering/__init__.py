"""Nearest neighbors + clustering (DL4J deeplearning4j-nearestneighbors parity).

Reference: `deeplearning4j-nearestneighbors-parent/nearestneighbor-core/
.../clustering/{vptree,kdtree,kmeans,lsh,randomprojection,sptree}`.

Placement, as in the JAX package: tree construction and traversal, LSH,
random projection and the server are host algorithms (numpy) and take no
device; k-means' assignment (the distance matmul and argmin over all
points) runs on the device the estimator was given, CUDA by default.
"""
from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering
from deeplearning4j_tpu_torch.clustering.vptree import VPTree
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree
from deeplearning4j_tpu_torch.clustering.lsh import RandomProjectionLSH
from deeplearning4j_tpu_torch.clustering.randomprojection import (
    RandomProjection,
)
from deeplearning4j_tpu_torch.clustering.server import (
    NearestNeighborsClient, NearestNeighborsServer,
)

__all__ = ["KMeansClustering", "VPTree", "KDTree", "RandomProjectionLSH",
           "RandomProjection", "NearestNeighborsServer",
           "NearestNeighborsClient"]
