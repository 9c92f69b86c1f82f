"""Data containers and iterators (numpy, framework-neutral copies of the
JAX package's)."""
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import (
    ArrayDataSetIterator, DataSetIterator, ExistingDataSetIterator,
)

__all__ = ["ArrayDataSetIterator", "DataSet", "DataSetIterator",
           "ExistingDataSetIterator"]
