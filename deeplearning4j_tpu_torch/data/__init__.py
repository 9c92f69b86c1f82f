"""Data containers, iterators, shards, the multi-process ring, record
readers, normalizers and fetchers (numpy copies of the JAX package's
`data/`; `async_iterator` and `normalization` hold the torch device
seams).

The reference's names are exported lazily (`util/lazy.py`): importing
this package imports none of its modules, so a spawned worker of
`data/pipeline.py` never imports torch.
"""
from deeplearning4j_tpu_torch.util.lazy import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("DataSet", "MultiDataSet"), "dataset"),
    **dict.fromkeys(("DataSetIterator", "ArrayDataSetIterator",
                     "ExistingDataSetIterator", "BenchmarkDataSetIterator"),
                    "iterator"),
    **dict.fromkeys(("AsyncDataSetIterator", "prefetch_depth",
                     "prefetch_iterable"), "async_iterator"),
    **dict.fromkeys(("ShardDataSetIterator", "ShardWriter", "write_shards"),
                    "shards"),
    **dict.fromkeys(("ImageFileBatchLoader", "MultiProcessDataSetIterator",
                     "ShardBatchLoader", "etl_workers"), "pipeline"),
    **dict.fromkeys((
        "AbstractDataSetIterator", "AsyncMultiDataSetIterator",
        "AsyncShieldDataSetIterator", "CombinedMultiDataSetPreProcessor",
        "CombinedPreProcessor", "DataSetCallback", "DataSetIteratorSplitter",
        "DefaultCallback", "DoublesDataSetIterator", "DummyPreProcessor",
        "EarlyTerminationDataSetIterator",
        "EarlyTerminationMultiDataSetIterator", "FileSplitDataSetIterator",
        "FloatsDataSetIterator", "INDArrayDataSetIterator",
        "InequalityHandling", "InterleavedDataSetCallback",
        "IteratorDataSetIterator", "IteratorMultiDataSetIterator",
        "JointParallelDataSetIterator", "ListDataSetIterator",
        "MovingWindowBaseDataSetIterator", "MultiDataSetIteratorSplitter",
        "MultiDataSetWrapperIterator", "MultipleEpochsIterator",
        "ReconstructionDataSetIterator", "SamplingDataSetIterator",
        "SingletonMultiDataSetIterator", "WorkspacesShieldDataSetIterator",
        "load_dataset", "save_dataset"), "utility_iterators"),
    **dict.fromkeys((
        "DataSetPreProcessor", "ImagePreProcessingScaler",
        "MultiNormalizerStandardize", "NormalizerMinMaxScaler",
        "NormalizerStandardize", "VGG16ImagePreProcessor"), "normalization"),
    **dict.fromkeys((
        "CSVRecordReader", "CSVSequenceRecordReader", "CollectionRecordReader",
        "CollectionSequenceRecordReader", "ImageRecordReader",
        "RecordReaderDataSetIterator", "RecordReaderMultiDataSetIterator",
        "SequenceRecordReaderDataSetIterator"), "records"),
    **dict.fromkeys((
        "Cifar10DataSetIterator", "EmnistDataSetIterator",
        "IrisDataSetIterator", "LfwDataSetIterator", "MnistDataSetIterator",
        "SvhnDataSetIterator", "TinyImageNetDataSetIterator",
        "UciSequenceDataSetIterator"), "fetchers"),
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
