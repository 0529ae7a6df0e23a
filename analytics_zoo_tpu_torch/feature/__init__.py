"""Data ingestion (port of ``analytics_zoo_tpu/feature``): the
preprocessing algebra (``feature.common``), the cached, sharded
``FeatureSet`` with its memory tiers, the RDD adapter (``feature.rdd``),
the label rule the Estimator reads its labels by, and the text, image
and 3-D image data paths (``feature.text``, ``feature.image``,
``feature.image3d``)."""

from analytics_zoo_tpu_torch.feature.common import (
    ArrayToTensor, ChainedPreprocessing, FeatureLabelPreprocessing,
    Preprocessing, Sample, ScalarToTensor, SeqToTensor, TensorToSample)
from analytics_zoo_tpu_torch.feature.feature_set import (
    FeatureSet, MemoryType, normalize_labels)
from analytics_zoo_tpu_torch.feature.rdd import (
    LocalRdd, collect_shard, is_rdd_like, is_spark_dataframe,
    process_shard_spec)

__all__ = [
    "Preprocessing", "ChainedPreprocessing", "ArrayToTensor", "SeqToTensor",
    "ScalarToTensor", "TensorToSample", "FeatureLabelPreprocessing",
    "Sample", "FeatureSet", "MemoryType", "LocalRdd", "collect_shard",
    "is_rdd_like", "is_spark_dataframe", "process_shard_spec",
    "normalize_labels",
]
