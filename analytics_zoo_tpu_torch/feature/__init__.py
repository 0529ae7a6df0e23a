"""Data ingestion (port of ``analytics_zoo_tpu/feature``): the label
rule the Estimator reads its labels by, the preprocessing algebra
(``feature.common``) and the text data path (``feature.text``)."""

from analytics_zoo_tpu_torch.feature.feature_set import normalize_labels

__all__ = ["normalize_labels"]
