"""Data ingestion (port of ``analytics_zoo_tpu/feature``): so far the
label rule the Estimator reads its labels by."""

from analytics_zoo_tpu_torch.feature.feature_set import normalize_labels

__all__ = ["normalize_labels"]
