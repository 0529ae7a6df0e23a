"""Anomaly detection of the port: the stacked-LSTM AnomalyDetector."""

from analytics_zoo_tpu_torch.models.anomalydetection.anomaly_detector \
    import AnomalyDetector, FeatureLabelIndex

__all__ = ["AnomalyDetector", "FeatureLabelIndex"]
