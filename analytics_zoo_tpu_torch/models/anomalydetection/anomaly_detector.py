"""AnomalyDetector (port of ``analytics_zoo_tpu/models/anomalydetection/
anomaly_detector.py``): a stacked-LSTM regressor over unrolled time
series, with ``unroll``'s windows and ``detect_anomalies``' threshold,
both numpy on the host as in the reference."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    LSTM, Dense, Dropout)
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential


@dataclass
class FeatureLabelIndex:
    """(reference case class `FeatureLabelIndex`)"""

    feature: np.ndarray
    label: float
    index: int


class AnomalyDetector(ZooModel):
    def __init__(self, feature_shape: Sequence[int],
                 hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2)):
        super().__init__()
        if len(hidden_layers) != len(dropouts):
            raise ValueError(
                "hidden_layers and dropouts must have equal length")
        self.feature_shape = tuple(int(d) for d in feature_shape)
        self.hidden_layers = tuple(int(h) for h in hidden_layers)
        self.dropouts = tuple(float(d) for d in dropouts)

    def hyper_parameters(self):
        return {"feature_shape": self.feature_shape,
                "hidden_layers": self.hidden_layers,
                "dropouts": self.dropouts}

    def build_model(self) -> Sequential:
        m = Sequential(name="anomaly_detector")
        for i, (h, d) in enumerate(zip(self.hidden_layers,
                                       self.dropouts)):
            m.add(LSTM(h, return_sequences=True,
                       input_shape=self.feature_shape if i == 0 else None))
            m.add(Dropout(d))
        m.add(LSTM(self.hidden_layers[-1], return_sequences=False))
        m.add(Dropout(self.dropouts[-1]))
        m.add(Dense(1))
        return m

    # -- data prep ----------------------------------------------------------
    @staticmethod
    def unroll(data: np.ndarray, unroll_length: int,
               predict_step: int = 1
               ) -> "list[FeatureLabelIndex]":
        """Sliding windows: feature = data[i : i+unroll_length], label =
        data[i + unroll_length + predict_step - 1][0]."""
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[:, None]
        out = []
        n = len(data)
        last = n - unroll_length - predict_step + 1
        for i in range(max(last, 0)):
            feature = data[i:i + unroll_length]
            label = float(data[i + unroll_length + predict_step - 1][0])
            out.append(FeatureLabelIndex(feature, label, i))
        return out

    @staticmethod
    def to_arrays(indexed: "list[FeatureLabelIndex]"
                  ) -> "tuple[np.ndarray, np.ndarray]":
        x = np.stack([f.feature for f in indexed])
        y = np.asarray([[f.label] for f in indexed], np.float32)
        return x, y

    # -- detection ----------------------------------------------------------
    @staticmethod
    def detect_anomalies(y_truth: np.ndarray, y_predict: np.ndarray,
                         anomaly_size: int = 5
                         ) -> "tuple[np.ndarray, np.ndarray]":
        """Top-`anomaly_size` absolute errors are anomalies; returns
        (anomaly_indices, threshold)."""
        yt = np.asarray(y_truth).reshape(-1)
        yp = np.asarray(y_predict).reshape(-1)
        err = np.abs(yt - yp)
        if anomaly_size >= len(err):
            threshold = -np.inf
        else:
            threshold = np.partition(err, -anomaly_size)[-anomaly_size]
        idx = np.flatnonzero(err >= threshold)
        return idx, threshold
