"""Model-zoo base class (port of the serving subset of
``analytics_zoo_tpu/models/common.py``): hyperparameters, a lazily built
net, predict. Persistence and training come with later slices."""

from __future__ import annotations

from typing import Optional

import numpy as np

from analytics_zoo_tpu_torch.pipeline.api.keras.models import KerasNet


class ZooModel:
    """Container for a built-in model: holds hyperparameters and builds
    the net on first use."""

    def __init__(self):
        self._model: Optional[KerasNet] = None

    def build_model(self) -> KerasNet:
        raise NotImplementedError

    def hyper_parameters(self) -> dict:
        """Constructor kwargs needed to rebuild this model."""
        return {}

    @property
    def model(self) -> KerasNet:
        if self._model is None:
            self._model = self.build_model()
        return self._model

    def predict(self, x, batch_size: int = 32) -> np.ndarray:
        return self.model.predict(x, batch_size=batch_size)

    def predict_classes(self, x, batch_size: int = 32,
                        zero_based_label: bool = True) -> np.ndarray:
        return self.model.predict_classes(
            x, batch_size=batch_size, zero_based_label=zero_based_label)
