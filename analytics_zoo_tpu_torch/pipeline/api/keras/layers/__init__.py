"""Keras-style layers of the port (the ones the ResNet slice runs)."""

from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import \
    Convolution2D
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import (
    Activation, Dense, Flatten)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.merge import Add
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.normalization \
    import BatchNormalization
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.pooling import (
    GlobalAveragePooling2D, MaxPooling2D)

__all__ = ["Activation", "Add", "BatchNormalization", "Convolution2D",
           "Dense", "Flatten", "GlobalAveragePooling2D", "MaxPooling2D"]
