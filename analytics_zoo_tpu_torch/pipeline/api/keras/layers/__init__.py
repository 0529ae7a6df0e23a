"""Keras-style layers of the port (the ones the ResNet and BERT slices
run)."""

from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import \
    Convolution2D
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import (
    Activation, Dense, Dropout, Flatten)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.merge import Add
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.normalization \
    import BatchNormalization, LayerNormalization
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.pooling import (
    GlobalAveragePooling2D, MaxPooling2D)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.transformer import (
    BERT, MultiHeadAttention, TransformerLayer)

__all__ = ["Activation", "Add", "BatchNormalization", "BERT",
           "Convolution2D", "Dense", "Dropout", "Flatten",
           "GlobalAveragePooling2D", "LayerNormalization", "MaxPooling2D",
           "MultiHeadAttention", "TransformerLayer"]
