"""Keras-style layers of the port."""

from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import \
    Convolution2D
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import (
    Activation, Dense, Dropout, ExpandDim, Flatten, Masking, Narrow, Permute,
    RepeatVector, Reshape, Select, Squeeze)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.embedding import (
    Embedding, WordEmbedding)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.merge import (
    Add, Average, Concatenate, Dot, Maximum, Merge, Minimum, Multiply, merge)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.normalization \
    import BatchNormalization, LayerNormalization
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.pooling import (
    GlobalAveragePooling2D, MaxPooling2D)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.transformer import (
    BERT, MultiHeadAttention, TransformerLayer)

__all__ = ["Activation", "Add", "Average", "BatchNormalization", "BERT",
           "Concatenate", "Convolution2D", "Dense", "Dot", "Dropout",
           "Embedding", "ExpandDim", "Flatten", "GlobalAveragePooling2D",
           "LayerNormalization", "Masking", "MaxPooling2D", "Maximum",
           "Merge", "Minimum", "MultiHeadAttention", "Multiply", "Narrow",
           "Permute", "RepeatVector", "Reshape", "Select", "Squeeze",
           "TransformerLayer", "WordEmbedding", "merge"]
