"""Keras-style layers of the port."""

from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import (
    Conv1D, Conv2D, Convolution1D, Convolution2D, DepthwiseConvolution2D)
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
    AveragePooling1D, AveragePooling2D, AveragePooling3D,
    GlobalAveragePooling1D, GlobalAveragePooling2D, GlobalAveragePooling3D,
    GlobalMaxPooling1D, GlobalMaxPooling2D, GlobalMaxPooling3D, MaxPooling1D,
    MaxPooling2D, MaxPooling3D)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.recurrent import (
    GRU, LSTM, Bidirectional, SimpleRNN, TimeDistributed)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.transformer import (
    BERT, MultiHeadAttention, TransformerLayer)

__all__ = ["Activation", "Add", "Average", "AveragePooling1D",
           "AveragePooling2D", "AveragePooling3D", "BatchNormalization",
           "BERT", "Bidirectional", "Concatenate", "Conv1D", "Conv2D",
           "Convolution1D", "Convolution2D", "Dense",
           "DepthwiseConvolution2D", "Dot", "Dropout", "Embedding",
           "ExpandDim", "Flatten", "GlobalAveragePooling1D",
           "GlobalAveragePooling2D", "GlobalAveragePooling3D",
           "GlobalMaxPooling1D", "GlobalMaxPooling2D", "GlobalMaxPooling3D",
           "GRU", "LayerNormalization", "LSTM", "Masking", "MaxPooling1D",
           "MaxPooling2D", "MaxPooling3D", "Maximum", "Merge", "Minimum",
           "MultiHeadAttention", "Multiply", "Narrow", "Permute",
           "RepeatVector", "Reshape", "Select", "SimpleRNN", "Squeeze",
           "TimeDistributed", "TransformerLayer", "WordEmbedding", "merge"]
