"""Keras-style layers of the port."""

from analytics_zoo_tpu_torch.pipeline.api.keras.layers.advanced_activations \
    import ELU, PReLU, LeakyReLU, Softmax, SReLU, ThresholdedReLU
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import (
    Conv1D, Conv2D, Convolution1D, Convolution2D, Cropping1D, Cropping2D,
    DepthwiseConvolution2D, UpSampling1D, UpSampling2D, UpSampling3D,
    ZeroPadding1D, ZeroPadding2D)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import (
    Activation, Dense, Dropout, ExpandDim, Flatten, Masking, Narrow, Permute,
    RepeatVector, Reshape, Select, Squeeze)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.elementwise import (
    AddConstant, BinaryThreshold, CAdd, CMul, Exp, Expand, GaussianSampler,
    GetShape, HardShrink, HardTanh, Highway, Identity, KerasLayerWrapper, Log,
    Max, MaxoutDense, Mul, MulConstant, Negative, Power, ResizeBilinear,
    RReLU, Scale, SelectTable, SoftShrink, SplitTensor, Sqrt, Square,
    Threshold)
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

__all__ = ["Activation", "Add", "AddConstant", "Average", "AveragePooling1D",
           "AveragePooling2D", "AveragePooling3D", "BatchNormalization",
           "BERT", "Bidirectional", "BinaryThreshold", "CAdd", "CMul",
           "Concatenate", "Conv1D", "Conv2D", "Convolution1D",
           "Convolution2D", "Cropping1D", "Cropping2D", "Dense",
           "DepthwiseConvolution2D", "Dot", "Dropout", "ELU", "Embedding",
           "Exp", "Expand", "ExpandDim", "Flatten", "GaussianSampler",
           "GetShape", "GlobalAveragePooling1D", "GlobalAveragePooling2D",
           "GlobalAveragePooling3D", "GlobalMaxPooling1D",
           "GlobalMaxPooling2D", "GlobalMaxPooling3D", "GRU", "HardShrink",
           "HardTanh", "Highway", "Identity", "KerasLayerWrapper",
           "LayerNormalization", "LeakyReLU", "Log", "LSTM", "Masking", "Max",
           "MaxoutDense", "MaxPooling1D", "MaxPooling2D", "MaxPooling3D",
           "Maximum", "Merge", "Minimum", "Mul", "MulConstant",
           "MultiHeadAttention", "Multiply", "Narrow", "Negative", "Permute",
           "Power", "PReLU", "RepeatVector", "Reshape", "ResizeBilinear",
           "RReLU", "Scale", "Select", "SelectTable", "SimpleRNN", "Softmax",
           "SoftShrink", "SplitTensor", "Sqrt", "Square", "Squeeze", "SReLU",
           "Threshold", "ThresholdedReLU", "TimeDistributed",
           "TransformerLayer", "UpSampling1D", "UpSampling2D", "UpSampling3D",
           "WordEmbedding", "ZeroPadding1D", "ZeroPadding2D", "merge"]
