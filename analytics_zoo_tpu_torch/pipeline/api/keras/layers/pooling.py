"""MaxPooling2D and GlobalAveragePooling2D over NHWC input (port of
``analytics_zoo_tpu/pipeline/api/keras/layers/pooling.py``). A SAME max
pool pads with -inf, TF-style (3x3/s2 on 112 pads (0, 1)), and its
backward splits the cotangent among tied maxima (``ops.pool_grad``)."""

from __future__ import annotations

from analytics_zoo_tpu_torch.ops import pool_grad
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, Shape)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import (
    _conv_out_len, _norm_tuple)


class MaxPooling2D(KerasLayer):
    def __init__(self, pool_size=2, strides=None, border_mode="valid",
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.pool_size = _norm_tuple(pool_size, 2, "pool_size")
        self.strides = (self.pool_size if strides is None
                        else _norm_tuple(strides, 2, "strides"))
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode must be valid|same, "
                             f"got {border_mode}")
        self.border_mode = border_mode

    def call(self, params, x, *, training=False, rng=None):
        return pool_grad.maxpool2d(x, self.pool_size, self.strides,
                                   self.border_mode)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        out = tuple(_conv_out_len(s, k, st, self.border_mode)
                    for s, k, st in zip(input_shape[:2], self.pool_size,
                                        self.strides))
        return out + tuple(input_shape[2:])


class GlobalAveragePooling2D(KerasLayer):
    def call(self, params, x, *, training=False, rng=None):
        return x.mean(dim=(1, 2))

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return (input_shape[-1],)
