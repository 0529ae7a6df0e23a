"""Pooling layers: max and average pooling in 1, 2 and 3 dimensions and
their global variants (port of
``analytics_zoo_tpu/pipeline/api/keras/layers/pooling.py``).

Input is channels-last (``dim_ordering="tf"``, the default) or
channels-first (``"th"``). A NHWC float 2-D max pool goes through
``ops.pool_grad.maxpool2d``: SAME pads with -inf, TF-style (3x3/s2 on
112 pads (0, 1)), and its backward splits the cotangent among tied
maxima, as the reference's mask backward does. Every other pool pads
explicitly to TF's SAME (the odd extra row or column at the high end,
which PyTorch's symmetric ``padding=`` cannot express) and runs
PyTorch's pooling over a channels-first view. A SAME average divides
each window's sum by the count of its real, unpadded cells, pooled from
ones, as the reference does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.ops import pool_grad
from analytics_zoo_tpu_torch.ops.conv_bn import tf_same_pads
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, Shape)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.conv import (
    _conv_out_len, _norm_tuple)

_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _same_pad(x, window, strides, value):
    """Pad the trailing ``len(window)`` dims of ``x`` to TF's SAME."""
    pads = []
    for n, k, s in zip(reversed(x.shape[-len(window):]), reversed(window),
                       reversed(strides)):
        lo, hi, _ = tf_same_pads(n, k, s)
        pads += [lo, hi]
    return F.pad(x, pads, value=value)


class _PoolND(KerasLayer):
    ndim = 2
    mode = "max"  # or "avg"

    def __init__(self, pool_size=2, strides=None, border_mode="valid",
                 dim_ordering="tf", input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        n = self.ndim
        self.pool_size = _norm_tuple(pool_size, n, "pool_size")
        self.strides = (self.pool_size if strides is None
                        else _norm_tuple(strides, n, "strides"))
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode must be valid|same, "
                             f"got {border_mode}")
        self.border_mode = border_mode
        self.dim_ordering = dim_ordering

    def _pool(self, x):
        """Pool the trailing ``ndim`` dims of channels-first ``x``; a 1-D
        pool runs as a 2-D one over a unit row."""
        window, strides = self.pool_size, self.strides
        if self.ndim == 1:
            x, window, strides = x.unsqueeze(-2), (1,) + window, \
                (1,) + strides
        rank = len(window)
        if self.mode == "max":
            if self.border_mode == "same":
                fill = (float("-inf") if x.is_floating_point()
                        else torch.iinfo(x.dtype).min)
                x = _same_pad(x, window, strides, fill)
            y = _MAX_POOL[rank](x, window, strides)
        elif self.border_mode == "valid":
            y = _AVG_POOL[rank](x, window, strides, divisor_override=1) \
                / float(math.prod(window))
        else:
            # the count of real cells in each window, pooled from ones
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            summed = _AVG_POOL[rank](_same_pad(x, window, strides, 0.0),
                                     window, strides, divisor_override=1)
            counts = _AVG_POOL[rank](_same_pad(ones, window, strides, 0.0),
                                     window, strides, divisor_override=1)
            y = summed / counts
        return y.squeeze(-2) if self.ndim == 1 else y

    def call(self, params, x, *, training=False, rng=None):
        if self.dim_ordering == "th":
            return self._pool(x)
        if (self.mode == "max" and self.ndim == 2
                and x.is_floating_point()):
            return pool_grad.maxpool2d(x, self.pool_size, self.strides,
                                       self.border_mode)
        last = x.dim() - 1
        y = self._pool(x.permute(0, last, *range(1, last)))
        return y.permute(0, *range(2, y.dim()), 1).contiguous()

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        n = self.ndim
        if self.dim_ordering == "tf":
            spatial, ch = input_shape[:n], input_shape[n:]
        else:
            ch, spatial = input_shape[:1], input_shape[1:1 + n]
        out_sp = tuple(_conv_out_len(s, k, st, self.border_mode)
                       for s, k, st in zip(spatial, self.pool_size,
                                           self.strides))
        return out_sp + ch if self.dim_ordering == "tf" else ch + out_sp


class MaxPooling1D(_PoolND):
    ndim, mode = 1, "max"

    def __init__(self, pool_length=2, stride=None, **kwargs):
        kwargs.setdefault("strides", stride)
        super().__init__(pool_size=pool_length, **kwargs)


class AveragePooling1D(_PoolND):
    ndim, mode = 1, "avg"

    def __init__(self, pool_length=2, stride=None, **kwargs):
        kwargs.setdefault("strides", stride)
        super().__init__(pool_size=pool_length, **kwargs)


class MaxPooling2D(_PoolND):
    ndim, mode = 2, "max"


class AveragePooling2D(_PoolND):
    ndim, mode = 2, "avg"


class MaxPooling3D(_PoolND):
    ndim, mode = 3, "max"


class AveragePooling3D(_PoolND):
    ndim, mode = 3, "avg"


class _GlobalPoolND(KerasLayer):
    ndim = 2
    mode = "max"

    def __init__(self, dim_ordering="tf", input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.dim_ordering = dim_ordering

    def _axes(self):
        if self.dim_ordering == "tf":
            return tuple(range(1, 1 + self.ndim))
        return tuple(range(2, 2 + self.ndim))

    def call(self, params, x, *, training=False, rng=None):
        if self.mode == "max":
            return x.amax(dim=self._axes())
        return x.mean(dim=self._axes())

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        if self.dim_ordering == "tf":
            return (input_shape[-1],)
        return (input_shape[0],)


class GlobalMaxPooling1D(_GlobalPoolND):
    ndim, mode = 1, "max"


class GlobalAveragePooling1D(_GlobalPoolND):
    ndim, mode = 1, "avg"


class GlobalMaxPooling2D(_GlobalPoolND):
    ndim, mode = 2, "max"


class GlobalAveragePooling2D(_GlobalPoolND):
    ndim, mode = 2, "avg"


class GlobalMaxPooling3D(_GlobalPoolND):
    ndim, mode = 3, "max"


class GlobalAveragePooling3D(_GlobalPoolND):
    ndim, mode = 3, "avg"
