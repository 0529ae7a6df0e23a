"""Merge layers, combining several inputs (port of
``analytics_zoo_tpu/pipeline/api/keras/layers/merge.py``): ``Merge``
with the modes sum, sub, mul, concat, ave, cos, dot, max and min, the
``merge()`` helper, and the Keras-2 style aliases ``Add``, ``Multiply``,
``Average``, ``Maximum``, ``Minimum``, ``Concatenate`` and ``Dot``."""

from __future__ import annotations

import torch

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, Shape, ShapeLike)

_MODES = ("sum", "sub", "mul", "concat", "ave", "cos", "dot", "max",
          "min")
_FOLDS = {"sum": torch.add, "sub": torch.sub, "mul": torch.mul,
          "ave": torch.add, "max": torch.maximum, "min": torch.minimum}


class Merge(KerasLayer):
    """Combine two or more inputs by ``mode``. ``concat_axis`` counts
    the batch axis (Keras): -1, or from 1 over the non-batch axes;
    ``dot`` and ``cos`` take two inputs, flattened per row, to (B, 1)."""

    def __init__(self, mode: str = "sum", concat_axis: int = -1,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        if mode not in _MODES:
            raise ValueError(f"merge mode must be one of {_MODES}")
        self.mode = mode
        self.concat_axis = int(concat_axis)

    def call(self, params, inputs, *, training=False, rng=None):
        xs = list(inputs)
        if len(xs) < 2:
            raise ValueError(f"{self.name}: merge needs >= 2 inputs")
        m = self.mode
        if m in _FOLDS:
            out = xs[0]
            for x in xs[1:]:
                out = _FOLDS[m](out, x)
            return out / float(len(xs)) if m == "ave" else out
        if m == "concat":
            return torch.cat(xs, dim=self.concat_axis)
        a = xs[0].reshape(xs[0].shape[0], -1)
        b = xs[1].reshape(xs[1].shape[0], -1)
        dot = torch.sum(a * b, dim=-1, keepdim=True)
        if m == "dot":
            return dot
        na = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
        nb = torch.linalg.vector_norm(b, dim=-1, keepdim=True)
        return dot / torch.clamp(na * nb, min=1e-12)

    def compute_output_shape(self, input_shape: ShapeLike) -> Shape:
        shapes = [tuple(s) for s in input_shape]
        if self.mode in _FOLDS:
            return shapes[0]
        if self.mode == "concat":
            axis = self.concat_axis
            out = list(shapes[0])
            idx = axis - 1 if axis > 0 else len(out) + axis \
                if axis < 0 else 0
            out[idx] = sum(s[idx] for s in shapes)
            return tuple(out)
        return (1,)


def merge(inputs, mode="sum", concat_axis=-1, name=None):
    """Functional helper: ``merge([a, b], mode="concat")``."""
    return Merge(mode=mode, concat_axis=concat_axis, name=name)(inputs)


class _MergeAlias(Merge):
    _mode = "sum"

    def __init__(self, input_shape=None, name=None, **kwargs):
        super().__init__(mode=self._mode, input_shape=input_shape,
                         name=name, **kwargs)


class Add(_MergeAlias):
    """Elementwise sum of two or more inputs."""
    _mode = "sum"


class Multiply(_MergeAlias):
    _mode = "mul"


class Average(_MergeAlias):
    _mode = "ave"


class Maximum(_MergeAlias):
    _mode = "max"


class Minimum(_MergeAlias):
    _mode = "min"


class Concatenate(Merge):
    def __init__(self, axis=-1, input_shape=None, name=None, **kwargs):
        super().__init__(mode="concat", concat_axis=axis,
                         input_shape=input_shape, name=name, **kwargs)


class Dot(Merge):
    def __init__(self, input_shape=None, name=None, **kwargs):
        super().__init__(mode="dot", input_shape=input_shape, name=name,
                         **kwargs)
