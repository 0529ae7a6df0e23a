"""Core layers: Dense, Activation, Dropout, Flatten (port of
``analytics_zoo_tpu/pipeline/api/keras/layers/core.py``)."""

from __future__ import annotations

import math

import torch

from analytics_zoo_tpu_torch.ops import activations, initializers, rng
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, Shape)


class Dense(KerasLayer):
    """Fully-connected layer over the last axis; kernel ``(in, out)``,
    cast to the input's dtype."""

    def __init__(self, output_dim: int, init="glorot_uniform",
                 activation=None, bias: bool = True, input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.output_dim = int(output_dim)
        self.kernel_init = initializers.get(init)
        self.activation = activations.get(activation)
        self.use_bias = bool(bias)

    def build(self, generator, input_shape: Shape) -> dict:
        params = {"kernel": self.kernel_init(
            generator, (input_shape[-1], self.output_dim))}
        if self.use_bias:
            params["bias"] = torch.zeros((self.output_dim,))
        return params

    def call(self, params, x, *, training=False, rng=None):
        y = torch.matmul(x, params["kernel"].to(x.dtype))
        if self.use_bias:
            y = y + params["bias"].to(y.dtype)
        if self.activation is not None:
            y = self.activation(y)
        return y

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return tuple(input_shape[:-1]) + (self.output_dim,)


class Activation(KerasLayer):
    """Standalone activation layer."""

    def __init__(self, activation, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.activation = activations.get(activation) or activations.linear

    def call(self, params, x, *, training=False, rng=None):
        return self.activation(x)


class Dropout(KerasLayer):
    """Inverted dropout. In training it draws its mask from a generator
    built from the seed the container hands it (``ops/rng.py``)."""

    def __init__(self, p: float, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.p = float(p)

    def call(self, params, x, *, training=False, rng=None):
        if not training or self.p <= 0.0:
            return x
        if rng is None:
            raise ValueError(f"{self.name}: dropout needs an rng in "
                             "training mode")
        return dropout(x, self.p, rng)


def dropout(x: torch.Tensor, p: float, seed: int) -> torch.Tensor:
    """``x / (1 - p)`` where a uniform draw from ``seed``'s generator is
    below ``1 - p``, else 0."""
    keep = 1.0 - p
    u = torch.rand(x.shape, generator=rng.generator(seed, x.device),
                   device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


class Flatten(KerasLayer):
    """Flatten all non-batch dims."""

    def call(self, params, x, *, training=False, rng=None):
        return x.reshape(x.shape[0], -1)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return (math.prod(input_shape),)
