"""Weight initializers by Keras name, on an explicit ``torch.Generator``
(port of ``analytics_zoo_tpu/ops/initializers.py``, the names the
ResNet slice uses). Fans follow ``jax.nn.initializers``: the last axis
is the output, the one before it the input, and every leading axis is
receptive field (HWIO conv kernels: fan_in = kh*kw*I, fan_out =
kh*kw*O)."""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Initializer = Callable[..., torch.Tensor]


def _fans(shape: Sequence[int]):
    if len(shape) < 2:
        n = shape[0] if shape else 1
        return n, n
    rf = math.prod(shape[:-2])
    return shape[-2] * rf, shape[-1] * rf


def glorot_uniform(generator: torch.Generator, shape,
                   dtype=torch.float32) -> torch.Tensor:
    """U(-limit, limit), ``limit = sqrt(6 / (fan_in + fan_out))``."""
    fan_in, fan_out = _fans(tuple(shape))
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * limit).to(dtype)


def zero(generator: torch.Generator, shape,
         dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype)


def one(generator: torch.Generator, shape,
        dtype=torch.float32) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype)


_REGISTRY = {
    "glorot_uniform": glorot_uniform,
    "xavier": glorot_uniform,
    "zero": zero,
    "zeros": zero,
    "one": one,
    "ones": one,
}


def get(name: "str | Initializer | None") -> Initializer:
    """Resolve an initializer by Keras name (or pass a callable
    through); ``None`` is ``glorot_uniform``."""
    if name is None:
        return glorot_uniform
    if callable(name):
        return name
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown initializer '{name}'; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]
