"""Weight initializers by Keras name, on an explicit ``torch.Generator``
(port of ``analytics_zoo_tpu/ops/initializers.py``). Fans follow
``jax.nn.initializers``: the last axis is the output, the one before it
the input, and every leading axis is receptive field (HWIO conv
kernels: fan_in = kh*kw*I, fan_out = kh*kw*O).

The draws differ from JAX's (another generator); the distributions are
the same. ``glorot_normal``, ``he_normal`` and ``lecun_normal`` are
``jax.nn.initializers.variance_scaling`` with a normal truncated at two
standard deviations and its scale corrected for the truncation (not
``torch.nn.init``'s untruncated ``*_normal_``)."""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Initializer = Callable[..., torch.Tensor]

# the standard deviation of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def _fans(shape: Sequence[int]):
    if len(shape) < 2:
        n = shape[0] if shape else 1
        return n, n
    rf = math.prod(shape[:-2])
    return shape[-2] * rf, shape[-1] * rf


def _uniform(generator, shape, limit) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return (u * 2.0 - 1.0) * limit


def _truncated_normal(generator, shape) -> torch.Tensor:
    """Standard normal draws truncated to (-2, 2), by inverting the
    CDF of a uniform over [cdf(-2), cdf(2)] (``jax.random.
    truncated_normal``'s method)."""
    lo, hi = (math.erf(b / math.sqrt(2.0)) for b in (-2.0, 2.0))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(lo + u * (hi - lo))
    return x.clamp(-2.0, 2.0).float()


def _variance_scaling(scale: float, mode: str, distribution: str):
    def init(generator: torch.Generator, shape,
             dtype=torch.float32) -> torch.Tensor:
        fan_in, fan_out = _fans(tuple(shape))
        n = {"fan_in": fan_in, "fan_avg": (fan_in + fan_out) / 2}[mode]
        variance = scale / n
        if distribution == "uniform":
            w = _uniform(generator, shape, math.sqrt(3.0 * variance))
        else:
            w = _truncated_normal(generator, shape) * (
                math.sqrt(variance) / _TRUNC_STD)
        return w.to(dtype)
    return init


def glorot_uniform(generator: torch.Generator, shape,
                   dtype=torch.float32) -> torch.Tensor:
    """U(-limit, limit), ``limit = sqrt(6 / (fan_in + fan_out))``."""
    fan_in, fan_out = _fans(tuple(shape))
    return _uniform(generator, shape,
                    math.sqrt(6.0 / (fan_in + fan_out))).to(dtype)


glorot_normal = _variance_scaling(1.0, "fan_avg", "truncated_normal")
he_uniform = _variance_scaling(2.0, "fan_in", "uniform")
he_normal = _variance_scaling(2.0, "fan_in", "truncated_normal")
lecun_uniform = _variance_scaling(1.0, "fan_in", "uniform")
lecun_normal = _variance_scaling(1.0, "fan_in", "truncated_normal")


def uniform(generator: torch.Generator, shape,
            dtype=torch.float32) -> torch.Tensor:
    """U(-0.05, 0.05) (Keras-1's ``uniform``; Embedding's default)."""
    return _uniform(generator, shape, 0.05).to(dtype)


def normal(generator: torch.Generator, shape,
           dtype=torch.float32) -> torch.Tensor:
    """N(0, 0.05^2)."""
    return (torch.randn(tuple(shape), generator=generator,
                        dtype=torch.float32) * 0.05).to(dtype)


def orthogonal(generator: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    """A uniformly distributed orthogonal matrix over the last axis
    (``jax.nn.initializers.orthogonal``: QR of a normal draw, the
    columns' signs set by R's diagonal)."""
    shape = tuple(shape)
    if len(shape) < 2:
        raise ValueError("orthogonal initializer requires at least a 2D "
                         "shape")
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    z = torch.randn((max(n_rows, n_cols), min(n_rows, n_cols)),
                    generator=generator, dtype=torch.float32)
    q, r = torch.linalg.qr(z)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if n_rows < n_cols:
        q = q.T
    return q.reshape(shape).to(dtype)


def identity(generator: torch.Generator, shape,
             dtype=torch.float32) -> torch.Tensor:
    if len(shape) != 2 or shape[0] != shape[1]:
        raise ValueError("identity init requires a square 2D shape, "
                         f"got {tuple(shape)}")
    return torch.eye(shape[0], dtype=dtype)


def zero(generator: torch.Generator, shape,
         dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype)


def one(generator: torch.Generator, shape,
        dtype=torch.float32) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype)


_REGISTRY = {
    "glorot_uniform": glorot_uniform,
    "glorot_normal": glorot_normal,
    "xavier": glorot_uniform,
    "he_uniform": he_uniform,
    "he_normal": he_normal,
    "lecun_uniform": lecun_uniform,
    "lecun_normal": lecun_normal,
    "orthogonal": orthogonal,
    "uniform": uniform,
    "normal": normal,
    "zero": zero,
    "zeros": zero,
    "one": one,
    "ones": one,
    "identity": identity,
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
