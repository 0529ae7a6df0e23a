"""Core layers: Dense, Activation, Dropout and the reshape family (port
of ``analytics_zoo_tpu/pipeline/api/keras/layers/core.py``). Where a
layer takes a ``dim``, it counts from 1 over the non-batch axes, as the
reference's ``compute_output_shape`` does."""

from __future__ import annotations

import math

import torch

from analytics_zoo_tpu_torch.ops import (activations, initializers,
                                         regularizers, rng)
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, Shape)


class Dense(KerasLayer):
    """Fully-connected layer over the last axis; kernel ``(in, out)``,
    cast to the input's dtype."""

    def __init__(self, output_dim: int, init="glorot_uniform",
                 activation=None, w_regularizer=None, b_regularizer=None,
                 bias: bool = True, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.output_dim = int(output_dim)
        self.kernel_init = initializers.get(init)
        self.activation = activations.get(activation)
        self.w_regularizer = regularizers.get(w_regularizer)
        self.b_regularizer = regularizers.get(b_regularizer)
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

    def regularizers(self):
        out = []
        if self.w_regularizer is not None:
            out.append(("kernel", self.w_regularizer))
        if self.b_regularizer is not None:
            out.append(("bias", self.b_regularizer))
        return out


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


class Reshape(KerasLayer):
    """Reshape the non-batch dims; one dim may be -1."""

    def __init__(self, target_shape, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.target_shape = tuple(int(d) for d in target_shape)

    def _resolve(self, input_shape: Shape) -> Shape:
        total = math.prod(input_shape)
        tgt = list(self.target_shape)
        if -1 in tgt:
            known = math.prod(d for d in tgt if d != -1)
            if known == 0 or total % known != 0:
                raise ValueError(
                    f"{self.name}: cannot reshape {tuple(input_shape)} to "
                    f"{self.target_shape}")
            tgt[tgt.index(-1)] = total // known
        return tuple(tgt)

    def call(self, params, x, *, training=False, rng=None):
        return x.reshape((x.shape[0],) + self._resolve(tuple(x.shape[1:])))

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return self._resolve(input_shape)


class Permute(KerasLayer):
    """Permute the non-batch dims (``dims`` from 1, as in Keras)."""

    def __init__(self, dims, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.dims = tuple(int(d) for d in dims)

    def call(self, params, x, *, training=False, rng=None):
        return x.permute((0,) + self.dims)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return tuple(input_shape[d - 1] for d in self.dims)


class RepeatVector(KerasLayer):
    """(F,) -> (n, F)."""

    def __init__(self, n: int, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.n = int(n)

    def call(self, params, x, *, training=False, rng=None):
        return x[:, None, :].expand(-1, self.n, -1)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return (self.n, input_shape[0])


class Squeeze(KerasLayer):
    """Remove the size-1 non-batch dim ``dim``."""

    def __init__(self, dim: int, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.dim = int(dim)

    def call(self, params, x, *, training=False, rng=None):
        if x.shape[self.dim] != 1:
            raise ValueError(f"{self.name}: dim {self.dim} of "
                             f"{tuple(x.shape[1:])} is not 1")
        return x.squeeze(self.dim)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        shape = list(input_shape)
        if shape[self.dim - 1] != 1:
            raise ValueError(f"{self.name}: dim {self.dim} of "
                             f"{tuple(input_shape)} is not 1")
        del shape[self.dim - 1]
        return tuple(shape)


class ExpandDim(KerasLayer):
    """Insert a size-1 dim at non-batch position ``dim``."""

    def __init__(self, dim: int, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.dim = int(dim)

    def call(self, params, x, *, training=False, rng=None):
        return x.unsqueeze(self.dim)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        shape = list(input_shape)
        shape.insert(self.dim - 1, 1)
        return tuple(shape)


class Narrow(KerasLayer):
    """``length`` elements from ``offset`` along non-batch dim ``dim``
    (``jax.lax.slice_in_dim``: a negative offset, or end, counts from
    the end of the axis)."""

    def __init__(self, dim: int, offset: int, length: int = 1,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.dim = int(dim)
        self.offset = int(offset)
        self.length = int(length)

    def call(self, params, x, *, training=False, rng=None):
        n = x.shape[self.dim]
        start, end = self.offset, self.offset + self.length
        start, end = (start + n if start < 0 else start,
                      end + n if end < 0 else end)
        return x[(slice(None),) * self.dim + (slice(start, end),)]

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        shape = list(input_shape)
        shape[self.dim - 1] = self.length
        return tuple(shape)


class Select(KerasLayer):
    """Index ``index`` of non-batch dim ``dim``, the dim removed (a
    negative index counts from the end)."""

    def __init__(self, dim: int, index: int, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.dim = int(dim)
        self.index = int(index)

    def call(self, params, x, *, training=False, rng=None):
        return x.select(self.dim, self.index)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        shape = list(input_shape)
        del shape[self.dim - 1]
        return tuple(shape)


class Masking(KerasLayer):
    """Zero the timesteps whose features all equal ``mask_value`` (no
    mask travels downstream: later layers see zeros)."""

    def __init__(self, mask_value: float = 0.0, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.mask_value = float(mask_value)

    def call(self, params, x, *, training=False, rng=None):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return torch.where(keep, x, torch.zeros_like(x))
