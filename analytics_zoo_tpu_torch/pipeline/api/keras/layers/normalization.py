"""BatchNormalization and LayerNormalization (port of
``analytics_zoo_tpu/pipeline/api/keras/layers/normalization.py``).

Moving statistics live in ``params["_state"]``; a training forward
returns their moving-average update through the second result of
:meth:`BatchNormalization.apply` (the engine's contract). Both modes
fold ``(x - mean) * rsqrt(var + eps) * gamma + beta`` into per-channel
``(scale, shift)`` computed in f32 and applied in ``x.dtype`` (so in
bf16 this rounds at other places than the fused conv+BN kernels, whose
epilogue applies the fold in f32).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, Shape)


def bn_batch_stats(ssum, ssq, count, state, momentum):
    """Batch mean/var from moving-mean-SHIFTED sums ``sum(x - mm)`` /
    ``sum((x - mm)^2)`` plus the moving-average update, the one copy of
    the scheme shared by :class:`BatchNormalization` and the fused ResNet
    bottleneck. The shift keeps E[x^2] - E[x]^2 from cancelling when
    |mean| >> std; the moving mean is frozen state, not differentiated."""
    mm = state["moving_mean"].detach()
    d_mean = ssum / count
    d_sq = ssq / count
    mean = d_mean + mm
    var = torch.clamp(d_sq - torch.square(d_mean), min=0.0)
    m = momentum
    updates = {"_state": {
        "moving_mean": m * state["moving_mean"] + (1 - m) * mean,
        "moving_var": m * state["moving_var"] + (1 - m) * var,
    }}
    return mean, var, updates


def bn_fold(mean, var, gamma, beta, epsilon):
    """Fold ``(x-mean)*rsqrt(var+eps)*gamma+beta`` into ``(scale,
    shift)`` for one FMA apply (``gamma``/``beta`` may be None)."""
    scale = torch.rsqrt(var + epsilon)
    if gamma is not None:
        scale = scale * gamma
    shift = -mean * scale
    if beta is not None:
        shift = shift + beta
    return scale, shift


class BatchNormalization(KerasLayer):
    """BatchNorm over the channel axis, the trailing one
    (``dim_ordering="tf"``) or axis 1 (``"th"``, as the importers build
    it); epsilon 1e-3."""

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 beta_init="zero", gamma_init="one", dim_ordering="tf",
                 center: bool = True, scale: bool = True,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        self.center = center
        self.scale = scale
        self.dim_ordering = dim_ordering

    def _feature_axis(self, ndim_with_batch: int) -> int:
        return ndim_with_batch - 1 if self.dim_ordering == "tf" else 1

    def _reshape_stat(self, stat, x):
        shape = [1] * x.dim()
        shape[self._feature_axis(x.dim())] = stat.shape[0]
        return stat.reshape(shape)

    def build(self, generator, input_shape: Shape) -> dict:
        n = input_shape[-1] if self.dim_ordering == "tf" else input_shape[0]
        params = {}
        if self.scale:
            params["gamma"] = torch.ones((n,))
        if self.center:
            params["beta"] = torch.zeros((n,))
        params["_state"] = {"moving_mean": torch.zeros((n,)),
                            "moving_var": torch.ones((n,))}
        return params

    def apply(self, params, x, *, training=False, rng=None):
        state = params["_state"]
        if training:
            # one pass over x for both sums, shifted by the moving mean
            axis = self._feature_axis(x.dim())
            dims = tuple(i for i in range(x.dim()) if i != axis)
            xf = x.float() - self._reshape_stat(
                state["moving_mean"].detach(), x)
            count = float(math.prod(x.shape[i] for i in dims))
            mean, var, updates = bn_batch_stats(
                xf.sum(dims), torch.square(xf).sum(dims), count, state,
                self.momentum)
        else:
            mean, var = state["moving_mean"], state["moving_var"]
            updates = {}
        scale, shift = bn_fold(
            mean, var, params["gamma"] if self.scale else None,
            params["beta"] if self.center else None, self.epsilon)
        return (x * self._reshape_stat(scale, x).to(x.dtype)
                + self._reshape_stat(shift, x).to(x.dtype)), updates

    def call(self, params, x, *, training=False, rng=None):
        return self.apply(params, x, training=training)[0]


def layer_norm(x: torch.Tensor, gamma: Optional[torch.Tensor],
               beta: Optional[torch.Tensor], eps: float = 1e-5
               ) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * gamma + beta`` over the last
    axis, rounded as JAX rounds it: mean and variance are taken in f32
    and cast to x's type (``jnp.mean``/``jnp.var`` upcast bf16), the
    rest runs in x's type."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True).to(x.dtype)
    var = xf.var(-1, correction=0, keepdim=True).to(x.dtype)
    y = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma.to(y.dtype)
    if beta is not None:
        y = y + beta.to(y.dtype)
    return y


class LayerNormalization(KerasLayer):
    """LayerNorm over the trailing axis (the internal norm of the
    transformer layers)."""

    def __init__(self, epsilon: float = 1e-5, center: bool = True,
                 scale: bool = True, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.epsilon = float(epsilon)
        self.center = center
        self.scale = scale

    def build(self, generator, input_shape: Shape) -> dict:
        n = input_shape[-1]
        params = {}
        if self.scale:
            params["gamma"] = torch.ones((n,))
        if self.center:
            params["beta"] = torch.zeros((n,))
        return params

    def call(self, params, x, *, training=False, rng=None):
        return layer_norm(x, params.get("gamma"), params.get("beta"),
                          self.epsilon)
