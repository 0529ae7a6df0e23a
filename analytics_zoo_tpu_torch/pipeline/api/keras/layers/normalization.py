"""BatchNormalization, eval mode (port of
``analytics_zoo_tpu/pipeline/api/keras/layers/normalization.py``).

Moving statistics live in ``params["_state"]``. Eval folds
``(x - mean) * rsqrt(var + eps) * gamma + beta`` into per-channel
``(scale, shift)`` computed in f32 and applied in ``x.dtype`` (so in
bf16 this rounds at other places than the fused conv+BN kernels, whose
epilogue applies the fold in f32).
"""

from __future__ import annotations

import torch

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    TRAINING_NOT_PORTED, KerasLayer, Shape)


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
    """BatchNorm over the trailing (channel) axis; epsilon 1e-3."""

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 center: bool = True, scale: bool = True,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        self.center = center
        self.scale = scale

    def build(self, generator, input_shape: Shape) -> dict:
        n = input_shape[-1]
        params = {}
        if self.scale:
            params["gamma"] = torch.ones((n,))
        if self.center:
            params["beta"] = torch.zeros((n,))
        params["_state"] = {"moving_mean": torch.zeros((n,)),
                            "moving_var": torch.ones((n,))}
        return params

    def call(self, params, x, *, training=False):
        if training:
            raise NotImplementedError(TRAINING_NOT_PORTED)
        state = params["_state"]
        scale, shift = bn_fold(
            state["moving_mean"], state["moving_var"],
            params["gamma"] if self.scale else None,
            params["beta"] if self.center else None, self.epsilon)
        return x * scale.to(x.dtype) + shift.to(x.dtype)
