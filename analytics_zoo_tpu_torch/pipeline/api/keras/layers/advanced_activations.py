"""Advanced activation layers: LeakyReLU, ELU, ThresholdedReLU, PReLU,
SReLU and Softmax (port of
``analytics_zoo_tpu/pipeline/api/keras/layers/advanced_activations.py``).
PReLU's and SReLU's learnable vectors run over the trailing (feature)
axis and are cast to the input's dtype, as the reference casts them."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, Shape)


class LeakyReLU(KerasLayer):
    def __init__(self, alpha: float = 0.3, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.alpha = float(alpha)

    def call(self, params, x, *, training=False, rng=None):
        return torch.where(x >= 0, x, self.alpha * x)


class ELU(KerasLayer):
    def __init__(self, alpha: float = 1.0, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.alpha = float(alpha)

    def call(self, params, x, *, training=False, rng=None):
        return F.elu(x, alpha=self.alpha)


class ThresholdedReLU(KerasLayer):
    def __init__(self, theta: float = 1.0, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.theta = float(theta)

    def call(self, params, x, *, training=False, rng=None):
        return torch.where(x > self.theta, x, torch.zeros_like(x))


class PReLU(KerasLayer):
    """Learnable leak, one alpha per feature (trailing axis)."""

    def build(self, generator, input_shape: Shape) -> dict:
        return {"alpha": torch.full((input_shape[-1],), 0.25)}

    def call(self, params, x, *, training=False, rng=None):
        return torch.where(x >= 0, x, params["alpha"].to(x.dtype) * x)


class SReLU(KerasLayer):
    """S-shaped ReLU with learnable thresholds and slopes per feature."""

    def build(self, generator, input_shape: Shape) -> dict:
        n = input_shape[-1]
        return {"t_right": torch.ones((n,)), "a_right": torch.ones((n,)),
                "t_left": torch.zeros((n,)), "a_left": torch.zeros((n,))}

    def call(self, params, x, *, training=False, rng=None):
        tr, ar, tl, al = (params[k].to(x.dtype) for k in
                          ("t_right", "a_right", "t_left", "a_left"))
        y_right = tr + ar * (x - tr)
        y_left = tl + al * (x - tl)
        return torch.where(x >= tr, y_right,
                           torch.where(x <= tl, y_left, x))


class Softmax(KerasLayer):
    def call(self, params, x, *, training=False, rng=None):
        return torch.softmax(x, dim=-1)
