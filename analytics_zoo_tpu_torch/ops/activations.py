"""Activation functions by Keras name (port of
``analytics_zoo_tpu/ops/activations.py``: every name it accepts, as
PyTorch's own operators)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]


def linear(x):
    return x


def hard_sigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def softmax(x):
    return torch.softmax(x, dim=-1)


def log_softmax(x):
    return torch.log_softmax(x, dim=-1)


def softsign(x):
    return x / (1 + x.abs())


def gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


_REGISTRY: "dict[str, Activation]" = {
    "linear": linear,
    "relu": torch.relu,
    "relu6": F.relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": hard_sigmoid,
    "softmax": softmax,
    "log_softmax": log_softmax,
    "softplus": F.softplus,
    "softsign": softsign,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": gelu,
    "silu": F.silu,
    "swish": F.silu,
    "exp": torch.exp,
}


def get(name: "str | Activation | None") -> Optional[Activation]:
    """Resolve an activation by name; ``None`` → ``None`` (identity)."""
    if name is None:
        return None
    if callable(name):
        return name
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown activation '{name}'; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]
