"""Objectives (losses) the training slice uses, Keras-1 names and
semantics (port of ``analytics_zoo_tpu/ops/losses.py``, a subset).

Every loss is a pure ``fn(y_true, y_pred) -> scalar`` (mean over the
batch) and differentiable in ``y_pred``. Integer labels may carry a
trailing axis of 1, as the reference allows.
"""

from __future__ import annotations

from typing import Callable

import torch

EPSILON = 1e-7

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _labels(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    labels = y_true.long()
    if labels.dim() == y_pred.dim():
        labels = labels[..., 0]
    return labels


def mean_squared_error(y_true, y_pred):
    return torch.mean(torch.square(y_pred - y_true))


def mean_absolute_error(y_true, y_pred):
    return torch.mean(torch.abs(y_pred - y_true))


def rank_hinge(y_true, y_pred, margin: float = 1.0):
    """Pairwise ranking hinge (KNRM text matching): batch rows alternate
    positive, negative, positive, negative, ...; ``y_true`` is
    ignored."""
    scores = y_pred.reshape(-1)
    return torch.mean(torch.clamp(margin - scores[0::2] + scores[1::2],
                                  min=0.0))


def categorical_crossentropy(y_true, y_pred):
    p = torch.clamp(y_pred, EPSILON, 1.0)
    return torch.mean(-torch.sum(y_true * torch.log(p), dim=-1))


def sparse_categorical_crossentropy(y_true, y_pred):
    logp = torch.log(torch.clamp(y_pred, EPSILON, 1.0))
    picked = torch.gather(logp, -1, _labels(y_true, y_pred)[..., None])
    return -torch.mean(picked)


def softmax_cross_entropy(y_true, y_pred):
    """Stable log-softmax cross entropy over *logits* (computed in f32)
    with sparse integer labels."""
    logp = torch.log_softmax(y_pred.float(), dim=-1)
    picked = torch.gather(logp, -1, _labels(y_true, y_pred)[..., None])
    return -torch.mean(picked)


_REGISTRY: "dict[str, LossFn]" = {
    "mean_squared_error": mean_squared_error,
    "mse": mean_squared_error,
    "mean_absolute_error": mean_absolute_error,
    "mae": mean_absolute_error,
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "softmax_cross_entropy": softmax_cross_entropy,
    "sparse_categorical_crossentropy_from_logits": softmax_cross_entropy,
    "rank_hinge": rank_hinge,
}


def get(name: "str | LossFn") -> LossFn:
    """Resolve a loss by Keras name (or pass a callable through)."""
    if callable(name):
        return name
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown or unported loss '{name}'; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]
