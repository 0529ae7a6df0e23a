"""Objectives (losses), Keras-1 names and semantics (port of
``analytics_zoo_tpu/ops/losses.py``, the whole table).

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


def mean_absolute_percentage_error(y_true, y_pred):
    diff = torch.abs((y_true - y_pred) /
                     torch.clamp(torch.abs(y_true), min=EPSILON))
    return 100.0 * torch.mean(diff)


def mean_squared_logarithmic_error(y_true, y_pred):
    a = torch.log(torch.clamp(y_pred, min=EPSILON) + 1.0)
    b = torch.log(torch.clamp(y_true, min=EPSILON) + 1.0)
    return torch.mean(torch.square(a - b))


def binary_crossentropy(y_true, y_pred):
    p = torch.clamp(y_pred, EPSILON, 1.0 - EPSILON)
    return torch.mean(-(y_true * torch.log(p) +
                        (1.0 - y_true) * torch.log(1.0 - p)))


def categorical_crossentropy(y_true, y_pred):
    p = torch.clamp(y_pred, EPSILON, 1.0)
    return torch.mean(-torch.sum(y_true * torch.log(p), dim=-1))


def sparse_categorical_crossentropy(y_true, y_pred):
    logp = torch.log(torch.clamp(y_pred, EPSILON, 1.0))
    picked = torch.gather(logp, -1, _labels(y_true, y_pred)[..., None])
    return -torch.mean(picked)


def class_nll(y_true, y_pred):
    """Negative log-likelihood over log-probabilities (BigDL
    ``ClassNLLCriterion`` with 0-based labels; pairs with a
    ``log_softmax`` output, as NeuralCF and Wide&Deep end)."""
    picked = torch.gather(y_pred, -1, _labels(y_true, y_pred)[..., None])
    return -torch.mean(picked)


def softmax_cross_entropy(y_true, y_pred):
    """Stable log-softmax cross entropy over *logits* (computed in f32)
    with sparse integer labels."""
    logp = torch.log_softmax(y_pred.float(), dim=-1)
    picked = torch.gather(logp, -1, _labels(y_true, y_pred)[..., None])
    return -torch.mean(picked)


def sigmoid_cross_entropy(y_true, y_pred):
    """Stable binary cross entropy over logits (in f32)."""
    z = y_pred.float()
    t = y_true.float()
    return torch.mean(torch.clamp(z, min=0) - z * t +
                      torch.log1p(torch.exp(-torch.abs(z))))


def hinge(y_true, y_pred):
    return torch.mean(torch.clamp(1.0 - y_true * y_pred, min=0.0))


def squared_hinge(y_true, y_pred):
    return torch.mean(torch.square(torch.clamp(1.0 - y_true * y_pred,
                                               min=0.0)))


def kullback_leibler_divergence(y_true, y_pred):
    t = torch.clamp(y_true, EPSILON, 1.0)
    p = torch.clamp(y_pred, EPSILON, 1.0)
    return torch.mean(torch.sum(t * torch.log(t / p), dim=-1))


def poisson(y_true, y_pred):
    return torch.mean(y_pred - y_true * torch.log(y_pred + EPSILON))


def cosine_proximity(y_true, y_pred):
    t = y_true / torch.clamp(torch.linalg.vector_norm(
        y_true, dim=-1, keepdim=True), min=EPSILON)
    p = y_pred / torch.clamp(torch.linalg.vector_norm(
        y_pred, dim=-1, keepdim=True), min=EPSILON)
    return -torch.mean(torch.sum(t * p, dim=-1))


_REGISTRY: "dict[str, LossFn]" = {
    "mean_squared_error": mean_squared_error,
    "mse": mean_squared_error,
    "mean_absolute_error": mean_absolute_error,
    "mae": mean_absolute_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "mape": mean_absolute_percentage_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "msle": mean_squared_logarithmic_error,
    "binary_crossentropy": binary_crossentropy,
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "class_nll": class_nll,
    "softmax_cross_entropy": softmax_cross_entropy,
    "sparse_categorical_crossentropy_from_logits": softmax_cross_entropy,
    "sigmoid_cross_entropy": sigmoid_cross_entropy,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "rank_hinge": rank_hinge,
    "kullback_leibler_divergence": kullback_leibler_divergence,
    "kld": kullback_leibler_divergence,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
}


def get(name: "str | LossFn") -> LossFn:
    """Resolve a loss by Keras name (or pass a callable through)."""
    if callable(name):
        return name
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown loss '{name}'; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]
