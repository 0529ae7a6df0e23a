"""Validation metrics (port of ``analytics_zoo_tpu/ops/metrics.py``).

Each metric exposes ``batch_stats(y_true, y_pred) -> dict[str, Tensor]``,
sums that the Estimator adds up over the batches on the card, and
``aggregate(stats) -> float``, computed on the host from the totals
(BigDL's ValidationMethod and ValidationResult split). The Estimator
evaluates every sample exactly once (the tail batch unpadded), so no
per-sample mask is needed here.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


class Metric:
    name = "metric"

    def batch_stats(self, y_true: torch.Tensor,
                    y_pred: torch.Tensor) -> "dict[str, torch.Tensor]":
        raise NotImplementedError

    def aggregate(self, stats: "dict[str, np.ndarray]") -> float:
        raise NotImplementedError


def _count(t: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(t.numel()), device=t.device)


def _ratio(num, den) -> float:
    return float(num / np.maximum(den, 1.0))


class Accuracy(Metric):
    """Softmax outputs → argmax against sparse or one-hot labels;
    single-unit outputs → a 0.5 threshold."""

    name = "accuracy"

    def batch_stats(self, y_true, y_pred):
        if y_pred.dim() >= 2 and y_pred.shape[-1] > 1:
            pred = y_pred.argmax(-1)
            if y_true.dim() == y_pred.dim() and y_true.shape[-1] > 1:
                true = y_true.argmax(-1)  # one-hot
            else:
                true = y_true.reshape(pred.shape).long()
        else:
            pred = (y_pred.reshape(y_pred.shape[0], -1)[:, 0] > 0.5).long()
            true = y_true.reshape(y_true.shape[0], -1)[:, 0].long()
        hits = (pred == true).float()
        return {"correct": hits.sum(), "count": _count(hits)}

    def aggregate(self, stats):
        return _ratio(stats["correct"], stats["count"])


SparseCategoricalAccuracy = Accuracy
CategoricalAccuracy = Accuracy
BinaryAccuracy = Accuracy


class Top5Accuracy(Metric):
    name = "top5accuracy"

    def batch_stats(self, y_true, y_pred):
        true = (y_true.argmax(-1)
                if y_true.dim() == y_pred.dim() and y_true.shape[-1] > 1
                else y_true.reshape(y_pred.shape[0]).long())
        top5 = y_pred.topk(5, dim=-1).indices
        hits = (top5 == true[:, None]).any(-1).float()
        return {"correct": hits.sum(), "count": _count(hits)}

    def aggregate(self, stats):
        return _ratio(stats["correct"], stats["count"])


class MAE(Metric):
    name = "mae"

    def batch_stats(self, y_true, y_pred):
        err = (y_pred - y_true).abs().float()
        return {"abs_sum": err.sum(), "count": _count(err)}

    def aggregate(self, stats):
        return _ratio(stats["abs_sum"], stats["count"])


class MSE(Metric):
    name = "mse"

    def batch_stats(self, y_true, y_pred):
        err = (y_pred - y_true).square().float()
        return {"sq_sum": err.sum(), "count": _count(err)}

    def aggregate(self, stats):
        return _ratio(stats["sq_sum"], stats["count"])


class Loss(Metric):
    """Wraps a loss fn (a batch mean) as a metric."""

    name = "loss"

    def __init__(self, loss_fn: Callable):
        self.loss_fn = loss_fn

    def batch_stats(self, y_true, y_pred):
        n = torch.tensor(float(y_pred.shape[0]), device=y_pred.device)
        return {"loss_sum": self.loss_fn(y_true, y_pred) * n, "count": n}

    def aggregate(self, stats):
        return _ratio(stats["loss_sum"], stats["count"])


class AUC(Metric):
    """ROC-AUC from confusion counts at evenly spaced thresholds."""

    name = "auc"

    def __init__(self, thresholds: int = 200):
        self.n_thresholds = int(thresholds)

    def batch_stats(self, y_true, y_pred):
        scores = y_pred.reshape(-1).float()
        labels = y_true.reshape(-1).float()
        ts = torch.linspace(0.0, 1.0, self.n_thresholds,
                            device=scores.device)
        pred_pos = scores[None, :] >= ts[:, None]          # (T, N)
        is_pos = labels[None, :] > 0.5
        pos = is_pos[0].float().sum()
        return {"tp": (pred_pos & is_pos).float().sum(1),
                "fp": (pred_pos & ~is_pos).float().sum(1),
                "pos": pos, "neg": float(scores.numel()) - pos}

    def aggregate(self, stats):
        tpr = stats["tp"] / np.maximum(stats["pos"], 1.0)
        fpr = stats["fp"] / np.maximum(stats["neg"], 1.0)
        # thresholds ascend, so fpr and tpr descend
        return float(np.abs(np.trapezoid(tpr, fpr)))


_REGISTRY: "dict[str, Callable[[], Metric]]" = {
    "accuracy": Accuracy,
    "acc": Accuracy,
    "top5accuracy": Top5Accuracy,
    "top5": Top5Accuracy,
    "mae": MAE,
    "mse": MSE,
    "auc": AUC,
}


def get(spec: "str | Metric") -> Metric:
    if isinstance(spec, Metric):
        return spec
    key = spec.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown metric '{spec}'; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]()
