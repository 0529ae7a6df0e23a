"""Weight regularizers (L1/L2), Keras-1 style (port of
``analytics_zoo_tpu/ops/regularizers.py``): the layers' ``w_regularizer``
and ``b_regularizer``, whose terms the Estimator adds to the train
loss (``KerasLayer.regularizers``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

Regularizer = Callable[[torch.Tensor], torch.Tensor]


class L1L2:
    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1 = float(l1)
        self.l2 = float(l2)

    def __call__(self, w: torch.Tensor) -> torch.Tensor:
        loss = torch.zeros((), dtype=torch.float32, device=w.device)
        if self.l1:
            loss = loss + self.l1 * torch.sum(torch.abs(w)).float()
        if self.l2:
            loss = loss + self.l2 * torch.sum(torch.square(w)).float()
        return loss

    def __repr__(self):
        return f"L1L2(l1={self.l1}, l2={self.l2})"


def l1(v: float = 0.01) -> L1L2:
    return L1L2(l1=v)


def l2(v: float = 0.01) -> L1L2:
    return L1L2(l2=v)


def l1l2(v1: float = 0.01, v2: float = 0.01) -> L1L2:
    return L1L2(l1=v1, l2=v2)


def get(spec) -> Optional[Regularizer]:
    """``None``, a callable (passed through) or a name: ``"l1"``,
    ``"l2"``, ``"l1l2"``/``"l1_l2"`` at 0.01."""
    if spec is None:
        return None
    if callable(spec):
        return spec
    if isinstance(spec, str):
        name = spec.lower()
        if name == "l1":
            return l1()
        if name == "l2":
            return l2()
        if name in ("l1l2", "l1_l2"):
            return l1l2()
    raise ValueError(f"unknown regularizer {spec!r}")
