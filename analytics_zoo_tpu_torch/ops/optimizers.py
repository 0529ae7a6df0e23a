"""SGD and Adam with optax's update rules (port of
``analytics_zoo_tpu/ops/optimizers.py``: the two methods the training
slices use and the learning-rate schedule helpers).

The reference builds optax transformations, which XLA fuses into one
program over the whole tree. Here each optimizer keeps its state as a
dict of lists, one tensor per trainable leaf in tree order, and updates
the parameters in place, step for step the update optax computes, with
multi-tensor ``torch._foreach_*`` calls: each walks every leaf in a few
launches, so a step's launches do not grow with the number of leaves
(ResNet-50 has 161):

- ``SGD``: ``g += weight_decay * p``; with momentum
  ``trace = g + momentum * trace`` and, with nesterov,
  ``g = g + momentum * trace`` (else ``g = trace``); ``p -= lr * g``.
- ``Adam``: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``,
  ``p -= lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)`` and,
  with weight decay, ``- lr * weight_decay * p`` (optax's adamw).

A learning rate may be a float or a callable of the step count (0 for
the first update), as optax's schedules are; :func:`poly`,
:func:`warmup`, :func:`exponential_decay` and :func:`step_decay` make
the reference's schedules with optax's formulas, as Python floats.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Union

import torch

ScheduleLike = Union[float, Callable[[int], float]]


# -- LR schedules -----------------------------------------------------------

def _polynomial(init: float, end: float, power: float, steps: int):
    """optax.polynomial_schedule."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac ** power + end
    return schedule


def poly(lr: float, power: float = 0.5, max_iteration: int = 100000,
         end_lr: float = 0.0):
    """BigDL ``SGD.Poly``."""
    return _polynomial(lr, end_lr, power, max_iteration)


def warmup(base_lr: float, warmup_iterations: int, delta: float = 0.0,
           after: Optional[Callable[[int], float]] = None):
    """BigDL ``SGD.Warmup``: a linear ramp from ``base_lr`` by ``delta``
    per iteration for ``warmup_iterations``, then ``after``."""
    ramp = _polynomial(base_lr, base_lr + delta * warmup_iterations, 1,
                       warmup_iterations)
    if after is None:
        return ramp

    def schedule(count):
        if count < warmup_iterations:
            return ramp(count)
        return after(count - warmup_iterations)
    return schedule


def exponential_decay(lr: float, decay_rate: float, decay_steps: int,
                      staircase: bool = False):
    """optax.exponential_decay: ``lr * decay_rate ** (count /
    decay_steps)``, floored exponent when ``staircase``."""
    if decay_steps <= 0 or decay_rate == 0:
        return lambda count: lr

    def schedule(count):
        if count <= 0:
            return lr
        p = count / decay_steps
        return lr * decay_rate ** (math.floor(p) if staircase else p)
    return schedule


def step_decay(lr: float, step_size: int, gamma: float = 0.1):
    return exponential_decay(lr, gamma, step_size, staircase=True)


class ZooOptimizer:
    """Base class: ``init(leaves)`` makes the state for a list of
    parameter tensors, ``update(leaves, grads, state)`` applies one step
    in place (under ``torch.no_grad``)."""

    def __init__(self, lr: ScheduleLike = 1e-3):
        self.lr = lr

    def lr_at(self, step: int) -> float:
        return float(self.lr(step) if callable(self.lr) else self.lr)

    def init(self, leaves: List[torch.Tensor]) -> dict:
        raise NotImplementedError

    def update(self, leaves, grads, state: dict) -> None:
        raise NotImplementedError


def _zeros(leaves):
    return [torch.zeros_like(p) for p in leaves]


class SGD(ZooOptimizer):
    def __init__(self, lr: ScheduleLike = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        super().__init__(lr)
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def init(self, leaves):
        state = {"count": 0}
        if self.momentum:
            state["trace"] = _zeros(leaves)
        return state

    @torch.no_grad()
    def update(self, leaves, grads, state):
        lr = self.lr_at(state["count"])
        leaves, grads = list(leaves), list(grads)
        if self.weight_decay:
            grads = torch._foreach_add(grads, leaves,
                                       alpha=self.weight_decay)
        if self.momentum:
            trace = state["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            grads = (torch._foreach_add(grads, trace, alpha=self.momentum)
                     if self.nesterov else trace)
        torch._foreach_add_(leaves, grads, alpha=-lr)
        state["count"] += 1


class Adam(ZooOptimizer):
    def __init__(self, lr: ScheduleLike = 1e-3, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(lr)
        self.beta_1, self.beta_2, self.epsilon = beta_1, beta_2, epsilon
        self.weight_decay = weight_decay

    def init(self, leaves):
        return {"count": 0, "mu": _zeros(leaves), "nu": _zeros(leaves)}

    @torch.no_grad()
    def update(self, leaves, grads, state):
        lr = self.lr_at(state["count"])
        t = state["count"] + 1
        b1, b2 = self.beta_1, self.beta_2
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        leaves, grads = list(leaves), list(grads)
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(grads, grads),
                            alpha=1.0 - b2)
        step = torch._foreach_div(mu, c1)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_div_(step, denom)
        if self.weight_decay:
            torch._foreach_add_(step, leaves, alpha=self.weight_decay)
        torch._foreach_add_(leaves, step, alpha=-lr)
        state["count"] = t


_REGISTRY = {"sgd": SGD, "adam": Adam}


def get(spec: "str | ZooOptimizer") -> ZooOptimizer:
    """Resolve an optimizer by name (defaults) or pass one through."""
    if isinstance(spec, ZooOptimizer):
        return spec
    key = spec.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown or unported optimizer '{spec}'; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]()
