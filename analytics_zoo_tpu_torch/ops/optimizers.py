"""The optimizers with optax's update rules (port of
``analytics_zoo_tpu/ops/optimizers.py``: its seven methods, the
learning-rate schedule helpers and the two gradient clippings).

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
  with weight decay, ``- lr * weight_decay * p`` (optax's adamw;
  ``AdamW`` is Adam with a weight decay of 0.01 by default).
- ``RMSprop``: ``nu = d nu + (1 - d) g^2``, ``p -= lr g / sqrt(nu + eps)``.
- ``Adagrad``: ``s += g^2`` from 0.1, ``p -= lr g / sqrt(s + 1e-7)``.
- ``Adadelta``: ``e_g = rho e_g + (1 - rho) g^2``,
  ``u = g sqrt(e_x + eps) / sqrt(e_g + eps)``,
  ``e_x = rho e_x + (1 - rho) u^2``, ``p -= lr u``.
- ``Adamax``: ``mu`` as Adam's, ``nu = max(b2 nu, |g| + eps)``,
  ``p -= lr (mu / (1 - b1^t)) / nu``.

:func:`clip_by_global_norm` and :func:`clip_constant` are the two
clippings the Estimator applies to the gradients before the update, as
the reference chains them in front of its optax transformation.

A state crosses to and from optax's own layout
(:meth:`ZooOptimizer.to_optax_leaves`, :meth:`~ZooOptimizer.
from_optax_leaves`): the leaves ``jax.tree_util.tree_leaves`` gives of
the reference Estimator's state (its ``multi_transform`` of the clip and
the method, the frozen leaves masked out), so a checkpoint of either
package resumes in the other.

A learning rate may be a float or a callable of the step count (0 for
the first update), as optax's schedules are; :func:`poly`,
:func:`warmup`, :func:`exponential_decay` and :func:`step_decay` make
the reference's schedules with optax's formulas, as Python floats.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
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


def plateau(lr: float, *args, **kwargs):
    raise NotImplementedError(
        "metric-reactive Plateau schedules are host-driven; use "
        "Estimator's reduce_lr_on_plateau hook (planned) or a step "
        "schedule")


# -- gradient clipping (applied before the update) ---------------------------

@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: ``g / ||g|| * max_norm`` over every
    leaf when the global L2 norm reaches ``max_norm``, else ``g``. The
    choice is made on the card (no host sync)."""
    if not grads:
        return grads
    norm = torch.linalg.vector_norm(
        torch.stack([n.float() for n in torch._foreach_norm(grads)]))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    out = torch._foreach_div(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(out, torch.where(keep, one, one * max_norm))
    return out


@torch.no_grad()
def clip_constant(grads: List[torch.Tensor], min_value: float,
                  max_value: float) -> List[torch.Tensor]:
    """Every gradient element clamped into ``[min_value, max_value]``
    (the reference's ``jnp.clip`` over the tree)."""
    if not grads:
        return grads
    out = torch._foreach_clamp_min(grads, float(min_value))
    torch._foreach_clamp_max_(out, float(max_value))
    return out


class ZooOptimizer:
    """Base class: ``init(leaves)`` makes the state for a list of
    parameter tensors, ``update(leaves, grads, state)`` applies one step
    in place (under ``torch.no_grad``). A state is ``{"count": int}``
    and one list of tensors per moment, in the leaves' order.

    ``_moments`` names the moments in optax's order within the method's
    state; ``_count_first`` says whether optax keeps a step count ahead
    of them (Adam and Adamax do). A schedule adds optax's
    ``scale_by_schedule`` count after them."""

    _moments: "tuple[str, ...]" = ()
    _count_first = False

    def __init__(self, lr: ScheduleLike = 1e-3):
        self.lr = lr

    def lr_at(self, step: int) -> float:
        return float(self.lr(step) if callable(self.lr) else self.lr)

    def _init_moment(self, name: str, leaves):
        return _zeros(leaves)

    def init(self, leaves: List[torch.Tensor]) -> dict:
        state = {"count": 0}
        for name in self._moments:
            state[name] = self._init_moment(name, leaves)
        return state

    def update(self, leaves, grads, state: dict) -> None:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"

    # -- optax's layout ------------------------------------------------------
    def optax_slots(self) -> "list[str]":
        """The state's parts in the order optax's leaves hold them:
        ``"count"`` for a step count, else a moment's name (one leaf per
        trainable param)."""
        slots = (["count"] if self._count_first else []) + \
            list(self._moments)
        if callable(self.lr):
            slots.append("count")
        return slots

    def to_optax_leaves(self, state: dict, order: Sequence[int]
                        ) -> "list[np.ndarray]":
        """The state (tensors, or host arrays) as the host leaves of the
        reference's optax state; ``order`` lists the trainable leaves'
        indices in the reference's tree order (its dict keys sorted)."""
        out = []
        for slot in self.optax_slots():
            if slot == "count":
                out.append(np.asarray(state["count"], np.int32))
            else:
                moment = state[slot]
                out += [_host(moment[i]) for i in order]
        return out

    def from_optax_leaves(self, leaves, order: Sequence[int],
                          like: List[torch.Tensor],
                          count: int = 0) -> dict:
        """The inverse of :meth:`to_optax_leaves`: a state for the
        trainable leaves ``like`` (tensors, which give the device and
        dtype) from optax's host leaves. ``count`` stands in where the
        layout keeps no count (SGD at a constant rate)."""
        slots = self.optax_slots()
        n = len(order)
        want = sum(1 if s == "count" else n for s in slots)
        leaves = list(leaves)
        if len(leaves) != want:
            raise ValueError(
                "optimizer state in checkpoint does not match this "
                f"model/optimizer ({len(leaves)} vs {want} leaves)")
        state = {"count": int(count)}
        pos = 0
        seen_count = False
        for slot in slots:
            if slot == "count":
                if not seen_count:
                    state["count"] = int(np.asarray(leaves[pos]))
                    seen_count = True
                pos += 1
                continue
            moment: "list" = [None] * n
            for j, i in enumerate(order):
                src = np.asarray(leaves[pos + j])
                dst = like[i]
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"optimizer state {slot}: shape {src.shape} != "
                        f"param {tuple(dst.shape)}")
                moment[i] = torch.from_numpy(np.array(src, copy=True)).to(
                    dst.device, dst.dtype)
            state[slot] = moment
            pos += n
        return state


def _zeros(leaves):
    return [torch.zeros_like(p) for p in leaves]


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().copy()
    return np.asarray(t)


class SGD(ZooOptimizer):
    def __init__(self, lr: ScheduleLike = 0.01, momentum: float = 0.0,
                 dampening: float = 0.0, nesterov: bool = False,
                 weight_decay: float = 0.0):
        super().__init__(lr)
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay
        # optax.sgd keeps a trace only with a momentum
        self._moments = ("trace",) if momentum else ()

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
    _moments = ("mu", "nu")
    _count_first = True

    def __init__(self, lr: ScheduleLike = 1e-3, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(lr)
        self.beta_1, self.beta_2, self.epsilon = beta_1, beta_2, epsilon
        self.weight_decay = weight_decay

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


class AdamW(Adam):
    def __init__(self, lr: ScheduleLike = 1e-3, weight_decay: float = 0.01,
                 **kw):
        super().__init__(lr, weight_decay=weight_decay, **kw)


class RMSprop(ZooOptimizer):
    _moments = ("nu",)

    def __init__(self, lr: ScheduleLike = 1e-3, decay_rate: float = 0.9,
                 epsilon: float = 1e-8):
        super().__init__(lr)
        self.decay_rate = decay_rate
        self.epsilon = epsilon

    @torch.no_grad()
    def update(self, leaves, grads, state):
        lr = self.lr_at(state["count"])
        d = self.decay_rate
        leaves, grads = list(leaves), list(grads)
        nu = state["nu"]
        torch._foreach_mul_(nu, d)
        torch._foreach_add_(nu, torch._foreach_mul(grads, grads),
                            alpha=1.0 - d)
        scale = torch._foreach_add(nu, self.epsilon)
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, grads)
        torch._foreach_add_(leaves, scale, alpha=-lr)
        state["count"] += 1


class Adagrad(ZooOptimizer):
    """optax.adagrad's defaults: accumulators from 0.1, eps 1e-7 (the
    accumulators stay positive, so optax's zero for a non-positive one
    never applies)."""

    _moments = ("sum_of_squares",)
    initial_accumulator_value = 0.1
    epsilon = 1e-7

    def _init_moment(self, name, leaves):
        return [torch.full_like(p, self.initial_accumulator_value)
                for p in leaves]

    @torch.no_grad()
    def update(self, leaves, grads, state):
        lr = self.lr_at(state["count"])
        leaves, grads = list(leaves), list(grads)
        sos = state["sum_of_squares"]
        torch._foreach_add_(sos, torch._foreach_mul(grads, grads))
        scale = torch._foreach_add(sos, self.epsilon)
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, grads)
        torch._foreach_add_(leaves, scale, alpha=-lr)
        state["count"] += 1


class Adadelta(ZooOptimizer):
    _moments = ("e_g", "e_x")

    def __init__(self, lr: ScheduleLike = 1.0, rho: float = 0.95,
                 epsilon: float = 1e-8):
        super().__init__(lr)
        self.rho = rho
        self.epsilon = epsilon

    @torch.no_grad()
    def update(self, leaves, grads, state):
        lr = self.lr_at(state["count"])
        rho, eps = self.rho, self.epsilon
        leaves, grads = list(leaves), list(grads)
        e_g, e_x = state["e_g"], state["e_x"]
        torch._foreach_mul_(e_g, rho)
        torch._foreach_add_(e_g, torch._foreach_mul(grads, grads),
                            alpha=1.0 - rho)
        num = torch._foreach_add(e_x, eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        torch._foreach_mul_(num, grads)        # the update u
        torch._foreach_mul_(e_x, rho)
        torch._foreach_add_(e_x, torch._foreach_mul(num, num),
                            alpha=1.0 - rho)
        torch._foreach_add_(leaves, num, alpha=-lr)
        state["count"] += 1


class Adamax(ZooOptimizer):
    _moments = ("mu", "nu")
    _count_first = True

    def __init__(self, lr: ScheduleLike = 1e-3, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8):
        super().__init__(lr)
        self.beta_1, self.beta_2, self.epsilon = beta_1, beta_2, epsilon

    @torch.no_grad()
    def update(self, leaves, grads, state):
        lr = self.lr_at(state["count"])
        t = state["count"] + 1
        b1 = self.beta_1
        leaves, grads = list(leaves), list(grads)
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, self.beta_2)
        g_abs = torch._foreach_abs(grads)
        torch._foreach_add_(g_abs, self.epsilon)
        torch._foreach_maximum_(nu, g_abs)
        step = torch._foreach_div(mu, 1.0 - b1 ** t)
        torch._foreach_div_(step, nu)
        torch._foreach_add_(leaves, step, alpha=-lr)
        state["count"] = t


_REGISTRY = {
    "sgd": SGD,
    "adam": Adam,
    "adamw": AdamW,
    "rmsprop": RMSprop,
    "adagrad": Adagrad,
    "adadelta": Adadelta,
    "adamax": Adamax,
}


def get(spec: "str | ZooOptimizer") -> ZooOptimizer:
    """Resolve an optimizer by name (defaults) or pass one through."""
    if isinstance(spec, ZooOptimizer):
        return spec
    key = spec.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown optimizer '{spec}'; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]()
