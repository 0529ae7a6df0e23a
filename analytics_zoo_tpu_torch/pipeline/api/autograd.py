"""Autograd surface on graph variables (port of
``analytics_zoo_tpu/pipeline/api/autograd.py``): ``Lambda``,
``Parameter``, ``Constant``, the operators on :class:`Variable` and
``CustomLoss``.

Each operator adds a node to the functional graph: an ``_OpLayer``
holding a function of tensors, which PyTorch's autograd differentiates
inside the train step. The op layers are auto-named by their operator
(``add``, ``sum``, ...), so a container numbers them from 1 as it
numbers its other layers: the names are a function of the
architecture, and a saved model's or checkpoint's keys match a rebuild.

Axis convention (the reference's): ``axis`` counts the batch as 0 and
graph shapes exclude it, so ``axis >= 1`` addresses the symbolic dims;
an operator over the batch axis is refused.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.ops import activations
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, Shape, Variable, as_shape, unique_name)

EPSILON = 1e-7

VarOrScalar = Union[Variable, float, int]


class _OpLayer(KerasLayer):
    """A layer wrapping a function of its input tensors. Named by the
    caller, or auto-named after ``op`` (its container numbers it)."""

    def __init__(self, fn: Callable, shape_fn: Callable, name=None,
                 op: str = "op"):
        super().__init__(name=name or unique_name(op))
        self._auto_named = name is None
        self.name_prefix = op
        self.fn = fn
        self.shape_fn = shape_fn

    def call(self, params, inputs, *, training=False, rng=None):
        return self.fn(inputs)

    def compute_output_shape(self, input_shape):
        return self.shape_fn(input_shape)


class Lambda(_OpLayer):
    """User function → layer. The function takes and returns tensors
    (the reference's takes jnp arrays), and autograd differentiates it.
    """

    def __init__(self, function: Callable, output_shape=None,
                 input_shape=None, name=None):
        shape_fn = ((lambda s: as_shape(output_shape))
                    if output_shape is not None else (lambda s: s))
        super().__init__(function, shape_fn,
                         name=name or unique_name("lambda"), op="lambda")
        self._given_input_shape = (None if input_shape is None
                                   else as_shape(input_shape))


class _ParameterLayer(KerasLayer):
    """A standalone trainable weight: a node with no input whose output
    is the weight itself (no batch axis; operators broadcast it)."""

    def __init__(self, shape: Shape, init_weight=None, name=None):
        super().__init__(name=name or unique_name("parameter"))
        self.shape = as_shape(shape)
        self.init_weight = (None if init_weight is None
                            else np.asarray(init_weight, np.float32))

    def build(self, generator, input_shape):
        if self.init_weight is not None:
            if tuple(self.init_weight.shape) != self.shape:
                raise ValueError(
                    f"init_weight shape {self.init_weight.shape} != "
                    f"declared {self.shape}")
            return {"weight": torch.from_numpy(self.init_weight.copy())}
        u = torch.rand(self.shape, generator=generator)
        return {"weight": (u * 2.0 - 1.0) * 0.05}

    def call(self, params, inputs, *, training=False, rng=None):
        return params["weight"]

    def compute_output_shape(self, input_shape):
        return self.shape


class _ConstantLayer(KerasLayer):
    """A literal value node. The value is a buffer outside the param
    tree (the reference's node has no params), so it moves with the
    net."""

    def __init__(self, value, name=None):
        super().__init__(name=name or unique_name("constant"))
        self.value = np.asarray(value, np.float32)
        self.trainable = False
        self.register_buffer("constant", torch.from_numpy(self.value.copy()),
                             persistent=False)

    def call(self, params, inputs, *, training=False, rng=None):
        return self.constant

    def compute_output_shape(self, input_shape):
        return tuple(self.value.shape)


def Parameter(shape, init_weight=None, name=None) -> Variable:
    """A trainable standalone weight variable (U(-0.05, 0.05) unless
    ``init_weight`` is given)."""
    layer = _ParameterLayer(as_shape(shape), init_weight, name=name)
    return Variable(shape=layer.shape, layer=layer, parents=[])


def Constant(value, name=None) -> Variable:
    layer = _ConstantLayer(value, name=name)
    return Variable(shape=tuple(layer.value.shape), layer=layer,
                    parents=[])


# ---------------------------------------------------------------------------
# op builders
# ---------------------------------------------------------------------------

def _norm_axis(axis: int, var: Variable) -> int:
    """Reference axis (0 = batch) → runtime tensor axis; refuses the
    batch."""
    ndim = len(var.shape) + 1
    if axis < 0:
        axis = ndim + axis
    if axis == 0:
        raise ValueError("reducing/indexing over the batch axis inside the "
                         "graph is not supported")
    return axis


def _reduce_shape(shape: Shape, axis: int, keepdims: bool) -> Shape:
    # axis already normalized (>= 1); shape excludes batch
    s = list(shape)
    if keepdims:
        s[axis - 1] = 1
    else:
        del s[axis - 1]
    return tuple(s)


def _unary(var: Variable, fn: Callable, name: str,
           shape_fn: Optional[Callable] = None) -> Variable:
    return _OpLayer(fn, shape_fn or (lambda s: s), op=name)(var)


def _broadcast_shape(sa: Shape, sb: Shape) -> Shape:
    return tuple(np.broadcast_shapes(tuple(sa), tuple(sb)))


def _binary(a: Variable, b: VarOrScalar, fn: Callable, name: str,
            shape_fn: Optional[Callable] = None) -> Variable:
    if isinstance(b, Variable):
        sf = shape_fn or (lambda shapes: _broadcast_shape(*shapes))
        return _OpLayer(lambda xs: fn(xs[0], xs[1]), sf, op=name)([a, b])
    const = b
    return _OpLayer(lambda x: fn(x, const), shape_fn or (lambda s: s),
                    op=name)(a)


def _tensor_pair(fn: Callable) -> Callable:
    """``fn`` of two operands where either may be a Python scalar (torch's
    ``maximum``/``minimum`` take tensors only)."""
    def pair(x, y):
        if not isinstance(y, torch.Tensor):
            y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
        elif not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, dtype=y.dtype, device=y.device)
        return fn(x, y)
    return pair


def add(a, b) -> Variable:
    return _binary(a, b, lambda x, y: x + y, "add")


def sub(a, b) -> Variable:
    return _binary(a, b, lambda x, y: x - y, "sub")


def rsub(a, b) -> Variable:
    return _binary(a, b, lambda x, y: y - x, "rsub")


def mul(a, b) -> Variable:
    return _binary(a, b, lambda x, y: x * y, "mul")


def div(a, b) -> Variable:
    return _binary(a, b, lambda x, y: x / y, "div")


def rdiv(a, b) -> Variable:
    return _binary(a, b, lambda x, y: y / x, "rdiv")


def neg(a) -> Variable:
    return _unary(a, lambda x: -x, "neg")


def abs(a) -> Variable:  # noqa: A001 (the reference's name)
    return _unary(a, torch.abs, "abs")


def square(a) -> Variable:
    return _unary(a, torch.square, "square")


def sqrt(a) -> Variable:
    return _unary(a, torch.sqrt, "sqrt")


def log(a) -> Variable:
    return _unary(a, torch.log, "log")


def exp(a) -> Variable:
    return _unary(a, torch.exp, "exp")


def pow(a, p) -> Variable:  # noqa: A001
    return _unary(a, lambda x: torch.pow(x, p), "pow")


def softsign(a) -> Variable:
    return _unary(a, activations.softsign, "softsign")


def softplus(a) -> Variable:
    return _unary(a, F.softplus, "softplus")


def clip(a, min_value: float, max_value: float) -> Variable:
    return _unary(a, lambda x: torch.clamp(x, min_value, max_value), "clip")


def epsilon() -> float:
    return EPSILON


def maximum(a, b) -> Variable:
    return _binary(a, b, _tensor_pair(torch.maximum), "maximum")


def minimum(a, b) -> Variable:
    return _binary(a, b, _tensor_pair(torch.minimum), "minimum")


def sum(a: Variable, axis: int = 1,  # noqa: A001
        keepdims: bool = False) -> Variable:
    ax = _norm_axis(axis, a)
    return _unary(a, lambda x: torch.sum(x, dim=ax, keepdim=keepdims),
                  "sum", lambda s: _reduce_shape(s, ax, keepdims))


def mean(a: Variable, axis: int = 1, keepdims: bool = False) -> Variable:
    ax = _norm_axis(axis, a)
    return _unary(a, lambda x: torch.mean(x, dim=ax, keepdim=keepdims),
                  "mean", lambda s: _reduce_shape(s, ax, keepdims))


def max(a: Variable, axis: int = 1,  # noqa: A001
        keepdims: bool = False) -> Variable:
    ax = _norm_axis(axis, a)
    return _unary(a, lambda x: torch.amax(x, dim=ax, keepdim=keepdims),
                  "max", lambda s: _reduce_shape(s, ax, keepdims))


def stack(inputs: Sequence[Variable], axis: int = 1) -> Variable:
    ax = _norm_axis(axis, inputs[0])

    def shape_fn(shapes):
        s = list(shapes[0])
        s.insert(ax - 1, len(inputs))
        return tuple(s)

    return _OpLayer(lambda xs: torch.stack(list(xs), dim=ax), shape_fn,
                    op="stack")(list(inputs))


def expand_dims(a: Variable, axis: int) -> Variable:
    ax = _norm_axis(axis, a)

    def shape_fn(s):
        out = list(s)
        out.insert(ax - 1, 1)
        return tuple(out)

    return _unary(a, lambda x: torch.unsqueeze(x, ax), "expanddims",
                  shape_fn)


def squeeze(a: Variable, dim: Optional[int] = None) -> Variable:
    if dim is None:
        def shape_fn(s):
            return tuple(d for d in s if d != 1)
        return _unary(a, lambda x: torch.squeeze(
            x, dim=tuple(i for i in range(1, x.dim())
                         if x.shape[i] == 1)), "squeeze", shape_fn)
    ax = _norm_axis(dim, a)

    def shape_fn(s):
        out = list(s)
        del out[ax - 1]
        return tuple(out)

    return _unary(a, lambda x: torch.squeeze(x, dim=ax), "squeeze",
                  shape_fn)


def contiguous(a: Variable) -> Variable:
    return _unary(a, lambda x: x, "contiguous")


def slice_var(a: Variable, idx) -> Variable:
    """``v[...]``: numpy basic indexing on the non-batch dims."""
    full_idx = (slice(None),) + (idx if isinstance(idx, tuple) else (idx,))

    def shape_fn(s):
        probe = np.zeros((1,) + tuple(s), np.int8)[full_idx]
        return tuple(probe.shape[1:])

    return _unary(a, lambda x: x[full_idx], "slice", shape_fn)


def mm(a: Variable, b: Variable, axes: Optional[Sequence[int]] = None
       ) -> Variable:
    """Matrix product (``torch.matmul``), or :func:`batch_dot` over
    ``axes``."""
    if axes is not None:
        return batch_dot(a, b, axes)

    def shape_fn(shapes):
        sa, sb = shapes
        return tuple(sa[:-1]) + (sb[-1],)

    return _OpLayer(lambda xs: torch.matmul(xs[0], xs[1]), shape_fn,
                    op="mm")([a, b])


def batch_dot(a: Variable, b: Variable, axes: Sequence[int] = (2, 1)
              ) -> Variable:
    """Keras's batch_dot: per sample, contract ``a``'s axis ``axes[0]``
    with ``b``'s ``axes[1]`` (batch-inclusive indices); the output has
    ``a``'s other axes, then ``b``'s. One batched product (``bmm``)."""
    ax_a, ax_b = axes

    def fn(xs):
        x, y = xs
        x = torch.movedim(x, ax_a, -1)
        y = torch.movedim(y, ax_b, 1)
        rest_a, rest_b = x.shape[1:-1], y.shape[2:]
        out = torch.bmm(x.reshape(x.shape[0], -1, x.shape[-1]),
                        y.reshape(y.shape[0], y.shape[1], -1))
        return out.reshape((x.shape[0],) + tuple(rest_a) + tuple(rest_b))

    def shape_fn(shapes):
        sa = list(shapes[0])
        sb = list(shapes[1])
        del sa[ax_a - 1]
        del sb[ax_b - 1]
        return tuple(sa + sb)

    return _OpLayer(fn, shape_fn, op="batchdot")([a, b])


def l2_normalize(a: Variable, axis: int = 1) -> Variable:
    ax = _norm_axis(axis, a)
    return _unary(
        a, lambda x: x / torch.clamp(
            torch.linalg.vector_norm(x, dim=ax, keepdim=True), min=EPSILON),
        "l2normalize")


# ---------------------------------------------------------------------------
# CustomLoss
# ---------------------------------------------------------------------------

class CustomLoss:
    """A loss built from a function of Variables:
    ``loss_func(y_true, y_pred)`` returns a Variable of any shape,
    mean-reduced. The instance is a ``(y_true, y_pred) -> scalar``
    callable, so ``compile(loss=CustomLoss(...))`` takes it."""

    def __init__(self, loss_func: Callable[[Variable, Variable], Variable],
                 y_pred_shape: Shape, y_true_shape: Optional[Shape] = None):
        from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input
        from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model
        y_pred_shape = as_shape(y_pred_shape)
        y_true_shape = (as_shape(y_true_shape) if y_true_shape is not None
                        else y_pred_shape)
        y_true_v = Input(y_true_shape, name=unique_name("y_true"))
        y_pred_v = Input(y_pred_shape, name=unique_name("y_pred"))
        out = loss_func(y_true_v, y_pred_v)
        if not isinstance(out, Variable):
            raise TypeError("loss_func must return a Variable")
        self._model = Model([y_true_v, y_pred_v], out)
        self._model.init(torch.Generator().manual_seed(0))

    def __call__(self, y_true, y_pred):
        if self._model.device != y_pred.device:
            self._model.to(y_pred.device)
        val = self._model.call(self._model.params(), [y_true, y_pred])
        return torch.mean(val)
