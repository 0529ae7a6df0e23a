"""Layer/graph engine underneath the Keras-style API (port of
``analytics_zoo_tpu/pipeline/api/keras/engine.py``).

A layer is an ``nn.Module`` that keeps the JAX package's functional
contract beside PyTorch's:

- ``build(generator, input_shape) -> dict`` makes the layer's param tree
  (the JAX package's names and layouts: NHWC activations, HWIO conv
  kernels, ``(in, out)`` Dense kernels, BatchNorm moving stats under
  ``"_state"``) from an explicit ``torch.Generator``;
- ``init`` installs that tree as the module's state (:class:`ParamTree`:
  dicts become child modules, ``_state`` leaves buffers, the rest
  parameters), so ``.to(device)`` and ``state_dict`` work as usual;
- ``apply(params, x, *, training) -> (out, updates)`` is the pure
  forward on a given tree; ``updates`` holds new values for ``_state``
  leaves (BatchNorm's moving statistics in training), which never get
  gradients. ``call`` returns ``apply``'s output alone, and
  ``forward(x)`` runs it on the layer's own tree.

Calling a layer on graph :class:`Variable` s builds a functional graph
(Keras ``Input`` → layer calls → ``Model``); calling it on tensors runs
it. Gradients flow through ``apply`` by autograd: the Estimator marks
the trainable leaves of the tree as requiring grad for a step.
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

Shape = Tuple[int, ...]
ShapeLike = Union[Shape, List[Shape]]

_name_lock = threading.Lock()
_name_counters: "dict[str, itertools.count]" = {}


def unique_name(prefix: str) -> str:
    with _name_lock:
        counter = _name_counters.setdefault(prefix, itertools.count(1))
        return f"{prefix}_{next(counter)}"


def as_shape(s) -> Shape:
    if isinstance(s, int):
        return (s,)
    return tuple(int(d) for d in s)


def is_multi_shape(s) -> bool:
    return isinstance(s, list) or (
        isinstance(s, tuple) and len(s) > 0 and
        isinstance(s[0], (tuple, list)))


class ParamTree(nn.Module):
    """A nested dict of tensors held as module state. Dict keys are
    child names; leaves under a ``"_state"`` key are buffers, the others
    parameters, registered with ``requires_grad=False`` (the Estimator
    switches it on for the trainable leaves while it takes a step).
    :meth:`tree` gives the dict back, in the original key order."""

    def __init__(self, tree: dict, state: bool = False):
        super().__init__()
        self._keys = list(tree)
        # a key that is no module attribute name (an imported graph's
        # "conv1.weight") is registered under a stand-in name
        self._attrs = {k: k if k and "." not in k and not hasattr(self, k)
                       else f"_key{i}" for i, k in enumerate(self._keys)}
        for k, v in tree.items():
            a = self._attrs[k]
            if isinstance(v, dict):
                self.add_module(a, ParamTree(v, state or k == "_state"))
            elif state:
                self.register_buffer(a, v)
            else:
                self.register_parameter(
                    a, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        out = {}
        for k in self._keys:
            a = self._attrs[k]
            if a in self._modules:
                out[k] = self._modules[a].tree()
            elif a in self._parameters:
                out[k] = self._parameters[a]
            else:
                out[k] = self._buffers[a]
        return out


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _ordered_like(tree: dict, like: dict) -> dict:
    """``tree`` with its keys, at every depth, in ``like``'s order."""
    return {k: _ordered_like(tree[k], v) if isinstance(v, dict) else tree[k]
            for k, v in like.items()}


def check_same_structure(src: dict, like: dict, where: str = "") -> None:
    """Raise unless ``src`` has exactly ``like``'s keys and leaf shapes."""
    if set(src) != set(like):
        raise KeyError(
            f"params at {where or '<root>'}: keys {sorted(src)} != "
            f"expected {sorted(like)}")
    for k, v in like.items():
        path = f"{where}/{k}" if where else k
        if isinstance(v, dict):
            if not isinstance(src[k], dict):
                raise ValueError(f"params at {path}: expected a dict")
            check_same_structure(src[k], v, path)
        elif tuple(src[k].shape) != tuple(v.shape):
            raise ValueError(f"params at {path}: shape "
                             f"{tuple(src[k].shape)} != {tuple(v.shape)}")


class KerasLayer(nn.Module):
    """Base class for all layers: subclasses implement :meth:`build`
    (optional), :meth:`call` and :meth:`compute_output_shape`."""

    def __init__(self, input_shape: Optional[ShapeLike] = None,
                 name: Optional[str] = None, trainable: bool = True,
                 **kwargs):
        super().__init__()
        if kwargs:
            raise TypeError(
                f"{type(self).__name__}: unexpected kwargs {list(kwargs)}")
        self._auto_named = name is None
        self.name = name or unique_name(type(self).__name__.lower())
        self.trainable = trainable
        self._given_input_shape = (
            None if input_shape is None else
            (list(map(as_shape, input_shape))
             if is_multi_shape(input_shape) else as_shape(input_shape)))
        self._build_input_shape: Optional[ShapeLike] = None
        self._output_shape: Optional[ShapeLike] = None

    # -- framework ----------------------------------------------------------
    def build(self, generator: torch.Generator,
              input_shape: ShapeLike) -> dict:
        """Create the param tree for ``input_shape``; default: none."""
        del generator, input_shape
        return {}

    def call(self, params: dict, inputs, *, training: bool = False, rng=None):
        raise NotImplementedError(type(self).__name__)

    def apply(self, params: dict, inputs, *, training: bool = False, rng=None):
        """Forward returning ``(outputs, state_updates)``; only stateful
        layers override it, the rest route through :meth:`call` with no
        updates."""
        return self.call(params, inputs, training=training, rng=rng), {}

    def regularizers(self) -> "list[tuple[str, Callable]]":
        """``(param_key, regularizer)`` pairs added to the train loss."""
        return []

    def regularization_loss(self, params: dict) -> torch.Tensor:
        loss = torch.zeros(())
        for key, reg in self.regularizers():
            if key in params:
                loss = loss + reg(params[key])
        return loss

    def compute_output_shape(self, input_shape: ShapeLike) -> ShapeLike:
        return input_shape

    # -- params -------------------------------------------------------------
    def init(self, generator: torch.Generator,
             input_shape: Optional[ShapeLike] = None) -> dict:
        """Build with shape bookkeeping, install the tree as this
        module's state and return it."""
        if input_shape is None:
            input_shape = self._given_input_shape
        if input_shape is None:
            raise ValueError(
                f"layer {self.name}: input_shape required (pass it to the "
                "constructor or to init)")
        self._build_input_shape = input_shape
        self.set_params(self.build(generator, input_shape))
        self._output_shape = self.compute_output_shape(input_shape)
        return self.params()

    def set_params(self, tree: dict) -> None:
        """Install ``tree`` (tensors, used as given) as this layer's
        state; a built layer checks it has the same keys and shapes and
        keeps its key order, the order of the optimizer state's lists
        (a tree from JAX comes with its keys sorted)."""
        if "weights" in self._modules:
            like = self.params()
            check_same_structure(tree, like, self.name)
            tree = _ordered_like(tree, like)
        self.weights = ParamTree(tree)

    def params(self) -> dict:
        w = self._modules.get("weights")
        return {} if w is None else w.tree()

    def forward(self, inputs):
        return self.call(self.params(), inputs)

    @property
    def input_shape(self) -> Optional[ShapeLike]:
        return self._build_input_shape or self._given_input_shape

    @property
    def output_shape(self) -> Optional[ShapeLike]:
        return self._output_shape

    # -- functional API -----------------------------------------------------
    def __call__(self, *args, **kwargs):
        """On graph variables: add a node (Keras functional API). On
        tensors: run the layer (``nn.Module`` call)."""
        x = args[0] if args else None
        if isinstance(x, Variable) or (
                isinstance(x, (list, tuple)) and x and
                all(isinstance(p, Variable) for p in x)):
            return self._connect(x)
        return super().__call__(*args, **kwargs)

    def _connect(self, x) -> "Variable":
        parents = list(x) if isinstance(x, (list, tuple)) else [x]
        in_shape: ShapeLike = (
            [p.shape for p in parents] if len(parents) > 1
            else parents[0].shape)
        out_shape = self.compute_output_shape(in_shape)
        if is_multi_shape(out_shape):
            # multi-output layer (BERT): one base node evaluating to the
            # list, and one selector variable per output
            base = Variable(shape=(), layer=self, parents=parents)
            return [_TupleSelect(i).select(base, as_shape(s))
                    for i, s in enumerate(out_shape)]
        return Variable(shape=as_shape(out_shape), layer=self,
                        parents=parents)

    def extra_repr(self) -> str:
        return f"name={self.name}"


class _TupleSelect(KerasLayer):
    """Selects output ``index`` of a multi-output layer's list."""

    def __init__(self, index: int, name: Optional[str] = None):
        super().__init__(name=name)
        self.index = int(index)

    def call(self, params, inputs, *, training=False, rng=None):
        return inputs[self.index]

    def select(self, base: "Variable", shape: Shape) -> "Variable":
        return Variable(shape=shape, layer=self, parents=[base])


class _InputLayer(KerasLayer):
    """Placeholder node for functional graphs (Keras ``Input``)."""

    def __init__(self, shape: Shape, name: Optional[str] = None):
        super().__init__(input_shape=shape,
                         name=name or unique_name("input"))
        self._output_shape = as_shape(shape)

    def call(self, params, inputs, *, training=False, rng=None):
        return inputs


class Variable:
    """A node in the functional graph: symbolic shape (batch excluded),
    the producing layer and the parent variables. Its arithmetic and
    indexing add operator nodes (``pipeline.api.autograd``, imported
    when first used: it imports this module)."""

    __slots__ = ("shape", "layer", "parents", "name")

    def __init__(self, shape: Shape, layer: Optional[KerasLayer] = None,
                 parents: Optional[List["Variable"]] = None,
                 name: Optional[str] = None):
        self.shape = as_shape(shape)
        self.layer = layer
        self.parents = parents or []
        self.name = name or (layer.name if layer is not None
                             else unique_name("var"))

    def __repr__(self):
        return f"Variable(name={self.name}, shape={self.shape})"

    @staticmethod
    def _ag():
        from analytics_zoo_tpu_torch.pipeline.api import autograd
        return autograd

    def __add__(self, other):
        return self._ag().add(self, other)

    def __radd__(self, other):
        return self._ag().add(self, other)

    def __sub__(self, other):
        return self._ag().sub(self, other)

    def __rsub__(self, other):
        return self._ag().rsub(self, other)

    def __mul__(self, other):
        return self._ag().mul(self, other)

    def __rmul__(self, other):
        return self._ag().mul(self, other)

    def __truediv__(self, other):
        return self._ag().div(self, other)

    def __rtruediv__(self, other):
        return self._ag().rdiv(self, other)

    def __neg__(self):
        return self._ag().neg(self)

    def __pow__(self, p):
        return self._ag().pow(self, p)

    def __getitem__(self, idx):
        return self._ag().slice_var(self, idx)

    def squeeze(self, dim=None):
        return self._ag().squeeze(self, dim)

    def expand_dims(self, axis):
        return self._ag().expand_dims(self, axis)


def Input(shape: ShapeLike, name: Optional[str] = None) -> Variable:
    """A functional-graph input placeholder; ``shape`` excludes the
    batch dimension."""
    layer = _InputLayer(as_shape(shape), name=name)
    return Variable(shape=as_shape(shape), layer=layer, parents=[])


def topological_order(outputs: Sequence[Variable]) -> List[Variable]:
    """Topo-sort the graph feeding ``outputs`` (inputs first)."""
    order: List[Variable] = []
    seen: set = set()

    def visit(v: Variable, stack: set):
        if id(v) in seen:
            return
        if id(v) in stack:
            raise ValueError("cycle detected in layer graph")
        stack.add(id(v))
        for p in v.parents:
            visit(p, stack)
        stack.discard(id(v))
        seen.add(id(v))
        order.append(v)

    for out in outputs:
        visit(out, set())
    return order


def collect_layers(order: Sequence[Variable]) -> List[KerasLayer]:
    """Unique non-input layers in topo order (shared layers once)."""
    seen: set = set()
    layers: List[KerasLayer] = []
    for v in order:
        lyr = v.layer
        if lyr is None or isinstance(lyr, _InputLayer):
            continue
        if id(lyr) not in seen:
            seen.add(id(lyr))
            layers.append(lyr)
    return layers
