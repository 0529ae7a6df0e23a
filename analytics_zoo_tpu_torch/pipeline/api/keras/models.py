"""Containers: functional ``Model`` and ``Sequential`` (port of
``analytics_zoo_tpu/pipeline/api/keras/models.py``): params by layer
name, ``apply`` with state updates, predict, the training surface
(``compile``/``fit``/``evaluate`` and the TensorBoard, checkpoint and
clipping setters, routed to the Estimator) and the weights' persistence
(``save_weights``/``load_weights`` in the reference's ``.npz`` format,
``get_weights``/``set_weights``/``copy_weights_from`` in its
sorted-path order).

A container's param tree is ``{layer.name: layer params}``, the JAX
package's layout, so a JAX param pytree loads into it as a copy
(:mod:`analytics_zoo_tpu_torch.bridge`).
"""

from __future__ import annotations

import itertools
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.ops.rng import fold_in
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, ShapeLike, Variable, _InputLayer, collect_layers,
    topological_order, unique_name,
)


def to_tensor(x, device) -> torch.Tensor:
    """A host array or tensor as a tensor on ``device`` (dtype kept)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def to_numpy(t):
    """A tensor (or a list of them) as a host array (or a list); bf16
    (which numpy lacks) widens to f32 exactly."""
    if isinstance(t, (list, tuple)):
        return [to_numpy(v) for v in t]
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def concat_outputs(chunks):
    """Batches of host outputs (each an array, or a list of arrays for a
    multi-output net) joined along the batch: one array per output."""
    if not chunks:
        return np.empty((0,))
    if isinstance(chunks[0], (list, tuple)):
        return [np.concatenate([c[i] for c in chunks])
                for i in range(len(chunks[0]))]
    return np.concatenate(chunks)


class KerasNet(KerasLayer):
    """Shared container behaviour. Containers are layers, so they nest;
    their sub-layers sit in an ``nn.ModuleDict`` keyed by layer name."""

    def _canonicalize_names(self, layers: "list[KerasLayer]") -> None:
        """Rename auto-named layers to container-scoped deterministic
        names (``dense_1``, ``dense_2``, ... in container order; an
        autograd operator by its ``name_prefix``: ``add_1``), so two
        builds of one architecture key their params alike."""
        counters: "dict[str, int]" = {}
        for lyr in layers:
            prefix = getattr(lyr, "name_prefix", type(lyr).__name__.lower())
            counters[prefix] = counters.get(prefix, 0) + 1
            if getattr(lyr, "_auto_named", False):
                lyr.name = f"{prefix}_{counters[prefix]}"

    def _register(self, layers: "list[KerasLayer]") -> None:
        self.graph_layers = nn.ModuleDict({lyr.name: lyr for lyr in layers})

    @property
    def layers(self) -> "list[KerasLayer]":
        return list(self.graph_layers.values())

    # -- params -------------------------------------------------------------
    @property
    def initialized(self) -> bool:
        return self._output_shape is not None

    @property
    def device(self) -> torch.device:
        for t in itertools.chain(self.parameters(), self.buffers()):
            return t.device
        return torch.device("cpu")

    def init_params(self, generator: Optional[torch.Generator] = None,
                    device=None) -> dict:
        """Build the whole param tree on the host from ``generator``
        (default: a fresh one from the process context) and move it to
        ``device`` (default: the context's device, the first card)."""
        from analytics_zoo_tpu_torch.common.nncontext import get_nncontext
        if generator is None or device is None:
            ctx = get_nncontext()
            generator = generator or ctx.new_generator()
            device = ctx.device if device is None else device
        params = self.init(generator)
        self.to(device)
        return params

    def params(self) -> dict:
        return {lyr.name: lyr.params() for lyr in self.layers}

    def set_params(self, tree: dict) -> None:
        """Install a tree keyed by layer name. A layer without params
        (an operator, a pool) needs no entry, and an empty entry under
        another name is ignored: operator nodes are numbered by process
        in the JAX package and by container here."""
        extra = sorted(k for k in set(tree) - set(self.graph_layers)
                       if not (isinstance(tree[k], dict) and not tree[k]))
        if extra:
            raise KeyError(f"{self.name}: params for unknown layers "
                           f"{extra[:5]}")
        for lyr in self.layers:
            if lyr.name not in tree:
                if not lyr.params():
                    continue
                raise KeyError(f"{self.name}: no params for layer "
                               f"{lyr.name!r}")
            lyr.set_params(tree[lyr.name])

    def load_params(self, tree: dict, device=None) -> "KerasNet":
        """Install a param tree (tensors, or host arrays as from
        ``jax.device_get``) by layer name, on ``device`` (default: where
        the net's params are, or the context's device)."""
        from analytics_zoo_tpu_torch.bridge import params_from_numpy
        if device is None:
            if self.initialized:
                device = self.device
            else:
                from analytics_zoo_tpu_torch.common.nncontext import \
                    get_nncontext
                device = get_nncontext().device
        if not self.initialized:
            # shapes and output-shape bookkeeping come from a build
            self.init(torch.Generator().manual_seed(0))
        self.set_params(params_from_numpy(tree, device))
        self.to(device)    # state outside the tree (a Constant's value)
        return self

    def regularization_loss(self, params: dict) -> torch.Tensor:
        loss = torch.zeros(())
        for lyr in self.layers:
            loss = loss + lyr.regularization_loss(params.get(lyr.name, {}))
        return loss

    def trainable_mask(self, params: dict) -> dict:
        """Bool tree: True where the optimizer updates. ``_state``
        subtrees (at any depth: a fused bottleneck keeps one per BN) and
        layers with ``trainable=False`` are masked out."""
        def mask_layer(lyr: KerasLayer, sub: dict):
            if isinstance(lyr, KerasNet):
                return {inner.name: mask_layer(inner,
                                               sub.get(inner.name, {}))
                        for inner in lyr.layers if inner.name in sub}

            def mask_sub(node, on):
                if isinstance(node, dict):
                    return {k: mask_sub(v, on and k != "_state")
                            for k, v in node.items()}
                return on
            return mask_sub(sub, bool(lyr.trainable))
        return {lyr.name: mask_layer(lyr, params.get(lyr.name, {}))
                for lyr in self.layers if lyr.name in params}

    def freeze(self, *layer_names: str) -> "KerasNet":
        """Freeze named layers (all layers if no names given)."""
        for lyr in self.layers:
            if not layer_names or lyr.name in layer_names:
                lyr.trainable = False
        return self

    def unfreeze(self, *layer_names: str) -> "KerasNet":
        """Unfreeze named layers (all layers if no names given). The
        optimizer's state then covers other leaves: call ``compile``
        again before ``fit``."""
        for lyr in self.layers:
            if not layer_names or lyr.name in layer_names:
                lyr.trainable = True
        return self

    # -- training surface (routes to the Estimator, as the reference) ------
    def compile(self, optimizer="adam", loss="mse", metrics=None):
        """Configure training. Weights live in the net, so re-compiling
        keeps them (Keras semantics)."""
        from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
        self._estimator = Estimator(self, optimizer=optimizer, loss=loss,
                                    metrics=metrics)
        return self

    @property
    def estimator(self):
        est = getattr(self, "_estimator", None)
        if est is None:
            raise RuntimeError("call compile(...) first")
        return est

    def set_tensorboard(self, log_dir: str, app_name: str = "zoo_tpu"):
        self.estimator.set_tensorboard(log_dir, app_name)
        return self

    def set_summary_trigger(self, name: str, trigger):
        """"Parameters" or "LearningRate" summaries on ``trigger``."""
        self.estimator.set_summary_trigger(name, trigger)
        return self

    def set_checkpoint(self, path: str, trigger=None):
        self.estimator.set_checkpoint(path, trigger)
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float):
        self.estimator.set_gradient_clipping_by_l2_norm(clip_norm)
        return self

    def set_constant_gradient_clipping(self, min_value, max_value):
        self.estimator.set_constant_gradient_clipping(min_value, max_value)
        return self

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 10,
            validation_data=None, **kwargs):
        """Train on numpy array(s) (+ ``y``) or an ``ArrayDataset``;
        ``validation_data`` (an ``(x, y)`` pair or a dataset) is
        evaluated at each ``validation_trigger`` (default every epoch)
        into the history's ``val_<metric>`` keys."""
        return self.estimator.train(x, y, batch_size=batch_size,
                                    nb_epoch=nb_epoch,
                                    validation_data=validation_data,
                                    **kwargs)

    def evaluate(self, x, y=None, batch_size: int = 32):
        return self.estimator.evaluate(x, y, batch_size=batch_size)

    # -- weights --------------------------------------------------------------
    def _flat_weights(self):
        """``("layer/param", tensor)`` for every leaf, in the reference's
        sorted-path order."""
        flat = []

        def walk(prefix, d):
            for k in sorted(d):
                key = f"{prefix}/{k}" if prefix else str(k)
                if isinstance(d[k], dict):
                    walk(key, d[k])
                else:
                    flat.append((key, d[k]))
        walk("", self.params())
        return flat

    def _weight_leaves(self):
        """:meth:`_flat_weights` of the initialized net."""
        self.estimator._ensure_initialized()
        return self._flat_weights()

    def _install(self, values: dict) -> None:
        """Install host arrays by ``"layer/param"`` key (every key of
        the tree), cast to each leaf's dtype."""
        from analytics_zoo_tpu_torch.bridge import params_to_numpy

        def fill(prefix, d):
            for k, v in d.items():
                key = f"{prefix}/{k}" if prefix else str(k)
                if isinstance(v, dict):
                    fill(key, v)
                else:
                    d[k] = np.asarray(values[key]).astype(v.dtype)
        tree = params_to_numpy(self)
        fill("", tree)
        self.estimator.params = tree

    def save_weights(self, path: str):
        """The weights as a flat ``.npz`` keyed ``"layer/param"`` (the
        reference's format: each package loads the other's)."""
        if not self.initialized:
            raise RuntimeError("no parameters to save; fit or init first")
        np.savez(path, **{k: to_numpy(t) for k, t in self._flat_weights()})

    def load_weights(self, path: str):
        """Load a :meth:`save_weights` file (either package's); a
        missing or misshapen tensor raises."""
        values = {}
        with np.load(path) as data:
            for key, leaf in self._weight_leaves():
                if key not in data:
                    raise KeyError(f"weight {key} missing from {path}")
                saved = data[key]
                if tuple(saved.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"shape mismatch for {key}: saved {saved.shape} vs "
                        f"model {tuple(leaf.shape)}")
                values[key] = saved
        self._install(values)
        return self

    def get_weights(self) -> "list[np.ndarray]":
        """Every weight array in sorted-path order (the reference's
        ``get_weights``); :meth:`set_weights` takes the list back."""
        return [to_numpy(t).copy() for _, t in self._weight_leaves()]

    def set_weights(self, weights: "list[np.ndarray]"):
        """The inverse of :meth:`get_weights`, shape-checked."""
        flat = self._weight_leaves()
        if len(weights) != len(flat):
            raise ValueError(f"expected {len(flat)} arrays, got "
                             f"{len(weights)}")
        values = {}
        for (key, cur), w in zip(flat, weights):
            w = np.asarray(w)
            if tuple(w.shape) != tuple(cur.shape):
                raise ValueError(f"shape mismatch: model "
                                 f"{tuple(cur.shape)} vs {w.shape}")
            values[key] = w
        self._install(values)
        return self

    def copy_weights_from(self, other: "KerasNet",
                          strict: bool = False) -> "KerasNet":
        """Copy weights from another net by layer name: layers in both
        take ``other``'s weights (cast to this net's dtypes), the rest
        keep theirs. A layer whose shapes differ is skipped with a
        warning, or raises with ``strict=True``, which also requires
        every layer of this net in ``other``."""
        from analytics_zoo_tpu_torch.bridge import params_to_numpy
        from analytics_zoo_tpu_torch.common.nncontext import logger
        other.estimator._ensure_initialized()
        self.estimator._ensure_initialized()
        src, dst = params_to_numpy(other), params_to_numpy(self)
        missing = [n for n in dst if n not in src]
        if strict and missing:
            raise KeyError(f"layers missing from source: {missing}")

        def shapes(tree, prefix=""):
            out = []
            for k in sorted(tree):
                key = f"{prefix}/{k}"
                if isinstance(tree[k], dict):
                    out += shapes(tree[k], key)
                else:
                    out.append((key, tuple(np.shape(tree[k]))))
            return out

        def cast(s_, d):
            if isinstance(d, dict):
                return {k: cast(s_[k], v) for k, v in d.items()}
            return np.asarray(s_).astype(d.dtype)

        new = {}
        for name, sub in dst.items():
            if name not in src:
                new[name] = sub
                continue
            if shapes(src[name]) != shapes(sub):
                if strict:
                    raise ValueError(
                        f"layer {name!r}: source weights "
                        f"{shapes(src[name])} incompatible with "
                        f"{shapes(sub)}")
                logger.warning("copy_weights_from: skipping layer %r — "
                               "source shapes %s != destination %s", name,
                               shapes(src[name]), shapes(sub))
                new[name] = sub
                continue
            new[name] = cast(src[name], sub)
        self.estimator.params = new
        return self

    # -- introspection ------------------------------------------------------
    def summary(self, params: Optional[dict] = None,
                line_length: int = 76) -> str:
        """A printable per-layer table: name (type), output shape and
        param count (``?`` without ``params``), and the total; printed
        and returned."""
        from analytics_zoo_tpu_torch.pipeline.api.keras.engine import \
            tree_leaves
        rows = [("Layer (type)", "Output Shape", "Param #")]
        total = 0
        for lyr in self.layers:
            n = (sum(int(t.numel()) for t in
                     tree_leaves(params.get(lyr.name, {})))
                 if params else 0)
            total += n
            rows.append((f"{lyr.name} ({type(lyr).__name__})",
                         str(lyr.output_shape), str(n) if params else "?"))
        widths = [max(len(r[i]) for r in rows) + 2 for i in range(3)]
        lines = ["=" * line_length]
        for i, r in enumerate(rows):
            lines.append("".join(c.ljust(w) for c, w in zip(r, widths)))
            if i == 0:
                lines.append("-" * line_length)
        lines.append("=" * line_length)
        if params:
            lines.append(f"Total params: {total}")
        text = "\n".join(lines)
        print(text)
        return text

    # -- inference ----------------------------------------------------------
    def forward(self, inputs):
        return self.call(self.params(), inputs)

    def call(self, params, inputs, *, training=False, rng=None):
        return self.apply(params, inputs, training=training, rng=rng)[0]

    def predict(self, x, batch_size: int = 32):
        """Forward ``x`` (a host array or tensor, or a list of them for
        a multi-input net, each batched along its first axis) in batches
        of ``batch_size`` on the net's device; returns a host array, or
        one per output of a multi-output net."""
        if not self.initialized:
            self.init_params()
        multi = isinstance(x, (list, tuple))
        xs = [to_tensor(a, self.device) for a in (x if multi else [x])]
        n = xs[0].shape[0]
        if any(a.shape[0] != n for a in xs):
            raise ValueError("inconsistent sample counts in x: "
                             f"{[a.shape[0] for a in xs]}")
        with torch.inference_mode():
            return concat_outputs(
                [to_numpy(self.forward(
                    [a[i:i + batch_size] for a in xs] if multi
                    else xs[0][i:i + batch_size]))
                 for i in range(0, n, batch_size)])

    def predict_classes(self, x, batch_size: int = 32,
                        zero_based_label: bool = True) -> np.ndarray:
        classes = np.argmax(self.predict(x, batch_size=batch_size), axis=-1)
        return classes if zero_based_label else classes + 1


class Sequential(KerasNet):
    """Linear stack of layers."""

    def __init__(self, layers: Optional[Sequence[KerasLayer]] = None,
                 name: Optional[str] = None):
        super().__init__(name=name or unique_name("sequential"))
        self._stack: "list[KerasLayer]" = []
        self._register([])
        for lyr in layers or []:
            self.add(lyr)

    def add(self, layer: KerasLayer) -> "Sequential":
        if not isinstance(layer, KerasLayer):
            raise TypeError(f"expected a KerasLayer, got {type(layer)}")
        if not self._stack and layer._given_input_shape is None:
            raise ValueError(
                "first layer of a Sequential needs input_shape=...")
        self._stack.append(layer)
        self._canonicalize_names(self._stack)
        self._register(self._stack)
        return self

    def init(self, generator: torch.Generator,
             input_shape: Optional[ShapeLike] = None) -> dict:
        if input_shape is None:
            if not self._stack:
                raise ValueError("empty Sequential")
            input_shape = self._stack[0]._given_input_shape
        self._build_input_shape = input_shape
        shape = input_shape
        for lyr in self._stack:
            lyr.init(generator, shape)
            shape = lyr.output_shape
        self._output_shape = shape
        return self.params()

    def compute_output_shape(self, input_shape: ShapeLike) -> ShapeLike:
        shape = input_shape
        for lyr in self._stack:
            shape = lyr.compute_output_shape(shape)
        return shape

    def apply(self, params, inputs, *, training=False, rng=None):
        x = inputs
        updates: dict = {}
        for i, lyr in enumerate(self._stack):
            sub_rng = None if rng is None else fold_in(rng, i)
            x, upd = lyr.apply(params[lyr.name], x, training=training,
                               rng=sub_rng)
            if upd:
                updates[lyr.name] = upd
        return x, updates


class Model(KerasNet):
    """Functional graph model, built from ``Input(...)`` variables
    through layer calls; a layer used at several nodes has one set of
    params."""

    def __init__(self, inputs: "Variable | Sequence[Variable]",
                 outputs: "Variable | Sequence[Variable]",
                 name: Optional[str] = None):
        super().__init__(name=name or unique_name("model"))
        self.inputs: "list[Variable]" = (
            list(inputs) if isinstance(inputs, (list, tuple)) else [inputs])
        self.outputs: "list[Variable]" = (
            list(outputs) if isinstance(outputs, (list, tuple))
            else [outputs])
        self._order = topological_order(self.outputs)
        for v in self.inputs:
            if v not in self._order:
                raise ValueError(f"input {v} is not connected to outputs")
        graph_layers = collect_layers(self._order)
        self._multi_out = isinstance(outputs, (list, tuple))
        old_names = {id(lyr): lyr.name for lyr in graph_layers}
        self._canonicalize_names(graph_layers)
        for v in self._order:
            if v.layer is not None and \
                    v.name == old_names.get(id(v.layer)):
                v.name = v.layer.name
        self._register(graph_layers)

    def init(self, generator: torch.Generator,
             input_shape: Optional[ShapeLike] = None) -> dict:
        """Build every layer in graph order, each at its node's input
        shape, from one generator. On this model's first build, a layer
        another net already built at that shape keeps its weights: the
        layers live in the graph, so a model made over another's nodes
        (:meth:`new_graph`, a new head on them) shares them, where the
        reference's functional params are copied; a second build of
        this model draws every layer anew."""
        del input_shape  # graph shapes come from the Input variables
        first = not self.initialized
        built = set()
        for v in self._order:
            lyr = v.layer
            if lyr is None or isinstance(lyr, _InputLayer) or \
                    id(lyr) in built:
                continue
            if not v.parents:   # a Parameter or a Constant
                in_shape: ShapeLike = v.shape
            else:
                in_shape = ([p.shape for p in v.parents]
                            if len(v.parents) > 1 else v.parents[0].shape)
            if not (first and "weights" in lyr._modules and
                    lyr.input_shape == in_shape):
                lyr.init(generator, in_shape)
            built.add(id(lyr))
        shapes = [v.shape for v in self.outputs]
        self._output_shape = shapes if self._multi_out else shapes[0]
        return self.params()

    def compute_output_shape(self, input_shape: ShapeLike) -> ShapeLike:
        shapes = [v.shape for v in self.outputs]
        return shapes if self._multi_out else shapes[0]

    def apply(self, params, inputs, *, training=False, rng=None):
        xs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        if len(xs) != len(self.inputs):
            raise ValueError(f"model {self.name} expects "
                             f"{len(self.inputs)} inputs, got {len(xs)}")
        values: "dict[int, Any]" = {id(v): x
                                    for v, x in zip(self.inputs, xs)}
        updates: dict = {}
        for i, v in enumerate(self._order):
            if id(v) in values:
                continue
            lyr = v.layer
            if lyr is None or isinstance(lyr, _InputLayer):
                raise ValueError(
                    f"graph input {v.name} was not fed; it must be listed "
                    "in Model(inputs=...)")
            args = [values[id(p)] for p in v.parents]
            values[id(v)], upd = lyr.apply(
                params[lyr.name],
                None if not args else args if len(args) > 1 else args[0],
                training=training,
                rng=None if rng is None else fold_in(rng, i))
            if upd:
                # a shared layer may update at several nodes; last wins
                updates[lyr.name] = upd
        outs = [values[id(v)] for v in self.outputs]
        return (outs if self._multi_out else outs[0]), updates

    def new_graph(self, output_names: "list[str]") -> "Model":
        """The sub-graph from this model's inputs to the named nodes
        (reference ``GraphNet.newGraph``: transfer-learning surgery).
        It shares this model's layers, and so their weights."""
        by_name = {v.name: v for v in self._order}
        missing = [n for n in output_names if n not in by_name]
        if missing:
            raise ValueError(f"no graph nodes named {missing}")
        outs = [by_name[n] for n in output_names]
        return Model(self.inputs, outs if len(outs) > 1 else outs[0])

    def freeze_up_to(self, *node_names: str) -> "Model":
        """Freeze every layer at or before the named nodes (reference
        ``freezeUpTo``): their trainable leaves get no optimizer update
        (:meth:`trainable_mask`), while a frozen BatchNormalization's
        moving statistics still follow the batches in training, as in
        the reference."""
        by_name = {v.name: v for v in self._order}
        missing = [n for n in node_names if n not in by_name]
        if missing:
            raise ValueError(f"no graph nodes named {missing}")
        frontier = [by_name[n] for n in node_names]
        seen = set()
        while frontier:
            v = frontier.pop()
            if id(v) in seen:
                continue
            seen.add(id(v))
            if v.layer is not None and not isinstance(v.layer, _InputLayer):
                v.layer.trainable = False
            frontier.extend(v.parents)
        return self
