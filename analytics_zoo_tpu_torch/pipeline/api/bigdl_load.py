"""BigDL / zoo-Keras saved-model importer (port of
``analytics_zoo_tpu/pipeline/api/bigdl_load.py``).

``Net.load_bigdl(path)`` / ``Net.load(path)`` read BigDL ``.model``
protobuf files, the analytics-zoo Keras-style models saved by
``KerasNet.saveModel`` among them, through the self-contained
:mod:`bigdl_pb` codec and rebuild them as a ``Sequential`` in
channels-first layout (BigDL tensors are NCHW), with the weights copied
onto the context's device, so they predict and fine-tune in the port.

Supported modules: Linear, SpatialConvolution/MaxPooling/AveragePooling/
BatchNormalization, Reshape/InferReshape/View, the activations, Dropout,
LookupTable, Sequential, a StaticGraph with a linear topology, and the
zoo keras wrapper layers. Anything else raises ``NotImplementedError``
naming the module type.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.pipeline.api import bigdl_pb as pb


def _attr_int(am, key, default=None):
    v = am.get(key)
    if v is None:
        return default
    for f in ("int32Value", "int64Value"):
        x = getattr(v, f)
        if x is not None:
            return int(x)
    return default


def _attr_bool(am, key, default=None):
    v = am.get(key)
    if v is None or v.boolValue is None:
        return default
    return bool(v.boolValue)


def _attr_float(am, key, default=None):
    v = am.get(key)
    if v is None:
        return default
    for f in ("floatValue", "doubleValue"):
        x = getattr(v, f)
        if x is not None:
            return float(x)
    return default


def _attr_ints(am, key):
    v = am.get(key)
    if v is None or v.arrayValue is None:
        return None
    a = v.arrayValue
    return [int(x) for x in (a.i32 or a.i64 or [])]


def _short(module_type: str) -> str:
    return (module_type or "").split(".")[-1]


_ACTIVATION_TYPES = {
    "Tanh": "tanh", "ReLU": "relu", "Sigmoid": "sigmoid",
    "LogSoftMax": "log_softmax", "SoftMax": "softmax",
    "SoftPlus": "softplus", "ELU": "elu", "HardSigmoid": "hard_sigmoid",
    "SoftSign": "softsign",
}

_SKIP_TYPES = {"Identity", "Input", "Echo", "Contiguous"}


class _Converted:
    """One imported layer + its weight assignments (param name →
    ndarray), applied after shape inference initializes the model."""

    def __init__(self, layer, weights: Optional[Dict[str, np.ndarray]]
                 = None):
        self.layer = layer
        self.weights = weights or {}


def _find_first(module: pb.BigDLModule, type_suffix: str) \
        -> Optional[pb.BigDLModule]:
    if _short(module.moduleType) == type_suffix:
        return module
    for s in module.subModules:
        hit = _find_first(s, type_suffix)
        if hit is not None:
            return hit
    return None


def _node_name(s: pb.BigDLModule) -> str:
    """Graph-node identity: explicit name, else BigDL's default
    SimpleName + namePostfix (how unnamed nodes appear in pre/next
    lists and ``*_edges`` attrs)."""
    if s.name:
        return s.name
    return _short(s.moduleType) + (s.namePostfix or "")


def _chain_order(graph: pb.BigDLModule) -> List[pb.BigDLModule]:
    """Order a StaticGraph's submodules along their (linear) pre/next
    chain. The serialized list is reverse-topological; reconstruct from
    preModules (reference builds graphs as node(prev) chains)."""
    subs = [s for s in graph.subModules]
    starts = [s for s in subs if not list(s.preModules)]
    if len(starts) != 1:
        raise NotImplementedError(
            "only linear BigDL graphs are importable (found "
            f"{len(starts)} start nodes)")
    order = [starts[0]]
    seen = {_node_name(starts[0])}
    while len(order) < len(subs):
        nxt = [s for s in subs
               if _node_name(s) not in seen and
               list(s.preModules) == [_node_name(order[-1])]]
        if len(nxt) != 1:
            raise NotImplementedError(
                f"non-linear BigDL graph at "
                f"{_node_name(order[-1])!r} ({len(nxt)} successors)")
        order.append(nxt[0])
        seen.add(_node_name(nxt[0]))
    return order


def _convert_module(m: pb.BigDLModule, table: pb.StorageTable) \
        -> List[_Converted]:
    """BigDLModule → list of imported layers (containers flatten)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L

    t = _short(m.moduleType)
    am = m.attr_map()
    name = m.name or None

    # containers --------------------------------------------------------
    if t in ("Sequential", "Model"):
        out: List[_Converted] = []
        for s in m.subModules:
            out.extend(_convert_module(s, table))
        return out
    if t == "StaticGraph":
        out = []
        for s in _chain_order(m):
            out.extend(_convert_module(s, table))
        return out
    if t in _SKIP_TYPES:
        return []

    # zoo keras wrapper layers (labor tree carries the weights) ---------
    if ".keras.layers." in (m.moduleType or ""):
        return _convert_keras_wrapper(m, table)

    w = table.tensor_to_numpy(m.weight)
    b = table.tensor_to_numpy(m.bias)
    if w is None and m.parameters:
        # newer BigDL serializes weights into `parameters` (field 16)
        # instead of the deprecated weight/bias fields
        w = table.tensor_to_numpy(m.parameters[0])
        if len(m.parameters) > 1:
            b = table.tensor_to_numpy(m.parameters[1])

    if t == "Linear":
        out_dim = _attr_int(am, "outputSize", w.shape[0] if w is not None
                            else None)
        lyr = L.Dense(out_dim, bias=b is not None, name=name)
        ws = {}
        if w is not None:
            ws["kernel"] = np.ascontiguousarray(w.T)
        if b is not None:
            ws["bias"] = b
        return [_Converted(lyr, ws)]

    if t == "SpatialConvolution":
        n_out = _attr_int(am, "nOutputPlane")
        kw = _attr_int(am, "kernelW")
        kh = _attr_int(am, "kernelH")
        sw = _attr_int(am, "strideW", 1)
        sh = _attr_int(am, "strideH", 1)
        pw = _attr_int(am, "padW", 0)
        ph = _attr_int(am, "padH", 0)
        group = _attr_int(am, "nGroup", 1)
        if group != 1:
            raise NotImplementedError(
                "grouped SpatialConvolution import not supported")
        layers = []
        border = "valid"
        if pw == -1 or ph == -1:
            border = "same"  # BigDL's SAME-pad convention
        elif pw or ph:
            layers.append(_Converted(
                L.ZeroPadding2D(padding=(ph, pw), dim_ordering="th")))
        lyr = L.Convolution2D(
            n_out, (kh, kw), subsample=(sh, sw), border_mode=border,
            dim_ordering="th", bias=b is not None, name=name)
        ws = {}
        if w is not None:
            if w.ndim == 5:  # [group, out, in, kH, kW]
                w = w.reshape(w.shape[0] * w.shape[1], *w.shape[2:])
            # OIHW → HWIO (the Keras kernel layout)
            ws["kernel"] = np.ascontiguousarray(
                np.transpose(w, (2, 3, 1, 0)))
        if b is not None:
            ws["bias"] = b
        layers.append(_Converted(lyr, ws))
        return layers

    if t in ("SpatialMaxPooling", "SpatialAveragePooling"):
        kw = _attr_int(am, "kW")
        kh = _attr_int(am, "kH")
        sw = _attr_int(am, "dW", kw)
        sh = _attr_int(am, "dH", kh)
        pw = _attr_int(am, "padW", 0)
        ph = _attr_int(am, "padH", 0)
        if pw or ph:
            raise NotImplementedError(
                "padded BigDL pooling import not supported (explicit "
                "-inf/zero pad semantics differ)")
        cls = (L.MaxPooling2D if t == "SpatialMaxPooling"
               else L.AveragePooling2D)
        return [_Converted(cls(pool_size=(kh, kw), strides=(sh, sw),
                               dim_ordering="th", name=name))]

    if t in ("SpatialBatchNormalization", "BatchNormalization"):
        eps = _attr_float(am, "eps", 1e-5)
        mom = _attr_float(am, "momentum", 0.1)
        lyr = L.BatchNormalization(epsilon=eps, momentum=1.0 - mom,
                                   dim_ordering="th", name=name)
        ws: Dict[str, Any] = {}
        if w is not None:
            ws["gamma"] = w
        if b is not None:
            ws["beta"] = b
        rm = table.tensor_to_numpy(
            am["runningMean"].tensorValue) if "runningMean" in am \
            else None
        rv = table.tensor_to_numpy(
            am["runningVar"].tensorValue) if "runningVar" in am else None
        state = {}
        if rm is not None:
            state["moving_mean"] = rm
        if rv is not None:
            state["moving_var"] = rv
        if state:
            ws["_state"] = state
        return [_Converted(lyr, ws)]

    if t in ("Reshape", "InferReshape"):
        size = _attr_ints(am, "size") or []
        if t == "InferReshape" and (not size or -1 in size):
            # keras-wrapper plumbing reshape — flatten-to-2D
            return [_Converted(L.Flatten(name=name))] \
                if size == [-1] or not size else \
                [_Converted(L.Reshape(tuple(size), name=name))]
        return [_Converted(L.Reshape(tuple(size), name=name))]

    if t == "View":
        size = _attr_ints(am, "size") or []
        return [_Converted(L.Reshape(tuple(size), name=name))]

    if t == "Dropout":
        p = _attr_float(am, "initP", 0.5)
        return [_Converted(L.Dropout(p, name=name))]

    if t == "LookupTable":
        n_index = _attr_int(am, "nIndex")
        n_out = _attr_int(am, "nOutput")
        lyr = L.Embedding(n_index, n_out, name=name)
        ws = {"embeddings": w} if w is not None else {}
        return [_Converted(lyr, ws)]

    if t in _ACTIVATION_TYPES:
        return [_Converted(L.Activation(_ACTIVATION_TYPES[t],
                                        name=name))]

    raise NotImplementedError(
        f"BigDL module type {m.moduleType!r} has no import mapping")


def _convert_keras_wrapper(m: pb.BigDLModule, table: pb.StorageTable) \
        -> List[_Converted]:
    """zoo keras layer wrapper → native keras layer, weights harvested
    from the serialized labor subtree."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L

    t = _short(m.moduleType)
    am = m.attr_map()
    name = m.name or None
    act = None
    if "activation" in am and am["activation"].stringValue:
        act = am["activation"].stringValue

    if t == "Dense":
        out_dim = _attr_int(am, "outputDim")
        linear = _find_first(m, "Linear")
        ws = {}
        if linear is not None:
            w = table.tensor_to_numpy(linear.weight)
            b = table.tensor_to_numpy(linear.bias)
            if w is not None:
                ws["kernel"] = np.ascontiguousarray(w.T)
            if b is not None:
                ws["bias"] = b
        lyr = L.Dense(out_dim, activation=act, bias=bool(ws.get("bias")
                      is not None), name=name)
        return [_Converted(lyr, ws)]

    if t in ("Input", "InputLayer"):
        return []

    # generic fallback: convert the labor subtree
    out: List[_Converted] = []
    for s in m.subModules:
        out.extend(_convert_module(s, table))
    if not out:
        raise NotImplementedError(
            f"zoo keras layer {m.moduleType!r} has no import "
            "mapping")
    return out


def load_bigdl(path: str, input_shape: Optional[Tuple[int, ...]] = None):
    """Load a BigDL/zoo-Keras ``.model`` file into a native
    `Sequential` (reference `Net.loadBigDL`, Net.scala:91).

    ``input_shape`` (sans batch, channels-first for images) may be
    omitted when the saved model carries its own leading Reshape or an
    inputShape attr.
    """
    root = pb.load_model(path)
    table = pb.StorageTable(root)
    converted = _convert_module(root, table)
    if not converted:
        raise ValueError(f"{path}: no importable layers")

    if input_shape is None:
        input_shape = _infer_input_shape(root, converted)
    if input_shape is None:
        raise ValueError(
            "input_shape could not be inferred from the saved model; "
            "pass input_shape=")

    from analytics_zoo_tpu_torch.pipeline.api._import_common import \
        build_sequential
    return build_sequential([(c.layer, c.weights) for c in converted],
                            input_shape, "load_bigdl")


def _infer_input_shape(root: pb.BigDLModule, converted) -> \
        Optional[Tuple[int, ...]]:
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense, \
        Reshape

    # a keras-style saved model records inputShape on its layers
    def walk(m):
        am = m.attr_map()
        v = am.get("inputShape")
        if v is not None and v.shape is not None and v.shape.shapeValue:
            return tuple(int(x) for x in v.shape.shapeValue)
        for s in m.subModules:
            r = walk(s)
            if r is not None:
                return r
        return None

    shape = walk(root)
    if shape is not None:
        return shape
    first = converted[0].layer
    # a leading Reshape pins everything downstream; feed it flat input
    if isinstance(first, Reshape):
        return (int(np.prod(first.target_shape)),)
    if isinstance(first, Dense) and "kernel" in converted[0].weights:
        return (int(converted[0].weights["kernel"].shape[0]),)
    return None
