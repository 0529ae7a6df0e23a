"""ONNX graph construction helpers (``onnx.helper`` analog).

Used by tests to fabricate golden models and by users to export simple
graphs. Mirrors the surface the reference's ONNX backend tests rely on
(`P/pipeline/api/onnx/onnx_loader.py:51` ``run_node`` op tests).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.pipeline.api.onnx.onnx_pb import (
    AttributeProto,
    GraphProto,
    ModelProto,
    NodeProto,
    OperatorSetIdProto,
    TensorProto,
    TensorShapeDim,
    TensorShapeProto,
    TensorTypeProto,
    TypeProto,
    ValueInfoProto,
    numpy_to_tensor,
)

__all__ = [
    "make_attribute", "make_node", "make_graph", "make_model",
    "make_tensor", "make_tensor_value_info",
]


def make_attribute(name: str, value: Any) -> AttributeProto:
    a = AttributeProto()
    a.name = name
    if isinstance(value, bool):
        a.i, a.type = int(value), AttributeProto.INT
    elif isinstance(value, (int, np.integer)):
        a.i, a.type = int(value), AttributeProto.INT
    elif isinstance(value, (float, np.floating)):
        a.f, a.type = float(value), AttributeProto.FLOAT
    elif isinstance(value, str):
        a.s, a.type = value.encode("utf-8"), AttributeProto.STRING
    elif isinstance(value, bytes):
        a.s, a.type = value, AttributeProto.STRING
    elif isinstance(value, TensorProto):
        a.t, a.type = value, AttributeProto.TENSOR
    elif isinstance(value, GraphProto):
        a.g, a.type = value, AttributeProto.GRAPH
    elif isinstance(value, np.ndarray):
        a.t, a.type = numpy_to_tensor(value), AttributeProto.TENSOR
    elif isinstance(value, (list, tuple)):
        if not value:
            a.ints, a.type = [], AttributeProto.INTS
        elif all(isinstance(v, (int, np.integer, bool)) for v in value):
            a.ints = [int(v) for v in value]
            a.type = AttributeProto.INTS
        elif all(isinstance(v, (int, float, np.floating, np.integer))
                 for v in value):
            a.floats = [float(v) for v in value]
            a.type = AttributeProto.FLOATS
        elif all(isinstance(v, (str, bytes)) for v in value):
            a.strings = [v.encode("utf-8") if isinstance(v, str) else v
                         for v in value]
            a.type = AttributeProto.STRINGS
        else:
            raise TypeError(f"mixed attribute list for {name}: {value!r}")
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return a


def attribute_value(a: AttributeProto) -> Any:
    """Decode an AttributeProto into a plain Python value."""
    t = a.type
    if t == AttributeProto.FLOAT:
        return float(a.f)
    if t == AttributeProto.INT:
        return int(a.i)
    if t == AttributeProto.STRING:
        return (a.s or b"").decode("utf-8")
    if t == AttributeProto.TENSOR:
        return a.t
    if t == AttributeProto.GRAPH:
        return a.g
    if t == AttributeProto.FLOATS:
        return [float(v) for v in a.floats]
    if t == AttributeProto.INTS:
        return [int(v) for v in a.ints]
    if t == AttributeProto.STRINGS:
        return [v.decode("utf-8") for v in a.strings]
    if t == AttributeProto.TENSORS:
        return list(a.tensors)
    # untyped attributes (some exporters omit .type): best effort
    if a.ints:
        return [int(v) for v in a.ints]
    if a.floats:
        return [float(v) for v in a.floats]
    if a.i is not None:
        return int(a.i)
    if a.f is not None:
        return float(a.f)
    if a.s is not None:
        return a.s.decode("utf-8")
    if a.t is not None:
        return a.t
    return None


def make_node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
              name: str = "", **attrs: Any) -> NodeProto:
    n = NodeProto()
    n.op_type = op_type
    n.input = list(inputs)
    n.output = list(outputs)
    n.name = name or None
    n.attribute = [make_attribute(k, v) for k, v in sorted(attrs.items())
                   if v is not None]
    return n


def make_tensor(name: str, arr: np.ndarray) -> TensorProto:
    return numpy_to_tensor(np.asarray(arr), name)


def make_tensor_value_info(name: str, elem_type: int,
                           shape: Optional[Sequence] = None
                           ) -> ValueInfoProto:
    vi = ValueInfoProto()
    vi.name = name
    tt = TensorTypeProto()
    tt.elem_type = elem_type
    if shape is not None:
        sp = TensorShapeProto()
        for d in shape:
            dim = TensorShapeDim()
            if isinstance(d, str):
                dim.dim_param = d
            elif d is not None:
                dim.dim_value = int(d)
            sp.dim.append(dim)
        tt.shape = sp
    ty = TypeProto()
    ty.tensor_type = tt
    vi.type = ty
    return vi


def make_graph(nodes: Sequence[NodeProto], name: str,
               inputs: Sequence[ValueInfoProto],
               outputs: Sequence[ValueInfoProto],
               initializer: Sequence[TensorProto] = ()) -> GraphProto:
    g = GraphProto()
    g.node = list(nodes)
    g.name = name
    g.input = list(inputs)
    g.output = list(outputs)
    g.initializer = list(initializer)
    return g


def make_model(graph: GraphProto, opset_version: int = 13,
               producer_name: str = "analytics-zoo-tpu") -> ModelProto:
    m = ModelProto()
    m.ir_version = 8
    m.producer_name = producer_name
    m.graph = graph
    op = OperatorSetIdProto()
    op.domain = ""
    op.version = opset_version
    m.opset_import = [op]
    return m
