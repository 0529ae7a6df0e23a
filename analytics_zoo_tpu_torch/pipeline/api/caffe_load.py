"""Caffe model importer: prototxt + caffemodel → a ``Sequential`` (port
of ``analytics_zoo_tpu/pipeline/api/caffe_load.py``).

Self-contained, as the reference's:

- a protobuf TEXT-format parser for the ``.prototxt`` architecture
  (scalars, strings, enums, nested blocks, repeated fields);
- a binary ``NetParameter`` codec (on the shared proto base) for the
  ``.caffemodel`` weights, matched to layers by name (V2 ``layer`` and
  V1 ``layers`` both);
- the layer mapping onto the Keras layers in channels-first ("th")
  layout throughout (Caffe is NCHW): Convolution, InnerProduct,
  Pooling, ReLU/Sigmoid/TanH/Softmax/ELU, Dropout, BatchNorm (+Scale),
  Flatten, Input.

The weights land on the context's device (the card unless the caller
asked for the CPU).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.pipeline.api.onnx.onnx_pb import (
    Message, _MESSAGE_TYPES)


# -- binary caffemodel schema -------------------------------------------------

class BlobShape(Message):
    FIELDS = {1: ("dim", "int64", True)}


class BlobProto(Message):
    FIELDS = {
        1: ("num", "int64", False),
        2: ("channels", "int64", False),
        3: ("height", "int64", False),
        4: ("width", "int64", False),
        5: ("data", "float", True),
        7: ("shape", "BlobShape", False),
        9: ("double_data", "double", True),
    }

    def to_numpy(self) -> np.ndarray:
        data = (np.asarray(self.double_data, np.float64)
                if self.double_data else
                np.asarray(self.data, np.float32))
        if self.shape is not None and self.shape.dim:
            return data.reshape([int(d) for d in self.shape.dim])
        legacy = [self.num, self.channels, self.height, self.width]
        if any(v is not None for v in legacy):
            shape = [int(v) for v in legacy if v is not None]
            try:
                return data.reshape(shape)
            except ValueError:
                pass
        return data


class CaffeLayerParameter(Message):
    FIELDS = {
        1: ("name", "string", False),
        2: ("type", "string", False),
        3: ("bottom", "string", True),
        4: ("top", "string", True),
        7: ("blobs", "BlobProto", True),
    }


class CaffeV1LayerParameter(Message):
    # V1 (caffe.proto): bottom=2, top=3, name=4, type(enum)=5, blobs=6
    FIELDS = {
        2: ("bottom", "string", True),
        3: ("top", "string", True),
        4: ("name", "string", False),
        5: ("type", "int64", False),
        6: ("blobs", "BlobProto", True),
    }


class NetParameter(Message):
    FIELDS = {
        1: ("name", "string", False),
        2: ("layers", "CaffeV1LayerParameter", True),  # V1
        3: ("input", "string", True),
        4: ("input_dim", "int64", True),
        8: ("input_shape", "BlobShape", True),
        100: ("layer", "CaffeLayerParameter", True),   # V2
    }


_MESSAGE_TYPES.update({
    "BlobShape": BlobShape,
    "BlobProto": BlobProto,
    "CaffeLayerParameter": CaffeLayerParameter,
    "CaffeV1LayerParameter": CaffeV1LayerParameter,
    "NetParameter": NetParameter,
})

# V1 LayerType enum values → V2 type strings (subset); binary protos
# carry the int, text prototxts the UPPERCASE enum identifier
_V1_TYPES = {
    4: "Convolution", 14: "InnerProduct", 17: "Pooling", 18: "ReLU",
    19: "Sigmoid", 20: "Softmax", 21: "SoftmaxWithLoss", 23: "TanH",
    6: "Dropout", 5: "Data", 8: "Flatten", 15: "LRN",
}
_V1_NAME_TYPES = {
    "CONVOLUTION": "Convolution", "INNER_PRODUCT": "InnerProduct",
    "POOLING": "Pooling", "RELU": "ReLU", "SIGMOID": "Sigmoid",
    "SOFTMAX": "Softmax", "SOFTMAX_LOSS": "SoftmaxWithLoss",
    "TANH": "TanH", "DROPOUT": "Dropout", "DATA": "Data",
    "FLATTEN": "Flatten", "LRN": "LRN",
}


# -- prototxt text-format parser ----------------------------------------------

_TOKEN = re.compile(
    r'\s*(?:(#[^\n]*)|([A-Za-z_][A-Za-z0-9_]*)|("(?:[^"\\]|\\.)*")'
    r"|([{}:])|([^\s{}:#]+))")


def _tokenize(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None or m.end() == pos:
            break
        pos = m.end()
        comment, ident, string, punct, other = m.groups()
        if comment:
            continue
        if ident is not None:
            yield ident
        elif string is not None:
            yield ("STR", string[1:-1])
        elif punct is not None:
            yield punct
        elif other is not None:
            yield ("VAL", other)


def parse_prototxt(text: str) -> "Dict[str, list]":
    """Protobuf text format → {field: [values]} with nested dicts for
    blocks. Every field is a list (repeated-friendly)."""
    tokens = list(_tokenize(text))
    pos = 0

    def block():
        nonlocal pos
        out: Dict[str, list] = {}
        while pos < len(tokens) and tokens[pos] != "}":
            key = tokens[pos]
            if not isinstance(key, str):
                raise ValueError(f"prototxt parse error near {key!r}")
            pos += 1
            if pos < len(tokens) and tokens[pos] == ":":
                pos += 1
                tok = tokens[pos]
                pos += 1
                if isinstance(tok, tuple):
                    kind, raw = tok
                    value = raw if kind == "STR" else _coerce(raw)
                else:
                    value = _coerce(tok)  # enum identifier
                out.setdefault(key, []).append(value)
            elif pos < len(tokens) and tokens[pos] == "{":
                pos += 1
                value = block()
                if pos >= len(tokens) or tokens[pos] != "}":
                    raise ValueError("prototxt: unbalanced braces")
                pos += 1
                out.setdefault(key, []).append(value)
            else:
                raise ValueError(f"prototxt parse error after {key!r}")
        return out

    def _coerce(raw: str):
        for cast in (int, float):
            try:
                return cast(raw)
            except (TypeError, ValueError):
                continue
        if raw in ("true", "false"):
            return raw == "true"
        return raw

    return block()


def _one(d: dict, key: str, default=None):
    v = d.get(key)
    return v[0] if v else default


# -- importer -----------------------------------------------------------------

def load_caffe(def_path: str, model_path: Optional[str] = None,
               input_shape: Optional[Tuple[int, ...]] = None):
    """(reference `Net.loadCaffe`, Net.scala:130) → native Sequential,
    channels-first. ``model_path`` may be omitted for a weights-free
    architecture load (random init)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L

    with open(def_path) as f:
        net_def = parse_prototxt(f.read())

    blobs_by_name: Dict[str, List[np.ndarray]] = {}
    if model_path is not None:
        with open(model_path, "rb") as f:
            weights = NetParameter()
            weights.ParseFromString(f.read())
        for lyr in list(weights.layer) + list(weights.layers):
            if lyr.blobs:
                blobs_by_name[lyr.name] = [b.to_numpy()
                                           for b in lyr.blobs]

    # input shape: explicit arg > input_shape block > input_dim
    if input_shape is None:
        ishape = net_def.get("input_shape")
        if ishape:
            dims = ishape[0].get("dim", [])
            input_shape = tuple(int(d) for d in dims[1:])
        elif net_def.get("input_dim"):
            input_shape = tuple(int(d)
                                for d in net_def["input_dim"][1:])

    layer_defs = net_def.get("layer") or net_def.get("layers") or []
    converted: List[Tuple[Any, Dict[str, np.ndarray]]] = []
    flattened = False

    for ld in layer_defs:
        lname = _one(ld, "name")
        ltype = _one(ld, "type")
        if isinstance(ltype, int):
            ltype = _V1_TYPES.get(ltype, str(ltype))
        elif isinstance(ltype, str) and ltype in _V1_NAME_TYPES:
            ltype = _V1_NAME_TYPES[ltype]  # V1 text-format enum name
        blobs = blobs_by_name.get(lname, [])
        if ltype in ("Input", "Data", "DummyData"):
            p = _one(ld, "input_param")
            if input_shape is None and p:
                dims = _one(p, "shape", {}).get("dim", [])
                input_shape = tuple(int(d) for d in dims[1:])
            continue

        if ltype == "Convolution":
            p = _one(ld, "convolution_param", {})
            n_out = _one(p, "num_output")
            kh = _one(p, "kernel_h", _one(p, "kernel_size"))
            kw = _one(p, "kernel_w", _one(p, "kernel_size"))
            sh = _one(p, "stride_h", _one(p, "stride", 1))
            sw = _one(p, "stride_w", _one(p, "stride", 1))
            ph = _one(p, "pad_h", _one(p, "pad", 0))
            pw = _one(p, "pad_w", _one(p, "pad", 0))
            groups = int(_one(p, "group", 1))
            if ph or pw:
                converted.append((L.ZeroPadding2D(
                    padding=(ph, pw), dim_ordering="th"), {}))
            bias_term = _one(p, "bias_term", True)
            ws: Dict[str, np.ndarray] = {}
            if blobs:
                # legacy blobs may carry sparse dims; the prototxt pins
                # (out, kh, kw), leaving in_channels = size/(out*kh*kw)
                w = blobs[0].reshape(int(n_out), -1, int(kh), int(kw))
                ws["kernel"] = np.ascontiguousarray(
                    np.transpose(w, (2, 3, 1, 0)))  # OIHW → HWIO
                if bias_term and len(blobs) > 1:
                    ws["bias"] = blobs[1].reshape(-1)
            converted.append((L.Convolution2D(
                n_out, (kh, kw), subsample=(sh, sw),
                border_mode="valid", dim_ordering="th", groups=groups,
                bias=bool(bias_term), name=lname), ws))
        elif ltype == "InnerProduct":
            p = _one(ld, "inner_product_param", {})
            n_out = _one(p, "num_output")
            bias_term = _one(p, "bias_term", True)
            if not flattened:
                converted.append((L.Flatten(), {}))
                flattened = True
            ws = {}
            if blobs:
                w = blobs[0].reshape(int(n_out), -1)
                ws["kernel"] = np.ascontiguousarray(w.T)
                if bias_term and len(blobs) > 1:
                    ws["bias"] = blobs[1].reshape(-1)
            converted.append((L.Dense(
                n_out, bias=bool(bias_term), name=lname), ws))
        elif ltype == "Pooling":
            p = _one(ld, "pooling_param", {})
            pool = _one(p, "pool", "MAX")
            k = _one(p, "kernel_size", 2)
            kh = _one(p, "kernel_h", k)
            kw = _one(p, "kernel_w", k)
            s = _one(p, "stride", 1)  # caffe PoolingParameter default
            sh = _one(p, "stride_h", s)
            sw = _one(p, "stride_w", s)
            if _one(p, "global_pooling", False):
                cls = (L.GlobalMaxPooling2D if pool == "MAX"
                       else L.GlobalAveragePooling2D)
                converted.append((cls(dim_ordering="th", name=lname),
                                  {}))
                continue
            if _one(p, "pad", 0) or _one(p, "pad_h", 0) or \
                    _one(p, "pad_w", 0):
                raise NotImplementedError(
                    "padded Caffe pooling not supported")
            cls = (L.MaxPooling2D if pool == "MAX"
                   else L.AveragePooling2D)
            converted.append((cls(pool_size=(kh, kw), strides=(sh, sw),
                                  dim_ordering="th", name=lname), {}))
        elif ltype in ("ReLU", "Sigmoid", "TanH", "Softmax",
                       "SoftmaxWithLoss", "ELU"):
            act = {"ReLU": "relu", "Sigmoid": "sigmoid",
                   "TanH": "tanh", "Softmax": "softmax",
                   "SoftmaxWithLoss": "softmax", "ELU": "elu"}[ltype]
            converted.append((L.Activation(act, name=lname), {}))
        elif ltype == "Dropout":
            p = _one(ld, "dropout_param", {})
            converted.append((L.Dropout(
                _one(p, "dropout_ratio", 0.5), name=lname), {}))
        elif ltype == "BatchNorm":
            p = _one(ld, "batch_norm_param", {})
            eps = _one(p, "eps", 1e-5)
            lyr = L.BatchNormalization(
                epsilon=eps, dim_ordering="th", scale=False,
                center=False, name=lname)
            ws = {}
            if len(blobs) >= 3:
                scale = float(blobs[2].reshape(-1)[0]) or 1.0
                ws["_state"] = {
                    "moving_mean": blobs[0].reshape(-1) / scale,
                    "moving_var": blobs[1].reshape(-1) / scale,
                }
            converted.append((lyr, ws))
        elif ltype == "Scale":
            lyr = L.BatchNormalization(
                epsilon=0.0, dim_ordering="th", name=lname)
            ws = {}
            if blobs:
                ws["gamma"] = blobs[0].reshape(-1)
                if len(blobs) > 1:
                    ws["beta"] = blobs[1].reshape(-1)
                n = blobs[0].size
                ws["_state"] = {
                    "moving_mean": np.zeros((n,), np.float32),
                    "moving_var": np.ones((n,), np.float32),
                }
            converted.append((lyr, ws))
        elif ltype == "Flatten":
            converted.append((L.Flatten(name=lname), {}))
            flattened = True
        else:
            raise NotImplementedError(
                f"Caffe layer type {ltype!r} has no import mapping")

    if not converted:
        raise ValueError(f"{def_path}: no importable layers")
    if input_shape is None:
        raise ValueError("input_shape required (prototxt declares no "
                         "input dims)")

    from analytics_zoo_tpu_torch.pipeline.api._import_common import \
        build_sequential
    return build_sequential(converted, input_shape, "load_caffe")
