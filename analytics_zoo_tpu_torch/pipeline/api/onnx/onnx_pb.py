"""Minimal pure-Python ONNX protobuf codec (reader + writer).

The runtime image has no ``onnx`` package, so the framework carries its
own wire-format codec for the subset of the ONNX schema the importer
needs (ModelProto / GraphProto / NodeProto / AttributeProto /
TensorProto / ValueInfoProto / TypeProto / OperatorSetIdProto). Field
numbers match the official ``onnx.proto`` so real ``.onnx`` files parse.

Reference analog: the zoo's ONNX support sits on the ``onnx`` pip
package (`P/pipeline/api/onnx/onnx_loader.py:32`); here the codec is
part of the framework itself — no external dependency, and it can both
read and write, which the test-suite uses to fabricate golden models.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

# -- wire-format primitives ---------------------------------------------------

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


def _write_varint(buf: bytearray, value: int) -> None:
    if value < 0:  # two's-complement 64-bit, 10 bytes
        value += 1 << 64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")
    return result, pos


def _to_signed64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _skip(data: bytes, pos: int, wire: int) -> int:
    if wire == _WIRE_VARINT:
        _, pos = _read_varint(data, pos)
    elif wire == _WIRE_I64:
        pos += 8
    elif wire == _WIRE_LEN:
        n, pos = _read_varint(data, pos)
        pos += n
    elif wire == _WIRE_I32:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


# -- declarative message base -------------------------------------------------

class Message:
    """Base for schema-described messages.

    Subclasses define ``FIELDS``: {field_number: (name, kind, repeated)}
    where kind is one of ``int64``, ``float``, ``double``, ``string``,
    ``bytes``, or a Message subclass name (sub-message).
    """

    FIELDS: Dict[int, Tuple[str, str, bool]] = {}

    def __init__(self, **kwargs: Any):
        for _, (name, _, repeated) in self.FIELDS.items():
            setattr(self, name, [] if repeated else None)
        for k, v in kwargs.items():
            if not any(name == k for name, _, _ in self.FIELDS.values()):
                raise AttributeError(f"{type(self).__name__}.{k}")
            setattr(self, k, v)

    # -- encode ---------------------------------------------------------------
    def SerializeToString(self) -> bytes:
        buf = bytearray()
        for num, (name, kind, repeated) in sorted(self.FIELDS.items()):
            value = getattr(self, name)
            if value is None or (repeated and not len(value)):
                continue
            values = value if repeated else [value]
            if kind == "int64":
                if repeated:
                    # packed encoding for repeated scalars
                    packed = bytearray()
                    for v in values:
                        _write_varint(packed, int(v))
                    _write_varint(buf, _tag(num, _WIRE_LEN))
                    _write_varint(buf, len(packed))
                    buf += packed
                else:
                    _write_varint(buf, _tag(num, _WIRE_VARINT))
                    _write_varint(buf, int(values[0]))
            elif kind == "float":
                if repeated:
                    packed = b"".join(struct.pack("<f", float(v))
                                      for v in values)
                    _write_varint(buf, _tag(num, _WIRE_LEN))
                    _write_varint(buf, len(packed))
                    buf += packed
                else:
                    _write_varint(buf, _tag(num, _WIRE_I32))
                    buf += struct.pack("<f", float(values[0]))
            elif kind == "double":
                if repeated:
                    packed = b"".join(struct.pack("<d", float(v))
                                      for v in values)
                    _write_varint(buf, _tag(num, _WIRE_LEN))
                    _write_varint(buf, len(packed))
                    buf += packed
                else:
                    _write_varint(buf, _tag(num, _WIRE_I64))
                    buf += struct.pack("<d", float(values[0]))
            elif kind in ("string", "bytes"):
                for v in values:
                    raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
                    _write_varint(buf, _tag(num, _WIRE_LEN))
                    _write_varint(buf, len(raw))
                    buf += raw
            else:  # sub-message
                for v in values:
                    raw = v.SerializeToString()
                    _write_varint(buf, _tag(num, _WIRE_LEN))
                    _write_varint(buf, len(raw))
                    buf += raw
        return bytes(buf)

    # -- decode ---------------------------------------------------------------
    @classmethod
    def FromString(cls, data: bytes) -> "Message":
        msg = cls()
        msg.ParseFromString(data)
        return msg

    def ParseFromString(self, data: bytes) -> None:
        pos = 0
        end = len(data)
        registry = _MESSAGE_TYPES
        while pos < end:
            key, pos = _read_varint(data, pos)
            num, wire = key >> 3, key & 7
            spec = self.FIELDS.get(num)
            if spec is None:
                pos = _skip(data, pos, wire)
                continue
            name, kind, repeated = spec
            if kind == "int64":
                if wire == _WIRE_LEN:  # packed
                    n, pos = _read_varint(data, pos)
                    stop = pos + n
                    vals = []
                    while pos < stop:
                        v, pos = _read_varint(data, pos)
                        vals.append(_to_signed64(v))
                    getattr(self, name).extend(vals) if repeated else \
                        setattr(self, name, vals[-1] if vals else None)
                else:
                    v, pos = _read_varint(data, pos)
                    v = _to_signed64(v)
                    if repeated:
                        getattr(self, name).append(v)
                    else:
                        setattr(self, name, v)
            elif kind == "float":
                if wire == _WIRE_LEN:
                    n, pos = _read_varint(data, pos)
                    vals = [struct.unpack_from("<f", data, pos + i)[0]
                            for i in range(0, n, 4)]
                    pos += n
                    if repeated:
                        getattr(self, name).extend(vals)
                    elif vals:
                        setattr(self, name, vals[-1])
                else:
                    v = struct.unpack_from("<f", data, pos)[0]
                    pos += 4
                    if repeated:
                        getattr(self, name).append(v)
                    else:
                        setattr(self, name, v)
            elif kind == "double":
                if wire == _WIRE_LEN:
                    n, pos = _read_varint(data, pos)
                    vals = [struct.unpack_from("<d", data, pos + i)[0]
                            for i in range(0, n, 8)]
                    pos += n
                    if repeated:
                        getattr(self, name).extend(vals)
                    elif vals:
                        setattr(self, name, vals[-1])
                else:
                    v = struct.unpack_from("<d", data, pos)[0]
                    pos += 8
                    if repeated:
                        getattr(self, name).append(v)
                    else:
                        setattr(self, name, v)
            elif kind in ("string", "bytes"):
                n, pos = _read_varint(data, pos)
                raw = data[pos:pos + n]
                pos += n
                v: Any = raw.decode("utf-8") if kind == "string" else raw
                if repeated:
                    getattr(self, name).append(v)
                else:
                    setattr(self, name, v)
            else:  # sub-message
                n, pos = _read_varint(data, pos)
                sub = registry[kind]()
                sub.ParseFromString(data[pos:pos + n])
                pos += n
                if repeated:
                    getattr(self, name).append(sub)
                else:
                    setattr(self, name, sub)

    def __repr__(self) -> str:
        parts = []
        for _, (name, _, repeated) in sorted(self.FIELDS.items()):
            v = getattr(self, name)
            if v is None or (repeated and not v):
                continue
            parts.append(f"{name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


# -- ONNX message schemas (field numbers match official onnx.proto) -----------

class OperatorSetIdProto(Message):
    FIELDS = {
        1: ("domain", "string", False),
        2: ("version", "int64", False),
    }


class TensorProto(Message):
    FIELDS = {
        1: ("dims", "int64", True),
        2: ("data_type", "int64", False),
        4: ("float_data", "float", True),
        5: ("int32_data", "int64", True),
        6: ("string_data", "bytes", True),
        7: ("int64_data", "int64", True),
        8: ("name", "string", False),
        9: ("raw_data", "bytes", False),
        10: ("double_data", "double", True),
        11: ("uint64_data", "int64", True),
        12: ("doc_string", "string", False),
    }

    # onnx.TensorProto.DataType values
    FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64, STRING, BOOL = \
        1, 2, 3, 4, 5, 6, 7, 8, 9
    FLOAT16, DOUBLE, UINT32, UINT64 = 10, 11, 12, 13
    BFLOAT16 = 16


class TensorShapeDim(Message):
    FIELDS = {
        1: ("dim_value", "int64", False),
        2: ("dim_param", "string", False),
    }


class TensorShapeProto(Message):
    FIELDS = {1: ("dim", "TensorShapeDim", True)}


class TensorTypeProto(Message):
    FIELDS = {
        1: ("elem_type", "int64", False),
        2: ("shape", "TensorShapeProto", False),
    }


class TypeProto(Message):
    FIELDS = {1: ("tensor_type", "TensorTypeProto", False)}


class ValueInfoProto(Message):
    FIELDS = {
        1: ("name", "string", False),
        2: ("type", "TypeProto", False),
        3: ("doc_string", "string", False),
    }


class AttributeProto(Message):
    FIELDS = {
        1: ("name", "string", False),
        2: ("f", "float", False),
        3: ("i", "int64", False),
        4: ("s", "bytes", False),
        5: ("t", "TensorProto", False),
        6: ("g", "GraphProto", False),
        7: ("floats", "float", True),
        8: ("ints", "int64", True),
        9: ("strings", "bytes", True),
        10: ("tensors", "TensorProto", True),
        11: ("graphs", "GraphProto", True),
        13: ("doc_string", "string", False),
        20: ("type", "int64", False),
    }

    # AttributeProto.AttributeType values
    FLOAT, INT, STRING, TENSOR, GRAPH = 1, 2, 3, 4, 5
    FLOATS, INTS, STRINGS, TENSORS, GRAPHS = 6, 7, 8, 9, 10


class NodeProto(Message):
    FIELDS = {
        1: ("input", "string", True),
        2: ("output", "string", True),
        3: ("name", "string", False),
        4: ("op_type", "string", False),
        5: ("attribute", "AttributeProto", True),
        6: ("doc_string", "string", False),
        7: ("domain", "string", False),
    }


class GraphProto(Message):
    FIELDS = {
        1: ("node", "NodeProto", True),
        2: ("name", "string", False),
        5: ("initializer", "TensorProto", True),
        10: ("doc_string", "string", False),
        11: ("input", "ValueInfoProto", True),
        12: ("output", "ValueInfoProto", True),
        13: ("value_info", "ValueInfoProto", True),
    }


class StringStringEntryProto(Message):
    FIELDS = {
        1: ("key", "string", False),
        2: ("value", "string", False),
    }


class ModelProto(Message):
    FIELDS = {
        1: ("ir_version", "int64", False),
        2: ("producer_name", "string", False),
        3: ("producer_version", "string", False),
        4: ("domain", "string", False),
        5: ("model_version", "int64", False),
        6: ("doc_string", "string", False),
        7: ("graph", "GraphProto", False),
        8: ("opset_import", "OperatorSetIdProto", True),
        14: ("metadata_props", "StringStringEntryProto", True),
    }


_MESSAGE_TYPES: Dict[str, type] = {
    cls.__name__: cls for cls in (
        OperatorSetIdProto, TensorProto, TensorShapeDim, TensorShapeProto,
        TensorTypeProto, TypeProto, ValueInfoProto, AttributeProto,
        NodeProto, GraphProto, StringStringEntryProto, ModelProto)
}


# -- numpy <-> TensorProto ----------------------------------------------------

_DTYPE_TO_ONNX = {
    np.dtype(np.float32): TensorProto.FLOAT,
    np.dtype(np.float64): TensorProto.DOUBLE,
    np.dtype(np.float16): TensorProto.FLOAT16,
    np.dtype(np.int32): TensorProto.INT32,
    np.dtype(np.int64): TensorProto.INT64,
    np.dtype(np.int16): TensorProto.INT16,
    np.dtype(np.int8): TensorProto.INT8,
    np.dtype(np.uint8): TensorProto.UINT8,
    np.dtype(np.uint16): TensorProto.UINT16,
    np.dtype(np.uint32): TensorProto.UINT32,
    np.dtype(np.uint64): TensorProto.UINT64,
    np.dtype(np.bool_): TensorProto.BOOL,
}

_ONNX_TO_DTYPE = {v: k for k, v in _DTYPE_TO_ONNX.items()}


def numpy_to_tensor(arr: np.ndarray, name: str = "") -> TensorProto:
    arr = np.asarray(arr)
    if arr.dtype not in _DTYPE_TO_ONNX:
        raise TypeError(f"unsupported dtype {arr.dtype}")
    t = TensorProto()
    t.name = name or None
    t.dims = list(arr.shape)
    t.data_type = _DTYPE_TO_ONNX[arr.dtype]
    t.raw_data = np.ascontiguousarray(arr).tobytes()
    return t


def tensor_to_numpy(t: TensorProto) -> np.ndarray:
    dt = t.data_type
    shape = tuple(t.dims)
    if dt == 16:  # BFLOAT16 — stored as uint16 raw; upcast via ml_dtypes
        import ml_dtypes
        if t.raw_data:
            arr = np.frombuffer(bytes(t.raw_data), dtype=ml_dtypes.bfloat16)
        else:
            arr = np.array(
                [v for v in t.int32_data], dtype=np.uint16
            ).view(ml_dtypes.bfloat16)
        return arr.reshape(shape).astype(np.float32)
    if dt not in _ONNX_TO_DTYPE:
        raise TypeError(f"unsupported ONNX data_type {dt}")
    np_dtype = _ONNX_TO_DTYPE[dt]
    if t.raw_data:
        return np.frombuffer(bytes(t.raw_data),
                             dtype=np_dtype).reshape(shape).copy()
    if dt == TensorProto.FLOAT16:
        # non-raw fp16: int32_data holds the uint16 bit patterns
        return np.array(list(t.int32_data),
                        np.uint16).view(np.float16).reshape(shape)
    if dt == TensorProto.FLOAT:
        return np.array(list(t.float_data), np.float32).reshape(shape)
    if dt == TensorProto.DOUBLE:
        return np.array(list(t.double_data), np.float64).reshape(shape)
    if dt == TensorProto.INT64:
        return np.array(list(t.int64_data), np.int64).reshape(shape)
    if dt in (TensorProto.INT32, TensorProto.INT16, TensorProto.INT8,
              TensorProto.UINT8, TensorProto.UINT16, TensorProto.BOOL):
        return np.array(list(t.int32_data)).astype(np_dtype).reshape(shape)
    if dt in (TensorProto.UINT32, TensorProto.UINT64):
        return np.array(list(t.uint64_data)).astype(np_dtype).reshape(shape)
    raise TypeError(f"no data found in TensorProto {t.name!r}")


def load_model(path_or_bytes) -> ModelProto:
    """Parse a serialized ONNX ModelProto from path / bytes."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    model = ModelProto()
    model.ParseFromString(data)
    if model.graph is None:
        raise ValueError("not an ONNX ModelProto (no graph)")
    return model


def save_model(model: ModelProto, path: str) -> None:
    with open(path, "wb") as f:
        f.write(model.SerializeToString())
