"""Minimal pure-Python BigDL model protobuf codec (reader + writer).

BigDL 0.x serializes modules as a ``BigDLModule`` proto tree
(`bigdl.proto` in the BigDL distribution — an external maven dep of the
reference, not vendored there). The reference loads these via
`Net.loadBigDL` / `Net.load` (`Z/pipeline/api/Net.scala:91-118`); this
codec lets the TPU framework read the same files — including the
reference's own test fixtures
(`zoo/src/test/resources/models/{bigdl,zoo_keras}`) — without Spark,
BigDL, or protobuf installed.

Field numbers match bigdl.proto, so real ``.model`` files parse. Only
the subset the importer needs is described; unknown fields are skipped
by the base codec.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from analytics_zoo_tpu_torch.pipeline.api.onnx.onnx_pb import (
    Message, _MESSAGE_TYPES)


class BShape(Message):
    # message Shape {ShapeType shapeType=1; int32 ssize=2;
    #                repeated int32 shapeValue=3; repeated Shape shape=4}
    FIELDS = {
        1: ("shapeType", "int64", False),
        2: ("ssize", "int64", False),
        3: ("shapeValue", "int64", True),
        4: ("shape", "BShape", True),
    }


class TensorStorage(Message):
    FIELDS = {
        1: ("datatype", "int64", False),
        2: ("float_data", "float", True),
        3: ("double_data", "double", True),
        4: ("int32_data", "int64", True),
        5: ("int64_data", "int64", True),
        6: ("bool_data", "int64", True),
        7: ("string_data", "string", True),
        8: ("bytes_data", "bytes", True),
        9: ("id", "int64", False),
    }


class BigDLTensor(Message):
    FIELDS = {
        1: ("datatype", "int64", False),
        2: ("size", "int64", True),
        3: ("stride", "int64", True),
        4: ("offset", "int64", False),
        5: ("dimension", "int64", False),
        6: ("nElements", "int64", False),
        7: ("isScalar", "int64", False),
        8: ("storage", "TensorStorage", False),
        9: ("id", "int64", False),
        10: ("tensorType", "int64", False),
    }


class ArrayValue(Message):
    FIELDS = {
        1: ("size", "int64", False),
        2: ("datatype", "int64", False),
        3: ("i32", "int64", True),
        4: ("i64", "int64", True),
        5: ("flt", "float", True),
        6: ("dbl", "double", True),
        7: ("str", "string", True),
        8: ("boolean", "int64", True),
        10: ("tensor", "BigDLTensor", True),
        13: ("bigDLModule", "BigDLModule", True),
        17: ("shape", "BShape", True),
    }


class AttrValue(Message):
    FIELDS = {
        1: ("dataType", "int64", False),
        2: ("subType", "string", False),
        3: ("int32Value", "int64", False),
        4: ("int64Value", "int64", False),
        5: ("floatValue", "float", False),
        6: ("doubleValue", "double", False),
        7: ("stringValue", "string", False),
        8: ("boolValue", "int64", False),
        10: ("tensorValue", "BigDLTensor", False),
        13: ("bigDLModuleValue", "BigDLModule", False),
        14: ("nameAttrListValue", "NameAttrList", False),
        15: ("arrayValue", "ArrayValue", False),
        16: ("dataFormatValue", "int64", False),
        18: ("shape", "BShape", False),
    }


class NameAttrList(Message):
    FIELDS = {
        1: ("name", "string", False),
        2: ("attr", "AttrEntry", True),
    }

    def attr_map(self) -> "Dict[str, AttrValue]":
        return {e.key: e.value for e in self.attr}


class AttrEntry(Message):
    # map<string, AttrValue> entry
    FIELDS = {
        1: ("key", "string", False),
        2: ("value", "AttrValue", False),
    }


class BigDLModule(Message):
    FIELDS = {
        1: ("name", "string", False),
        2: ("subModules", "BigDLModule", True),
        3: ("weight", "BigDLTensor", False),
        4: ("bias", "BigDLTensor", False),
        5: ("preModules", "string", True),
        6: ("nextModules", "string", True),
        7: ("moduleType", "string", False),
        8: ("attr", "AttrEntry", True),
        9: ("version", "string", False),
        10: ("train", "int64", False),
        11: ("namePostfix", "string", False),
        12: ("id", "int64", False),
        13: ("inputShape", "BShape", True),
        14: ("outputShape", "BShape", True),
        15: ("hasParameters", "int64", False),
        16: ("parameters", "BigDLTensor", True),
    }

    def attr_map(self) -> "Dict[str, AttrValue]":
        return {e.key: e.value for e in self.attr}


_MESSAGE_TYPES.update({
    "BShape": BShape,
    "TensorStorage": TensorStorage,
    "BigDLTensor": BigDLTensor,
    "ArrayValue": ArrayValue,
    "AttrValue": AttrValue,
    "AttrEntry": AttrEntry,
    "NameAttrList": NameAttrList,
    "BigDLModule": BigDLModule,
})

# DataType enum values (bigdl.proto)
DT_INT32, DT_INT64, DT_FLOAT, DT_DOUBLE = 0, 1, 2, 3


def _storage_data(storage: Optional[TensorStorage]) -> \
        Optional[np.ndarray]:
    if storage is None:
        return None
    if storage.float_data:
        return np.asarray(storage.float_data, np.float32)
    if storage.double_data:
        return np.asarray(storage.double_data, np.float64)
    if storage.int32_data:
        return np.asarray(storage.int32_data, np.int32)
    if storage.int64_data:
        return np.asarray(storage.int64_data, np.int64)
    if storage.bytes_data:
        return np.frombuffer(b"".join(storage.bytes_data), np.uint8)
    return None


class StorageTable:
    """Tensor DATA is deduplicated per saved file: the top module's
    ``global_storage`` attr is a NameAttrList mapping str(tensorId) →
    BigDLTensor carrying the actual storage; per-layer weight/bias
    tensors reference it by their ``id`` (and carry size/stride/offset
    locally)."""

    def __init__(self, root: Optional[BigDLModule] = None):
        self._by_tid: Dict[int, np.ndarray] = {}
        self._by_sid: Dict[int, np.ndarray] = {}
        if root is not None:
            gs = root.attr_map().get("global_storage")
            nal = gs.nameAttrListValue if gs is not None else None
            if nal is not None:
                for k, v in nal.attr_map().items():
                    t = v.tensorValue
                    data = _storage_data(t.storage) if t else None
                    if data is None:
                        continue
                    try:
                        self._by_tid[int(k)] = data
                    except ValueError:
                        pass
                    if t.storage.id is not None:
                        self._by_sid[int(t.storage.id)] = data

    def tensor_to_numpy(self, t: Optional[BigDLTensor]) -> \
            Optional[np.ndarray]:
        if t is None:
            return None
        data = _storage_data(t.storage)
        if data is None and t.id is not None:
            data = self._by_tid.get(int(t.id))
        if data is None and t.storage is not None and \
                t.storage.id is not None:
            data = self._by_sid.get(int(t.storage.id))
        if data is None:
            return None
        size = [int(s) for s in t.size]
        # BigDL storageOffset is 1-based (Torch heritage)
        offset = max(int(t.offset or 0) - 1, 0)
        n = int(np.prod(size)) if size else 1
        flat = data[offset:offset + n]
        return flat.reshape(size) if size else flat.reshape(())


def load_model(path_or_bytes) -> BigDLModule:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    m = BigDLModule()
    m.ParseFromString(data)
    return m
