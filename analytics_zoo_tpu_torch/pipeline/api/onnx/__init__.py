"""ONNX import (port of ``analytics_zoo_tpu/pipeline/api/onnx/``): the
self-contained protobuf codec and the graph interpreter in torch; no
``onnx`` package needed."""

from analytics_zoo_tpu_torch.pipeline.api.onnx import onnx_pb  # noqa: F401
from analytics_zoo_tpu_torch.pipeline.api.onnx.onnx_pb import (  # noqa: F401
    ModelProto,
    TensorProto,
    load_model,
    save_model,
)

__all__ = ["onnx_pb", "ModelProto", "TensorProto", "load_model",
           "save_model", "OnnxLoader", "helper"]


def __getattr__(name):
    # lazy, so proto-only use does not import the interpreter
    import importlib
    if name == "OnnxLoader":
        mod = importlib.import_module(
            "analytics_zoo_tpu_torch.pipeline.api.onnx.onnx_loader")
        return mod.OnnxLoader
    if name == "helper":
        return importlib.import_module(
            "analytics_zoo_tpu_torch.pipeline.api.onnx.helper")
    raise AttributeError(name)
