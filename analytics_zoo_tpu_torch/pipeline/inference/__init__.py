"""Serving of the port: predict, int8, generation and the HTTP front
end."""

from analytics_zoo_tpu_torch.pipeline.inference.batching import (
    ContinuousBatcher, DeadlineExpiredError, DynamicBatcher,
    QueueFullError)
from analytics_zoo_tpu_torch.pipeline.inference.generation import (
    GenerationEngine, resolve_kv_dtype)
from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
    InferenceModel
from analytics_zoo_tpu_torch.pipeline.inference.quantize import \
    QuantizedModel
from analytics_zoo_tpu_torch.pipeline.inference.serving import (
    InferenceServer, make_inference_server)

__all__ = ["ContinuousBatcher", "DeadlineExpiredError", "DynamicBatcher",
           "GenerationEngine", "InferenceModel", "InferenceServer",
           "QuantizedModel", "QueueFullError", "make_inference_server",
           "resolve_kv_dtype"]
