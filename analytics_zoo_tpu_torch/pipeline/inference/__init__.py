"""Serving of the port: predict and generation."""

from analytics_zoo_tpu_torch.pipeline.inference.batching import (
    ContinuousBatcher, DeadlineExpiredError, QueueFullError)
from analytics_zoo_tpu_torch.pipeline.inference.generation import (
    GenerationEngine, resolve_kv_dtype)
from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
    InferenceModel

__all__ = ["ContinuousBatcher", "DeadlineExpiredError", "GenerationEngine",
           "InferenceModel", "QueueFullError", "resolve_kv_dtype"]
