"""Serving of the port."""

from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
    InferenceModel

__all__ = ["InferenceModel"]
