"""Keras-style API of the port: engine, containers and layers."""

from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    Input, KerasLayer, Variable)
from analytics_zoo_tpu_torch.pipeline.api.keras.models import (
    Model, Sequential)

__all__ = ["Input", "KerasLayer", "Model", "Sequential", "Variable"]
