"""Serving of the port: predict, int8, generation, compiled serving
artifacts, the HTTP front ends (stdlib and native C++),
the replicated fleet with its registry and canary rollout, and
disaggregated prefill/decode."""

from analytics_zoo_tpu_torch.pipeline.inference.batching import (
    ContinuousBatcher, DeadlineExpiredError, DynamicBatcher,
    QueueFullError)
from analytics_zoo_tpu_torch.pipeline.inference.fleet import (
    DisaggReplica, DisaggRouter, FleetRouter, FleetSaturatedError,
    HttpDisaggReplica, HttpReplica, Replica, ReplicaContext, ReplicaPool,
    ReplicaUnavailableError, make_fleet_server)
from analytics_zoo_tpu_torch.pipeline.inference.generation import (
    GenerationEngine, resolve_kv_dtype)
from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
    InferenceModel
from analytics_zoo_tpu_torch.pipeline.inference.quantize import \
    QuantizedModel
from analytics_zoo_tpu_torch.pipeline.inference.registry import (
    ModelRegistry, ModelVersion, RolloutController)
from analytics_zoo_tpu_torch.pipeline.inference.serving import (
    InferenceServer, NativeInferenceServer, make_inference_server)

__all__ = ["ContinuousBatcher", "DeadlineExpiredError", "DisaggReplica",
           "DisaggRouter", "DynamicBatcher", "FleetRouter",
           "FleetSaturatedError", "GenerationEngine", "HttpDisaggReplica",
           "HttpReplica", "InferenceModel", "InferenceServer",
           "ModelRegistry", "ModelVersion", "NativeInferenceServer",
           "QuantizedModel",
           "QueueFullError", "Replica", "ReplicaContext", "ReplicaPool",
           "ReplicaUnavailableError", "RolloutController",
           "make_fleet_server", "make_inference_server",
           "resolve_kv_dtype"]
