"""Context, configuration and telemetry of the port."""

from analytics_zoo_tpu_torch.common.nncontext import (
    init_nncontext,
    get_nncontext,
    NNContext,
    ZooTpuConf,
)
from analytics_zoo_tpu_torch.common.config import ZooBuildInfo
from analytics_zoo_tpu_torch.common import (
    diagnostics, dictionary, observability, safe_pickle, slo,
    tracing, utils)
from analytics_zoo_tpu_torch.common.dictionary import ZooDictionary
from analytics_zoo_tpu_torch.common.observability import (
    MetricsRegistry,
    counter,
    gauge,
    histogram,
    span,
    event,
    snapshot,
    to_prometheus,
    get_registry,
    reset_metrics,
)
from analytics_zoo_tpu_torch.common.safe_pickle import checked_load

__all__ = [
    "init_nncontext",
    "get_nncontext",
    "NNContext",
    "ZooTpuConf",
    "ZooBuildInfo",
    "ZooDictionary",
    "MetricsRegistry",
    "counter",
    "gauge",
    "histogram",
    "span",
    "event",
    "snapshot",
    "to_prometheus",
    "get_registry",
    "reset_metrics",
    "checked_load",
    "diagnostics",
    "dictionary",
    "observability",
    "safe_pickle",
    "slo",
    "tracing",
    "utils",
]
