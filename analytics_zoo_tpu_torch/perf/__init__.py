"""Performance accounting (port of ``analytics_zoo_tpu/perf``): the
train step's product FLOPs (:mod:`.flops`) and the live goodput/MFU
ledger the Estimator feeds (:mod:`.goodput`)."""

from analytics_zoo_tpu_torch.perf import flops, goodput

__all__ = ["flops", "goodput"]
