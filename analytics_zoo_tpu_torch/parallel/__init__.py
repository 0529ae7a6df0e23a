"""Device placement of the port (port of ``analytics_zoo_tpu/parallel``):
so far the serving fleet's replica slices (``mesh.py``)."""

from analytics_zoo_tpu_torch.parallel.mesh import (
    place_inference_params, replica_device_slices)

__all__ = ["place_inference_params", "replica_device_slices"]
