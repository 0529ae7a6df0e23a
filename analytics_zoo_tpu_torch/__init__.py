"""PyTorch/CUDA port of analytics_zoo_tpu.

The package mirrors the JAX package's structure and names, imports
``torch``, numpy and the standard library only, and runs on the CUDA
card unless a caller asks for the CPU (``init_nncontext(device="cpu")``,
where every kernel wrapper runs its plain PyTorch version).
"""

from analytics_zoo_tpu_torch.common.nncontext import (
    get_nncontext, init_nncontext, reset_nncontext)
from analytics_zoo_tpu_torch.version import __version__

__all__ = ["get_nncontext", "init_nncontext", "reset_nncontext",
           "__version__", "Net"]


def __getattr__(name):
    if name == "Net":  # lazy: pulls in the layer machinery
        from analytics_zoo_tpu_torch.pipeline.api.net_load import Net
        return Net
    raise AttributeError(name)
