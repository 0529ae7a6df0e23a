"""Typed configuration for :func:`~analytics_zoo_tpu_torch.common.
nncontext.init_nncontext` (port of ``analytics_zoo_tpu/common/config.py``,
the seed and device fields only)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ZooTpuConf:
    """``seed`` roots every generator the context hands out; ``device``
    is where models and inputs live (``None``: the first CUDA card)."""

    seed: int = 0
    device: Optional[str] = None
