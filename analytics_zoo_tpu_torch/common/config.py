"""Typed configuration for :func:`~analytics_zoo_tpu_torch.common.
nncontext.init_nncontext` (port of ``analytics_zoo_tpu/common/config.py``:
the config dataclass with its ``ZOO_TPU_*`` environment overlay and the
build report; the device mesh waits for the multi-card slice).
"""

from __future__ import annotations

import dataclasses
import platform
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Optional

_ENV_PREFIX = "ZOO_TPU_"


def _torch_versions() -> "tuple[str, str]":
    import torch
    return torch.__version__, str(torch.version.cuda or "none")


@dataclass(frozen=True)
class ZooBuildInfo:
    """Build and version info (the reference's ``ZooBuildInfo``), with
    the torch and CUDA versions where the reference reports jax's."""

    version: str
    python_version: str = field(
        default_factory=lambda: sys.version.split()[0])
    platform: str = field(default_factory=platform.platform)
    torch_version: str = field(
        default_factory=lambda: _torch_versions()[0])
    cuda_version: str = field(
        default_factory=lambda: _torch_versions()[1])

    def report(self) -> str:
        return "\n".join([
            f"analytics_zoo_tpu_torch version: {self.version}",
            f"python: {self.python_version}",
            f"torch: {self.torch_version}",
            f"cuda: {self.cuda_version}",
            f"platform: {self.platform}"])


@dataclass
class ZooTpuConf:
    """``seed`` roots every generator the context hands out; ``device``
    is where models and inputs live (``None``: the first CUDA card);
    ``log_level`` sets the package logger's level. ``app_name``,
    ``checkpoint_dir`` and ``extra`` (free-form settings) are carried
    for the reference's config format and its ``ZOO_TPU_<FIELD>``
    overlay; nothing in the port reads them (the Estimator's checkpoint
    calls take their path explicitly).
    """

    app_name: str = "analytics-zoo-tpu"
    seed: int = 0
    device: Optional[str] = None
    log_level: str = "INFO"
    checkpoint_dir: str = ""
    extra: "dict[str, Any]" = field(default_factory=dict)

    @staticmethod
    def from_env(base: "ZooTpuConf | None" = None) -> "ZooTpuConf":
        """Overlay ``ZOO_TPU_<FIELD>`` environment variables onto
        ``base`` (the environment wins), e.g. ``ZOO_TPU_SEED=7``.
        Mutable sub-configs are copied, so later edits never write
        through to the caller's object."""
        conf = (ZooTpuConf() if base is None else
                dataclasses.replace(base, extra=dict(base.extra)))
        for f in dataclasses.fields(conf):
            key = _ENV_PREFIX + f.name.upper()
            if key not in os.environ:
                continue
            raw = os.environ[key]
            if f.type in ("int", int):
                setattr(conf, f.name, int(raw))
            elif f.type in ("bool", bool):
                setattr(conf, f.name, raw.lower() in ("1", "true", "yes"))
            elif f.type in ("str", str, "Optional[str]"):
                setattr(conf, f.name, raw)
        return conf
