"""Context init (port of ``analytics_zoo_tpu/common/nncontext.py``).

The JAX package's context builds a device mesh; the port runs on one
card, so the context holds the device, its data-parallel size (1) and a
seeded root from which explicit ``torch.Generator`` objects are drawn
(model init and the Estimator draw theirs from it). The entry point runs on
the card unless the caller asks for the CPU: ``device=None`` resolves
to ``cuda:0`` and raises where there is no CUDA device.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import torch

from analytics_zoo_tpu_torch.common.config import ZooTpuConf

logger = logging.getLogger("analytics_zoo_tpu_torch")

_lock = threading.RLock()
_current: "NNContext | None" = None


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda:0``, raising when CUDA is absent; anything else
    is taken as given (``"cpu"`` runs the plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda", 0)
    return torch.device(device)


class NNContext:
    """Process-wide context: config, device and the generator root."""

    def __init__(self, conf: ZooTpuConf, device: torch.device):
        self.conf = conf
        self.device = device
        self._seeds = torch.Generator().manual_seed(conf.seed)
        self._seed_lock = threading.Lock()

    @property
    def data_parallel_size(self) -> int:
        """Devices the batch splits over: one card (the mesh waits)."""
        return 1

    def check_batch_size(self, batch_size: int) -> int:
        """Enforce batch divisibility over the data-parallel size, the
        reference's ``batch_size % total_cores == 0`` rule."""
        dp = self.data_parallel_size
        if batch_size < 1 or batch_size % dp:
            raise ValueError(
                f"batch_size ({batch_size}) must be a positive multiple "
                f"of the data-parallel size ({dp})")
        return batch_size

    def next_seed(self) -> int:
        """A fresh int seed from the context's root (the counterpart of
        ``next_rng_key``; see ``ops/rng.py``)."""
        with self._seed_lock:
            return int(torch.randint(0, 2 ** 62, (1,),
                                     generator=self._seeds))

    def new_generator(self) -> torch.Generator:
        """A fresh CPU generator, seeded from the context's root: the
        same seed gives the same sequence of generators, so weights
        made from them repeat."""
        return torch.Generator().manual_seed(self.next_seed())

    def __repr__(self) -> str:
        return f"NNContext(device={self.device}, seed={self.conf.seed})"


def init_nncontext(conf: Optional[ZooTpuConf] = None, *,
                   seed: Optional[int] = None,
                   device=None) -> NNContext:
    """Create (or replace) the process-wide :class:`NNContext`.
    ``ZOO_TPU_*`` environment variables overlay ``conf``
    (:meth:`ZooTpuConf.from_env`), and the arguments overlay both.
    ``device`` overrides ``conf.device``; both ``None`` means
    ``cuda:0``, and raises without a CUDA device."""
    global _current
    conf = ZooTpuConf.from_env(conf)
    if seed is not None:
        conf.seed = int(seed)
    if device is not None:
        conf.device = str(device)
    # the package's own logger only; its records still reach the
    # root's handlers
    logger.setLevel(conf.log_level)
    ctx = NNContext(conf, resolve_device(conf.device))
    with _lock:
        _current = ctx
    logger.info("Initialized %s", ctx)
    return ctx


def get_nncontext(create_if_missing: bool = True) -> NNContext:
    """The current context, creating the default one if needed."""
    with _lock:
        if _current is not None:
            return _current
        if not create_if_missing:
            raise RuntimeError("NNContext not initialized; "
                               "call init_nncontext() first")
        return init_nncontext()


def reset_nncontext() -> None:
    global _current
    with _lock:
        _current = None
