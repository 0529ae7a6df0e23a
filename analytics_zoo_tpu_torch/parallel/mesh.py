"""Device slices for the serving fleet (port of the inference path of
``analytics_zoo_tpu/parallel/mesh.py``).

A replica owns a disjoint slice of the host's devices. A one-device
slice holds its own copy of the params on that device. A slice of more
than one device would split the params over a tensor-parallel group;
that placement is not ported yet (ROADMAP A14), and it raises rather
than replicate.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

__all__ = ["replica_device_slices", "place_inference_params"]


def host_devices() -> list:
    """``cuda:0 .. cuda:n-1`` when the card is present, else the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")]


def replica_device_slices(n_replicas: int,
                          devices_per_replica: int = 1,
                          devices: Optional[Sequence] = None) -> list:
    """Partition ``devices`` (default :func:`host_devices`) into
    disjoint per-replica slices: replica i owns
    ``devices[i*k : (i+1)*k]``. Raises when the host cannot seat the
    fleet: a fleet time-slicing one card would report capacity the card
    does not have."""
    devs = list(devices) if devices is not None else host_devices()
    k = int(devices_per_replica)
    need = int(n_replicas) * k
    if k < 1 or n_replicas < 1:
        raise ValueError("n_replicas and devices_per_replica must "
                         "be >= 1")
    if need > len(devs):
        raise ValueError(
            f"fleet needs {need} devices ({n_replicas} replicas x "
            f"{k}) but the host has {len(devs)}")
    return [tuple(devs[i * k:(i + 1) * k]) for i in range(n_replicas)]


def place_inference_params(params: Any, devices: Sequence,
                           mode: str = "auto") -> Any:
    """One inference replica's params, copied onto its device slice: a
    tree of the same keys whose tensors (or host arrays) are new tensors
    on ``devices[0]``, sharing no storage with ``params``. A slice of
    more than one device raises ``NotImplementedError``
    (tensor-parallel placement, ROADMAP A14)."""
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("empty device slice")
    if mode not in ("auto", "tp", "replicate"):
        raise ValueError(f"unknown inference placement mode {mode!r} "
                         f"(auto|tp|replicate)")
    if len(devs) > 1:
        raise NotImplementedError(
            f"placing one replica's params over {len(devs)} devices "
            f"(mode {mode!r}) is tensor-parallel placement, not ported "
            f"yet (ROADMAP A14); use one device per replica")
    dev = devs[0]

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        if isinstance(x, torch.Tensor):
            return x.detach().to(dev, copy=True)
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return place(params)
