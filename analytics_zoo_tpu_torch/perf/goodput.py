"""Live goodput / MFU ledger for the training loop (port of
``analytics_zoo_tpu/perf/goodput.py``).

Every Estimator step feeds a :class:`GoodputLedger`, which keeps

- ``zoo_tpu_mfu``: the step's product FLOPs (counted once, inside the
  first step of a run, by :mod:`analytics_zoo_tpu_torch.perf.flops`)
  over the step's wall time over the card's peak from
  :data:`PEAK_FLOPS_BY_DEVICE_KIND` (``ZOO_TPU_PEAK_TFLOPS``
  overrides);
- ``zoo_tpu_goodput_ratio``: the compute share of the step's wall time,
  where wall time splits into compute / data-wait / dispatch /
  checkpoint (compute is the residual, so the shares sum to 1);
- ``zoo_tpu_goodput_share{component}``: the whole split.

Per-epoch summaries (:meth:`GoodputLedger.epoch_summary`) go into the
Estimator's history under ``goodput`` and a process-wide ring
(:func:`recent_summaries`). ``ZOO_TPU_GOODPUT=0`` turns the ledger off;
``ZOO_TPU_GOODPUT_FLOPS=0`` skips the FLOP count (MFU then reads 0).

On the card, "dispatch" is the host time the step's Python took to
queue its kernels and "compute" the rest of the wall: with no sync per
step the host runs ahead until the allocator or a fetch makes it wait
for the card, so the split is the host's view, as the reference's is.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Dict, Optional

from analytics_zoo_tpu_torch.common import observability as obs

__all__ = [
    "GoodputLedger",
    "PEAK_FLOPS_BY_DEVICE_KIND",
    "COMPONENTS",
    "resolve_peak_flops",
    "ledger_for_backend",
    "recent_summaries",
    "reset_goodput",
    "enabled",
    "flops_enabled",
]

# Per-device dense peak FLOP/s at the dtype the train step runs: the
# H100's bf16 tensor cores, the reference's TPU rows, and a single-core
# CPU figure. Matched by lowercase substring against the device's name
# (``torch.cuda.get_device_name``); first hit wins, most specific
# first.
PEAK_FLOPS_BY_DEVICE_KIND = (
    ("h100", 989e12),
    ("v5p", 459e12),
    ("v5e", 197e12),
    ("v5 lite", 197e12),
    ("v6e", 918e12),
    ("v6 lite", 918e12),
    ("v4", 275e12),
    ("v3", 123e12),
    ("v2", 45e12),
    ("cpu", 1e11),
)

# Wall-time decomposition components; "compute" is the residual so
# the shares always sum to 1.0.
COMPONENTS = ("compute", "data_wait", "dispatch", "checkpoint")

_DEFAULT_PEAK = 197e12  # an unrecognized accelerator, as the reference


def enabled() -> bool:
    return os.environ.get("ZOO_TPU_GOODPUT", "1") != "0"


def flops_enabled() -> bool:
    """Gate for the FLOP count inside a run's first step."""
    return os.environ.get("ZOO_TPU_GOODPUT_FLOPS", "1") != "0"


def resolve_peak_flops(device_kind: str,
                       platform: str = "") -> float:
    """Peak FLOP/s for a device-kind string.
    ``ZOO_TPU_PEAK_TFLOPS`` overrides the table."""
    raw = os.environ.get("ZOO_TPU_PEAK_TFLOPS")
    if raw:
        try:
            return float(raw) * 1e12
        except ValueError:
            pass
    kind = (device_kind or "").lower()
    for sub, peak in PEAK_FLOPS_BY_DEVICE_KIND:
        if sub in kind:
            return peak
    if (platform or "").lower() == "cpu":
        return dict(PEAK_FLOPS_BY_DEVICE_KIND)["cpu"]
    return _DEFAULT_PEAK


class GoodputLedger:
    """Accumulates per-step wall-time decomposition + FLOPs into live
    gauges and per-epoch summaries. Thread-safe (the train loop owns
    it, but `/debug` surfaces may read concurrently)."""

    def __init__(self, peak_flops: Optional[float] = None,
                 device_kind: str = "", platform: str = "",
                 n_devices: int = 1,
                 registry: "Optional[obs.MetricsRegistry]" = None):
        if peak_flops is None:
            peak_flops = resolve_peak_flops(device_kind, platform)
        self.peak_flops = float(peak_flops) * max(1, int(n_devices))
        self.device_kind = device_kind
        self.flops_per_step: Optional[float] = None
        self._lock = threading.Lock()
        self._registry = registry or obs.get_registry()
        self._reset_epoch_locked()

    def _reset_epoch_locked(self):
        self._steps = 0
        self._wall_s = 0.0
        self._parts = {c: 0.0 for c in COMPONENTS}

    def set_flops_per_step(self, flops: Optional[float]):
        with self._lock:
            self.flops_per_step = (
                float(flops) if flops else None)

    def note_step(self, wall_s: float, data_wait_s: float = 0.0,
                  dispatch_s: float = 0.0,
                  checkpoint_s: float = 0.0) -> dict:
        """Feed one step's wall time and its measured non-compute
        components (each clamped into the wall); compute is the
        residual. Updates the live gauges and returns this step's
        decomposition."""
        wall_s = max(float(wall_s), 1e-9)
        parts = {"data_wait": max(float(data_wait_s), 0.0),
                 "dispatch": max(float(dispatch_s), 0.0),
                 "checkpoint": max(float(checkpoint_s), 0.0)}
        overhead = sum(parts.values())
        if overhead > wall_s:  # measurement skew: scale into the wall
            scale = wall_s / overhead
            parts = {k: v * scale for k, v in parts.items()}
            overhead = wall_s
        parts["compute"] = wall_s - overhead
        with self._lock:
            self._steps += 1
            self._wall_s += wall_s
            for k, v in parts.items():
                self._parts[k] += v
            flops = self.flops_per_step
        goodput = parts["compute"] / wall_s
        mfu = ((flops / wall_s) / self.peak_flops
               if flops and self.peak_flops > 0 else 0.0)
        reg = self._registry
        reg.gauge("zoo_tpu_mfu",
                  help="model FLOPs utilization of the last train "
                       "step (executed FLOPs / wall / peak)"
                  ).set(mfu)
        reg.gauge("zoo_tpu_goodput_ratio",
                  help="compute share of the last train step's wall "
                       "time").set(goodput)
        for comp in COMPONENTS:
            reg.gauge("zoo_tpu_goodput_share",
                      help="train-step wall-time decomposition "
                           "(shares sum to 1)",
                      labels={"component": comp}
                      ).set(parts[comp] / wall_s)
        return {k: parts[k] / wall_s for k in COMPONENTS}

    def epoch_summary(self, epoch: Optional[int] = None,
                      reset: bool = True) -> Optional[dict]:
        """Aggregate decomposition for the epoch so far (None when no
        steps landed): per-component seconds + shares (summing to
        ~1.0), mean MFU, and goodput ratio. Emitted as a
        ``perf/goodput_epoch`` event, appended to the module summary
        ring, and (by default) the
        epoch accumulators reset."""
        with self._lock:
            if self._steps == 0:
                return None
            steps, wall = self._steps, self._wall_s
            parts = dict(self._parts)
            flops = self.flops_per_step
            if reset:
                self._reset_epoch_locked()
        shares = {k: v / wall for k, v in parts.items()}
        mfu = ((flops * steps / wall) / self.peak_flops
               if flops and self.peak_flops > 0 and wall > 0
               else 0.0)
        summary: "Dict[str, Any]" = {
            "epoch": epoch,
            "steps": steps,
            "wall_s": round(wall, 6),
            "seconds": {k: round(v, 6) for k, v in parts.items()},
            "shares": {k: round(v, 6) for k, v in shares.items()},
            "goodput_ratio": round(shares["compute"], 6),
            # significant figures, not decimal places: a toy CPU fit
            # has an MFU of ~1e-9 and must not summarize as 0.0
            "mfu": float(f"{mfu:.6g}"),
            "flops_per_step": flops,
            "peak_flops": self.peak_flops,
            "device_kind": self.device_kind,
        }
        obs.event("perf/goodput_epoch", **summary)
        with _summaries_lock:
            _summaries.append(summary)
        return summary


# Recent epoch summaries, process-wide.
_summaries_lock = threading.Lock()
_summaries: "deque" = deque(maxlen=32)


def recent_summaries() -> "list[dict]":
    with _summaries_lock:
        return list(_summaries)


def reset_goodput():
    """Clear the process-global summary ring (test isolation)."""
    with _summaries_lock:
        _summaries.clear()


def ledger_for_backend(
        registry: "Optional[obs.MetricsRegistry]" = None,
        device=None) -> Optional[GoodputLedger]:
    """A ledger sized for ``device`` (the model's; default the
    context's): the card's name and peak, or the CPU row on the CPU.
    None when ``ZOO_TPU_GOODPUT=0``."""
    if not enabled():
        return None
    import torch
    if device is None:
        from analytics_zoo_tpu_torch.common.nncontext import get_nncontext
        device = get_nncontext().device
    device = torch.device(device)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
    else:
        kind = device.type
    return GoodputLedger(device_kind=kind, platform=device.type,
                         n_devices=1, registry=registry)
