"""Anomaly detection and device diagnostics (port of
``analytics_zoo_tpu/common/diagnostics.py``).

Turns the raw telemetry of :mod:`~analytics_zoo_tpu_torch.common.
observability` into judgements: "this process is compiling in a storm",
"that step was a straggler", "device memory is near its limit". Every
detector emits one structured ``diagnostics/anomaly`` event and bumps
``zoo_tpu_anomalies_total{kind}``, the reference's names, so a scrape
reads the same.

Detectors:

- :class:`RecompileMonitor`: the port has no XLA compile, so it counts
  the port's own compiles, announced through :func:`compile_event`: a
  CUDA library built or loaded by ``ops/cuda_build.py``, and a
  ``DynamicBatcher`` bucket callable made for a new (signature,
  bucket). More than ``threshold`` of them inside a rolling
  ``window_s`` fires ``kind="recompile_storm"``. Deliberate work (the
  batcher's warm-up, ``cuda_build.build``) runs inside
  :class:`expected_compiles`: counted, never a storm.
- :class:`StepTimeWatcher`: rolling-median straggler detection,
  ``kind="step_time_regression"``.
- :class:`ReplicaSkewDetector`: one replica drifting from its
  siblings, ``kind="replica_skew"``.
- :func:`update_device_memory_gauges`: the card's allocator watermarks
  (``zoo_tpu_device_memory_bytes{device,kind}``) from
  ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``; nothing
  on the CPU.
"""

from __future__ import annotations

import hashlib
import os
import statistics
import threading
import time
from collections import deque
from typing import Optional

from analytics_zoo_tpu_torch.common import observability as obs

__all__ = [
    "anomaly",
    "add_anomaly_listener",
    "remove_anomaly_listener",
    "compile_event",
    "expected_compiles",
    "RecompileMonitor",
    "StepTimeWatcher",
    "ReplicaSkewDetector",
    "install_recompile_monitor",
    "get_recompile_monitor",
    "update_device_memory_gauges",
    "update_process_vitals",
    "build_info",
    "update_build_info",
]

_listener_lock = threading.Lock()
_listeners: list = []


def add_anomaly_listener(fn) -> None:
    """Register ``fn(kind, fields)``, called synchronously on every
    :func:`anomaly` after its counter and event are recorded. A
    listener's exception is logged and swallowed."""
    with _listener_lock:
        if fn not in _listeners:
            _listeners.append(fn)


def remove_anomaly_listener(fn) -> None:
    with _listener_lock:
        try:
            _listeners.remove(fn)
        except ValueError:
            pass


def anomaly(kind: str, **fields):
    """Record one detected anomaly: bump
    ``zoo_tpu_anomalies_total{kind}``, append a ``diagnostics/anomaly``
    event carrying ``fields``, then notify the listeners."""
    obs.counter("zoo_tpu_anomalies_total",
                help="anomalies detected, by kind",
                labels={"kind": kind}).inc()
    obs.event("diagnostics/anomaly", kind=kind, **fields)
    with _listener_lock:
        listeners = list(_listeners)
    for fn in listeners:
        try:
            fn(kind, dict(fields))
        except Exception as e:
            from analytics_zoo_tpu_torch.common.nncontext import logger
            logger.warning("anomaly listener %r failed: %s", fn, e)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


# -- compiles -----------------------------------------------------------------
# The events the port's compile sites announce (compile_event's names):
# a library built by nvcc, a library loaded into the process, a bucket
# callable made by the DynamicBatcher.
COMPILE_EVENTS = ("cuda_build/build", "cuda_build/load",
                  "serving/bucket_compile")
_compile_lock = threading.Lock()
_compile_listeners: list = []
_expected = threading.local()


class expected_compiles:
    """Marks compiles on this thread as expected: still counted in
    ``zoo_tpu_xla_compiles_total``, never part of a storm. Re-entrant;
    compiles run on the calling thread, so other threads stay
    watched."""

    def __enter__(self):
        _expected.depth = getattr(_expected, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _expected.depth -= 1
        return False


def compiles_expected() -> bool:
    return getattr(_expected, "depth", 0) > 0


def compile_event(name: str, duration: float = 0.0) -> None:
    """Announce one of the port's compiles (a name of
    :data:`COMPILE_EVENTS`) to the installed monitor."""
    with _compile_lock:
        listeners = list(_compile_listeners)
    for fn in listeners:
        fn(name, duration)


class RecompileMonitor:
    """Rolling-window compile-storm detector. :meth:`note` is the pure
    core (testable with fake clocks); :meth:`install` subscribes it to
    :func:`compile_event`. At most one anomaly fires per window."""

    def __init__(self, threshold: Optional[int] = None,
                 window_s: Optional[float] = None):
        if threshold is None:
            threshold = int(_env_float("ZOO_TPU_RECOMPILE_THRESHOLD", 5))
        if window_s is None:
            window_s = _env_float("ZOO_TPU_RECOMPILE_WINDOW_S", 60.0)
        self.threshold = max(1, threshold)
        self.window_s = window_s
        self.storms = 0
        self._times: "deque[float]" = deque()
        self._muted_until = float("-inf")
        self._lock = threading.Lock()
        self._installed = False

    @staticmethod
    def _count():
        obs.counter("zoo_tpu_xla_compiles_total",
                    help="the port's compiles observed: CUDA libraries "
                    "built or loaded, bucket callables made").inc()

    def note(self, now: Optional[float] = None) -> bool:
        """Record one compile at monotonic time ``now``; True when it
        tips the window over the threshold (and fires the anomaly).
        Expected compiles are counted and skip the window."""
        if now is None:
            now = time.monotonic()
        if compiles_expected():
            self._count()
            return False
        with self._lock:
            self._times.append(now)
            cutoff = now - self.window_s
            while self._times and self._times[0] <= cutoff:
                self._times.popleft()
            in_window = len(self._times)
            storm = (in_window > self.threshold
                     and now >= self._muted_until)
            if storm:
                self._muted_until = now + self.window_s
                self.storms += 1
        self._count()
        if storm:
            anomaly("recompile_storm", compiles=in_window,
                    window_s=self.window_s, threshold=self.threshold)
        return storm

    def _listener(self, event_name: str, duration: float = 0.0, **kw):
        if event_name in COMPILE_EVENTS:
            self.note()

    def install(self) -> "RecompileMonitor":
        """Subscribe to :func:`compile_event` (idempotent)."""
        with self._lock:
            if self._installed:
                return self
            self._installed = True
        with _compile_lock:
            _compile_listeners.append(self._listener)
        return self


_monitor_lock = threading.Lock()
_monitor: Optional[RecompileMonitor] = None


def get_recompile_monitor() -> Optional[RecompileMonitor]:
    return _monitor


def install_recompile_monitor() -> RecompileMonitor:
    """The process-wide :class:`RecompileMonitor`, installed once; the
    Estimator's train loop and the batchers call this on start."""
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            _monitor = RecompileMonitor()
    return _monitor.install()


class StepTimeWatcher:
    """Straggler detection over a rolling window of step wall times: a
    step slower than ``factor`` x the window median fires
    ``kind="step_time_regression"``, then detection mutes for
    ``cooldown`` observations."""

    def __init__(self, window: int = 64, min_samples: int = 16,
                 factor: Optional[float] = None, cooldown: int = 16):
        if factor is None:
            factor = _env_float("ZOO_TPU_STEP_ANOMALY_FACTOR", 3.0)
        self.window = max(2, window)
        self.min_samples = max(1, min_samples)
        self.factor = factor
        self.cooldown = max(0, cooldown)
        self.fired = 0
        self._buf: "deque[float]" = deque(maxlen=self.window)
        self._mute = 0
        self._lock = threading.Lock()

    def observe(self, dur_s: float, step: Optional[int] = None) -> bool:
        """Feed one step's wall time; True when it fired."""
        dur_s = float(dur_s)
        fired = False
        median = 0.0
        with self._lock:
            if self._mute > 0:
                self._mute -= 1
            elif len(self._buf) >= self.min_samples and self.factor > 0:
                median = statistics.median(self._buf)
                if median > 0 and dur_s > self.factor * median:
                    fired = True
                    self.fired += 1
                    self._mute = self.cooldown
            self._buf.append(dur_s)
        if fired:
            anomaly("step_time_regression", step=step,
                    dur_s=round(dur_s, 6), median_s=round(median, 6),
                    factor=self.factor)
        return fired


class ReplicaSkewDetector:
    """One replica drifting from its siblings: each replica's window p99
    and error ratio against the median of the *other* replicas. A p99
    above ``factor`` x that median, or an error ratio above it by
    ``error_margin``, fires ``kind="replica_skew"``; the replica then
    mutes for ``cooldown_s``."""

    def __init__(self, factor: Optional[float] = None,
                 error_margin: Optional[float] = None,
                 min_events: int = 4, cooldown_s: float = 60.0):
        if factor is None:
            factor = _env_float("ZOO_TPU_SKEW_FACTOR", 3.0)
        if error_margin is None:
            error_margin = _env_float("ZOO_TPU_SKEW_ERROR_MARGIN", 0.25)
        self.factor = float(factor)
        self.error_margin = float(error_margin)
        self.min_events = max(1, int(min_events))
        self.cooldown_s = float(cooldown_s)
        self.fired = 0
        self._muted_until: "dict" = {}
        self._lock = threading.Lock()
        self.last: "dict" = {}

    @staticmethod
    def _median_others(stats, name: str, key: str):
        vals = [s.get(key) for n, s in stats.items()
                if n != name and s.get(key) is not None]
        return statistics.median(vals) if vals else None

    def observe(self, stats: "dict", now: Optional[float] = None
                ) -> "list":
        """``stats``: replica → ``{"p99_s", "error_ratio", "events"}``
        for one window. Returns the anomalies fired."""
        if now is None:
            now = time.monotonic()
        fired = []
        verdicts = {}
        for name, s in stats.items():
            events = int(s.get("events") or 0)
            verdict = {"events": events, "skew": None}
            p99 = s.get("p99_s")
            med_p99 = self._median_others(stats, name, "p99_s")
            err = s.get("error_ratio")
            med_err = self._median_others(stats, name, "error_ratio")
            if events >= self.min_events:
                if (p99 is not None and med_p99 is not None
                        and med_p99 > 0 and self.factor > 0
                        and p99 > self.factor * med_p99):
                    verdict["skew"] = {
                        "metric": "latency_p99",
                        "value": round(float(p99), 6),
                        "fleet_median": round(float(med_p99), 6)}
                elif (err is not None and med_err is not None
                        and err - med_err > self.error_margin):
                    verdict["skew"] = {
                        "metric": "error_ratio",
                        "value": round(float(err), 6),
                        "fleet_median": round(float(med_err), 6)}
            verdicts[name] = verdict
            if verdict["skew"] is None:
                with self._lock:
                    self._muted_until.pop(name, None)
                continue
            with self._lock:
                muted = now < self._muted_until.get(name, float("-inf"))
                if not muted:
                    self._muted_until[name] = now + self.cooldown_s
                    self.fired += 1
            if muted:
                continue
            fields = dict(verdict["skew"], replica=name,
                          factor=self.factor, events=events)
            anomaly("replica_skew", **fields)
            fired.append(fields)
        self.last = verdicts
        return fired


def _read_rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm", "r", encoding="ascii") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError, AttributeError):
        return None


_PROC_T0 = time.monotonic()


def _uptime_s() -> float:
    try:
        with open("/proc/self/stat", "rb") as fh:
            start_ticks = float(fh.read().rsplit(b")", 1)[-1].split()[19])
        with open("/proc/uptime", "r", encoding="ascii") as fh:
            host_up = float(fh.read().split()[0])
        return max(0.0, host_up - start_ticks /
                   float(os.sysconf("SC_CLK_TCK")))
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic() - _PROC_T0


def update_process_vitals() -> dict:
    """Refresh ``zoo_tpu_process_rss_bytes``, ``zoo_tpu_process_uptime_s``
    and (where ``/proc`` exists) ``zoo_tpu_process_open_fds``; returns
    the values set. The server calls it on every ``/metrics``."""
    out: "dict" = {}
    rss = _read_rss_bytes()
    if rss is not None:
        obs.gauge("zoo_tpu_process_rss_bytes",
                  help="resident set size of this process").set(rss)
        out["rss_bytes"] = rss
    up = _uptime_s()
    obs.gauge("zoo_tpu_process_uptime_s",
              help="seconds since this process started").set(up)
    out["uptime_s"] = up
    try:
        n_fds = len(os.listdir("/proc/self/fd"))
    except OSError:
        n_fds = None
    if n_fds is not None:
        obs.gauge("zoo_tpu_process_open_fds",
                  help="open file descriptors in this process").set(n_fds)
        out["open_fds"] = n_fds
    return out


_build_info_lock = threading.Lock()
_build_info: "Optional[dict]" = None


def build_info() -> dict:
    """This process's provenance: the package, torch and CUDA versions,
    the card's name (``torch.cuda.get_device_name``; ``"cpu"`` without
    one) and a fingerprint (12 hex digits of sha256) of every
    ``ZOO_TPU_*`` setting. Computed once."""
    global _build_info
    with _build_info_lock:
        if _build_info is not None:
            return dict(_build_info)
        import torch

        from analytics_zoo_tpu_torch import __version__
        device = "cpu"
        try:
            if torch.cuda.is_available():
                device = torch.cuda.get_device_name(0)
        except Exception:
            device = "unknown"
        flags = sorted(f"{k}={v}" for k, v in os.environ.items()
                       if k.startswith("ZOO_TPU_"))
        _build_info = {
            "version": __version__,
            "torch": torch.__version__,
            "cuda": str(torch.version.cuda or "none"),
            "device": str(device),
            "flags_fingerprint": hashlib.sha256(
                "\n".join(flags).encode()).hexdigest()[:12],
            "flags": flags,
        }
        return dict(_build_info)


def update_build_info() -> dict:
    """Publish :func:`build_info` as the gauge
    ``zoo_tpu_build_info{version,torch,cuda,device,flags}`` (value 1:
    the labels are the payload)."""
    info = build_info()
    obs.gauge("zoo_tpu_build_info",
              help="build/runtime provenance as labels (value is always 1)",
              labels={"version": info["version"], "torch": info["torch"],
                      "cuda": info["cuda"], "device": info["device"],
                      "flags": info["flags_fingerprint"]}).set(1)
    return info


def update_device_memory_gauges() -> int:
    """Refresh ``zoo_tpu_device_memory_bytes{device,kind}`` for each
    visible card: ``in_use`` and ``peak`` from the caching allocator's
    ``allocated_bytes.all.current`` and ``.peak``, ``limit`` the card's
    total memory (``torch.cuda.mem_get_info``). Returns the number of
    samples set: 0 on the CPU or before the allocator holds anything."""
    import torch
    if not torch.cuda.is_available():
        return 0
    n = 0
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats:
            continue
        values = {"in_use": stats.get("allocated_bytes.all.current"),
                  "peak": stats.get("allocated_bytes.all.peak"),
                  "limit": torch.cuda.mem_get_info(i)[1]}
        for kind, v in values.items():
            if v is None:
                continue
            obs.gauge("zoo_tpu_device_memory_bytes",
                      help="device memory watermarks by kind",
                      labels={"device": str(i), "kind": kind}).set(v)
            n += 1
    return n
