"""Capacity forecasting (port of ``analytics_zoo_tpu/common/forecast.py``).

A sample listener of the
:mod:`~analytics_zoo_tpu_torch.common.timeseries` history: after every
sample it extrapolates the recent trend of each watched resource (an
EWMA-smoothed least-squares slope over ``ZOO_TPU_FORECAST_WINDOW_S``)
to an exhaustion ETA:

- **kv_pages**: ``zoo_tpu_serving_gen_free_pages`` falling toward 0;
- **queue** / **gen_queue**: ``zoo_tpu_serving_queue_depth`` /
  ``zoo_tpu_serving_gen_queue_depth`` climbing toward their admission
  limits;
- **event_log**: ``zoo_tpu_event_log_bytes`` climbing toward the
  rotation budget (disk).

Each resource publishes ``zoo_tpu_forecast_eta_s{resource=}``; the
:data:`NO_ETA` sentinel ``1e9`` means no exhaustion in sight (never
``inf``, which the Prometheus renderer rejects). When a finite ETA
drops inside ``ZOO_TPU_FORECAST_HORIZON_S`` the forecaster fires one
``zoo_tpu_anomalies_total{kind="capacity_forecast"}`` anomaly, re-armed
when the ETA recovers; the shipped ``forecast`` objectives of
:mod:`~analytics_zoo_tpu_torch.common.slo` read both.

Standard library only; injectable clock; ``tick(now=)`` for tests.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from analytics_zoo_tpu_torch.common import diagnostics
from analytics_zoo_tpu_torch.common import observability as obs
from analytics_zoo_tpu_torch.common import timeseries

__all__ = [
    "NO_ETA",
    "DEFAULT_RESOURCES",
    "Forecaster",
    "ewma",
    "linear_slope",
    "eta_to_limit",
    "enabled",
    "get_forecaster",
    "ensure_forecaster",
    "reset_forecast",
]

# Published instead of +inf when the trend never reaches the limit:
# ~31 years, finite for the text renderer, and trivially outside any
# sane SLO threshold on zoo_tpu_forecast_eta_s.
NO_ETA = 1e9

# Watched resources (pure literal; limits may be overridden or
# supplied by env). direction "down" → exhausted when the value
# falls to `limit`; "up" → when it climbs to `limit`.
DEFAULT_RESOURCES = [
    {
        "resource": "kv_pages",
        "family": "zoo_tpu_serving_gen_free_pages",
        "direction": "down",
        "limit": 0.0,
    },
    {
        "resource": "queue",
        "family": "zoo_tpu_serving_queue_depth",
        "direction": "up",
        "limit": 256.0,
        "limit_env": "ZOO_TPU_FORECAST_QUEUE_LIMIT",
    },
    {
        "resource": "gen_queue",
        "family": "zoo_tpu_serving_gen_queue_depth",
        "direction": "up",
        "limit": 256.0,
        "limit_env": "ZOO_TPU_FORECAST_GEN_QUEUE_LIMIT",
    },
    {
        "resource": "event_log",
        "family": "zoo_tpu_event_log_bytes",
        "direction": "up",
        "limit": None,
        "limit_env": "ZOO_TPU_FORECAST_EVENT_LOG_LIMIT_MB",
        "limit_scale": 1048576.0,
    },
]


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# Trend math (pure functions — unit-tested exactly)
# ---------------------------------------------------------------------------

def ewma(values: "List[float]", alpha: float) -> "List[float]":
    """Exponentially-weighted moving average; ``alpha=1`` is the
    identity (pure linear fit on raw samples)."""
    out: "List[float]" = []
    s: Optional[float] = None
    for v in values:
        s = v if s is None else alpha * v + (1.0 - alpha) * s
        out.append(s)
    return out


def linear_slope(points: "List[tuple]") -> Optional[float]:
    """Least-squares slope of ``[(ts, value), ...]`` in units/s;
    None when fewer than 2 points or zero time spread."""
    n = len(points)
    if n < 2:
        return None
    mt = sum(p[0] for p in points) / n
    mv = sum(p[1] for p in points) / n
    den = sum((p[0] - mt) ** 2 for p in points)
    if den <= 0:
        return None
    num = sum((p[0] - mt) * (p[1] - mv) for p in points)
    return num / den


def eta_to_limit(points: "List[tuple]", limit: float,
                 direction: str,
                 alpha: float = 1.0) -> Optional[float]:
    """Seconds until the EWMA-smoothed linear trend of ``points``
    reaches ``limit`` (0.0 if already there); None when the trend
    points away from the limit or is flat/unknown."""
    if not points:
        return None
    smoothed = ewma([p[1] for p in points], alpha)
    pts = [(points[i][0], smoothed[i])
           for i in range(len(points))]
    cur = pts[-1][1]
    slope = linear_slope(pts)
    if direction == "down":
        if cur <= limit:
            return 0.0
        if slope is None or slope >= -1e-12:
            return None
        return (cur - limit) / (-slope)
    if cur >= limit:
        return 0.0
    if slope is None or slope <= 1e-12:
        return None
    return (limit - cur) / slope


# ---------------------------------------------------------------------------
# Forecaster
# ---------------------------------------------------------------------------

class Forecaster:
    """Extrapolates resource trends from a
    :class:`~analytics_zoo_tpu_torch.common.timeseries.MetricHistory`
    into exhaustion ETAs + predictive anomalies."""

    def __init__(self, history: "timeseries.MetricHistory",
                 registry: "Optional[obs.MetricsRegistry]" = None,
                 clock: "Optional[Callable[[], float]]" = None,
                 resources: "Optional[List[dict]]" = None,
                 window_s: Optional[float] = None,
                 horizon_s: Optional[float] = None,
                 min_points: Optional[int] = None,
                 min_span_s: Optional[float] = None,
                 alpha: Optional[float] = None):
        self.history = history
        self._registry = registry or obs.get_registry()
        self._clock = clock or time.monotonic
        self._resources = [dict(r) for r in
                           (resources if resources is not None
                            else DEFAULT_RESOURCES)]
        self.window_s = (window_s if window_s is not None else
                         _env_float("ZOO_TPU_FORECAST_WINDOW_S",
                                    120.0))
        self.horizon_s = (horizon_s if horizon_s is not None else
                          _env_float("ZOO_TPU_FORECAST_HORIZON_S",
                                     600.0))
        self.min_points = max(
            min_points if min_points is not None else
            _env_int("ZOO_TPU_FORECAST_MIN_POINTS", 5), 2)
        self.min_span_s = (
            min_span_s if min_span_s is not None else
            _env_float("ZOO_TPU_FORECAST_MIN_SPAN_S", 10.0))
        a = (alpha if alpha is not None else
             _env_float("ZOO_TPU_FORECAST_EWMA", 0.3))
        self.alpha = min(max(a, 0.01), 1.0)
        self._lock = threading.Lock()
        self._pending: "Dict[str, bool]" = {}
        self._status: "Dict[str, dict]" = {}
        self._ticks = 0

    def _limit(self, spec: dict) -> Optional[float]:
        env = spec.get("limit_env")
        if env and os.environ.get(env):
            try:
                return float(os.environ[env]) * float(
                    spec.get("limit_scale", 1.0))
            except ValueError:
                pass
        limit = spec.get("limit")
        if limit is not None:
            return float(limit)
        if spec["resource"] == "event_log":
            # Default disk budget: the rotation cap times the
            # number of live segments, when rotation is on.
            max_mb = _env_float("ZOO_TPU_EVENT_LOG_MAX_MB", 0.0)
            if max_mb > 0:
                keep = _env_int("ZOO_TPU_EVENT_LOG_KEEP", 3)
                return max_mb * 1048576.0 * (keep + 1)
        return None

    def _points(self, spec: dict, now: float) -> "List[tuple]":
        """Gauge samples for the resource, summed across label
        sets at each timestamp (a family like queue depth may be
        split per batcher; capacity is the sum)."""
        ser = self.history.series(spec["family"],
                                  window_s=self.window_s,
                                  now=now)
        by_ts: "Dict[float, float]" = {}
        for s in ser.get("series", ()):
            for p in s.get("points", ()):
                if "value" in p:
                    by_ts[p["ts"]] = by_ts.get(p["ts"], 0.0) \
                        + float(p["value"])
        return sorted(by_ts.items())

    def tick(self, now: Optional[float] = None) -> dict:
        """Re-forecast every resource; called from the history's
        sample listener (so it shares the sampler's ``ts``) or
        manually with an injected ``now`` in tests."""
        t = self._clock() if now is None else float(now)
        status: "Dict[str, dict]" = {}
        with self._lock:
            for spec in self._resources:
                name = spec["resource"]
                limit = self._limit(spec)
                st: "Dict[str, Any]" = {
                    "family": spec["family"],
                    "direction": spec["direction"],
                    "limit": limit,
                }
                eta: Optional[float] = None
                if limit is not None:
                    pts = self._points(spec, t)
                    st["points"] = len(pts)
                    span = (pts[-1][0] - pts[0][0]) if pts else 0.0
                    st["span_s"] = round(span, 3)
                    st["value"] = pts[-1][1] if pts else None
                    if (len(pts) >= self.min_points
                            and span >= self.min_span_s):
                        eta = eta_to_limit(pts, limit,
                                           spec["direction"],
                                           self.alpha)
                else:
                    st["skipped"] = "no limit configured"
                st["eta_s"] = (round(eta, 3) if eta is not None
                               else None)
                self._registry.gauge(
                    "zoo_tpu_forecast_eta_s",
                    help="forecast seconds until resource "
                         "exhaustion (1e9 = none in sight)",
                    labels={"resource": name},
                ).set(round(eta, 3) if eta is not None
                      else NO_ETA)
                pending = (eta is not None
                           and eta <= self.horizon_s)
                st["pending"] = pending
                if pending and not self._pending.get(name):
                    diagnostics.anomaly(
                        "capacity_forecast",
                        resource=name,
                        eta_s=round(eta, 3),
                        limit=limit,
                        value=st.get("value"),
                        window_s=self.window_s)
                self._pending[name] = pending
                status[name] = st
            self._status = status
            self._ticks += 1
        return status

    def status(self) -> dict:
        with self._lock:
            return {"ticks": self._ticks,
                    "window_s": self.window_s,
                    "horizon_s": self.horizon_s,
                    "resources": dict(self._status)}


# ---------------------------------------------------------------------------
# Process-global forecaster, riding the global history's sampler
# ---------------------------------------------------------------------------

def enabled() -> bool:
    return os.environ.get("ZOO_TPU_FORECAST", "1") != "0"


_global_lock = threading.Lock()
_forecaster: Optional[Forecaster] = None


def _on_sample(history: "timeseries.MetricHistory", ts: float):
    f = _forecaster
    if f is None:
        return
    try:
        f.tick(now=ts)
    except Exception:
        pass  # forecasting must never break the sampler


def get_forecaster() -> Forecaster:
    """The process-global forecaster over the global history;
    created on first use (does not register the listener — use
    :func:`ensure_forecaster` for that)."""
    global _forecaster
    with _global_lock:
        if _forecaster is None:
            _forecaster = Forecaster(timeseries.get_history())
        return _forecaster


def ensure_forecaster() -> Optional[Forecaster]:
    """Idempotently wire the global forecaster onto the global
    history's sample listener; no-op when ``ZOO_TPU_FORECAST=0``."""
    if not enabled():
        return None
    f = get_forecaster()
    f.history.add_listener(_on_sample)
    return f


def reset_forecast():
    """Drop the global forecaster + listener (test isolation)."""
    global _forecaster
    with _global_lock:
        if _forecaster is not None:
            try:
                _forecaster.history.remove_listener(_on_sample)
            except Exception:
                pass
        _forecaster = None
