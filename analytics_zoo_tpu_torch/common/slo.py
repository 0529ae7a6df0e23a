"""Declarative SLOs evaluated against the metrics registry (port of
``analytics_zoo_tpu/common/slo.py``).

- an :class:`SLO` is a rule: a metric selector (family name and a
  label subset), one or more evaluation windows, and either a plain
  threshold (``gauge``, ``rate`` and ``quantile`` signals) or an
  error-budget burn rate over a numerator/denominator pair (``ratio``
  signals). A rule with several windows breaches only when every
  window breaches: the short one detects, the long one keeps one bad
  second from paging.
- the :class:`SLOEngine` snapshots the registry on a background ticker
  (``ZOO_TPU_SLO_TICK_S``, default 5 s; ``0``: :meth:`~SLOEngine.tick`
  by hand only) and evaluates every rule against windowed deltas of
  those snapshots, so cumulative counters and histograms become
  per-window rates and quantiles. The snapshots live in the shared
  :class:`~analytics_zoo_tpu_torch.common.timeseries.MetricHistory`
  that also backs ``/debug/metrics/history`` and the capacity
  forecaster. Early in a process's life windows clip to the engine's
  uptime (the oldest snapshot stands in for one not old enough yet).
- a healthy-to-breach transition increments
  ``zoo_tpu_slo_breaches_total{slo}`` once and goes through
  :func:`diagnostics.anomaly` (``kind="slo_breach"``); recovery appends
  a ``slo/recovered`` event. ``GET /debug/slo`` serves
  :meth:`~SLOEngine.status`.

The shipped objectives (:data:`DEFAULT_SERVING_SLOS`,
:data:`DEFAULT_FLEET_SLOS`, :data:`DEFAULT_FED_SLOS`,
:data:`DEFAULT_FORECAST_SLOS`, :data:`DEFAULT_TRAINING_SLOS`) are the
reference's dict literals, unchanged. In the port
``zoo_tpu_xla_compiles_total``, which ``train_recompile_rate`` reads,
counts CUDA library builds and loads and bucket callables
(``common/diagnostics.py``). Thresholds are overridable per rule with
``ZOO_TPU_SLO_<ID>_THRESHOLD``, ``_OBJECTIVE`` and ``_BURN_RATE``;
``ZOO_TPU_SLO=0`` disables the default installation and the ticker.

Standard library only, like the rest of the telemetry layer.
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
    "SLO",
    "SLOEngine",
    "DEFAULT_SERVING_SLOS",
    "DEFAULT_FLEET_SLOS",
    "DEFAULT_FED_SLOS",
    "DEFAULT_FORECAST_SLOS",
    "DEFAULT_TRAINING_SLOS",
    "get_engine",
    "install_defaults",
    "ensure_default_slos",
    "enabled",
    "reset_slo",
]

_SIGNAL_TYPES = ("gauge", "rate", "quantile", "ratio")

_OPS: "Dict[str, Callable[[float, float], bool]]" = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}


# ---------------------------------------------------------------------------
# Shipped default objectives (the reference's dict literals; keep them
# literal)
# ---------------------------------------------------------------------------

DEFAULT_SERVING_SLOS = [
    {
        "id": "serving_latency_p99",
        "description": "p99 /predict latency stays under 250 ms",
        "signal": {"type": "quantile",
                   "metric": "zoo_tpu_serving_request_seconds",
                   "labels": {"path": "/predict"},
                   "q": 0.99},
        "threshold": 0.25,
        "op": ">",
        "windows": [60.0, 300.0],
        "min_events": 20,
    },
    {
        "id": "serving_error_rate",
        "description": "99% of HTTP requests succeed "
                       "(multi-window burn rate)",
        "signal": {"type": "ratio",
                   "numerator": {
                       "metric": "zoo_tpu_serving_errors_total"},
                   "denominator": {
                       "metric": "zoo_tpu_serving_requests_total"}},
        "objective": 0.99,
        "burn_rate": 14.0,
        "windows": [60.0, 600.0],
        "min_events": 10,
    },
    {
        "id": "serving_queue_depth",
        "description": "batcher admission queue stays below 75% "
                       "of its default 256-slot bound",
        "signal": {"type": "gauge",
                   "metric": "zoo_tpu_serving_queue_depth"},
        "threshold": 192.0,
        "op": ">",
        "windows": [60.0],
    },
]

DEFAULT_FLEET_SLOS = [
    {
        "id": "fleet_replicas_admitting",
        "description": "the serving fleet keeps at least one "
                       "replica admitting traffic",
        "signal": {"type": "gauge",
                   "metric": "zoo_tpu_fleet_replicas_admitting"},
        "threshold": 1.0,
        "op": "<",
        "windows": [60.0],
    },
    {
        "id": "fleet_error_rate",
        "description": "99% of routed requests resolve (replica "
                       "failures absorbed by sibling retries)",
        "signal": {"type": "ratio",
                   "numerator": {
                       "metric":
                           "zoo_tpu_fleet_requests_failed_total"},
                   "denominator": {
                       "metric": "zoo_tpu_fleet_requests_total"}},
        "objective": 0.99,
        "burn_rate": 14.0,
        "windows": [60.0, 600.0],
        "min_events": 10,
    },
    {
        "id": "fleet_retry_rate",
        "description": "sibling retries stay under 1/s (a dying "
                       "replica burns retry budget before ejection)",
        "signal": {"type": "rate",
                   "metric": "zoo_tpu_fleet_retries_total"},
        "threshold": 1.0,
        "op": ">",
        "windows": [120.0],
    },
]

DEFAULT_FED_SLOS = [
    {
        "id": "fed_latency_p99",
        "description": "fleet-wide federated /predict p99 stays "
                       "under 500 ms (per-source window worst case)",
        "signal": {"type": "gauge",
                   "metric": "zoo_tpu_fed_latency_p99_seconds"},
        "threshold": 0.5,
        "op": ">",
        "windows": [60.0],
    },
    {
        "id": "fed_error_ratio",
        "description": "fleet-wide federated serving error ratio "
                       "stays under 5%",
        "signal": {"type": "gauge",
                   "metric": "zoo_tpu_fed_error_ratio"},
        "threshold": 0.05,
        "op": ">",
        "windows": [60.0],
    },
]

DEFAULT_FORECAST_SLOS = [
    {
        "id": "forecast_capacity_pending",
        "description": "no capacity-exhaustion forecast is "
                       "pending (predictive anomaly rate stays 0)",
        "signal": {"type": "rate",
                   "metric": "zoo_tpu_anomalies_total",
                   "labels": {"kind": "capacity_forecast"}},
        "threshold": 0.0,
        "op": ">",
        "windows": [300.0],
    },
    {
        "id": "forecast_kv_pages_eta",
        "description": "KV-page exhaustion stays more than 2 min "
                       "out at the current admission trend",
        "signal": {"type": "gauge",
                   "metric": "zoo_tpu_forecast_eta_s",
                   "labels": {"resource": "kv_pages"}},
        "threshold": 120.0,
        "op": "<",
        "windows": [60.0],
    },
]

DEFAULT_TRAINING_SLOS = [
    {
        "id": "train_step_p99",
        "description": "p99 train-step wall time stays under 10 s",
        "signal": {"type": "quantile",
                   "metric": "zoo_tpu_train_step_seconds",
                   "q": 0.99},
        "threshold": 10.0,
        "op": ">",
        "windows": [120.0, 600.0],
        "min_events": 20,
    },
    {
        "id": "train_data_wait_share",
        "description": "input pipeline keeps data-wait below 60% "
                       "of step wall time (goodput ledger)",
        "signal": {"type": "gauge",
                   "metric": "zoo_tpu_goodput_share",
                   "labels": {"component": "data_wait"}},
        "threshold": 0.6,
        "op": ">",
        "windows": [60.0],
    },
    {
        "id": "train_recompile_rate",
        "description": "XLA recompiles stay under 1 per 5 s "
                       "(shape/dtype leak detector)",
        "signal": {"type": "rate",
                   "metric": "zoo_tpu_xla_compiles_total"},
        "threshold": 0.2,
        "op": ">",
        "windows": [300.0],
    },
]


def enabled() -> bool:
    """Master switch: ``ZOO_TPU_SLO=0`` disables default install and
    the background ticker (explicit engines still work)."""
    return os.environ.get("ZOO_TPU_SLO", "1") != "0"


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _selector(d: "Dict[str, Any]", what: str) -> "Dict[str, Any]":
    _require(isinstance(d, dict) and isinstance(d.get("metric"), str)
             and bool(d.get("metric")),
             f"{what} needs a 'metric' name")
    labels = d.get("labels") or {}
    _require(isinstance(labels, dict), f"{what} labels must be a dict")
    return {"metric": d["metric"],
            "labels": {str(k): str(v) for k, v in labels.items()}}


class SLO:
    """One declarative objective. Build directly or via
    :meth:`from_dict` (the shape of the shipped defaults)."""

    def __init__(self, id: str, signal: "Dict[str, Any]",
                 description: str = "",
                 threshold: Optional[float] = None, op: str = ">",
                 objective: Optional[float] = None,
                 burn_rate: float = 14.0,
                 windows: "Any" = (60.0,), min_events: int = 1):
        _require(isinstance(id, str) and bool(id.strip()),
                 "slo id must be a non-empty string")
        self.id = id.strip()
        _require(isinstance(signal, dict), "signal must be a dict")
        self.kind = signal.get("type")
        _require(self.kind in _SIGNAL_TYPES,
                 f"slo {self.id}: unknown signal type {self.kind!r} "
                 f"(one of {_SIGNAL_TYPES})")
        self.description = str(description or "")
        self.windows = tuple(sorted(float(w) for w in windows))
        _require(bool(self.windows),
                 f"slo {self.id}: needs at least one window")
        _require(all(w > 0 for w in self.windows),
                 f"slo {self.id}: windows must be positive seconds")
        self.min_events = max(1, int(min_events))
        self.op = op
        self.objective = None
        self.burn_rate = None
        self.threshold = None
        self.q = None
        self.num = self.den = self.sel = None
        if self.kind == "ratio":
            _require(objective is not None
                     and 0.0 < float(objective) < 1.0,
                     f"slo {self.id}: ratio signals need an "
                     f"'objective' strictly inside (0, 1)")
            self.objective = float(objective)
            _require(float(burn_rate) > 0,
                     f"slo {self.id}: burn_rate must be > 0")
            self.burn_rate = float(burn_rate)
            self.num = _selector(signal.get("numerator"),
                                 f"slo {self.id}: numerator")
            self.den = _selector(signal.get("denominator"),
                                 f"slo {self.id}: denominator")
        else:
            _require(op in _OPS,
                     f"slo {self.id}: op must be one of "
                     f"{sorted(_OPS)}")
            _require(isinstance(threshold, (int, float)),
                     f"slo {self.id}: {self.kind} signals need a "
                     f"numeric 'threshold'")
            self.threshold = float(threshold)
            self.sel = _selector(signal, f"slo {self.id}: signal")
            if self.kind == "quantile":
                q = signal.get("q")
                _require(isinstance(q, (int, float))
                         and 0.0 < float(q) < 1.0,
                         f"slo {self.id}: quantile signals need "
                         f"'q' strictly inside (0, 1)")
                self.q = float(q)

    @classmethod
    def from_dict(cls, d: "Dict[str, Any]") -> "SLO":
        _require(isinstance(d, dict), "slo definition must be a dict")
        known = {"id", "signal", "description", "threshold", "op",
                 "objective", "burn_rate", "windows", "min_events"}
        extra = set(d) - known
        _require(not extra,
                 f"slo definition has unknown keys: {sorted(extra)}")
        kw = dict(d)
        return cls(kw.pop("id", ""), kw.pop("signal", None), **kw)

    def to_dict(self) -> dict:
        out: "Dict[str, Any]" = {
            "id": self.id, "description": self.description,
            "type": self.kind, "windows": list(self.windows),
            "min_events": self.min_events}
        if self.kind == "ratio":
            out["numerator"] = self.num
            out["denominator"] = self.den
            out["objective"] = self.objective
            out["burn_rate"] = self.burn_rate
        else:
            out["selector"] = self.sel
            out["threshold"] = self.threshold
            out["op"] = self.op
            if self.q is not None:
                out["q"] = self.q
        return out


# ---------------------------------------------------------------------------
# Snapshot math: windowed deltas over MetricsRegistry.snapshot() dicts
# ---------------------------------------------------------------------------

def _children(snap: dict, metric: str,
              labels: "Dict[str, str]") -> "Optional[List[dict]]":
    """Children of ``metric`` whose labels contain ``labels`` as a
    subset; None when the family does not exist (yet)."""
    fam = snap.get(metric)
    if fam is None:
        return None
    out = []
    for rec in fam.get("values", ()):
        rl = rec.get("labels", {})
        if all(rl.get(k) == v for k, v in labels.items()):
            out.append(rec)
    return out


def _scalar_sum(snap: dict, sel: dict) -> Optional[float]:
    kids = _children(snap, sel["metric"], sel["labels"])
    if kids is None:
        return None
    return float(sum(r.get("value", 0.0) for r in kids))


def _counter_delta(cur: dict, base: dict, sel: dict
                   ) -> Optional[float]:
    cur_v = _scalar_sum(cur, sel)
    if cur_v is None:
        return None
    base_v = _scalar_sum(base, sel) or 0.0
    return max(cur_v - base_v, 0.0)


def _hist_delta(cur: dict, base: dict, sel: dict):
    """Windowed histogram delta summed over matching children →
    ``(finite_bounds, per_bucket_counts, count)`` (per-bucket counts
    carry a trailing +Inf entry, the :func:`obs.bucket_quantile`
    contract); None when the family is absent."""
    kids = _children(cur, sel["metric"], sel["labels"])
    if kids is None:
        return None
    base_kids = _children(base, sel["metric"], sel["labels"]) or []

    def agg(children):
        buckets: "Dict[str, float]" = {}
        count = 0.0
        for r in children:
            count += r.get("count", 0)
            for le, c in r.get("buckets", {}).items():
                buckets[le] = buckets.get(le, 0.0) + c
        return buckets, count

    cb, cc = agg(kids)
    bb, bc = agg(base_kids)
    les = sorted((le for le in cb if le != "+Inf"), key=float)
    cum = [cb[le] - bb.get(le, 0.0) for le in les]
    cum.append(cb.get("+Inf", cc) - bb.get("+Inf", 0.0))
    per, prev = [], 0.0
    for c in cum:
        c = max(c, prev)  # deltas of cumulative counts stay monotone
        per.append(c - prev)
        prev = c
    return [float(le) for le in les], per, max(cc - bc, 0.0)


class SLOEngine:
    """Evaluates a set of :class:`SLO` rules against snapshot history
    of a :class:`~analytics_zoo_tpu_torch.common.observability.MetricsRegistry`.

    ``clock`` is injectable (monotonic seconds) so the breach
    lifecycle is unit-testable without sleeps; :meth:`tick` likewise
    accepts an explicit ``now``. Snapshot history lives in a
    :class:`~analytics_zoo_tpu_torch.common.timeseries.MetricHistory`
    (``history``): the global engine shares the process-global
    history that also feeds ``/debug/metrics/history`` and the
    forecaster; explicit-registry engines get a private one on the
    same clock."""

    def __init__(self, registry: "Optional[obs.MetricsRegistry]" = None,
                 clock: "Optional[Callable[[], float]]" = None,
                 history: "Optional[timeseries.MetricHistory]" = None):
        if history is None:
            if registry is None and clock is None:
                history = timeseries.get_history()
            else:
                history = timeseries.MetricHistory(
                    registry=registry or obs.get_registry(),
                    clock=clock)
        self.history = history
        self._registry = registry or obs.get_registry()
        self._clock = clock or time.monotonic
        self._lock = threading.RLock()
        self._rules: "Dict[str, SLO]" = {}
        self._states: "Dict[str, dict]" = {}
        self._ticks = 0
        self._interval_s: Optional[float] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- rule management ----------------------------------------------------
    def add(self, slo: SLO, replace: bool = False) -> SLO:
        with self._lock:
            if slo.id in self._rules and not replace:
                raise ValueError(f"duplicate slo id {slo.id!r}")
            self._rules[slo.id] = slo
            self._states.pop(slo.id, None)
        return slo

    def has(self, slo_id: str) -> bool:
        with self._lock:
            return slo_id in self._rules

    def remove(self, slo_id: str):
        with self._lock:
            self._rules.pop(slo_id, None)
            self._states.pop(slo_id, None)

    def clear(self):
        with self._lock:
            self._rules.clear()
            self._states.clear()
            self.history.clear()

    # -- evaluation ---------------------------------------------------------
    def _baseline(self, now: float, window_s: float):
        """Newest snapshot at least ``window_s`` old; the oldest one
        stands in while the engine is younger than the window
        (delegated to the shared :class:`MetricHistory`)."""
        return self.history.baseline(now, window_s)

    def _window_result(self, rule: SLO, snap: dict, now: float,
                       window_s: float) -> dict:
        out: "Dict[str, Any]" = {"window_s": window_s, "value": None,
                                 "breaching": None}
        base = self._baseline(now, window_s)
        if base is None:
            return out
        bts, bsnap = base
        out["span_s"] = round(max(now - bts, 0.0), 3)
        if rule.kind == "rate":
            delta = _counter_delta(snap, bsnap, rule.sel)
            if delta is None:
                return out
            span = max(now - bts, 1e-9)
            out["value"] = delta / span
            out["breaching"] = _OPS[rule.op](out["value"],
                                             rule.threshold)
        elif rule.kind == "quantile":
            hd = _hist_delta(snap, bsnap, rule.sel)
            if hd is None:
                return out
            les, per, count = hd
            out["events"] = count
            if count < rule.min_events:
                return out
            out["value"] = obs.bucket_quantile(les, per, rule.q)
            out["breaching"] = _OPS[rule.op](out["value"],
                                             rule.threshold)
        else:  # ratio
            num = _counter_delta(snap, bsnap, rule.num)
            den = _counter_delta(snap, bsnap, rule.den)
            if num is None or den is None:
                return out
            out["events"] = den
            if den < rule.min_events:
                return out
            ratio = num / den if den > 0 else 0.0
            budget = 1.0 - rule.objective
            out["value"] = ratio
            out["burn"] = ratio / budget
            out["breaching"] = out["burn"] >= rule.burn_rate
        return out

    def _gauge_result(self, rule: SLO, snap: dict) -> dict:
        value = _scalar_sum(snap, rule.sel)
        if value is None:
            return {"window_s": None, "value": None,
                    "breaching": None}
        return {"window_s": None, "value": value,
                "breaching": _OPS[rule.op](value, rule.threshold)}

    def _evaluate(self, rule: SLO, snap: dict, now: float):
        st = self._states.setdefault(rule.id, {
            "state": "no_data", "breaches": 0, "since": None})
        if rule.kind == "gauge":
            results = [self._gauge_result(rule, snap)]
        else:
            results = [self._window_result(rule, snap, now, w)
                       for w in rule.windows]
        has_data = bool(results) and all(
            r["value"] is not None for r in results)
        breach_now = has_data and all(r["breaching"] for r in results)
        st["windows"] = results
        st["has_data"] = has_data
        st["value"] = results[0]["value"] if results else None
        if not has_data:
            # insufficient signal never transitions the state machine
            if st["state"] not in ("ok", "breach"):
                st["state"] = "no_data"
            return
        prev = st["state"]
        if breach_now:
            if prev != "breach":
                st["breaches"] += 1
                st["since"] = now
                self._registry.counter(
                    "zoo_tpu_slo_breaches_total",
                    help="SLO healthy-to-breach transitions, by "
                         "objective id",
                    labels={"slo": rule.id}).inc()
                diagnostics.anomaly(
                    "slo_breach", slo=rule.id,
                    description=rule.description,
                    value=st["value"],
                    windows=[{k: r.get(k) for k in
                              ("window_s", "value", "burn")}
                             for r in results])
            st["state"] = "breach"
        else:
            if prev == "breach":
                st["since"] = now
                obs.event("slo/recovered", slo=rule.id,
                          value=st["value"])
            st["state"] = "ok"

    def _prune(self, now: float):
        with self._lock:
            max_w = max((r.windows[-1]
                         for r in self._rules.values()),
                        default=600.0)
        # keep the newest snapshot that is already older than the
        # largest window: it is the baseline for full-width windows
        # (the MetricHistory prune contract)
        self.history.prune(now, keep_s=max_w)

    def tick(self, now: Optional[float] = None) -> dict:
        """Snapshot the registry, evaluate every rule against history
        (which holds strictly older snapshots), then append the new
        snapshot to the shared history. Returns :meth:`status`."""
        with self._lock:
            t = self._clock() if now is None else float(now)
            snap = self._registry.snapshot()
            for rule in list(self._rules.values()):
                self._evaluate(rule, snap, t)
            self.history.append(t, snap)
            self._prune(t)
            self._ticks += 1
            return self._status_locked()

    # -- status -------------------------------------------------------------
    def _status_locked(self) -> dict:
        objectives = []
        for rid in sorted(self._rules):
            rule = self._rules[rid]
            st = self._states.get(rid, {})
            rec = rule.to_dict()
            rec.update({
                "state": st.get("state", "no_data"),
                "has_data": st.get("has_data", False),
                "value": st.get("value"),
                "breaches": st.get("breaches", 0),
                "since": st.get("since"),
                "window_results": st.get("windows", []),
            })
            objectives.append(rec)
        return {"enabled": enabled(), "ticks": self._ticks,
                "interval_s": self._interval_s,
                "objectives": objectives}

    def status(self) -> dict:
        with self._lock:
            return self._status_locked()

    # -- background ticker --------------------------------------------------
    def start(self, interval_s: Optional[float] = None) -> "SLOEngine":
        """Start the daemon ticker (idempotent). ``interval_s``
        defaults to ``ZOO_TPU_SLO_TICK_S`` (5 s); ``<= 0`` means no
        thread — callers drive :meth:`tick` themselves."""
        if interval_s is None:
            try:
                interval_s = float(
                    os.environ.get("ZOO_TPU_SLO_TICK_S", "5"))
            except ValueError:
                interval_s = 5.0
        with self._lock:
            self._interval_s = interval_s
            if interval_s <= 0:
                return self
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop_evt = threading.Event()
            self._thread = threading.Thread(
                target=self._run, name="zoo-tpu-slo-ticker",
                daemon=True)
            self._thread.start()
        return self

    def _run(self):
        while not self._stop_evt.wait(self._interval_s):
            try:
                self.tick()
            except Exception:
                pass  # the ticker must outlive a bad snapshot

    def stop(self):
        with self._lock:
            thread = self._thread
            self._thread = None
        self._stop_evt.set()
        if thread is not None:
            thread.join(timeout=2.0)


# ---------------------------------------------------------------------------
# Process-global engine + shipped-default installation
# ---------------------------------------------------------------------------

_global_lock = threading.Lock()
_engine: Optional[SLOEngine] = None


def get_engine() -> SLOEngine:
    """The process-global engine (shared by both HTTP front-ends and
    the Estimator); created on first use."""
    global _engine
    with _global_lock:
        if _engine is None:
            _engine = SLOEngine()
        return _engine


def _env_overrides(d: dict) -> dict:
    """Per-rule env tuning: ``ZOO_TPU_SLO_<ID>_THRESHOLD`` /
    ``_OBJECTIVE`` / ``_BURN_RATE`` (floats) override the shipped
    literal."""
    base = "ZOO_TPU_SLO_" + d["id"].upper()
    out = dict(d)
    for key in ("threshold", "objective", "burn_rate"):
        raw = os.environ.get(base + "_" + key.upper())
        if raw:
            try:
                out[key] = float(raw)
            except ValueError:
                pass
    return out


def install_defaults(engine: SLOEngine, role: str) -> int:
    """Install the shipped objectives for ``role`` (``"serving"``,
    ``"fleet"``, ``"fed"``, ``"forecast"`` or ``"training"``) into
    ``engine``, skipping ids already present (idempotent;
    user-replaced rules are never clobbered). Returns how many rules
    were added."""
    if role == "serving":
        defaults = DEFAULT_SERVING_SLOS
    elif role == "fleet":
        defaults = DEFAULT_FLEET_SLOS
    elif role == "fed":
        defaults = DEFAULT_FED_SLOS
    elif role == "forecast":
        defaults = DEFAULT_FORECAST_SLOS
    elif role == "training":
        defaults = DEFAULT_TRAINING_SLOS
    else:
        raise ValueError(f"unknown slo role {role!r}")
    n = 0
    for d in defaults:
        if engine.has(d["id"]):
            continue
        engine.add(SLO.from_dict(_env_overrides(d)))
        n += 1
    return n


def ensure_default_slos(role: str) -> Optional[SLOEngine]:
    """Install ``role`` defaults on the global engine and start its
    ticker; no-op (returns None) when ``ZOO_TPU_SLO=0``. Both server
    ``start()`` paths and ``Estimator`` training call this."""
    if not enabled():
        return None
    engine = get_engine()
    install_defaults(engine, role)
    return engine.start()


def reset_slo():
    """Drop the global engine (stopping its ticker) — test isolation,
    mirroring ``observability.reset_metrics``."""
    global _engine
    with _global_lock:
        engine = _engine
        _engine = None
    if engine is not None:
        engine.stop()
