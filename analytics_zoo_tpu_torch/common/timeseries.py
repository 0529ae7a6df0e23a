"""Bounded in-process metric time-series store (port of
``analytics_zoo_tpu/common/timeseries.py``).

- :class:`MetricHistory` keeps a bounded raw ring of ``(ts, registry
  snapshot)`` samples plus coarser downsampled tiers, with a hard cap
  on resident bytes. The SLO engine's ticker samples it (one history,
  one clock: :class:`~analytics_zoo_tpu_torch.common.slo.SLOEngine`
  reads its windowed baselines from here); tests tick it by hand with
  an injected ``now``.
- :meth:`MetricHistory.series` answers windowed per-family queries
  (``GET /debug/metrics/history?family=&window=``): counters come back
  as per-interval deltas and rates, gauges as sampled values,
  histograms as quantile summaries (q50/q90/q99 and the event rate),
  per label set.
- Each downsampled tier stores one compact point per ``step_s`` bucket
  (counters as deltas, histograms as quantile summaries; bucket arrays
  are not kept), so wide windows cost tier points, not raw snapshots.

Configuration: ``ZOO_TPU_TSDB_RAW_S`` (raw ring retention, default
900 s), ``ZOO_TPU_TSDB_RAW_MAX`` (raw samples, default 4096),
``ZOO_TPU_TSDB_MAX_BYTES`` (resident cap, default 8 MiB) and
``ZOO_TPU_TSDB_TIERS`` (``step:retention[,...]``, default
``30:3600,300:21600``).

Standard library only, like the rest of the telemetry layer.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.common import observability as obs

__all__ = [
    "MetricHistory",
    "get_history",
    "reset_history",
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


def _parse_tiers(raw: str) -> "List[Tuple[float, float]]":
    """``"30:3600,300:21600"`` → ``[(step_s, retention_s), ...]``
    sorted by step; malformed entries are silently dropped."""
    out = []
    for part in (raw or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            step, ret = part.split(":")
            step_f, ret_f = float(step), float(ret)
        except ValueError:
            continue
        if step_f > 0 and ret_f > 0:
            out.append((step_f, ret_f))
    return sorted(out)


def _label_key(labels: "Optional[Dict[str, Any]]"
               ) -> "Tuple[Tuple[str, str], ...]":
    return tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))


def _match(labels: "Dict[str, str]",
           want: "Optional[Dict[str, str]]") -> bool:
    return all(labels.get(k) == v for k, v in (want or {}).items())


def _approx_snapshot_bytes(snap: dict) -> int:
    """Cheap resident-size estimate of one registry snapshot —
    counted, not serialized (sampling must stay cheap)."""
    n = 0
    for name, fam in snap.items():
        n += 64 + len(name)
        for rec in fam.get("values", ()):
            n += 120
            n += 24 * len(rec.get("labels", {}))
            n += 24 * len(rec.get("buckets", {}))
    return n


def _approx_point_bytes(fams: dict) -> int:
    n = 0
    for name, fam in fams.items():
        n += 64 + len(name)
        n += 100 * len(fam.get("values", ()))
    return n


def _bucket_delta(cur_rec: dict, prev_rec: "Optional[dict]"):
    """``(finite_bounds, per_bucket_counts(+Inf tail), count_delta,
    sum_delta)`` between two cumulative histogram children
    (``prev_rec`` may be None). Deltas of cumulative counts are
    clamped monotone, so a source restart (counter reset) never
    yields negatives."""
    cb = cur_rec.get("buckets", {})
    cc = float(cur_rec.get("count", 0))
    cs = float(cur_rec.get("sum", 0.0))
    pb = (prev_rec or {}).get("buckets", {})
    pc = float((prev_rec or {}).get("count", 0))
    ps = float((prev_rec or {}).get("sum", 0.0))
    les = sorted((le for le in cb if le != "+Inf"), key=float)
    cum = [max(float(cb[le]) - float(pb.get(le, 0.0)), 0.0)
           for le in les]
    cum.append(max(float(cb.get("+Inf", cc))
                   - float(pb.get("+Inf", 0.0)), 0.0))
    per, prev_c = [], 0.0
    for c in cum:
        c = max(c, prev_c)
        per.append(c - prev_c)
        prev_c = c
    return ([float(le) for le in les], per,
            max(cc - pc, 0.0), max(cs - ps, 0.0))


def _hist_summary(les, per, count: float, dsum: float) -> dict:
    """Quantile summary of a windowed histogram delta (NaN → None
    so the payload stays strict-JSON-parseable)."""
    if count <= 0:
        return {"count": 0.0, "sum": 0.0,
                "q50": None, "q90": None, "q99": None}
    out = {"count": count, "sum": dsum}
    for name, q in (("q50", 0.5), ("q90", 0.9), ("q99", 0.99)):
        v = obs.bucket_quantile(les, per, q)
        out[name] = None if v != v else round(v, 9)
    return out


class _Tier:
    """One downsampling tier: at most one compact point per
    ``step_s`` time bucket, retained ``retention_s`` seconds."""

    __slots__ = ("step_s", "retention_s", "points", "bytes",
                 "_bucket", "_prev", "_prev_ts")

    def __init__(self, step_s: float, retention_s: float):
        self.step_s = float(step_s)
        self.retention_s = float(retention_s)
        self.points: "collections.deque" = collections.deque()
        self.bytes = 0
        self._bucket: Optional[float] = None
        # (family, labelkey) -> last cumulative value/record
        self._prev: "Dict[tuple, Any]" = {}
        self._prev_ts: Optional[float] = None

    def offer(self, ts: float, snap: dict) -> bool:
        """Downsample ``snap`` into this tier iff ``ts`` opens a new
        ``step_s`` bucket (first sample in each bucket wins)."""
        bucket = ts - (ts % self.step_s)
        if self._bucket is not None and bucket <= self._bucket:
            return False
        fams: "Dict[str, dict]" = {}
        prev = self._prev
        nxt: "Dict[tuple, Any]" = {}
        for name, fam in snap.items():
            mtype = fam.get("type")
            vals = []
            for rec in fam.get("values", ()):
                labels = dict(rec.get("labels", {}))
                lk = (name, _label_key(labels))
                if mtype == "gauge":
                    vals.append({"labels": labels,
                                 "value": float(
                                     rec.get("value", 0.0))})
                elif mtype == "counter":
                    cur = float(rec.get("value", 0.0))
                    base = prev.get(lk, 0.0)
                    vals.append({"labels": labels,
                                 "value": max(cur - base, 0.0)})
                    nxt[lk] = cur
                else:
                    les, per, dc, ds = _bucket_delta(
                        rec, prev.get(lk))
                    vals.append(dict(
                        {"labels": labels},
                        **_hist_summary(les, per, dc, ds)))
                    nxt[lk] = {
                        "buckets": dict(rec.get("buckets", {})),
                        "count": rec.get("count", 0),
                        "sum": rec.get("sum", 0.0)}
            fams[name] = {"type": mtype, "values": vals}
        dt = (ts - self._prev_ts) if self._prev_ts is not None \
            else self.step_s
        point = {"ts": ts, "dt": max(float(dt), 1e-9),
                 "fams": fams}
        self.points.append(point)
        self.bytes += _approx_point_bytes(fams)
        self._bucket = bucket
        self._prev = nxt
        self._prev_ts = ts
        horizon = ts - self.retention_s
        while self.points and self.points[0]["ts"] < horizon:
            dropped = self.points.popleft()
            self.bytes -= _approx_point_bytes(dropped["fams"])
        return True

    def clear(self):
        self.points.clear()
        self.bytes = 0
        self._bucket = None
        self._prev = {}
        self._prev_ts = None


class MetricHistory:
    """Bounded ring of registry snapshots + downsampled tiers.

    ``registry=None`` builds an append-only store (the federation
    collector feeds it merged fleet snapshots); with a registry,
    :meth:`sample`/:meth:`tick` snapshot it directly. ``clock`` is
    injectable (monotonic seconds) and every mutating entry point
    accepts an explicit ``now``/``ts`` — no test ever sleeps."""

    def __init__(self, registry: "Optional[obs.MetricsRegistry]"
                 = None,
                 clock: "Optional[Callable[[], float]]" = None,
                 raw_retention_s: Optional[float] = None,
                 raw_max: Optional[int] = None,
                 max_bytes: Optional[int] = None,
                 tiers: "Optional[List[Tuple[float, float]]]"
                 = None):
        self._registry = registry
        self._clock = clock or time.monotonic
        if raw_retention_s is None:
            raw_retention_s = _env_float("ZOO_TPU_TSDB_RAW_S",
                                         900.0)
        self.raw_retention_s = max(float(raw_retention_s), 1.0)
        if raw_max is None:
            raw_max = _env_int("ZOO_TPU_TSDB_RAW_MAX", 4096)
        self.raw_max = max(int(raw_max), 2)
        if max_bytes is None:
            max_bytes = _env_int("ZOO_TPU_TSDB_MAX_BYTES",
                                 8 * 1024 * 1024)
        self.max_bytes = max(int(max_bytes), 65536)
        if tiers is None:
            tiers = _parse_tiers(os.environ.get(
                "ZOO_TPU_TSDB_TIERS", "30:3600,300:21600"))
        self._tiers = [_Tier(s, r) for s, r in tiers]
        self._lock = threading.RLock()
        # raw ring entries: (ts, snapshot, approx_bytes)
        self._raw: "collections.deque" = collections.deque()
        self._raw_bytes = 0
        self._samples = 0
        self._evictions = 0
        self._listeners: "List[Callable]" = []

    # -- ingestion ----------------------------------------------------------
    def append(self, ts: float, snap: dict) -> dict:
        """Record one ``(ts, snapshot)`` sample: raw ring + tier
        downsampling + cap enforcement, then listener fan-out (the
        forecaster rides here). Listeners run outside the lock."""
        with self._lock:
            ts = float(ts)
            b = _approx_snapshot_bytes(snap)
            self._raw.append((ts, snap, b))
            self._raw_bytes += b
            self._samples += 1
            for tier in self._tiers:
                tier.offer(ts, snap)
            self.prune(ts)
            self._enforce_caps()
            if self._registry is not None:
                self._registry.counter(
                    "zoo_tpu_tsdb_samples_total",
                    help="metric-history samples recorded").inc()
                self._registry.gauge(
                    "zoo_tpu_tsdb_resident_bytes",
                    help="approximate resident bytes of the metric"
                         " history (raw ring + tiers)").set(
                    self._raw_bytes
                    + sum(t.bytes for t in self._tiers))
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(self, ts)
            except Exception:
                pass  # a bad listener must not break sampling
        return snap

    def sample(self, now: Optional[float] = None
               ) -> "Tuple[float, dict]":
        """Snapshot the bound registry and append it."""
        if self._registry is None:
            raise ValueError(
                "this MetricHistory has no registry to sample "
                "(append() only — e.g. the fleet-merged history)")
        t = self._clock() if now is None else float(now)
        snap = self._registry.snapshot()
        self.append(t, snap)
        return t, snap

    def tick(self, now: Optional[float] = None
             ) -> "Tuple[float, dict]":
        """Manual sampling tick (the injectable-``now`` convention
        of slo.py / federation.py — tests never sleep)."""
        return self.sample(now=now)

    # -- retention ----------------------------------------------------------
    def prune(self, now: float, keep_s: Optional[float] = None):
        """Drop raw entries older than the retention horizon, but
        always keep the newest entry already older than it: that
        entry is the baseline for full-width windows (the slo.py
        windows-clip-to-uptime contract)."""
        with self._lock:
            horizon = float(now) - max(float(keep_s or 0.0),
                                       self.raw_retention_s)
            raw = self._raw
            while len(raw) >= 2 and raw[1][0] <= horizon:
                self._raw_bytes -= raw.popleft()[2]

    def _enforce_caps(self):
        """Hard caps: sample count and resident bytes (down to a
        2-sample floor so windowed deltas always have a baseline).
        Evicted samples already live on in the tiers."""
        raw = self._raw
        while len(raw) > self.raw_max or (
                self._raw_bytes > self.max_bytes and len(raw) > 2):
            self._raw_bytes -= raw.popleft()[2]
            self._evictions += 1

    # -- SLO-engine seam ----------------------------------------------------
    def baseline(self, now: float, window_s: float):
        """Newest raw sample at least ``window_s`` old; the oldest
        one stands in while history is younger than the window."""
        with self._lock:
            best = None
            for ts, snap, _b in self._raw:
                if ts <= now - window_s:
                    best = (ts, snap)
                else:
                    break
            if best is None and self._raw:
                ts, snap, _b = self._raw[0]
                best = (ts, snap)
            return best

    def __len__(self) -> int:
        with self._lock:
            return len(self._raw)

    def clear(self):
        with self._lock:
            self._raw.clear()
            self._raw_bytes = 0
            for tier in self._tiers:
                tier.clear()

    # -- queries ------------------------------------------------------------
    def families(self) -> "List[dict]":
        """Known families (name + type), newest raw snapshot union
        the tiers (a family evicted from raw may persist there)."""
        with self._lock:
            out: "Dict[str, str]" = {}
            if self._raw:
                for name, fam in self._raw[-1][1].items():
                    out.setdefault(name, fam.get("type"))
            for tier in self._tiers:
                for p in tier.points:
                    for name, fam in p["fams"].items():
                        out.setdefault(name, fam.get("type"))
            return [{"family": k, "type": out[k]}
                    for k in sorted(out)]

    def series(self, family: str,
               window_s: Optional[float] = None,
               now: Optional[float] = None,
               labels: "Optional[Dict[str, str]]" = None) -> dict:
        """Windowed per-label-set series for one family.

        Raw ring when the window fits its retention, else the
        finest tier that covers it. Counters → per-interval deltas
        (``value``) + ``rate``; gauges → sampled ``value``;
        histograms → ``count``/``sum``/``q50``/``q90``/``q99`` +
        ``rate`` per interval."""
        with self._lock:
            if now is None:
                now = self._clock()
            w = float(window_s) if window_s else \
                self.raw_retention_s
            use_raw = w <= self.raw_retention_s + 1e-9
            tier = None
            if not use_raw:
                for t in self._tiers:
                    if t.retention_s + 1e-9 >= w:
                        tier = t
                        break
                if tier is None and self._tiers:
                    tier = self._tiers[-1]
                if tier is None:
                    use_raw = True
            if use_raw:
                return self._series_raw(family, w, now, labels)
            return self._series_tier(tier, family, w, now, labels)

    def _series_raw(self, family, w, now, labels) -> dict:
        start = now - w
        kept = []
        prev_entry = None
        for ts, snap, _b in self._raw:
            if ts < start:
                prev_entry = (ts, snap)
            else:
                kept.append((ts, snap))
        mtype = None
        for ts, snap, _b in reversed(self._raw):
            fam = snap.get(family)
            if fam is not None:
                mtype = fam.get("type")
                break
        out = {"family": family, "type": mtype, "window_s": w,
               "now": now, "source": "raw", "series": []}
        if mtype is None:
            return out
        keys: "Dict[tuple, dict]" = {}
        for _ts, snap in kept:
            fam = snap.get(family) or {}
            for rec in fam.get("values", ()):
                ld = dict(rec.get("labels", {}))
                if labels and not _match(ld, labels):
                    continue
                keys.setdefault(_label_key(ld), ld)
        chain = ([prev_entry] if prev_entry else []) + kept
        for lk in sorted(keys):
            ld = keys[lk]
            pts = []
            prev_rec = None
            prev_ts = None
            for ts, snap in chain:
                rec = None
                fam = snap.get(family) or {}
                for r in fam.get("values", ()):
                    if _label_key(r.get("labels", {})) == lk:
                        rec = r
                        break
                if rec is None:
                    continue
                if mtype == "gauge":
                    if ts >= start:
                        pts.append({
                            "ts": ts,
                            "value": float(rec.get("value",
                                                   0.0))})
                elif mtype == "counter":
                    if prev_rec is not None and ts >= start:
                        d = max(float(rec.get("value", 0.0))
                                - float(prev_rec.get("value",
                                                     0.0)), 0.0)
                        dt = max(ts - prev_ts, 1e-9)
                        pts.append({"ts": ts, "value": d,
                                    "rate": d / dt})
                    prev_rec, prev_ts = rec, ts
                else:
                    if prev_rec is not None and ts >= start:
                        les, per, dc, ds = _bucket_delta(
                            rec, prev_rec)
                        dt = max(ts - prev_ts, 1e-9)
                        pts.append(dict(
                            {"ts": ts, "rate": dc / dt},
                            **_hist_summary(les, per, dc, ds)))
                    prev_rec, prev_ts = rec, ts
            out["series"].append({"labels": ld, "points": pts})
        return out

    def _series_tier(self, tier, family, w, now, labels) -> dict:
        start = now - w
        out = {"family": family, "type": None, "window_s": w,
               "now": now, "source": f"tier:{int(tier.step_s)}",
               "series": []}
        keyed: "Dict[tuple, Tuple[dict, list]]" = {}
        for p in tier.points:
            if p["ts"] < start:
                continue
            fam = p["fams"].get(family)
            if fam is None:
                continue
            if out["type"] is None:
                out["type"] = fam.get("type")
            for rec in fam.get("values", ()):
                ld = dict(rec.get("labels", {}))
                if labels and not _match(ld, labels):
                    continue
                lk = _label_key(ld)
                pt = {k: v for k, v in rec.items()
                      if k != "labels"}
                pt["ts"] = p["ts"]
                if out["type"] == "counter":
                    pt["rate"] = float(pt.get("value", 0.0)) \
                        / max(p["dt"], 1e-9)
                elif out["type"] == "histogram":
                    pt["rate"] = float(pt.get("count", 0.0)) \
                        / max(p["dt"], 1e-9)
                keyed.setdefault(lk, (ld, []))[1].append(pt)
        for lk in sorted(keyed):
            ld, pts = keyed[lk]
            out["series"].append({"labels": ld, "points": pts})
        return out

    def export(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> dict:
        """Full history dump as one JSON-able document."""
        with self._lock:
            if now is None:
                now = self._clock()
            doc = {"now": float(now),
                   "window_s": (float(window_s) if window_s
                                else self.raw_retention_s),
                   "stats": self.stats(),
                   "families": {}}
            for f in self.families():
                doc["families"][f["family"]] = self.series(
                    f["family"], window_s=window_s, now=now)
            return doc

    def stats(self) -> dict:
        with self._lock:
            return {
                "raw_samples": len(self._raw),
                "raw_retention_s": self.raw_retention_s,
                "raw_max": self.raw_max,
                "resident_bytes": self._raw_bytes
                + sum(t.bytes for t in self._tiers),
                "max_bytes": self.max_bytes,
                "samples_total": self._samples,
                "evictions": self._evictions,
                "span_s": (round(self._raw[-1][0]
                                 - self._raw[0][0], 3)
                           if len(self._raw) >= 2 else 0.0),
                "tiers": [{"step_s": t.step_s,
                           "retention_s": t.retention_s,
                           "points": len(t.points)}
                          for t in self._tiers],
            }

    # -- listeners ----------------------------------------------------------
    def add_listener(self, fn: Callable):
        """Register ``fn(history, ts)`` to run after every sample
        (outside the lock). Idempotent per function object."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn: Callable):
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)


# ---------------------------------------------------------------------------
# Process-global history (one history, one clock)
# ---------------------------------------------------------------------------

_global_lock = threading.Lock()
_history: Optional[MetricHistory] = None


def get_history() -> MetricHistory:
    """The process-global history over the global metrics registry
    — shared by the SLO engine, the forecaster and both HTTP
    front-ends; created on first use."""
    global _history
    with _global_lock:
        if _history is None:
            _history = MetricHistory(registry=obs.get_registry())
        return _history


def reset_history():
    """Drop the global history (test isolation, mirroring
    ``observability.reset_metrics``)."""
    global _history
    with _global_lock:
        _history = None
