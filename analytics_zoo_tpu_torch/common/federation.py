"""Fleet-wide telemetry: metric federation and trace stitching (port
of ``analytics_zoo_tpu/common/federation.py``).

- :func:`merge_snapshots` folds N ``MetricsRegistry.snapshot()`` dumps
  into one: counters summed, histogram buckets added (over the
  intersection of the bucket boundaries when the layouts differ:
  cumulative counts at a shared ``le`` stay exact), gauges kept per
  source under an added ``replica=`` label, and a type conflict
  resolved first-seen-wins with the losers reported.
- the :class:`TraceAggregator` joins span records scraped from every
  process by trace id (the ``X-Zoo-Trace-Id`` the serving stack
  propagates), so one request renders as one timeline, each process on
  its own Perfetto lane.
- the :class:`TelemetryCollector` scrapes each replica's
  ``GET /metrics/json`` and its incremental ``GET /debug/traces?since=``
  cursor, merges, publishes the ``zoo_tpu_fed_*`` summary gauges (which
  the ``fed`` objectives of ``common/slo.py`` read) and feeds per-replica
  window stats to
  :class:`~analytics_zoo_tpu_torch.common.diagnostics.ReplicaSkewDetector`.
  It reads ``router.pool.replicas[*]`` (``.name``, ``.url``) and needs
  nothing else of a router. Its ticker runs every ``ZOO_TPU_FED_TICK_S``
  (default 5 s); ``<= 0`` starts no thread: drive
  :meth:`~TelemetryCollector.tick` with an injected ``now``.

Standard library only (urllib for the scrapes).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.common import diagnostics
from analytics_zoo_tpu_torch.common import observability as obs
from analytics_zoo_tpu_torch.common import timeseries
from analytics_zoo_tpu_torch.common import tracing

__all__ = [
    "merge_snapshots",
    "render_prometheus",
    "TraceAggregator",
    "TelemetryCollector",
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
# Metric federation: merge N registry snapshots into one
# ---------------------------------------------------------------------------

def _label_key(labels: "Dict[str, Any]"
               ) -> "Tuple[Tuple[str, str], ...]":
    return tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))


def _merge_histograms(children: "List[dict]") -> dict:
    """Fold same-label histogram children from multiple sources.

    Identical bucket layouts sum pointwise. Mismatched layouts merge
    over the **intersection** of finite bounds — exact, not an
    approximation: a cumulative count at bound ``le`` ("observations
    ≤ le") is a valid statement regardless of what other bounds a
    source used, so summing cumulative counts at shared bounds loses
    nothing but resolution between dropped bounds. ``+Inf``, count
    and sum always survive."""
    bound_sets = []
    for rec in children:
        bound_sets.append({le for le in rec.get("buckets", {})
                           if le != "+Inf"})
    shared = set.intersection(*bound_sets) if bound_sets else set()
    les = sorted(shared, key=float)
    buckets: "Dict[str, float]" = {le: 0.0 for le in les}
    total = 0.0
    count = 0.0
    hsum = 0.0
    for rec in children:
        b = rec.get("buckets", {})
        c = float(rec.get("count", 0))
        for le in les:
            buckets[le] += float(b.get(le, 0.0))
        total += float(b.get("+Inf", c))
        count += c
        hsum += float(rec.get("sum", 0.0))
    buckets["+Inf"] = total
    return {"count": count, "sum": hsum, "buckets": buckets}


def merge_snapshots(snapshots: "Dict[str, dict]"
                    ) -> "Tuple[dict, List[dict]]":
    """Merge per-source ``MetricsRegistry.snapshot()`` dumps into one
    snapshot-shaped dict (renderable by :func:`render_prometheus`).

    ``snapshots`` maps source name (replica/process) → snapshot.
    Rules:

    - **counters**: summed across sources per label set;
    - **histograms**: counts/sums added; bucket counts added over
      the intersection of bucket boundaries when sources disagree
      (see :func:`_merge_histograms` — exact for cumulative counts);
    - **gauges**: kept per-source — a ``replica=<source>`` label is
      added (a point-in-time value summed across processes is
      meaningless; per-source it stays diagnosable). A child that
      already carries a ``replica`` label keeps it (it is already a
      per-replica identity, e.g. the router's own fleet gauges);
    - **type conflicts**: the first-seen type (sources in sorted
      name order) wins; later sources' conflicting families are
      dropped and reported in the returned conflict list — merging
      a counter into a histogram would corrupt both.

    Returns ``(merged, conflicts)``; ``conflicts`` entries are
    ``{"metric", "source", "type", "kept_type"}``."""
    merged: "Dict[str, dict]" = {}
    conflicts: "List[dict]" = []
    # (name, label_key) -> list of child recs, for counter/histogram
    acc: "Dict[Tuple[str, tuple], List[dict]]" = {}
    for source in sorted(snapshots):
        snap = snapshots[source] or {}
        for name in sorted(snap):
            fam = snap[name]
            mtype = fam.get("type")
            if name not in merged:
                merged[name] = {"type": mtype,
                                "help": fam.get("help", ""),
                                "values": []}
            elif merged[name]["type"] != mtype:
                conflicts.append({
                    "metric": name, "source": source,
                    "type": mtype,
                    "kept_type": merged[name]["type"]})
                continue
            if not merged[name]["help"]:
                merged[name]["help"] = fam.get("help", "")
            for rec in fam.get("values", ()):
                labels = dict(rec.get("labels", {}))
                if mtype == "gauge":
                    if "replica" not in labels:
                        labels["replica"] = source
                    merged[name]["values"].append(
                        {"labels": labels,
                         "value": float(rec.get("value", 0.0))})
                else:
                    acc.setdefault(
                        (name, _label_key(labels)),
                        []).append(rec)
    for (name, lkey), children in acc.items():
        labels = dict(lkey)
        if merged[name]["type"] == "histogram":
            out = dict(_merge_histograms(children), labels=labels)
        else:
            out = {"labels": labels,
                   "value": float(sum(
                       float(r.get("value", 0.0))
                       for r in children))}
        merged[name]["values"].append(out)
    for fam in merged.values():
        fam["values"].sort(
            key=lambda r: _label_key(r.get("labels", {})))
    return merged, conflicts


def render_prometheus(merged: dict) -> str:
    """Prometheus text exposition (format 0.0.4) of a merged
    snapshot. One ``# HELP`` / ``# TYPE`` per family — deduplicated
    by construction, since :func:`merge_snapshots` collapses every
    source's family into one."""
    esc = obs._escape_label
    fmt = obs._fmt
    lines: "List[str]" = []

    def label_str(labels: "Dict[str, str]",
                  extra: "Optional[Tuple[str, str]]" = None) -> str:
        items = sorted(labels.items())
        if extra is not None:
            items = items + [extra]
        if not items:
            return ""
        inner = ",".join(f'{k}="{esc(v)}"' for k, v in items)
        return "{" + inner + "}"

    for name in sorted(merged):
        fam = merged[name]
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam.get('type', 'untyped')}")
        for rec in fam.get("values", ()):
            labels = rec.get("labels", {})
            if fam.get("type") == "histogram":
                buckets = rec.get("buckets", {})
                les = sorted((le for le in buckets if le != "+Inf"),
                             key=float)
                for le in les:
                    lines.append(
                        f"{name}_bucket"
                        f"{label_str(labels, ('le', le))} "
                        f"{fmt(buckets[le])}")
                inf = buckets.get("+Inf", rec.get("count", 0))
                lines.append(
                    f"{name}_bucket"
                    f"{label_str(labels, ('le', '+Inf'))} "
                    f"{fmt(inf)}")
                lines.append(f"{name}_sum{label_str(labels)} "
                             f"{fmt(rec.get('sum', 0.0))}")
                lines.append(f"{name}_count{label_str(labels)} "
                             f"{fmt(rec.get('count', 0))}")
            else:
                lines.append(f"{name}{label_str(labels)} "
                             f"{fmt(rec.get('value', 0.0))}")
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Trace stitching: join spans from N processes by trace id
# ---------------------------------------------------------------------------

class TraceAggregator:
    """Router-side store of span records scraped from every process
    in the fleet, joined by trace id. Spans arrive as plain dicts
    (the ``/debug/traces?since=`` wire shape) and are tagged with
    their ``source`` process, so the Perfetto export can give each
    process its own lane. Bounded ring
    (``ZOO_TPU_FED_TRACE_BUFFER`` spans, default 8192) — a flight
    recorder, like the per-process store it federates."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = _env_int("ZOO_TPU_FED_TRACE_BUFFER", 8192)
        self.capacity = max(1, int(capacity))
        self._buf: "collections.deque" = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()

    def add_spans(self, source: str, spans: "List[dict]") -> int:
        """Ingest one scrape's worth of span dicts from ``source``.
        Returns how many were added."""
        n = 0
        with self._lock:
            for rec in spans:
                if not isinstance(rec, dict) or \
                        not rec.get("trace_id"):
                    continue
                rec = dict(rec)
                rec.setdefault("source", source)
                self._buf.append(rec)
                n += 1
        return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def spans(self, trace_id: str) -> "List[dict]":
        with self._lock:
            recs = [dict(r) for r in self._buf
                    if r.get("trace_id") == trace_id]
        recs.sort(key=lambda r: r.get("t_start", 0.0))
        return recs

    def trace(self, trace_id: str) -> "Optional[dict]":
        """One stitched timeline: every buffered span of
        ``trace_id`` from every source, oldest-start first, plus the
        set of processes it touched. None when unknown."""
        recs = self.spans(trace_id)
        if not recs:
            return None
        t0 = min(r.get("t_start", 0.0) for r in recs)
        t1 = max(r.get("t_start", 0.0) + (r.get("dur_s") or 0.0)
                 for r in recs)
        return {"trace_id": trace_id,
                "t_start": round(t0, 6),
                "dur_s": round(t1 - t0, 6),
                "n_spans": len(recs),
                "sources": sorted({r.get("source", "router")
                                   for r in recs}),
                "spans": recs}

    def chrome(self, trace_id: Optional[str] = None) -> dict:
        """Perfetto-loadable chrome-trace JSON with one process lane
        per SOURCE process (distinct pid per replica), so one
        request renders as parallel tracks: router dispatch on one
        lane, the replica's queue/pad/execute on another."""
        with self._lock:
            recs = list(self._buf)
        if trace_id is not None:
            recs = [r for r in recs if r.get("trace_id") == trace_id]
        return {"traceEvents": tracing.chrome_events(
            recs, source_lanes=True),
            "displayTimeUnit": "ms"}

    def recent(self, n: int = 20) -> "List[dict]":
        """The ``n`` most recently completed stitched traces, newest
        first (same shape as :meth:`trace`, without the full span
        list capped)."""
        with self._lock:
            recs = list(self._buf)
        order: "List[str]" = []
        seen = set()
        for r in recs:
            tid = r.get("trace_id")
            if tid in seen:
                order.remove(tid)
            else:
                seen.add(tid)
            order.append(tid)
        out = []
        for tid in reversed(order[-max(0, n):] if n else []):
            t = self.trace(tid)
            if t is not None:
                out.append(t)
        return out

    def clear(self):
        with self._lock:
            self._buf.clear()


# ---------------------------------------------------------------------------
# The collector: scrape → merge → publish → detect
# ---------------------------------------------------------------------------

def _fed_sources_gauge():
    return obs.gauge("zoo_tpu_fed_sources",
                     help="telemetry sources merged in the last "
                          "federation tick")


def _fed_scrapes(replica: str, ok: bool):
    return obs.counter("zoo_tpu_fed_scrapes_total",
                       help="federation scrape attempts by source "
                            "and outcome",
                       labels={"replica": replica,
                               "ok": "1" if ok else "0"})


def _fed_spans(replica: str):
    return obs.counter("zoo_tpu_fed_spans_total",
                       help="trace spans collected per source",
                       labels={"replica": replica})


def _fed_source_age(replica: str):
    return obs.gauge("zoo_tpu_fed_source_age_s",
                     help="age of each source's newest good "
                          "scrape (carried-forward data shows "
                          "its true staleness here)",
                     labels={"replica": replica})


def _fed_p99_gauge():
    return obs.gauge("zoo_tpu_fed_latency_p99_seconds",
                     help="fleet-wide /predict p99 over the last "
                          "federation window")


def _fed_error_gauge():
    return obs.gauge("zoo_tpu_fed_error_ratio",
                     help="fleet-wide serving error ratio over the "
                          "last federation window")


def _hist_children(snap: dict, metric: str) -> "List[dict]":
    fam = snap.get(metric) or {}
    if fam.get("type") != "histogram":
        return []
    return list(fam.get("values", ()))


def _window_hist_stats(cur: dict, prev: dict, metric: str,
                       label_filter: "Optional[Dict[str, str]]"
                       = None) -> "Tuple[Optional[float], float]":
    """(p99, events) of ``metric`` over the delta between two
    snapshots of ONE source, children summed (optionally filtered by
    a label subset). None p99 when the family is absent or empty."""

    def agg(snap):
        buckets: "Dict[str, float]" = {}
        count = 0.0
        for rec in _hist_children(snap, metric):
            labels = rec.get("labels", {})
            if label_filter and any(
                    labels.get(k) != v
                    for k, v in label_filter.items()):
                continue
            count += float(rec.get("count", 0))
            for le, c in rec.get("buckets", {}).items():
                buckets[le] = buckets.get(le, 0.0) + float(c)
        return buckets, count

    cb, cc = agg(cur)
    pb, pc = agg(prev)
    if not cb:
        return None, 0.0
    les = sorted((le for le in cb if le != "+Inf"), key=float)
    cum = [max(cb[le] - pb.get(le, 0.0), 0.0) for le in les]
    cum.append(max(cb.get("+Inf", cc) - pb.get("+Inf", 0.0), 0.0))
    per, prev_c = [], 0.0
    for c in cum:
        c = max(c, prev_c)
        per.append(c - prev_c)
        prev_c = c
    events = max(cc - pc, 0.0)
    if events <= 0:
        return None, 0.0
    p99 = obs.bucket_quantile([float(le) for le in les], per, 0.99)
    return p99, events


def _counter_sum(snap: dict, metric: str,
                 labels: "Optional[Dict[str, str]]" = None
                 ) -> float:
    fam = snap.get(metric) or {}
    total = 0.0
    for rec in fam.get("values", ()):
        rl = rec.get("labels", {})
        if labels and any(rl.get(k) != v
                          for k, v in labels.items()):
            continue
        total += float(rec.get("value", 0.0))
    return total


class TelemetryCollector:
    """Scrapes every telemetry source of a fleet, merges, publishes.

    Sources: the router's own process (in-process replicas share its
    registry and trace ring, so "router" covers them) plus one
    source per replica exposing a ``.url`` (HttpReplica processes),
    scraped over ``GET /metrics/json`` and the incremental
    ``GET /debug/traces?since=<seq>`` cursor.

    Each :meth:`tick`:

    1. scrapes all sources (a failed scrape keeps the source's last
       snapshot, marked stale — a wedged replica must not blank the
       fleet view);
    2. merges metric snapshots (:func:`merge_snapshots`) for
       ``GET /metrics?fleet=1`` / ``GET /debug/fleet/telemetry``;
    3. ingests new spans into the :class:`TraceAggregator`
       (``GET /debug/trace/<id>`` serves stitched timelines);
    4. publishes fleet summary gauges (``zoo_tpu_fed_*``) that the
       federated SLO rules evaluate;
    5. computes per-replica window stats from the router's
       per-replica dispatch histograms and runs the
       :class:`~analytics_zoo_tpu_torch.common.diagnostics.
       ReplicaSkewDetector`.

    ``tick_s=None`` reads ``ZOO_TPU_FED_TICK_S`` (default 5 s);
    ``<= 0`` starts no thread (manual :meth:`tick`, injectable
    ``now``)."""

    def __init__(self, router, tick_s: Optional[float] = None,
                 clock: "Optional[Callable[[], float]]" = None,
                 scrape_timeout_s: float = 5.0,
                 skew: "Optional[diagnostics.ReplicaSkewDetector]"
                 = None):
        self.router = router
        if tick_s is None:
            tick_s = _env_float("ZOO_TPU_FED_TICK_S", 5.0)
        self.tick_s = float(tick_s)
        self._clock = clock or time.monotonic
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.aggregator = TraceAggregator()
        self.skew = skew if skew is not None else \
            diagnostics.ReplicaSkewDetector()
        self._lock = threading.RLock()
        self._merged: "Optional[dict]" = None
        self._conflicts: "List[dict]" = []
        self._snaps: "Dict[str, dict]" = {}     # last good snapshot
        self._prev_snaps: "Dict[str, dict]" = {}
        self._prev_replica_stats: "Dict[str, dict]" = {}
        self._cursors: "Dict[str, int]" = {}    # source -> trace seq
        self._source_meta: "Dict[str, dict]" = {}
        self._carried: "List[str]" = []
        # fleet-merged metric history: one timeline across replicas
        # (append-only — fed merged snapshots each tick; served via
        # GET /debug/metrics/history?fleet=1)
        self.history = timeseries.MetricHistory(
            registry=None, clock=self._clock)
        self._ticks = 0
        self._last_tick_at: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    # -- sources -------------------------------------------------------------
    def _http_sources(self) -> "List[Tuple[str, str]]":
        out = []
        pool = getattr(self.router, "pool", None)
        for r in getattr(pool, "replicas", ()):
            url = getattr(r, "url", None)
            if url:
                out.append((r.name, url))
        return out

    def _fetch_json(self, url: str) -> dict:
        with urllib.request.urlopen(
                url, timeout=self.scrape_timeout_s) as resp:
            return json.loads(resp.read())

    def _scrape_one(self, name: str, url: str,
                    at: Optional[float] = None) -> None:
        """One source's metrics + incremental trace scrape; records
        the outcome, never raises (telemetry must not take down the
        router). ``at`` is the tick timestamp the scrape is stamped
        with (falls back to the clock), so source ages stay on the
        injectable-clock timeline."""
        meta = self._source_meta.setdefault(name, {})
        try:
            payload = self._fetch_json(url + "/metrics/json")
            snap = payload.get("metrics", payload)
            since = self._cursors.get(name, 0)
            tr = self._fetch_json(
                f"{url}/debug/traces?since={since}")
            spans = tr.get("spans", [])
            self._cursors[name] = int(tr.get("seq", since))
        except Exception as e:
            _fed_scrapes(name, ok=False).inc()
            meta["ok"] = False
            meta["error"] = f"{type(e).__name__}: {e}"
            return
        _fed_scrapes(name, ok=True).inc()
        n = self.aggregator.add_spans(name, spans)
        if n:
            _fed_spans(name).inc(n)
        meta.update(ok=True, error=None,
                    last_scrape_at=(self._clock() if at is None
                                    else float(at)),
                    spans_collected=meta.get("spans_collected", 0)
                    + n)
        self._snaps[name] = snap

    def _scrape_router(self, at: Optional[float] = None) -> None:
        """The router's own process is always a source: its registry
        snapshot (which covers in-process replicas) and its local
        trace ring, read through the same incremental cursor."""
        store = tracing.get_store()
        since = self._cursors.get("router", 0)
        seq, recs = store.records_since(since)
        self._cursors["router"] = seq
        n = self.aggregator.add_spans(
            "router", [r.to_dict() for r in recs])
        if n:
            _fed_spans("router").inc(n)
        self._snaps["router"] = obs.snapshot()
        self._source_meta.setdefault("router", {}).update(
            ok=True, error=None,
            last_scrape_at=(self._clock() if at is None
                            else float(at)),
            spans_collected=self._source_meta.get(
                "router", {}).get("spans_collected", 0) + n)

    # -- per-replica skew stats ----------------------------------------------
    def _replica_stats(self) -> "Dict[str, dict]":
        """Per-replica window stats from the router's OWN dispatch
        accounting (`zoo_tpu_fleet_replica_latency_seconds{replica}`
        etc.) — the router measures dispatch-to-resolve for every
        replica, in-process or HTTP, so skew detection is uniform
        across transports."""
        cur = self._snaps.get("router") or {}
        prev = self._prev_snaps.get("router") or {}
        stats: "Dict[str, dict]" = {}
        pool = getattr(self.router, "pool", None)
        for r in getattr(pool, "replicas", ()):
            sel = {"replica": r.name}
            p99, events = _window_hist_stats(
                cur, prev, "zoo_tpu_fleet_replica_latency_seconds",
                sel)
            errs = (_counter_sum(
                cur, "zoo_tpu_fleet_replica_errors_total", sel)
                - _counter_sum(
                    prev, "zoo_tpu_fleet_replica_errors_total",
                    sel))
            attempts = events + max(errs, 0.0)
            stats[r.name] = {
                "p99_s": p99,
                "error_ratio": (max(errs, 0.0) / attempts
                                if attempts > 0 else None),
                "events": attempts,
            }
        return stats

    # -- the tick ------------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> dict:
        """One scrape/merge/publish/detect pass; thread-safe,
        idempotent, callable from the ticker thread, a debug route,
        or a test with an injected ``now``."""
        with self._lock:
            t = self._clock() if now is None else float(now)
            self._prev_snaps = dict(self._snaps)
            self._snaps = {}
            self._scrape_router(at=t)
            for name, url in self._http_sources():
                self._scrape_one(name, url, at=t)
            # carry forward the last good snapshot of a source that
            # failed this tick (stale beats absent for merged views)
            # — but record WHICH sources are stale, and publish each
            # source's true data age so staleness is never hidden
            carried = [name for name in self._prev_snaps
                       if name not in self._snaps]
            self._carried = carried
            for name, snap in self._prev_snaps.items():
                self._snaps.setdefault(name, snap)
            for name in self._snaps:
                at = self._source_meta.get(name, {}).get(
                    "last_scrape_at")
                if at is not None:
                    _fed_source_age(name).set(
                        round(max(t - at, 0.0), 3))
            merged, conflicts = merge_snapshots(self._snaps)
            self._merged, self._conflicts = merged, conflicts
            self.history.append(t, merged)
            self._ticks += 1
            self._last_tick_at = t
            _fed_sources_gauge().set(len(self._snaps))
            self._publish_summaries()
            stats = self._replica_stats()
            self._prev_replica_stats = stats
            if len(stats) >= 2:
                self.skew.observe(stats, now=t)
            return self.status()

    def _publish_summaries(self):
        """Fleet-level summary gauges over the last tick window —
        computed from per-source deltas then combined, so one
        process's restart (counter reset) cannot go negative. The
        federated SLO rules (`DEFAULT_FED_SLOS`) evaluate these."""
        p99s: "List[Tuple[float, float]]" = []  # (p99, events)
        errs = reqs = 0.0
        for name, cur in self._snaps.items():
            prev = self._prev_snaps.get(name) or {}
            p99, events = _window_hist_stats(
                cur, prev, "zoo_tpu_serving_request_seconds",
                {"path": "/predict"})
            if p99 is not None and events > 0:
                p99s.append((p99, events))
            errs += max(
                _counter_sum(cur, "zoo_tpu_serving_errors_total")
                - _counter_sum(prev,
                               "zoo_tpu_serving_errors_total"),
                0.0)
            reqs += max(
                _counter_sum(cur, "zoo_tpu_serving_requests_total")
                - _counter_sum(prev,
                               "zoo_tpu_serving_requests_total"),
                0.0)
        if p99s:
            # conservative fleet p99: the worst source's window p99
            # (bucket merging across sources is exact only on shared
            # bounds; max is both exact and the paging-relevant one)
            _fed_p99_gauge().set(max(p for p, _ in p99s))
        if reqs > 0:
            _fed_error_gauge().set(min(errs / reqs, 1.0))

    # -- exposition ----------------------------------------------------------
    def merged_snapshot(self) -> "Tuple[dict, List[dict]]":
        """Last merged snapshot + conflicts (tick first for a fresh
        one); empty before the first tick."""
        with self._lock:
            return (self._merged or {}), list(self._conflicts)

    def fleet_prometheus(self) -> str:
        """Prometheus text of the merged fleet view (HELP/TYPE
        deduplicated across sources)."""
        merged, _ = self.merged_snapshot()
        return render_prometheus(merged)

    def status(self) -> dict:
        """JSON-able collector state — the
        ``GET /debug/fleet/telemetry`` payload."""
        with self._lock:
            now = self._clock()
            sources = {}
            for name, meta in self._source_meta.items():
                at = meta.get("last_scrape_at")
                sources[name] = {
                    "ok": bool(meta.get("ok")),
                    "error": meta.get("error"),
                    "age_s": (round(now - at, 3)
                              if at is not None else None),
                    "carried_forward": name in self._carried,
                    "spans_collected": meta.get(
                        "spans_collected", 0),
                    "trace_cursor": self._cursors.get(name, 0),
                }
            return {
                "ticks": self._ticks,
                "tick_s": self.tick_s,
                "sources": sources,
                "history": self.history.stats(),
                "conflicts": list(self._conflicts),
                "replica_stats": dict(self._prev_replica_stats),
                "skew": dict(self.skew.last),
                "stitched_spans": len(self.aggregator),
            }

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "TelemetryCollector":
        """Start the background ticker (no thread when
        ``tick_s <= 0``). Idempotent."""
        if self.tick_s <= 0:
            return self
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop_evt = threading.Event()
            self._thread = threading.Thread(
                target=self._run, name="zoo-fed-collector",
                daemon=True)
            self._thread.start()
        return self

    def _run(self):
        while not self._stop_evt.wait(self.tick_s):
            try:
                self.tick()
            except Exception:
                pass  # the collector must outlive a bad scrape

    def stop(self):
        with self._lock:
            thread = self._thread
            self._thread = None
        self._stop_evt.set()
        if thread is not None:
            thread.join(timeout=5.0)
