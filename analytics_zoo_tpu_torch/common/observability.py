"""Telemetry core (port of ``analytics_zoo_tpu/common/observability.py``).

Labelled counters, gauges, fixed-bucket histograms and wall-time spans
in one process-global, thread-safe registry, read back with
:func:`snapshot` (JSON-able) or :func:`to_prometheus` (Prometheus text
format 0.0.4, the inference server's ``GET /metrics``). A span opened
while a trace is ambient (:mod:`~analytics_zoo_tpu_torch.common.tracing`)
also joins that trace as a child; its keyword fields go to the trace
record, never to metric labels. Names follow
``zoo_tpu_<area>_<what>[_<unit>]``.

The serving front end's metrics (``pipeline/inference/serving.py`` and
the ``DynamicBatcher``): ``zoo_tpu_serving_requests_total{path,status}``,
``zoo_tpu_serving_request_seconds{path}``, ``zoo_tpu_serving_in_flight``,
``zoo_tpu_serving_queue_depth``, ``zoo_tpu_serving_warmed_buckets``,
``zoo_tpu_serving_queue_wait_seconds``, ``zoo_tpu_serving_batch_size``,
``zoo_tpu_serving_batch_fill_ratio``,
``zoo_tpu_serving_padding_rows_total``,
``zoo_tpu_serving_batch_executions_total{bucket}``,
``zoo_tpu_serving_bucket_compiles_total``,
``zoo_tpu_serving_errors_total{kind}`` and the ``serving/predict``,
``serving/pad`` and ``serving/bucket_warm`` spans.

The generation metrics (``pipeline/inference/batching.py``):
``zoo_tpu_serving_gen_ttft_seconds`` (submit to first token),
``zoo_tpu_serving_gen_tokens_total``, ``zoo_tpu_serving_gen_steps_total``,
the gauges ``zoo_tpu_serving_gen_slots_active``,
``zoo_tpu_serving_gen_free_pages`` and
``zoo_tpu_serving_gen_queue_depth``, ``zoo_tpu_serving_errors_total``
(``kind="gen_queue_full"``) and the ``decode/admit``, ``decode/step``
and ``decode/retire`` spans. Under the engine's levers:
``zoo_tpu_serving_gen_prefill_chunks_total``,
``zoo_tpu_serving_gen_spec_proposed_total`` and ``_spec_accepted_total``,
``zoo_tpu_serving_gen_handoffs_total{direction}``,
``zoo_tpu_serving_gen_handoff_seconds`` (blob enqueue to pages spliced),
``zoo_tpu_serving_gen_handoff_pages_leaked`` (the drain audit; 0 in a
correct flow) and the ``decode/prefill_chunk``, ``decode/spec_step``,
``decode/handoff_export`` and ``decode/handoff_admit`` spans, each also
recorded on the trace of every request it served.

Fault injection (``common/faults.py``):
``zoo_tpu_faults_injected_total{point,kind}``.

Structured events (:func:`event`) append one JSON line each to the file
``ZOO_TPU_EVENT_LOG`` names (nothing when it is unset): the
``diagnostics/anomaly``, ``perf/goodput_epoch``, ``faults/armed``,
``faults/injected`` and ``slo/recovered`` events. With
``ZOO_TPU_EVENT_LOG_MAX_MB`` set the file rotates by size into
``ZOO_TPU_EVENT_LOG_KEEP`` (default 3) gzipped segments ``<path>.N.gz``
(``ZOO_TPU_EVENT_LOG_GZIP=0``: raw ``<path>.N``), counted in
``zoo_tpu_event_log_rotations_total``; ``zoo_tpu_event_log_bytes`` is
the live and rotated bytes on disk, which the capacity forecaster's
``event_log`` resource reads.
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple

from analytics_zoo_tpu_torch.common import tracing as _tracing

DEFAULT_BUCKETS: "Tuple[float, ...]" = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

# power-of-two buckets for batch sizes / record counts
SIZE_BUCKETS: "Tuple[float, ...]" = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096, 16384)

_NAME_SUB = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    name = _NAME_SUB.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats print as ints."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _escape_label(v: Any) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_key(labels: Optional[Dict[str, Any]]
               ) -> "Tuple[Tuple[str, str], ...]":
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: "Tuple[Tuple[str, str], ...]") -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
    return "{" + inner + "}"


def bucket_quantile(buckets: "Sequence[float]",
                    counts: "Sequence[float]", q: float) -> float:
    """Prometheus-style quantile estimate from per-bucket counts.

    ``buckets`` are the finite upper bounds (ascending); ``counts`` are
    per-bucket (not cumulative) observation counts with one trailing
    entry for the ``+Inf`` bucket. Linear interpolation inside the
    winning bucket, a lower edge of 0 for the first bucket and, like
    Prometheus ``histogram_quantile``, the highest finite bound when the
    rank lands in the overflow bucket. NaN when there are no
    observations."""
    if len(counts) != len(buckets) + 1:
        raise ValueError("counts must be per-bucket plus overflow")
    total = float(sum(counts))
    if total <= 0:
        return float("nan")
    q = min(max(float(q), 0.0), 1.0)
    rank = q * total
    acc = 0.0
    for i, hi in enumerate(buckets):
        prev = acc
        acc += counts[i]
        if acc >= rank:
            if counts[i] <= 0:
                return float(hi)
            lo = float(buckets[i - 1]) if i > 0 else 0.0
            frac = (rank - prev) / counts[i]
            return lo + (float(hi) - lo) * min(max(frac, 0.0), 1.0)
    return float(buckets[-1])  # rank fell in the +Inf bucket


class Counter:
    """Monotonic counter (one labelled child of a family)."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram (``le`` inclusive, like Prometheus)."""

    __slots__ = ("buckets", "_counts", "_sum", "_lock")

    def __init__(self, buckets: "Sequence[float]" = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float):
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> "list[tuple[str, int]]":
        """[(le_str, cumulative_count), ..., ("+Inf", total)]."""
        with self._lock:
            counts = list(self._counts)
        out, acc = [], 0
        for b, c in zip(self.buckets, counts):
            acc += c
            out.append((_fmt(b), acc))
        out.append(("+Inf", acc + counts[-1]))
        return out

    def quantile(self, q: float) -> float:
        """The q-quantile (0 <= q <= 1) estimated from the bucket
        counts (:func:`bucket_quantile`); NaN when empty."""
        with self._lock:
            counts = list(self._counts)
        return bucket_quantile(self.buckets, counts, q)


class _Family:
    __slots__ = ("name", "mtype", "help", "buckets", "children", "_lock")

    def __init__(self, name: str, mtype: str, help_: str,
                 buckets: "Optional[Sequence[float]]" = None):
        self.name = name
        self.mtype = mtype
        self.help = help_
        self.buckets = buckets
        self.children: "Dict[tuple, Any]" = {}
        self._lock = threading.Lock()

    def child(self, labels: Optional[Dict[str, Any]]):
        key = _label_key(labels)
        with self._lock:
            m = self.children.get(key)
            if m is None:
                m = (Counter() if self.mtype == "counter" else
                     Gauge() if self.mtype == "gauge" else
                     Histogram(self.buckets or DEFAULT_BUCKETS))
                self.children[key] = m
            return m


class MetricsRegistry:
    """Thread-safe registry of metric families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: "Dict[str, _Family]" = {}

    def _family(self, name: str, mtype: str, help_: str,
                buckets: "Optional[Sequence[float]]" = None) -> _Family:
        name = _sanitize(name)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, mtype, help_, buckets)
                self._families[name] = fam
            elif fam.mtype != mtype:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{fam.mtype}, not {mtype}")
            return fam

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, Any]] = None) -> Counter:
        return self._family(name, "counter", help).child(labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, Any]] = None) -> Gauge:
        return self._family(name, "gauge", help).child(labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, Any]] = None,
                  buckets: "Optional[Sequence[float]]" = None
                  ) -> Histogram:
        return self._family(name, "histogram", help,
                            buckets).child(labels)

    def snapshot(self) -> dict:
        """JSON-able dump: ``{name: {"type", "help", "values": [...]}}``
        with a counter's or gauge's ``value`` or a histogram's
        ``count``, ``sum`` and cumulative ``buckets``."""
        out: "Dict[str, dict]" = {}
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            with fam._lock:
                items = sorted(fam.children.items())
            values = []
            for key, m in items:
                rec: "Dict[str, Any]" = {"labels": dict(key)}
                if fam.mtype == "histogram":
                    rec["count"] = m.count
                    rec["sum"] = m.sum
                    rec["buckets"] = dict(m.cumulative())
                else:
                    rec["value"] = m.value
                values.append(rec)
            out[fam.name] = {"type": fam.mtype, "help": fam.help,
                             "values": values}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: "list[str]" = []
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.mtype}")
            with fam._lock:
                items = sorted(fam.children.items())
            for key, m in items:
                ls = _label_str(key)
                if fam.mtype == "histogram":
                    for le, cum in m.cumulative():
                        bl = _label_str(key + (("le", le),))
                        lines.append(f"{fam.name}_bucket{bl} {cum}")
                    lines.append(f"{fam.name}_sum{ls} {_fmt(m.sum)}")
                    lines.append(f"{fam.name}_count{ls} {m.count}")
                else:
                    lines.append(f"{fam.name}{ls} {_fmt(m.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self):
        with self._lock:
            self._families.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str, help: str = "",
            labels: Optional[Dict[str, Any]] = None) -> Counter:
    return _REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "",
          labels: Optional[Dict[str, Any]] = None) -> Gauge:
    return _REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "",
              labels: Optional[Dict[str, Any]] = None,
              buckets: "Optional[Sequence[float]]" = None) -> Histogram:
    return _REGISTRY.histogram(name, help, labels, buckets)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def to_prometheus() -> str:
    return _REGISTRY.to_prometheus()


_event_lock = threading.Lock()
_event_path: Optional[str] = None
_event_fh = None
_rotated_bytes = 0  # on-disk size of the rotated segments


def _event_log_keep() -> int:
    try:
        return int(os.environ.get("ZOO_TPU_EVENT_LOG_KEEP", "3"))
    except ValueError:
        return 3


def _gzip_segment(path: str) -> None:
    """Compress a freshly rotated segment (``path`` → ``path.gz``). On
    failure the raw segment stays and the partial ``.gz`` goes."""
    try:
        with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.remove(path)
    except OSError:
        try:
            os.remove(path + ".gz")
        except OSError:
            pass


def _scan_rotated_bytes() -> int:
    """On-disk size of the rotated segments (``.N.gz`` and the legacy
    raw ``.N``) inside the keep window."""
    if not _event_path:
        return 0
    total = 0
    for i in range(1, _event_log_keep() + 1):
        for ext in (".gz", ""):
            try:
                total += os.path.getsize(f"{_event_path}.{i}{ext}")
            except OSError:
                pass
    return total


def _rotate_locked() -> None:
    """Size-based rotation: once the live file has reached
    ``ZOO_TPU_EVENT_LOG_MAX_MB``, shift ``path.1 → path.2 → ...``
    (keeping ``ZOO_TPU_EVENT_LOG_KEEP`` rotated files, default 3), gzip
    the fresh ``path.1`` (``ZOO_TPU_EVENT_LOG_GZIP=0`` keeps it raw) and
    reopen an empty ``path``. Each rotation counts in
    ``zoo_tpu_event_log_rotations_total``. Called with ``_event_lock``
    held, before a line is written, so no line is split or doubled
    across the rename."""
    global _event_fh, _rotated_bytes
    raw = os.environ.get("ZOO_TPU_EVENT_LOG_MAX_MB")
    if not raw or _event_fh is None:
        return
    try:
        max_bytes = float(raw) * 1024 * 1024
    except ValueError:
        return
    if max_bytes <= 0:
        return
    try:
        if _event_fh.tell() < max_bytes:
            return
        _event_fh.close()
    except (OSError, ValueError):
        return
    keep = _event_log_keep()
    rotated = False
    try:
        for i in range(max(keep - 1, 0), 0, -1):
            for ext in (".gz", ""):
                src = f"{_event_path}.{i}{ext}"
                if os.path.exists(src):
                    os.replace(src, f"{_event_path}.{i + 1}{ext}")
        if keep >= 1:
            os.replace(_event_path, _event_path + ".1")
            rotated = True
            if os.environ.get("ZOO_TPU_EVENT_LOG_GZIP", "1") != "0":
                _gzip_segment(_event_path + ".1")
        else:
            os.remove(_event_path)
            rotated = True
    except OSError:
        pass  # rotation is best effort; logging goes on
    _event_fh = open(_event_path, "a", encoding="utf-8")
    _rotated_bytes = _scan_rotated_bytes()
    if rotated:
        counter("zoo_tpu_event_log_rotations_total",
                help="event-log segment rotations").inc()


def _close_event_log() -> None:
    global _event_path, _event_fh, _rotated_bytes
    if _event_fh is not None:
        try:
            _event_fh.close()
        except OSError:
            pass
    _event_fh = None
    _event_path = None
    _rotated_bytes = 0


def event(name: str, **fields) -> None:
    """Append one structured JSON line ``{"ts", "event", **fields}`` to
    the ``ZOO_TPU_EVENT_LOG`` file (read on every call; nothing when it
    is unset), rotating it first when it has outgrown
    ``ZOO_TPU_EVENT_LOG_MAX_MB``. Values JSON cannot hold are written as
    strings. ``zoo_tpu_event_log_bytes`` then holds the live file's and
    the rotated segments' bytes on disk."""
    global _event_path, _event_fh, _rotated_bytes
    path = os.environ.get("ZOO_TPU_EVENT_LOG")
    if not path:
        return
    rec = {"ts": round(time.time(), 6), "event": name}
    rec.update(fields)
    try:
        line = json.dumps(rec)
    except (TypeError, ValueError):
        line = json.dumps({k: (v if isinstance(
            v, (int, float, str, bool, type(None))) else str(v))
            for k, v in rec.items()})
    with _event_lock:
        if path != _event_path:
            _close_event_log()
            _event_fh = open(path, "a", encoding="utf-8")
            _event_path = path
            _rotated_bytes = _scan_rotated_bytes()
        _rotate_locked()
        _event_fh.write(line + "\n")
        _event_fh.flush()
        try:
            gauge("zoo_tpu_event_log_bytes",
                  help="event-log bytes on disk (live segment + "
                       "rotated)").set(_event_fh.tell() + _rotated_bytes)
        except (OSError, ValueError):
            pass


def reset_metrics():
    """Clear the process-global registry and release the event log's
    file (test isolation)."""
    _REGISTRY.reset()
    with _event_lock:
        _close_event_log()


class Span:
    """Times a ``with`` block into the wall-time histogram
    ``zoo_tpu_<name>_seconds`` (``serving/predict`` →
    ``zoo_tpu_serving_predict_seconds``); ``elapsed`` holds the
    duration in seconds after exit. Exceptions pass through. When a
    trace is ambient the span also joins it as a child, recorded with
    ``fields`` (which never become metric labels)."""

    __slots__ = ("name", "fields", "elapsed", "_t0", "_registry",
                 "_trace_tok")

    def __init__(self, name: str, registry: MetricsRegistry,
                 fields: Dict[str, Any]):
        self.name = name
        self.fields = fields
        self.elapsed = 0.0
        self._t0 = 0.0
        self._registry = registry
        self._trace_tok = None

    def __enter__(self) -> "Span":
        self._trace_tok = _tracing.span_start(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.elapsed = time.perf_counter() - self._t0
        self._registry.histogram(
            "zoo_tpu_" + _sanitize(self.name) + "_seconds",
            help=f"wall time of {self.name} spans").observe(self.elapsed)
        if self._trace_tok is not None:
            _tracing.span_end(self._trace_tok, self.name, self.elapsed,
                              self.fields)
        return False


def span(name: str, registry: Optional[MetricsRegistry] = None,
         **fields) -> Span:
    """``with span("serving/pad", rows=3): ...``"""
    return Span(name, registry or _REGISTRY, fields)
