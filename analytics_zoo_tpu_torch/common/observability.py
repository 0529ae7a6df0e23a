"""Telemetry core, trimmed (port of
``analytics_zoo_tpu/common/observability.py``).

What ``InferenceModel.predict`` and the generation batcher write:
labelled counters, gauges, fixed-bucket histograms and wall-time spans
in one process-global, thread-safe registry, read back with
:func:`snapshot`. The JAX package's Prometheus exposition, JSONL event
log and trace joining are not ported yet. Names follow
``zoo_tpu_<area>_<what>[_<unit>]``.

The generation metrics (``pipeline/inference/batching.py``):
``zoo_tpu_serving_gen_ttft_seconds`` (submit to first token),
``zoo_tpu_serving_gen_tokens_total``, ``zoo_tpu_serving_gen_steps_total``,
the gauges ``zoo_tpu_serving_gen_slots_active``,
``zoo_tpu_serving_gen_free_pages`` and
``zoo_tpu_serving_gen_queue_depth``, ``zoo_tpu_serving_errors_total``
(``kind="gen_queue_full"``) and the ``decode/admit``, ``decode/step``
and ``decode/retire`` spans.
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple

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


def _label_key(labels: Optional[Dict[str, Any]]
               ) -> "Tuple[Tuple[str, str], ...]":
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


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
        ``count``/``sum``."""
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
                else:
                    rec["value"] = m.value
                values.append(rec)
            out[fam.name] = {"type": fam.mtype, "help": fam.help,
                             "values": values}
        return out

    def reset(self):
        with self._lock:
            self._families.clear()


_REGISTRY = MetricsRegistry()


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


def reset_metrics():
    """Clear the process-global registry (test isolation)."""
    _REGISTRY.reset()


class Span:
    """Times a ``with`` block into the wall-time histogram
    ``zoo_tpu_<name>_seconds`` (``serving/predict`` →
    ``zoo_tpu_serving_predict_seconds``); ``elapsed`` holds the
    duration in seconds after exit. Exceptions pass through."""

    __slots__ = ("name", "elapsed", "_t0", "_registry")

    def __init__(self, name: str, registry: MetricsRegistry):
        self.name = name
        self.elapsed = 0.0
        self._t0 = 0.0
        self._registry = registry

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.elapsed = time.perf_counter() - self._t0
        self._registry.histogram(
            "zoo_tpu_" + _sanitize(self.name) + "_seconds",
            help=f"wall time of {self.name} spans").observe(self.elapsed)
        return False


def span(name: str, registry: Optional[MetricsRegistry] = None) -> Span:
    """``with span("serving/predict"): ...``"""
    return Span(name, registry or _REGISTRY)
