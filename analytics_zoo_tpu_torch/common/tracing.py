"""Context-propagated tracing (port of
``analytics_zoo_tpu/common/tracing.py``, which imports only the
standard library; this is the port's own copy).

:mod:`~analytics_zoo_tpu_torch.common.observability` answers "how long
do spans take in aggregate"; this module answers "what happened to THIS
request". A **trace** is a tree of timed spans sharing one
``trace_id``; the ambient (trace_id, span_id) pair lives in a
:class:`contextvars.ContextVar`, so nested ``with span(...)`` blocks
inherit it and each thread has its own.

- **ambient context**: :func:`trace` opens a root span and sets the
  context; every ``observability.span()`` entered underneath joins it
  as a child (:func:`span_start`/:func:`span_end`). Work handed to
  another thread (the batcher's dispatcher) captures :func:`current`
  at enqueue time and either re-enters it with :func:`activate` or
  records explicit child spans with :func:`record_span`.
- **ring-buffered store**: every finished span lands in a bounded
  :class:`TraceStore` (``ZOO_TPU_TRACE_BUFFER`` records, default 4096),
  served by the inference server's ``GET /debug/traces``.
- **Perfetto export**: :func:`to_chrome_trace` / :func:`chrome_events`
  render spans as chrome-trace JSON (``ph: "X"`` complete events, one
  process per trace) loadable at https://ui.perfetto.dev.

``ZOO_TPU_TRACE=0`` disables the whole layer: :func:`span_start`
returns ``None`` before touching the context var and :func:`trace`
yields a no-op handle, so the serving hot path skips all trace
bookkeeping (the spans' histograms are still kept). The reference's
event-log hook waits with the event log.
"""

from __future__ import annotations

import collections
import contextvars
import os
import re
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "TRACE_HEADER",
    "SpanRecord",
    "TraceStore",
    "Trace",
    "enabled",
    "new_trace_id",
    "sanitize_trace_id",
    "current",
    "trace",
    "activate",
    "record_span",
    "span_start",
    "span_end",
    "get_store",
    "reset_tracing",
    "chrome_events",
    "to_chrome_trace",
]

# HTTP header carrying the trace id across the serving front door.
TRACE_HEADER = "X-Zoo-Trace-Id"

# Wire-safe trace ids only: no header/log injection, bounded length.
_ID_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,64}$")


def enabled() -> bool:
    """Tracing is on unless ``ZOO_TPU_TRACE=0``."""
    return os.environ.get("ZOO_TPU_TRACE", "1") != "0"


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def _new_span_id() -> str:
    return uuid.uuid4().hex[:8]


def sanitize_trace_id(trace_id: Optional[str]) -> Optional[str]:
    """Return ``trace_id`` if it is wire-safe, else ``None`` (the
    caller then mints a fresh one — a hostile header never reaches
    a response header verbatim)."""
    if isinstance(trace_id, str) and _ID_RE.match(trace_id):
        return trace_id
    return None


class SpanRecord:
    """One finished span. ``t_start`` is epoch seconds (wall clock,
    so records from different threads line up); ``dur_s`` is a
    monotonic-clock duration."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name",
                 "t_start", "dur_s", "thread", "fields")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str, t_start: float,
                 dur_s: float, thread: str,
                 fields: Optional[Dict[str, Any]] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t_start = t_start
        self.dur_s = dur_s
        self.thread = thread
        self.fields = fields or {}

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t_start": round(self.t_start, 6),
            "dur_s": round(self.dur_s, 6),
            "thread": self.thread,
            "fields": dict(self.fields),
        }


class TraceStore:
    """Bounded, thread-safe ring buffer of :class:`SpanRecord`.
    Oldest records fall off; a trace whose spans outlive the buffer
    simply truncates — this is a flight recorder, not a database.

    Every record gets a monotonically increasing ``seq`` at insert,
    so collectors can scrape incrementally (:meth:`records_since`)
    without ever re-reading the ring: fetch with the last seq they
    saw, get only newer records plus the new cursor. Records that
    fall off the ring before a scrape are lost (flight-recorder
    semantics), never re-delivered twice."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get(
                    "ZOO_TPU_TRACE_BUFFER", "4096"))
            except ValueError:
                capacity = 4096
        self.capacity = max(1, capacity)
        self._buf: "collections.deque" = collections.deque(
            maxlen=self.capacity)  # (seq, SpanRecord)
        self._seq = 0
        self._lock = threading.Lock()

    def add(self, rec: SpanRecord):
        with self._lock:
            self._seq += 1
            self._buf.append((self._seq, rec))

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def latest_seq(self) -> int:
        """Seq of the most recently added record (0 when empty ever
        since construction — seqs never reset while the store
        lives)."""
        with self._lock:
            return self._seq

    def records(self) -> "List[SpanRecord]":
        with self._lock:
            return [rec for _seq, rec in self._buf]

    def records_since(self, since: int
                      ) -> "Tuple[int, List[SpanRecord]]":
        """``(cursor, records)``: every buffered record with
        ``seq > since``, oldest first, plus the cursor to pass next
        time. Cursor and records are taken under ONE lock, so a
        record added during the scrape has ``seq > cursor`` and is
        returned by the next call — zero loss, zero duplication (as
        long as it does not fall off the ring first)."""
        with self._lock:
            return self._seq, [rec for seq, rec in self._buf
                               if seq > since]

    def spans(self, trace_id: str) -> "List[SpanRecord]":
        """All buffered spans of one trace, oldest-start first."""
        return sorted((r for r in self.records()
                       if r.trace_id == trace_id),
                      key=lambda r: r.t_start)

    def recent(self, n: int = 20) -> "List[dict]":
        """The ``n`` most recently finished traces, newest first,
        each as ``{"trace_id", "t_start", "dur_s", "spans": [...]}``
        (``dur_s`` spans first start to last end)."""
        by_trace: "Dict[str, List[SpanRecord]]" = {}
        order: "List[str]" = []
        for rec in self.records():
            if rec.trace_id not in by_trace:
                by_trace[rec.trace_id] = []
            else:
                try:
                    order.remove(rec.trace_id)
                except ValueError:
                    pass
            by_trace[rec.trace_id].append(rec)
            order.append(rec.trace_id)
        out = []
        for tid in reversed(order[-max(0, n):] if n else []):
            recs = sorted(by_trace[tid], key=lambda r: r.t_start)
            t0 = recs[0].t_start
            t1 = max(r.t_start + r.dur_s for r in recs)
            out.append({"trace_id": tid,
                        "t_start": round(t0, 6),
                        "dur_s": round(t1 - t0, 6),
                        "n_spans": len(recs),
                        "spans": [r.to_dict() for r in recs]})
        return out

    def clear(self):
        with self._lock:
            self._buf.clear()


_STORE = TraceStore()


def get_store() -> TraceStore:
    return _STORE


def reset_tracing():
    """Drop all buffered spans (test isolation)."""
    _STORE.clear()


# Ambient (trace_id, span_id) of the innermost open span, or None.
_ctx: "contextvars.ContextVar[Optional[Tuple[str, str]]]" = (
    contextvars.ContextVar("zoo_tpu_trace", default=None))


def current() -> "Optional[Tuple[str, str]]":
    """The ambient ``(trace_id, span_id)`` pair, or ``None``. Capture
    this before handing work to another thread, then pass it to
    :func:`activate` or :func:`record_span` over there."""
    return _ctx.get()


class Trace:
    """Handle yielded by :func:`trace`. ``trace_id`` is ``None`` when
    tracing is disabled; :meth:`annotate` attaches fields to the root
    span record."""

    __slots__ = ("trace_id", "span_id", "fields")

    def __init__(self, trace_id: Optional[str],
                 span_id: Optional[str], fields: Dict[str, Any]):
        self.trace_id = trace_id
        self.span_id = span_id
        self.fields = fields

    def annotate(self, **fields):
        for k, v in fields.items():
            if v is not None:
                self.fields[k] = v


_NOOP = Trace(None, None, {})


@contextmanager
def trace(name: str = "trace", trace_id: Optional[str] = None,
          **fields):
    """Open a **root** span: mint (or adopt) a trace id, set the
    ambient context for the block, and record the span on exit. Yields
    a :class:`Trace`; no-op (``trace_id is None``) when disabled."""
    if not enabled():
        yield _NOOP
        return
    tid = sanitize_trace_id(trace_id) or new_trace_id()
    sid = _new_span_id()
    tok = _ctx.set((tid, sid))
    t0_wall = time.time()
    t0 = time.perf_counter()
    handle = Trace(tid, sid, dict(fields))
    try:
        yield handle
    finally:
        _ctx.reset(tok)
        rec = SpanRecord(tid, sid, None, name, t0_wall,
                         time.perf_counter() - t0,
                         threading.current_thread().name,
                         handle.fields)
        _STORE.add(rec)


@contextmanager
def activate(ctx: "Optional[Tuple[str, str]]"):
    """Re-enter a context captured with :func:`current` on another
    thread, so spans opened inside join that trace. No-op on None."""
    if ctx is None:
        yield
        return
    tok = _ctx.set(ctx)
    try:
        yield
    finally:
        _ctx.reset(tok)


def record_span(ctx: "Optional[Tuple[str, str]]", name: str,
                t_start: float, dur_s: float, **fields):
    """Record an already-timed child span of ``ctx`` (explicit
    cross-thread form — e.g. the batcher crediting queue wait back to
    the submitting request). ``t_start`` is epoch seconds. No-op when
    ``ctx`` is None or tracing is disabled."""
    if ctx is None or not enabled():
        return
    tid, parent = ctx
    rec = SpanRecord(tid, _new_span_id(), parent, name, t_start,
                     dur_s, threading.current_thread().name, fields)
    _STORE.add(rec)


def span_start(name: str):
    """Called by ``observability.Span.__enter__``: join the ambient
    trace as a child span. Returns an opaque token for
    :func:`span_end`, or **None** (the hot-path fast exit) when
    tracing is disabled or no trace is open."""
    if not enabled():
        return None
    cur = _ctx.get()
    if cur is None:
        return None
    tid, parent = cur
    sid = _new_span_id()
    tok = _ctx.set((tid, sid))
    return (tok, tid, sid, parent, time.time())


def span_end(token, name: str, dur_s: float,
             fields: Optional[Dict[str, Any]] = None):
    """Close a span opened by :func:`span_start` (token must be
    non-None) and buffer its record."""
    tok, tid, sid, parent, t0_wall = token
    try:
        _ctx.reset(tok)
    except ValueError:
        pass  # exited in a different context; record anyway
    _STORE.add(SpanRecord(tid, sid, parent, name, t0_wall, dur_s,
                          threading.current_thread().name,
                          dict(fields or {})))


# ---------------------------------------------------------------------------
# Perfetto / chrome-trace export
# ---------------------------------------------------------------------------

def _get(rec, key, default=None):
    if isinstance(rec, SpanRecord):
        return getattr(rec, key, default)
    return rec.get(key, default)


def chrome_events(records, source_lanes: bool = False
                  ) -> "List[dict]":
    """Render span records (:class:`SpanRecord` or plain dicts with
    the same keys) as chrome-trace
    events: one ``ph: "X"`` complete event per span, one *process*
    per trace id, one *thread* per source thread, plus ``ph: "M"``
    metadata naming both.

    ``source_lanes=True`` assigns the process lane per the record's
    ``source`` field instead (the process that recorded it), so a
    cross-process trace renders each process as its own Perfetto
    track group; a record without one lands in the ``"router"`` lane
    (``GET /debug/trace/<id>?chrome=1`` renders the local ring so)."""
    pids: "Dict[str, int]" = {}
    tids: "Dict[Tuple[int, str], int]" = {}
    events: "List[dict]" = []
    for rec in records:
        dur = _get(rec, "dur_s")
        tid_str = _get(rec, "trace_id")
        if dur is None or tid_str is None:
            continue
        t_start = _get(rec, "t_start")
        if t_start is None:
            ts = _get(rec, "ts")  # records that stamp their exit time
            if ts is None:
                continue
            t_start = float(ts) - float(dur)
        if source_lanes:
            lane = str(_get(rec, "source", None) or "router")
            lane_name = f"process {lane}"
        else:
            lane = tid_str
            lane_name = f"trace {tid_str}"
        if lane not in pids:
            pids[lane] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[lane], "tid": 0,
                           "args": {"name": lane_name}})
        pid = pids[lane]
        thread = _get(rec, "thread", "main") or "main"
        tkey = (pid, thread)
        if tkey not in tids:
            tids[tkey] = len([k for k in tids if k[0] == pid]) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": tids[tkey],
                           "args": {"name": thread}})
        args = {"trace_id": tid_str,
                "span_id": _get(rec, "span_id"),
                "parent_id": _get(rec, "parent_id")}
        fields = _get(rec, "fields")
        if isinstance(fields, dict):
            args.update(fields)
        events.append({
            "name": _get(rec, "name") or _get(rec, "event", "span"),
            "ph": "X",
            "ts": round(float(t_start) * 1e6, 3),
            "dur": round(float(dur) * 1e6, 3),
            "pid": pid,
            "tid": tids[tkey],
            "args": {k: v for k, v in args.items() if v is not None},
        })
    return events


def to_chrome_trace(trace_ids=None) -> dict:
    """Chrome-trace JSON object for the buffered spans (optionally
    restricted to ``trace_ids``), loadable by Perfetto."""
    recs = _STORE.records()
    if trace_ids is not None:
        wanted = set(trace_ids)
        recs = [r for r in recs if r.trace_id in wanted]
    return {"traceEvents": chrome_events(recs),
            "displayTimeUnit": "ms"}
