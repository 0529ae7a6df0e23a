"""Request batching for serving (port of
``analytics_zoo_tpu/pipeline/inference/batching.py``): the
``DynamicBatcher`` in front of ``/predict`` and the ``ContinuousBatcher``
in front of ``/generate``.

**DynamicBatcher.** One request per forward starves the card at batch 1
(Clipper, NSDI'17). Requests land in a bounded queue; one dispatcher
thread drains up to ``max_batch_size`` rows or until ``max_wait_ms``
expires, pads the coalesced batch with zero rows up to the next size of
a bucket ladder (powers of two by default), runs one forward per bucket
and scatters the un-padded rows back to the requests' futures. A full
queue rejects at once (:class:`QueueFullError` → HTTP 503 +
``Retry-After``), and requests past their deadline are evicted before
dispatch (:class:`DeadlineExpiredError` → HTTP 504).

Where the reference AOT-compiles one executable per (signature,
bucket), the port keeps one callable per (signature, bucket)
(``InferenceModel.lower_for``). :meth:`DynamicBatcher.start` runs every
bucket once on the dispatcher's own thread, under
``torch.inference_mode``, before the first request, so kernel builds,
cuDNN's algorithm choice and the caching allocator's blocks all happen
in warm-up; a model reload (its ``generation`` counter) clears them. A
warm-up failure raises: there is no unpadded fallback for a signature
the model cannot run. The fault point ``batcher/dispatch``
(``common/faults.py``) fires at the head of every batch execution; a
fault fails that batch and the dispatcher goes on. The warm-up runs
inside ``diagnostics.expected_compiles``; a bucket callable made after
it is a ``serving/bucket_compile`` the recompile monitor watches.

Configuration: constructor kwargs override the environment,
``ZOO_TPU_SERVING_BATCH`` (``0`` reverts the servers to per-request
serving), ``ZOO_TPU_SERVING_MAX_BATCH`` (32),
``ZOO_TPU_SERVING_MAX_WAIT_MS`` (5), ``ZOO_TPU_SERVING_QUEUE_DEPTH``
(256), ``ZOO_TPU_SERVING_DEADLINE_MS`` (0: none) and
``ZOO_TPU_SERVING_BUCKETS`` (a comma-separated ladder).

Correctness contract: the served forward is row-wise in eval mode (row
*i* of the output depends only on row *i* of the input), as every model
the zoo serves is (BatchNorm folds its moving statistics). Padding rows
are zeros and are sliced off before the scatter.

**ContinuousBatcher.** Generation requests run for a variable number of
steps, so batching whole requests would hold every sequence hostage to
the longest one (ORCA, OSDI'22). Instead one decode step runs
continuously over a fixed slot array (``generation.GenerationEngine``)
and this batcher reschedules between steps: finished sequences retire
(pages reclaimed, future resolved) and queued ones are admitted into the
freed slots by a bucket-padded prefill, while their neighbours keep
decoding. Client threads call :meth:`ContinuousBatcher.submit`; one
loop thread drives admit → step → retire. Admission is gated on a free
slot and a full worst-case page reservation, so an admitted sequence
always runs to completion. ``ZOO_TPU_GEN_QUEUE_DEPTH`` bounds the wait
queue (default 64; full → :class:`QueueFullError`),
``ZOO_TPU_GEN_MAX_NEW`` caps a request's decode budget (default 256).
Under the engine's levers the loop also writes one prompt chunk per
iteration for prompts longer than a chunk (short prompts keep the bucket
prefill), runs a speculative round for the slots whose k-token window
fits their reservation and plain steps for the rest, and in the
disaggregated roles resolves :meth:`ContinuousBatcher.submit_prefill`
with a handoff blob at the first token and admits blobs from
:meth:`ContinuousBatcher.submit_handoff` with no prefill.

Telemetry: ``common/observability.py`` lists the metrics and spans.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common import diagnostics
from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.common import observability as obs
from analytics_zoo_tpu_torch.common import tracing
from analytics_zoo_tpu_torch.common.nncontext import logger

__all__ = ["DynamicBatcher", "ContinuousBatcher", "QueueFullError",
           "DeadlineExpiredError", "bucket_ladder"]

# fill-ratio histogram buckets: rows / bucket capacity in (0, 1]
_FILL_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)

# chaos hook (common/faults.py): fires at the head of every batch
# execution, on the dispatcher thread
_DISPATCH_FAULT = faults.point("batcher/dispatch")


def _fail_entry(entry, exc):
    """Fail one entry's future without raising into the loop thread (a
    future a client cancelled refuses ``set_exception``)."""
    try:
        if not entry.future.done():
            entry.future.set_exception(exc)
    except Exception:  # cancelled or resolved between check and set
        pass


class QueueFullError(Exception):
    """Admission rejected: the queue is at capacity. ``retry_after_s``
    estimates when capacity frees up."""

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(
            f"serving queue full ({depth} requests waiting); "
            f"retry in ~{retry_after_s:.2f}s")
        self.retry_after_s = retry_after_s


class DeadlineExpiredError(Exception):
    """The request's deadline elapsed while it waited in the queue."""


def bucket_ladder(max_batch: int,
                  override: Optional[Sequence[int]] = None
                  ) -> "Tuple[int, ...]":
    """The batch sizes the batcher warms and pads to: powers of two up
    to ``max_batch`` (``max_batch`` appended when it is not one), or a
    validated, sorted copy of ``override`` (ValueError when it is empty
    or holds a size below 1). The generation engine pads prompts to the
    default ladder."""
    if override is not None:
        ladder = sorted({int(b) for b in override})
        if not ladder or ladder[0] < 1:
            raise ValueError(f"invalid bucket ladder: {override!r}")
        return tuple(ladder)
    ladder = []
    b = 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return tuple(ladder)


class _Entry:
    """One queued request: input arrays, row count, signature,
    completion future, the two clocks (enqueue time, absolute
    deadline) and, when the submitting thread had an open trace, its
    captured context, so the dispatcher can credit queue wait, execute
    and scatter back to the request's trace."""

    __slots__ = ("xs", "n", "sig", "future", "t_enq", "deadline",
                 "trace", "t_enq_wall")

    def __init__(self, xs, n, sig, deadline):
        self.xs = xs
        self.n = n
        self.sig = sig
        self.future: "Future" = Future()
        self.t_enq = time.monotonic()
        self.deadline = deadline  # absolute monotonic, or None
        self.trace = tracing.current()  # None when untraced
        self.t_enq_wall = time.time() if self.trace else 0.0


def _signature(xs) -> tuple:
    """Coalescing key: per-input (row shape, dtype). Requests merge only
    when every input position agrees on both."""
    return tuple((tuple(x.shape[1:]), str(x.dtype)) for x in xs)


class DynamicBatcher:
    """Cross-request micro-batching between the HTTP front end and an
    :class:`~analytics_zoo_tpu_torch.pipeline.inference.InferenceModel`
    (the module docstring has the design).

    Any number of handler threads call :meth:`submit`; one dispatcher
    thread drains, pads, executes and scatters, so the card runs one
    bucket at a time and the model's slot pool is not used by the
    batched path.
    """

    def __init__(self, model, *,
                 max_batch_size: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 buckets: Optional[Sequence[int]] = None,
                 labels: Optional[dict] = None):
        env = os.environ
        if max_batch_size is None:
            max_batch_size = int(env.get("ZOO_TPU_SERVING_MAX_BATCH", 32))
        if max_wait_ms is None:
            max_wait_ms = float(env.get("ZOO_TPU_SERVING_MAX_WAIT_MS", 5))
        if queue_depth is None:
            queue_depth = int(env.get("ZOO_TPU_SERVING_QUEUE_DEPTH", 256))
        if deadline_ms is None:
            deadline_ms = float(env.get("ZOO_TPU_SERVING_DEADLINE_MS", 0))
        if buckets is None and env.get("ZOO_TPU_SERVING_BUCKETS"):
            buckets = [int(b) for b in
                       env["ZOO_TPU_SERVING_BUCKETS"].split(",")]
        self.model = model
        self.buckets = bucket_ladder(int(max_batch_size), buckets)
        self.max_batch = self.buckets[-1]
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.queue_depth = int(queue_depth)
        self.deadline_s = (float(deadline_ms) / 1e3 if deadline_ms
                           else None)

        self._q: "deque[_Entry]" = deque()
        self._cond = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # (signature, bucket) -> bucket callable; cleared when the
        # model swaps generations (reload)
        self._compiled: dict = {}
        self._compile_lock = threading.Lock()
        self._model_gen = getattr(model, "generation", 0)
        # metric labels: a fleet tags each replica's batcher with
        # {"replica": name}, so the gauges stay per queue
        self._labels = dict(labels) if labels else None
        self._ema_batch_s = 0.01  # retry-after estimator seed
        # touch the gauges so /metrics carries them from the start
        self._depth_gauge().set(0)
        self._warmed_gauge().set(0)

    # -- factory ------------------------------------------------------------
    @classmethod
    def from_env(cls, model) -> "Optional[DynamicBatcher]":
        """The servers' default construction: a batcher with
        environment settings, or ``None`` when ``ZOO_TPU_SERVING_BATCH=0``
        reverts to per-request serving."""
        if os.environ.get("ZOO_TPU_SERVING_BATCH", "1") == "0":
            return None
        return cls(model)

    # -- metrics handles ----------------------------------------------------
    def _depth_gauge(self):
        return obs.gauge("zoo_tpu_serving_queue_depth",
                         help="requests waiting in the batcher queue",
                         labels=self._labels)

    def _warmed_gauge(self):
        return obs.gauge("zoo_tpu_serving_warmed_buckets",
                         help="bucket executables compiled and ready",
                         labels=self._labels)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "DynamicBatcher":
        """Start the dispatcher thread, which first warms every bucket
        of the model's declared signature (:meth:`warm`) and then
        serves; returns once warm-up is done and raises what it raised.
        Idempotent."""
        if self._thread is not None and self._thread.is_alive():
            return self
        with self._cond:
            self._depth_gauge().set(len(self._q))
        self._warmed_gauge().set(self.warmed_buckets)
        self._stop = False
        warmed = threading.Event()
        failed: list = []
        diagnostics.install_recompile_monitor()

        def dispatcher():
            try:
                # the warm-up's callables are expected compiles; a
                # callable made later for a new signature is watched
                with diagnostics.expected_compiles():
                    self.warm()
            except Exception as e:  # re-raised by start()
                failed.append(e)
                return
            finally:
                warmed.set()
            self._run()

        self._thread = threading.Thread(
            target=dispatcher, name="zoo-tpu-batcher", daemon=True)
        self._thread.start()
        warmed.wait()
        if failed:
            self._thread.join()
            self._thread = None
            raise failed[0]
        return self

    def stop(self, timeout: float = 30.0):
        """Drain the queue (pending entries execute or expire), then
        stop the dispatcher."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def warm(self) -> int:
        """Make and run every bucket callable of the model's declared
        example-input signature, on the calling thread (the dispatcher's,
        from :meth:`start`). Returns the number of buckets warmed; 0 when
        the model declared no signature (a signature is then warmed on
        its first request) or cannot build bucket callables."""
        specs = getattr(self.model, "example_input_specs", None)
        if not specs or not getattr(self.model, "can_relower", False):
            return 0
        sig = tuple((tuple(shape[1:]), str(np.dtype(dt)))
                    for shape, dt in specs)
        return self._warm_signature(sig)

    # -- admission ----------------------------------------------------------
    def batchable(self, xs: "Sequence[np.ndarray]") -> bool:
        """Whether these inputs can ride the coalescing path: every
        input has a leading (row) dimension and all agree on it."""
        if not xs:
            return False
        if any(x.ndim < 1 for x in xs):
            return False
        n = xs[0].shape[0]
        return n >= 1 and all(x.shape[0] == n for x in xs)

    def submit(self, xs: "Sequence[np.ndarray]") -> "Future":
        """Enqueue one request (a list of row-aligned host arrays).
        Returns a future resolving to what ``model.predict`` returns for
        these inputs (one array, or a list for a multi-output model).
        Raises :class:`QueueFullError` when the queue is at capacity."""
        xs = [np.asarray(x) for x in xs]
        if not self.batchable(xs):
            raise ValueError(
                "inputs are not row-aligned (every input needs the "
                "same leading dimension >= 1)")
        n = xs[0].shape[0]
        deadline = (time.monotonic() + self.deadline_s
                    if self.deadline_s else None)
        entry = _Entry(xs, n, _signature(xs), deadline)
        with self._cond:
            if len(self._q) >= self.queue_depth:
                # ~time for the backlog to drain at the current rate
                retry = max(0.05, len(self._q) * self._ema_batch_s
                            * max(1.0, n / self.max_batch))
                obs.counter("zoo_tpu_serving_errors_total",
                            help="serving errors by kind",
                            labels={"kind": "queue_full"}).inc()
                raise QueueFullError(len(self._q), retry)
            self._q.append(entry)
            self._depth_gauge().set(len(self._q))
            self._cond.notify_all()
        return entry.future

    # -- dispatcher ---------------------------------------------------------
    def _evict_expired_locked(self):
        if self.deadline_s is None or not self._q:
            return
        now = time.monotonic()
        kept = deque()
        for e in self._q:
            if e.deadline is not None and e.deadline < now:
                obs.counter("zoo_tpu_serving_errors_total",
                            help="serving errors by kind",
                            labels={"kind": "deadline_expired"}).inc()
                _fail_entry(e, DeadlineExpiredError(
                    f"request waited past its "
                    f"{self.deadline_s * 1e3:.0f}ms deadline"))
            else:
                kept.append(e)
        if len(kept) != len(self._q):
            self._q = kept
            self._depth_gauge().set(len(self._q))

    def _ready_rows_locked(self) -> int:
        """Row count of the maximal coalescible prefix (the head's
        signature, cumulative rows <= max_batch)."""
        rows = 0
        sig = self._q[0].sig
        for e in self._q:
            if e.sig != sig or (rows and rows + e.n > self.max_batch):
                break
            rows += e.n
        return rows

    def _take_batch_locked(self) -> "list[_Entry]":
        batch: "list[_Entry]" = []
        rows = 0
        while self._q:
            e = self._q[0]
            if batch and (e.sig != batch[0].sig
                          or rows + e.n > self.max_batch):
                break
            batch.append(self._q.popleft())
            rows += e.n
            if rows >= self.max_batch:
                break
        self._depth_gauge().set(len(self._q))
        return batch

    def _run(self):
        # nothing that goes wrong with one batch (pad, scatter, the
        # forward, the queue bookkeeping) may escape this loop: it would
        # end the one dispatcher thread and every later submit would
        # wait forever. Each iteration fails at most its own batch.
        while True:
            batch: "list[_Entry]" = []
            try:
                with self._cond:
                    while not self._q and not self._stop:
                        self._cond.wait(timeout=0.1)
                    if not self._q:
                        if self._stop:
                            return
                        continue
                    self._evict_expired_locked()
                    if not self._q:
                        continue
                    # the coalescing window is anchored at the head's
                    # arrival: the oldest request never waits past
                    # max_wait_ms
                    wait_until = self._q[0].t_enq + self.max_wait_s
                    while (not self._stop and
                           self._ready_rows_locked() < self.max_batch):
                        remaining = wait_until - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=min(remaining, 0.05))
                        self._evict_expired_locked()
                        if not self._q:
                            break
                    if not self._q:
                        continue
                    batch = self._take_batch_locked()
                if batch:
                    self._execute(batch)
            except Exception as e:
                for entry in batch:
                    _fail_entry(entry, e)
                obs.counter("zoo_tpu_serving_errors_total",
                            help="serving errors by kind",
                            labels={"kind": "dispatch_error"}).inc()
                logger.warning("batcher dispatch error (%s: %s); "
                               "dispatcher continues",
                               type(e).__name__, e, exc_info=True)

    # -- execution ----------------------------------------------------------
    def _execute(self, batch: "list[_Entry]"):
        _DISPATCH_FAULT.fire(rows=sum(e.n for e in batch))
        now = time.monotonic()
        wait_h = obs.histogram(
            "zoo_tpu_serving_queue_wait_seconds",
            help="time requests spent queued before dispatch")
        rows = sum(e.n for e in batch)
        for e in batch:
            wait_h.observe(now - e.t_enq)
            # credit the queue wait back to each request's trace
            tracing.record_span(
                e.trace, "serving/queue_wait", e.t_enq_wall,
                now - e.t_enq, rows=e.n, batch_rows=rows,
                n_requests=len(batch))
        sig = batch[0].sig
        n_inputs = len(batch[0].xs)
        if len(batch) == 1:
            xs = batch[0].xs
        else:
            xs = [np.concatenate([e.xs[i] for e in batch])
                  for i in range(n_inputs)]
        t0 = time.monotonic()
        t0_wall = time.time()
        try:
            # the first entry's trace becomes ambient, so the pad and
            # predict spans join it as children
            with tracing.activate(batch[0].trace):
                outs, multi = self._run_rows(sig, xs, rows)
        except Exception as e:  # each request's future carries it
            for entry in batch:
                _fail_entry(entry, e)
            logger.warning("batch of %d rows failed (%s: %s)", rows,
                           type(e).__name__, e, exc_info=True)
            return
        exec_s = time.monotonic() - t0
        # coalesced requests beyond the first get an explicit execute
        # span (their trace was not the ambient one during the call)
        for e in batch[1:]:
            tracing.record_span(
                e.trace, "serving/execute", t0_wall, exec_s,
                rows=e.n, batch_rows=rows, n_requests=len(batch))
        self._ema_batch_s = 0.8 * self._ema_batch_s + 0.2 * exec_s
        off = 0
        t_sc = time.monotonic()
        t_sc_wall = time.time()
        for entry in batch:
            rows_out = [o[off:off + entry.n] for o in outs]
            try:
                if not entry.future.done():
                    entry.future.set_result(
                        rows_out if multi else rows_out[0])
            except Exception:  # cancelled under us: drop the rows,
                pass           # the batchmates still get theirs
            off += entry.n
        scatter_s = time.monotonic() - t_sc
        for e in batch:
            tracing.record_span(
                e.trace, "serving/scatter", t_sc_wall, scatter_s,
                rows=e.n, n_requests=len(batch))

    def _run_rows(self, sig, xs, rows):
        """Execute ``rows`` coalesced rows, in chunks of ``max_batch``
        when one oversized request exceeds it. Returns ``(outs,
        multi)``: row-aligned host arrays (one per model output) and
        whether the model returned a list."""
        if rows <= self.max_batch:
            return self._pad_and_run(sig, xs, rows)
        chunks = []
        multi = False
        for lo in range(0, rows, self.max_batch):
            hi = min(lo + self.max_batch, rows)
            part, multi = self._pad_and_run(
                sig, [x[lo:hi] for x in xs], hi - lo)
            chunks.append(part)
        return [np.concatenate([c[i] for c in chunks])
                for i in range(len(chunks[0]))], multi

    def _pad_and_run(self, sig, xs, n):
        bucket = next(b for b in self.buckets if b >= n)
        fn = self._get_compiled(sig, bucket)
        obs.histogram("zoo_tpu_serving_batch_size",
                      help="predict batch size (leading dim)",
                      buckets=obs.SIZE_BUCKETS).observe(n)
        obs.histogram("zoo_tpu_serving_batch_fill_ratio",
                      help="coalesced rows / bucket capacity",
                      buckets=_FILL_BUCKETS).observe(n / bucket)
        if fn is None:
            # a model that cannot build bucket callables: coalesce
            # without padding through the per-request path (still one
            # call per drained batch)
            with obs.span("serving/predict", rows=n, bucket=0):
                out = self.model.predict(list(xs) if len(xs) > 1
                                         else xs[0])
            multi = isinstance(out, list)
            outs = out if multi else [out]
            return [np.asarray(o) for o in outs], multi
        pad = bucket - n
        if pad:
            with obs.span("serving/pad", rows=n, bucket=bucket, pad=pad):
                xs = [np.concatenate(
                    [x, np.zeros((pad,) + x.shape[1:], x.dtype)])
                    for x in xs]
            obs.counter("zoo_tpu_serving_padding_rows_total",
                        help="padding rows executed (bucket waste)"
                        ).inc(pad)
        obs.counter("zoo_tpu_serving_batch_executions_total",
                    help="bucket executions",
                    labels={"bucket": str(bucket)}).inc()
        with obs.span("serving/predict", rows=n, bucket=bucket,
                      fill=round(n / bucket, 4)):
            out = fn(*xs)
        multi = isinstance(out, (list, tuple))
        outs = [np.asarray(o) for o in (out if multi else [out])]
        for o in outs:
            if o.ndim < 1 or o.shape[0] != bucket:
                raise ValueError(
                    "model output is not row-aligned with its input "
                    f"(expected leading dim {bucket}, got {o.shape}); "
                    "dynamic batching requires a row-wise forward")
        return [o[:n] for o in outs], multi

    # -- bucket callables ---------------------------------------------------
    def _get_compiled(self, sig, bucket: int):
        gen = getattr(self.model, "generation", 0)
        with self._compile_lock:
            if gen != self._model_gen:  # model reloaded underneath us
                self._compiled.clear()
                self._model_gen = gen
                self._warmed_gauge().set(0)
            fn = self._compiled.get((sig, bucket))
        if fn is not None:
            return fn
        if not getattr(self.model, "can_relower", False):
            return None
        # first sight of this signature: warm the whole ladder, so the
        # request mix that follows makes no new callable (a failure
        # fails this batch and is tried again on the next)
        self._warm_signature(sig)
        with self._compile_lock:
            return self._compiled.get((sig, bucket))

    def _warm_signature(self, sig) -> int:
        warmed = 0
        for b in self.buckets:
            with self._compile_lock:
                if (sig, b) in self._compiled:
                    continue
            specs = [((b,) + tuple(shape), np.dtype(dt))
                     for shape, dt in sig]
            with obs.span("serving/bucket_warm", bucket=b):
                fn = self.model.lower_for(specs)
            obs.counter("zoo_tpu_serving_bucket_compiles_total",
                        help="bucket executables compiled "
                        "(warm-up only in steady state)").inc()
            diagnostics.compile_event("serving/bucket_compile")
            with self._compile_lock:
                self._compiled[(sig, b)] = fn
                self._warmed_gauge().set(len(self._compiled))
            warmed += 1
        return warmed

    # -- introspection ------------------------------------------------------
    @property
    def warmed_buckets(self) -> int:
        with self._compile_lock:
            return len(self._compiled)

    def retry_hint_s(self) -> float:
        """The Retry-After a ``QueueFullError`` raised now would carry
        (queued entries times the EMA batch time); the fleet router
        hints the minimum of these when every replica is full."""
        with self._cond:
            depth = len(self._q)
        return max(0.05, depth * self._ema_batch_s)

    def stats(self) -> dict:
        """JSON-able summary for ``GET /health``."""
        with self._cond:
            depth = len(self._q)
        return {
            "enabled": True,
            "queue_depth": depth,
            "queue_capacity": self.queue_depth,
            "buckets": list(self.buckets),
            "warmed_buckets": self.warmed_buckets,
            "max_wait_ms": self.max_wait_s * 1e3,
            "deadline_ms": (self.deadline_s * 1e3
                            if self.deadline_s else None),
        }

    def __repr__(self):
        return (f"DynamicBatcher(buckets={list(self.buckets)}, "
                f"max_wait_ms={self.max_wait_s * 1e3:g}, "
                f"queue_depth={self.queue_depth}, "
                f"warmed={self.warmed_buckets})")


class _GenEntry:
    """One queued generation request: prompt tokens, decode budget,
    sampling knobs, completion future, clocks, the submitting thread's
    trace context and, once admitted, its slot and the tokens emitted so
    far."""

    __slots__ = ("ids", "max_new", "temperature", "eos_id", "future",
                 "t_enq", "t_enq_wall", "trace", "slot", "tokens",
                 "prefilling", "handoff", "blob", "prompt_len")

    def __init__(self, ids, max_new, temperature, eos_id):
        self.ids = ids
        self.max_new = max_new
        self.temperature = temperature
        self.eos_id = eos_id
        self.future: "Future" = Future()
        self.t_enq = time.monotonic()
        self.t_enq_wall = time.time()
        self.trace = tracing.current()
        self.slot = -1
        self.tokens: "list[int]" = []
        self.prefilling = False  # admitted, prompt not wholly cached
        # disaggregation: None for an ordinary request; "out" on the
        # prefill side (the future resolves to a handoff blob at the
        # first token); "in" on the decode side (admitted from ``blob``)
        self.handoff = None
        self.blob = None
        # the page-accounting length: the prompt's, or for a handoff-in
        # entry, which never sees the prompt, the blob's position
        self.prompt_len = len(ids)


class ContinuousBatcher:
    """Iteration-level scheduling for autoregressive decode over one
    :class:`~analytics_zoo_tpu_torch.pipeline.inference.generation.
    GenerationEngine` (module docstring has the design)."""

    def __init__(self, engine, *,
                 queue_depth: Optional[int] = None,
                 max_new_cap: Optional[int] = None):
        env = os.environ
        if queue_depth is None:
            queue_depth = int(env.get("ZOO_TPU_GEN_QUEUE_DEPTH", 64))
        if max_new_cap is None:
            max_new_cap = int(env.get("ZOO_TPU_GEN_MAX_NEW", 256))
        self.engine = engine
        self.queue_depth = int(queue_depth)
        self.max_new_cap = int(max_new_cap)
        self._q: "deque[_GenEntry]" = deque()
        self._active: "list[_GenEntry]" = []
        self._cond = threading.Condition()
        self._stop = False
        self._draining = False
        # an iteration is running: entries it popped may hold slots
        # before they join _active, so the drain audit waits for it
        self._busy = False
        self._thread: Optional[threading.Thread] = None
        self._ema_req_s = 0.05  # retry-after estimator seed
        self._slots_gauge().set(0)
        self._pages_gauge().set(engine.free_pages)

    # -- metrics handles ------------------------------------------------------
    def _slots_gauge(self):
        return obs.gauge("zoo_tpu_serving_gen_slots_active",
                         help="decode slots currently generating")

    def _pages_gauge(self):
        return obs.gauge("zoo_tpu_serving_gen_free_pages",
                         help="free KV-cache pages in the pool")

    def _depth_gauge(self):
        return obs.gauge("zoo_tpu_serving_gen_queue_depth",
                         help="generation requests waiting for a slot")

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "ContinuousBatcher":
        """Warm the engine's programs and start the loop thread.
        Idempotent."""
        if self._thread is not None and self._thread.is_alive():
            return self
        # the page and queue gauges exist before the first request, so
        # the capacity forecaster's rules see their families at once
        self._pages_gauge().set(self.engine.free_pages)
        with self._cond:
            self._depth_gauge().set(len(self._q))
        diagnostics.install_recompile_monitor()
        with obs.span("decode/warm"), diagnostics.expected_compiles():
            self.engine.warm()
        self._stop = False
        self._draining = False
        self._thread = threading.Thread(
            target=self._run, name="zoo-tpu-gen-batcher", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0):
        """Drain (resident sequences run to completion within
        ``timeout``), then stop the loop thread. Whatever is still
        resident or queued fails with RuntimeError and has its pages
        reclaimed."""
        self.drain(timeout=timeout)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        with self._cond:
            pending = list(self._q) + list(self._active)
            self._q.clear()
            self._active = []
        for e in pending:
            if e.slot >= 0:
                self.engine.release(e.slot)
            _fail_entry(e, RuntimeError("generation batcher stopped"))
        self._slots_gauge().set(self.engine.slots_active)
        self._pages_gauge().set(self.engine.free_pages)

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting but run the resident sequences to completion
        (a prompt mid-chunked-prefill included). Queued entries fail at
        once with a retryable RuntimeError and new submits are rejected.
        Then, once the loop is between iterations, an audit reclaims any
        slot that no request owns (a handoff splice that failed after its
        entry was failed, say) and counts its pages in
        ``zoo_tpu_serving_gen_handoff_pages_leaked``, which stays 0 in a
        correct flow. Returns True when every resident sequence retired
        within ``timeout``. Idempotent."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._draining = True
            queued = list(self._q)
            self._q.clear()
            self._depth_gauge().set(0)
            self._cond.notify_all()
        for e in queued:
            _fail_entry(e, RuntimeError(
                "replica draining; resubmit to another replica"))
        alive = self._thread is not None and self._thread.is_alive()
        while time.monotonic() < deadline:
            with self._cond:
                if not (self._active or self._busy) or not alive:
                    break
            time.sleep(0.005)
        with self._cond:
            drained = not self._active
            audit = not self._busy
            owned = {e.slot for e in self._active}
        before = self.engine.free_pages
        for s in range(self.engine.max_slots if audit else 0):
            if s not in self.engine.free_slots and s not in owned:
                self.engine.release(s)
        obs.counter("zoo_tpu_serving_gen_handoff_pages_leaked",
                    help="pages the drain audit reclaimed from slots no "
                    "request owned (0 = exact pool refill)"
                    ).inc(self.engine.free_pages - before)
        self._pages_gauge().set(self.engine.free_pages)
        return drained

    # -- admission ------------------------------------------------------------
    def _new_entry(self, prompt_ids, max_new_tokens, temperature, eos_id):
        ids = [int(t) for t in prompt_ids]
        max_new = min(int(max_new_tokens), self.max_new_cap)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not 1 <= len(ids) <= self.engine.max_context - 1:
            raise ValueError(
                f"prompt length {len(ids)} outside [1, "
                f"{self.engine.max_context - 1}] for this cache")
        return _GenEntry(ids, max_new, float(temperature), eos_id)

    def _enqueue(self, entry: "_GenEntry") -> "Future":
        with self._cond:
            if self._draining or self._stop:
                raise RuntimeError("generation batcher is draining/stopped")
            if len(self._q) >= self.queue_depth:
                retry = max(0.05, len(self._q) * self._ema_req_s)
                obs.counter("zoo_tpu_serving_errors_total",
                            help="serving errors by kind",
                            labels={"kind": "gen_queue_full"}).inc()
                raise QueueFullError(len(self._q), retry)
            self._q.append(entry)
            self._depth_gauge().set(len(self._q))
            self._cond.notify_all()
        return entry.future

    def submit(self, prompt_ids, max_new_tokens: int = 32,
               temperature: float = 0.0, eos_id=None) -> "Future":
        """Enqueue one generation request. The future resolves to a 1-D
        int32 array of the newly generated token ids (eos included when
        hit). Raises ValueError for prompts the cache can never hold and
        :class:`QueueFullError` at capacity."""
        return self._enqueue(self._new_entry(prompt_ids, max_new_tokens,
                                             temperature, eos_id))

    def submit_prefill(self, prompt_ids, max_new_tokens: int = 32,
                       temperature: float = 0.0) -> "Future":
        """Prefill-pool admission: the prompt runs through the bucket or
        chunked prefill as usual, but at its first token the slot's cache
        state is exported and its pages reclaimed; the future resolves to
        the handoff blob (``GenerationEngine.export_handoff``).
        ``max_new_tokens`` rides along so admission reserves pages as a
        monolithic engine would."""
        entry = self._new_entry(prompt_ids, max_new_tokens, temperature,
                                None)
        entry.handoff = "out"
        return self._enqueue(entry)

    def submit_handoff(self, blob: dict, max_new_tokens: int = 32,
                       eos_id=None) -> "Future":
        """Decode-pool admission: claim a slot and pages for a prefilled
        sequence and splice its shipped pages in, with no forward pass.
        The future resolves to the whole new-token stream (the blob's
        first token included), as the monolithic engine's. Raises
        ValueError for a blob this engine can never hold."""
        max_new = min(int(max_new_tokens), self.max_new_cap)
        if max_new < 2:
            raise ValueError(
                "handoff admission needs max_new_tokens >= 2 (the first "
                "token was already sampled at prefill)")
        self.engine._check_handoff_blob(blob)
        entry = _GenEntry([], max_new, float(blob.get("temperature", 0.0)),
                          eos_id)
        entry.handoff = "in"
        entry.blob = blob
        entry.prompt_len = int(blob["seq_len"])
        # the prefill side emitted token 1: seed it, so the budget and
        # the resolved stream match the monolithic engine's
        entry.tokens = [int(blob["last_token"])]
        return self._enqueue(entry)

    # -- the decode loop ------------------------------------------------------
    def _finish(self, e: "_GenEntry", now: float):
        with obs.span("decode/retire", slot=e.slot, tokens=len(e.tokens)):
            self.engine.release(e.slot)
        dur = now - e.t_enq
        self._ema_req_s = 0.8 * self._ema_req_s + 0.2 * dur
        # the request's trace: enqueue to its last token
        tracing.record_span(e.trace, "decode/retire", e.t_enq_wall, dur,
                            slot=e.slot, tokens=len(e.tokens))
        e.future.set_result(np.asarray(e.tokens, np.int32))

    def _finish_handoff_out(self, e: "_GenEntry", now: float):
        """Prefill-side retirement: export the slot's cache state (which
        reclaims its pages) and resolve the future with the blob."""
        t0 = time.time()
        with obs.span("decode/handoff_export", slot=e.slot):
            blob = self.engine.export_handoff(e.slot)
        obs.counter("zoo_tpu_serving_gen_handoffs_total",
                    help="KV-page handoffs between prefill and decode "
                    "pools", labels={"direction": "out"}).inc()
        self._ema_req_s = 0.8 * self._ema_req_s + 0.2 * (now - e.t_enq)
        tracing.record_span(e.trace, "decode/handoff_export", t0,
                            time.time() - t0, slot=e.slot,
                            seq_len=blob["seq_len"])
        e.future.set_result(blob)

    def _admit_handoffs(self, entries, done):
        """Decode-side admission: splice each blob into the engine and
        join the active set. A failed splice fails its own entry only;
        the engine validates before it allocates, so a rejected blob
        leaves the pool whole."""
        for e in entries:
            try:
                with obs.span("decode/handoff_admit"):
                    slot = self.engine.admit_from_handoff(e.blob, e.max_new)
            except Exception as exc:
                _fail_entry(e, exc)
                continue
            now = time.monotonic()
            e.slot = slot
            e.blob = None  # the host copy is spliced
            obs.histogram("zoo_tpu_serving_gen_handoff_seconds",
                          help="decode-pool handoff admission latency "
                          "(blob enqueue to pages spliced)"
                          ).observe(now - e.t_enq)
            obs.counter("zoo_tpu_serving_gen_handoffs_total",
                        help="KV-page handoffs between prefill and decode "
                        "pools", labels={"direction": "in"}).inc()
            tracing.record_span(e.trace, "decode/handoff_admit",
                                e.t_enq_wall, now - e.t_enq, slot=slot,
                                seq_len=e.prompt_len)
            if (e.eos_id is not None and e.tokens[-1] == e.eos_id) or \
                    len(e.tokens) >= e.max_new:
                done.append(e)
            else:
                self._active.append(e)

    def _token_out(self, e: "_GenEntry", tok: int, now: float) -> bool:
        """Record one emitted token; True when the request is done."""
        if not e.tokens:
            obs.histogram("zoo_tpu_serving_gen_ttft_seconds",
                          help="time from submit to first generated token"
                          ).observe(now - e.t_enq)
        e.tokens.append(tok)
        if e.eos_id is not None and tok == e.eos_id:
            return True
        return len(e.tokens) >= e.max_new

    def _first_token(self, e: "_GenEntry", tok: int, now: float, done):
        """An admitted request's first token: a prefill-side handoff
        exports and resolves; any other request joins ``done`` when the
        token ends it. Returns True when it stays resident."""
        if e.handoff == "out":
            self._token_out(e, tok, now)
            self._finish_handoff_out(e, now)
            return False
        if self._token_out(e, tok, now):
            done.append(e)
            return False
        return True

    def _admit_locked_pop(self) -> "list[_GenEntry]":
        """Pop the longest queue prefix that fits (FIFO: no request
        starves behind a smaller one that jumped it), debiting slots and
        pages of entries popped earlier in the same batch."""
        take = []
        slots = len(self.engine.free_slots)
        pages = self.engine.free_pages
        while self._q and slots > 0:
            need = self.engine.pages_for(self._q[0].prompt_len,
                                         self._q[0].max_new)
            if need > pages:
                break
            take.append(self._q.popleft())
            slots -= 1
            pages -= need
        if take:
            self._depth_gauge().set(len(self._q))
        return take

    def _spec_eligible(self, e: "_GenEntry") -> bool:
        """Whether a resident slot may take a speculative round. A round
        consumes a full k-token window even when the request needs one
        more token, so the window must fit the slot's page reservation
        and the context: the rows consumed after the round are ``plen +
        emitted - 1 + k``, the reservation ``min(plen + max_new,
        max_context)``. Ineligible slots take plain steps in the same
        iteration."""
        consumed_after = e.prompt_len + len(e.tokens) - 1 + \
            self.engine.spec_k
        return consumed_after <= min(e.prompt_len + e.max_new,
                                     self.engine.max_context)

    def _record_round(self, name: str, entries, t0_wall: float,
                      dur: float, **fields):
        """Credit one engine call (a chunk, a speculative round) to the
        trace of every request it served."""
        for e in entries:
            tracing.record_span(e.trace, name, t0_wall, dur, slot=e.slot,
                                **fields)

    def _chunk_step(self, done):
        """Advance every mid-prefill slot by one chunk and emit the first
        tokens of prompts whose last chunk just landed."""
        engine = self.engine
        prefilling = [e for e in self._active if e.prefilling]
        t0, t0_wall = time.monotonic(), time.time()
        with obs.span("decode/prefill_chunk", n=len(prefilling)):
            firsts = engine.prefill_step()
        now = time.monotonic()
        self._record_round("decode/prefill_chunk", prefilling, t0_wall,
                           now - t0, n=len(prefilling))
        obs.counter("zoo_tpu_serving_gen_prefill_chunks_total",
                    help="prompt chunks written by chunked prefill").inc()
        by_slot = {e.slot: e for e in prefilling}
        for slot, tok in firsts:
            e = by_slot[slot]
            e.prefilling = False
            if not self._first_token(e, tok, now, done):
                self._active.remove(e)

    def _admit(self, fresh, done):
        """Admit the entries popped this iteration: handoff blobs are
        spliced; prompts longer than one chunk (under chunked prefill)
        claim slots and pages and land their first chunk at once; the
        rest take one bucket-padded prefill, whose single right-sized
        call beats a padded full-width chunk."""
        engine = self.engine
        hand_in = [e for e in fresh if e.handoff == "in"]
        if hand_in:
            self._admit_handoffs(hand_in, done)
        prompts = [e for e in fresh if e.handoff != "in"]
        chunk = engine.prefill_chunk
        long_p = [e for e in prompts if 0 < chunk < len(e.ids)]
        short_p = [e for e in prompts if not 0 < chunk < len(e.ids)]
        if long_p:
            reqs = [(e.ids, e.max_new, e.temperature) for e in long_p]
            with obs.span("decode/admit", n=len(long_p)):
                slots = engine.admit_partial(reqs)
            now = time.monotonic()
            for e, slot in zip(long_p, slots):
                e.slot = slot
                e.prefilling = True
                tracing.record_span(e.trace, "decode/admit", e.t_enq_wall,
                                    now - e.t_enq, slot=slot,
                                    prompt_len=len(e.ids))
                self._active.append(e)
            # kickoff: the fresh prompts' first chunk lands in the
            # iteration that admitted them
            self._chunk_step(done)
        if short_p:
            reqs = [(e.ids, e.max_new, e.temperature) for e in short_p]
            with obs.span("decode/admit", n=len(short_p)):
                first = engine.admit(reqs)
            now = time.monotonic()
            for e, (slot, tok) in zip(short_p, first):
                e.slot = slot
                # the request's trace: enqueue to admission
                tracing.record_span(e.trace, "decode/admit", e.t_enq_wall,
                                    now - e.t_enq, slot=slot,
                                    prompt_len=len(e.ids))
                if self._first_token(e, tok, now, done):
                    self._active.append(e)

    def _decode(self, done) -> int:
        """One decode iteration: a speculative round for the eligible
        resident slots, a plain step for the others. Returns the tokens
        emitted."""
        engine = self.engine
        spec_k = engine.spec_k
        spec, regular = [], []
        for e in self._active:
            if not e.prefilling:
                (spec if spec_k > 0 and self._spec_eligible(e)
                 else regular).append(e)
        emitted = 0
        if spec:
            active = np.zeros((engine.max_slots,), np.bool_)
            active[[e.slot for e in spec]] = True
            prev_acc = engine.spec_accepted
            t0, t0_wall = time.monotonic(), time.time()
            with obs.span("decode/spec_step", n=len(spec)):
                out, n_emit = engine.spec_step(active)
            now = time.monotonic()
            self._record_round("decode/spec_step", spec, t0_wall, now - t0,
                               n=len(spec))
            obs.counter("zoo_tpu_serving_gen_spec_proposed_total",
                        help="draft tokens proposed for verification"
                        ).inc(spec_k * len(spec))
            obs.counter("zoo_tpu_serving_gen_spec_accepted_total",
                        help="draft tokens accepted by the target model"
                        ).inc(engine.spec_accepted - prev_acc)
            for e in spec:
                for j in range(int(n_emit[e.slot])):
                    emitted += 1
                    if self._token_out(e, int(out[e.slot, j]), now):
                        done.append(e)
                        self._active.remove(e)
                        break
        if regular:
            active = np.zeros((engine.max_slots,), np.bool_)
            active[[e.slot for e in regular]] = True
            with obs.span("decode/step", n=len(regular)):
                toks = engine.step(active)
            now = time.monotonic()
            for e in regular:
                emitted += 1
                if self._token_out(e, int(toks[e.slot]), now):
                    done.append(e)
                    self._active.remove(e)
        if spec or regular:
            obs.counter("zoo_tpu_serving_gen_tokens_total",
                        help="tokens generated").inc(emitted)
            obs.counter("zoo_tpu_serving_gen_steps_total",
                        help="decode iterations executed").inc()
        return emitted

    def _run(self):
        engine = self.engine
        while True:
            with self._cond:
                while not self._q and not self._active and not self._stop:
                    self._cond.wait(timeout=0.1)
                if self._stop:
                    return
                fresh = [] if self._draining else self._admit_locked_pop()
                self._busy = True
            done: "list[_GenEntry]" = []
            try:
                if fresh:
                    self._admit(fresh, done)
                if engine.prefilling_slots:
                    self._chunk_step(done)
                self._decode(done)
                now = time.monotonic()
                for e in done:
                    self._finish(e, now)
            except Exception as exc:
                # a failed step fails its requests, not the loop thread;
                # slots are reclaimed so the batch serves whoever is next.
                # A request already resolved (a handoff blob) owns no slot.
                failing = {id(e): e for e in fresh + self._active + done}
                for e in failing.values():
                    if e.future.done():
                        continue
                    if e.slot >= 0:
                        engine.release(e.slot)
                    _fail_entry(e, exc)
                self._active = []
                logger.warning("generation batcher error: %s", exc,
                               exc_info=True)
            self._slots_gauge().set(engine.slots_active)
            self._pages_gauge().set(engine.free_pages)
            with self._cond:
                self._busy = False

    # -- introspection --------------------------------------------------------
    def stats(self) -> dict:
        """JSON-able summary."""
        with self._cond:
            depth = len(self._q)
            active = len(self._active)
        s = {"enabled": True, "queue_depth": depth,
             "queue_capacity": self.queue_depth,
             "requests_active": active, "max_new_cap": self.max_new_cap}
        s.update(self.engine.stats())
        return s

    def __repr__(self):
        return (f"ContinuousBatcher(slots={self.engine.max_slots}, "
                f"context={self.engine.max_context}, "
                f"queue_depth={self.queue_depth})")
