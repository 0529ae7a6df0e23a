"""Continuous batching for generation serving (port of the
``ContinuousBatcher`` of ``analytics_zoo_tpu/pipeline/inference/
batching.py``, whole-prompt path; ``DynamicBatcher`` and the chunked,
speculative and handoff branches wait with their engine features).

Generation requests run for a variable number of steps, so batching
whole requests would hold every sequence hostage to the longest one
(ORCA, OSDI'22). Instead one decode step runs continuously over a fixed
slot array (``generation.GenerationEngine``) and this batcher
reschedules between steps: finished sequences retire (pages reclaimed,
future resolved) and queued ones are admitted into the freed slots by a
bucket-padded prefill, while their neighbours keep decoding.

Thread model: client threads call :meth:`ContinuousBatcher.submit`; one
loop thread drives admit → step → retire. Admission is gated on a free
slot and a full worst-case page reservation, so an admitted sequence
always runs to completion. ``ZOO_TPU_GEN_QUEUE_DEPTH`` bounds the wait
queue (default 64; full → :class:`QueueFullError`),
``ZOO_TPU_GEN_MAX_NEW`` caps a request's decode budget (default 256).
Telemetry: ``common/observability.py`` lists the metrics and spans.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common import observability as obs
from analytics_zoo_tpu_torch.common.nncontext import logger

__all__ = ["ContinuousBatcher", "QueueFullError", "DeadlineExpiredError",
           "bucket_ladder"]


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


def bucket_ladder(max_batch: int) -> "Tuple[int, ...]":
    """Powers of two up to ``max_batch`` (``max_batch`` appended when it
    is not one). The generation engine pads prompts to this ladder."""
    ladder = []
    b = 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return tuple(ladder)


class _GenEntry:
    """One queued generation request: prompt tokens, decode budget,
    sampling knobs, completion future, clocks and, once admitted, its
    slot and the tokens emitted so far."""

    __slots__ = ("ids", "max_new", "temperature", "eos_id", "future",
                 "t_enq", "slot", "tokens", "prompt_len")

    def __init__(self, ids, max_new, temperature, eos_id):
        self.ids = ids
        self.max_new = max_new
        self.temperature = temperature
        self.eos_id = eos_id
        self.future: "Future" = Future()
        self.t_enq = time.monotonic()
        self.slot = -1
        self.tokens: "list[int]" = []
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
        with obs.span("decode/warm"):
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
        """Stop admitting but run the resident sequences to completion.
        Queued entries fail at once with a retryable RuntimeError and new
        submits are rejected. Returns True when every resident sequence
        retired within ``timeout``. Idempotent."""
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
                if not self._active or not alive:
                    break
            time.sleep(0.005)
        with self._cond:
            return not self._active

    # -- admission ------------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32,
               temperature: float = 0.0, eos_id=None) -> "Future":
        """Enqueue one generation request. The future resolves to a 1-D
        int32 array of the newly generated token ids (eos included when
        hit). Raises ValueError for prompts the cache can never hold and
        :class:`QueueFullError` at capacity."""
        ids = [int(t) for t in prompt_ids]
        max_new = min(int(max_new_tokens), self.max_new_cap)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not 1 <= len(ids) <= self.engine.max_context - 1:
            raise ValueError(
                f"prompt length {len(ids)} outside [1, "
                f"{self.engine.max_context - 1}] for this cache")
        entry = _GenEntry(ids, max_new, float(temperature), eos_id)
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

    # -- the decode loop ------------------------------------------------------
    def _finish(self, e: "_GenEntry", now: float):
        with obs.span("decode/retire"):
            self.engine.release(e.slot)
        self._ema_req_s = 0.8 * self._ema_req_s + 0.2 * (now - e.t_enq)
        e.future.set_result(np.asarray(e.tokens, np.int32))

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

    def _run(self):
        engine = self.engine
        while True:
            with self._cond:
                while not self._q and not self._active and not self._stop:
                    self._cond.wait(timeout=0.1)
                if self._stop:
                    return
                fresh = [] if self._draining else self._admit_locked_pop()
            try:
                now = time.monotonic()
                done: "list[_GenEntry]" = []
                if fresh:
                    reqs = [(e.ids, e.max_new, e.temperature) for e in fresh]
                    with obs.span("decode/admit"):
                        first = engine.admit(reqs)
                    now = time.monotonic()
                    for e, (slot, tok) in zip(fresh, first):
                        e.slot = slot
                        if self._token_out(e, tok, now):
                            done.append(e)
                        else:
                            self._active.append(e)
                if self._active:
                    active = np.zeros((engine.max_slots,), np.bool_)
                    for e in self._active:
                        active[e.slot] = True
                    with obs.span("decode/step"):
                        toks = engine.step(active)
                    now = time.monotonic()
                    for e in list(self._active):
                        if self._token_out(e, int(toks[e.slot]), now):
                            done.append(e)
                            self._active.remove(e)
                    obs.counter("zoo_tpu_serving_gen_tokens_total",
                                help="tokens generated").inc(
                        int(active.sum()))
                    obs.counter("zoo_tpu_serving_gen_steps_total",
                                help="decode iterations executed").inc()
                for e in done:
                    self._finish(e, now)
            except Exception as exc:
                # a failed step fails its requests, not the loop thread;
                # slots are reclaimed so the batch serves whoever is next
                failing = {id(e): e for e in fresh + self._active}
                for e in failing.values():
                    if e.slot >= 0:
                        engine.release(e.slot)
                    _fail_entry(e, exc)
                self._active = []
                logger.warning("generation batcher error: %s", exc,
                               exc_info=True)
            self._slots_gauge().set(engine.slots_active)
            self._pages_gauge().set(engine.free_pages)

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
