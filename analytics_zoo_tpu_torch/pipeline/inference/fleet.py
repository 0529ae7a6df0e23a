"""Replicated serving fleet: a router over N model replicas (port of
``analytics_zoo_tpu/pipeline/inference/fleet.py``).

The reference platform's Cluster Serving is a fleet, not one process.
A :class:`ReplicaPool` owns N replicas (one per device slice,
``parallel/mesh.py``), and a :class:`FleetRouter` dispatches requests
across them::

    clients --HTTP--> front end (serving.py)
                          | handle_predict
                          v
                     FleetRouter        least outstanding rows, or
                      |  |  |           consistent-hash affinity
              +-------+  |  +-------+
              v          v          v
          Replica r0  Replica r1  HttpReplica r2   each: its OWN
          DynamicBatcher + InferenceModel         bucket ladder and
          (cuda:0)    (cuda:1)    (a process)     its own warm-up

Design notes:

* **Layering.** The router duck-types both the model surface
  (``predict`` / ``example_input_specs`` / ``concurrent_slots_free``)
  and the batcher surface (``batchable`` / ``submit`` / ``stats`` /
  ``start`` / ``stop``), so the front end serves a fleet unchanged:
  ``InferenceServer(router, batcher=router)``. Each replica keeps its
  own :class:`DynamicBatcher`; the router only picks the queue.
* **Exactly once for acked work.** ``submit`` returns a router-level
  future. A replica that fails mid-request fails its own future; the
  router re-dispatches those rows to a sibling (at most
  ``ZOO_TPU_FLEET_MAX_RETRIES`` times, the failed replica excluded).
  Rows whose future resolved are never run again.
* **Lifecycle.** admitting -> (``ZOO_TPU_FLEET_EJECT_AFTER`` consecutive
  failures) -> down, re-admitted by probes after an exponential
  backoff; or admitting -> draining (stop admitting, flush, stop the
  batcher) -> drained -> restart (a reload in between bumps
  ``InferenceModel.generation``, so the bucket callables are made
  anew).
* **Backpressure.** One full queue steers traffic to a sibling; when
  every admitting replica is full the router raises
  :class:`FleetSaturatedError` with the minimum Retry-After hint of the
  fleet (HTTP 503 + ``Retry-After``).
* **Tracing.** Dispatch and retry spans join the request's trace
  (``X-Zoo-Trace-Id``); in-process replicas inherit it through the
  batcher, HTTP replicas forward the header.

Environment (read at construction; keyword arguments override):

``ZOO_TPU_FLEET_REPLICAS``              fleet size (default: one per
                                        device slice)
``ZOO_TPU_FLEET_DEVICES_PER_REPLICA``   devices per slice (1)
``ZOO_TPU_FLEET_POLICY``                least_loaded | hash
``ZOO_TPU_FLEET_MAX_RETRIES``           sibling retries (2)
``ZOO_TPU_FLEET_EJECT_AFTER``           consecutive failures -> down (3)
``ZOO_TPU_FLEET_BACKOFF_S``             first re-admission delay (1)
``ZOO_TPU_FLEET_BACKOFF_MAX_S``         backoff ceiling (30)
``ZOO_TPU_FLEET_PROBE_S``               prober interval (2; <= 0: call
                                        ``tick()`` by hand)

The second half of the module is disaggregated generation
(:class:`DisaggRouter`): a prefill pool that exports KV-page handoff
blobs and a decode pool that resumes from them.
"""

from __future__ import annotations

import bisect
import copy
import hashlib
import json
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.common import diagnostics
from analytics_zoo_tpu_torch.common import faults
from analytics_zoo_tpu_torch.common import observability as obs
from analytics_zoo_tpu_torch.common import tracing
from analytics_zoo_tpu_torch.common.nncontext import logger
from analytics_zoo_tpu_torch.pipeline.inference.batching import (
    ContinuousBatcher, DeadlineExpiredError, DynamicBatcher,
    QueueFullError)

# fault point: fires on every dispatch to an in-process replica with
# ctx {replica: name}, so a fault can target one replica by name ("kill"
# exercises ejection and sibling retry, "delay" a straggler, "corrupt"
# a replica returning garbage)
_PREDICT_FAULT = faults.point("fleet/replica_predict")

__all__ = [
    "Replica",
    "HttpReplica",
    "ReplicaPool",
    "ReplicaContext",
    "FleetRouter",
    "FleetSaturatedError",
    "ReplicaUnavailableError",
    "make_fleet_server",
    "DisaggReplica",
    "HttpDisaggReplica",
    "DisaggRouter",
]

# replica lifecycle states (fleet_status() and /debug/fleet)
STARTING = "starting"
ADMITTING = "admitting"
DRAINING = "draining"
DRAINED = "drained"
DOWN = "down"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class FleetSaturatedError(QueueFullError):
    """Every admitting replica's queue is full. A
    :class:`QueueFullError`, so ``handle_predict`` answers 503 +
    ``Retry-After``; ``retry_after_s`` is the minimum hint across the
    fleet (the soonest any queue frees up)."""

    def __init__(self, replicas: int, retry_after_s: float):
        Exception.__init__(
            self,
            f"all {replicas} admitting replica queues are full; "
            f"retry in ~{retry_after_s:.2f}s")
        self.retry_after_s = retry_after_s
        self.replicas = replicas


class ReplicaUnavailableError(QueueFullError):
    """No replica admits (all down or draining). Also a 503: capacity
    returns when a probe re-admits one, so ``retry_after_s`` is the
    soonest probe."""

    def __init__(self, retry_after_s: float):
        Exception.__init__(
            self,
            f"no admitting replica in the fleet; retry in "
            f"~{retry_after_s:.2f}s")
        self.retry_after_s = retry_after_s


# -- metric handles (the reference's names) -----------------------------------

def _g_admitting():
    return obs.gauge("zoo_tpu_fleet_replicas_admitting",
                     help="replicas currently accepting traffic")


def _g_size():
    return obs.gauge("zoo_tpu_fleet_replicas_total",
                     help="replicas in the pool (any state)")


def _g_up(name: str):
    return obs.gauge("zoo_tpu_fleet_replica_up",
                     help="1 while the replica admits traffic",
                     labels={"replica": name})


def _g_outstanding(name: str):
    return obs.gauge("zoo_tpu_fleet_outstanding_rows",
                     help="rows dispatched to the replica and not "
                          "yet resolved",
                     labels={"replica": name})


def _c_dispatch(name: str):
    return obs.counter("zoo_tpu_fleet_dispatches_total",
                       help="requests dispatched, by replica",
                       labels={"replica": name})


def _c_requests():
    return obs.counter("zoo_tpu_fleet_requests_total",
                       help="requests entering the router")


def _c_failed():
    return obs.counter("zoo_tpu_fleet_requests_failed_total",
                       help="router requests that ultimately failed")


def _c_retries():
    return obs.counter("zoo_tpu_fleet_retries_total",
                       help="dispatches retried on a sibling replica")


def _c_saturated():
    return obs.counter("zoo_tpu_fleet_saturated_total",
                       help="requests rejected with every replica "
                            "queue full")


def _c_ejections(name: str):
    return obs.counter("zoo_tpu_fleet_ejections_total",
                       help="replica ejections (marked down)",
                       labels={"replica": name})


def _c_readmissions(name: str):
    return obs.counter("zoo_tpu_fleet_readmissions_total",
                       help="replicas re-admitted after backoff",
                       labels={"replica": name})


# per-version cohort metrics: every replica completion counts for the
# model version that served it, so a canary cohort's errors and latency
# separate from the baseline's (the rollout controller reads them)

def _c_cohort_requests(version: str):
    return obs.counter("zoo_tpu_rollout_requests_total",
                       help="replica completions by model version "
                            "(canary cohort attribution)",
                       labels={"version": version})


def _c_cohort_errors(version: str):
    return obs.counter("zoo_tpu_rollout_errors_total",
                       help="replica failures by model version "
                            "(canary cohort attribution)",
                       labels={"version": version})


def _h_cohort_latency(version: str):
    return obs.histogram("zoo_tpu_rollout_latency_seconds",
                         help="dispatch-to-resolve latency by model "
                              "version",
                         labels={"version": version})


# per-replica dispatch accounting, the same for in-process and HTTP
# replicas: the federation collector's skew detector reads these

def _h_replica_latency(name: str):
    return obs.histogram("zoo_tpu_fleet_replica_latency_seconds",
                         help="dispatch-to-resolve latency by "
                              "replica (skew detection input)",
                         labels={"replica": name})


def _c_replica_errors(name: str):
    return obs.counter("zoo_tpu_fleet_replica_errors_total",
                       help="dispatch failures attributed to a "
                            "replica (skew detection input)",
                       labels={"replica": name})


class ReplicaContext:
    """What a :class:`ReplicaPool` ``model_fn`` receives: the
    replica's index, name and the device slice it owns."""

    def __init__(self, index: int, name: str, devices: Sequence):
        self.index = int(index)
        self.name = name
        self.devices = tuple(devices)

    def __repr__(self):
        return (f"ReplicaContext({self.name}, "
                f"devices={[str(d) for d in self.devices]})")


class _ReplicaBase:
    """The replica state machine and its accounting. Subclasses provide
    the transport (:class:`Replica` in-process, :class:`HttpReplica`
    remote)."""

    def __init__(self, name: str, clock: Callable[[], float]):
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self.state = STARTING
        # what the replica serves: "predict", or a disaggregated pool
        # role ("prefill" / "decode" / "both"), shown on /debug/fleet
        self.role = "predict"
        # the model version it serves (the cohort label; the rollout
        # controller rewrites it across a warm swap)
        self.version = "v0"
        self.down_reason: Optional[str] = None
        self.outstanding_rows = 0
        self.consecutive_failures = 0
        self.failures_total = 0
        self.dispatches_total = 0
        self._backoff_base = _env_float("ZOO_TPU_FLEET_BACKOFF_S", 1.0)
        self._backoff_max = _env_float("ZOO_TPU_FLEET_BACKOFF_MAX_S",
                                       30.0)
        self.backoff_s = self._backoff_base
        self.next_probe_at = 0.0  # clock() time of the next revival try
        _g_outstanding(name).set(0)
        _g_up(name).set(0)

    # -- state ---------------------------------------------------------------
    def admitting(self) -> bool:
        with self._lock:
            return self.state == ADMITTING

    def _set_admitting(self):
        with self._lock:
            self.state = ADMITTING
            self.down_reason = None
            self.consecutive_failures = 0
            self.backoff_s = self._backoff_base
        _g_up(self.name).set(1)

    def _set_stopped(self):
        with self._lock:
            self.state = DOWN
            self.down_reason = "stopped"
        _g_up(self.name).set(0)

    def mark_down(self, reason: str,
                  now: Optional[float] = None) -> bool:
        """admitting/draining -> down, the first revival probe one
        backoff from now. False when already down."""
        now = self._clock() if now is None else now
        with self._lock:
            if self.state == DOWN:
                return False
            self.state = DOWN
            self.down_reason = reason
            self.next_probe_at = now + self.backoff_s
        _g_up(self.name).set(0)
        _c_ejections(self.name).inc()
        diagnostics.anomaly("fleet_replica_down", replica=self.name,
                            reason=reason)
        logger.warning("fleet: replica %s marked down (%s)",
                       self.name, reason)
        return True

    def backoff_bump(self, now: float):
        """A revival probe failed: double the backoff (capped) and
        schedule the next probe."""
        with self._lock:
            self.backoff_s = min(self.backoff_s * 2.0, self._backoff_max)
            self.next_probe_at = now + self.backoff_s

    def _drain_wait(self, timeout: float) -> bool:
        """Wait (wall clock) for the outstanding rows to resolve, then
        park in ``drained``; True when they all did."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self.outstanding_rows == 0:
                    break
            time.sleep(0.005)
        with self._lock:
            flushed = self.outstanding_rows == 0
            self.state = DRAINED
        return flushed

    def _begin_drain(self) -> bool:
        """admitting -> draining; False when the replica is down (there
        is nothing to drain)."""
        with self._lock:
            if self.state == DOWN:
                return False
            self.state = DRAINING
        _g_up(self.name).set(0)
        return True

    # -- accounting (router-driven) ------------------------------------------
    def note_dispatch(self, rows: int):
        with self._lock:
            self.outstanding_rows += rows
            self.dispatches_total += 1
            out = self.outstanding_rows
        _g_outstanding(self.name).set(out)
        _c_dispatch(self.name).inc()

    def note_done(self, rows: int):
        with self._lock:
            self.outstanding_rows = max(0, self.outstanding_rows - rows)
            out = self.outstanding_rows
        _g_outstanding(self.name).set(out)

    def note_success(self):
        with self._lock:
            self.consecutive_failures = 0

    def note_failure(self) -> int:
        """Count one dispatch failure; returns the consecutive count
        (the router ejects past its threshold)."""
        with self._lock:
            self.consecutive_failures += 1
            self.failures_total += 1
            return self.consecutive_failures

    # -- introspection -------------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            st = {
                "name": self.name,
                "state": self.state,
                "role": self.role,
                "version": self.version,
                "outstanding_rows": self.outstanding_rows,
                "consecutive_failures": self.consecutive_failures,
                "failures_total": self.failures_total,
                "dispatches_total": self.dispatches_total,
                "backoff_s": self.backoff_s,
            }
            if self.down_reason:
                st["down_reason"] = self.down_reason
        st["batcher"] = self.batcher_stats()
        return st

    # -- transport surface (subclasses) --------------------------------------
    def start(self):
        raise NotImplementedError

    def stop(self):
        raise NotImplementedError

    def batchable(self, xs) -> bool:
        raise NotImplementedError

    def submit(self, xs) -> "Future":
        raise NotImplementedError

    def predict(self, inputs, timeout_ms: int = -1):
        raise NotImplementedError

    def probe(self) -> bool:
        raise NotImplementedError

    def retry_hint_s(self) -> float:
        return 0.05

    def batcher_stats(self) -> dict:
        return {"enabled": False}

    def slots_free(self) -> int:
        return 1

    def concurrency(self) -> int:
        return 1

    def input_specs(self):
        return None


class Replica(_ReplicaBase):
    """One in-process replica: a model (an :class:`InferenceModel`
    whose net and params sit on this replica's device) and its own
    :class:`DynamicBatcher`: its own bounded queue, bucket ladder and
    warm-up, with gauges labelled ``{replica=<name>}``."""

    def __init__(self, name: str, model, batcher="auto",
                 batcher_kwargs: Optional[dict] = None,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(name, clock)
        self.model = model
        if batcher == "auto":
            if os.environ.get("ZOO_TPU_SERVING_BATCH", "1") == "0":
                self.batcher = None
            else:
                kw = dict(batcher_kwargs or {})
                kw.setdefault("labels", {"replica": name})
                self.batcher = DynamicBatcher(model, **kw)
        else:
            self.batcher = batcher

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Replica":
        """Warm the bucket ladder and begin admitting. Idempotent."""
        if self.batcher is not None:
            self.batcher.start()
        self._set_admitting()
        return self

    def stop(self):
        if self.batcher is not None:
            self.batcher.stop()
        self._set_stopped()

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting (the router skips the replica), flush what is
        in flight (the batcher runs its queue before its dispatcher
        exits), then park in ``drained``. True when everything resolved
        within ``timeout`` of wall time."""
        if not self._begin_drain():
            return True
        t0 = time.monotonic()
        if self.batcher is not None:
            self.batcher.stop(timeout=timeout)
        flushed = self._drain_wait(
            max(0.0, timeout - (time.monotonic() - t0)))
        obs.event("fleet/drained", replica=self.name, flushed=flushed)
        return flushed

    def restart(self) -> "Replica":
        """Bring a drained replica back: restart the batcher (its
        callables are checked against ``model.generation``, so a reload
        in between serves the new weights) and admit again."""
        if self.batcher is not None:
            self.batcher.start()
        self._set_admitting()
        return self

    # -- transport -----------------------------------------------------------
    def batchable(self, xs) -> bool:
        return self.batcher is not None and self.batcher.batchable(xs)

    def submit(self, xs) -> "Future":
        _PREDICT_FAULT.fire(replica=self.name)
        return self.batcher.submit(xs)

    def predict(self, inputs, timeout_ms: int = -1):
        _PREDICT_FAULT.fire(replica=self.name)
        if timeout_ms is not None and timeout_ms > 0:
            out = self.model.predict(inputs, timeout_ms=timeout_ms)
        else:
            out = self.model.predict(inputs)
        return _PREDICT_FAULT.corrupt(out, replica=self.name)

    def probe(self) -> bool:
        """One predict at the declared example shape through the
        per-request path (the queue bypassed), to prove the replica
        serves before it is admitted again."""
        try:
            specs = getattr(self.model, "example_input_specs", None)
            if specs:
                xs = [np.zeros(tuple(shape), np.dtype(dt))
                      for shape, dt in specs]
                self.model.predict(xs if len(xs) > 1 else xs[0])
            return True
        except Exception as e:
            logger.info("fleet: probe failed on %s: %s", self.name, e)
            return False

    def retry_hint_s(self) -> float:
        if self.batcher is not None:
            return self.batcher.retry_hint_s()
        return 0.05

    def batcher_stats(self) -> dict:
        if self.batcher is None:
            return {"enabled": False}
        return self.batcher.stats()

    def slots_free(self) -> int:
        return int(getattr(self.model, "concurrent_slots_free", 1))

    def concurrency(self) -> int:
        return int(getattr(self.model, "supported_concurrent_num", 1))

    def input_specs(self):
        return getattr(self.model, "example_input_specs", None)


def _http_error(name: str, e) -> Exception:
    """A replica's HTTP error mapped onto the router's exceptions: 503
    is backpressure, 504 a deadline, 400 a client error."""
    detail = {}
    try:
        detail = json.loads(e.read()).get("error", {})
    except (ValueError, OSError):
        pass
    if e.code == 503:
        return QueueFullError(0, float(detail.get("retry_after_s", 1.0)))
    if e.code == 504:
        return DeadlineExpiredError(
            detail.get("message", "remote deadline expired"))
    if e.code == 400:
        return ValueError(detail.get("message", "bad request"))
    return RuntimeError(f"replica {name} HTTP {e.code}: "
                        f"{detail.get('message', '')}")


def _post_json(url: str, name: str, payload: dict, ctx,
               timeout_s: float) -> dict:
    """POST ``payload`` with the trace id in ``X-Zoo-Trace-Id``;
    returns the parsed answer or raises :func:`_http_error`'s
    exception."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    if ctx is not None:
        req.add_header(tracing.TRACE_HEADER, ctx[0])
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        raise _http_error(name, e) from None


def _health_ok(url: str) -> bool:
    import urllib.request
    try:
        with urllib.request.urlopen(url + "/health", timeout=5.0) as resp:
            return json.loads(resp.read()).get("status") == "ok"
    except Exception:
        return False


def _name_of(url: str) -> str:
    return url.split("//", 1)[-1].replace("/", "_").replace(":", "_")


class HttpReplica(_ReplicaBase):
    """A replica in another process behind the standard HTTP front end
    (the Cluster Serving shape: a router node and worker nodes).
    ``submit`` POSTs ``/predict`` with the trace id in
    ``X-Zoo-Trace-Id``, so one trace spans the router's dispatch and
    the remote queue, pad and execute; remote 503/504 come back as
    :class:`QueueFullError` / :class:`DeadlineExpiredError` and take
    the same retry and backpressure paths as in-process replicas.

    JSON carries no dtype, so remote replicas serve single-output
    float32 models."""

    def __init__(self, url: str, name: Optional[str] = None,
                 timeout_s: float = 30.0, workers: int = 4,
                 clock: Callable[[], float] = time.monotonic):
        self.url = url.rstrip("/")
        super().__init__(name or _name_of(self.url), clock)
        self.timeout_s = float(timeout_s)
        self._workers = int(workers)
        self._pool: Optional[ThreadPoolExecutor] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "HttpReplica":
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._workers,
                thread_name_prefix=f"zoo-fleet-{self.name}")
        self._set_admitting()
        return self

    def stop(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        self._set_stopped()

    def drain(self, timeout: float = 30.0) -> bool:
        if not self._begin_drain():
            return True
        return self._drain_wait(timeout)

    def restart(self) -> "HttpReplica":
        return self.start()

    # -- transport -----------------------------------------------------------
    def batchable(self, xs) -> bool:
        # the remote front end batches for itself; anything row-aligned
        # can take the future path
        if not xs or not all(isinstance(x, np.ndarray) and x.ndim >= 1
                             for x in xs):
            return False
        n = xs[0].shape[0]
        return n >= 1 and all(x.shape[0] == n for x in xs)

    def submit(self, xs) -> "Future":
        ctx = tracing.current()  # forwarded as X-Zoo-Trace-Id
        return self._pool.submit(self._post_predict, list(xs), ctx)

    def predict(self, inputs, timeout_ms: int = -1):
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        return self._post_predict([np.asarray(x) for x in xs],
                                  tracing.current())

    def _post_predict(self, xs, ctx):
        if len(xs) == 1:
            inputs = xs[0].tolist()
        else:
            inputs = [{"data": x.tolist()} for x in xs]
        t0 = time.time()
        payload = _post_json(self.url + "/predict", self.name,
                             {"inputs": inputs}, ctx, self.timeout_s)
        tracing.record_span(ctx, "fleet/remote_predict", t0,
                            time.time() - t0, replica=self.name)
        return np.asarray(payload["outputs"], np.float32)

    def probe(self) -> bool:
        return _health_ok(self.url)

    def batcher_stats(self) -> dict:
        return {"enabled": False, "remote": self.url}

    def concurrency(self) -> int:
        return self._workers


def _replica_net(net):
    """A copy of ``net`` for one replica: its own layers and tensors
    (the layers hold the weights), without the compiled Estimator."""
    est = getattr(net, "_estimator", None)
    memo = {id(est): None} if est is not None else {}
    return copy.deepcopy(net, memo)


class ReplicaPool:
    """Owns the fleet's replicas. Either wrap built replicas
    (``ReplicaPool(replicas=[...])``; in-process and HTTP replicas mix)
    or give ``model_fn(ctx: ReplicaContext)``, which builds one model
    per device slice: the pool carves the devices (default
    ``cuda:0..n-1``, or exactly ``devices``) into ``n_replicas``
    disjoint slices of ``devices_per_replica``
    (``parallel.replica_device_slices``, which raises when the host
    cannot seat them) and wraps each model in a :class:`Replica`."""

    def __init__(self, model_fn: Optional[Callable] = None,
                 replicas: Optional[Sequence[_ReplicaBase]] = None,
                 n_replicas: Optional[int] = None,
                 devices_per_replica: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 batcher="auto",
                 batcher_kwargs: Optional[dict] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        if replicas is not None:
            if model_fn is not None:
                raise ValueError("pass model_fn OR replicas, not both")
            self.replicas = list(replicas)
        else:
            if model_fn is None:
                raise ValueError("need model_fn or replicas")
            from analytics_zoo_tpu_torch.parallel.mesh import (
                host_devices, replica_device_slices)
            if devices is None:
                devices = host_devices()
            k = devices_per_replica or _env_int(
                "ZOO_TPU_FLEET_DEVICES_PER_REPLICA", 1)
            n = n_replicas or _env_int("ZOO_TPU_FLEET_REPLICAS", 0) \
                or len(devices) // k
            slices = replica_device_slices(n, k, devices)
            self.replicas = []
            for i, sl in enumerate(slices):
                ctx = ReplicaContext(i, f"r{i}", sl)
                self.replicas.append(Replica(
                    ctx.name, model_fn(ctx), batcher=batcher,
                    batcher_kwargs=batcher_kwargs, clock=clock))
        if not self.replicas:
            raise ValueError("empty replica pool")
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")

    @classmethod
    def for_keras(cls, net, params=None,
                  example_inputs: Optional[Sequence] = None,
                  n_replicas: Optional[int] = None,
                  devices_per_replica: Optional[int] = None,
                  sharding: str = "auto",
                  devices: Optional[Sequence] = None,
                  concurrency: int = 1,
                  batcher="auto",
                  batcher_kwargs: Optional[dict] = None,
                  clock: Callable[[], float] = time.monotonic
                  ) -> "ReplicaPool":
        """N replicas of one in-memory net. Each replica serves its own
        copy of the net, with ``params`` (default: the net's own,
        initialised if it has none) copied onto its device by
        ``parallel.place_inference_params``: no replica shares a tensor
        with ``net`` or with another replica, and each warms its own
        bucket ladder on its own device. A slice of more than one
        device raises (tensor-parallel placement, ROADMAP A14)."""
        from analytics_zoo_tpu_torch.parallel.mesh import \
            place_inference_params
        from analytics_zoo_tpu_torch.pipeline.inference.inference_model \
            import InferenceModel
        if params is None:
            params = net.params() if net.initialized else net.init_params()

        def model_fn(ctx: ReplicaContext):
            placed = place_inference_params(params, ctx.devices,
                                            mode=sharding)
            rnet = _replica_net(net)
            rnet.load_params(placed, device=ctx.devices[0])
            im = InferenceModel(supported_concurrent_num=concurrency)
            im.load_keras_net(rnet, example_inputs=example_inputs)
            return im

        return cls(model_fn, n_replicas=n_replicas,
                   devices_per_replica=devices_per_replica,
                   devices=devices, batcher=batcher,
                   batcher_kwargs=batcher_kwargs, clock=clock)

    def start(self) -> "ReplicaPool":
        for r in self.replicas:
            r.start()
        _g_size().set(len(self.replicas))
        return self

    def stop(self):
        for r in self.replicas:
            try:
                r.stop()
            except Exception as e:
                logger.warning("fleet: stopping %s failed: %s", r.name, e)

    def __len__(self):
        return len(self.replicas)

    def __repr__(self):
        states = {r.name: r.state for r in self.replicas}
        return f"ReplicaPool({states})"


class FleetRouter:
    """The fleet's front door. Duck-types the model and the batcher
    surfaces of the front end, so ``make_inference_server(router)``
    serves the whole fleet.

    Dispatch: ``policy="least_loaded"`` picks the admitting replica
    with the fewest outstanding rows (ties rotate); ``policy="hash"``
    routes by consistent hash over a ring of ``vnodes`` virtual nodes
    per replica: the same payload (or ``key=``) lands on the same
    replica while it admits, the walk passing replicas that do not."""

    def __init__(self, pool: ReplicaPool,
                 policy: Optional[str] = None,
                 max_retries: Optional[int] = None,
                 eject_after: Optional[int] = None,
                 probe_interval_s: Optional[float] = None,
                 vnodes: int = 64):
        self.pool = pool
        self.policy = policy or os.environ.get("ZOO_TPU_FLEET_POLICY",
                                               "least_loaded")
        if self.policy not in ("least_loaded", "hash"):
            raise ValueError(f"unknown fleet policy {self.policy!r} "
                             f"(least_loaded|hash)")
        self.max_retries = (max_retries if max_retries is not None
                            else _env_int("ZOO_TPU_FLEET_MAX_RETRIES", 2))
        self.eject_after = (eject_after if eject_after is not None
                            else _env_int("ZOO_TPU_FLEET_EJECT_AFTER", 3))
        self.probe_interval_s = (
            probe_interval_s if probe_interval_s is not None
            else _env_float("ZOO_TPU_FLEET_PROBE_S", 2.0))
        self._clock = pool.clock
        self._rr = 0  # least-loaded tie-breaker
        self._rr_lock = threading.Lock()
        self._ring = self._build_ring(vnodes)
        self._prober: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # the canary split the rollout controller installs:
        # {"version", "baseline", "pct"} or None
        self._canary: Optional[dict] = None
        self._cohort_rr = 0  # keyless traffic's bucket rotation
        self._rollout = None  # the active or last RolloutController
        # the federation collector, made on start()
        self.telemetry = None

    # -- the model surface ---------------------------------------------------
    @property
    def example_input_specs(self):
        for r in self.pool.replicas:
            specs = r.input_specs()
            if specs:
                return specs
        return None

    @property
    def concurrent_slots_free(self) -> int:
        return sum(r.slots_free() for r in self.pool.replicas
                   if r.admitting())

    @property
    def supported_concurrent_num(self) -> int:
        return max(1, sum(r.concurrency() for r in self.pool.replicas))

    def predict(self, inputs, timeout_ms: int = -1):
        """The per-request path (inputs the batcher cannot coalesce):
        a synchronous dispatch with :meth:`submit`'s sibling retry and
        failure accounting."""
        _c_requests().inc()
        tried: set = set()
        last_exc: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            r = self._pick(rows=1, key=None, exclude=tried)
            if r is None:
                break
            t0 = time.time()
            try:
                with obs.span("fleet/dispatch", replica=r.name,
                              attempt=attempt, path="predict"):
                    r.note_dispatch(1)
                    try:
                        out = r.predict(inputs, timeout_ms=timeout_ms)
                    finally:
                        r.note_done(1)
                r.note_success()
                _c_cohort_requests(r.version).inc()
                dt = time.time() - t0
                _h_cohort_latency(r.version).observe(dt)
                _h_replica_latency(r.name).observe(dt)
                return out
            except (QueueFullError, DeadlineExpiredError):
                raise  # backpressure or a deadline: not a replica fault
            except Exception as e:
                last_exc = e
                tried.add(r.name)
                self._note_attempt_error(r, e)
                if attempt < self.max_retries:
                    _c_retries().inc()
        _c_failed().inc()
        if last_exc is not None:
            raise last_exc
        raise ReplicaUnavailableError(self._soonest_probe_s())

    # -- the batcher surface -------------------------------------------------
    def batchable(self, xs) -> bool:
        for r in self.pool.replicas:
            if r.admitting():
                return r.batchable(xs)
        return False

    def submit(self, xs, key: Optional[bytes] = None) -> "Future":
        """Dispatch one row-aligned request to a replica's batcher.
        Returns a router-level future: a replica failing mid-request
        sends the rows to a sibling (never rows whose future resolved),
        a bounded number of times, then the failure surfaces. A fleet
        with every queue full resolves it with
        :class:`FleetSaturatedError` (503 + the minimum Retry-After)."""
        xs = [np.asarray(x) for x in xs]
        if not self.batchable(xs):
            raise ValueError(
                "inputs are not row-aligned (every input needs the "
                "same leading dimension >= 1)")
        _c_requests().inc()
        fut: "Future" = Future()
        if key is None and self.policy == "hash":
            key = self._affinity_key(xs)
        self._dispatch(xs, xs[0].shape[0], fut, key, attempt=0,
                       exclude=frozenset(), ctx=tracing.current())
        return fut

    def stats(self) -> dict:
        """The ``/health`` "batcher" block: fleet totals and each
        replica's queue."""
        per = {r.name: r.batcher_stats() for r in self.pool.replicas}
        return {
            "enabled": True,
            "fleet": True,
            "replicas_total": len(self.pool),
            "replicas_admitting": sum(
                1 for r in self.pool.replicas if r.admitting()),
            "queue_depth": sum(p.get("queue_depth", 0)
                               for p in per.values()),
            "queue_capacity": sum(p.get("queue_capacity", 0)
                                  for p in per.values()),
            "per_replica": per,
        }

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetRouter":
        """Start every replica (each warms its own ladder), the prober
        (none when ``probe_interval_s <= 0``: call :meth:`tick`) and the
        federation collector."""
        self.pool.start()
        self._refresh_gauges()
        if self.probe_interval_s > 0 and self._prober is None:
            self._stop_evt.clear()
            self._prober = threading.Thread(
                target=self._probe_loop, name="zoo-fleet-prober",
                daemon=True)
            self._prober.start()
        if self.telemetry is None:
            from analytics_zoo_tpu_torch.common import federation
            self.telemetry = federation.TelemetryCollector(self)
        self.telemetry.start()
        return self

    def stop(self):
        self._stop_evt.set()
        if self._prober is not None:
            self._prober.join(timeout=5)
            self._prober = None
        if self.telemetry is not None:
            self.telemetry.stop()
        self.pool.stop()
        self._refresh_gauges()

    def _probe_loop(self):
        while not self._stop_evt.wait(self.probe_interval_s):
            try:
                self.tick()
            except Exception as e:  # the prober must not die
                logger.warning("fleet prober: %s", e)

    def tick(self, now: Optional[float] = None) -> dict:
        """One health pass: probe each down replica whose backoff has
        run out, re-admit it or double its backoff; then one pass of the
        active rollout. Called by the prober, or by hand with an
        injected ``now``. Returns :meth:`fleet_status`."""
        now = self._clock() if now is None else now
        for r in self.pool.replicas:
            with r._lock:
                due = (r.state == DOWN and r.down_reason != "stopped"
                       and r.next_probe_at <= now)
            if not due:
                continue
            if r.probe():
                try:
                    r.restart()
                except Exception as e:
                    logger.warning("fleet: restart of %s failed: %s",
                                   r.name, e)
                    r.backoff_bump(now)
                    continue
                _c_readmissions(r.name).inc()
                obs.event("fleet/readmitted", replica=r.name)
                logger.info("fleet: replica %s re-admitted", r.name)
            else:
                r.backoff_bump(now)
        self._refresh_gauges()
        rollout = self._rollout
        if rollout is not None and rollout.in_progress:
            try:
                rollout.tick(now=now)
            except Exception as e:  # the prober must not die
                logger.warning("fleet: rollout tick failed: %s", e)
        return self.fleet_status()

    def drain(self, name: str, timeout: float = 30.0) -> bool:
        """Drain one replica by name (stop admitting, flush, stop its
        batcher); :meth:`restart_replica` completes a rolling reload."""
        ok = self._replica(name).drain(timeout=timeout)
        self._refresh_gauges()
        return ok

    def restart_replica(self, name: str):
        """Re-admit a drained replica (its ladder is warmed again for a
        model reloaded in between)."""
        r = self._replica(name)
        r.restart()
        self._refresh_gauges()
        return r

    def _replica(self, name: str) -> _ReplicaBase:
        for r in self.pool.replicas:
            if r.name == name:
                return r
        raise KeyError(f"no replica named {name!r}")

    # -- versioned rollout ---------------------------------------------------
    def rollout(self, version, canary_pct: int = 25, **kwargs):
        """Warm-swap the fleet to ``version`` (a
        :class:`~analytics_zoo_tpu_torch.pipeline.inference.registry.
        ModelVersion`, or anything with ``name`` and ``load_into``):
        drain one replica at a time behind the router, then route
        ``canary_pct``% of traffic to the new version and watch its
        cohort's errors. The canary bakes clean and is promoted to the
        rest of the fleet, or breaches and is rolled back through the
        same drain path. Returns the
        :class:`~analytics_zoo_tpu_torch.pipeline.inference.registry.
        RolloutController` (``GET /debug/rollout``); ``kwargs`` go to
        it (``bake_s``, ``max_canary_errors``, ...). The prober drives
        its ``tick``; without one call ``router.tick()``."""
        from analytics_zoo_tpu_torch.pipeline.inference.registry import \
            RolloutController
        active = self._rollout
        if active is not None and active.in_progress:
            raise RuntimeError(
                f"rollout of {active.version_name} still "
                f"{active.state}; finish or roll it back first")
        ctl = RolloutController(self, version, canary_pct=canary_pct,
                                **kwargs)
        self._rollout = ctl
        ctl.begin()
        return ctl

    def rollout_status(self) -> dict:
        """The ``GET /debug/rollout`` payload (``idle`` when no rollout
        ever ran)."""
        if self._rollout is None:
            return {"state": "idle", "canary": self._canary}
        st = self._rollout.status()
        st["canary"] = self._canary
        return st

    # -- dispatch ------------------------------------------------------------
    def _affinity_key(self, xs) -> bytes:
        """The content key of hash routing: shapes, dtypes and the
        first 1 KiB of each input's bytes."""
        h = hashlib.blake2b(digest_size=8)
        for x in xs:
            h.update(str(x.shape).encode())
            h.update(str(x.dtype).encode())
            h.update(x.tobytes()[:1024])
        return h.digest()

    def _build_ring(self, vnodes: int):
        ring = []
        for r in self.pool.replicas:
            for v in range(vnodes):
                hv = int.from_bytes(
                    hashlib.blake2b(f"{r.name}#{v}".encode(),
                                    digest_size=8).digest(), "big")
                ring.append((hv, r))
        ring.sort(key=lambda t: t[0])
        self._ring_keys = [t[0] for t in ring]
        return ring

    def _cohort_version(self, key: Optional[bytes]) -> Optional[str]:
        """The version this request's cohort should land on, or None
        without a canary split. Keyed traffic buckets by its affinity
        key (a payload never flaps between versions); keyless traffic
        rotates ``pct``% round-robin."""
        canary = self._canary
        if not canary:
            return None
        if key is not None:
            hv = int.from_bytes(hashlib.blake2b(
                b"cohort:" + key, digest_size=8).digest(), "big")
            bucket = hv % 100
        else:
            with self._rr_lock:
                self._cohort_rr = (self._cohort_rr + 1) % 100
                bucket = self._cohort_rr
        if bucket < canary["pct"]:
            return canary["version"]
        return canary["baseline"]

    def set_canary(self, version: str, baseline: str, pct: int):
        """Install a canary split: ``pct``% of requests prefer replicas
        serving ``version``, the rest ``baseline``. A preference, not a
        wall: when a cohort's replicas are all down or draining its
        traffic spills to the other cohort."""
        self._canary = {"version": str(version),
                        "baseline": str(baseline),
                        "pct": max(0, min(100, int(pct)))}
        obs.event("rollout/canary_split", version=version,
                  baseline=baseline, pct=self._canary["pct"])

    def clear_canary(self):
        self._canary = None

    def _pick_hash(self, key: bytes, exclude: set,
                   prefer_version: Optional[str] = None
                   ) -> Optional[_ReplicaBase]:
        if not self._ring:
            return None
        hv = int.from_bytes(
            hashlib.blake2b(key, digest_size=8).digest(), "big")
        start = bisect.bisect_left(self._ring_keys, hv)
        n = len(self._ring)
        fallback = None
        seen: set = set()
        for i in range(n):
            _, r = self._ring[(start + i) % n]
            if r.name in seen:
                continue
            seen.add(r.name)
            if r.name not in exclude and r.admitting():
                if prefer_version is None or r.version == prefer_version:
                    return r
                if fallback is None:
                    fallback = r  # the other cohort, but admitting
        return fallback

    def _pick(self, rows: int, key: Optional[bytes],
              exclude: set) -> Optional[_ReplicaBase]:
        prefer = self._cohort_version(key)
        if key is not None:
            return self._pick_hash(key, exclude, prefer)
        cands = [r for r in self.pool.replicas
                 if r.admitting() and r.name not in exclude]
        if not cands:
            return None
        if prefer is not None:
            cohort = [r for r in cands if r.version == prefer]
            if cohort:  # spill to the other cohort only when empty
                cands = cohort
        lo = min(r.outstanding_rows for r in cands)
        ties = [r for r in cands if r.outstanding_rows == lo]
        with self._rr_lock:
            self._rr += 1
            return ties[self._rr % len(ties)]

    def _soonest_probe_s(self) -> float:
        """The retry hint when nothing admits: time to the next revival
        probe (at least 0.05 s)."""
        now = self._clock()
        waits = [max(0.05, r.next_probe_at - now)
                 for r in self.pool.replicas if r.state == DOWN]
        return min(waits) if waits else 1.0

    def _note_attempt_error(self, r, exc):
        """An attempt the replica worked on and failed: count it for its
        version's cohort (a sick canary trips the rollout's burst rule
        even when it fails at admission) and against the replica."""
        _c_cohort_requests(r.version).inc()
        _c_cohort_errors(r.version).inc()
        _c_replica_errors(r.name).inc()
        self._note_replica_failure(r, exc)

    def _dispatch(self, xs, rows, fut, key, attempt, exclude, ctx):
        """Pick a replica and hand it the rows; on a synchronous
        queue-full try the next; when every admitting replica is full
        resolve with the fleet's 503 (the minimum hint)."""
        tried = set(exclude)
        busy_hints = []
        while True:
            r = self._pick(rows, key, tried)
            if r is None:
                _c_failed().inc()
                if busy_hints:
                    _c_saturated().inc()
                    self._fail(fut, FleetSaturatedError(
                        len(busy_hints), min(busy_hints)))
                else:
                    self._fail(fut, ReplicaUnavailableError(
                        self._soonest_probe_s()))
                return
            t0 = time.time()
            try:
                inner = r.submit(xs)
            except QueueFullError as e:
                busy_hints.append(e.retry_after_s)
                tried.add(r.name)
                continue
            except Exception as e:  # failed at admission
                tried.add(r.name)
                self._note_attempt_error(r, e)
                continue
            r.note_dispatch(rows)
            tracing.record_span(ctx, "fleet/dispatch", t0,
                                time.time() - t0, replica=r.name,
                                rows=rows, attempt=attempt)
            inner.add_done_callback(
                lambda f, r=r, t0=t0: self._on_replica_done(
                    r, f, xs, rows, fut, key, attempt, exclude, ctx,
                    t0))
            return

    def _on_replica_done(self, r, inner, xs, rows, fut, key, attempt,
                         exclude, ctx, t0=None):
        """A replica's future resolved. Success and a deadline
        propagate; a queue-full retries a sibling without counting
        against the replica; anything else counts against it (ejection
        past the threshold) and sends the rows to a sibling. The router
        future resolves exactly once."""
        r.note_done(rows)
        exc = inner.exception()
        # every attempt the replica worked on counts for its version (a
        # queue-full never reached the model)
        if not isinstance(exc, QueueFullError):
            _c_cohort_requests(r.version).inc()
            if t0 is not None:
                dt = time.time() - t0
                _h_cohort_latency(r.version).observe(dt)
                _h_replica_latency(r.name).observe(dt)
            if exc is not None and not isinstance(exc,
                                                  DeadlineExpiredError):
                _c_cohort_errors(r.version).inc()
                _c_replica_errors(r.name).inc()
        if exc is None:
            r.note_success()
            self._resolve(fut, inner.result())
            return
        if isinstance(exc, DeadlineExpiredError):
            _c_failed().inc()
            self._fail(fut, exc)
            return
        if not isinstance(exc, QueueFullError):
            self._note_replica_failure(r, exc)
        if attempt >= self.max_retries:
            _c_failed().inc()
            self._fail(fut, exc)
            return
        _c_retries().inc()
        tracing.record_span(ctx, "fleet/retry", time.time(), 0.0,
                            replica=r.name, rows=rows,
                            attempt=attempt + 1,
                            error=type(exc).__name__)
        with tracing.activate(ctx):
            self._dispatch(xs, rows, fut, key, attempt + 1,
                           set(exclude) | {r.name}, ctx)

    def _note_replica_failure(self, r, exc):
        fails = r.note_failure()
        logger.warning("fleet: dispatch to %s failed (%s: %s), "
                       "consecutive=%d", r.name, type(exc).__name__, exc,
                       fails)
        if fails >= self.eject_after and r.admitting():
            r.mark_down(f"{type(exc).__name__}: {exc}", now=self._clock())
            self._refresh_gauges()

    @staticmethod
    def _resolve(fut, value):
        try:
            fut.set_result(value)
        except Exception:
            pass  # already resolved

    @staticmethod
    def _fail(fut, exc):
        try:
            fut.set_exception(exc)
        except Exception:
            pass

    # -- introspection -------------------------------------------------------
    def _refresh_gauges(self):
        _g_admitting().set(sum(
            1 for r in self.pool.replicas if r.admitting()))
        _g_size().set(len(self.pool))

    def fleet_status(self) -> dict:
        """The ``GET /debug/fleet`` payload: topology and each
        replica's lifecycle state."""
        return {
            "policy": self.policy,
            "max_retries": self.max_retries,
            "eject_after": self.eject_after,
            "probe_interval_s": self.probe_interval_s,
            "replicas_admitting": sum(
                1 for r in self.pool.replicas if r.admitting()),
            "canary": self._canary,
            "replicas": [r.status() for r in self.pool.replicas],
        }

    def __repr__(self):
        return (f"FleetRouter(policy={self.policy}, "
                f"replicas={len(self.pool)})")


# -- disaggregated generation (prefill and decode pools) ----------------------

def _c_handoff_retries():
    return obs.counter(
        "zoo_tpu_serving_gen_handoff_retries_total",
        help="handoffs retried after a pool replica failed "
             "mid-flight (the blob re-prefills on a sibling)")


class DisaggReplica(_ReplicaBase):
    """One in-process replica of a disaggregated pool: a
    :class:`GenerationEngine` of role ``"prefill"`` or ``"decode"`` and
    its own :class:`ContinuousBatcher`. The prefill side returns
    handoff blobs; the decode side consumes them."""

    def __init__(self, name: str, engine,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(name, clock)
        self.engine = engine
        self.role = getattr(engine, "role", "both")
        self.batcher = ContinuousBatcher(engine)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "DisaggReplica":
        self.batcher.start()
        self._set_admitting()
        return self

    def stop(self):
        self.batcher.stop()
        self._set_stopped()

    def drain(self, timeout: float = 30.0) -> bool:
        if not self._begin_drain():
            return True
        flushed = self.batcher.drain(timeout=timeout)
        with self._lock:
            self.state = DRAINED
        return flushed

    def restart(self) -> "DisaggReplica":
        self.batcher.start()
        self._set_admitting()
        return self

    def probe(self) -> bool:
        return True  # in-process: alive while its loop thread is

    # -- generation transport ------------------------------------------------
    def prefill(self, prompt_ids, max_new: int,
                temperature: float) -> "Future":
        """A future resolving to the handoff blob (a host dict)."""
        return self.batcher.submit_prefill(
            prompt_ids, max_new_tokens=max_new, temperature=temperature)

    def decode(self, blob: dict, max_new: int, eos_id) -> "Future":
        """A future resolving to the whole new-token stream."""
        return self.batcher.submit_handoff(
            blob, max_new_tokens=max_new, eos_id=eos_id)

    # -- introspection -------------------------------------------------------
    def free_pages(self) -> int:
        return int(self.engine.free_pages)

    def total_pages(self) -> int:
        return int(self.engine.allocator.max_pages)

    def batcher_stats(self) -> dict:
        return self.batcher.stats()

    def status(self) -> dict:
        st = super().status()
        st["pages_free"] = self.free_pages()
        st["pages_total"] = self.total_pages()
        return st


class HttpDisaggReplica(_ReplicaBase):
    """A disaggregated-pool replica in another process behind the HTTP
    front end: ``prefill`` POSTs ``/generate/prefill`` (the blob comes
    back in the base64 wire form, ``ops/kv_cache.handoff_to_wire``),
    ``decode`` POSTs ``/generate/handoff``. The trace id rides
    ``X-Zoo-Trace-Id`` on both legs. Page headroom comes from the
    remote ``/health`` generator block, cached for half a second (a
    stale count costs balance, never correctness)."""

    def __init__(self, url: str, role: str, name: Optional[str] = None,
                 timeout_s: float = 60.0, workers: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        self.url = url.rstrip("/")
        super().__init__(name or _name_of(self.url), clock)
        if role not in ("prefill", "decode", "both"):
            raise ValueError(f"bad pool role {role!r}")
        self.role = role
        self.timeout_s = float(timeout_s)
        self._workers = int(workers)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pages_cache = (0.0, 0, 0)  # (stamp, free, total)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "HttpDisaggReplica":
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._workers,
                thread_name_prefix=f"zoo-disagg-{self.name}")
        self._set_admitting()
        return self

    def stop(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        self._set_stopped()

    def restart(self) -> "HttpDisaggReplica":
        return self.start()

    # -- transport -----------------------------------------------------------
    def _post(self, path: str, payload: dict, ctx):
        t0 = time.time()
        out = _post_json(self.url + path, self.name, payload, ctx,
                         self.timeout_s)
        tracing.record_span(ctx, "fleet/remote_generate", t0,
                            time.time() - t0, replica=self.name,
                            path=path)
        return out

    def prefill(self, prompt_ids, max_new: int,
                temperature: float) -> "Future":
        from analytics_zoo_tpu_torch.ops.kv_cache import \
            handoff_from_wire
        ctx = tracing.current()

        def run():
            out = self._post("/generate/prefill", {
                "prompt": [int(t) for t in prompt_ids],
                "max_new_tokens": int(max_new),
                "temperature": float(temperature)}, ctx)
            return handoff_from_wire(out["handoff"])

        return self._pool.submit(run)

    def decode(self, blob: dict, max_new: int, eos_id) -> "Future":
        from analytics_zoo_tpu_torch.ops.kv_cache import handoff_to_wire
        ctx = tracing.current()

        def run():
            out = self._post("/generate/handoff", {
                "handoff": handoff_to_wire(blob),
                "max_new_tokens": int(max_new),
                "eos_id": eos_id}, ctx)
            return np.asarray(out["tokens"], np.int32)

        return self._pool.submit(run)

    def probe(self) -> bool:
        return _health_ok(self.url)

    # -- introspection -------------------------------------------------------
    def _pages(self) -> "tuple[int, int]":
        import urllib.request
        now = time.monotonic()
        stamp, free, total = self._pages_cache
        if now - stamp < 0.5:
            return free, total
        try:
            with urllib.request.urlopen(self.url + "/health",
                                        timeout=5.0) as resp:
                gen = json.loads(resp.read()).get("generator") or {}
            free = int(gen.get("free_pages", 0))
            total = int(gen.get("total_pages", 0))
        except Exception:
            free, total = 0, 0  # unknown: route elsewhere first
        self._pages_cache = (now, free, total)
        return free, total

    def free_pages(self) -> int:
        return self._pages()[0]

    def total_pages(self) -> int:
        return self._pages()[1]

    def batcher_stats(self) -> dict:
        return {"enabled": False, "remote": self.url}

    def status(self) -> dict:
        st = super().status()
        free, total = self._pages()
        st["pages_free"] = free
        st["pages_total"] = total
        return st


class DisaggRouter:
    """The ``/generate`` front door of a disaggregated fleet
    (prefill/decode separation as in DistServe and Splitwise):
    admission goes to the least-loaded **prefill** replica, which runs
    the prompt to its first token and exports a KV-page handoff blob;
    the router ships the blob (a dict in process, base64 pages over
    HTTP) to the **decode** replica with the most free pages, whose
    future resolves the whole stream.

    Duck-types the gen-batcher surface (``submit`` / ``stats`` /
    ``start`` / ``stop``), so the front end mounts it as
    ``gen_batcher``; ``serving._resolve_gen_batcher`` builds one when
    ``ZOO_TPU_DISAGG`` is set.

    **Exactly once.** The router's future resolves once. A replica
    failing mid-handoff fails only its leg: the blob is dropped (the
    prefill side reclaimed its pages at export) and the request
    re-prefills from the original prompt on a surviving replica;
    greedy decoding is deterministic, so the retried stream is the
    same."""

    def __init__(self, prefill_replicas, decode_replicas, *,
                 max_retries: Optional[int] = None,
                 request_timeout_s: Optional[float] = None,
                 eject_after: int = 1):
        self.prefill = list(prefill_replicas)
        self.decode = list(decode_replicas)
        if not self.prefill or not self.decode:
            raise ValueError("DisaggRouter needs >= 1 prefill and >= 1 "
                             "decode replica")
        self.max_retries = (max_retries if max_retries is not None
                            else _env_int("ZOO_TPU_FLEET_MAX_RETRIES", 2))
        self.request_timeout_s = (
            request_timeout_s if request_timeout_s is not None
            else _env_float("ZOO_TPU_DISAGG_TIMEOUT_S", 120.0))
        self.eject_after = max(1, int(eject_after))
        self._clock = time.monotonic
        self._pool: Optional[ThreadPoolExecutor] = None

    @classmethod
    def for_engine(cls, engine, n_prefill: Optional[int] = None,
                   n_decode: Optional[int] = None,
                   **kwargs) -> "DisaggRouter":
        """An in-process disaggregated fleet from one template engine:
        ``n_prefill`` engines of role "prefill" and ``n_decode`` of role
        "decode" on the template's net, params, device and cache
        geometry (``ZOO_TPU_DISAGG_PREFILL_REPLICAS`` /
        ``ZOO_TPU_DISAGG_DECODE_REPLICAS``, both 1 by default). Each
        owns its own cache; the template itself serves nothing."""
        from analytics_zoo_tpu_torch.pipeline.inference.generation import \
            GenerationEngine
        if getattr(engine, "spec_k", 0) > 0:
            raise ValueError(
                "speculative decoding is incompatible with "
                "disaggregated pools (unset ZOO_TPU_SPEC_K or "
                "ZOO_TPU_DISAGG)")
        if n_prefill is None:
            n_prefill = _env_int("ZOO_TPU_DISAGG_PREFILL_REPLICAS", 1)
        if n_decode is None:
            n_decode = _env_int("ZOO_TPU_DISAGG_DECODE_REPLICAS", 1)

        def make(role, i):
            eng = GenerationEngine(
                engine.net, engine.params,
                max_slots=engine.max_slots,
                max_context=engine.max_context,
                page_size=engine.page_size,
                top_k=engine.top_k,
                cache_dtype=engine.cache_dtype,
                prefill_chunk=(engine.prefill_chunk
                               if role == "prefill" else 0),
                role=role, device=engine.device)
            return DisaggReplica(f"{role}{i}", eng)

        return cls([make("prefill", i) for i in range(n_prefill)],
                   [make("decode", i) for i in range(n_decode)],
                   **kwargs)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "DisaggRouter":
        for r in self.prefill + self.decode:
            r.start()
        if self._pool is None:
            # each request in flight parks one worker on a pool future;
            # sized past the pools' slots so the router never queues
            # ahead of their own admission
            workers = 8 * (len(self.prefill) + len(self.decode))
            self._pool = ThreadPoolExecutor(
                max_workers=max(32, workers),
                thread_name_prefix="zoo-disagg-router")
        _g_size().set(len(self.prefill) + len(self.decode))
        self._refresh_gauges()
        return self

    def stop(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        for r in self.prefill + self.decode:
            try:
                r.stop()
            except Exception as e:
                logger.warning("disagg: stopping %s failed: %s",
                               r.name, e)
        self._refresh_gauges()

    def _refresh_gauges(self):
        _g_admitting().set(sum(1 for r in self.prefill + self.decode
                               if r.admitting()))

    # -- request path --------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32,
               temperature: float = 0.0, eos_id=None) -> "Future":
        """The gen-batcher surface: a future resolving to the 1-D int32
        array of new tokens, greedy streams equal to a colocated
        engine's."""
        ids = [int(t) for t in prompt_ids]
        _c_requests().inc()
        fut: "Future" = Future()
        ctx = tracing.current()
        self._pool.submit(self._run_request, ids, int(max_new_tokens),
                          float(temperature), eos_id, fut, ctx)
        return fut

    def _pick_prefill(self, exclude: set):
        cands = [r for r in self.prefill
                 if r.admitting() and r.name not in exclude]
        if not cands:
            return None
        return min(cands, key=lambda r: r.outstanding_rows)

    def _pick_decode(self, exclude: set):
        cands = [r for r in self.decode
                 if r.admitting() and r.name not in exclude]
        if not cands:
            return None
        # page headroom is the decode pool's capacity
        return max(cands, key=lambda r: r.free_pages())

    def _note_failure(self, r, exc):
        fails = r.note_failure()
        _c_replica_errors(r.name).inc()
        logger.warning("disagg: %s leg on %s failed (%s: %s)", r.role,
                       r.name, type(exc).__name__, exc)
        if fails >= self.eject_after and r.admitting():
            r.mark_down(f"{type(exc).__name__}: {exc}",
                        now=self._clock())
            self._refresh_gauges()

    def _run_request(self, ids, max_new, temperature, eos_id, fut, ctx):
        with tracing.activate(ctx):
            try:
                toks = self._generate_once(ids, max_new, temperature,
                                           eos_id)
            except Exception as exc:
                _c_failed().inc()
                FleetRouter._fail(fut, exc)
                return
        FleetRouter._resolve(fut, toks)

    def _leg(self, r, span: str, call, **fields):
        """Run one leg on replica ``r``: the call's future, waited for
        within the request timeout, with the replica's accounting."""
        t0 = time.time()
        with obs.span(span, replica=r.name, **fields):
            r.note_dispatch(1)
            try:
                out = call().result(self.request_timeout_s)
            finally:
                r.note_done(1)
        r.note_success()
        _h_replica_latency(r.name).observe(time.time() - t0)
        return out

    def _generate_once(self, ids, max_new, temperature, eos_id):
        bad_p: set = set()
        bad_d: set = set()
        busy_hints: "list[float]" = []
        last_exc: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                _c_retries().inc()
                _c_handoff_retries().inc()
            # leg 1: prefill to the first token and the handoff blob
            p = self._pick_prefill(bad_p)
            if p is None:
                break
            try:
                blob = self._leg(
                    p, "fleet/prefill_dispatch",
                    lambda: p.prefill(ids, max_new, temperature),
                    attempt=attempt)
            except QueueFullError as e:
                busy_hints.append(e.retry_after_s)
                bad_p.add(p.name)  # full, not dead: skip it
                continue
            except ValueError:
                raise  # a client error: no retry can fix the request
            except Exception as e:
                last_exc = e
                bad_p.add(p.name)
                self._note_failure(p, e)
                continue
            first = int(blob["last_token"])
            if (eos_id is not None and first == eos_id) or max_new <= 1:
                # done at prefill: no pages to ship
                return np.asarray([first], np.int32)
            # leg 2: ship the pages, resume decoding
            d = self._pick_decode(bad_d)
            if d is None:
                break
            try:
                toks = self._leg(
                    d, "fleet/handoff",
                    lambda: d.decode(blob, max_new, eos_id),
                    attempt=attempt, seq_len=blob["seq_len"])
                return np.asarray(toks, np.int32)
            except QueueFullError as e:
                busy_hints.append(e.retry_after_s)
                bad_d.add(d.name)
                continue  # the blob is dropped; re-prefill
            except ValueError:
                raise
            except Exception as e:
                # a failure mid-handoff: the blob dies with the leg (the
                # prefill side reclaimed its pages at export, so nothing
                # leaks) and the request re-prefills from its prompt
                last_exc = e
                bad_d.add(d.name)
                self._note_failure(d, e)
                continue
        _c_failed().inc()
        if last_exc is not None:
            raise last_exc
        if busy_hints:
            _c_saturated().inc()
            raise FleetSaturatedError(len(busy_hints), min(busy_hints))
        raise ReplicaUnavailableError(1.0)

    # -- drain and introspection ---------------------------------------------
    def drain(self, timeout: float = 30.0) -> bool:
        ok = True
        for r in self.prefill + self.decode:
            if hasattr(r, "drain"):
                ok = r.drain(timeout=timeout) and ok
        self._refresh_gauges()
        return ok

    def _pool_block(self, replicas) -> dict:
        return {
            "replicas": len(replicas),
            "admitting": sum(1 for r in replicas if r.admitting()),
            "pages_free": sum(r.free_pages() for r in replicas),
            "pages_total": sum(r.total_pages() for r in replicas),
        }

    def stats(self) -> dict:
        """The ``/health`` "generator" block: each pool's page headroom
        and each replica's batcher."""
        out = {
            "enabled": True,
            "disagg": True,
            "pools": {
                "prefill": self._pool_block(self.prefill),
                "decode": self._pool_block(self.decode),
            },
            "per_replica": {r.name: r.batcher_stats()
                            for r in self.prefill + self.decode},
        }
        out["queue_depth"] = sum(
            p.get("queue_depth", 0) for p in out["per_replica"].values()
            if isinstance(p, dict))
        return out

    def fleet_status(self) -> dict:
        """The ``GET /debug/fleet`` payload of a disaggregated fleet:
        role-tagged replicas and each pool's page headroom."""
        return {
            "disagg": True,
            "max_retries": self.max_retries,
            "replicas_admitting": sum(
                1 for r in self.prefill + self.decode if r.admitting()),
            "pools": {
                "prefill": self._pool_block(self.prefill),
                "decode": self._pool_block(self.decode),
            },
            "replicas": [r.status() for r in self.prefill + self.decode],
        }

    def __repr__(self):
        return (f"DisaggRouter(prefill={len(self.prefill)}, "
                f"decode={len(self.decode)})")


def make_fleet_server(pool_or_router, port: int = 0,
                      prefer_native: bool = True):
    """Serve a fleet behind the standard front ends
    (:func:`~analytics_zoo_tpu_torch.pipeline.inference.serving.
    make_inference_server`: the native one where its library builds): a
    :class:`ReplicaPool` is wrapped in a :class:`FleetRouter` (pass a
    router to choose its policy and retries), mounted as both the model
    and the batcher (``/predict``, ``/health``, ``/metrics``,
    ``/debug/fleet``, ``/debug/rollout`` and the rest)."""
    from analytics_zoo_tpu_torch.pipeline.inference.serving import \
        make_inference_server
    router = pool_or_router
    if isinstance(router, ReplicaPool):
        router = FleetRouter(router)
    return make_inference_server(router, port=port,
                                 prefer_native=prefer_native,
                                 batcher=router)
