"""HTTP serving front end over InferenceModel (port of
``analytics_zoo_tpu/pipeline/inference/serving.py``): the web-service
boundary of the reference's ``AbstractInferenceModel``, a stdlib
HTTP/JSON endpoint with no framework.

POST /predict   {"inputs": [[...], ...]}  →  {"outputs": [[...], ...]}
POST /generate  {"prompt": [ids]} or {"prompts": [[ids], ...]}
     →  {"tokens": [...]} or {"tokens": [[...], ...]}
GET  /health    →  {"status": "ok", "free_slots": N, "batcher": {...}}
GET  /metrics   →  Prometheus text exposition
GET  /metrics/json  →  the registry snapshot as JSON
GET  /debug/traces[?n=20]  →  recent traces as JSON; ``?since=<seq>``
     switches to the incremental span scrape (cursor + new spans)
GET  /debug/trace/<id>[?chrome=1]  →  one trace's timeline from the
     local ring; ``chrome=1`` renders Perfetto JSON

Tracing: ``POST`` routes accept and echo an ``X-Zoo-Trace-Id`` header
(minted when absent); the request runs under that trace, so the
batcher's queue/pad/execute/scatter child spans and the model span land
in ``GET /debug/traces`` under one id. ``ZOO_TPU_TRACE=0`` disables it.

Requests go through a :class:`DynamicBatcher` by default
(``batching.py``); ``ZOO_TPU_SERVING_BATCH=0`` (or ``batcher=None``)
reverts to the per-request path. ``/generate`` goes through a
:class:`ContinuousBatcher` when the model has a generator
(``ZOO_TPU_GEN_BATCH=0`` or ``gen_batcher=None``: the sequential path).

Errors are structured JSON, ``{"error": {"code": N, "message": ...}}``,
with real status codes: 404 for unknown paths, 400 for malformed JSON,
a missing "inputs", uncoercible inputs or a bad prompt, 500
``kind="internal"`` for model and runtime failures, 501 for
``/generate`` without a generator, 503 (+ ``Retry-After``) when a queue
is full, 504 when a queued request's deadline expires. Each counts in
``zoo_tpu_serving_errors_total{kind=...}``.

Not ported yet, so they answer 404 as unknown paths: the fleet's and
disaggregation's routes (``/generate/prefill``, ``/generate/handoff``,
``/debug/fleet*``, ``/debug/rollout``, ``?fleet=1``), ``/debug/slo``,
``/debug/metrics/history``, ``/debug/dashboard`` and
``/debug/profile``, with the native front end
(``NativeInferenceServer``); ROADMAP A12.5 and A13.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlsplit

import numpy as np

from analytics_zoo_tpu_torch.common import diagnostics
from analytics_zoo_tpu_torch.common import observability as obs
from analytics_zoo_tpu_torch.common import tracing
from analytics_zoo_tpu_torch.pipeline.inference.batching import (
    ContinuousBatcher, DeadlineExpiredError, DynamicBatcher,
    QueueFullError)
from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
    InferenceModel

__all__ = ["InferenceServer", "make_inference_server", "handle_predict",
           "handle_generate"]


def _error_body(code: int, message: str, **extra) -> dict:
    err = {"code": code, "message": message}
    err.update(extra)
    return {"error": err}


def _count_error(kind: str):
    obs.counter("zoo_tpu_serving_errors_total",
                help="serving errors by kind",
                labels={"kind": kind}).inc()


def _record_request(path: str, status: int, dt: float):
    """Per-request telemetry. Query strings are stripped so label
    cardinality stays bounded."""
    path = path.split("?", 1)[0]
    obs.counter("zoo_tpu_serving_requests_total",
                help="HTTP requests served",
                labels={"path": path, "status": str(status)}).inc()
    obs.histogram("zoo_tpu_serving_request_seconds",
                  help="request latency (handler wall time)",
                  labels={"path": path}).observe(dt)


def _in_flight() -> "obs.Gauge":
    return obs.gauge("zoo_tpu_serving_in_flight",
                     help="requests currently being handled")


def _coerce_inputs(model: InferenceModel, inputs) -> "list":
    """JSON inputs → list of host arrays in the loaded model's declared
    example dtypes (an embedding model's integer ids stay integers); f32
    for a model that declared none. Raises ValueError/TypeError/KeyError
    on uncoercible payloads (ragged rows, non-numeric): a client
    error."""
    specs = model.example_input_specs

    def dtype_for(i: int):
        if specs is not None and i < len(specs):
            return specs[i][1]
        return np.float32

    if isinstance(inputs, list) and inputs and \
            isinstance(inputs[0], dict):
        return [np.asarray(d["data"], dtype_for(i))
                for i, d in enumerate(inputs)]
    return [np.asarray(inputs, dtype_for(0))]


def handle_predict(model: InferenceModel, body: bytes,
                   batcher: "Optional[DynamicBatcher]" = None
                   ) -> "Tuple[int, dict]":
    """The /predict contract: JSON body → (http_status, payload). With a
    ``batcher``, row-aligned requests ride the coalescing path; without
    one (or for inputs it cannot coalesce) the model runs per request."""
    try:
        req = json.loads(body)
    except (ValueError, UnicodeDecodeError) as e:
        _count_error("bad_json")
        return 400, _error_body(400, f"malformed JSON body: {e}")
    try:
        inputs = req["inputs"]
    except (KeyError, TypeError):
        _count_error("bad_request")
        return 400, _error_body(
            400, 'request must be a JSON object with an "inputs" key')
    try:
        xs = _coerce_inputs(model, inputs)
    except (ValueError, TypeError, KeyError) as e:
        _count_error("bad_request")
        return 400, _error_body(
            400, f"inputs are not coercible to arrays: {e}")
    try:
        if batcher is not None and batcher.batchable(xs):
            out = batcher.submit(xs).result()
        else:
            out = model.predict(xs if len(xs) > 1 else xs[0])
        if isinstance(out, list):
            if len(out) == 1:
                return 200, {"outputs": out[0].tolist()}
            return 200, {"outputs": [o.tolist() for o in out]}
        return 200, {"outputs": out.tolist()}
    except QueueFullError as e:
        # the batcher already counted kind="queue_full"
        return 503, _error_body(
            503, str(e), retry_after_s=round(e.retry_after_s, 3))
    except DeadlineExpiredError as e:
        # the batcher already counted kind="deadline_expired"
        return 504, _error_body(504, str(e))
    except Exception as e:  # serving boundary: report, not die
        _count_error("internal")
        return 500, _error_body(500, str(e), kind="internal")


def handle_generate(model: InferenceModel, body: bytes,
                    gen_batcher=None) -> "Tuple[int, dict]":
    """The /generate contract: JSON body → (http_status, payload).

    Request: ``{"prompt": [ids...]}`` (one sequence) or ``{"prompts":
    [[ids...], ...]}``, with optional ``max_new_tokens`` (32),
    ``temperature`` (0: greedy) and ``eos_id``. The response mirrors the
    request's shape, ``{"tokens": [...]}`` or ``{"tokens": [[...],
    ...]}``: the newly generated ids only (eos included when hit). With
    a :class:`ContinuousBatcher` the sequences join the live decode
    batch; without one they run the sequential ``generate``. 501 when
    the model has no generator."""
    try:
        req = json.loads(body)
    except (ValueError, UnicodeDecodeError) as e:
        _count_error("bad_json")
        return 400, _error_body(400, f"malformed JSON body: {e}")
    if not isinstance(req, dict) or \
            ("prompt" not in req) == ("prompts" not in req):
        _count_error("bad_request")
        return 400, _error_body(
            400, 'request must be a JSON object with exactly one of '
            '"prompt" (one token-id list) or "prompts" (a list of '
            'them)')
    if gen_batcher is None and getattr(model, "generator", None) is None:
        _count_error("no_generator")
        return 501, _error_body(
            501, "this server has no generative model loaded "
            "(InferenceModel.load_generator)")
    single = "prompt" in req
    prompts = [req["prompt"]] if single else req["prompts"]
    try:
        prompts = [[int(t) for t in p] for p in prompts]
        max_new = int(req.get("max_new_tokens", 32))
        temperature = float(req.get("temperature", 0.0))
        eos_id = req.get("eos_id")
        eos_id = None if eos_id is None else int(eos_id)
    except (TypeError, ValueError) as e:
        _count_error("bad_request")
        return 400, _error_body(
            400, f"prompts must be lists of token ids: {e}")
    try:
        if gen_batcher is not None:
            futures = [gen_batcher.submit(
                p, max_new_tokens=max_new, temperature=temperature,
                eos_id=eos_id) for p in prompts]
            outs = [f.result() for f in futures]
        else:
            outs = model.generate(prompts, max_new_tokens=max_new,
                                  temperature=temperature, eos_id=eos_id)
        toks = [[int(t) for t in o] for o in outs]
        return 200, {"tokens": toks[0] if single else toks}
    except QueueFullError as e:
        return 503, _error_body(
            503, str(e), retry_after_s=round(e.retry_after_s, 3))
    except ValueError as e:  # prompt/budget outside the cache bounds
        _count_error("bad_request")
        return 400, _error_body(400, str(e))
    except Exception as e:  # serving boundary: report, not die
        _count_error("internal")
        return 500, _error_body(500, str(e), kind="internal")


def _refresh_vitals() -> None:
    """The process vitals and build-info gauges, refreshed before each
    scrape renders (RSS, uptime, open fds, provenance)."""
    diagnostics.update_process_vitals()
    diagnostics.update_build_info()


def _health_payload(model: InferenceModel,
                    batcher: "Optional[DynamicBatcher]",
                    gen_batcher=None) -> dict:
    """The /health body: the model pool's capacity, the batcher's
    queue and bucket state and, with a generator, the continuous
    batcher's slot and page occupancy."""
    payload = {
        "status": "ok",
        "free_slots": model.concurrent_slots_free,
        "batcher": (batcher.stats() if batcher is not None
                    else {"enabled": False}),
    }
    if gen_batcher is not None:
        payload["generator"] = gen_batcher.stats()
    elif getattr(model, "generator", None) is not None:
        payload["generator"] = dict(model.generator.stats(),
                                    enabled=False)
    return payload


def _traces_payload(path: str) -> dict:
    """``GET /debug/traces[?n=20]``: the most recent traces from the
    ring, newest first; ``?since=<seq>`` returns the ring's cursor and
    every span recorded after ``seq`` (read under one lock: no loss, no
    duplicate)."""
    q = parse_qs(urlsplit(path).query)
    try:
        n = int(q.get("n", ["20"])[0])
    except ValueError:
        n = 20
    n = max(1, min(n, 200))
    if "since" in q:
        try:
            since = int(q["since"][0])
        except ValueError:
            since = 0
        seq, recs = tracing.get_store().records_since(since)
        return {"enabled": tracing.enabled(), "seq": seq,
                "spans": [r.to_dict() for r in recs]}
    return {"enabled": tracing.enabled(),
            "traces": tracing.get_store().recent(n)}


def _trace_payload(route: str, path: str) -> "Tuple[int, dict]":
    """``GET /debug/trace/<id>[?chrome=1]``: one trace's timeline from
    the local ring; ``chrome=1`` renders Perfetto JSON."""
    tid = route[len("/debug/trace/"):]
    chrome = parse_qs(urlsplit(path).query).get("chrome", ["0"])[0] == "1"
    recs = tracing.get_store().spans(tid)
    if not recs:
        _count_error("not_found")
        return 404, _error_body(404, f"unknown trace id {tid!r}")
    if chrome:
        return 200, {"traceEvents": tracing.chrome_events(
            [r.to_dict() for r in recs], source_lanes=True),
            "displayTimeUnit": "ms"}
    t0 = min(r.t_start for r in recs)
    t1 = max(r.t_start + r.dur_s for r in recs)
    return 200, {"trace_id": tid, "t_start": round(t0, 6),
                 "dur_s": round(t1 - t0, 6), "n_spans": len(recs),
                 "sources": ["router"],
                 "spans": [r.to_dict() for r in recs]}


def _resolve_gen_batcher(model: InferenceModel, gen_batcher):
    """``"auto"`` → a :class:`ContinuousBatcher` over the model's
    generator (None when it has none or ``ZOO_TPU_GEN_BATCH=0``:
    /generate then runs the sequential path); ``None`` or an instance
    pass through."""
    if gen_batcher == "auto":
        engine = getattr(model, "generator", None)
        if engine is None or os.environ.get("ZOO_TPU_GEN_BATCH",
                                            "1") == "0":
            return None
        return ContinuousBatcher(engine)
    return gen_batcher


def _resolve_batcher(model: InferenceModel, batcher):
    """``"auto"`` → the environment's batcher (None when
    ``ZOO_TPU_SERVING_BATCH=0``); ``None`` → per-request serving; a
    DynamicBatcher passes through."""
    if batcher == "auto":
        return DynamicBatcher.from_env(model)
    return batcher


class InferenceServer:
    """``ThreadingHTTPServer`` over an :class:`InferenceModel` (the
    module docstring lists the routes). :meth:`start` warms the
    batchers before it serves: every bucket of the declared signature
    and every generation program run once on the card."""

    def __init__(self, model: InferenceModel, host: str = "127.0.0.1",
                 port: int = 0, batcher="auto", gen_batcher="auto"):
        self.model = model
        self.batcher = _resolve_batcher(model, batcher)
        self.gen_batcher = _resolve_gen_batcher(model, gen_batcher)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code: int, payload: dict,
                       headers: Optional[dict] = None):
                self._reply_raw(code, json.dumps(payload).encode(),
                                "application/json", headers)

            def _reply_raw(self, code: int, body: bytes, ctype: str,
                           headers: Optional[dict] = None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                if code == 503:
                    try:
                        err = json.loads(body).get("error", {})
                    except ValueError:
                        err = {}
                    retry = err.get("retry_after_s")
                    if retry is not None:
                        self.send_header("Retry-After",
                                         str(max(1, math.ceil(retry))))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                t0 = time.perf_counter()
                _in_flight().inc()
                status = 0
                payload = None
                route = self.path.split("?", 1)[0]
                try:
                    if route == "/health":
                        status = 200
                        payload = _health_payload(
                            server.model, server.batcher,
                            server.gen_batcher)
                    elif route == "/metrics":
                        status = 200  # rendered after accounting
                        _refresh_vitals()
                    elif route == "/metrics/json":
                        status = 200
                        _refresh_vitals()
                        payload = {"ts": time.time(),
                                   "metrics": obs.snapshot()}
                    elif route == "/debug/traces":
                        status = 200
                        payload = _traces_payload(self.path)
                    elif route.startswith("/debug/trace/"):
                        status, payload = _trace_payload(route, self.path)
                    else:
                        status = 404
                        _count_error("not_found")
                        payload = _error_body(404, "not found",
                                              path=route)
                finally:
                    # account before replying: a client that scrapes
                    # /metrics right after a response sees its request
                    # counted (and in-flight back at 0)
                    _in_flight().dec()
                    _record_request(self.path, status,
                                    time.perf_counter() - t0)
                if payload is None:
                    self._reply_raw(status, obs.to_prometheus().encode(),
                                    "text/plain; version=0.0.4")
                else:
                    self._reply(status, payload)

            def do_POST(self):
                t0 = time.perf_counter()
                _in_flight().inc()
                status = 0
                trace_id = None
                route = self.path.split("?", 1)[0]
                try:
                    if route not in ("/predict", "/generate"):
                        status = 404
                        _count_error("not_found")
                        payload = _error_body(404, "not found",
                                              path=route)
                    else:
                        try:
                            n = int(self.headers.get("Content-Length", 0))
                            body = self.rfile.read(n)
                        except Exception as e:  # client gone
                            status = 400
                            _count_error("bad_request")
                            payload = _error_body(400, str(e))
                        else:
                            with tracing.trace(
                                    "serving/request",
                                    trace_id=self.headers.get(
                                        tracing.TRACE_HEADER),
                                    path=route) as tr:
                                if route == "/generate":
                                    status, payload = handle_generate(
                                        server.model, body,
                                        server.gen_batcher)
                                else:
                                    status, payload = handle_predict(
                                        server.model, body,
                                        batcher=server.batcher)
                                tr.annotate(status=status)
                            trace_id = tr.trace_id
                finally:
                    _in_flight().dec()
                    _record_request(route, status,
                                    time.perf_counter() - t0)
                self._reply(status, payload,
                            {tracing.TRACE_HEADER: trace_id}
                            if trace_id else None)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self, background: bool = True):
        """Warm and start the batchers, then serve (on a thread of its
        own unless ``background=False``)."""
        if self.batcher is not None:
            self.batcher.start()
        if self.gen_batcher is not None:
            self.gen_batcher.start()
        if background:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="zoo-tpu-http",
                daemon=True)
            self._thread.start()
        else:
            self._httpd.serve_forever()
        return self

    def stop(self):
        """Stop serving, close the socket and stop the batchers."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        if self.batcher is not None:
            self.batcher.stop()
        if self.gen_batcher is not None:
            self.gen_batcher.stop()


def make_inference_server(model: InferenceModel, port: int = 0,
                          batcher="auto", gen_batcher="auto"):
    """The stdlib front end (the reference's native C++ one is not
    ported). ``batcher``: ``"auto"`` (environment-configured dynamic
    batching), ``None`` (per request) or a :class:`DynamicBatcher`;
    ``gen_batcher``: the same for /generate (``"auto"`` mounts a
    :class:`ContinuousBatcher` when the model has a generator)."""
    return InferenceServer(model, port=port, batcher=batcher,
                           gen_batcher=gen_batcher)
