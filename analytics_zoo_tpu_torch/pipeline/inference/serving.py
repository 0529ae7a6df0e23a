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

The judgement layer (``common/slo.py``, ``timeseries.py``,
``forecast.py``, ``federation.py``):

GET  /debug/slo[?tick=0]  →  the SLO engine's objectives and their states
     (ticks the engine first unless ``tick=0``)
GET  /debug/metrics/history[?family=&window=&sample=0&fleet=1]  →
     windowed series of one family, or the known families and the
     store's stats; 400 for a window that is not a positive number
GET  /debug/dashboard[?fleet=1]  →  a self-contained HTML page over the
     two routes above
POST /debug/profile {"dir", "ms"}  →  a ``torch.profiler`` capture (CPU
     and, on the card, CUDA activity) of ``ms`` milliseconds written as
     a Chrome trace into ``dir`` on a background thread; 503 while one
     runs

With a federation ``TelemetryCollector`` mounted as the batcher's
``telemetry`` attribute (a started ``FleetRouter`` makes one):
``GET /metrics?fleet=1`` (merged Prometheus text),
``GET /debug/fleet/telemetry`` (the collector's state),
``GET /debug/traces?fleet=1`` and a stitched ``GET /debug/trace/<id>``;
without one the first two answer 404. :meth:`InferenceServer.start`
installs the ``serving`` and ``forecast`` objectives (the ``fleet`` ones
on a fleet's front door, and the ``fed`` ones when it has a collector),
starts the SLO ticker and wires the capacity forecaster to the shared
history.

The fleet (``fleet.py``, ``registry.py``):

GET  /debug/fleet    →  the ``FleetRouter``'s (or the ``DisaggRouter``'s)
     topology and each replica's lifecycle state; 404 on a server that
     no fleet fronts
GET  /debug/rollout  →  the rollout state machine and the canary split;
     404 on a server that no fleet fronts
POST /generate/prefill {"prompt": [ids]}  →  {"handoff": wire blob}: the
     disaggregated prefill pool's ingress; 501 without a prefill-capable
     generation batcher
POST /generate/handoff {"handoff": blob}  →  {"tokens": [...]}: the
     decode pool's ingress; 501 without one, 400 on a bad blob

:class:`NativeInferenceServer` serves the same routes behind the C++
front end (``native/src/serving_http.cpp``): accept, HTTP parsing, the
request queue and ``GET /health`` run in C++, off the GIL; worker
threads pull requests through the C interface and run the same handlers.
Its replies close the connection, and a 503 carries ``retry_after_s`` in
its body but no ``Retry-After`` header. :func:`make_inference_server`
prefers it and falls back to :class:`InferenceServer` where the library
cannot be built.
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
from analytics_zoo_tpu_torch.common import forecast as forecast_lib
from analytics_zoo_tpu_torch.common import observability as obs
from analytics_zoo_tpu_torch.common import slo as slo_lib
from analytics_zoo_tpu_torch.common import timeseries
from analytics_zoo_tpu_torch.common import tracing
from analytics_zoo_tpu_torch.pipeline.inference.batching import (
    ContinuousBatcher, DeadlineExpiredError, DynamicBatcher,
    QueueFullError)
from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
    InferenceModel

__all__ = ["InferenceServer", "NativeInferenceServer",
           "make_inference_server", "handle_predict",
           "handle_generate", "handle_prefill", "handle_handoff",
           "handle_profile"]


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


def handle_prefill(model: InferenceModel, body: bytes,
                   gen_batcher=None) -> "Tuple[int, dict]":
    """``POST /generate/prefill``, the disaggregated prefill pool's
    ingress. Request: ``{"prompt": [ids...]}`` with optional
    ``max_new_tokens`` and ``temperature``. The prompt runs to its first
    sampled token, then the sequence's KV pages leave the cache as a
    handoff blob: ``{"handoff": {...}}`` in the base64 wire form
    (``ops/kv_cache.handoff_to_wire``), ready for a decode replica's
    ``/generate/handoff``. 501 unless the generation batcher can
    prefill."""
    sub = getattr(gen_batcher, "submit_prefill", None)
    if sub is None:
        _count_error("no_generator")
        return 501, _error_body(
            501, "this server has no prefill-capable generation "
            "batcher mounted (disaggregated prefill pool only)")
    try:
        req = json.loads(body)
    except (ValueError, UnicodeDecodeError) as e:
        _count_error("bad_json")
        return 400, _error_body(400, f"malformed JSON body: {e}")
    if not isinstance(req, dict) or "prompt" not in req:
        _count_error("bad_request")
        return 400, _error_body(
            400, 'request must be a JSON object with a "prompt" '
            'token-id list')
    try:
        prompt = [int(t) for t in req["prompt"]]
        max_new = int(req.get("max_new_tokens", 32))
        temperature = float(req.get("temperature", 0.0))
    except (TypeError, ValueError) as e:
        _count_error("bad_request")
        return 400, _error_body(
            400, f"prompt must be a list of token ids: {e}")
    from analytics_zoo_tpu_torch.ops.kv_cache import handoff_to_wire
    try:
        blob = sub(prompt, max_new_tokens=max_new,
                   temperature=temperature).result()
        return 200, {"handoff": handoff_to_wire(blob)}
    except QueueFullError as e:
        return 503, _error_body(
            503, str(e), retry_after_s=round(e.retry_after_s, 3))
    except ValueError as e:
        _count_error("bad_request")
        return 400, _error_body(400, str(e))
    except Exception as e:  # serving boundary: report, not die
        _count_error("internal")
        return 500, _error_body(500, str(e), kind="internal")


def handle_handoff(model: InferenceModel, body: bytes,
                   gen_batcher=None) -> "Tuple[int, dict]":
    """``POST /generate/handoff``, the decode pool's ingress. Request:
    ``{"handoff": {...}}`` (a prefill replica's wire blob) with optional
    ``max_new_tokens`` and ``eos_id``. The blob's pages are written into
    this replica's cache with no forward pass and the sequence decodes
    on; the answer ``{"tokens": [...]}`` is the whole new-token stream,
    the prefill's first token included, equal to what a colocated
    ``/generate`` returns. 501 unless the generation batcher admits
    handoffs; 400 on a bad blob."""
    sub = getattr(gen_batcher, "submit_handoff", None)
    if sub is None:
        _count_error("no_generator")
        return 501, _error_body(
            501, "this server has no handoff-capable generation "
            "batcher mounted (disaggregated decode pool only)")
    try:
        req = json.loads(body)
    except (ValueError, UnicodeDecodeError) as e:
        _count_error("bad_json")
        return 400, _error_body(400, f"malformed JSON body: {e}")
    if not isinstance(req, dict) or \
            not isinstance(req.get("handoff"), dict):
        _count_error("bad_request")
        return 400, _error_body(
            400, 'request must be a JSON object with a "handoff" '
            'wire blob (POST /generate/prefill produces one)')
    from analytics_zoo_tpu_torch.ops.kv_cache import handoff_from_wire
    try:
        max_new = int(req.get("max_new_tokens", 32))
        eos_id = req.get("eos_id")
        eos_id = None if eos_id is None else int(eos_id)
        blob = handoff_from_wire(req["handoff"])
    except (TypeError, ValueError, KeyError) as e:
        _count_error("bad_request")
        return 400, _error_body(400, f"bad handoff blob: {e}")
    try:
        toks = sub(blob, max_new_tokens=max_new, eos_id=eos_id).result()
        return 200, {"tokens": [int(t) for t in toks]}
    except QueueFullError as e:
        return 503, _error_body(
            503, str(e), retry_after_s=round(e.retry_after_s, 3))
    except ValueError as e:  # blob and engine geometry disagree
        _count_error("bad_request")
        return 400, _error_body(400, str(e))
    except Exception as e:
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


def _fed_collector(batcher):
    """The federation ``TelemetryCollector`` mounted as the batcher's
    ``telemetry`` attribute (None when there is none: the fleet
    telemetry routes then answer 404)."""
    return getattr(batcher, "telemetry", None)


def _fleet_metrics_text(path: str, batcher
                        ) -> "Tuple[int, Optional[bytes]]":
    """``GET /metrics?fleet=1``: the collector's merged Prometheus text
    (one HELP/TYPE per family), after a tick unless ``tick=0``;
    ``(404, None)`` when no collector is mounted."""
    q = parse_qs(urlsplit(path).query)
    tele = _fed_collector(batcher)
    if tele is None:
        _count_error("not_found")
        return 404, None
    if q.get("tick", ["1"])[0] != "0":
        tele.tick()
    return 200, tele.fleet_prometheus().encode()


def _traces_payload(path: str, batcher=None) -> dict:
    """``GET /debug/traces[?n=20]``: the most recent traces from the
    ring, newest first; ``?since=<seq>`` returns the ring's cursor and
    every span recorded after ``seq`` (read under one lock: no loss, no
    duplicate); ``?fleet=1`` with a collector mounted lists its stitched
    traces."""
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
    tele = _fed_collector(batcher)
    if q.get("fleet", ["0"])[0] == "1" and tele is not None:
        return {"enabled": tracing.enabled(), "fleet": True,
                "traces": tele.aggregator.recent(n)}
    return {"enabled": tracing.enabled(),
            "traces": tracing.get_store().recent(n)}


def _trace_payload(route: str, path: str, batcher=None
                   ) -> "Tuple[int, dict]":
    """``GET /debug/trace/<id>[?chrome=1]``: one trace's timeline, from
    the collector's aggregator (ticked first) when one is mounted and
    holds the id, else from the local ring; ``chrome=1`` renders
    Perfetto JSON with a lane per source process."""
    tid = route[len("/debug/trace/"):]
    chrome = parse_qs(urlsplit(path).query).get("chrome", ["0"])[0] == "1"
    tele = _fed_collector(batcher)
    if tele is not None:
        tele.tick()  # pull the spans still sitting in the sources
        agg = tele.aggregator
        if agg.spans(tid):
            return 200, (agg.chrome(tid) if chrome else agg.trace(tid))
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


def _fleet_telemetry_payload(batcher) -> "Tuple[int, dict]":
    """``GET /debug/fleet/telemetry``: the collector's state (sources
    and scrape health, merge conflicts, per-replica window stats, skew
    verdicts); 404 when no collector is mounted."""
    tele = _fed_collector(batcher)
    if tele is None:
        _count_error("not_found")
        return 404, _error_body(
            404, "no fleet telemetry collector mounted")
    return 200, tele.status()


def _fleet_payload(batcher, gen_batcher=None) -> "Tuple[int, dict]":
    """``GET /debug/fleet``: the ``FleetRouter``'s topology and each
    replica's lifecycle state, or on a disaggregated generation front
    door the ``DisaggRouter``'s role-tagged replicas and each pool's
    page headroom; 404 on a server that no fleet fronts."""
    status_fn = getattr(batcher, "fleet_status", None)
    if status_fn is None:
        status_fn = getattr(gen_batcher, "fleet_status", None)
    if status_fn is None:
        _count_error("not_found")
        return 404, _error_body(
            404, "no fleet router mounted on this server")
    return 200, status_fn()


def _rollout_payload(batcher) -> "Tuple[int, dict]":
    """``GET /debug/rollout``: the rollout state machine, the
    replicas' versions, the swap log and the canary split; 404 on a
    server that no fleet fronts, ``{"state": "idle"}`` on a fleet that
    never rolled."""
    status_fn = getattr(batcher, "rollout_status", None)
    if status_fn is None:
        _count_error("not_found")
        return 404, _error_body(
            404, "no fleet router mounted on this server")
    return 200, status_fn()


def _slo_payload(path: str) -> dict:
    """``GET /debug/slo[?tick=0]``: the process-global SLO engine's
    status, after a tick unless ``tick=0``."""
    q = parse_qs(urlsplit(path).query)
    engine = slo_lib.get_engine()
    if q.get("tick", ["1"])[0] != "0":
        return engine.tick()
    return engine.status()


def _history_payload(path: str, batcher=None) -> "Tuple[int, dict]":
    """``GET /debug/metrics/history[?family=&window=&fleet=1]``: windowed
    series from the process-global
    :class:`~analytics_zoo_tpu_torch.common.timeseries.MetricHistory`
    (sampled first unless ``sample=0``); without ``family``, the known
    families and the store's stats. ``fleet=1`` reads the collector's
    merged timeline instead (``tick=1`` ticks it first)."""
    q = parse_qs(urlsplit(path).query)
    fleet = q.get("fleet", ["0"])[0] == "1"
    if fleet:
        tele = _fed_collector(batcher)
        if tele is None:
            _count_error("not_found")
            return 404, _error_body(
                404, "no fleet telemetry collector mounted")
        if q.get("tick", ["0"])[0] == "1":
            tele.tick()
        hist = tele.history
    else:
        hist = timeseries.get_history()
        if q.get("sample", ["1"])[0] != "0":
            hist.sample()
    window_s = None
    if q.get("window"):
        try:
            window_s = float(q["window"][0])
        except ValueError:
            _count_error("bad_request")
            return 400, _error_body(
                400, f"bad window {q['window'][0]!r} "
                "(seconds expected)")
        if window_s <= 0:
            _count_error("bad_request")
            return 400, _error_body(
                400, "window must be positive seconds")
    family = q.get("family", [None])[0]
    if not family:
        return 200, {"fleet": fleet,
                     "families": hist.families(),
                     "stats": hist.stats()}
    return 200, dict(hist.series(family, window_s=window_s),
                     fleet=fleet)


# The live dashboard: one self-contained HTML page with no external
# assets; its series come from /debug/metrics/history and its
# sparklines are inline SVG built in the browser. The reference's page,
# byte for byte.
_DASHBOARD_PAGE = """<!doctype html>
<html><head><meta charset="utf-8">
<title>analytics-zoo-tpu dashboard</title>
<style>
body{font:13px/1.4 system-ui,sans-serif;margin:16px;
     background:#0b0e14;color:#d6deeb}
h1{font-size:16px;margin:0 0 2px}
#meta{color:#7a88a8;margin-bottom:12px}
#panels{display:grid;gap:10px;
        grid-template-columns:repeat(auto-fill,minmax(290px,1fr))}
.panel{background:#131824;border:1px solid #232b3d;
       border-radius:6px;padding:8px 10px}
.panel h2{font-size:12px;margin:0 0 4px;color:#9fb2d8;
          font-weight:600}
.row{display:flex;align-items:center;gap:8px;margin:2px 0}
.lbl{color:#7a88a8;font-size:11px;white-space:nowrap;
     overflow:hidden;text-overflow:ellipsis;max-width:45%}
.val{margin-left:auto;font-variant-numeric:tabular-nums}
.nodata{color:#53607c;font-style:italic}
svg{flex:1 1 auto;min-width:60px}
polyline{fill:none;stroke:#58a6ff;stroke-width:1.5}
.bad polyline{stroke:#ff7b72}
#slo .breach{color:#ff7b72}
#slo .ok{color:#3fb950}
#slo .no_data{color:#53607c}
</style></head><body>
<h1>analytics-zoo-tpu &mdash; live dashboard</h1>
<div id="meta">loading&hellip;</div>
<div id="panels"></div>
<div class="panel" id="slo" style="margin-top:10px">
<h2>SLO state &amp; recent anomalies</h2>
<div id="slobody" class="nodata">loading&hellip;</div></div>
<script>
"use strict";
var FLEET = new URLSearchParams(location.search)
    .get("fleet") === "1";
var SUFFIX = FLEET ? "&fleet=1" : "";
var PANELS = [
  {t: "QPS (requests/s)", f: "zoo_tpu_serving_requests_total",
   k: "rate"},
  {t: "p99 latency (s)", f: "zoo_tpu_serving_request_seconds",
   k: "q99"},
  {t: "queue depth", f: "zoo_tpu_serving_queue_depth",
   k: "value"},
  {t: "KV pages free", f: "zoo_tpu_serving_gen_free_pages",
   k: "value"},
  {t: "goodput share", f: "zoo_tpu_goodput_share", k: "value"},
  {t: "MFU", f: "zoo_tpu_mfu", k: "value"},
  {t: "forecast ETA (s)", f: "zoo_tpu_forecast_eta_s",
   k: "value", bad: function (v) { return v < 600; }},
  {t: "anomalies/s", f: "zoo_tpu_anomalies_total", k: "rate",
   bad: function (v) { return v > 0; }}
];
function esc(s) {
  return String(s).replace(/[&<>"]/g, function (c) {
    return {"&": "&amp;", "<": "&lt;", ">": "&gt;",
            '"': "&quot;"}[c];
  });
}
function spark(vals) {
  var w = 120, h = 26;
  if (vals.length < 2) {
    return '<svg width="' + w + '" height="' + h + '"></svg>';
  }
  var lo = Math.min.apply(null, vals);
  var hi = Math.max.apply(null, vals);
  var span = (hi - lo) || 1;
  var pts = vals.map(function (v, i) {
    var x = i * w / (vals.length - 1);
    var y = h - 2 - (v - lo) / span * (h - 4);
    return x.toFixed(1) + "," + y.toFixed(1);
  }).join(" ");
  return '<svg width="' + w + '" height="' + h +
    '" viewBox="0 0 ' + w + " " + h +
    '"><polyline points="' + pts + '"/></svg>';
}
function fmtv(v) {
  if (v === null || v === undefined) { return "-"; }
  if (v >= 1e8) { return "&#8734;"; }
  if (Math.abs(v) >= 100) { return v.toFixed(0); }
  return v.toPrecision(3);
}
function labelText(labels) {
  var ks = Object.keys(labels);
  if (!ks.length) { return "total"; }
  return ks.map(function (k) {
    return k + "=" + labels[k];
  }).join(",");
}
function renderPanel(p, doc) {
  var html = "<h2>" + esc(p.t) + "</h2>";
  var series = (doc && doc.series) || [];
  var rows = 0;
  series.forEach(function (s) {
    var vals = s.points.map(function (pt) {
      return pt[p.k];
    }).filter(function (v) {
      return v !== null && v !== undefined;
    });
    if (!vals.length) { return; }
    rows += 1;
    var last = vals[vals.length - 1];
    var bad = p.bad && p.bad(last);
    html += '<div class="row' + (bad ? " bad" : "") +
      '"><span class="lbl" title="' +
      esc(labelText(s.labels)) + '">' +
      esc(labelText(s.labels)) + "</span>" + spark(vals) +
      '<span class="val">' + fmtv(last) + "</span></div>";
  });
  if (!rows) {
    html += '<div class="nodata">no data</div>';
  }
  return html;
}
function refresh() {
  PANELS.forEach(function (p, i) {
    fetch("/debug/metrics/history?family=" + p.f + SUFFIX)
      .then(function (r) { return r.json(); })
      .then(function (doc) {
        document.getElementById("p" + i).innerHTML =
          renderPanel(p, doc);
      }).catch(function () {});
  });
  fetch("/debug/metrics/history?" + (FLEET ? "fleet=1" : ""))
    .then(function (r) { return r.json(); })
    .then(function (doc) {
      var st = doc.stats || {};
      document.getElementById("meta").textContent =
        (FLEET ? "fleet-merged timeline" : "local timeline") +
        " \\u00b7 " + (st.raw_samples || 0) + " samples over " +
        (st.span_s || 0).toFixed(0) + "s \\u00b7 " +
        ((st.resident_bytes || 0) / 1024).toFixed(0) +
        " KiB resident \\u00b7 " + new Date().toLocaleTimeString();
    }).catch(function () {});
  fetch("/debug/slo?tick=0")
    .then(function (r) { return r.json(); })
    .then(function (doc) {
      var html = "";
      (doc.objectives || []).forEach(function (o) {
        html += '<div class="row"><span class="lbl">' +
          esc(o.id) + '</span><span class="' + esc(o.state) +
          '">' + esc(o.state) + "</span>" +
          '<span class="val">' + fmtv(o.value) + "</span></div>";
      });
      document.getElementById("slobody").innerHTML =
        html || '<div class="nodata">no objectives</div>';
    }).catch(function () {});
}
var panels = document.getElementById("panels");
PANELS.forEach(function (p, i) {
  var d = document.createElement("div");
  d.className = "panel";
  d.id = "p" + i;
  d.innerHTML = "<h2>" + esc(p.t) +
    '</h2><div class="nodata">loading&hellip;</div>';
  panels.appendChild(d);
});
refresh();
setInterval(refresh, 5000);
</script></body></html>
"""


def _dashboard_html() -> bytes:
    """``GET /debug/dashboard``: the self-contained live page."""
    return _DASHBOARD_PAGE.encode()


# One profiler capture at a time per process.
_profile_lock = threading.Lock()
_profile_thread: "Optional[threading.Thread]" = None


def _profiler_capture(out_dir: str, ms: float) -> str:
    """Capture ``ms`` milliseconds of ``torch.profiler`` activity (the
    CPU and, when the card is present, CUDA kernels launched by every
    thread) and write it as a Chrome trace into ``out_dir``; returns
    the file's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        time.sleep(ms / 1e3)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(out_dir, f"zoo_tpu_profile_{os.getpid()}_"
                        f"{int(time.time() * 1e3)}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def handle_profile(body: bytes) -> "Tuple[int, dict]":
    """``POST /debug/profile {"dir": ..., "ms": 500}``: start a
    ``torch.profiler`` capture on a background thread and answer at
    once; 503 while a capture is already running. The capture appends a
    ``serving/profile_capture`` event (with the trace file's path) or a
    ``serving/profile_error`` event."""
    global _profile_thread
    try:
        req = json.loads(body) if body else {}
    except (ValueError, UnicodeDecodeError) as e:
        _count_error("bad_json")
        return 400, _error_body(400, f"malformed JSON body: {e}")
    if not isinstance(req, dict) or not req.get("dir"):
        _count_error("bad_request")
        return 400, _error_body(
            400, 'request must be a JSON object with a "dir" key '
            '(profile output directory); optional "ms" duration')
    out_dir = str(req["dir"])
    try:
        ms = float(req.get("ms", 500))
    except (TypeError, ValueError):
        _count_error("bad_request")
        return 400, _error_body(400, '"ms" must be a number')
    ms = max(1.0, min(ms, 60_000.0))
    if not _profile_lock.acquire(blocking=False):
        _count_error("profile_busy")
        return 503, _error_body(
            503, "a profiler capture is already running")

    def _run():
        try:
            path = _profiler_capture(out_dir, ms)
            obs.event("serving/profile_capture", dir=out_dir, ms=ms,
                      path=path)
        except Exception as e:
            obs.event("serving/profile_error", dir=out_dir,
                      error=f"{type(e).__name__}: {e}")
        finally:
            _profile_lock.release()

    t = threading.Thread(target=_run, name="zoo-tpu-profiler",
                         daemon=True)
    _profile_thread = t
    t.start()
    return 200, {"status": "capturing", "dir": out_dir, "ms": ms}


def _resolve_gen_batcher(model: InferenceModel, gen_batcher):
    """``"auto"`` → a :class:`ContinuousBatcher` over the model's
    generator (None when it has none or ``ZOO_TPU_GEN_BATCH=0``:
    /generate then runs the sequential path; a ``FleetRouter`` standing
    for the model has none). ``ZOO_TPU_DISAGG=1`` makes it a
    ``DisaggRouter`` carved out of the generator instead
    (``ZOO_TPU_DISAGG_PREFILL_REPLICAS`` / ``_DECODE_REPLICAS``), for a
    ``role="both"`` engine only: a pool worker's role engine keeps its
    plain batcher. ``None`` or an instance pass through."""
    if gen_batcher == "auto":
        engine = getattr(model, "generator", None)
        if engine is None or os.environ.get("ZOO_TPU_GEN_BATCH",
                                            "1") == "0":
            return None
        if os.environ.get("ZOO_TPU_DISAGG", "0") not in ("", "0") \
                and getattr(engine, "role", "both") == "both":
            from analytics_zoo_tpu_torch.pipeline.inference.fleet import \
                DisaggRouter
            return DisaggRouter.for_engine(engine)
        return ContinuousBatcher(engine)
    return gen_batcher


def _resolve_batcher(model: InferenceModel, batcher):
    """``"auto"`` → the environment's batcher (None when
    ``ZOO_TPU_SERVING_BATCH=0``), or the model itself when it is a
    ``FleetRouter`` (it is both surfaces); ``None`` → per-request
    serving; a DynamicBatcher passes through."""
    if batcher == "auto":
        if hasattr(model, "fleet_status"):
            return model
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
                raw = None  # (body, content type) of a non-JSON reply
                route = self.path.split("?", 1)[0]
                try:
                    if route == "/health":
                        status = 200
                        payload = _health_payload(
                            server.model, server.batcher,
                            server.gen_batcher)
                    elif route == "/metrics" and "fleet=1" in self.path:
                        status, body = _fleet_metrics_text(
                            self.path, server.batcher)
                        if body is None:
                            payload = _error_body(
                                404, "no fleet telemetry collector "
                                "mounted")
                        else:
                            raw = (body, "text/plain; version=0.0.4")
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
                        payload = _traces_payload(self.path,
                                                  server.batcher)
                    elif route.startswith("/debug/trace/"):
                        status, payload = _trace_payload(
                            route, self.path, server.batcher)
                    elif route == "/debug/slo":
                        status = 200
                        payload = _slo_payload(self.path)
                    elif route == "/debug/fleet/telemetry":
                        status, payload = _fleet_telemetry_payload(
                            server.batcher)
                    elif route == "/debug/fleet":
                        status, payload = _fleet_payload(
                            server.batcher, server.gen_batcher)
                    elif route == "/debug/rollout":
                        status, payload = _rollout_payload(
                            server.batcher)
                    elif route == "/debug/metrics/history":
                        status, payload = _history_payload(
                            self.path, server.batcher)
                    elif route == "/debug/dashboard":
                        status = 200
                        raw = (_dashboard_html(),
                               "text/html; charset=utf-8")
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
                if raw is None and payload is None:
                    # the local /metrics renders after accounting, so
                    # the scrape sees itself counted
                    raw = (obs.to_prometheus().encode(),
                           "text/plain; version=0.0.4")
                if raw is not None:
                    self._reply_raw(status, raw[0], raw[1])
                else:
                    self._reply(status, payload)

            def do_POST(self):
                t0 = time.perf_counter()
                _in_flight().inc()
                status = 0
                trace_id = None
                route = self.path.split("?", 1)[0]
                try:
                    if route not in ("/predict", "/generate",
                                     "/generate/prefill",
                                     "/generate/handoff",
                                     "/debug/profile"):
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
                            if route == "/debug/profile":
                                status, payload = handle_profile(body)
                            else:
                                with tracing.trace(
                                        "serving/request",
                                        trace_id=self.headers.get(
                                            tracing.TRACE_HEADER),
                                        path=route) as tr:
                                    if route == "/generate/prefill":
                                        status, payload = \
                                            handle_prefill(
                                                server.model, body,
                                                server.gen_batcher)
                                    elif route == "/generate/handoff":
                                        status, payload = \
                                            handle_handoff(
                                                server.model, body,
                                                server.gen_batcher)
                                    elif route == "/generate":
                                        status, payload = \
                                            handle_generate(
                                                server.model, body,
                                                server.gen_batcher)
                                    else:
                                        status, payload = \
                                            handle_predict(
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
        """Warm and start the batchers, install the default objectives,
        then serve (on a thread of its own unless
        ``background=False``)."""
        if self.batcher is not None:
            self.batcher.start()
        if self.gen_batcher is not None:
            self.gen_batcher.start()
        # the shipped serving and forecast objectives and the SLO
        # ticker (ZOO_TPU_SLO=0 disables), whose samples of the shared
        # history drive the capacity forecaster; a fleet's front door
        # adds the fleet's objectives, and the federated ones when it
        # has a collector mounted
        slo_lib.ensure_default_slos("serving")
        slo_lib.ensure_default_slos("forecast")
        forecast_lib.ensure_forecaster()
        if hasattr(self.batcher, "fleet_status"):
            slo_lib.ensure_default_slos("fleet")
            if _fed_collector(self.batcher) is not None:
                slo_lib.ensure_default_slos("fed")
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


class NativeInferenceServer:
    """The routes of :class:`InferenceServer` behind the C++ front end
    (``native/src/serving_http.cpp``, the reference's
    ``NativeInferenceServer``): socket accept, HTTP parsing, queueing and
    ``GET /health`` run in C++; ``workers`` threads (the model's
    concurrency by default) pull each request's path, body and trace
    header over the C interface, run the handlers and post the reply.
    ``/health`` is refreshed after every request, so it reports the
    capacity after that request, and is answered while every worker is
    busy."""

    def __init__(self, model: InferenceModel, port: int = 0,
                 workers: Optional[int] = None, batcher="auto",
                 gen_batcher="auto"):
        from analytics_zoo_tpu_torch.native import NativeHttpServer
        self._srv = NativeHttpServer(port=port)
        self.model = model
        self.batcher = _resolve_batcher(model, batcher)
        self.gen_batcher = _resolve_gen_batcher(model, gen_batcher)
        self._workers = workers or model.supported_concurrent_num
        self._threads: "list[threading.Thread]" = []
        self._stopping = False

    @property
    def port(self) -> int:
        return self._srv.port

    def _route(self, route: str, path: str, body: bytes,
               trace_hdr: Optional[str]):
        """``(status, reply bytes or None, trace id)`` of one request;
        None stands for the local ``/metrics``, rendered after the
        request is counted."""
        if route == "/metrics" and "fleet=1" in path:
            status, text = _fleet_metrics_text(path, self.batcher)
            return status, text if text is not None else json.dumps(
                _error_body(404, "no fleet telemetry collector mounted")
            ).encode(), None
        if route == "/metrics":
            _refresh_vitals()
            return 200, None, None
        if route == "/debug/dashboard":
            return 200, _dashboard_html(), None
        if route == "/metrics/json":
            _refresh_vitals()
            return 200, json.dumps({"ts": time.time(),
                                    "metrics": obs.snapshot()}).encode(), \
                None
        gets = {
            "/debug/traces": lambda: (200, _traces_payload(path,
                                                           self.batcher)),
            "/debug/slo": lambda: (200, _slo_payload(path)),
            "/debug/fleet/telemetry": lambda: _fleet_telemetry_payload(
                self.batcher),
            "/debug/fleet": lambda: _fleet_payload(self.batcher,
                                                   self.gen_batcher),
            "/debug/rollout": lambda: _rollout_payload(self.batcher),
            "/debug/metrics/history": lambda: _history_payload(
                path, self.batcher),
            "/debug/profile": lambda: handle_profile(body),
        }
        if route in gets:
            status, payload = gets[route]()
        elif route.startswith("/debug/trace/"):
            status, payload = _trace_payload(route, path, self.batcher)
        elif route not in ("/predict", "/generate", "/generate/prefill",
                           "/generate/handoff"):
            _count_error("not_found")
            status, payload = 404, _error_body(404, "not found",
                                               path=route)
        else:
            with tracing.trace("serving/request", trace_id=trace_hdr,
                               path=route) as tr:
                if route == "/generate/prefill":
                    status, payload = handle_prefill(
                        self.model, body, self.gen_batcher)
                elif route == "/generate/handoff":
                    status, payload = handle_handoff(
                        self.model, body, self.gen_batcher)
                elif route == "/generate":
                    status, payload = handle_generate(
                        self.model, body, self.gen_batcher)
                else:
                    status, payload = handle_predict(
                        self.model, body, batcher=self.batcher)
                tr.annotate(status=status)
            return status, json.dumps(payload).encode(), tr.trace_id
        return status, json.dumps(payload).encode(), None

    def _serve_one(self, rid: int, path: str, body: bytes,
                   trace_hdr: Optional[str] = None):
        t0 = time.perf_counter()
        _in_flight().inc()
        status, out, trace_id = 0, b"", None
        route = path.split("?", 1)[0]
        try:
            status, out, trace_id = self._route(route, path, body,
                                                trace_hdr)
        except Exception as e:
            status = 500
            out = json.dumps(_error_body(500, str(e),
                                         kind="internal")).encode()
        finally:
            # account before replying: a client that scrapes /metrics
            # right after its response sees its request counted (and
            # in-flight back at 0)
            _in_flight().dec()
            _record_request(route, status, time.perf_counter() - t0)
        if out is None:
            out = obs.to_prometheus().encode()
        try:
            self._srv.respond(rid, status, out, trace_id=trace_id)
        except Exception:
            pass  # the client is gone: nothing to tell it
        # after the slot is back: /health reports the capacity after
        # this request and the batcher's queue now
        self._srv.set_health(json.dumps(_health_payload(
            self.model, self.batcher, self.gen_batcher)))

    def _loop(self):
        from analytics_zoo_tpu_torch.common.nncontext import logger
        while not self._stopping:
            try:
                got = self._srv.next_request(timeout_ms=200)
            except StopIteration:
                return
            except Exception as e:  # transient: keep the worker alive
                if self._stopping:
                    return
                logger.warning("native serving worker error: %s", e)
                continue
            if got is not None:
                self._serve_one(*got)

    def start(self, background: bool = True):
        """Warm and start the batchers, install the default objectives
        (as :meth:`InferenceServer.start`), publish ``/health`` and start
        the worker threads (and join them unless ``background``)."""
        if self.batcher is not None:
            self.batcher.start()
        if self.gen_batcher is not None:
            self.gen_batcher.start()
        slo_lib.ensure_default_slos("serving")
        slo_lib.ensure_default_slos("forecast")
        forecast_lib.ensure_forecaster()
        if hasattr(self.batcher, "fleet_status"):
            slo_lib.ensure_default_slos("fleet")
            if _fed_collector(self.batcher) is not None:
                slo_lib.ensure_default_slos("fed")
        self._srv.set_health(json.dumps(_health_payload(
            self.model, self.batcher, self.gen_batcher)))
        for i in range(self._workers):
            t = threading.Thread(target=self._loop,
                                 name=f"zoo-tpu-native-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        if not background:
            for t in self._threads:
                t.join()
        return self

    def stop(self):
        """Let the workers drain (each polls every 200 ms; an in-flight
        request finishes) for up to 60 s, stop the batchers, then free
        the native server. A worker still busy after that keeps the
        handle alive: it is leaked, never freed under the worker."""
        self._stopping = True
        deadline = time.monotonic() + 60.0
        for t in self._threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.1))
        if self.batcher is not None:
            self.batcher.stop()
        if self.gen_batcher is not None:
            self.gen_batcher.stop()
        if any(t.is_alive() for t in self._threads):
            from analytics_zoo_tpu_torch.common.nncontext import logger
            logger.warning(
                "native serving: a worker is still busy after 60 s; "
                "leaking the native server handle instead of freeing it "
                "under the worker")
            return
        self._srv.close()


def make_inference_server(model: InferenceModel, port: int = 0,
                          prefer_native: bool = True, batcher="auto",
                          gen_batcher="auto"):
    """The native C++ front end where its library builds, else the
    stdlib one (with one logged warning), the same routes either way;
    ``prefer_native=False`` asks for the stdlib one. ``batcher``:
    ``"auto"`` (environment-configured dynamic batching, or the model
    itself for a ``FleetRouter``), ``None`` (per request) or a
    :class:`DynamicBatcher`; ``gen_batcher``: the same for /generate
    (``"auto"`` mounts a :class:`ContinuousBatcher` when the model has a
    generator)."""
    if prefer_native:
        try:
            return NativeInferenceServer(model, port=port, batcher=batcher,
                                         gen_batcher=gen_batcher)
        except (RuntimeError, OSError) as e:
            global _native_warned
            if not _native_warned:
                _native_warned = True
                from analytics_zoo_tpu_torch.common.nncontext import logger
                logger.warning("native front end unavailable, serving "
                               "with the stdlib one: %s", e)
    return InferenceServer(model, port=port, batcher=batcher,
                           gen_batcher=gen_batcher)


_native_warned = False
