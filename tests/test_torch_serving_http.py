"""The port's HTTP front end (``pipeline/inference/serving.py``) against
the JAX package's: an ``InferenceServer`` of each package on port 0,
the same requests to both.

Held: status codes and error bodies (400, 404, 500, 501, 503 with
``Retry-After``, 504), the ``/health`` keys, ``/predict`` outputs within
1e-5 of max(1, max|ref|) on a ``Sequential`` Dense 16→32→4 and within
1e-3 on a fused ResNet cut to two bottlenecks (the stem, a stride-1 and
a stride-2 ``FusedBottleneck`` with distinctive BatchNorm statistics, at
16x16: the eval folds of ResNet-50's blocks, which the JAX side runs in
Pallas interpret mode), identical greedy ``/generate`` tokens for
``prompt`` and ``prompts`` (a 2-block ``TransformerLayer``, hidden 32),
the trace header echoed or minted with the batcher's spans under it,
the batcher's families in ``/metrics``, and the judgement layer's
routes: ``/debug/slo``'s objectives and states and
``/debug/metrics/history``'s windowed deltas after the same requests,
the fleet telemetry routes' 404s while no collector is mounted, and the
fleet's own routes (``/debug/fleet``, ``/debug/rollout``, the
disaggregated pools' ``/generate/prefill`` and ``/generate/handoff``) on
single-model servers.

Each package's servers start once per module; every client call has a
timeout and every server is stopped in a ``finally``.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as jinit
from analytics_zoo_tpu.models.image.imageclassification import resnet as jr
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import engine as je
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.api.keras import models as jmodels
from analytics_zoo_tpu.pipeline.api.keras.layers import transformer as jtr
from analytics_zoo_tpu.pipeline.inference import batching as jb
from analytics_zoo_tpu.pipeline.inference import \
    InferenceModel as JInferenceModel
from analytics_zoo_tpu.pipeline.inference import serving as jsv
from analytics_zoo_tpu.common import forecast as jfc
from analytics_zoo_tpu.common import slo as jslo
from analytics_zoo_tpu_torch.models.image.imageclassification import \
    resnet as tr
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as te
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    transformer as ttr
from analytics_zoo_tpu_torch.pipeline.inference import batching as tb
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.pipeline.inference import serving as tsv
from analytics_zoo_tpu_torch.common import forecast as tfc
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.common import slo as tslo
from analytics_zoo_tpu_torch.common import timeseries as tts

SIDES = ("port", "jax")
TIMEOUT = 60
SEQ, VOCAB = 32, 61
GPT = dict(n_block=2, hidden_size=32, n_head=2, vocab=VOCAB,
           hidden_p_drop=0.0, attn_p_drop=0.0, embed_p_drop=0.0)
GEN = dict(max_slots=2, max_context=SEQ, page_size=8)


def _call(port, method, path, body=None, headers=None):
    """(status, headers, parsed JSON or text) of one request."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method=method,
                                 headers=headers or {})
    try:
        r = urllib.request.urlopen(req, timeout=TIMEOUT)
        code, hdrs, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        code, hdrs, raw = e.code, e.headers, e.read()
    try:
        return code, hdrs, json.loads(raw)
    except ValueError:
        return code, hdrs, raw.decode()


def _post(port, path, payload, headers=None):
    body = payload if isinstance(payload, bytes) else \
        json.dumps(payload).encode()
    return _call(port, "POST", path, body, headers)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _dense(lib):
    m = JSequential() if lib is JL else tmodels.Sequential()
    m.add(lib.Dense(32, activation="relu", input_shape=(16,)))
    m.add(lib.Dense(4))
    return m


def _small_resnet(E, L, R, M):
    inp = E.Input((16, 16, 3), name="image")
    x = R.conv_bn(inp, 64, 7, stride=2, name="stem")
    x = L.MaxPooling2D(pool_size=3, strides=2, border_mode="same")(x)
    x = R.FusedBottleneck(64, stride=1, downsample=True, name="s0b0")(x)
    x = R.FusedBottleneck(64, stride=2, downsample=True, name="s1b0")(x)
    x = L.GlobalAveragePooling2D()(x)
    return M(inp, L.Dense(10, name="fc")(x))


def _distinct_stats(tree, rs):
    for v in tree.values():
        if isinstance(v, dict) and "_state" in v:
            n = v["_state"]["moving_mean"].shape[0]
            v["_state"]["moving_mean"] = (rs.randn(n) * 0.1).astype(
                np.float32)
            v["_state"]["moving_var"] = (rs.rand(n) + 0.5).astype(
                np.float32)
        elif isinstance(v, dict):
            _distinct_stats(v, rs)
    return tree


def _jtree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


class _StubModel:
    """Duck-typed model without bucket callables whose ``predict``
    blocks until released (or raises): queue states are
    deterministic."""

    can_relower = False
    example_input_specs = None
    generation = 0
    concurrent_slots_free = 1
    supported_concurrent_num = 1
    generator = None

    def __init__(self, fail=False):
        self.started = threading.Event()
        self.release = threading.Event()
        self.fail = fail

    def predict(self, xs):
        self.started.set()
        assert self.release.wait(TIMEOUT), "test forgot to release stub"
        if self.fail:
            raise RuntimeError("stub model exploded")
        return np.asarray(xs[0] if isinstance(xs, list) else xs) * 2.0


@pytest.fixture(scope="module", autouse=True)
def _manual_slo_ticks():
    """Every server of this module starts its SLO engine with no
    background ticker: ``/debug/slo`` ticks it by hand."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ZOO_TPU_SLO_TICK_S", "0")
    tslo.reset_slo()
    try:
        yield
    finally:
        mp.undo()
        tslo.reset_slo()
        tts.reset_history()
        tfc.reset_forecast()


@pytest.fixture(scope="module")
def servers():
    """Per package: "main" (the Dense net with a declared signature
    behind a DynamicBatcher, and the GPT stack behind a
    ContinuousBatcher), "plain" (the Dense net per request, no
    generator) and "resnet" (the small fused ResNet: the port's behind a
    batcher, the JAX package's per request)."""
    tzoo.init_nncontext(seed=0, device="cpu")
    jinit(seed=0)
    rs = np.random.RandomState(0)
    jm = _dense(JL)
    dense = jax.device_get(jm.init_params(jax.random.key(0)))
    jnet = jtr.TransformerLayer(seq_len=SEQ, **GPT)
    gen = jax.device_get(jnet.build(jax.random.key(1), (SEQ,)))
    jres = _small_resnet(je, JL, jr, jmodels.Model)
    res = _distinct_stats(jax.device_get(
        jres.init_params(jax.random.key(2))), rs)
    example = [rs.randn(4, 16).astype(np.float32)]
    out = {}
    try:
        # the JAX package's servers
        jim = JInferenceModel(supported_concurrent_num=2)
        jim.load_keras_net(jm, params=_jtree(dense), example_inputs=example)
        jim.load_generator(jnet, params=_jtree(gen), **GEN)
        jplain = JInferenceModel(2).load_keras_net(
            _dense(JL), params=_jtree(dense))
        jres_im = JInferenceModel().load_keras_net(jres, params=_jtree(res))
        out["jax"] = {
            "main": jsv.InferenceServer(jim, port=0, batcher=jb.DynamicBatcher(
                jim, max_batch_size=8, max_wait_ms=2)).start(),
            "plain": jsv.InferenceServer(jplain, port=0, batcher=None),
            "resnet": jsv.InferenceServer(jres_im, port=0, batcher=None)}
        out["jax"]["plain"].start()
        out["jax"]["resnet"].start()
        # the port's, on the same weights
        tim = InferenceModel(supported_concurrent_num=2).load_keras_net(
            _dense(TL), params=dense, example_inputs=example)
        tnet = ttr.TransformerLayer(seq_len=SEQ, **GPT)
        tim.load_generator(tnet, params=gen, **GEN)
        tplain = InferenceModel(2).load_keras_net(_dense(TL), params=dense)
        tres_im = InferenceModel().load_keras_net(
            _small_resnet(te, TL, tr, tmodels.Model), params=res,
            example_inputs=[np.zeros((1, 16, 16, 3), np.float32)])
        out["port"] = {
            "main": tsv.InferenceServer(tim, port=0, batcher=tb.DynamicBatcher(
                tim, max_batch_size=8, max_wait_ms=2)).start(),
            "plain": tsv.make_inference_server(
                tplain, prefer_native=False, batcher=None).start(),
            "resnet": tsv.InferenceServer(
                tres_im, port=0, batcher=tb.DynamicBatcher(
                    tres_im, max_batch_size=4, max_wait_ms=2)).start()}
        yield out
    finally:
        for side in out.values():
            for srv in side.values():
                srv.stop()
        tzoo.reset_nncontext()


def _both(servers, which, method, path, body=None, headers=None):
    return {side: _call(servers[side][which].port, method, path, body,
                        headers) for side in SIDES}


# -- error contract -----------------------------------------------------------

ERRORS = [
    ("main", "POST", "/predict", b"{not json", 400),
    ("main", "POST", "/predict", b'{"x": 1}', 400),
    ("main", "POST", "/predict", b"[1, 2]", 400),
    ("main", "POST", "/predict", b'{"inputs": [[1, 2], [3]]}', 400),
    ("main", "POST", "/predict", b'{"inputs": [["a", "b"]]}', 400),
    ("main", "POST", "/nope", b"{}", 404),
    ("main", "GET", "/nope", None, 404),
    ("main", "GET", "/debug/trace/no-such-id", None, 404),
    ("main", "POST", "/generate", b"{bad", 400),
    ("main", "POST", "/generate", b'{"prompt": [1], "prompts": [[1]]}',
     400),
    ("main", "POST", "/generate", b"{}", 400),
    ("main", "POST", "/generate", b'{"prompt": ["a"]}', 400),
    ("main", "POST", "/generate", b'{"prompt": [1, 2], "max_new_tokens": 0}',
     400),
    ("main", "POST", "/generate", json.dumps({"prompt": [1] * 40}).encode(),
     400),
    ("plain", "POST", "/generate", b'{"prompt": [1, 2]}', 501),
]


@pytest.mark.parametrize("which,method,path,body,code", ERRORS)
def test_error_statuses_and_bodies_match_jax(servers, which, method, path,
                                             body, code):
    got = _both(servers, which, method, path, body)
    assert got["port"][0] == got["jax"][0] == code
    assert got["port"][2] == got["jax"][2]
    assert got["port"][2]["error"]["code"] == code


@pytest.mark.parametrize("batched", [False, True])
def test_internal_failure_is_500_like_jax(batched):
    bodies = {}
    for side, mod, bmod in (("port", tsv, tb), ("jax", jsv, jb)):
        stub = _StubModel(fail=True)
        stub.release.set()
        b = bmod.DynamicBatcher(stub, max_batch_size=4, max_wait_ms=1) \
            if batched else None
        srv = mod.InferenceServer(stub, port=0, batcher=b,
                                  gen_batcher=None).start()
        try:
            code, _, bodies[side] = _post(srv.port, "/predict",
                                          {"inputs": [[1, 2, 3, 4]]})
        finally:
            srv.stop()
        assert code == 500
    assert bodies["port"] == bodies["jax"] == {"error": {
        "code": 500, "message": "stub model exploded", "kind": "internal"}}


def test_queue_full_is_503_with_retry_after_like_jax():
    got = {}
    for side, mod, bmod in (("port", tsv, tb), ("jax", jsv, jb)):
        stub = _StubModel()
        b = bmod.DynamicBatcher(stub, max_batch_size=4, max_wait_ms=1,
                                queue_depth=1)
        srv = mod.InferenceServer(stub, port=0, batcher=b,
                                  gen_batcher=None).start()
        threads = []
        try:
            def post_async():
                _post(srv.port, "/predict", {"inputs": [[1, 2, 3, 4]]})

            threads.append(threading.Thread(target=post_async))
            threads[-1].start()                  # blocks in the stub
            assert stub.started.wait(TIMEOUT)
            threads.append(threading.Thread(target=post_async))
            threads[-1].start()                  # fills the queue
            deadline = time.monotonic() + 10
            while (b.stats()["queue_depth"] < 1 and
                   time.monotonic() < deadline):
                time.sleep(0.01)
            assert b.stats()["queue_depth"] == 1
            got[side] = _post(srv.port, "/predict",
                              {"inputs": [[1, 2, 3, 4]]})
        finally:
            stub.release.set()
            for t in threads:
                t.join(timeout=TIMEOUT)
            srv.stop()
        assert not any(t.is_alive() for t in threads)
    for side in SIDES:
        code, hdrs, body = got[side]
        assert code == 503 and int(hdrs["Retry-After"]) >= 1
        assert body["error"]["retry_after_s"] > 0
    assert got["port"][2] == got["jax"][2]
    assert got["port"][1]["Retry-After"] == got["jax"][1]["Retry-After"]


def test_expired_deadline_is_504_like_jax():
    got = {}
    for side, mod, bmod in (("port", tsv, tb), ("jax", jsv, jb)):
        stub = _StubModel()
        b = bmod.DynamicBatcher(stub, max_batch_size=4, max_wait_ms=1,
                                queue_depth=8, deadline_ms=50)
        srv = mod.InferenceServer(stub, port=0, batcher=b,
                                  gen_batcher=None).start()
        first = threading.Thread(target=_post, args=(
            srv.port, "/predict", {"inputs": [[1, 2, 3, 4]]}))
        try:
            first.start()                        # blocks in the stub
            assert stub.started.wait(TIMEOUT)
            threading.Timer(0.3, stub.release.set).start()
            got[side] = _post(srv.port, "/predict",
                              {"inputs": [[5, 6, 7, 8]]})
        finally:
            stub.release.set()
            first.join(timeout=TIMEOUT)
            srv.stop()
        assert not first.is_alive()
    assert got["port"][0] == got["jax"][0] == 504
    assert got["port"][2] == got["jax"][2]
    assert "50ms deadline" in got["port"][2]["error"]["message"]


# -- health, metrics ----------------------------------------------------------

@pytest.mark.parametrize("which", ["main", "plain"])
def test_health_keys_match_jax(servers, which):
    got = _both(servers, which, "GET", "/health")
    port, ref = got["port"][2], got["jax"][2]
    assert got["port"][0] == got["jax"][0] == 200
    assert set(port) == set(ref)
    assert port["status"] == "ok" and port["free_slots"] == 2
    assert port["batcher"] == ref["batcher"]
    if which == "main":
        assert port["batcher"]["warmed_buckets"] == 4
        assert set(port["generator"]) == set(ref["generator"])
        for k in ("enabled", "queue_capacity", "max_slots", "max_context",
                  "page_size", "total_pages", "prompt_buckets", "kv_dtype"):
            assert port["generator"][k] == ref["generator"][k], k
    else:
        assert port["batcher"] == {"enabled": False}
        assert "generator" not in port


def test_metrics_carry_the_batchers_families(servers):
    # one batched request first, so every family has a child
    for side in SIDES:
        _post(servers[side]["main"].port, "/predict",
              {"inputs": np.ones((3, 16)).tolist()})
    got = _both(servers, "main", "GET", "/metrics")
    fams = {}
    for side in SIDES:
        code, hdrs, text = got[side]
        assert code == 200 and hdrs["Content-Type"].startswith("text/plain")
        fams[side] = {line.split()[2] for line in text.splitlines()
                      if line.startswith("# TYPE zoo_tpu_serving")}
    # the families a batched request writes, in both; the JAX
    # package's test harness resets its registry around every test, so
    # the gauges set at server start are held on the port alone
    want = {"zoo_tpu_serving_queue_depth",
            "zoo_tpu_serving_batch_executions_total",
            "zoo_tpu_serving_padding_rows_total",
            "zoo_tpu_serving_batch_fill_ratio",
            "zoo_tpu_serving_batch_size",
            "zoo_tpu_serving_queue_wait_seconds",
            "zoo_tpu_serving_requests_total",
            "zoo_tpu_serving_request_seconds",
            "zoo_tpu_serving_in_flight",
            "zoo_tpu_serving_predict_seconds",
            "zoo_tpu_serving_pad_seconds"}
    assert want <= fams["jax"]
    assert want | {"zoo_tpu_serving_warmed_buckets",
                   "zoo_tpu_serving_bucket_compiles_total",
                   "zoo_tpu_serving_bucket_warm_seconds",
                   "zoo_tpu_serving_gen_slots_active",
                   "zoo_tpu_serving_gen_free_pages"} <= fams["port"]
    code, _, snap = _call(servers["port"]["main"].port, "GET",
                          "/metrics/json")
    assert code == 200 and set(snap) == {"ts", "metrics"}
    assert "zoo_tpu_serving_batch_executions_total" in snap["metrics"]


# -- outputs ------------------------------------------------------------------

@pytest.mark.parametrize("which", ["main", "plain"])
def test_predict_dense_matches_jax(servers, which):
    rs = np.random.RandomState(7)
    for n in (1, 3, 8, 11):
        x = rs.randn(n, 16).astype(np.float32)
        got = {side: _post(servers[side][which].port, "/predict",
                           {"inputs": x.tolist()}) for side in SIDES}
        assert got["port"][0] == got["jax"][0] == 200
        out = np.asarray(got["port"][2]["outputs"], np.float32)
        assert out.shape == (n, 4)
        _close(out, got["jax"][2]["outputs"], 1e-5)


def test_predict_fused_resnet_matches_jax(servers):
    x = np.random.RandomState(8).rand(3, 16, 16, 3).astype(np.float32)
    got = {side: _post(servers[side]["resnet"].port, "/predict",
                       {"inputs": x.tolist()}) for side in SIDES}
    assert got["port"][0] == got["jax"][0] == 200
    out = np.asarray(got["port"][2]["outputs"], np.float32)
    assert out.shape == (3, 10)
    _close(out, got["jax"][2]["outputs"], 1e-3)
    # the port served a padded bucket of 4: the live rows equal the
    # per-request forward
    port_im = servers["port"]["resnet"].model
    _close(out, port_im.predict(x), 1e-5)


@pytest.mark.parametrize("payload", [
    {"prompt": [4, 19, 7], "max_new_tokens": 5},
    {"prompts": [[4, 19, 7], [5], [11, 12, 13, 14, 15, 16]],
     "max_new_tokens": 4},
    {"prompt": [9, 8], "max_new_tokens": 6, "eos_id": 3},
])
def test_generate_greedy_tokens_match_jax(servers, payload):
    got = {side: _post(servers[side]["main"].port, "/generate", payload)
           for side in SIDES}
    assert got["port"][0] == got["jax"][0] == 200
    assert got["port"][2] == got["jax"][2]
    toks = got["port"][2]["tokens"]
    if "prompt" in payload:
        assert isinstance(toks[0], int)
    else:
        assert len(toks) == len(payload["prompts"])
    # the server's stream is the engine's sequential generate
    eng = servers["port"]["main"].model.generator
    prompts = [payload["prompt"]] if "prompt" in payload else \
        payload["prompts"]
    seq = [o.tolist() for o in eng.generate(
        prompts, max_new_tokens=payload["max_new_tokens"],
        eos_id=payload.get("eos_id"))]
    assert (seq[0] if "prompt" in payload else seq) == toks


# -- tracing ------------------------------------------------------------------

def test_trace_id_echoed_and_spans_recorded_like_jax(servers):
    names, docs = {}, {}
    x = np.random.RandomState(9).randn(3, 16)   # pads to the bucket of 4
    for side in SIDES:
        port = servers[side]["main"].port
        code, hdrs, _ = _post(port, "/predict", {"inputs": x.tolist()},
                              {"X-Zoo-Trace-Id": f"req-{side}"})
        assert code == 200 and hdrs["X-Zoo-Trace-Id"] == f"req-{side}"
        _, _, dbg = _call(port, "GET", "/debug/traces?n=50")
        ours = [t for t in dbg["traces"] if t["trace_id"] == f"req-{side}"]
        assert dbg["enabled"] is True and len(ours) == 1
        spans = ours[0]["spans"]
        names[side] = sorted(s["name"] for s in spans)
        root = next(s for s in spans if s["name"] == "serving/request")
        assert root["parent_id"] is None and root["fields"] == {
            "path": "/predict", "status": 200}
        ids = {s["span_id"] for s in spans}
        assert all(s["parent_id"] in ids for s in spans if s is not root)
        _, _, one = _call(port, "GET", f"/debug/trace/req-{side}")
        assert one["n_spans"] == len(spans)
        _, _, docs[side] = _call(port, "GET",
                                 f"/debug/trace/req-{side}?chrome=1")
        _, _, inc = _call(port, "GET", "/debug/traces?since=0")
        assert inc["seq"] >= len(inc["spans"]) > 0
    assert names["port"] == names["jax"] == sorted([
        "serving/request", "serving/queue_wait", "serving/pad",
        "serving/predict", "serving/scatter"])
    assert [e["ph"] for e in docs["port"]["traceEvents"]] == \
        [e["ph"] for e in docs["jax"]["traceEvents"]]
    # a request without the header gets a minted id, a hostile one is
    # replaced
    for side in SIDES:
        port = servers[side]["main"].port
        _, hdrs, _ = _post(port, "/predict", {"inputs": [[0.5] * 16]})
        minted = hdrs["X-Zoo-Trace-Id"]
        assert len(minted) == 16 and int(minted, 16) >= 0
        _, hdrs, _ = _post(port, "/generate", {"prompt": [1]},
                           {"X-Zoo-Trace-Id": "bad id!"})
        assert hdrs["X-Zoo-Trace-Id"] not in ("bad id!", minted)


def test_generate_requests_are_traced_like_jax(servers):
    names = {}
    for side in SIDES:
        port = servers[side]["main"].port
        code, hdrs, _ = _post(port, "/generate",
                              {"prompts": [[3, 4, 5], [6]],
                               "max_new_tokens": 3},
                              {"X-Zoo-Trace-Id": f"gen-{side}"})
        assert code == 200 and hdrs["X-Zoo-Trace-Id"] == f"gen-{side}"
        _, _, one = _call(port, "GET", f"/debug/trace/gen-{side}")
        names[side] = sorted(s["name"] for s in one["spans"])
        root = next(s for s in one["spans"]
                    if s["name"] == "serving/request")
        assert all(s["parent_id"] == root["span_id"]
                   for s in one["spans"] if s is not root)
    # one admission and one retirement per sequence
    assert names["port"] == names["jax"] == sorted(
        ["serving/request"] + ["decode/admit", "decode/retire"] * 2)


def test_trace_disabled_sends_no_header(servers, monkeypatch):
    monkeypatch.setenv("ZOO_TPU_TRACE", "0")
    for side in SIDES:
        code, hdrs, _ = _post(servers[side]["main"].port, "/predict",
                              {"inputs": [[0.5] * 16]},
                              {"X-Zoo-Trace-Id": "ignored"})
        assert code == 200 and "X-Zoo-Trace-Id" not in hdrs


def test_routes_not_ported_answer_404(servers):
    """The fleet's routes on single-model servers answer as the JAX
    package's: ``/debug/fleet`` and ``/debug/rollout`` 404 (no fleet
    fronts them); ``/generate/prefill`` and ``/generate/handoff`` 501
    without a generation batcher and 400 on a body without a prompt or
    a blob where one is mounted."""
    cases = [("main", "GET", "/debug/fleet", None, 404),
             ("main", "GET", "/debug/rollout", None, 404),
             ("plain", "GET", "/debug/fleet", None, 404),
             ("plain", "GET", "/debug/rollout", None, 404),
             ("plain", "POST", "/generate/prefill", b'{"prompt": [1]}', 501),
             ("plain", "POST", "/generate/handoff", b'{"handoff": {}}', 501),
             ("main", "POST", "/generate/prefill", b"{}", 400),
             ("main", "POST", "/generate/handoff", b'{"handoff": 1}', 400),
             ("main", "POST", "/generate/handoff", b'{"handoff": {}}', 400)]
    for which, method, path, body, want in cases:
        got = _both(servers, which, method, path, body)
        assert got["port"][0] == got["jax"][0] == want, (which, path)
        assert got["port"][2] == got["jax"][2], (which, path)


class _FrontDoor:
    """A duck-typed fleet front door: ``fleet_status`` and the batcher
    surface, with no requests ever batched."""

    def __init__(self, telemetry=None):
        if telemetry is not None:
            self.telemetry = telemetry

    def fleet_status(self):
        return {"replicas": []}

    def start(self):
        return self

    def stop(self):
        pass

    def batchable(self, xs):
        return False

    def stats(self):
        return {"enabled": True, "fleet": True}


class _Collector:
    def start(self):
        return self

    def stop(self):
        pass


def test_start_installs_fleet_objectives_like_jax():
    """``InferenceServer.start`` installs the ``fleet`` objectives on a
    front door with ``fleet_status`` and the ``fed`` ones only when it
    also has a collector mounted, as the JAX package does."""
    got = {}
    for side, sv, slo in (("port", tsv, tslo), ("jax", jsv, jslo)):
        for mounted in (False, True):
            slo.reset_slo()
            srv = sv.InferenceServer(
                _StubModel(), port=0,
                batcher=_FrontDoor(_Collector() if mounted else None),
                gen_batcher=None).start()
            try:
                ids = {o["id"] for o in
                       slo.get_engine().status()["objectives"]}
            finally:
                srv.stop()
            got[side, mounted] = ids
            assert "fleet_replicas_admitting" in ids
            assert ("fed_latency_p99" in ids) == mounted
        slo.reset_slo()
    assert got["port", False] == got["jax", False]
    assert got["port", True] == got["jax", True]


# -- the judgement layer's routes (these reset both registries: last) ---------

def _fresh_judgement_plane():
    """Both packages' registries, histories, engines and forecasters
    emptied, then the serving and forecast objectives installed in each,
    as ``InferenceServer.start`` installs them."""
    from analytics_zoo_tpu.common import observability as jobs
    from analytics_zoo_tpu.common import timeseries as jts
    for obs, slo, fc, ts in ((tobs, tslo, tfc, tts), (jobs, jslo, jfc, jts)):
        obs.reset_metrics()
        slo.reset_slo()
        fc.reset_forecast()
        ts.reset_history()
        slo.ensure_default_slos("serving")
        slo.ensure_default_slos("forecast")
        fc.ensure_forecaster()


def test_debug_slo_matches_jax(servers):
    _fresh_judgement_plane()
    first = _both(servers, "main", "GET", "/debug/slo")
    x = json.dumps({"inputs": [[0.25] * 16]}).encode()
    for side in SIDES:
        port = servers[side]["main"].port
        for _ in range(10):
            assert _post(port, "/predict", x)[0] == 200
        for _ in range(2):
            assert _call(port, "GET", "/nope")[0] == 404
    second = _both(servers, "main", "GET", "/debug/slo")
    passive = _both(servers, "main", "GET", "/debug/slo?tick=0")
    for got in (first, second, passive):
        assert got["port"][0] == got["jax"][0] == 200
    assert passive["port"][2]["ticks"] == second["port"][2]["ticks"] == 2

    def judged(status):
        return [{k: v for k, v in o.items()
                 if k not in ("value", "window_results", "since")}
                for o in status["objectives"]]

    assert judged(first["port"][2]) == judged(first["jax"][2])
    assert judged(second["port"][2]) == judged(second["jax"][2])
    rules = {o["id"]: o for o in second["port"][2]["objectives"]}
    jrules = {o["id"]: o for o in second["jax"][2]["objectives"]}
    # 2 of 13 requests failed: burn 15.4 against the budget of 1%
    assert rules["serving_error_rate"]["state"] == "breach"
    assert rules["serving_error_rate"]["value"] == \
        jrules["serving_error_rate"]["value"] == 2 / 13
    assert rules["serving_latency_p99"]["state"] == "no_data"
    assert rules["forecast_kv_pages_eta"]["state"] == "ok"


def test_metrics_history_matches_jax(servers):
    _fresh_judgement_plane()
    path = "/debug/metrics/history?family=zoo_tpu_serving_requests_total"
    x = json.dumps({"inputs": [[0.5] * 16]}).encode()
    # a label set's first sample is its baseline: make it before the
    # history's first sample, so every request below counts in a delta
    for side in SIDES:
        assert _post(servers[side]["main"].port, "/predict", x)[0] == 200
    _both(servers, "main", "GET", path)
    for side in SIDES:
        for _ in range(6):
            assert _post(servers[side]["main"].port, "/predict", x)[0] == 200
    got = _both(servers, "main", "GET", path + "&window=600")

    def sums(payload):
        return {json.dumps(s["labels"], sort_keys=True):
                sum(p["value"] for p in s["points"])
                for s in payload["series"]}

    assert got["port"][0] == got["jax"][0] == 200
    assert sums(got["port"][2]) == sums(got["jax"][2])
    assert sums(got["port"][2])[json.dumps(
        {"path": "/predict", "status": "200"}, sort_keys=True)] == 6
    fams = _both(servers, "main", "GET", "/debug/metrics/history")
    assert {f["family"] for f in fams["port"][2]["families"]} >= {
        "zoo_tpu_serving_requests_total", "zoo_tpu_serving_queue_depth",
        "zoo_tpu_serving_request_seconds"}
    for q in ("window=0", "window=x", "window=-1"):
        bad = _both(servers, "main", "GET", path + "&" + q)
        assert bad["port"][0] == bad["jax"][0] == 400
        assert bad["port"][2] == bad["jax"][2]


@pytest.mark.parametrize("method,path", [
    ("GET", "/metrics?fleet=1"), ("GET", "/debug/fleet/telemetry"),
    ("GET", "/debug/metrics/history?fleet=1")])
def test_fleet_routes_answer_404_like_jax(servers, method, path):
    got = _both(servers, "main", method, path)
    assert got["port"][0] == got["jax"][0] == 404
    assert got["port"][2] == got["jax"][2]
