"""The port's native serving layer (``analytics_zoo_tpu_torch/native/``,
``NativeInferenceServer``) against the JAX package's, on the CPU: both
build their C++ with ``g++`` at first use.

Held: the host arena and its overflow, the slot queue and its blocking
hand-off, each on both packages; ``NativeInferenceServer`` of each
package over the same bridged Dense net, answering the same requests
with the same status codes and JSON bodies (outputs within 1e-5 of
max(1, max|ref|)); ``/metrics`` counting the requests; the trace header
echoed with the request's spans under it; the fallbacks to the Python
queue and the stdlib server, each with one warning; and two processes
building the library at once, ending with one loadable file.

The servers start once per module; every client call has a timeout and
every server is stopped in a ``finally``.
"""

import json
import logging
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as jinit
from analytics_zoo_tpu import native as jnative
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.inference import \
    InferenceModel as JInferenceModel
from analytics_zoo_tpu.pipeline.inference import serving as jsv
from analytics_zoo_tpu_torch import native as tnative
from analytics_zoo_tpu_torch.common import slo as tslo
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.pipeline.inference import serving as tsv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60
NATIVES = {"port": tnative, "jax": jnative}


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


@pytest.fixture(scope="module")
def libs():
    """Each package's library, built (or found built) once."""
    for side, mod in NATIVES.items():
        if mod.load_native() is None:
            pytest.fail(f"{side}: the native library does not build")
    return NATIVES


# -- the arena and the queue, on both packages --------------------------------

@pytest.mark.parametrize("side", sorted(NATIVES))
def test_native_arena(libs, side):
    arena = libs[side].HostArena(1 << 20)
    a = np.arange(100, dtype=np.float32)
    off = arena.put(a)
    np.testing.assert_array_equal(arena.view(off, (100,), np.float32), a)
    assert arena.used >= a.nbytes
    b = np.ones((10, 10), np.int32)
    off2 = arena.put(b)
    assert off2 % 64 == 0 and off2 >= off + a.nbytes
    np.testing.assert_array_equal(arena.view(off2, (10, 10), np.int32), b)
    arena.reset()
    assert arena.used == 0
    arena.close()


@pytest.mark.parametrize("side", sorted(NATIVES))
def test_native_arena_overflow(libs, side):
    arena = libs[side].HostArena(1024)
    with pytest.raises(MemoryError):
        arena.put(np.zeros(4096, np.float32))
    arena.close()


@pytest.mark.parametrize("side", sorted(NATIVES))
def test_native_serving_queue(libs, side):
    q = libs[side].ServingQueue()
    q.put(0)
    q.put(1)
    assert q.size() == 2
    assert q.take() in (0, 1)
    assert q.take(timeout_ms=50) in (0, 1)
    assert q.take(timeout_ms=50) == -1   # empty: a timeout
    q.close()


@pytest.mark.parametrize("side", sorted(NATIVES))
def test_native_queue_blocking_handoff(libs, side):
    q = libs[side].make_serving_queue()
    assert type(q).__name__ == "ServingQueue"
    results = []
    t = threading.Thread(target=lambda: results.append(
        q.take(timeout_ms=2000)))
    t.start()
    q.put(7)
    t.join(timeout=3)
    assert results == [7]


def test_port_inference_model_pool_is_the_native_queue(libs):
    im = InferenceModel(supported_concurrent_num=3)
    assert type(im._queue).__name__ == "ServingQueue"
    assert im.concurrent_slots_free == 3


# -- NativeInferenceServer against the reference's ----------------------------

def _dense(lib):
    m = JSequential() if lib is JL else tmodels.Sequential()
    m.add(lib.Dense(32, activation="relu", input_shape=(16,)))
    m.add(lib.Dense(4))
    return m


@pytest.fixture(scope="module")
def servers(libs):
    """A ``NativeInferenceServer`` per package over the same Dense
    16→32→4 weights, per request (no batcher)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ZOO_TPU_SLO_TICK_S", "0")
    tslo.reset_slo()
    tzoo.init_nncontext(seed=0, device="cpu")
    jinit(seed=0)
    jm = _dense(JL)
    dense = jax.device_get(jm.init_params(jax.random.key(0)))
    jim = JInferenceModel(2).load_keras_net(
        jm, params=jax.tree_util.tree_map(jnp.asarray, dense))
    tim = InferenceModel(2).load_keras_net(_dense(TL), params=dense)
    out = {}
    try:
        out["jax"] = jsv.NativeInferenceServer(jim, port=0,
                                               batcher=None).start()
        out["port"] = tsv.make_inference_server(tim, batcher=None).start()
        assert isinstance(out["port"], tsv.NativeInferenceServer)
        yield out
    finally:
        for srv in out.values():
            srv.stop()
        tzoo.reset_nncontext()
        tslo.reset_slo()
        mp.undo()


X = np.random.RandomState(1).randn(5, 16).astype(np.float32)
REQUESTS = {
    "predict": ("POST", "/predict",
                json.dumps({"inputs": X.tolist()}).encode()),
    "health": ("GET", "/health", None),
    "unknown_route": ("POST", "/nope", b"{}"),
    "get_predict": ("GET", "/predict", None),
    "bad_json": ("POST", "/predict", b"{not json"),
    "no_inputs": ("POST", "/predict", b'{"x": 1}'),
    "generate_without_generator": ("POST", "/generate",
                                   b'{"prompt": [1, 2]}'),
    "unknown_trace": ("GET", "/debug/trace/no-such-id", None),
    "fleet_route_unmounted": ("GET", "/debug/fleet", None),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_native_http_same_contract(servers, name):
    method, path, body = REQUESTS[name]
    got = {side: _call(srv.port, method, path, body)
           for side, srv in servers.items()}
    (tc, th, tb), (jc, jh, jb) = got["port"], got["jax"]
    assert tc == jc, (tc, jc, tb, jb)
    assert th["Connection"] == jh["Connection"] == "close"
    if name == "predict":
        want = np.asarray(jb["outputs"], np.float32)
        np.testing.assert_allclose(
            np.asarray(tb["outputs"], np.float32), want, rtol=1e-5,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))
    elif name == "health":
        assert tb.keys() == jb.keys()
        assert tb["status"] == jb["status"] == "ok"
        assert tb["free_slots"] == jb["free_slots"] == 2
        assert tb["batcher"] == jb["batcher"] == {"enabled": False}
    else:
        assert tb == jb


def test_native_serving_metrics_endpoint(servers):
    port = servers["port"].port
    before = _call(port, "GET", "/metrics")[2]
    _call(port, "POST", *REQUESTS["predict"][1:])
    _call(port, "POST", "/nope", b"{}")
    code, hdrs, text = _call(port, "GET", "/metrics")
    assert code == 200 and hdrs["Content-Type"].startswith("text/plain")

    def count(txt, key):
        for line in txt.splitlines():
            if line.startswith(key + " "):
                return float(line.split()[-1])
        return 0.0
    key = 'zoo_tpu_serving_requests_total{path="/predict",status="200"}'
    assert count(text, key) == count(before, key) + 1
    assert "zoo_tpu_serving_request_seconds_bucket" in text
    assert 'kind="not_found"' in text
    # the scrape counts itself before it renders
    key = 'zoo_tpu_serving_requests_total{path="/metrics",status="200"}'
    assert count(text, key) == count(before, key) + 1


def test_native_serving_trace_header(servers):
    port = servers["port"].port
    code, hdrs, out = _call(port, "POST", *REQUESTS["predict"][1:],
                            headers={"X-Zoo-Trace-Id": "native-1"})
    assert code == 200 and out["outputs"]
    assert hdrs["X-Zoo-Trace-Id"] == "native-1"
    dbg = _call(port, "GET", "/debug/traces?n=50")[2]
    ours = [t for t in dbg["traces"] if t["trace_id"] == "native-1"]
    assert len(ours) == 1
    assert {"serving/request", "serving/predict"} <= \
        {s["name"] for s in ours[0]["spans"]}
    # a header that is not wire-safe is dropped: the reply mints its own
    code, hdrs, _ = _call(port, "POST", *REQUESTS["predict"][1:],
                          headers={"X-Zoo-Trace-Id": "bad/id"})
    assert code == 200 and hdrs["X-Zoo-Trace-Id"] not in (None, "bad/id")


# -- fallbacks and the build --------------------------------------------------

def test_fallbacks_warn_once(monkeypatch, caplog):
    def unavailable():
        raise RuntimeError("native library unavailable (test)")
    monkeypatch.setattr(tnative, "_require", unavailable)
    monkeypatch.setattr(tnative, "_warned", False)
    monkeypatch.setattr(tsv, "_native_warned", False)
    tzoo.init_nncontext(seed=0, device="cpu")
    with caplog.at_level(logging.WARNING, logger="analytics_zoo_tpu_torch"):
        queues = [tnative.make_serving_queue() for _ in range(2)]
        im = InferenceModel(2).load_keras_net(_dense(TL))
        srvs = [tsv.make_inference_server(im, batcher=None)
                for _ in range(2)]
    try:
        assert [type(q).__name__ for q in queues] == ["PyServingQueue"] * 2
        assert [type(s).__name__ for s in srvs] == ["InferenceServer"] * 2
        assert im.concurrent_slots_free == 2
        msgs = [r.getMessage() for r in caplog.records]
        assert sum("native serving queue unavailable" in m
                   for m in msgs) == 1
        assert sum("native front end unavailable" in m for m in msgs) == 1
    finally:
        for s in srvs:
            s._httpd.server_close()


def test_concurrent_builds_leave_one_library(tmp_path):
    code = ("import sys\n"
            "from analytics_zoo_tpu_torch import native as n\n"
            "n.BUILD_DIR = sys.argv[1]\n"
            "lib = n.load_native()\n"
            "assert lib is not None, n.load_error()\n"
            "q = n.ServingQueue(); q.put(5); assert q.take(10) == 5\n"
            "print(n.library_path())\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert os.listdir(tmp_path) == [os.path.basename(paths.pop())]
