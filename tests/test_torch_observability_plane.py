"""The port's observability plane around the judgement layer: the event
log's size-based rotation (no line lost or doubled across a rename,
from one thread or four; gzipped and raw segments; the keep window; the
bytes gauge against the disk), the ``faults/armed`` and
``faults/injected`` records against the JAX package's, the HTTP routes
on a CPU server (``/debug/dashboard``'s bytes against the reference's,
``POST /debug/profile`` with ``torch.profiler``, the fleet routes'
404s, and a mounted federation collector behind ``/metrics?fleet=1``,
``/debug/fleet/telemetry``, ``/debug/traces?fleet=1``, the stitched
``/debug/trace/<id>`` and ``/debug/metrics/history?fleet=1``), and the
three serving examples at ``--device cpu``. No test sleeps on the wall
clock."""

import glob
import gzip
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.common import observability as jobs
from analytics_zoo_tpu.pipeline.inference import serving as jsv
from analytics_zoo_tpu_torch.common import faults as tfaults
from analytics_zoo_tpu_torch.common import federation as tfed
from analytics_zoo_tpu_torch.common import forecast as tfc
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.common import slo as tslo
from analytics_zoo_tpu_torch.common import timeseries as tts
from analytics_zoo_tpu_torch.common import tracing as ttr

TIMEOUT = 60


@pytest.fixture(autouse=True)
def _fresh_port_plane(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_SLO_TICK_S", "0")
    monkeypatch.setenv("ZOO_TPU_FED_TICK_S", "0")
    resets = (tslo.reset_slo, tts.reset_history, tfc.reset_forecast,
              tobs.reset_metrics, ttr.reset_tracing, tfaults.reset_faults)
    for reset in resets:
        reset()
    yield
    for reset in resets:
        reset()


# -- event-log rotation -------------------------------------------------------

def _segments(path):
    """Every line of the live file and its rotated segments."""
    lines = []
    for seg in glob.glob(str(path) + ".*"):
        opener = gzip.open if seg.endswith(".gz") else open
        with opener(seg, "rt", encoding="utf-8") as f:
            lines += f.read().splitlines()
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            lines += f.read().splitlines()
    return [json.loads(x) for x in lines]


def _on_disk(path):
    return sum(os.path.getsize(p) for p in
               glob.glob(str(path) + ".*") + [str(path)])


def _gauge(name):
    fam = tobs.snapshot().get(name)
    return fam["values"][0]["value"] if fam else None


@pytest.mark.parametrize("threads", [1, 4])
def test_rotation_loses_and_doubles_no_line(tmp_path, monkeypatch,
                                            threads):
    path = tmp_path / "events.jsonl"
    monkeypatch.setenv("ZOO_TPU_EVENT_LOG", str(path))
    monkeypatch.setenv("ZOO_TPU_EVENT_LOG_MAX_MB", "0.002")
    monkeypatch.setenv("ZOO_TPU_EVENT_LOG_KEEP", "1000")
    per = 240 // threads

    def write(k):
        for i in range(per):
            tobs.event("unit/rotate", idx=k * per + i, pad="x" * 40)

    ts = [threading.Thread(target=write, args=(k,))
          for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    rotated = glob.glob(str(path) + ".*.gz")
    assert len(rotated) >= 8
    assert _gauge("zoo_tpu_event_log_rotations_total") == len(rotated)
    assert _gauge("zoo_tpu_event_log_bytes") == _on_disk(path)
    idx = sorted(r["idx"] for r in _segments(path))
    assert idx == list(range(240))


def test_rotation_keep_window_and_raw_segments(tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    monkeypatch.setenv("ZOO_TPU_EVENT_LOG", str(path))
    monkeypatch.setenv("ZOO_TPU_EVENT_LOG_MAX_MB", "0.001")
    monkeypatch.setenv("ZOO_TPU_EVENT_LOG_KEEP", "2")
    monkeypatch.setenv("ZOO_TPU_EVENT_LOG_GZIP", "0")
    for i in range(100):
        tobs.event("unit/rotate", idx=i, pad="y" * 30)
    names = sorted(os.path.basename(p)
                   for p in glob.glob(str(path) + ".*"))
    assert names == ["events.jsonl.1", "events.jsonl.2"]
    assert _gauge("zoo_tpu_event_log_bytes") == _on_disk(path)
    kept = [r["idx"] for r in _segments(path)]
    assert sorted(kept) == list(range(100 - len(kept), 100))
    # a raw segment beside gzipped ones still counts toward the bytes
    monkeypatch.setenv("ZOO_TPU_EVENT_LOG_GZIP", "1")
    for i in range(100, 130):
        tobs.event("unit/rotate", idx=i, pad="y" * 30)
    assert os.path.exists(str(path) + ".1.gz")
    assert _gauge("zoo_tpu_event_log_bytes") == _on_disk(path)
    # repointing the log reopens it; without a size cap, no rotation
    other = tmp_path / "other.jsonl"
    monkeypatch.setenv("ZOO_TPU_EVENT_LOG", str(other))
    monkeypatch.delenv("ZOO_TPU_EVENT_LOG_MAX_MB")
    for i in range(50):
        tobs.event("unit/plain", idx=i)
    assert not glob.glob(str(other) + ".*")
    assert [r["idx"] for r in _segments(other)] == list(range(50))


def test_faults_events_match_reference(tmp_path, monkeypatch):
    got = []
    for obs, faults, name in ((tobs, tfaults, "t"), (jobs, jfaults, "j")):
        path = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("ZOO_TPU_EVENT_LOG", str(path))
        faults.arm("batcher/dispatch", "error", times=1)
        with pytest.raises(Exception):
            faults.point("batcher/dispatch").fire()
        faults.point("batcher/dispatch").fire()  # disarmed: a no-op
        faults.arm("generation/decode_step", "delay", seconds=0.0)
        faults.disarm_all()
        obs.reset_metrics()
        faults.reset_faults()
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        for r in recs:
            r.pop("ts")
        got.append(recs)
    assert got[0] == got[1] == [
        {"event": "faults/armed", "point": "batcher/dispatch",
         "kind": "error"},
        {"event": "faults/injected", "point": "batcher/dispatch",
         "kind": "error"},
        {"event": "faults/armed", "point": "generation/decode_step",
         "kind": "delay"}]


# -- the routes on a CPU server -----------------------------------------------

def _call(port, method, path, body=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method=method,
                                 headers=headers or {})
    try:
        r = urllib.request.urlopen(req, timeout=TIMEOUT)
        code, hdrs, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        code, hdrs, raw = e.code, e.headers, e.read()
    return code, hdrs, raw


@pytest.fixture
def server():
    import analytics_zoo_tpu_torch as tzoo
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.inference import (
        DynamicBatcher, InferenceModel, InferenceServer)
    tzoo.init_nncontext(seed=0, device="cpu")
    net = Sequential()
    net.add(L.Dense(4, input_shape=(8,)))
    im = InferenceModel().load_keras_net(
        net, example_inputs=[np.zeros((2, 8), np.float32)])
    batcher = DynamicBatcher(im, max_batch_size=4, max_wait_ms=2)
    srv = InferenceServer(im, port=0, batcher=batcher).start()
    try:
        yield srv
    finally:
        srv.stop()
        tzoo.reset_nncontext()


def test_start_installs_objectives_and_forecaster(server):
    ids = [o["id"] for o in tslo.get_engine().status()["objectives"]]
    assert ids == sorted(
        d["id"] for d in tslo.DEFAULT_SERVING_SLOS
        + tslo.DEFAULT_FORECAST_SLOS)
    assert tfc._on_sample in tts.get_history()._listeners
    code, _, raw = _call(server.port, "GET", "/debug/slo?tick=0")
    assert code == 200 and json.loads(raw)["ticks"] == 0


def test_dashboard_bytes_and_fleet_404s(server):
    code, hdrs, raw = _call(server.port, "GET", "/debug/dashboard?fleet=1")
    assert code == 200
    assert hdrs["Content-Type"] == "text/html; charset=utf-8"
    assert raw == jsv._dashboard_html()
    for path in ("/metrics?fleet=1", "/debug/fleet/telemetry",
                 "/debug/metrics/history?fleet=1"):
        code, _, raw = _call(server.port, "GET", path)
        assert code == 404
        assert json.loads(raw) == {"error": {
            "code": 404, "message": "no fleet telemetry collector mounted"}}
    for q in ("window=0", "window=-3", "window=x"):
        code, _, raw = _call(server.port, "GET",
                             "/debug/metrics/history?" + q)
        assert code == 400 and json.loads(raw)["error"]["code"] == 400


def test_profile_capture_and_busy(server, tmp_path):
    from analytics_zoo_tpu_torch.pipeline.inference import serving
    body = json.dumps({"dir": str(tmp_path), "ms": 300}).encode()
    code, _, raw = _call(server.port, "POST", "/debug/profile", body)
    assert code == 200 and json.loads(raw)["status"] == "capturing"
    code, hdrs, raw = _call(server.port, "POST", "/debug/profile", body)
    assert code == 503
    serving._profile_thread.join(timeout=TIMEOUT)
    traces = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert "traceEvents" in json.load(f)
    for bad in (b"{x", b"{}", b'{"dir": "d", "ms": "soon"}'):
        code, _, raw = _call(server.port, "POST", "/debug/profile", bad)
        want_code, want = jsv.handle_profile(bad)
        assert code == want_code == 400
        assert json.loads(raw)["error"]["message"].split(":")[0] == \
            want["error"]["message"].split(":")[0]


def test_mounted_collector_serves_the_fleet_routes(server):
    col = tfed.TelemetryCollector(_Holder(), tick_s=0)
    server.batcher.telemetry = col
    try:
        code, hdrs, _ = _call(
            server.port, "POST", "/predict",
            json.dumps({"inputs": [[0.5] * 8]}).encode(),
            {"X-Zoo-Trace-Id": "fed-1"})
        assert code == 200
        code, _, raw = _call(server.port, "GET", "/debug/trace/fed-1")
        tr = json.loads(raw)
        assert code == 200 and tr["sources"] == ["router"]
        names = {s["name"] for s in tr["spans"]}
        assert "serving/request" in names and len(names) >= 2
        code, _, raw = _call(server.port, "GET",
                             "/debug/trace/fed-1?chrome=1")
        assert code == 200 and json.loads(raw)["traceEvents"]
        code, _, raw = _call(server.port, "GET", "/debug/traces?fleet=1")
        assert json.loads(raw)["fleet"] is True
        code, hdrs, raw = _call(server.port, "GET", "/metrics?fleet=1")
        assert code == 200 and hdrs["Content-Type"].startswith("text/plain")
        assert "zoo_tpu_serving_requests_total" in raw.decode()
        code, _, raw = _call(server.port, "GET", "/debug/fleet/telemetry")
        assert code == 200 and json.loads(raw)["ticks"] >= 2
        code, _, raw = _call(
            server.port, "GET", "/debug/metrics/history?fleet=1&tick=1"
            "&family=zoo_tpu_fed_sources")
        hist = json.loads(raw)
        assert code == 200 and hist["fleet"] is True
        assert hist["series"][0]["points"][-1]["value"] == 1.0
    finally:
        del server.batcher.telemetry


class _Holder:
    def __init__(self):
        self.pool = type("Pool", (), {"replicas": []})()


def test_start_with_a_collector_installs_the_fleet_objectives():
    """A fleet's front door (a ``FleetRouter``, whose ``start`` mounts a
    collector) installs the ``fleet`` and ``fed`` objectives beside the
    serving ones; a plain batcher with a collector mounted installs
    neither, as the reference keys them on ``fleet_status``."""
    from analytics_zoo_tpu_torch.pipeline.inference import (
        DynamicBatcher, FleetRouter, InferenceServer, Replica, ReplicaPool)
    from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
        InferenceModel
    im = InferenceModel()
    router = FleetRouter(ReplicaPool(replicas=[Replica("r0", im,
                                                       batcher=None)]),
                         probe_interval_s=0)
    router.telemetry = tfed.TelemetryCollector(_Holder(), tick_s=0)
    srv = InferenceServer(router, port=0).start()
    try:
        ids = [o["id"] for o in tslo.get_engine().status()["objectives"]]
    finally:
        srv.stop()
    assert ids == sorted(d["id"] for d in tslo.DEFAULT_SERVING_SLOS
                         + tslo.DEFAULT_FORECAST_SLOS
                         + tslo.DEFAULT_FLEET_SLOS + tslo.DEFAULT_FED_SLOS)
    tslo.reset_slo()
    batcher = DynamicBatcher(im, max_batch_size=2)
    batcher.telemetry = tfed.TelemetryCollector(_Holder(), tick_s=0)
    srv = InferenceServer(im, port=0, batcher=batcher).start()
    try:
        ids = [o["id"] for o in tslo.get_engine().status()["objectives"]]
    finally:
        srv.stop()
    assert ids == sorted(d["id"] for d in tslo.DEFAULT_SERVING_SLOS
                         + tslo.DEFAULT_FORECAST_SLOS)


# -- the serving examples -----------------------------------------------------

SERVING_STATES = {"ok", "breach", "no_data"}


@pytest.mark.parametrize("name,argv", [
    ("inference_serving", ["--requests", "8", "--concurrency", "2"]),
    ("quantized_serving", ["--n", "128", "--epochs", "2"]),
    ("streaming_inference", ["--records", "24", "--rate", "2000"]),
])
def test_serving_examples_run_on_the_cpu(name, argv):
    import importlib

    from analytics_zoo_tpu_torch.common import nncontext
    from analytics_zoo_tpu_torch.examples import EXAMPLES
    assert name in EXAMPLES
    mod = importlib.import_module(f"analytics_zoo_tpu_torch.examples.{name}")
    try:
        out = mod.main(argv + ["--device", "cpu"])
    finally:
        nncontext.reset_nncontext()
    slo = out["slo"]
    assert {"serving_latency_p99", "serving_error_rate",
            "serving_queue_depth", "forecast_kv_pages_eta"} <= set(slo)
    assert set(slo.values()) <= SERVING_STATES
