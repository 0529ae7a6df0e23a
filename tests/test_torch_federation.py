"""The port's telemetry federation (``common/federation.py``) against the
JAX package's: ``merge_snapshots`` and ``render_prometheus`` over
registries drawn from a numpy seed (identical and mismatched bucket
layouts, per-source gauges, a type conflict, labels that need
escaping), the ``TraceAggregator``'s stitched traces and Chrome export,
and a ``TelemetryCollector`` of each package scraping the same stub
HTTP sources (one serving a port registry and trace ring, one the JAX
package's) at the same injected times: merged snapshot, Prometheus text,
status, stitched traces, the merged history and the ``zoo_tpu_fed_*``
metrics must agree exactly. No test sleeps."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np
import pytest

from analytics_zoo_tpu.common import federation as jfed
from analytics_zoo_tpu.common import observability as jobs
from analytics_zoo_tpu.common import tracing as jtr
from analytics_zoo_tpu_torch.common import federation as tfed
from analytics_zoo_tpu_torch.common import forecast as tfc
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.common import slo as tslo
from analytics_zoo_tpu_torch.common import timeseries as tts
from analytics_zoo_tpu_torch.common import tracing as ttr

BUCKETS = [(0.01, 0.1, 0.5, 1.0), (0.01, 0.05, 0.1, 1.0, 5.0),
           (0.1, 0.5, 1.0)]


@pytest.fixture(autouse=True)
def _fresh_port_plane(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_SLO_TICK_S", "0")
    monkeypatch.setenv("ZOO_TPU_FED_TICK_S", "0")
    resets = (tslo.reset_slo, tts.reset_history, tfc.reset_forecast,
              tobs.reset_metrics, ttr.reset_tracing)
    for reset in resets:
        reset()
    yield
    for reset in resets:
        reset()


def fill(reg, rs, layout, conflict=False):
    """Random serving families in ``reg``; ``conflict`` registers
    ``zoo_tpu_mixed`` as a gauge instead of a counter."""
    for path in ("/predict", 'we"ird\\path\n'):
        reg.counter("zoo_tpu_serving_requests_total", help="requests",
                    labels={"path": path, "status": "200"}).inc(
            int(rs.randint(0, 50)))
        h = reg.histogram("zoo_tpu_serving_request_seconds",
                          help="latency", labels={"path": path},
                          buckets=layout)
        for v in rs.exponential(0.2, size=int(rs.randint(0, 30))):
            h.observe(float(v))
    reg.gauge("zoo_tpu_serving_queue_depth", help="depth").set(
        float(rs.randint(0, 9)))
    reg.gauge("zoo_tpu_fleet_up", help="up",
              labels={"replica": "pinned"}).set(1.0)
    if conflict:
        reg.gauge("zoo_tpu_mixed", help="").set(3.0)
    else:
        reg.counter("zoo_tpu_mixed", help="mixed").inc(2)


@pytest.mark.parametrize("seed", range(3))
def test_merge_and_render_match_reference(seed):
    rs = np.random.RandomState(seed)
    snaps = {}
    for i, name in enumerate(("r1", "r0", "router")):
        state = rs.get_state()
        treg, jreg = tobs.MetricsRegistry(), jobs.MetricsRegistry()
        layout = BUCKETS[(i + seed) % 3]
        fill(treg, rs, layout, conflict=(name == "r1"))
        rs.set_state(state)
        fill(jreg, rs, layout, conflict=(name == "r1"))
        assert json.dumps(treg.snapshot()) == json.dumps(jreg.snapshot())
        snaps[name] = treg.snapshot()
    merged, conflicts = tfed.merge_snapshots(snaps)
    assert (merged, conflicts) == jfed.merge_snapshots(snaps)
    assert conflicts == [{"metric": "zoo_tpu_mixed", "source": "r1",
                          "type": "gauge", "kept_type": "counter"}]
    text = tfed.render_prometheus(merged)
    assert text == jfed.render_prometheus(merged)
    assert text.count("# TYPE zoo_tpu_serving_request_seconds") == 1
    assert tfed.render_prometheus({}) == jfed.render_prometheus({}) == ""
    # mismatched layouts merge over the shared bounds only
    hist = merged["zoo_tpu_serving_request_seconds"]["values"][0]
    if seed == 0:
        assert sorted(hist["buckets"], key=float) == ["0.1", "1", "+Inf"]


def _span(tid, sid, name, t0, dur, parent=None, **fields):
    return {"trace_id": tid, "span_id": sid, "parent_id": parent,
            "name": name, "t_start": t0, "dur_s": dur,
            "thread": "t", "fields": fields}


def test_aggregator_matches_reference():
    rs = np.random.RandomState(0)
    batches = []
    for k in range(12):
        src = ("router", "r0", "r1")[k % 3]
        spans = [_span(f"T{rs.randint(0, 6)}", f"s{k}_{i}",
                       ("serving/request", "serving/pad",
                        "decode/step")[rs.randint(0, 3)],
                       float(100 + rs.rand() * 5), float(rs.rand() * 0.2),
                       parent=None if i == 0 else f"s{k}_0", i=i)
                 for i in range(int(rs.randint(1, 5)))]
        spans.append({"no": "trace id"})
        batches.append((src, spans))
    aggs = [tfed.TraceAggregator(capacity=20),
            jfed.TraceAggregator(capacity=20)]
    for src, spans in batches:
        assert aggs[0].add_spans(src, spans) == \
            aggs[1].add_spans(src, spans)
    assert len(aggs[0]) == len(aggs[1]) == 20
    for tid in [f"T{i}" for i in range(6)] + ["nope"]:
        assert aggs[0].trace(tid) == aggs[1].trace(tid)
        assert aggs[0].chrome(tid) == aggs[1].chrome(tid)
    assert aggs[0].chrome() == aggs[1].chrome()
    for n in (0, 1, 3, 50):
        assert aggs[0].recent(n) == aggs[1].recent(n)
    aggs[0].clear()
    assert len(aggs[0]) == 0


class _Source:
    """A replica-shaped telemetry source: a real HTTP server handing
    out its registry's snapshot and a cursor-correct span feed."""

    def __init__(self, name, obs, tracing):
        self.name = name
        self.obs, self.tracing = obs, tracing
        self.reg = obs.MetricsRegistry()
        self.store = tracing.TraceStore(capacity=512)
        src = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                u = urlsplit(self.path)
                if u.path == "/metrics/json":
                    body = {"ts": 0.0, "metrics": src.reg.snapshot()}
                else:
                    since = int(parse_qs(u.query).get("since", ["0"])[0])
                    seq, recs = src.store.records_since(since)
                    body = {"seq": seq,
                            "spans": [r.to_dict() for r in recs]}
                raw = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def span(self, tid, sid, t0):
        self.store.add(self.tracing.SpanRecord(
            tid, sid, None, "serving/request", t0, 0.1, "t", {}))

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class _Holder:
    """Router-shaped: only ``pool.replicas``."""

    def __init__(self, replicas):
        self.pool = type("Pool", (), {})()
        self.pool.replicas = replicas


def test_collector_matches_reference_on_stub_sources():
    s0 = _Source("r0", tobs, ttr)
    s1 = _Source("r1", jobs, jtr)
    holder = _Holder([s0, s1])
    cols = [tfed.TelemetryCollector(holder, tick_s=0, clock=lambda: 0.0),
            jfed.TelemetryCollector(holder, tick_s=0, clock=lambda: 0.0)]
    # a trace ring's seq never resets in a process: each package's
    # router cursor is compared as its advance from here
    seq0 = [ttr.get_store().latest_seq(), jtr.get_store().latest_seq()]

    def status(i, st):
        st["sources"]["router"]["trace_cursor"] -= seq0[i]
        return st
    rs = np.random.RandomState(0)
    try:
        for k, now in enumerate((100.0, 103.5, 110.0, 140.0)):
            for s in (s0, s1):
                s.reg.counter("zoo_tpu_serving_requests_total",
                              labels={"path": "/predict",
                                      "status": "200"}).inc(
                    int(rs.randint(1, 9)))
                if rs.rand() < 0.5:
                    s.reg.counter("zoo_tpu_serving_errors_total",
                                  labels={"kind": "internal"}).inc()
                h = s.reg.histogram("zoo_tpu_serving_request_seconds",
                                    labels={"path": "/predict"})
                for v in rs.exponential(0.3, size=5):
                    h.observe(float(v))
                s.span(f"T{k}", f"{s.name}-{k}", now)
            if k == 3:
                s1.stop()  # r1 dies; its last snapshot is carried
            stats = [status(i, c.tick(now=now)) for i, c in enumerate(cols)]
            assert stats[0] == stats[1], k
            assert cols[0].merged_snapshot() == cols[1].merged_snapshot()
            assert cols[0].fleet_prometheus() == cols[1].fleet_prometheus()
        st = status(0, cols[0].status())
        assert st == status(1, cols[1].status())
        assert st["sources"]["r1"]["carried_forward"] is True
        assert st["sources"]["r0"]["trace_cursor"] == 4
        for tid in ("T0", "T1", "T2", "T3"):
            assert cols[0].aggregator.trace(tid) == \
                cols[1].aggregator.trace(tid)
        assert cols[0].aggregator.trace("T0")["sources"] == ["r0", "r1"]
        assert cols[0].aggregator.trace("T0")["n_spans"] == 2
        for fam in ("zoo_tpu_serving_requests_total",
                    "zoo_tpu_serving_request_seconds",
                    "zoo_tpu_fed_error_ratio"):
            assert cols[0].history.series(fam, window_s=60, now=140.0) \
                == cols[1].history.series(fam, window_s=60, now=140.0)
        # the fed gauges and scrape counters of each package's registry
        tsnap, jsnap = tobs.snapshot(), jobs.snapshot()
        fed = sorted(k for k in tsnap if k.startswith("zoo_tpu_fed_"))
        assert fed == sorted(k for k in jsnap
                             if k.startswith("zoo_tpu_fed_"))
        assert "zoo_tpu_fed_latency_p99_seconds" in fed
        for k in fed:
            assert tsnap[k] == jsnap[k], k
    finally:
        s0.stop()


def test_collector_ticker_and_router_source():
    ttr.get_store().add(ttr.SpanRecord("L1", "a", None, "serving/request",
                                       5.0, 0.1, "t", {}))
    col = tfed.TelemetryCollector(_Holder([]), tick_s=0.01)
    assert col.tick()["sources"]["router"]["spans_collected"] == 1
    assert col.aggregator.trace("L1")["sources"] == ["router"]
    col.start()
    assert col._thread is not None and col._thread.is_alive()
    col.stop()
    assert col._thread is None
    idle = tfed.TelemetryCollector(_Holder([]), tick_s=0)
    assert idle.start()._thread is None
