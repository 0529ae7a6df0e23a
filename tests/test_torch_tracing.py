"""The port's tracing copy (``common/tracing.py``) and the Prometheus
exposition of its ``common/observability.py``, against the JAX
package's modules (``tests/test_tracing.py``'s behaviours): ids minted
and adopted, spans nested under their parents, propagation across
threads, the ring's bound, ``recent`` grouping, ``ZOO_TPU_TRACE=0`` as
a no-op that keeps the metrics, the Chrome trace's structure, and the
text exposition family by family.

Both packages' stdlib-only modules run here side by side; structures
are compared with ids and clocks taken out, text exactly.
"""

import json
import threading
import time

import pytest

from analytics_zoo_tpu.common import observability as jobs
from analytics_zoo_tpu.common import tracing as jtr
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.common import tracing as ttr

PAIRS = {"port": (ttr, tobs), "jax": (jtr, jobs)}


@pytest.fixture(autouse=True)
def _fresh():
    for tr, ob in PAIRS.values():
        tr.reset_tracing()
        ob.reset_metrics()
    yield
    for tr, ob in PAIRS.values():
        tr.reset_tracing()
        ob.reset_metrics()


def _shape(spans):
    """Span dicts with ids and clocks replaced by their roles: name,
    parent's name, fields."""
    by_id = {s["span_id"]: s["name"] for s in spans}
    return sorted((s["name"], by_id.get(s["parent_id"]),
                   json.dumps(s["fields"], sort_keys=True))
                  for s in spans)


def _nested(tr, ob):
    with tr.trace("unit/base", trace_id="req-42") as t:
        with ob.span("unit/outer", step=3):
            with ob.span("unit/inner"):
                pass
        t.annotate(status=200, skipped=None)
    return t


def test_ids_minted_adopted_and_sanitized_like_jax():
    with ttr.trace("unit/base") as t:
        assert t.trace_id and t.span_id and len(t.trace_id) == 16
        assert ttr.current() == (t.trace_id, t.span_id)
    assert ttr.current() is None
    assert _nested(ttr, tobs).trace_id == "req-42"
    for raw in ("ok-1_2.3", "bad id\nx", "a" * 64, "a" * 65, "", None,
                "x;y", 7):
        assert ttr.sanitize_trace_id(raw) == jtr.sanitize_trace_id(raw)
    # a hostile header is replaced by a minted id
    with ttr.trace("unit/base", trace_id="bad id") as t:
        assert t.trace_id != "bad id" and ttr.sanitize_trace_id(t.trace_id)
    assert ttr.TRACE_HEADER == jtr.TRACE_HEADER == "X-Zoo-Trace-Id"


def test_spans_nest_under_their_parents_like_jax():
    got = {}
    for name, (tr, ob) in PAIRS.items():
        t = _nested(tr, ob)
        got[name] = [r.to_dict() for r in tr.get_store().spans(t.trace_id)]
    assert _shape(got["port"]) == _shape(got["jax"])
    assert _shape(got["port"]) == sorted([
        ("unit/inner", "unit/outer", "{}"),
        ("unit/outer", "unit/base", '{"step": 3}'),
        ("unit/base", None, '{"status": 200}')])
    assert set(got["port"][0]) == set(got["jax"][0])
    # an orphan span records nothing but still times its histogram
    with tobs.span("unit/orphan"):
        pass
    assert len(ttr.get_store()) == 3
    assert tobs.snapshot()["zoo_tpu_unit_orphan_seconds"]["values"][0][
        "count"] == 1


def test_propagation_across_threads_like_jax():
    got = {}
    for name, (tr, ob) in PAIRS.items():
        def worker(ctx, tr=tr, ob=ob):
            with tr.activate(ctx):
                with ob.span("unit/worker_span"):
                    pass
            tr.record_span(ctx, "unit/explicit", time.time(), 0.001, rows=4)
            tr.record_span(None, "unit/dropped", time.time(), 0.001)

        with tr.trace("unit/base") as t:
            th = threading.Thread(target=worker, args=(tr.current(),))
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
        got[name] = [r.to_dict() for r in tr.get_store().spans(t.trace_id)]
        threads = {s["name"]: s["thread"] for s in got[name]}
        assert threads["unit/worker_span"] == threads["unit/explicit"] != \
            threads["unit/base"]
    assert _shape(got["port"]) == _shape(got["jax"]) == sorted([
        ("unit/explicit", "unit/base", '{"rows": 4}'),
        ("unit/base", None, "{}"),
        ("unit/worker_span", "unit/base", "{}")])


def test_ring_bound_and_incremental_scrape_like_jax():
    for tr, _ in PAIRS.values():
        store = tr.TraceStore(capacity=8)
        for i in range(50):
            store.add(tr.SpanRecord(f"t{i}", f"s{i}", None, "unit/x",
                                    time.time(), 0.0, "main", {}))
        assert len(store) == 8
        assert store.records()[0].trace_id == "t42"  # oldest evicted
        assert store.latest_seq() == 50
        seq, recs = store.records_since(45)
        assert seq == 50 and [r.trace_id for r in recs] == \
            ["t45", "t46", "t47", "t48", "t49"]
        assert store.records_since(50) == (50, [])


def test_buffer_size_from_the_environment(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_TRACE_BUFFER", "5")
    assert ttr.TraceStore().capacity == jtr.TraceStore().capacity == 5
    monkeypatch.setenv("ZOO_TPU_TRACE_BUFFER", "many")
    assert ttr.TraceStore().capacity == jtr.TraceStore().capacity == 4096


def test_recent_groups_by_trace_like_jax():
    got = {}
    for name, (tr, ob) in PAIRS.items():
        with tr.trace("unit/a", trace_id="ta"):
            with ob.span("unit/a_child"):
                pass
        with tr.trace("unit/b", trace_id="tb"):
            pass
        with tr.trace("unit/a2", trace_id="ta"):  # ta is newest again
            pass
        got[name] = tr.get_store().recent(10)
        json.dumps(got[name])
        assert tr.get_store().recent(0) == []
        assert len(tr.get_store().recent(1)) == 1
    for p, j in zip(got["port"], got["jax"]):
        assert set(p) == set(j)
        assert (p["trace_id"], p["n_spans"]) == (j["trace_id"],
                                                 j["n_spans"])
        assert _shape(p["spans"]) == _shape(j["spans"])
    assert [t["trace_id"] for t in got["port"]] == ["ta", "tb"]
    assert got["port"][0]["n_spans"] == 3


def test_trace_disabled_is_a_noop_that_keeps_metrics(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_TRACE", "0")
    for tr, ob in PAIRS.values():
        assert not tr.enabled()
        with tr.trace("unit/base", trace_id="x") as t:
            assert t.trace_id is None
            # the hot-path guard: span_start bails before any work
            assert tr.span_start("unit/child") is None
            with ob.span("unit/child"):
                pass
            tr.record_span(("t", "s"), "unit/x", time.time(), 0.0)
        assert len(tr.get_store()) == 0
        assert tr.current() is None
        snap = ob.snapshot()["zoo_tpu_unit_child_seconds"]["values"][0]
        assert snap["count"] == 1


def test_chrome_trace_structure_like_jax():
    docs = {}
    for name, (tr, ob) in PAIRS.items():
        with tr.trace("unit/base", trace_id="tc") as t:
            with ob.span("unit/child", rows=2):
                pass
        docs[name] = tr.to_chrome_trace([t.trace_id])
        assert tr.to_chrome_trace(["nobody"])["traceEvents"] == []
        json.dumps(docs[name])
    port, ref = docs["port"], docs["jax"]
    assert port["displayTimeUnit"] == ref["displayTimeUnit"] == "ms"

    def strip(evs):
        out = []
        for e in evs:
            e = dict(e)
            e.pop("ts", None)
            e.pop("dur", None)
            if "args" in e:
                e["args"] = {k: v for k, v in e["args"].items()
                             if k not in ("span_id", "parent_id", "name")}
            out.append(json.dumps(e, sort_keys=True))
        return sorted(out)
    assert strip(port["traceEvents"]) == strip(ref["traceEvents"])
    spans = [e for e in port["traceEvents"] if e["ph"] == "X"]
    child = next(s for s in spans if s["name"] == "unit/child")
    root = next(s for s in spans if s["name"] == "unit/base")
    assert child["pid"] == root["pid"]
    assert child["args"]["parent_id"] == root["args"]["span_id"]
    assert child["args"]["rows"] == 2
    for s in spans:  # microseconds
        assert s["ts"] > 1e15 and s["dur"] >= 0
    # dict records, source lanes, and exit-stamped records
    recs = [{"name": "a", "trace_id": "t1", "span_id": "s1",
             "parent_id": None, "t_start": 10.0, "dur_s": 0.5,
             "thread": "w"},
            {"event": "b", "trace_id": "t1", "ts": 100.0, "dur_s": 0.25},
            {"event": "untraced", "ts": 100.0}]
    for lanes in (False, True):
        assert ttr.chrome_events(recs, source_lanes=lanes) == \
            jtr.chrome_events(recs, source_lanes=lanes)


def _record(ob, reg):
    reg.counter("zoo_tpu_unit_requests_total", help="requests",
                labels={"path": "/predict", "status": "200"}).inc(3)
    reg.counter("zoo_tpu_unit_requests_total", help="requests",
                labels={"path": '/we"ird\\p\nath', "status": "500"}).inc()
    reg.counter("zoo_tpu_unit_plain_total").inc(0.5)
    reg.gauge("zoo_tpu_unit_depth", help="queue depth").set(7)
    reg.gauge("zoo_tpu_unit_depth", help="queue depth",
              labels={"replica": "r1"}).set(-2.25)
    h = reg.histogram("zoo_tpu_unit_latency_seconds", help="latency",
                      labels={"path": "/predict"})
    for v in (0.0004, 0.001, 0.003, 0.2, 7.0, 500.0):
        h.observe(v)
    s = reg.histogram("zoo_tpu_unit_size", help="sizes",
                      buckets=ob.SIZE_BUCKETS)
    for v in (1, 3, 32, 40000):
        s.observe(v)
    reg.histogram("zoo_tpu_unit_fill", buckets=(0.5, 1.0)).observe(0.25)


def _families(text):
    fams = {}
    for line in text.splitlines():
        name = line.split()[2] if line.startswith("#") else \
            line.split("{")[0].split()[0]
        for suffix in ("_bucket", "_sum", "_count"):
            if not line.startswith("#") and name.endswith(suffix) and \
                    name[:-len(suffix)] in fams:
                name = name[:-len(suffix)]
        fams.setdefault(name, []).append(line)
    return fams


@pytest.mark.parametrize("family", [
    "zoo_tpu_unit_requests_total", "zoo_tpu_unit_plain_total",
    "zoo_tpu_unit_depth", "zoo_tpu_unit_latency_seconds",
    "zoo_tpu_unit_size", "zoo_tpu_unit_fill"])
def test_prometheus_text_matches_jax_family_by_family(family):
    texts, snaps = {}, {}
    for name, (_, ob) in PAIRS.items():
        reg = ob.MetricsRegistry()
        _record(ob, reg)
        texts[name] = reg.to_prometheus()
        snaps[name] = reg.snapshot()
    port, ref = _families(texts["port"]), _families(texts["jax"])
    assert list(port) == list(ref)
    assert port[family] == ref[family]
    assert snaps["port"][family] == snaps["jax"][family]


def test_process_registry_exposition_and_quantiles_match_jax():
    for _, ob in PAIRS.values():
        _record(ob, ob.get_registry())
    assert tobs.to_prometheus() == jobs.to_prometheus()
    assert tobs.to_prometheus().endswith("\n")
    assert tobs.MetricsRegistry().to_prometheus() == ""
    h_t = tobs.get_registry().histogram("zoo_tpu_unit_latency_seconds",
                                        labels={"path": "/predict"})
    h_j = jobs.get_registry().histogram("zoo_tpu_unit_latency_seconds",
                                        labels={"path": "/predict"})
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert h_t.quantile(q) == h_j.quantile(q)
    buckets = (1.0, 2.0, 4.0)
    for counts in ([0, 0, 0, 0], [1, 0, 0, 0], [0, 3, 1, 0], [2, 0, 0, 5]):
        for q in (0.0, 0.3, 0.5, 0.95, 1.0):
            a = tobs.bucket_quantile(buckets, counts, q)
            b = jobs.bucket_quantile(buckets, counts, q)
            assert a == b or (a != a and b != b)
    with pytest.raises(ValueError):
        tobs.bucket_quantile(buckets, [1, 2, 3], 0.5)
    for v in (0, 1.0, 2.5, 1e15, 1e16, -3.0, 0.1):
        assert tobs._fmt(v) == jobs._fmt(v)
