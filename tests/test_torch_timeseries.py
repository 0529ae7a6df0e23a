"""The port's metric history (``common/timeseries.py``) against the JAX
package's: the same registry operations, drawn from a numpy seed, go
into a ``MetricsRegistry`` of each package; both ``MetricHistory``
stores sample them at the same injected times and must answer exactly
alike: ``series()`` per family for raw and tier windows, label filters,
``families()``, ``stats()`` and ``export()``, cap evictions, and the
listener and global-store contracts. No test sleeps."""

import numpy as np
import pytest

from analytics_zoo_tpu.common import observability as jobs
from analytics_zoo_tpu.common import timeseries as jts
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.common import slo as tslo
from analytics_zoo_tpu_torch.common import timeseries as tts

SIDES = ((tobs, tts), (jobs, jts))
BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


@pytest.fixture(autouse=True)
def _fresh_port_history(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_SLO_TICK_S", "0")
    tslo.reset_slo()
    tts.reset_history()
    yield
    tslo.reset_slo()
    tts.reset_history()


def draw_ops(seed, n_steps, dt=7.0):
    """Per step: (ts, [ops]) with counter, gauge and histogram ops of the
    serving families, two label sets each."""
    rs = np.random.RandomState(seed)
    steps = []
    for i in range(n_steps):
        ops = []
        for path in ("/predict", "/generate"):
            for status in ("200", "500"):
                k = int(rs.randint(0, 6 if status == "200" else 2))
                if k:
                    ops.append(("c", "zoo_tpu_serving_requests_total",
                                {"path": path, "status": status}, k))
            for v in rs.exponential(0.08 if path == "/predict" else 0.4,
                                    size=int(rs.randint(0, 5))):
                ops.append(("h", "zoo_tpu_serving_request_seconds",
                            {"path": path}, float(v)))
        ops.append(("g", "zoo_tpu_serving_queue_depth", {},
                    float(rs.randint(0, 40))))
        ops.append(("g", "zoo_tpu_serving_gen_free_pages",
                    {"pool": str(rs.randint(0, 2))},
                    float(rs.randint(0, 64))))
        steps.append((i * dt + float(rs.rand()), ops))
    return steps


def apply_ops(reg, ops):
    for kind, name, labels, v in ops:
        if kind == "c":
            reg.counter(name, help="h", labels=labels).inc(v)
        elif kind == "g":
            reg.gauge(name, help="h", labels=labels).set(v)
        else:
            reg.histogram(name, help="h", labels=labels,
                          buckets=BUCKETS).observe(v)


def twin(steps, **kw):
    """Both packages' histories after sampling ``steps``."""
    kw.setdefault("tiers", [(30.0, 600.0), (300.0, 3600.0)])
    out = []
    for obs, ts in SIDES:
        reg = obs.MetricsRegistry()
        h = ts.MetricHistory(registry=reg, clock=lambda: 0.0, **kw)
        for t, ops in steps:
            apply_ops(reg, ops)
            h.tick(now=t)
        out.append(h)
    return out


FAMILIES = ("zoo_tpu_serving_requests_total",
            "zoo_tpu_serving_request_seconds",
            "zoo_tpu_serving_queue_depth",
            "zoo_tpu_serving_gen_free_pages",
            "zoo_tpu_tsdb_samples_total", "zoo_tpu_no_such_family")


@pytest.mark.parametrize("window", [None, 45.0, 119.0, 500.0, 3000.0])
def test_series_match_reference_raw_and_tiers(window):
    steps = draw_ops(0, 160)
    th, jh = twin(steps, raw_retention_s=120.0)
    now = steps[-1][0]
    for fam in FAMILIES:
        t = th.series(fam, window_s=window, now=now)
        j = jh.series(fam, window_s=window, now=now)
        assert t == j, fam
    # the windows above reach the raw ring and both tiers
    assert {th.series(FAMILIES[0], window_s=w, now=now)["source"]
            for w in (45.0, 500.0, 3000.0)} == {"raw", "tier:30",
                                                "tier:300"}


def test_label_filter_families_stats_export_match_reference():
    steps = draw_ops(1, 60)
    th, jh = twin(steps)
    now = steps[-1][0]
    for labels in ({"path": "/predict"}, {"path": "/generate",
                                          "status": "500"}, {"x": "y"}):
        for fam in FAMILIES[:2]:
            assert th.series(fam, window_s=200, now=now, labels=labels) \
                == jh.series(fam, window_s=200, now=now, labels=labels)
    assert th.families() == jh.families()
    assert th.stats() == jh.stats()
    assert th.export(window_s=300, now=now) == \
        jh.export(window_s=300, now=now)
    assert len(th) == len(jh)


def test_counter_reset_and_histogram_summary_match_reference():
    """A source restart (counters falling) clamps to zero deltas, and a
    window's histogram summary interpolates the same quantiles."""
    hs = []
    for obs, ts in SIDES:
        h = ts.MetricHistory(registry=None, clock=lambda: 0.0)
        for i, reg_ops in enumerate(([("c", "zoo_tpu_x_total", {}, 50)],
                                     [("c", "zoo_tpu_x_total", {}, 7)],
                                     [("c", "zoo_tpu_x_total", {}, 9)])):
            reg = obs.MetricsRegistry()
            apply_ops(reg, reg_ops + [
                ("h", "zoo_tpu_y_seconds", {}, v)
                for v in np.linspace(0.001, 0.3 * (i + 1), 9 + i)])
            h.append(10.0 * i, reg.snapshot())
        hs.append(h)
    for fam in ("zoo_tpu_x_total", "zoo_tpu_y_seconds"):
        assert hs[0].series(fam, window_s=100, now=20.0) == \
            hs[1].series(fam, window_s=100, now=20.0)
    pts = hs[0].series("zoo_tpu_x_total", window_s=100,
                       now=20.0)["series"][0]["points"]
    assert [p["value"] for p in pts] == [0.0, 2.0]
    with pytest.raises(ValueError):
        hs[0].sample()


@pytest.mark.parametrize("caps", [dict(raw_max=5),
                                  dict(max_bytes=65536),
                                  dict(raw_retention_s=30.0)])
def test_caps_evict_like_reference(caps):
    steps = draw_ops(2, 120, dt=3.0)
    # widen the snapshots so the byte cap binds
    steps = [(t, ops + [("g", "zoo_tpu_wide", {"i": str(i)}, 1.0)
                        for i in range(40)]) for t, ops in steps]
    th, jh = twin(steps, **caps)
    assert th.stats() == jh.stats()
    now = steps[-1][0]
    assert th.baseline(now, 60.0)[0] == jh.baseline(now, 60.0)[0]
    assert th.series(FAMILIES[0], window_s=1000.0, now=now) == \
        jh.series(FAMILIES[0], window_s=1000.0, now=now)
    st = th.stats()
    assert st["raw_samples"] >= 2 and (
        st["evictions"] > 0 or "raw_retention_s" in caps)


def test_listeners_and_global_history():
    h = tts.get_history()
    assert tts.get_history() is h
    assert h._registry is tobs.get_registry()
    seen = []

    def good(hist, ts):
        seen.append(ts)

    def bad(hist, ts):
        raise RuntimeError("a bad listener")

    h.add_listener(bad)
    h.add_listener(good)
    h.add_listener(good)  # idempotent per function
    h.tick(now=5.0)
    h.tick(now=6.0)
    assert seen == [5.0, 6.0]
    h.remove_listener(good)
    h.tick(now=7.0)
    assert seen == [5.0, 6.0]
    # each sample counts itself in the registry it samples
    snap = tobs.snapshot()
    assert snap["zoo_tpu_tsdb_resident_bytes"]["values"][0]["value"] == \
        h.stats()["resident_bytes"]
    tts.reset_history()
    assert tts.get_history() is not h


def test_slo_engine_reads_the_shared_history():
    engine = tslo.get_engine()
    assert engine.history is tts.get_history()
    reg = tobs.MetricsRegistry()
    e = tslo.SLOEngine(registry=reg, clock=lambda: 0.0)
    assert e.history is not tts.get_history()
    e.tick(now=1.0)
    e.tick(now=2.0)
    assert len(e.history) == 2
