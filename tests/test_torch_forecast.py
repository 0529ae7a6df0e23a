"""The port's capacity forecaster (``common/forecast.py``) against the
JAX package's: the trend math on random series, the resource literals,
and a ``Forecaster`` of each package over the same gauge sequences
(drawn from a numpy seed: KV pages draining then idle, both queues
climbing then falling, the event log growing toward its rotation
budget) at the same injected times. ``tick()``, ``status()``, the
``zoo_tpu_forecast_eta_s`` gauges and the ``capacity_forecast``
anomalies must agree exactly. No test sleeps."""

import numpy as np
import pytest

from analytics_zoo_tpu.common import diagnostics as jdiag
from analytics_zoo_tpu.common import forecast as jfc
from analytics_zoo_tpu.common import observability as jobs
from analytics_zoo_tpu.common import timeseries as jts
from analytics_zoo_tpu_torch.common import diagnostics as tdiag
from analytics_zoo_tpu_torch.common import forecast as tfc
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.common import slo as tslo
from analytics_zoo_tpu_torch.common import timeseries as tts

SIDES = ((tobs, tts, tfc, tdiag), (jobs, jts, jfc, jdiag))


@pytest.fixture(autouse=True)
def _fresh_port_plane(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_SLO_TICK_S", "0")
    for reset in (tslo.reset_slo, tts.reset_history, tfc.reset_forecast,
                  tobs.reset_metrics):
        reset()
    yield
    for reset in (tslo.reset_slo, tts.reset_history, tfc.reset_forecast,
                  tobs.reset_metrics):
        reset()


def test_literals_match_reference():
    assert tfc.DEFAULT_RESOURCES == jfc.DEFAULT_RESOURCES
    assert tfc.NO_ETA == jfc.NO_ETA


@pytest.mark.parametrize("seed", range(4))
def test_trend_math_matches_reference(seed):
    rs = np.random.RandomState(seed)
    n = int(rs.randint(1, 30))
    ts = np.cumsum(rs.uniform(0.5, 5.0, n))
    vals = rs.randn(n).cumsum() * 3 + rs.uniform(-2, 2) * ts
    pts = [(float(t), float(v)) for t, v in zip(ts, vals)]
    for alpha in (1.0, 0.3, 0.01):
        assert tfc.ewma(list(vals), alpha) == jfc.ewma(list(vals), alpha)
        for limit in (-50.0, 0.0, float(vals[-1]), 400.0):
            for d in ("down", "up"):
                assert tfc.eta_to_limit(pts, limit, d, alpha) == \
                    jfc.eta_to_limit(pts, limit, d, alpha)
    assert tfc.linear_slope(pts) == jfc.linear_slope(pts)
    assert tfc.linear_slope(pts[:1]) is None
    assert tfc.linear_slope([(1.0, 2.0), (1.0, 3.0)]) is None


def draw_gauges(seed, n=120, dt=2.0):
    """(ts, {(family, labels): value}) per sample."""
    rs = np.random.RandomState(seed)
    out = []
    pages = 512.0
    for i in range(n):
        if i < 60:
            pages = max(pages - rs.uniform(2, 12), 0.0)
        elif i < 80:
            pages = min(pages + rs.uniform(20, 40), 512.0)
        g = {("zoo_tpu_serving_gen_free_pages", ()): pages,
             ("zoo_tpu_serving_queue_depth", (("b", "0"),)):
                 float(min(i * 2 + rs.randint(0, 5), 250) if i < 90
                       else rs.randint(0, 3)),
             ("zoo_tpu_serving_queue_depth", (("b", "1"),)):
                 float(rs.randint(0, 4)),
             ("zoo_tpu_serving_gen_queue_depth", ()):
                 float(rs.randint(0, 3)),
             ("zoo_tpu_event_log_bytes", ()):
                 float(1000 * i + rs.randint(0, 500))}
        out.append((i * dt + float(rs.rand() * 0.5), g))
    return out


def run_forecaster(side, samples, **kw):
    obs, ts, fc, diag = side
    reg = obs.MetricsRegistry()
    hist = ts.MetricHistory(registry=reg, clock=lambda: 0.0)
    f = fc.Forecaster(hist, registry=reg, clock=lambda: 0.0, **kw)
    seen = []
    listener = lambda kind, fields: seen.append((kind, fields))  # noqa: E731
    diag.add_anomaly_listener(listener)
    statuses = []
    try:
        for t, g in samples:
            for (fam, labels), v in g.items():
                reg.gauge(fam, help="h", labels=dict(labels)).set(v)
            hist.tick(now=t)
            statuses.append(f.tick(now=t))
    finally:
        diag.remove_anomaly_listener(listener)
    eta = reg.snapshot()["zoo_tpu_forecast_eta_s"]
    return statuses, f.status(), seen, eta


@pytest.mark.parametrize("kw", [
    dict(window_s=60.0, horizon_s=120.0, min_points=5, min_span_s=10.0,
         alpha=0.3),
    dict(window_s=30.0, horizon_s=600.0, min_points=3, min_span_s=4.0,
         alpha=1.0),
])
def test_forecaster_matches_reference(kw, monkeypatch):
    monkeypatch.setenv("ZOO_TPU_FORECAST_EVENT_LOG_LIMIT_MB", "0.15")
    samples = draw_gauges(0)
    t = run_forecaster(SIDES[0], samples, **kw)
    j = run_forecaster(SIDES[1], samples, **kw)
    for k, (a, b) in enumerate(zip(t[0], j[0])):
        assert a == b, k
    assert t[1:] == j[1:]
    kinds = {f["resource"] for k, f in t[2]}
    assert {"kv_pages", "queue", "event_log"} <= kinds
    # while pages drained the ETA was finite; idle, it is the sentinel
    kv = [s["kv_pages"]["eta_s"] for s in t[0]]
    assert any(e is not None and e < tfc.NO_ETA for e in kv[10:60])
    assert kv[-1] is None
    by_res = {v["labels"]["resource"]: v["value"] for v in t[3]["values"]}
    assert by_res["kv_pages"] == tfc.NO_ETA


def test_event_log_limit_from_rotation_budget(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_EVENT_LOG_MAX_MB", "2")
    monkeypatch.setenv("ZOO_TPU_EVENT_LOG_KEEP", "4")
    got = []
    for obs, ts, fc, _ in SIDES:
        f = fc.Forecaster(ts.MetricHistory(registry=None),
                          registry=obs.MetricsRegistry())
        got.append(f._limit(fc.DEFAULT_RESOURCES[3]))
    assert got[0] == got[1] == 2 * 1048576.0 * 5
    monkeypatch.delenv("ZOO_TPU_EVENT_LOG_MAX_MB")
    f = tfc.Forecaster(tts.MetricHistory(registry=None),
                       registry=tobs.MetricsRegistry())
    st = f.tick(now=1.0)
    assert st["event_log"]["skipped"] == "no limit configured"


def test_ensure_forecaster_rides_the_global_history(monkeypatch):
    f = tfc.ensure_forecaster()
    assert f is tfc.get_forecaster() and f.history is tts.get_history()
    tfc.ensure_forecaster()  # idempotent: one listener
    assert f.history._listeners.count(tfc._on_sample) == 1
    tts.get_history().tick(now=3.0)
    tts.get_history().tick(now=4.0)
    assert f.status()["ticks"] == 2
    eta = tobs.snapshot()["zoo_tpu_forecast_eta_s"]["values"]
    assert {v["labels"]["resource"] for v in eta} == {
        "kv_pages", "queue", "gen_queue", "event_log"}
    tfc.reset_forecast()
    assert tfc._on_sample not in tts.get_history()._listeners
    monkeypatch.setenv("ZOO_TPU_FORECAST", "0")
    assert tfc.ensure_forecaster() is None
