"""The port's SLO engine (``common/slo.py``) against the JAX package's:
the shipped rule literals, definition validation, and the whole breach
lifecycle. The same registry operations, drawn from a numpy seed in
regimes that breach and recover every default objective, go into a
``MetricsRegistry`` of each package; an engine of each, holding all
five default rule lists, ticks at the same injected times, and
``tick()``/``status()``, the ``slo_breach`` anomalies, the breach
counters and the event log's records must agree exactly (apart from
the events' wall-clock ``ts``). No test sleeps."""

import json

import numpy as np
import pytest

from analytics_zoo_tpu.common import diagnostics as jdiag
from analytics_zoo_tpu.common import observability as jobs
from analytics_zoo_tpu.common import slo as jslo
from analytics_zoo_tpu_torch.common import diagnostics as tdiag
from analytics_zoo_tpu_torch.common import forecast as tfc
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.common import slo as tslo
from analytics_zoo_tpu_torch.common import timeseries as tts

ROLES = ("serving", "fleet", "fed", "forecast", "training")
LISTS = ("DEFAULT_SERVING_SLOS", "DEFAULT_FLEET_SLOS", "DEFAULT_FED_SLOS",
         "DEFAULT_FORECAST_SLOS", "DEFAULT_TRAINING_SLOS")


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


def test_default_rule_literals_match_reference():
    for name in LISTS:
        assert getattr(tslo, name) == getattr(jslo, name), name
    assert tslo._SIGNAL_TYPES == jslo._SIGNAL_TYPES
    assert sorted(tslo._OPS) == sorted(jslo._OPS)
    for role in ROLES:
        te = tslo.SLOEngine(registry=tobs.MetricsRegistry(),
                            clock=lambda: 0.0)
        je = jslo.SLOEngine(registry=jobs.MetricsRegistry(),
                            clock=lambda: 0.0)
        assert tslo.install_defaults(te, role) == \
            jslo.install_defaults(je, role)
        assert tslo.install_defaults(te, role) == 0  # idempotent
        assert te.status() == je.status()
    with pytest.raises(ValueError, match="unknown slo role"):
        tslo.install_defaults(te, "nope")


BAD = [
    {"id": "", "signal": {"type": "gauge", "metric": "m"},
     "threshold": 1.0},
    {"id": "x", "signal": {"type": "nope", "metric": "m"},
     "threshold": 1.0},
    {"id": "x", "signal": {"type": "gauge", "metric": "m"},
     "threshold": 1.0, "windows": []},
    {"id": "x", "signal": {"type": "gauge", "metric": "m"},
     "threshold": 1.0, "windows": [0.0]},
    {"id": "x", "signal": {"type": "gauge", "metric": "m"},
     "threshold": 1.0, "op": "!="},
    {"id": "x", "signal": {"type": "gauge", "metric": "m"}},
    {"id": "x", "signal": {"type": "quantile", "metric": "m", "q": 1.5},
     "threshold": 1.0},
    {"id": "x", "signal": {"type": "ratio", "numerator": {"metric": "n"},
                           "denominator": {"metric": "d"}},
     "objective": 1.0},
    {"id": "x", "signal": {"type": "gauge", "metric": "m"},
     "threshold": 1.0, "bogus": 1},
    {"id": "x", "signal": {"type": "gauge"}, "threshold": 1.0},
]


@pytest.mark.parametrize("bad", BAD)
def test_bad_definitions_raise_like_reference(bad):
    msgs = []
    for lib in (tslo, jslo):
        with pytest.raises(ValueError) as e:
            lib.SLO.from_dict(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def draw_regimes(seed, n_ticks=260, dt=5.0):
    """(ts, ops) per tick: every default objective's families, in
    healthy and breaching regimes that alternate every 40 ticks."""
    rs = np.random.RandomState(seed)
    steps = []
    for i in range(n_ticks):
        bad = (i // 40) % 2 == 1
        ops = []
        n_req = int(rs.randint(1, 12))
        ops.append(("c", "zoo_tpu_serving_requests_total",
                    {"path": "/predict", "status": "200"}, n_req))
        if bad and rs.rand() < 0.8:
            ops.append(("c", "zoo_tpu_serving_errors_total",
                        {"kind": "internal"}, int(rs.randint(1, 6))))
        for v in rs.exponential(0.6 if bad else 0.03, size=n_req):
            ops.append(("h", "zoo_tpu_serving_request_seconds",
                        {"path": "/predict"}, float(v)))
        ops.append(("g", "zoo_tpu_serving_queue_depth", {},
                    float(rs.randint(150, 260) if bad
                          else rs.randint(0, 30))))
        ops.append(("g", "zoo_tpu_fleet_replicas_admitting", {},
                    float(0 if bad and rs.rand() < 0.5 else 2)))
        ops.append(("c", "zoo_tpu_fleet_requests_total", {}, n_req))
        if bad:
            ops.append(("c", "zoo_tpu_fleet_requests_failed_total", {},
                        int(rs.randint(n_req // 2, n_req + 1))))
            ops.append(("c", "zoo_tpu_fleet_retries_total", {},
                        int(rs.randint(0, 20))))
        ops.append(("g", "zoo_tpu_fed_latency_p99_seconds", {},
                    float(rs.uniform(0.4, 0.9) if bad
                          else rs.uniform(0.0, 0.3))))
        ops.append(("g", "zoo_tpu_fed_error_ratio", {},
                    float(rs.uniform(0.0, 0.2) if bad else 0.0)))
        ops.append(("g", "zoo_tpu_forecast_eta_s",
                    {"resource": "kv_pages"},
                    float(rs.uniform(10, 300) if bad else 1e9)))
        if bad and i % 40 < 8 and rs.rand() < 0.3:
            ops.append(("c", "zoo_tpu_anomalies_total",
                        {"kind": "capacity_forecast"}, 1))
        for v in rs.exponential(12.0 if bad else 0.2,
                                size=int(rs.randint(0, 8))):
            ops.append(("h", "zoo_tpu_train_step_seconds", {}, float(v)))
        ops.append(("g", "zoo_tpu_goodput_share",
                    {"component": "data_wait"},
                    float(rs.uniform(0.5, 0.9) if bad
                          else rs.uniform(0.0, 0.3))))
        if rs.rand() < (0.9 if bad else 0.05):
            ops.append(("c", "zoo_tpu_xla_compiles_total", {},
                        int(rs.randint(1, 4))))
        steps.append((i * dt + float(rs.rand()), ops))
    return steps


def apply_ops(reg, ops):
    for kind, name, labels, v in ops:
        if kind == "c":
            reg.counter(name, help="h", labels=labels).inc(v)
        elif kind == "g":
            reg.gauge(name, help="h", labels=labels).set(v)
        else:
            reg.histogram(name, help="h", labels=labels).observe(v)


def run_engine(obs, slo, diag, steps, env_path, monkeypatch):
    """Tick an engine with every default rule over ``steps``; returns
    (statuses, anomalies, breach counters, event records)."""
    monkeypatch.setenv("ZOO_TPU_EVENT_LOG", str(env_path))
    reg = obs.MetricsRegistry()
    engine = slo.SLOEngine(registry=reg, clock=lambda: 0.0)
    for role in ROLES:
        slo.install_defaults(engine, role)
    seen = []
    listener = lambda kind, fields: seen.append((kind, fields))  # noqa: E731
    diag.add_anomaly_listener(listener)
    try:
        statuses = []
        for t, ops in steps:
            apply_ops(reg, ops)
            statuses.append(engine.tick(now=t))
    finally:
        diag.remove_anomaly_listener(listener)
        obs.reset_metrics()  # closes the event log
    monkeypatch.delenv("ZOO_TPU_EVENT_LOG")
    events = []
    for line in env_path.read_text().splitlines():
        rec = json.loads(line)
        rec.pop("ts")
        events.append(rec)
    breaches = reg.snapshot().get("zoo_tpu_slo_breaches_total")
    return statuses, seen, breaches, events


@pytest.mark.parametrize("seed", [0, 1])
def test_breach_lifecycle_matches_reference(seed, tmp_path, monkeypatch):
    steps = draw_regimes(seed)
    t = run_engine(tobs, tslo, tdiag, steps, tmp_path / "t.jsonl",
                   monkeypatch)
    j = run_engine(jobs, jslo, jdiag, steps, tmp_path / "j.jsonl",
                   monkeypatch)
    assert len(t[0]) == len(steps)
    for k, (ts, js) in enumerate(zip(t[0], j[0])):
        assert ts == js, k
    assert t[1] == j[1]
    assert t[2] == j[2]
    assert t[3] == j[3]
    # every objective breached and recovered at least once
    final = {o["id"]: o for o in t[0][-1]["objectives"]}
    assert all(o["breaches"] >= 1 for o in final.values()), final
    recovered = {e["slo"] for e in t[3] if e["event"] == "slo/recovered"}
    assert recovered == set(final)
    # one anomaly and one counter step per healthy-to-breach transition
    n = {rid: sum(1 for k, f in t[1] if f["slo"] == rid) for rid in final}
    assert n == {rid: o["breaches"] for rid, o in final.items()}
    counted = {v["labels"]["slo"]: v["value"] for v in t[2]["values"]}
    assert counted == {rid: float(o["breaches"])
                       for rid, o in final.items()}


def test_recompile_rule_fires_on_a_cold_process_warm_up():
    """``train_recompile_rate`` on a fresh process: the engine's first
    tick is the baseline; four library loads (the flagship step's
    B1-B4) in the next 5 s read 0.8/s over a window clipped to the
    engine's 5 s of uptime, above the rule's 0.2/s, in both packages.
    Once the 300 s window is full and no build follows, it recovers."""
    out = []
    for obs, slo in ((tobs, tslo), (jobs, jslo)):
        reg = obs.MetricsRegistry()
        engine = slo.SLOEngine(registry=reg, clock=lambda: 0.0)
        slo.install_defaults(engine, "training")
        c = reg.counter("zoo_tpu_xla_compiles_total", help="h")
        engine.tick(now=0.0)
        c.inc(4)
        first = engine.tick(now=5.0)
        states = [first]
        for t in range(10, 320, 5):
            states.append(engine.tick(now=float(t)))
        out.append(states)
    assert out[0] == out[1]
    rule = {o["id"]: o for o in out[0][0]["objectives"]}[
        "train_recompile_rate"]
    assert rule["state"] == "breach" and rule["value"] == 0.8
    last = {o["id"]: o for o in out[0][-1]["objectives"]}[
        "train_recompile_rate"]
    assert last["state"] == "ok" and last["value"] == 0.0


def test_env_overrides_and_switches_match_reference(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_SLO_SERVING_LATENCY_P99_THRESHOLD", "0.5")
    monkeypatch.setenv("ZOO_TPU_SLO_SERVING_ERROR_RATE_OBJECTIVE", "0.95")
    monkeypatch.setenv("ZOO_TPU_SLO_SERVING_ERROR_RATE_BURN_RATE", "x")
    got = []
    for obs, slo in ((tobs, tslo), (jobs, jslo)):
        e = slo.SLOEngine(registry=obs.MetricsRegistry(),
                          clock=lambda: 0.0)
        slo.install_defaults(e, "serving")
        got.append(e.status())
    assert got[0] == got[1]
    rules = {o["id"]: o for o in got[0]["objectives"]}
    assert rules["serving_latency_p99"]["threshold"] == 0.5
    assert rules["serving_error_rate"]["objective"] == 0.95
    assert rules["serving_error_rate"]["burn_rate"] == 14.0
    # the global engine: installed and ticking by hand with TICK_S=0
    engine = tslo.ensure_default_slos("training")
    assert engine is tslo.get_engine() and engine._thread is None
    assert [o["id"] for o in engine.status()["objectives"]] == [
        "train_data_wait_share", "train_recompile_rate", "train_step_p99"]
    monkeypatch.setenv("ZOO_TPU_SLO", "0")
    assert tslo.ensure_default_slos("serving") is None
    assert jslo.ensure_default_slos("serving") is None
    assert not tslo.enabled()
    tslo.reset_slo()
    assert tslo.get_engine() is not engine


def test_background_ticker_starts_and_stops(monkeypatch):
    engine = tslo.SLOEngine(registry=tobs.MetricsRegistry())
    engine.start(interval_s=0.01)
    assert engine._thread is not None and engine._thread.is_alive()
    thread = engine._thread
    engine.start(interval_s=0.01)  # idempotent
    assert engine._thread is thread
    engine.stop()
    assert not thread.is_alive() and engine._thread is None
    with pytest.raises(ValueError, match="duplicate"):
        rule = tslo.SLO.from_dict(tslo.DEFAULT_SERVING_SLOS[0])
        engine.add(rule)
        engine.add(rule)
    engine.remove(rule.id)
    assert not engine.has(rule.id)
