"""The port's goodput ledger (``perf/goodput.py``) and diagnostics layer
(``common/diagnostics.py``) on the cases of ``tests/test_goodput.py``
and ``tests/test_diagnostics.py``, each against the port, with the JAX
package's functions beside it where a case compares values (the peak
table, the share math, the detectors' firing on the same fed sequence);
plus the H100 row and the port's compile hooks: ``cuda_build``'s builds
and loads and the ``DynamicBatcher``'s bucket callables, the warm-up's
excused.

Tolerances: shares and MFU as the reference's tests hold them
(``pytest.approx``: 1e-6 relative; summaries within 1e-4 after their
rounding to 6 decimals).
"""

import json
import threading

import numpy as np
import pytest

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.common import diagnostics as jdiag
from analytics_zoo_tpu.common import observability as jobs
from analytics_zoo_tpu.perf import goodput as jgoodput
from analytics_zoo_tpu_torch.common import diagnostics
from analytics_zoo_tpu_torch.common import observability as obs
from analytics_zoo_tpu_torch.perf import goodput
from analytics_zoo_tpu_torch.perf.goodput import (
    COMPONENTS, GoodputLedger, recent_summaries, resolve_peak_flops)


@pytest.fixture(autouse=True)
def _fresh():
    tzoo.init_nncontext(seed=0, device="cpu")
    obs.reset_metrics()
    goodput.reset_goodput()
    yield
    obs.reset_metrics()
    tzoo.reset_nncontext()


def _val(snap, name, labels=None):
    for rec in snap.get(name, {}).get("values", ()):
        if labels is None or rec["labels"] == labels:
            return rec["value"]
    return None


def _anomalies(kind):
    return _val(obs.snapshot(), "zoo_tpu_anomalies_total",
                {"kind": kind}) or 0


# -- goodput: the peak table --------------------------------------------------

@pytest.mark.parametrize("kind,platform,expect", [
    ("TPU v5p", "", 459e12),
    ("TPU v5e", "", 197e12),
    ("TPU v5 lite", "", 197e12),
    ("TPU v4", "", 275e12),
    ("TPU v3", "", 123e12),
    ("cpu", "cpu", 1e11),
    ("Golden Gate", "cpu", 1e11),
    ("Golden Gate", "", 197e12),
    ("NVIDIA H100 80GB HBM3", "cuda", 989e12),
    ("NVIDIA H100 PCIe", "", 989e12),
])
def test_resolve_peak_flops(kind, platform, expect):
    assert resolve_peak_flops(kind, platform) == expect
    if "H100" not in kind:      # the reference's rows, unchanged
        assert jgoodput.resolve_peak_flops(kind, platform) == expect


def test_peak_env_override(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_PEAK_TFLOPS", "2.5")
    assert resolve_peak_flops("NVIDIA H100 80GB HBM3") == 2.5e12


def test_peak_scales_by_device_count():
    led = GoodputLedger(peak_flops=100.0, n_devices=8,
                        registry=obs.MetricsRegistry())
    assert led.peak_flops == 800.0


# -- goodput: share math, as the reference's ----------------------------------

@pytest.mark.parametrize("wall,parts,flops", [
    (1.0, dict(data_wait_s=0.2, dispatch_s=0.1, checkpoint_s=0.0), 2e11),
    (1.0, dict(data_wait_s=3.0, dispatch_s=1.0), None),     # skew clamp
    (0.5, dict(), None),                                    # no flops
    (2.0, dict(data_wait_s=0.1, dispatch_s=0.3, checkpoint_s=0.6), 5e11),
])
def test_note_step_matches_the_reference(wall, parts, flops):
    reg, jreg = obs.MetricsRegistry(), jobs.MetricsRegistry()
    led = GoodputLedger(peak_flops=1e12, registry=reg)
    jled = jgoodput.GoodputLedger(peak_flops=1e12, registry=jreg)
    led.set_flops_per_step(flops)
    jled.set_flops_per_step(flops)
    shares = led.note_step(wall, **parts)
    want = jled.note_step(wall, **parts)
    assert shares == pytest.approx(want)
    assert sum(shares.values()) == pytest.approx(1.0)
    assert min(shares.values()) >= 0.0
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    for name in ("zoo_tpu_mfu", "zoo_tpu_goodput_ratio"):
        assert _val(snap, name) == pytest.approx(_val(jsnap, name))
    for comp in COMPONENTS:
        assert _val(snap, "zoo_tpu_goodput_share", {"component": comp}) == \
            pytest.approx(shares[comp])


def test_epoch_summary_aggregates_and_resets():
    led = GoodputLedger(peak_flops=1e12, registry=obs.MetricsRegistry())
    led.set_flops_per_step(1e11)
    led.note_step(1.0, data_wait_s=0.5)
    led.note_step(1.0, data_wait_s=0.1)
    s = led.epoch_summary(epoch=3)
    assert s["epoch"] == 3 and s["steps"] == 2
    assert s["wall_s"] == pytest.approx(2.0)
    assert sum(s["shares"].values()) == pytest.approx(1.0, abs=1e-4)
    assert s["shares"]["data_wait"] == pytest.approx(0.3)
    assert s["goodput_ratio"] == pytest.approx(0.7)
    assert s["mfu"] == pytest.approx(0.1)
    assert recent_summaries()[-1] == s
    assert led.epoch_summary(epoch=4) is None
    assert GoodputLedger(peak_flops=1e12, registry=obs.MetricsRegistry()
                         ).epoch_summary() is None
    goodput.reset_goodput()
    assert recent_summaries() == []


def test_ledger_for_backend(monkeypatch):
    led = goodput.ledger_for_backend(registry=obs.MetricsRegistry())
    # the model's device, not a backend: one CPU, the CPU row
    assert led.peak_flops == pytest.approx(1e11)
    assert led.device_kind == "cpu"
    monkeypatch.setenv("ZOO_TPU_GOODPUT", "0")
    assert goodput.ledger_for_backend() is None


def _toy(optimizer="sgd"):
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
    m = Sequential()
    m.add(L.Dense(4, input_shape=(3,)))
    m.add(L.Dense(1))
    m.compile(optimizer=optimizer, loss="mse")
    return m


def test_estimator_fit_exposes_goodput():
    rs = np.random.RandomState(0)
    x = rs.randn(16, 3).astype(np.float32)
    y = rs.randn(16, 1).astype(np.float32)
    res = _toy().fit(x, y, batch_size=8, nb_epoch=1)    # 2 steps
    snap = obs.snapshot()
    assert _val(snap, "zoo_tpu_mfu") > 0.0
    assert 0.0 < _val(snap, "zoo_tpu_goodput_ratio") <= 1.0
    assert sum(r["value"] for r in snap["zoo_tpu_goodput_share"]["values"]
               ) == pytest.approx(1.0, abs=1e-6)
    gp = res.history[-1]["goodput"]
    assert gp["steps"] == 2 and gp["mfu"] > 0.0
    # the products of Dense 3->4->1 at batch 8: forward 2*8*(3*4 + 4*1),
    # backward dW of both and dx of the second (the input needs none)
    assert gp["flops_per_step"] == 2 * 8 * (12 + 4) + 2 * 8 * (12 + 4) + \
        2 * 8 * 4
    assert sum(gp["shares"].values()) == pytest.approx(1.0, abs=1e-4)
    assert set(gp["shares"]) == set(COMPONENTS)
    assert recent_summaries()[-1]["steps"] == 2


def test_estimator_goodput_disabled(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_GOODPUT", "0")
    rs = np.random.RandomState(0)
    res = _toy().fit(rs.randn(8, 3).astype(np.float32),
                     rs.randn(8, 1).astype(np.float32), batch_size=8,
                     nb_epoch=1)
    assert "zoo_tpu_mfu" not in obs.snapshot()
    assert "goodput" not in res.history[-1]


# -- diagnostics, the reference's cases ---------------------------------------

def test_anomaly_counter_and_event(tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    monkeypatch.setenv("ZOO_TPU_EVENT_LOG", str(path))
    seen = []
    listener = lambda kind, fields: seen.append((kind, fields))
    diagnostics.add_anomaly_listener(listener)
    try:
        diagnostics.anomaly("unit_test", detail=42)
    finally:
        diagnostics.remove_anomaly_listener(listener)
    obs.reset_metrics()  # closes the sink
    rec = json.loads(path.read_text().strip())
    assert rec["event"] == "diagnostics/anomaly"
    assert rec["kind"] == "unit_test" and rec["detail"] == 42
    assert seen == [("unit_test", {"detail": 42})]


@pytest.mark.parametrize("times,threshold,expect", [
    ((0.0, 1.0, 2.0, 3.0, 4.0, 70.0, 70.1, 70.2, 70.3), 3,
     [False, False, False, True, False, False, False, False, True]),
    ((0.0, 0.5, 1.0, 61.5, 62.0, 62.5), 2,
     [False, False, True, False, False, True]),
])
def test_recompile_monitor_fires_as_the_reference(times, threshold, expect):
    mon = diagnostics.RecompileMonitor(threshold=threshold, window_s=60.0)
    jmon = jdiag.RecompileMonitor(threshold=threshold, window_s=60.0)
    got = [mon.note(now=t) for t in times]
    assert got == expect == [jmon.note(now=t) for t in times]
    assert mon.storms == jmon.storms == sum(expect)
    assert _anomalies("recompile_storm") == sum(expect)
    assert _val(obs.snapshot(), "zoo_tpu_xla_compiles_total") == len(times)


def test_expected_compiles_excused_from_storm_window():
    mon = diagnostics.RecompileMonitor(threshold=2, window_s=60.0)
    with diagnostics.expected_compiles():
        assert [mon.note(now=t) for t in (0.0, 0.1, 0.2, 0.3, 0.4)] == \
            [False] * 5
    assert mon.storms == 0
    assert _val(obs.snapshot(), "zoo_tpu_xla_compiles_total") == 5
    assert [mon.note(now=t) for t in (10.0, 10.1)] == [False, False]
    assert mon.note(now=10.2) is True


def test_recompile_listener_filters_event_names():
    mon = diagnostics.RecompileMonitor(threshold=100, window_s=60.0)
    for name in diagnostics.COMPILE_EVENTS:
        mon._listener(name, 0.1)
    mon._listener("/jax/core/backend_compile_duration", 0.1)  # not ours
    mon._listener("serving/predict", 0.1)
    assert _val(obs.snapshot(), "zoo_tpu_xla_compiles_total") == \
        len(diagnostics.COMPILE_EVENTS)


def test_install_recompile_monitor_is_singleton():
    a = diagnostics.install_recompile_monitor()
    assert diagnostics.install_recompile_monitor() is a
    assert diagnostics.get_recompile_monitor() is a


@pytest.mark.parametrize("feed,kw,fired", [
    ([0.1] * 8 + [0.31, 1.0, 1.0, 0.1],
     dict(window=16, min_samples=4, factor=3.0, cooldown=2),
     [False] * 8 + [True, False, False, False]),
    ([10.0, 0.1, 0.1, 0.1], dict(window=16, min_samples=4, factor=3.0),
     [False] * 4),
])
def test_step_time_watcher_as_the_reference(feed, kw, fired):
    w = diagnostics.StepTimeWatcher(**kw)
    jw = jdiag.StepTimeWatcher(**kw)
    assert [w.observe(d) for d in feed] == fired == \
        [jw.observe(d) for d in feed]
    assert _anomalies("step_time_regression") == sum(fired)


def test_step_time_watcher_env_factor(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_STEP_ANOMALY_FACTOR", "10")
    w = diagnostics.StepTimeWatcher(window=8, min_samples=2)
    assert w.factor == 10.0
    for _ in range(4):
        w.observe(0.1)
    assert w.observe(0.5) is False and w.fired == 0


def test_env_threshold_defaults(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_RECOMPILE_THRESHOLD", "2")
    monkeypatch.setenv("ZOO_TPU_RECOMPILE_WINDOW_S", "5")
    mon = diagnostics.RecompileMonitor()
    assert mon.threshold == 2 and mon.window_s == 5.0
    monkeypatch.setenv("ZOO_TPU_RECOMPILE_THRESHOLD", "garbage")
    assert diagnostics.RecompileMonitor().threshold == 5


def test_recompile_monitor_thread_safety():
    mon = diagnostics.RecompileMonitor(threshold=10 ** 6, window_s=1e9)

    def work():
        for _ in range(500):
            mon.note(now=1.0)
    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert _val(obs.snapshot(), "zoo_tpu_xla_compiles_total") == 2000
    assert mon.storms == 0


def test_replica_skew_as_the_reference():
    stats = {"a": {"p99_s": 0.1, "error_ratio": 0.0, "events": 10},
             "b": {"p99_s": 0.11, "error_ratio": 0.0, "events": 10},
             "c": {"p99_s": 0.9, "error_ratio": 0.0, "events": 10},
             "d": {"p99_s": 0.1, "error_ratio": 0.6, "events": 10}}
    det, jdet = diagnostics.ReplicaSkewDetector(), \
        jdiag.ReplicaSkewDetector()
    got, want = det.observe(stats, now=0.0), jdet.observe(stats, now=0.0)
    assert got == want and {f["replica"] for f in got} == {"c", "d"}
    assert det.observe(stats, now=1.0) == []        # muted
    assert _anomalies("replica_skew") == 2


def test_vitals_build_info_and_memory_gauges_on_the_cpu():
    v = diagnostics.update_process_vitals()
    assert v["uptime_s"] >= 0 and v.get("rss_bytes", 1) > 0
    info = diagnostics.update_build_info()
    import torch
    assert info["torch"] == torch.__version__ and info["device"] in (
        "cpu", "unknown") or torch.cuda.is_available()
    snap = obs.snapshot()
    assert _val(snap, "zoo_tpu_build_info") == 1
    labels = snap["zoo_tpu_build_info"]["values"][0]["labels"]
    assert set(labels) == {"version", "torch", "cuda", "device", "flags"}
    # no card: nothing set, as the reference on a backend without stats
    assert diagnostics.update_device_memory_gauges() == 0
    assert "zoo_tpu_device_memory_bytes" not in obs.snapshot()


# -- the port's compile hooks -------------------------------------------------

def test_cuda_build_announces_builds_and_loads(monkeypatch):
    from analytics_zoo_tpu_torch.ops import cuda_build
    mon = diagnostics.RecompileMonitor(threshold=1, window_s=60.0)
    monkeypatch.setattr(diagnostics, "_compile_listeners", [])
    mon.install()

    def fake_build(names):        # nvcc's place: one build per name
        for _ in names:
            diagnostics.compile_event("cuda_build/build", 1.0)
        return {n: 1.0 for n in names}
    monkeypatch.setattr(cuda_build, "_build", fake_build)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(cuda_build, "_libs", {})
    # a requested build is expected: counted, no storm
    names = ["matmul_bn", "conv3x3_bn", "matmul_bn_dx"]
    cuda_build.build(names)
    assert mon.storms == 0
    assert _val(obs.snapshot(), "zoo_tpu_xla_compiles_total") == 3
    # loads at first use are watched: the second in the window storms
    cuda_build.load(names[0])
    cuda_build.load(names[0])          # loaded once
    assert mon.storms == 0
    cuda_build.load(names[1])
    assert mon.storms == 1 and _anomalies("recompile_storm") == 1
    # each load built its library (expected) and loaded it (watched)
    assert _val(obs.snapshot(), "zoo_tpu_xla_compiles_total") == 3 + 4


class _Relowering:
    """A duck-typed model that makes bucket callables (doubling its
    input)."""

    can_relower = True
    generation = 0
    supported_concurrent_num = 1
    concurrent_slots_free = 1
    example_input_specs = [((4, 3), np.float32)]

    def lower_for(self, specs):
        return lambda *xs: np.asarray(xs[0]) * 2.0

    def predict(self, xs):
        return np.asarray(xs[0]) * 2.0


def test_batcher_warm_up_is_expected_and_later_callables_watched(
        monkeypatch):
    from analytics_zoo_tpu_torch.pipeline.inference import batching as tb
    mon = diagnostics.RecompileMonitor(threshold=1, window_s=60.0)
    monkeypatch.setattr(diagnostics, "_compile_listeners", [])
    monkeypatch.setattr(diagnostics, "_monitor", mon)
    b = tb.DynamicBatcher(_Relowering(), max_batch_size=4, max_wait_ms=1)
    b.start()
    try:
        assert mon._installed
        warmed = b.warmed_buckets
        assert warmed == 3 and mon.storms == 0      # buckets 1, 2, 4
        assert _val(obs.snapshot(), "zoo_tpu_xla_compiles_total") == warmed
        # a new signature after warm-up makes its ladder: watched
        out = b.submit([np.ones((2, 5), np.float32)]).result(timeout=30)
        np.testing.assert_array_equal(out, np.full((2, 5), 2.0))
        assert mon.storms == 1
        assert _val(obs.snapshot(), "zoo_tpu_xla_compiles_total") == 6
    finally:
        b.stop()
