"""The port's serving fleet (``pipeline/inference/fleet.py``,
``parallel/mesh.py``) against the JAX package's: the reference tests'
cases (``test_fleet.py``), each run on a fleet of each package built
from the same numpy weights (a Dense 4→8→2 net) or the same stub models,
with the same requests.

Held: routed outputs within 1e-5 of each other and of the net's forward,
the hash ring's picks (same keys → same replica names), lifecycle states
and backoff under the same injected clock, ``/debug/fleet`` and
``/health`` payloads, metric counts, trace spans across the router and
its replicas (in process, and forwarded to an ``HttpReplica``), and the
pool's construction rules. Two placements differ on purpose:
``place_inference_params`` over two devices raises naming ROADMAP A14,
and the port's CPU fleets seat two replicas on the one host device by
passing it twice. The fleet cases of ``test_faults.py`` and the
``FleetRouter`` cases of ``test_federation.py`` close the file. No test
sleeps for its timing: backoff runs on injected clocks and every router
has ``probe_interval_s=0``.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as jinit
from analytics_zoo_tpu.common import diagnostics as jdiag
from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.common import observability as jobs
from analytics_zoo_tpu.common import slo as jslo
from analytics_zoo_tpu.common import tracing as jtracing
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.inference import InferenceModel as JIM
from analytics_zoo_tpu.pipeline.inference import fleet as jfleet
from analytics_zoo_tpu.pipeline.inference import serving as jsv
from analytics_zoo_tpu_torch.common import diagnostics as tdiag
from analytics_zoo_tpu_torch.common import faults as tfaults
from analytics_zoo_tpu_torch.common import forecast as tfc
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.common import slo as tslo
from analytics_zoo_tpu_torch.common import timeseries as tts
from analytics_zoo_tpu_torch.common import tracing as ttracing
from analytics_zoo_tpu_torch.parallel import (place_inference_params,
                                              replica_device_slices)
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel as TIM
from analytics_zoo_tpu_torch.pipeline.inference import batching as tb
from analytics_zoo_tpu_torch.pipeline.inference import fleet as tfleet
from analytics_zoo_tpu_torch.pipeline.inference import serving as tsv

TIMEOUT = 30
CPU2 = [torch.device("cpu")] * 2  # two replicas on the one host device
BATCHER = {"max_wait_ms": 1, "max_batch_size": 4}  # buckets 1, 2, 4


class Lib:
    """One package's fleet surface, so each case runs the same code on
    both."""

    def __init__(self, name, fleet, serving, im, faults, obs, tracing,
                 slo, diag):
        self.name, self.fleet, self.serving, self.IM = name, fleet, \
            serving, im
        self.faults, self.obs, self.tracing, self.slo = faults, obs, \
            tracing, slo
        self.diag = diag


T = Lib("port", tfleet, tsv, TIM, tfaults, tobs, ttracing, tslo, tdiag)
J = Lib("jax", jfleet, jsv, JIM, jfaults, jobs, jtracing, jslo, jdiag)
LIBS = (T, J)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Both packages' registries, traces and faults emptied around each
    case; the port's SLO engine without a ticker."""
    monkeypatch.setenv("ZOO_TPU_SLO_TICK_S", "0")
    monkeypatch.setenv("ZOO_TPU_FED_TICK_S", "0")
    tzoo.init_nncontext(seed=0, device="cpu")
    resets = (tobs.reset_metrics, ttracing.reset_tracing, tslo.reset_slo,
              tts.reset_history, tfc.reset_forecast, tfaults.reset_faults,
              jobs.reset_metrics, jfaults.reset_faults)
    for reset in resets:
        reset()
    yield
    for reset in resets:
        reset()
    tzoo.reset_nncontext()


def _metric_sum(lib, name):
    fam = lib.obs.snapshot().get(name)
    if fam is None:
        return 0.0
    return sum(v["value"] for v in fam["values"])


def _wait(cond, timeout=10.0):
    """Poll ``cond`` (a condition on other threads' progress) until it
    holds."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.002)
    return cond()


# -- the toy net, one numpy weight tree for both packages ---------------------

def _toy(lib):
    m = JSequential() if lib is J else tmodels.Sequential()
    L = JL if lib is J else TL
    m.add(L.Dense(8, activation="relu", input_shape=(4,)))
    m.add(L.Dense(2))
    return m


def _weights():
    jinit(seed=0)
    return jax.device_get(_toy(J).init_params())


def _ref(params, x):
    """The net's forward in numpy."""
    h = np.maximum(x @ params["dense_1"]["kernel"]
                   + params["dense_1"]["bias"], 0)
    return h @ params["dense_2"]["kernel"] + params["dense_2"]["bias"]


def _im(lib, params, example):
    if lib is J:
        im = JIM()
        im.load_keras_net(_toy(J), params=jax.tree_util.tree_map(
            jax.numpy.asarray, params), example_inputs=example)
        return im
    return TIM().load_keras_net(_toy(T), params=params,
                                example_inputs=example)


class _KillableModel:
    """A real InferenceModel whose bucket callables and per-request
    predicts raise while ``dead`` is set (the batcher runs the callables
    of ``lower_for``, so those are poisoned too)."""

    def __init__(self, im):
        self._im = im
        self.dead = threading.Event()

    def __getattr__(self, name):
        return getattr(self._im, name)

    def _check(self):
        if self.dead.is_set():
            raise RuntimeError("injected replica death")

    def lower_for(self, example_args):
        fn = self._im.lower_for(example_args)

        def wrapped(*xs):
            self._check()
            return fn(*xs)
        return wrapped

    def predict(self, inputs, timeout_ms=-1):
        self._check()
        return self._im.predict(inputs, timeout_ms=timeout_ms)


def _killable_pool(lib, params, n=2, clock=time.monotonic, **router_kw):
    ex = [np.random.RandomState(1).randn(2, 4).astype(np.float32)]
    models, replicas = [], []
    for i in range(n):
        km = _KillableModel(_im(lib, params, ex))
        models.append(km)
        replicas.append(lib.fleet.Replica(
            f"r{i}", km, clock=clock,
            batcher_kwargs={"max_wait_ms": 1, "max_batch_size": 4,
                            "labels": {"replica": f"r{i}"}}))
    router_kw.setdefault("probe_interval_s", 0)
    pool = lib.fleet.ReplicaPool(replicas=replicas, clock=clock)
    return lib.fleet.FleetRouter(pool, **router_kw), models


class _StubReplicaModel:
    """Blocking duck-typed model for deterministic queue states."""

    can_relower = False
    example_input_specs = None
    generation = 0
    concurrent_slots_free = 1
    supported_concurrent_num = 1

    def __init__(self):
        self.started = threading.Event()
        self.release = threading.Event()
        self.calls = 0

    def predict(self, xs, timeout_ms=-1):
        self.started.set()
        assert self.release.wait(TIMEOUT), "test forgot to release stub"
        self.calls += 1
        return np.asarray(xs[0] if isinstance(xs, list) else xs) * 2.0


def _stub_fleet(lib, n=2, queue_depth=4, clock=time.monotonic,
                **router_kw):
    """A started router over ``n`` stub replicas; ``clock`` is handed to
    the replicas and the pool (the router reads the pool's)."""
    models = [_StubReplicaModel() for _ in range(n)]
    replicas = [lib.fleet.Replica(f"r{i}", m, batcher_kwargs={
        "max_wait_ms": 1, "queue_depth": queue_depth}, clock=clock)
        for i, m in enumerate(models)]
    router_kw.setdefault("probe_interval_s", 0)
    router = lib.fleet.FleetRouter(
        lib.fleet.ReplicaPool(replicas=replicas, clock=clock), **router_kw)
    return router.start(), models


def _release(models):
    for m in models:
        m.release.set()


def _stop_all(routers):
    for router, models in routers.values():
        _release(models)
        router.stop()


# -- dispatch policies --------------------------------------------------------

def test_least_loaded_prefers_idle_replica():
    fleets = {lib.name: _stub_fleet(lib, 2) for lib in LIBS}
    try:
        x = np.ones((1, 3), np.float32)
        for lib in LIBS:
            router, models = fleets[lib.name]
            f1 = router.submit([x])
            assert _wait(lambda: any(m.started.is_set() for m in models))
            busy = [r.name for r in router.pool.replicas
                    if r.outstanding_rows > 0]
            assert len(busy) == 1
            f2 = router.submit([x])
            # the second request went to the other (idle) replica
            assert _wait(lambda: all(m.started.is_set() for m in models))
            _release(models)
            np.testing.assert_allclose(f1.result(TIMEOUT), x * 2.0)
            np.testing.assert_allclose(f2.result(TIMEOUT), x * 2.0)
    finally:
        _stop_all(fleets)


def test_consistent_hash_is_deterministic_and_sticky():
    fleets = {lib.name: _stub_fleet(lib, 3, policy="hash") for lib in LIBS}
    try:
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        keys = [fleets["port"][0]._affinity_key(
            [np.full((1, 3), i, np.float32)]) for i in range(64)]
        picks = {}
        for lib in LIBS:
            router = fleets[lib.name][0]
            key = router._affinity_key([x])
            # the content key is the reference's, byte for byte
            assert key == fleets["port"][0]._affinity_key([x])
            names = {router._pick(2, key, set()).name for _ in range(16)}
            assert len(names) == 1  # same payload → same replica
            router2 = lib.fleet.FleetRouter(router.pool, policy="hash",
                                            probe_interval_s=0)
            assert router2._pick(2, key, set()).name == names.pop()
            picks[lib.name] = [router._pick(1, k, set()).name
                               for k in keys]
            assert len(set(picks[lib.name])) > 1  # payloads spread
        # one ring: the same keys map to the same replica names
        assert picks["port"] == picks["jax"]
    finally:
        _stop_all(fleets)


def test_hash_ring_walks_past_down_replica():
    fleets = {lib.name: _stub_fleet(lib, 3, policy="hash") for lib in LIBS}
    try:
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        walk = {}
        for lib in LIBS:
            router = fleets[lib.name][0]
            key = router._affinity_key([x])
            first = router._pick(2, key, set())
            first.mark_down("test")
            second = router._pick(2, key, set())
            assert second is not None and second.name != first.name
            assert router._pick(2, key, set()).name == second.name
            walk[lib.name] = (first.name, second.name)
        assert walk["port"] == walk["jax"]
    finally:
        _stop_all(fleets)


# -- kill / retry / eject / re-admit ------------------------------------------

def test_replica_death_mid_request_retries_on_sibling():
    params = _weights()
    rs = np.random.RandomState(2)
    x = rs.randn(2, 4).astype(np.float32)
    outs, states = {}, {}
    for lib in LIBS:
        router, models = _killable_pool(lib, params, 2, eject_after=1,
                                        max_retries=2)
        router.start()
        try:
            for _ in range(4):  # warm both replicas through traffic
                router.submit([x]).result(timeout=TIMEOUT)
            models[0].dead.set()  # r0 now fails its bucket calls
            futs = [router.submit([x]) for _ in range(8)]
            outs[lib.name] = [np.asarray(f.result(timeout=TIMEOUT))
                              for f in futs]
            states[lib.name] = {r["name"]: r["state"] for r in
                                router.fleet_status()["replicas"]}
            assert _metric_sum(lib, "zoo_tpu_fleet_retries_total") >= 1
            assert _metric_sum(lib, "zoo_tpu_fleet_ejections_total") == 1
        finally:
            router.stop()
    assert states["port"] == states["jax"] == {"r0": "down",
                                               "r1": "admitting"}
    want = _ref(params, x)
    for got_t, got_j in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(got_t, got_j, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_t, want, rtol=1e-5, atol=1e-5)


def test_dead_replica_readmitted_after_backoff():
    params = _weights()
    x = np.random.RandomState(3).randn(2, 4).astype(np.float32)
    seqs = {}
    for lib in LIBS:
        clock = [1000.0]
        router, models = _killable_pool(lib, params, 2,
                                        clock=lambda: clock[0],
                                        eject_after=1)
        router.start()
        seq = []
        try:
            router.submit([x]).result(timeout=TIMEOUT)
            models[0].dead.set()
            for _ in range(4):
                router.submit([x]).result(timeout=TIMEOUT)
            r0 = router.pool.replicas[0]
            seq.append((r0.state, r0.next_probe_at, r0.backoff_s))
            # a probe while still dead: the backoff doubles
            t_probe = r0.next_probe_at
            router.tick(now=t_probe + 0.01)
            seq.append((r0.state, r0.next_probe_at, r0.backoff_s))
            assert r0.state == "down" and r0.next_probe_at > t_probe
            # healed: the next probe after the grown backoff re-admits
            models[0].dead.clear()
            router.tick(now=r0.next_probe_at + 0.01)
            seq.append((r0.state, r0.next_probe_at, r0.backoff_s))
            assert r0.state == "admitting"
            assert _metric_sum(lib,
                               "zoo_tpu_fleet_readmissions_total") == 1
            out = router.submit([x]).result(timeout=TIMEOUT)  # serves
            np.testing.assert_allclose(out, _ref(params, x), rtol=1e-5,
                                       atol=1e-5)
        finally:
            router.stop()
        seqs[lib.name] = seq
    assert seqs["port"] == seqs["jax"]


def test_drain_flushes_in_flight_then_restart_readmits():
    fleets = {lib.name: _stub_fleet(lib, 2) for lib in LIBS}
    try:
        x = np.ones((1, 3), np.float32)
        for lib in LIBS:
            router, models = fleets[lib.name]
            futs = [router.submit([x]) for _ in range(3)]
            _release(models)
            t = threading.Thread(target=router.drain, args=("r0", 10))
            t.start()
            for f in futs:
                np.testing.assert_allclose(f.result(TIMEOUT), x * 2.0)
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
            r0 = router._replica("r0")
            assert r0.state == "drained" and r0.outstanding_rows == 0
            # a drained replica takes no traffic; the sibling serves
            np.testing.assert_allclose(
                router.submit([x]).result(TIMEOUT), x * 2.0)
            assert r0.outstanding_rows == 0
            router.restart_replica("r0")
            assert r0.state == "admitting"
    finally:
        _stop_all(fleets)


# -- backpressure -------------------------------------------------------------

def test_fleet_saturation_returns_min_retry_hint():
    fleets = {lib.name: _stub_fleet(lib, 2, queue_depth=1) for lib in LIBS}
    try:
        x = np.ones((1, 3), np.float32)
        for lib in LIBS:
            router, models = fleets[lib.name]
            # one request in flight per replica (blocked in the stub)
            futs = [router.submit([x]) for _ in range(2)]
            for m in models:
                assert m.started.wait(TIMEOUT)
            # then one queued per replica: every queue (depth 1) full
            futs += [router.submit([x]) for _ in range(2)]
            with pytest.raises(lib.fleet.FleetSaturatedError) as ei:
                router.submit([x]).result(timeout=5)
            hints = [r.retry_hint_s() for r in router.pool.replicas]
            assert ei.value.retry_after_s > 0
            assert ei.value.retry_after_s == pytest.approx(min(hints))
            assert isinstance(ei.value, lib.fleet.QueueFullError)
            assert _metric_sum(lib, "zoo_tpu_fleet_saturated_total") == 1
            _release(models)
            for f in futs:
                np.testing.assert_allclose(f.result(TIMEOUT), x * 2.0)
    finally:
        _stop_all(fleets)


def test_no_admitting_replica_is_unavailable_not_crash():
    # one fixed clock for both packages: the message carries the
    # soonest probe's delay, which would otherwise read the real clock
    # at two different moments
    fleets = {lib.name: _stub_fleet(lib, 2, clock=lambda: 1000.0)
              for lib in LIBS}
    try:
        x = np.ones((1, 3), np.float32)
        msgs = {}
        for lib in LIBS:
            router = fleets[lib.name][0]
            for r in router.pool.replicas:
                r.mark_down("test")
            with pytest.raises(lib.fleet.ReplicaUnavailableError) as ei:
                router.predict(x)
            assert isinstance(ei.value, lib.fleet.QueueFullError)
            assert ei.value.retry_after_s > 0
            msgs[lib.name] = str(ei.value)
        assert msgs["port"] == msgs["jax"]
    finally:
        _stop_all(fleets)


# -- placement over device slices ---------------------------------------------

def test_sharded_placement_raises_naming_a14():
    """The reference serves a replica over a two-device slice with a
    tensor-parallel split; the port has no such placement yet and
    raises rather than replicate."""
    params = _weights()
    with pytest.raises(NotImplementedError, match="A14"):
        place_inference_params(params, CPU2, mode="tp")
    with pytest.raises(NotImplementedError, match="A14"):
        tfleet.ReplicaPool.for_keras(
            _toy(T), params=params, n_replicas=2, devices_per_replica=2,
            sharding="tp", devices=[torch.device("cpu")] * 4)
    # one device: a copy of every leaf, sharing no storage
    placed = place_inference_params(params, [torch.device("cpu")])
    for lyr in params:
        for k, v in params[lyr].items():
            np.testing.assert_array_equal(placed[lyr][k].numpy(), v)
    t = {"a": torch.ones(3)}
    assert place_inference_params(t, ["cpu"])["a"].data_ptr() != \
        t["a"].data_ptr()
    with pytest.raises(ValueError):
        place_inference_params(t, [])


# -- serving integration ------------------------------------------------------

def _fleet_server(lib, params):
    ex = [np.random.RandomState(5).randn(2, 4).astype(np.float32)]
    if lib is J:
        jinit(seed=0)
        pool = jfleet.ReplicaPool.for_keras(
            _toy(J), params=jax.tree_util.tree_map(jax.numpy.asarray,
                                                   params),
            example_inputs=ex, n_replicas=2, devices_per_replica=1,
            batcher_kwargs=BATCHER)
    else:
        pool = tfleet.ReplicaPool.for_keras(
            _toy(T), params=params, example_inputs=ex, n_replicas=2,
            devices_per_replica=1, devices=CPU2, batcher_kwargs=BATCHER)
    router = lib.fleet.FleetRouter(pool, probe_interval_s=0)
    srv = lib.serving.InferenceServer(router, batcher=router)
    srv.start()
    return srv, router


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=TIMEOUT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(port, payload, headers=None, path="/predict"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


def test_fleet_behind_http_server_with_debug_fleet():
    params = _weights()
    x = np.random.RandomState(6).randn(2, 4).astype(np.float32)
    got = {}
    for lib in LIBS:
        srv, router = _fleet_server(lib, params)
        try:
            status, payload, _ = _post(srv.port, {"inputs": x.tolist()})
            assert status == 200
            status, fleet = _get(srv.port, "/debug/fleet")
            assert status == 200
            status, health = _get(srv.port, "/health")
            got[lib.name] = (np.asarray(payload["outputs"], np.float32),
                             fleet, health)
        finally:
            srv.stop()
    out_t, fleet_t, health_t = got["port"]
    out_j, fleet_j, health_j = got["jax"]
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out_t, _ref(params, x), rtol=1e-5,
                               atol=1e-5)
    # the /debug/fleet payloads agree field for field (no time fields)
    assert fleet_t == fleet_j
    assert fleet_t["replicas_admitting"] == 2
    assert {r["name"] for r in fleet_t["replicas"]} == {"r0", "r1"}
    assert all(r["batcher"]["enabled"] for r in fleet_t["replicas"])
    assert health_t["batcher"] == health_j["batcher"]
    assert health_t["batcher"]["fleet"] is True
    assert health_t["batcher"]["replicas_admitting"] == 2


def test_debug_fleet_404_on_single_model_server():
    for lib in LIBS:
        for holder in (None, object()):
            status, body = lib.serving._fleet_payload(holder)
            assert status == 404
            assert body["error"]["code"] == 404
    assert tsv._fleet_payload(None) == jsv._fleet_payload(None)


def test_fleet_installs_fleet_slos():
    params = _weights()
    ids = {}
    for lib in LIBS:
        srv, router = _fleet_server(lib, params)
        try:
            ids[lib.name] = {s["id"] for s in
                             lib.slo.get_engine().status()["objectives"]}
        finally:
            srv.stop()
    for got in ids.values():
        assert {"fleet_replicas_admitting", "fleet_error_rate",
                "serving_latency_p99"} <= got
    # both front doors mount a collector: the fed objectives too
    assert "fed_latency_p99" in ids["port"]
    assert ids["port"] == ids["jax"]


# -- trace propagation --------------------------------------------------------

def test_trace_id_spans_router_and_replica_inprocess():
    params = _weights()
    x = np.random.RandomState(7).randn(2, 4).astype(np.float32)
    names = {}
    for lib in LIBS:
        router, _ = _killable_pool(lib, params, 2)
        router.start()
        try:
            router.submit([x]).result(timeout=TIMEOUT)  # warm
            with lib.tracing.trace("client/request") as tr:
                router.submit([x]).result(timeout=TIMEOUT)
                tid = tr.trace_id
            # the batcher records serving/scatter after it resolves the
            # request's future: wait for its thread to write the span
            _wait(lambda: "serving/scatter" in {
                s.name for s in lib.tracing.get_store().spans(tid)})
            names[lib.name] = {s.name for s in
                               lib.tracing.get_store().spans(tid)}
        finally:
            router.stop()
    for got in names.values():
        assert "fleet/dispatch" in got
        # the replica's batcher spans joined the same trace id
        assert any(n.startswith("serving/") for n in got), got
    assert names["port"] == names["jax"]


def test_trace_header_forwarded_to_http_replica():
    params = _weights()
    x = np.random.RandomState(8).randn(2, 4).astype(np.float32)
    got = {}
    for lib in LIBS:
        srv, _ = _fleet_server(lib, params)  # stands in for a worker
        try:
            remote = lib.fleet.HttpReplica(
                f"http://127.0.0.1:{srv.port}", name="remote0").start()
            router = lib.fleet.FleetRouter(
                lib.fleet.ReplicaPool(replicas=[remote]),
                probe_interval_s=0)
            with lib.tracing.trace("client/request") as tr:
                out = router.submit([x]).result(timeout=TIMEOUT)
                tid = tr.trace_id
            names = {s.name for s in lib.tracing.get_store().spans(tid)}
            got[lib.name] = np.asarray(out)
            # the server (this process here) recorded its request span
            # under the forwarded trace id
            assert "serving/request" in names
            assert "fleet/remote_predict" in names
            router.stop()
        finally:
            srv.stop()
    np.testing.assert_allclose(got["port"], got["jax"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["port"], _ref(params, x), rtol=1e-4,
                               atol=1e-5)


def test_http_replica_probe_and_health():
    params = _weights()
    for lib in LIBS:
        srv, _ = _fleet_server(lib, params)
        try:
            remote = lib.fleet.HttpReplica(
                f"http://127.0.0.1:{srv.port}").start()
            assert remote.probe() is True
            assert remote.name == f"127.0.0.1_{srv.port}"
            remote.stop()
            assert remote.status()["down_reason"] == "stopped"
            assert lib.fleet.HttpReplica("http://127.0.0.1:1/"
                                         ).probe() is False
        finally:
            srv.stop()


# -- pool construction --------------------------------------------------------

def test_replica_device_slices_partition_and_validate():
    jdevs = jax.devices()
    from analytics_zoo_tpu.parallel import replica_device_slices as jslices
    tdevs = [torch.device("cpu", i) for i in range(len(jdevs))]
    for slices_fn, devs in ((replica_device_slices, tdevs),
                            (jslices, jdevs)):
        slices = slices_fn(4, 2, devs)
        assert len(slices) == 4
        flat = [d for sl in slices for d in sl]
        assert len(set(flat)) == 8  # disjoint
        for bad in ((5, 2), (0, 1), (1, 0)):
            with pytest.raises(ValueError):
                slices_fn(*bad, devs)
    assert [[d.index for d in sl] for sl in
            replica_device_slices(4, 2, tdevs)] == \
        [[d.id for d in sl] for sl in jslices(4, 2, jdevs)]
    # the host's own devices: one CPU here, so one replica seats
    assert replica_device_slices(1) == [(torch.device("cpu"),)]
    with pytest.raises(ValueError, match="needs 2 devices"):
        replica_device_slices(2)


def test_pool_rejects_bad_construction():
    for lib in LIBS:
        fl = lib.fleet
        with pytest.raises(ValueError):
            fl.ReplicaPool()
        with pytest.raises(ValueError):
            fl.ReplicaPool(model_fn=lambda ctx: None,
                           replicas=[fl.Replica("x", _StubReplicaModel())])
        with pytest.raises(ValueError):
            fl.ReplicaPool(replicas=[
                fl.Replica("same", _StubReplicaModel()),
                fl.Replica("same", _StubReplicaModel())])


def test_for_keras_replicas_own_their_weights():
    """Each replica serves its own copy of the net on its slice: no
    tensor is shared with the template or a sibling, and a reload of one
    replica leaves the other serving the old weights."""
    params = _weights()
    template = _toy(T)
    template.load_params(params, device="cpu")
    pool = tfleet.ReplicaPool.for_keras(template, n_replicas=2,
                                        devices=CPU2, batcher=None)
    ptrs = [{t.data_ptr() for t in r.model._net.parameters()}
            for r in pool.replicas]
    tptr = {t.data_ptr() for t in template.parameters()}
    assert not (ptrs[0] & ptrs[1]) and not (ptrs[0] & tptr)
    x = np.random.RandomState(9).randn(3, 4).astype(np.float32)
    doubled = {k: {kk: vv * 2 for kk, vv in v.items()}
               for k, v in params.items()}
    r0, r1 = pool.replicas
    r0.model.load_keras_net(r0.model._net, params=doubled)
    np.testing.assert_allclose(r1.predict(x), _ref(params, x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(r0.predict(x), _ref(doubled, x),
                               rtol=1e-5, atol=1e-5)


# -- fleet cases of test_faults.py --------------------------------------------

class _CountingModel:
    can_relower = False
    example_input_specs = None
    generation = 0
    concurrent_slots_free = 1
    supported_concurrent_num = 1

    def __init__(self):
        self.calls = 0

    def predict(self, xs, timeout_ms=-1):
        self.calls += 1
        return np.asarray(xs[0] if isinstance(xs, list) else xs) * 2.0


def _counting_fleet(lib, **router_kw):
    models = [_CountingModel() for _ in range(2)]
    replicas = [lib.fleet.Replica(f"r{i}", m,
                                  batcher_kwargs={"max_wait_ms": 1})
                for i, m in enumerate(models)]
    return lib.fleet.FleetRouter(lib.fleet.ReplicaPool(replicas=replicas),
                                 probe_interval_s=0, **router_kw
                                 ).start(), models


def test_hash_policy_sibling_retry_is_exactly_once():
    """Kill the hash-affine replica at admission: the request lands
    exactly once on the sibling and the dead replica is ejected."""
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    homes = {}
    for lib in LIBS:
        router, models = _counting_fleet(lib, policy="hash", eject_after=1,
                                         max_retries=2)
        try:
            key = router._affinity_key([x])
            home = router._pick(2, key, set()).name
            homes[lib.name] = home
            lib.faults.arm("fleet/replica_predict", "kill",
                           where={"replica": home})
            out = router.submit([x]).result(timeout=TIMEOUT)
            np.testing.assert_allclose(np.asarray(out), x * 2.0)
            calls = {f"r{i}": m.calls for i, m in enumerate(models)}
            assert calls[home] == 0  # killed at admission, never ran
            assert sum(calls.values()) == 1  # exactly once
            assert _metric_sum(lib, "zoo_tpu_fleet_ejections_total") == 1
            st = {r["name"]: r["state"]
                  for r in router.fleet_status()["replicas"]}
            assert st[home] == "down"
        finally:
            lib.faults.disarm_all()
            router.stop()
    assert homes["port"] == homes["jax"]


def test_dispatch_fault_mid_batch_retries_on_sibling():
    """A dispatcher failure after admission re-dispatches on a sibling
    through the router's retry: the acked request is never lost."""
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    for lib in LIBS:
        router, models = _counting_fleet(lib, policy="hash", max_retries=2)
        try:
            lib.faults.arm("batcher/dispatch", "error", times=1)
            out = router.submit([x]).result(timeout=TIMEOUT)
            np.testing.assert_allclose(np.asarray(out), x * 2.0)
            assert sum(m.calls for m in models) == 1  # exactly once
            assert _metric_sum(lib, "zoo_tpu_fleet_retries_total") >= 1
        finally:
            lib.faults.disarm_all()
            router.stop()


def test_corrupt_fault_poisons_direct_predict_output():
    for lib in LIBS:
        router = lib.fleet.FleetRouter(lib.fleet.ReplicaPool(
            replicas=[lib.fleet.Replica("r0", _CountingModel())]),
            probe_interval_s=0)
        try:
            lib.faults.arm("fleet/replica_predict", "corrupt", times=1)
            rep = router.pool.replicas[0]
            assert np.isnan(np.asarray(rep.predict(
                np.ones((1, 4), np.float32)))).all()
            assert not np.isnan(np.asarray(rep.predict(
                np.ones((1, 4), np.float32)))).any()
        finally:
            router.stop()


# -- FleetRouter cases of test_federation.py ----------------------------------

class _DoublingModel:
    """Duck-typed model: doubles its input."""

    concurrent_slots_free = 4
    supported_concurrent_num = 4
    example_input_specs = None
    generator = None

    def predict(self, xs, timeout_ms=-1):
        return [np.asarray(x, dtype=np.float32) * 2 for x in xs]


def test_injected_replica_delay_fires_replica_skew():
    """A delay fault on r0 makes its router-measured p99 diverge from
    its sibling's; two collector ticks on an injected clock fire the
    replica_skew anomaly in both packages."""
    verdicts = {}
    for lib in LIBS:
        lib.faults.arm("fleet/replica_predict", "delay", seconds=0.05,
                       where={"replica": "r0"})
        router = lib.fleet.FleetRouter(lib.fleet.ReplicaPool(replicas=[
            lib.fleet.Replica(f"r{i}", _DoublingModel(), batcher=None)
            for i in range(2)]), probe_interval_s=0).start()
        heard = []

        def listen(kind, fields, heard=heard):
            heard.append((kind, fields))
        try:
            col = router.telemetry
            assert col is not None and col.tick_s == 0
            col.skew = lib.diag.ReplicaSkewDetector(
                factor=3.0, min_events=2, cooldown_s=60.0)
            col.tick(now=100.0)  # baseline window
            x = np.ones((1, 4), np.float32)
            for _ in range(10):
                router.predict([x])
            lib.diag.add_anomaly_listener(listen)
            col.tick(now=200.0)
            assert col.skew.fired >= 1
            skews = [f for k, f in heard if k == "replica_skew"]
            assert skews and skews[0]["replica"] == "r0"
            assert skews[0]["metric"] == "latency_p99"
            stats = col.status()["replica_stats"]
            assert stats["r0"]["p99_s"] > 3 * stats["r1"]["p99_s"]
            verdicts[lib.name] = (skews[0]["replica"], skews[0]["metric"],
                                  sorted(stats))
        finally:
            lib.diag.remove_anomaly_listener(listen)
            lib.faults.disarm_all()
            router.stop()
    assert verdicts["port"] == verdicts["jax"]


_WORKER = r"""
import json, sys, time
import numpy as np
from analytics_zoo_tpu_torch.pipeline.inference.serving import \
    InferenceServer

class M:
    concurrent_slots_free = 8
    supported_concurrent_num = 8
    example_input_specs = None
    generator = None
    def predict(self, xs, timeout_ms=-1):
        return [np.asarray(x, dtype=np.float32) * 2 for x in xs]

srv = InferenceServer(M(), port=0, batcher=None)
srv.start()
print(json.dumps({"port": srv.port}), flush=True)
while True:
    time.sleep(3600)
"""


def _counter_value(snap, name, **labels):
    fam = snap.get(name) or {}
    return sum(rec["value"] for rec in fam.get("values", ())
               if all(rec.get("labels", {}).get(k) == v
                      for k, v in labels.items()))


def test_subprocess_fleet_federation_and_stitching(tmp_path):
    """Two port worker processes behind a port router as HttpReplicas:
    the federated request counter equals the router's own plus each
    worker's exactly, and one traced request stitches spans from the
    router's process and a worker's (the reference's case, on the
    port's processes)."""
    script = tmp_path / "replica_worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, str(script)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True, env=env)
             for _ in range(2)]
    router = srv = None
    try:
        urls = []
        for p in procs:
            line = p.stdout.readline()
            assert line, "replica worker died before binding"
            urls.append(f"http://127.0.0.1:{json.loads(line)['port']}")
        router = tfleet.FleetRouter(tfleet.ReplicaPool(replicas=[
            tfleet.HttpReplica(u, name=f"r{i}")
            for i, u in enumerate(urls)]), probe_interval_s=0).start()
        srv = tsv.InferenceServer(router, port=0).start()
        errs = []

        def client(ci):
            for _ in range(6):
                try:
                    s, out, _h = _post(srv.port,
                                       {"inputs": [[float(ci), 2.0, 3.0,
                                                    4.0]]})
                    assert s == 200
                    assert np.asarray(out["outputs"]).ravel()[0] == 2 * ci
                except Exception as e:
                    errs.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert errs == []
        per_replica = []
        for u in urls:
            with urllib.request.urlopen(f"{u}/metrics/json",
                                        timeout=TIMEOUT) as r:
                per_replica.append(_counter_value(
                    json.loads(r.read())["metrics"],
                    "zoo_tpu_serving_requests_total", path="/predict",
                    status="200"))
        assert sum(per_replica) == 24 and all(v > 0 for v in per_replica)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics?fleet=1",
                timeout=TIMEOUT) as r:
            body = r.read().decode()
            assert r.headers["Content-Type"] == "text/plain; version=0.0.4"
        merged, _ = router.telemetry.merged_snapshot()
        fed = _counter_value(merged, "zoo_tpu_serving_requests_total",
                             path="/predict", status="200")
        local = _counter_value(tobs.snapshot(),
                               "zoo_tpu_serving_requests_total",
                               path="/predict", status="200")
        assert fed == local + sum(per_replica)
        m = re.search(r'^zoo_tpu_serving_requests_total\{[^}]*'
                      r'path="/predict"[^}]*status="200"[^}]*\} (\d+)',
                      body, re.M)
        assert m and float(m.group(1)) == fed
        # one traced request → one stitched cross-process timeline
        _s, _out, hdrs = _post(srv.port, {"inputs": [[1.0, 2.0, 3.0,
                                                      4.0]]})
        tid = hdrs["X-Zoo-Trace-Id"]
        _s, t = _get(srv.port, f"/debug/trace/{tid}")
        assert t["trace_id"] == tid and "router" in t["sources"]
        assert any(src in ("r0", "r1") for src in t["sources"])
        names = {sp["name"] for sp in t["spans"]}
        assert {"fleet/remote_predict", "serving/request"} <= names
        _s, ch = _get(srv.port, f"/debug/trace/{tid}?chrome=1")
        xs = [e for e in ch["traceEvents"] if e.get("ph") == "X"]
        assert len({e["pid"] for e in xs}) >= 2
    finally:
        if srv is not None:
            srv.stop()
        elif router is not None:
            router.stop()
        for p in procs:
            p.kill()
        for p in procs:
            p.wait(timeout=10)


def test_retry_hint_matches_reference_batcher():
    """``DynamicBatcher.retry_hint_s``: max(0.05, depth x EMA batch
    time), as the reference's."""
    from analytics_zoo_tpu.pipeline.inference import batching as jb
    for mod in (tb, jb):
        b = mod.DynamicBatcher(_CountingModel(), queue_depth=8)
        assert b.retry_hint_s() == 0.05
        b._ema_batch_s = 0.04
        with b._cond:
            b._q.extend([object()] * 3)
        assert b.retry_hint_s() == pytest.approx(0.12)
        with b._cond:
            b._q.clear()
