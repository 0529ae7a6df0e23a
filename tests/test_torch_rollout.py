"""The port's model registry and canary rollout
(``pipeline/inference/registry.py``) against the JAX package's: the
reference tests' cases (``test_rollout.py``), each run on a fleet of each
package over the same stub models, with the same requests and the same
injected clock.

Held: registration, lookup and the on-disk layout (each package reads
the other's registry root), the rollout's state sequences and its
``/debug/rollout`` payloads (equal but for their time fields), the
cohort split's buckets, the error-burst and SLO-breach rollbacks, and
zero failed requests through a swap; an artifact version loaded and
served, and ``register_export`` into each package's registry (the same
``meta.json``, the same warm buckets, outputs within 1e-5). No test
waits out ``bake_s``: the controller ticks on the router's clock.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.common import observability as jobs
from analytics_zoo_tpu.common import slo as jslo
from analytics_zoo_tpu.pipeline.inference import fleet as jfleet
from analytics_zoo_tpu.pipeline.inference import registry as jreg
from analytics_zoo_tpu.pipeline.inference import serving as jsv
from analytics_zoo_tpu_torch.common import faults as tfaults
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.common import slo as tslo
from analytics_zoo_tpu_torch.pipeline.inference import fleet as tfleet
from analytics_zoo_tpu_torch.pipeline.inference import registry as treg
from analytics_zoo_tpu_torch.pipeline.inference import serving as tsv

TIMEOUT = 10


class Lib:
    def __init__(self, name, fleet, reg, serving, faults, obs, slo):
        self.name, self.fleet, self.reg, self.serving = name, fleet, reg, \
            serving
        self.faults, self.obs, self.slo = faults, obs, slo


T = Lib("port", tfleet, treg, tsv, tfaults, tobs, tslo)
J = Lib("jax", jfleet, jreg, jsv, jfaults, jobs, jslo)
LIBS = (T, J)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_SLO_TICK_S", "0")
    monkeypatch.setenv("ZOO_TPU_FED_TICK_S", "0")
    resets = (tobs.reset_metrics, tfaults.reset_faults, tslo.reset_slo,
              jobs.reset_metrics, jfaults.reset_faults)
    for reset in resets:
        reset()
    yield
    for reset in resets:
        reset()


def _metric_sum(lib, name):
    fam = lib.obs.snapshot().get(name)
    if fam is None:
        return 0.0
    return sum(v["value"] for v in fam["values"])


def _untimed(payload):
    """A rollout payload without its time fields (the clock's readings
    and registration times)."""
    out = {k: v for k, v in payload.items() if k != "canary_age_s"}
    for key in ("transitions", "swaps"):
        if key in out:
            out[key] = [{k: v for k, v in rec.items() if k != "at"}
                        for rec in out[key]]
    return out


# -- registry -----------------------------------------------------------------

def test_registry_register_lookup_latest():
    for lib in LIBS:
        reg = lib.reg.ModelRegistry(root=None)
        v0 = reg.register("toy", "v0", loader=lambda m: None,
                          metadata={"note": "baseline"})
        v1 = reg.register("toy", "v1", loader=lambda m: None)
        v1.created_at = v0.created_at + 1.0  # latest() orders by time
        assert reg.get("toy", "v0") is v0
        assert reg.latest("toy") is v1
        assert reg.versions("toy") == ["v0", "v1"]
        assert reg.models() == ["toy"]
        with pytest.raises(ValueError, match="immutable"):
            reg.register("toy", "v0", loader=lambda m: None)
        with pytest.raises(KeyError):
            reg.get("toy", "nope")
        with pytest.raises(KeyError):
            reg.latest("unknown-model")


def test_model_version_needs_exactly_one_source():
    for lib in LIBS:
        with pytest.raises(ValueError):
            lib.reg.ModelVersion("toy", "v1")
        with pytest.raises(ValueError):
            lib.reg.ModelVersion("toy", "v1", artifact="a.zip",
                                 loader=lambda m: None)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_registry_persistence_roundtrip(tmp_path, writer):
    """A root written by one package reads back in both: the artifact's
    bytes, metadata and warm buckets; a torn registration (no
    meta.json) is invisible; in-memory versions never persist."""
    w = T if writer == "port" else J
    src = tmp_path / "export.zip"
    src.write_bytes(b"fake-compiled-artifact")
    root = str(tmp_path / "registry")
    w.reg.ModelRegistry(root=root).register(
        "toy", "v1", artifact=str(src), metadata={"mfu": 0.33},
        warm_buckets=[1, 2, 4])
    assert sorted(os.listdir(os.path.join(root, "toy", "v1"))) == [
        "artifact.zip", "meta.json"]
    os.makedirs(os.path.join(root, "toy", "v2"))
    for lib in LIBS:
        reg = lib.reg.ModelRegistry(root=root)
        mv = reg.get("toy", "v1")
        assert mv.metadata == {"mfu": 0.33}
        assert mv.warm_buckets == [1, 2, 4]
        with open(mv.artifact, "rb") as f:
            assert f.read() == b"fake-compiled-artifact"
        assert reg.versions("toy") == ["v1"]
    reg = T.reg.ModelRegistry(root=root)
    reg.register("toy", "v3", loader=lambda m: None)
    assert T.reg.ModelRegistry(root=root).versions("toy") == ["v1"]
    assert J.reg.ModelRegistry(root=root).versions("toy") == ["v1"]


def _bridged_dense_models():
    """The same Dense 4→8→2 weights behind an ``InferenceModel`` of each
    package, loaded with an 8-row example; and the rows to predict."""
    import jax
    import jax.numpy as jnp

    import analytics_zoo_tpu_torch as tzoo
    from analytics_zoo_tpu import init_nncontext as jinit
    from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSeq
    from analytics_zoo_tpu.pipeline.api.keras import layers as JL
    from analytics_zoo_tpu.pipeline.inference import \
        InferenceModel as JIM
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import \
        Sequential as TSeq
    from analytics_zoo_tpu_torch.pipeline.inference import \
        InferenceModel as TIM

    def net(seq, lib):
        m = seq()
        m.add(lib.Dense(8, activation="relu", input_shape=(4,)))
        m.add(lib.Dense(2))
        return m
    tzoo.init_nncontext(seed=0, device="cpu")
    jinit(seed=0)
    jm = net(JSeq, JL)
    params = jax.device_get(jm.init_params(jax.random.key(0)))
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    models = {
        "port": TIM(2).load_keras_net(net(TSeq, TL), params=params,
                                      example_inputs=[x]),
        "jax": JIM(2).load_keras_net(
            jm, params=jax.tree_util.tree_map(jnp.asarray, params),
            example_inputs=[x]),
    }
    return models, {"port": TIM, "jax": JIM}, x


def test_artifact_version_loads_and_serves(tmp_path):
    models, fresh, x = _bridged_dense_models()
    src = str(tmp_path / "export.zip")
    models["port"].export_compiled(src)
    reg = treg.ModelRegistry(root=str(tmp_path / "registry"))
    mv = reg.register("toy", "v1", artifact=src)
    assert mv.artifact != src and os.path.isfile(mv.artifact)
    im = fresh["port"](2)
    mv.load_into(im)
    assert im.generation == 1 and im.concurrent_slots_free == 2
    assert np.array_equal(im.predict(x), models["port"].predict(x))
    swaps = tobs.snapshot()["zoo_tpu_rollout_swap_seconds"]["values"]
    assert sum(v["count"] for v in swaps) == 1


def test_register_export_roundtrip_matches_reference(tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("ZOO_TPU_SERVING_MAX_BATCH", "16")
    models, fresh, x = _bridged_dense_models()
    metas, outs = {}, {}
    for lib in LIBS:
        root = str(tmp_path / lib.name)
        reg = lib.reg.ModelRegistry(root=root)
        mv = reg.register_export("toy", "v1", models[lib.name],
                                 metadata={"mfu": 0.5})
        assert mv.artifact == os.path.join(root, "toy", "v1",
                                           "artifact.zip")
        with open(os.path.join(root, "toy", "v1", "meta.json")) as f:
            metas[lib.name] = {k: v for k, v in json.load(f).items()
                               if k != "created_at"}
        # a fresh registry over the same root finds it and loads it
        again = lib.reg.ModelRegistry(root=root).get("toy", "v1")
        assert again.warm_buckets == [1, 2, 4, 8, 16]
        im = fresh[lib.name](2)
        again.load_into(im)
        outs[lib.name] = np.asarray(im.predict(x))
        want = np.asarray(models[lib.name].predict(x))
        if lib is T:
            assert np.array_equal(outs[lib.name], want)
        else:
            np.testing.assert_allclose(outs[lib.name], want, rtol=1e-6,
                                       atol=1e-7)
        with pytest.raises(ValueError, match="root"):
            lib.reg.ModelRegistry().register_export("toy", "v2",
                                                    models[lib.name])
    assert metas["port"] == metas["jax"]
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(
                                   outs["jax"]).max())))


# -- fleet fixtures -----------------------------------------------------------

class _VersionedStub:
    """Duck-typed model whose output encodes the loaded version."""

    can_relower = False
    example_input_specs = None
    generation = 0
    concurrent_slots_free = 1
    supported_concurrent_num = 1

    def __init__(self, factor=2.0):
        self.factor = factor

    def predict(self, xs, timeout_ms=-1):
        x = xs[0] if isinstance(xs, list) else xs
        return np.asarray(x) * self.factor


def _loader(factor):
    def load(model):
        model.factor = factor
        model.generation += 1
    return load


def _rollout_fleet(lib, n=4, clock=None, **router_kw):
    """n stub replicas on v0 (x2) and a registry holding v0 and a v2
    whose loader makes the model multiply by 3; the pool's clock is
    ``clock`` (a list holding now) when given."""
    reg = lib.reg.ModelRegistry(root=None)
    reg.register("toy", "v0", loader=_loader(2.0))
    v2 = reg.register("toy", "v2", loader=_loader(3.0))
    models = [_VersionedStub() for _ in range(n)]
    replicas = [lib.fleet.Replica(f"r{i}", m,
                                  batcher_kwargs={"max_wait_ms": 1})
                for i, m in enumerate(models)]
    kw = {} if clock is None else {"clock": lambda: clock[0]}
    router_kw.setdefault("probe_interval_s", 0)
    router = lib.fleet.FleetRouter(
        lib.fleet.ReplicaPool(replicas=replicas, **kw), **router_kw)
    return router.start(), models, reg, v2


# -- the happy path: the canary bakes clean and is promoted -------------------

def test_canary_rollout_promotes_after_clean_bake():
    seqs = {}
    for lib in LIBS:
        clock = [500.0]
        router, models, reg, v2 = _rollout_fleet(lib, 4, clock=clock)
        try:
            x = np.ones((1, 3), np.float32)
            np.testing.assert_allclose(router.submit([x]).result(TIMEOUT),
                                       x * 2.0)
            ctl = router.rollout(v2, canary_pct=25, bake_s=30.0)
            assert ctl.state == "canary"
            st = router.rollout_status()
            assert st["canary"]["pct"] == 25
            assert sorted(st["replica_versions"].values()) == [
                "v0", "v0", "v0", "v2"]
            assert st["replica_versions"][ctl.canary_replicas[0]] == "v2"
            ids = {s["id"] for s in
                   lib.slo.get_engine().status()["objectives"]}
            assert "rollout_canary" in ids
            for _ in range(12):
                out = np.asarray(router.submit([x]).result(TIMEOUT))
                assert np.allclose(out, x * 2.0) or np.allclose(out, x * 3.0)
            ctl.tick(now=ctl.canary_since + 5.0)
            assert ctl.state == "canary"  # still baking
            clock[0] += 31.0
            router.tick()
            assert ctl.state == "promoted"
            st = router.rollout_status()
            assert set(st["replica_versions"].values()) == {"v2"}
            assert st["canary"] is None
            assert all(m.factor == 3.0 for m in models)
            np.testing.assert_allclose(router.submit([x]).result(TIMEOUT),
                                       x * 3.0)
            assert all(s["flushed"] for s in ctl.swaps)
            assert len(ctl.swaps) == 4
            ids = {s["id"] for s in
                   lib.slo.get_engine().status()["objectives"]}
            assert "rollout_canary" not in ids
            assert _metric_sum(lib, "zoo_tpu_rollout_active") == 0
            seqs[lib.name] = (_untimed(st),
                              [t["at"] for t in ctl.transitions])
        finally:
            router.stop()
    assert seqs["port"] == seqs["jax"]
    assert [t["state"] for t in seqs["port"][0]["transitions"]] == [
        "rolling", "canary", "promoting", "promoted"]


def test_plain_rolling_update_without_canary():
    for lib in LIBS:
        router, models, reg, v2 = _rollout_fleet(lib, 2)
        try:
            ctl = router.rollout(v2, canary_pct=100)
            assert ctl.state == "promoted"
            assert all(m.factor == 3.0 for m in models)
            assert router.rollout_status()["canary"] is None
            assert [t["state"] for t in ctl.transitions] == [
                "rolling", "promoted"]
        finally:
            router.stop()


def test_second_rollout_rejected_while_in_progress():
    msgs = {}
    for lib in LIBS:
        router, models, reg, v2 = _rollout_fleet(lib, 4)
        try:
            router.rollout(v2, canary_pct=25, bake_s=3600)
            with pytest.raises(RuntimeError, match="still") as ei:
                router.rollout(v2, canary_pct=25)
            msgs[lib.name] = str(ei.value)
        finally:
            router.stop()
    assert msgs["port"] == msgs["jax"]


def test_rollout_without_resolvable_baseline_refuses_to_start():
    """A rollout that could not roll back must not begin: no registry
    entry for the replicas' version and no ``baseline=``."""
    for lib in LIBS:
        models = [_VersionedStub() for _ in range(2)]
        router = lib.fleet.FleetRouter(lib.fleet.ReplicaPool(replicas=[
            lib.fleet.Replica(f"r{i}", m, batcher_kwargs={"max_wait_ms": 1})
            for i, m in enumerate(models)]), probe_interval_s=0).start()
        try:
            orphan = lib.reg.ModelVersion("toy", "v9", loader=_loader(9.0))
            with pytest.raises(ValueError, match="baseline"):
                router.rollout(orphan, canary_pct=50)
            assert all(m.factor == 2.0 for m in models)
            assert all(r.version == "v0" for r in router.pool.replicas)
        finally:
            router.stop()


# -- automatic rollback -------------------------------------------------------

def test_canary_error_burst_rolls_back_automatically():
    """An error fault on the canary replica: its cohort's burst crosses
    ``max_canary_errors`` and the next tick rolls it back through the
    drain path, with no client request lost."""
    got = {}
    for lib in LIBS:
        router, models, reg, v2 = _rollout_fleet(lib, 4, clock=[10.0])
        try:
            ctl = router.rollout(v2, canary_pct=25, bake_s=3600.0,
                                 max_canary_errors=3)
            lib.faults.arm("fleet/replica_predict", "error",
                           where={"replica": ctl.canary_replicas[0]})
            x = np.ones((1, 3), np.float32)
            outs = [np.asarray(router.predict(x)) for _ in range(40)]
            for out in outs:
                assert np.allclose(out, x * 2.0) or np.allclose(out, x * 3.0)
            assert _metric_sum(lib, "zoo_tpu_rollout_errors_total") >= 3
            router.tick()
            assert ctl.state == "rolled_back"
            assert "error burst" in ctl.reason
            st = router.rollout_status()
            assert set(st["replica_versions"].values()) == {"v0"}
            assert st["canary"] is None
            assert all(m.factor == 2.0 for m in models)
            assert _metric_sum(lib, "zoo_tpu_anomalies_total") >= 1
            trans = {v["labels"]["state"]: v["value"] for v in
                     lib.obs.snapshot()["zoo_tpu_rollout_transitions_total"]
                     ["values"]}
            assert trans["rolling_back"] == trans["rolled_back"] == 1
            lib.faults.disarm_all()
            np.testing.assert_allclose(router.predict(x), x * 2.0)
            got[lib.name] = (_untimed(st), [
                np.asarray(o).tolist() for o in outs])
        finally:
            lib.faults.disarm_all()
            router.stop()
    assert got["port"] == got["jax"]


def test_slo_breach_on_canary_cohort_rolls_back():
    """The SLO engine's path: a burn-rate breach on the cohort's
    error-ratio objective reaches the anomaly listener and the next
    tick rolls back."""
    reasons = {}
    for lib in LIBS:
        engine = lib.slo.SLOEngine(clock=lambda: 0.0)
        router, models, reg, v2 = _rollout_fleet(lib, 4)
        try:
            ctl = router.rollout(v2, canary_pct=25, bake_s=3600.0,
                                 max_canary_errors=None, engine=engine,
                                 slo_min_events=5)
            assert ctl.state == "canary"
            engine.tick(now=0.0)
            lib.fleet._c_cohort_requests("v2").inc(10)
            lib.fleet._c_cohort_errors("v2").inc(6)
            engine.tick(now=200.0)
            status = {s["id"]: s for s in engine.status()["objectives"]}
            assert status["rollout_canary"]["state"] == "breach"
            router.tick()
            assert ctl.state == "rolled_back"
            assert "slo_breach" in ctl.reason
            assert all(m.factor == 2.0 for m in models)
            assert "rollout_canary" not in {
                s["id"] for s in engine.status()["objectives"]}
            reasons[lib.name] = ctl.reason
        finally:
            router.stop()
    assert reasons["port"] == reasons["jax"]


def test_manual_promote_and_rollback_guards():
    for lib in LIBS:
        router, models, reg, v2 = _rollout_fleet(lib, 4)
        try:
            ctl = router.rollout(v2, canary_pct=25, bake_s=3600.0)
            ctl.promote()
            assert ctl.state == "promoted"
            with pytest.raises(RuntimeError):
                ctl.promote()
            with pytest.raises(RuntimeError):
                ctl.rollback()
        finally:
            router.stop()
    # a manual rollback from the canary, in both packages alike
    states = {}
    for lib in LIBS:
        router, models, reg, v2 = _rollout_fleet(lib, 2)
        try:
            ctl = router.rollout(v2, canary_pct=50, bake_s=3600.0)
            ctl.rollback("operator")
            states[lib.name] = ([t["state"] for t in ctl.transitions],
                                ctl.reason)
            assert all(m.factor == 2.0 for m in models)
        finally:
            router.stop()
    assert states["port"] == states["jax"] == (
        ["rolling", "canary", "rolling_back", "rolled_back"], "operator")


# -- traffic split ------------------------------------------------------------

def test_cohort_split_is_sticky_and_proportional():
    cohorts = {}
    for lib in LIBS:
        router, models, reg, v2 = _rollout_fleet(lib, 2, policy="hash")
        try:
            router.set_canary("v2", "v0", 25)
            rs = np.random.RandomState(0)
            keys = [router._affinity_key([rs.randn(1, 3).astype(
                np.float32)]) for _ in range(300)]
            got = [router._cohort_version(k) for k in keys]
            for k, c in zip(keys, got):
                assert all(router._cohort_version(k) == c for _ in range(3))
            assert 0.15 < got.count("v2") / len(got) < 0.35
            router.set_canary("v2", "v0", 0)
            assert all(router._cohort_version(k) == "v0" for k in keys)
            router.clear_canary()
            assert router._cohort_version(keys[0]) is None
            cohorts[lib.name] = got
        finally:
            router.stop()
    assert cohorts["port"] == cohorts["jax"]


def test_concurrent_traffic_during_rollout_loses_nothing():
    """Clients hammering the fleet through the swap see only valid
    outputs (old or new version): never an error, never a drop."""
    for lib in LIBS:
        router, models, reg, v2 = _rollout_fleet(lib, 3)
        try:
            x = np.ones((2, 3), np.float32)
            stop = threading.Event()
            results = {"ok": 0, "bad": []}
            lock = threading.Lock()

            def client():
                while not stop.is_set():
                    try:
                        out = np.asarray(router.submit([x]).result(30))
                        good = (np.allclose(out, x * 2.0)
                                or np.allclose(out, x * 3.0))
                        with lock:
                            if good:
                                results["ok"] += 1
                            else:
                                results["bad"].append(out)
                    except Exception as e:
                        with lock:
                            results["bad"].append(repr(e))

            threads = [threading.Thread(target=client) for _ in range(4)]
            for t in threads:
                t.start()
            try:
                ctl = router.rollout(v2, canary_pct=34, bake_s=0.0)
                ctl.tick(now=ctl.canary_since + 1.0)
                assert ctl.state == "promoted"
                ok0 = results["ok"]
                assert _wait(lambda: results["ok"] > ok0 + 4)
            finally:
                stop.set()
                for t in threads:
                    t.join(timeout=TIMEOUT)
            assert results["bad"] == []
            assert results["ok"] > 0
        finally:
            router.stop()


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.002)
    return cond()


# -- the debug surface --------------------------------------------------------

def test_debug_rollout_payload():
    payloads = {}
    for lib in LIBS:
        for holder in (None, object()):
            status, _ = lib.serving._rollout_payload(holder)
            assert status == 404
        router, models, reg, v2 = _rollout_fleet(lib, 4, clock=[7.0])
        try:
            status, payload = lib.serving._rollout_payload(router)
            assert status == 200
            assert payload == {"state": "idle", "canary": None}
            ctl = router.rollout(v2, canary_pct=25, bake_s=3600.0)
            status, canary = lib.serving._rollout_payload(router)
            assert status == 200 and canary["state"] == "canary"
            assert canary["version"] == "v2"
            assert canary["baseline"] == "v0"
            assert canary["canary"]["pct"] == 25
            assert canary["canary_replicas"] == ctl.canary_replicas
            json.dumps(canary)
            ctl.promote()
            status, done = lib.serving._rollout_payload(router)
            assert done["state"] == "promoted"
            payloads[lib.name] = (canary, done)
        finally:
            router.stop()
    # equal field for field, time fields included (one injected clock)
    assert payloads["port"] == payloads["jax"]
    assert tsv._rollout_payload(None) == jsv._rollout_payload(None)
