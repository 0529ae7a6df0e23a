"""The port's ``DynamicBatcher`` (``pipeline/inference/batching.py``)
against the JAX package's, case by case as ``tests/test_serving_batch.py``
runs it: the bucket ladder, coalescing with per-request outputs,
padding at the ladder's edges, queue-full backpressure, deadline
eviction, the ``ZOO_TPU_SERVING_BATCH=0`` revert, a reload clearing the
buckets and no new bucket callable after warm-up.

Each case runs on both batchers, over the same bridged weights (a
``Sequential`` Dense 16→32→4) or the same duck-typed stub model, and
must give the same outputs (f32 within 1e-5 of max(1, max|ref|)), the
same counters and the same errors. Every future is read with a
timeout and every batcher and server is stopped in a ``finally``.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as jinit
from analytics_zoo_tpu.common import observability as jobs
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.inference import batching as jb
from analytics_zoo_tpu.pipeline.inference import \
    InferenceModel as JInferenceModel
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
from analytics_zoo_tpu_torch.pipeline.inference import batching as tb
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.pipeline.inference import serving as tsv

SIDES = ("port", "jax")
TIMEOUT = 60


@pytest.fixture(autouse=True)
def _fresh():
    tzoo.init_nncontext(seed=0, device="cpu")
    tobs.reset_metrics()
    jobs.reset_metrics()
    yield
    tobs.reset_metrics()
    jobs.reset_metrics()
    tzoo.reset_nncontext()


@pytest.fixture(scope="module")
def weights():
    jinit(seed=0)
    m = _net(JL)
    return jax.device_get(m.init_params(jax.random.key(0)))


def _net(lib):
    m = JSequential() if lib is JL else Sequential()
    m.add(lib.Dense(32, activation="relu", input_shape=(16,)))
    m.add(lib.Dense(4))
    return m


def _loaded(side, params, example_batch=None):
    """An InferenceModel of ``side`` serving the Dense net on
    ``params``, with declared example inputs when ``example_batch``."""
    kw = {}
    if example_batch is not None:
        kw["example_inputs"] = [np.random.RandomState(1).randn(
            example_batch, 16).astype(np.float32)]
    if side == "port":
        return InferenceModel(supported_concurrent_num=2).load_keras_net(
            _net(TL), params=params, **kw)
    jinit(seed=0)
    m = _net(JL)
    m.compile(optimizer="sgd", loss="mse")
    return JInferenceModel(supported_concurrent_num=2).load_keras_net(
        m, params=jax.tree_util.tree_map(jnp.asarray, params), **kw)


def _mod(side):
    return tb if side == "port" else jb


def _metric(side, name):
    fam = (tobs if side == "port" else jobs).snapshot().get(name)
    return 0.0 if fam is None else sum(v["value"] for v in fam["values"])


def _kinds(side):
    fam = (tobs if side == "port" else jobs).snapshot()[
        "zoo_tpu_serving_errors_total"]
    return {v["labels"]["kind"]: v["value"] for v in fam["values"]}


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


class _StubModel:
    """Duck-typed model that cannot build bucket callables, so the
    batcher runs ``predict``, which blocks until released: queue states
    are then deterministic."""

    can_relower = False
    example_input_specs = None
    generation = 0
    concurrent_slots_free = 1
    supported_concurrent_num = 1

    def __init__(self):
        self.started = threading.Event()
        self.release = threading.Event()

    def predict(self, xs):
        self.started.set()
        assert self.release.wait(TIMEOUT), "test forgot to release stub"
        x = xs[0] if isinstance(xs, list) else xs
        return np.asarray(x) * 2.0


# -- ladder ---------------------------------------------------------------

@pytest.mark.parametrize("args", [(32,), (12,), (1,), (32, [4, 16, 8]),
                                  (8, [3, 3, 5]), (5, (2,))])
def test_bucket_ladder_matches_jax(args):
    assert tb.bucket_ladder(*args) == jb.bucket_ladder(*args)


@pytest.mark.parametrize("override", [[0, 4], [], [-2], set()])
def test_bucket_ladder_rejects_what_jax_rejects(override):
    for mod in (tb, jb):
        with pytest.raises(ValueError, match="invalid bucket ladder"):
            mod.bucket_ladder(8, override)


def test_ladder_from_the_environment(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_SERVING_BUCKETS", "2,8,4")
    monkeypatch.setenv("ZOO_TPU_SERVING_MAX_WAIT_MS", "7")
    monkeypatch.setenv("ZOO_TPU_SERVING_DEADLINE_MS", "250")
    port = tb.DynamicBatcher(_StubModel())
    ref = jb.DynamicBatcher(_StubModel())
    assert port.stats() == ref.stats()
    assert port.buckets == (2, 4, 8)
    monkeypatch.setenv("ZOO_TPU_SERVING_BATCH", "0")
    assert tb.DynamicBatcher.from_env(_StubModel()) is None


# -- coalescing -------------------------------------------------------------

def test_concurrent_clients_coalesce_with_per_request_outputs(weights):
    rs = np.random.RandomState(0)
    xs = [rs.randn(1, 16).astype(np.float32) for _ in range(8)]
    ref_im = _loaded("jax", weights)
    for side in SIDES:
        im = _loaded(side, weights)
        b = _mod(side).DynamicBatcher(im, max_batch_size=16,
                                      max_wait_ms=100,
                                      queue_depth=64).start()
        try:
            b.submit([xs[0]]).result(timeout=TIMEOUT)  # warms the ladder
            base = _metric(side, "zoo_tpu_serving_batch_executions_total")
            barrier = threading.Barrier(8)
            outs = [None] * 8

            def client(i):
                barrier.wait(timeout=TIMEOUT)
                outs[i] = b.submit([xs[i]]).result(timeout=TIMEOUT)

            ts = [threading.Thread(target=client, args=(i,))
                  for i in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=TIMEOUT)
            assert not any(t.is_alive() for t in ts)
        finally:
            b.stop()
        for i in range(8):
            _close(outs[i], ref_im.predict(xs[i]))
        execs = _metric(side, "zoo_tpu_serving_batch_executions_total") \
            - base
        assert execs < 8, f"{side}: 8 concurrent rows ran {execs} times"


def test_bucket_padding_at_ladder_edges(weights):
    rs = np.random.RandomState(0)
    pads = {1: 0, 2: 0, 3: 1, 4: 0, 5: 3, 8: 0}
    xs = {n: rs.randn(n, 16).astype(np.float32) for n in pads}
    big = rs.randn(11, 16).astype(np.float32)
    ref_im = _loaded("jax", weights)
    for side in SIDES:
        im = _loaded(side, weights)
        # max_wait 1 ms: sequential submits dispatch alone, so the
        # padding per dispatch is deterministic
        b = _mod(side).DynamicBatcher(im, max_batch_size=8,
                                      max_wait_ms=1, queue_depth=64).start()
        try:
            for n, pad in sorted(pads.items()):
                before = _metric(side, "zoo_tpu_serving_padding_rows_total")
                out = b.submit([xs[n]]).result(timeout=TIMEOUT)
                assert np.asarray(out).shape == (n, 4)
                _close(out, ref_im.predict(xs[n]))
                # padding rows never change the live rows: the served
                # rows equal the same rows alone
                if side == "port" and pad:
                    alone = np.concatenate([im.predict(xs[n][i:i + 1])
                                            for i in range(n)])
                    _close(out, alone)
                after = _metric(side, "zoo_tpu_serving_padding_rows_total")
                assert after - before == pad, (side, n, after - before)
            # an oversize request (rows > max_batch) is chunked
            out = b.submit([big]).result(timeout=TIMEOUT)
            assert np.asarray(out).shape == (11, 4)
            _close(out, ref_im.predict(big))
        finally:
            b.stop()
    for name in ("zoo_tpu_serving_padding_rows_total",
                 "zoo_tpu_serving_batch_executions_total"):
        assert _metric("port", name) == _metric("jax", name)


# -- backpressure and deadlines ---------------------------------------------

@pytest.mark.parametrize("side", SIDES)
def test_queue_full_raises_and_counts(side):
    mod = _mod(side)
    stub = _StubModel()
    b = mod.DynamicBatcher(stub, max_batch_size=4, max_wait_ms=1,
                           queue_depth=2).start()
    try:
        x = np.ones((1, 4), np.float32)
        f0 = b.submit([x])          # dispatched, blocks in predict
        assert stub.started.wait(TIMEOUT)
        f1 = b.submit([x])          # queued
        f2 = b.submit([x])          # queued: at capacity
        with pytest.raises(mod.QueueFullError) as ei:
            b.submit([x])
        assert ei.value.retry_after_s > 0
        assert b.stats()["queue_depth"] == 2
        assert _kinds(side) == {"queue_full": 1}
        stub.release.set()
        for f in (f0, f1, f2):
            np.testing.assert_array_equal(f.result(timeout=TIMEOUT), x * 2)
    finally:
        stub.release.set()
        b.stop()


@pytest.mark.parametrize("side", SIDES)
def test_deadline_expiry_evicts_before_dispatch(side):
    mod = _mod(side)
    stub = _StubModel()
    b = mod.DynamicBatcher(stub, max_batch_size=4, max_wait_ms=1,
                           queue_depth=8, deadline_ms=50).start()
    try:
        x = np.ones((2, 4), np.float32)
        f0 = b.submit([x])          # dispatched, blocks in predict
        assert stub.started.wait(TIMEOUT)
        f1 = b.submit([x])          # queued behind the blocked batch
        time.sleep(0.15)            # f1's 50 ms deadline passes
        stub.release.set()
        np.testing.assert_array_equal(f0.result(timeout=TIMEOUT), x * 2)
        with pytest.raises(mod.DeadlineExpiredError, match="50ms"):
            f1.result(timeout=TIMEOUT)
        assert _kinds(side) == {"deadline_expired": 1}
    finally:
        stub.release.set()
        b.stop()


@pytest.mark.parametrize("side", SIDES)
def test_unaligned_inputs_are_not_batchable(side):
    b = _mod(side).DynamicBatcher(_StubModel())
    one, two = np.ones((1, 4)), np.ones((2, 4))
    assert b.batchable([one]) and b.batchable([two, two])
    assert not b.batchable([]) and not b.batchable([np.float32(1.0)])
    assert not b.batchable([one, two])
    with pytest.raises(ValueError, match="row-aligned"):
        b.submit([one, two])


# -- the revert flag ----------------------------------------------------------

def test_batch_flag_zero_reverts_to_per_request(weights, monkeypatch):
    import json
    import urllib.request
    monkeypatch.setenv("ZOO_TPU_SERVING_BATCH", "0")
    im = _loaded("port", weights)
    srv = tsv.InferenceServer(im, port=0).start()
    try:
        assert srv.batcher is None
        url = f"http://127.0.0.1:{srv.port}"
        health = json.loads(urllib.request.urlopen(
            url + "/health", timeout=TIMEOUT).read())
        assert health["batcher"] == {"enabled": False}
        x = np.random.RandomState(0).randn(3, 16).astype(np.float32)
        req = urllib.request.Request(
            url + "/predict", data=json.dumps({"inputs": x.tolist()}).encode())
        out = json.loads(urllib.request.urlopen(req, timeout=TIMEOUT).read())
        _close(np.asarray(out["outputs"], np.float32),
               _loaded("jax", weights).predict(x))
    finally:
        srv.stop()
    assert _metric("port", "zoo_tpu_serving_batch_executions_total") == 0


# -- bucket callables: warm-up, reload, steady state --------------------------

class _Spy:
    """Counts the port model's ``lower_for`` calls and their threads."""

    def __init__(self, im):
        self.calls = []
        orig = im.lower_for

        def lower_for(args):
            self.calls.append((tuple(args[0][0]),
                               threading.current_thread().name))
            return orig(args)
        im.lower_for = lower_for


def test_warm_runs_every_bucket_on_the_dispatcher_thread(weights):
    im = _loaded("port", weights, example_batch=4)
    spy = _Spy(im)
    b = tb.DynamicBatcher(im, max_batch_size=8, max_wait_ms=1)
    try:
        b.start()
        assert b.warmed_buckets == 4
        assert spy.calls == [((n, 16), "zoo-tpu-batcher")
                             for n in (1, 2, 4, 8)]
        assert _metric("port", "zoo_tpu_serving_warmed_buckets") == 4
        assert _metric("port", "zoo_tpu_serving_bucket_compiles_total") == 4
        assert b.start() is b and len(spy.calls) == 4   # idempotent
    finally:
        b.stop()


def test_warm_failure_raises_from_start(weights):
    im = _loaded("port", weights, example_batch=4)

    def broken(args):
        raise RuntimeError("kernel launch failed")
    im.lower_for = broken
    b = tb.DynamicBatcher(im, max_batch_size=8)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        b.start()
    assert b.warmed_buckets == 0 and b._thread is None


def test_no_new_bucket_after_warmup_across_mixed_sizes(weights):
    rs = np.random.RandomState(0)
    sizes = [1, 3, 2, 8, 5, 4, 7, 6, 1, 8, 11]
    xs = [rs.randn(n, 16).astype(np.float32) for n in sizes]
    outs = {}
    for side in SIDES:
        im = _loaded(side, weights, example_batch=4)
        spy = _Spy(im) if side == "port" else None
        b = _mod(side).DynamicBatcher(im, max_batch_size=8, max_wait_ms=1,
                                      queue_depth=64)
        try:
            b.start()   # warm-up: the whole ladder
            assert b.warmed_buckets == 4
            outs[side] = [b.submit([x]).result(timeout=TIMEOUT)
                          for x in xs]
        finally:
            b.stop()
        assert _metric(side, "zoo_tpu_serving_bucket_compiles_total") == 4
        if spy is not None:
            assert len(spy.calls) == 4
    for got, want, n in zip(outs["port"], outs["jax"], sizes):
        assert np.asarray(got).shape == (n, 4)
        _close(got, want)


def test_reload_clears_the_buckets(weights):
    rs = np.random.RandomState(5)
    x = rs.randn(3, 16).astype(np.float32)
    other = jax.tree_util.tree_map(lambda a: (a * 0.5 + 0.1).astype(a.dtype),
                                   weights)
    got, compiles = {}, {}
    for side in SIDES:
        im = _loaded(side, weights, example_batch=4)
        b = _mod(side).DynamicBatcher(im, max_batch_size=8, max_wait_ms=1)
        try:
            b.start()
            first = b.submit([x]).result(timeout=TIMEOUT)
            gen = im.generation
            if side == "port":
                im.load_keras_net(_net(TL), params=other,
                                  example_inputs=[x[:2]])
            else:
                jinit(seed=0)
                m = _net(JL)
                m.compile(optimizer="sgd", loss="mse")
                im.load_keras_net(m, params=jax.tree_util.tree_map(
                    jnp.asarray, other), example_inputs=[x[:2]])
            assert im.generation == gen + 1
            second = b.submit([x]).result(timeout=TIMEOUT)
            assert b.warmed_buckets == 4
        finally:
            b.stop()
        got[side] = (first, second)
        compiles[side] = _metric(side,
                                 "zoo_tpu_serving_bucket_compiles_total")
        assert np.abs(np.asarray(first) - np.asarray(second)).max() > 1e-3
    assert compiles["port"] == compiles["jax"] == 8
    for a, b_ in zip(got["port"], got["jax"]):
        _close(a, b_)


def test_load_serves_a_saved_zoo_model_with_int_ids(tmp_path):
    # InferenceModel.load: a ZooModel file of the port, served with its
    # declared int32 ids; JSON ids stay ints through the batcher
    import json
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    ncf = NeuralCF(10, 8, 3, user_embed=4, item_embed=4,
                   hidden_layers=(8,), mf_embed=4)
    ncf.compile(optimizer="adam", loss="class_nll")
    path = str(tmp_path / "ncf.model")
    ncf.save_model(path)
    ids = np.array([[0, 1], [9, 7], [3, 3]], np.int32)
    im = InferenceModel().load(path, example_inputs=[ids])
    assert im.example_input_specs == [((3, 2), np.dtype(np.int32))]
    want = ncf.predict(ids)
    np.testing.assert_array_equal(im.predict(ids), want)
    b = tb.DynamicBatcher(im, max_batch_size=4, max_wait_ms=1)
    try:
        b.start()
        status, payload = tsv.handle_predict(
            im, json.dumps({"inputs": ids.tolist()}).encode(), batcher=b)
    finally:
        b.stop()
    assert status == 200
    _close(np.asarray(payload["outputs"], np.float32), want)
    assert b.warmed_buckets == 3
    with pytest.raises(TypeError, match="Sequential"):
        InferenceModel().load(path, example_inputs=[ids], quantize=True)


def test_many_clients_stress_every_reply_is_its_own(weights):
    # more client threads than cores and a short switch interval: every
    # reply carries its own rows, and the batches' live rows add up to
    # the rows submitted
    import sys
    im = _loaded("port", weights, example_batch=4)
    want_of = {}
    rs = np.random.RandomState(11)
    jobs_ = [rs.randn(int(n), 16).astype(np.float32)
             for n in rs.randint(1, 7, size=96)]
    for i, x in enumerate(jobs_):
        want_of[i] = im.predict(x)
    b = tb.DynamicBatcher(im, max_batch_size=8, max_wait_ms=2,
                          queue_depth=512)
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        b.start()

        def client(c):
            try:
                for i in range(c, len(jobs_), 24):
                    got = b.submit([jobs_[i]]).result(timeout=TIMEOUT)
                    _close(got, want_of[i])
            except Exception as e:      # surfaced by the assert below
                errors.append(e)

        ts = [threading.Thread(target=client, args=(c,)) for c in range(24)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
        b.stop()
    assert not errors, errors[:3]
    snap = tobs.snapshot()
    rows = snap["zoo_tpu_serving_batch_size"]["values"][0]["sum"]
    assert rows == sum(len(x) for x in jobs_) * 2   # predicts + batches
    assert b.stats()["queue_depth"] == 0
