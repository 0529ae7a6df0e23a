"""The port's input pipeline and multi-tensor optimizer updates on the
CPU: the reference's ``TestPrefetch`` cases (tests/test_training.py)
against the port's Estimator, datasets that only give batches, the
placement's casts (the inputs', not the labels'), and the foreach SGD
and Adam against their per-leaf formulas.

The card's half (the pinned ring and the copy stream against the
synchronous copy) is in tests/test_torch_kernels_cuda.py.
Tolerances: prefetched and synchronous runs are the same arithmetic,
held equal; the optimizers within 2e-7 of max(1, max|ref|) (f32: a
multiply and add fused or not).
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.ops import optimizers as topt
from analytics_zoo_tpu_torch.pipeline import estimator as est_mod
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    tobs.reset_metrics()
    yield
    tzoo.reset_nncontext()


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "zoo-tpu-prefetch" and t.is_alive()]


class TestPrefetch:
    def _fit(self, monkeypatch, depth):
        tzoo.init_nncontext(seed=0, device="cpu")   # same init weights
        monkeypatch.setenv("ZOO_TPU_PREFETCH", str(depth))
        rng = np.random.RandomState(7)
        x = rng.rand(48, 6).astype(np.float32)
        y = rng.randint(0, 3, size=(48, 1))
        m = Sequential()
        m.add(L.Dense(16, input_shape=(6,), activation="relu"))
        m.add(L.Dense(3, activation="softmax"))
        est = est_mod.Estimator(m, optimizer="sgd",
                                loss="sparse_categorical_crossentropy")
        res = est.train(x, y, batch_size=16, nb_epoch=2)
        ev = est.evaluate(x, y, batch_size=16)
        pred = est.predict(x[:20], batch_size=16)
        return [h["losses"] for h in res.history], ev["loss"], pred

    def test_prefetch_matches_sync(self, monkeypatch):
        l0, e0, p0 = self._fit(monkeypatch, 0)
        l3, e3, p3 = self._fit(monkeypatch, 3)
        assert l0 == l3 and e0 == e3
        np.testing.assert_array_equal(p0, p3)
        assert p0.shape == (20, 3)
        # each step's wait for its batch is observed
        snap = tobs.snapshot()["zoo_tpu_train_data_wait_seconds"]
        assert snap["values"][0]["count"] == 2 * 2 * 3
        assert not _prefetch_threads()

    def test_worker_exception_propagates(self):
        def gen():
            yield 1
            raise RuntimeError("augment failed")

        it = est_mod._prefetch_iter(gen(), lambda v: v * 2, depth=2)
        assert next(it) == 2
        with pytest.raises(RuntimeError, match="augment failed"):
            list(it)

    def test_early_break_stops_worker(self):
        produced = []

        def gen():
            for i in range(1000):
                produced.append(i)
                yield i

        it = est_mod._prefetch_iter(gen(), lambda v: v, depth=2)
        for v in it:
            if v >= 3:
                break
        it.close()   # GeneratorExit: the stop event drains the worker
        deadline = time.time() + 5
        while time.time() < deadline and _prefetch_threads():
            time.sleep(0.05)
        assert not _prefetch_threads()
        assert len(produced) < 1000   # it did not run the iterator dry

    def test_train_stops_the_worker_on_an_end_trigger(self, monkeypatch):
        # Estimator.train closes its batches in a finally: a mid-epoch
        # stop leaves no worker behind
        monkeypatch.setenv("ZOO_TPU_PREFETCH", "2")
        m = Sequential([L.Dense(2, input_shape=(3,))])
        est = est_mod.Estimator(m, optimizer="sgd", loss="mse")
        res = est.train(np.ones((64, 3), np.float32),
                        np.zeros((64, 2), np.float32), batch_size=2,
                        end_trigger=est_mod.MaxIteration(2))
        assert res.step == 2
        deadline = time.time() + 5
        while time.time() < deadline and _prefetch_threads():
            time.sleep(0.05)
        assert not _prefetch_threads()

    def test_bad_env_value_falls_back(self, monkeypatch, caplog):
        monkeypatch.setenv("ZOO_TPU_PREFETCH", "off")
        with caplog.at_level(logging.WARNING,
                             logger="analytics_zoo_tpu_torch"):
            assert est_mod._prefetch_depth() == 2
        assert "ZOO_TPU_PREFETCH" in caplog.text
        monkeypatch.delenv("ZOO_TPU_PREFETCH")
        assert est_mod._prefetch_depth() == 2
        monkeypatch.setenv("ZOO_TPU_PREFETCH", "-1")
        assert est_mod._prefetch_depth() == -1


class _Batches:
    """A dataset of another kind: only ``iter_batches``, over the same
    batches an ArrayDataset of its arrays gives."""

    def __init__(self, x, y):
        self.arrays = est_mod.ArrayDataset(x, y)

    def iter_batches(self, batch_size, shuffle=True, seed=0,
                     drop_last=True):
        return self.arrays.iter_batches(batch_size, shuffle, seed,
                                        drop_last)


@pytest.mark.parametrize("depth", [0, 3])
def test_a_dataset_of_batches_trains_as_its_arrays(monkeypatch, depth):
    # a dataset with iter_batches alone goes through the same placement,
    # each batch as a dataset of its own: the same losses, evaluation
    # and predictions as the arrays themselves
    monkeypatch.setenv("ZOO_TPU_PREFETCH", str(depth))
    rng = np.random.RandomState(5)
    x = rng.rand(40, 6)        # f64: comes in as f32 either way
    y = rng.rand(40, 3).astype(np.float32)
    runs = []
    for data in (x, _Batches(x, y)):
        tzoo.init_nncontext(seed=0, device="cpu")
        m = Sequential([L.Dense(3, input_shape=(6,))])
        est = est_mod.Estimator(m, optimizer="sgd", loss="mse")
        yy = y if isinstance(data, np.ndarray) else None
        res = est.train(data, yy, batch_size=8, nb_epoch=2)
        runs.append(([h["losses"] for h in res.history],
                     est.evaluate(data, yy, batch_size=16)["loss"]))
    assert runs[0] == runs[1]
    assert len(runs[0][0][0]) == 5


@pytest.mark.parametrize("labels", ["float32", "float64", "int32",
                                    "columns"])
def test_placement_casts_the_inputs_and_not_the_labels(labels):
    # under mixed_bfloat16 the inputs arrive in bf16 and the labels as
    # the synchronous copy gives them (regression targets, one-hot
    # rows, per-output columns keep f32; f64 comes in as f32)
    rs = np.random.RandomState(2)
    x = rs.randn(12, 5)
    y = {"float32": rs.randn(12, 3).astype(np.float32),
         "float64": rs.randn(12, 1),
         "int32": rs.randint(0, 4, size=(12, 1)).astype(np.int32),
         "columns": [rs.randn(12, 2).astype(np.float32),
                     rs.randint(0, 2, size=(12,))]}[labels]
    ds = est_mod.ArrayDataset(x, y)
    xs, ys = ds.tensors()
    assert ds.tensors() is ds.tensors()   # made once
    assert xs[0].dtype == torch.float32
    assert [t.dtype for t in ys] == [
        torch.float32 if t.is_floating_point() else t.dtype
        for t in ys]
    place = est_mod._HostPlacer(torch.device("cpu"), torch.bfloat16)
    sel = np.array([3, 0, 7, 7, 11])
    xb, yb = place.take(place((ds, sel)))
    want_x, want_y = ds.gather(sel)
    assert xb.dtype == torch.bfloat16
    assert torch.equal(xb, torch.from_numpy(want_x).float().to(
        torch.bfloat16))
    for got, want in zip(est_mod._flat(yb), est_mod._flat(want_y)):
        want = est_mod._to_device(want, torch.device("cpu"))
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert isinstance(yb, list) == (labels == "columns")


# -- the foreach optimizers -------------------------------------------------

def _per_leaf_sgd(opt, leaves, grads, trace, lr):
    for i, (p, g) in enumerate(zip(leaves, grads)):
        if opt.weight_decay:
            g = g + opt.weight_decay * p
        if opt.momentum:
            tr = trace[i]
            tr.mul_(opt.momentum).add_(g)
            g = g + opt.momentum * tr if opt.nesterov else tr
        p.sub_(lr * g)


def _per_leaf_adam(opt, leaves, grads, mu, nu, lr, t):
    b1, b2 = opt.beta_1, opt.beta_2
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    for p, g, m, v in zip(leaves, grads, mu, nu):
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).add_(g * g, alpha=1.0 - b2)
        step = (m / c1) / (torch.sqrt(v / c2) + opt.epsilon)
        if opt.weight_decay:
            step = step + opt.weight_decay * p
        p.sub_(lr * step)


def _mixed_tree(rs, n=7):
    shapes = [(), (5,), (3, 4), (1, 1, 16, 8), (2, 3, 3, 4), (64,),
              (7, 1)][:n]
    return [torch.from_numpy(np.asarray(rs.randn(*s), np.float32))
            for s in shapes]


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(lr=0.1)),
    ("sgd", dict(lr=0.1, momentum=0.9)),
    ("sgd", dict(lr=0.05, momentum=0.9, nesterov=True, weight_decay=1e-2)),
    ("sgd", dict(lr=lambda step: 0.1 / (1 + step), momentum=0.5,
                 weight_decay=1e-3)),
    ("adam", dict(lr=1e-2)),
    ("adam", dict(lr=1e-2, beta_1=0.8, weight_decay=1e-2))])
def test_foreach_updates_match_the_per_leaf_formulas(name, kw):
    rs = np.random.RandomState(3)
    leaves = _mixed_tree(rs)
    ref = [p.clone() for p in leaves]
    opt = (topt.SGD if name == "sgd" else topt.Adam)(**kw)
    state = opt.init(leaves)
    ref_state = {k: [v.clone() for v in vals] if isinstance(vals, list)
                 else vals for k, vals in opt.init(ref).items()}
    for step in range(4):
        grads = [torch.from_numpy(np.asarray(rs.randn(*p.shape), np.float32))
                 for p in leaves]
        lr = opt.lr_at(step)
        opt.update(leaves, grads, state)
        if name == "sgd":
            _per_leaf_sgd(opt, ref, grads, ref_state.get("trace"), lr)
        else:
            _per_leaf_adam(opt, ref, grads, ref_state["mu"],
                           ref_state["nu"], lr, step + 1)
    assert state["count"] == 4
    for key in ("trace", "mu", "nu"):
        for a, b in zip(state.get(key, []), ref_state.get(key, [])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-7,
                                       atol=2e-7 * max(1.0, float(
                                           b.abs().max())))
    for a, b in zip(leaves, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-7,
                                   atol=2e-7 * max(1.0, float(b.abs().max())))


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("opt", [
    topt.SGD(lr=0.1, momentum=0.9, nesterov=True, weight_decay=1e-4),
    topt.Adam(lr=1e-3, weight_decay=1e-2)])
def test_optimizer_ops_per_step_do_not_grow_with_the_leaves(opt):
    # a step dispatches the same ops for 3 leaves as for 60: one
    # multi-tensor call walks them all (on the card, a few launches each)
    counts = []
    for n in (3, 60):
        leaves = [torch.zeros(4) for _ in range(n)]
        state = opt.init(leaves)
        grads = [torch.ones(4) for _ in range(n)]
        with _OpCount() as mode:
            opt.update(leaves, grads, state)
        counts.append(mode.n)
    assert counts[0] == counts[1] and counts[0] < 15
