"""The port's Estimator training surface against the JAX package's, on
the same seeded numpy inputs and bridged weights: every trigger on the
same call sequences; both gradient clippings (one step against the JAX
Estimator); validation in ``fit`` and its history keys; the end
trigger's loss and validation state; TensorBoard event files and tags,
an injected writer; the ``set_profile`` trace; the dtype policy's
resolution; the train loop's traces, spans and gauges; ``KerasNet``'s
pass-throughs, ``unfreeze``, ``get_weights``/``set_weights``,
``copy_weights_from`` and weight files crossing both ways; and
``Convolution2D``'s regularizers.

Tolerances: one step against the JAX Estimator within 1e-5 of max(1,
max|w|) (f32 products in another order); weight files and weight lists
bit for bit; the regularizer's loss within 1e-6 relative.
"""

import os

import jax
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as jinit
from analytics_zoo_tpu.pipeline import estimator as jest
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JS
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.ops import optimizers as jopt
from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.common import observability as tobs
from analytics_zoo_tpu_torch.common import tracing
from analytics_zoo_tpu_torch.ops import optimizers as topt
from analytics_zoo_tpu_torch.pipeline import estimator as test_
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential

TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("ZOO_TPU_DTYPE_POLICY", raising=False)
    tzoo.init_nncontext(seed=0, device="cpu")
    tobs.reset_metrics()
    tracing.reset_tracing()
    yield
    tzoo.reset_nncontext()


def _net(lib, model, classes=3):
    model.add(lib.Dense(8, activation="relu", input_shape=(5,)))
    model.add(lib.Dense(classes))
    return model


def _data(seed=0, n=32, classes=3):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 5).astype(np.float32),
            rs.randint(0, classes, size=(n, 1)).astype(np.int32))


# -- triggers ----------------------------------------------------------------

def _trigger_pairs():
    mk = lambda mod: [
        mod.EveryEpoch(), mod.SeveralIteration(3), mod.MaxEpoch(2),
        mod.MaxIteration(5), mod.MinLoss(0.5), mod.MaxScore(0.7),
        mod.MaxScore(0.2, metric="loss"),
        mod.TriggerAnd(mod.EveryEpoch(), mod.MaxEpoch(2)),
        mod.TriggerOr(mod.SeveralIteration(4), mod.MinLoss(0.1)),
        mod.Trigger.every_epoch(), mod.Trigger.several_iteration(2),
        mod.Trigger.max_epoch(3), mod.Trigger.max_iteration(7),
        mod.Trigger.min_loss(0.3), mod.Trigger.max_score(0.5),
        mod.Trigger.and_(mod.Trigger.max_iteration(2),
                         mod.Trigger.every_epoch()),
        mod.Trigger.or_(mod.Trigger.max_epoch(1),
                        mod.Trigger.max_score(0.9, "acc"))]
    return list(zip(mk(test_), mk(jest)))


CALLS = [(e, i, end, st) for e in range(0, 4) for i in (0, 1, 2, 3, 4, 5, 8)
         for end in (False, True)
         for st in ({}, {"loss": 0.05}, {"loss": 0.4},
                    {"loss": 0.9, "val_metrics": {"acc": 0.95,
                                                  "loss": 0.1}},
                    {"val_metrics": {"acc": 0.3, "loss": 0.8}})]


@pytest.mark.parametrize("k", range(len(_trigger_pairs())))
def test_trigger_matches_the_reference(k):
    port, ref = _trigger_pairs()[k]
    assert type(port).__name__ == type(ref).__name__
    got = [port(e, i, end, **st) for e, i, end, st in CALLS]
    assert got == [ref(e, i, end, **st) for e, i, end, st in CALLS]


def test_end_triggers_stop_fit_as_the_reference():
    x, y = _data()
    m = _net(TL, Sequential())
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    res = m.fit(x, y, batch_size=8, nb_epoch=10,
                end_trigger=test_.MaxIteration(6))
    assert m.estimator.step == 6 and len(res.history) == 2
    # MinLoss at epoch end with the epoch's mean loss
    res = m.fit(x, y, batch_size=8, nb_epoch=10,
                end_trigger=test_.MinLoss(1e9))
    assert len(res.history) == 1
    # MaxScore reads the validation metrics
    res = m.fit(x, y, batch_size=8, nb_epoch=10, validation_data=(x, y),
                end_trigger=test_.MaxScore(0.0, metric="accuracy"))
    assert len(res.history) == 1 and "val_accuracy" in res.history[0]


# -- clipping, one step against the JAX Estimator -----------------------------

@pytest.mark.parametrize("clip", ["l2", "constant"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_clipping_step_matches_the_jax_estimator(clip, opt):
    x, y = _data(1, n=16)
    jinit(seed=0)
    jm = _net(JL, JS())
    jm.compile(optimizer=jopt.SGD(0.5) if opt == "sgd" else jopt.Adam(1e-2),
               loss="sparse_categorical_crossentropy")
    tm = _net(TL, Sequential())
    tm.compile(optimizer=topt.SGD(0.5) if opt == "sgd" else topt.Adam(1e-2),
               loss="sparse_categorical_crossentropy")
    for m in (jm, tm):
        if clip == "l2":
            m.set_gradient_clipping_by_l2_norm(0.05)     # it clips
        else:
            m.set_constant_gradient_clipping(-0.01, 0.02)
    jm.estimator._ensure_initialized()    # its state holds the clip's
    w0 = jax.device_get(jm.estimator.params)
    tm.estimator.params = w0
    for m in (jm, tm):
        m.fit(x, y, batch_size=8, nb_epoch=1, end_trigger=(
            jest if m is jm else test_).MaxIteration(1))
    want = jax.device_get(jm.estimator.params)
    got = params_to_numpy(tm)
    moved = 0.0
    for lyr, sub in want.items():
        for k, v in sub.items():
            np.testing.assert_allclose(
                got[lyr][k], v, rtol=TOL,
                atol=TOL * max(1.0, float(np.abs(v).max())))
            moved = max(moved, float(np.abs(v - w0[lyr][k]).max()))
    assert moved > 0


# -- validation, summaries, profile, traces, policy ---------------------------

def test_validation_history_keys_and_trigger():
    x, y = _data()
    xv, yv = _data(5, n=12)
    m = _net(TL, Sequential())
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    res = m.fit(x, y, batch_size=8, nb_epoch=3, validation_data=(xv, yv),
                validation_trigger=test_.MaxEpoch(2))
    assert ["val_loss" in h for h in res.history] == [False, True, True]
    assert set(res.history[-1]) >= {"epoch", "loss", "losses", "throughput",
                                    "step", "goodput", "val_loss",
                                    "val_accuracy"}
    ev = m.evaluate(xv, yv, batch_size=8)
    assert res.history[-1]["val_loss"] == pytest.approx(ev["loss"])
    assert res.history[-1]["val_accuracy"] == ev["accuracy"]
    # a dataset as validation data
    res = m.fit(x, y, batch_size=8, nb_epoch=1,
                validation_data=test_.ArrayDataset(xv, yv))
    assert res.history[-1]["val_loss"] == pytest.approx(
        m.evaluate(xv, yv, batch_size=8)["loss"])


def _event_tags(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(log_dir, size_guidance={"scalars": 0,
                                                   "histograms": 0})
    acc.Reload()
    tags = acc.Tags()
    return acc, set(tags["scalars"]), set(tags["histograms"])


def test_tensorboard_event_files_and_tags(tmp_path):
    x, y = _data()
    m = _net(TL, Sequential())
    m.compile(optimizer=topt.SGD(lr=topt.step_decay(0.1, 2)),
              loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    m.set_tensorboard(str(tmp_path / "tb"), "app")
    m.set_summary_trigger("Parameters", test_.SeveralIteration(2))
    m.set_summary_trigger("LearningRate", test_.EveryEpoch())
    with pytest.raises(ValueError, match="unsupported summary"):
        m.set_summary_trigger("Gradients", test_.EveryEpoch())
    m.fit(x, y, batch_size=8, nb_epoch=2, validation_data=(x, y))
    assert m.estimator._tb_writer is None          # closed, not leaked
    acc, scalars, hists = _event_tags(str(tmp_path / "tb" / "app"))
    assert scalars == {"Loss", "LearningRate", "Throughput",
                       "Validation/loss", "Validation/accuracy"}
    assert hists == {"Parameters/dense_1/bias", "Parameters/dense_1/kernel",
                     "Parameters/dense_2/bias", "Parameters/dense_2/kernel"}
    assert [e.step for e in acc.Scalars("Loss")] == list(range(1, 9))
    # in step and again at epoch end where the trigger holds there, as
    # the reference fires it
    assert sorted({e.step for e in acc.Histograms(
        "Parameters/dense_1/kernel")}) == [2, 4, 6, 8]
    lr = {e.step: e.value for e in acc.Scalars("LearningRate")}
    assert lr[2] == pytest.approx(0.01) and lr[1] == pytest.approx(0.1)
    assert tobs.snapshot()["zoo_tpu_learning_rate"]["values"][0][
        "value"] == pytest.approx(0.1 * 0.1 ** 4)


def test_an_injected_writer_is_kept(tmp_path):
    class Recording:
        def __init__(self):
            self.tags, self.flushed = [], 0

        def add_scalar(self, tag, v, s):
            self.tags.append((tag, s))

        def add_histogram(self, tag, v, s):
            self.tags.append((tag, s))

        def flush(self):
            self.flushed += 1

    x, y = _data()
    m = _net(TL, Sequential())
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    w = Recording()
    m.estimator.tensorboard_dir = str(tmp_path)
    m.estimator._tb_writer = w
    m.fit(x, y, batch_size=8, nb_epoch=1)
    assert m.estimator._tb_writer is w and w.flushed == 1
    assert [s for t, s in w.tags if t == "Loss"] == [1, 2, 3, 4]


def test_set_profile_writes_a_trace(tmp_path):
    x, y = _data()
    m = _net(TL, Sequential())
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    est = m.estimator
    d = str(tmp_path / "prof")
    est.set_profile(d, start_step=1, n_steps=2)
    m.fit(x, y, batch_size=8, nb_epoch=1)
    assert os.listdir(d) == ["1-3.pt.trace.json"]
    assert est._profiling is False and est._profile_dir is None
    # stopped (and written) on an exception's path too
    est.set_profile(str(tmp_path / "p2"), start_step=1, n_steps=50)

    class Boom(Exception):
        pass

    class Exploding:
        num_samples = 32

        def iter_batches(self, batch_size, shuffle=True, seed=0,
                         drop_last=True):
            yield x[:8], y[:8]
            raise Boom()

    with pytest.raises(Boom):
        est.train(Exploding(), batch_size=8)
    assert est._profiling is False
    assert os.listdir(str(tmp_path / "p2")) == ["5-5.pt.trace.json"]


def test_train_traces_spans_and_gauges():
    x, y = _data()
    m = _net(TL, Sequential())
    m.compile(optimizer=topt.SGD(lr=0.05), loss="sparse_categorical_"
              "crossentropy")
    m.fit(x, y, batch_size=8, nb_epoch=2)
    m.evaluate(x, y, batch_size=8)
    recs = tracing.get_store().records()
    steps = [r for r in recs if r.name == "train/step"]
    assert len(steps) == 8
    assert {"data_wait_s", "dispatch_s", "step", "epoch"} <= set(
        steps[0].fields)
    assert any(r.name == "train/eval_run" for r in recs)
    s = tobs.snapshot()
    assert s["zoo_tpu_train_epoch_seconds"]["values"][0]["count"] == 2
    assert s["zoo_tpu_train_eval_seconds"]["values"][0]["count"] == 1
    for name in ("zoo_tpu_train_first_step_seconds",
                 "zoo_tpu_train_throughput_examples_per_sec"):
        assert s[name]["values"][0]["value"] > 0
    assert s["zoo_tpu_learning_rate"]["values"][0]["value"] == 0.05


def test_trace_sync_annotates_device_time(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_TRACE_SYNC", "1")
    x, y = _data()
    m = _net(TL, Sequential())
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    m.fit(x, y, batch_size=8, nb_epoch=1)
    steps = [r for r in tracing.get_store().records()
             if r.name == "train/step"]
    assert all("device_s" in r.fields for r in steps)


@pytest.mark.parametrize("explicit,env,want", [
    (None, None, "float32"), (None, "mixed_bfloat16", "mixed_bfloat16"),
    ("float32", "mixed_bfloat16", "float32"),
    ("mixed_bfloat16", None, "mixed_bfloat16")])
def test_dtype_policy_resolution(monkeypatch, explicit, env, want):
    if env:
        monkeypatch.setenv("ZOO_TPU_DTYPE_POLICY", env)
    m = _net(TL, Sequential())
    est = test_.Estimator(m, dtype_policy=explicit)
    assert est.dtype_policy == want
    with pytest.raises(ValueError):
        est.set_dtype_policy("float8")
    assert est.set_dtype_policy("float32").dtype_policy == "float32"


# -- KerasNet -----------------------------------------------------------------

def test_kerasnet_pass_throughs_and_unfreeze(tmp_path):
    x, y = _data()
    m = _net(TL, Sequential())
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    est = m.estimator
    assert m.set_checkpoint(str(tmp_path), test_.SeveralIteration(2)) is m
    assert est.checkpoint_path == str(tmp_path)
    assert isinstance(est.checkpoint_trigger, test_.SeveralIteration)
    m.set_tensorboard(str(tmp_path / "tb"), "a")
    assert (est.tensorboard_dir, est.tensorboard_app) == (
        str(tmp_path / "tb"), "a")
    m.set_summary_trigger("LearningRate", test_.EveryEpoch())
    assert "LearningRate" in est._summary_triggers
    m.set_gradient_clipping_by_l2_norm(1.0)
    assert est._clip is not None
    m.set_constant_gradient_clipping(-1, 1)
    m.freeze("dense_1")
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    w0 = m.get_weights()
    m.fit(x, y, batch_size=8, nb_epoch=1)
    w1 = m.get_weights()
    # sorted paths: dense_1/bias, dense_1/kernel, dense_2/bias, /kernel
    assert np.array_equal(w0[0], w1[0]) and np.array_equal(w0[1], w1[1])
    assert not np.array_equal(w0[3], w1[3])
    m.unfreeze()
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    m.fit(x, y, batch_size=8, nb_epoch=1)
    assert not np.array_equal(m.get_weights()[1], w1[1])


def test_weights_cross_between_the_packages(tmp_path):
    jinit(seed=0)
    jm = _net(JL, JS())
    jm.compile(optimizer="sgd", loss="mse")
    tm = _net(TL, Sequential())
    tm.compile(optimizer="sgd", loss="mse")
    # the same sorted-path order: the JAX list loads into the port
    jw = jm.get_weights()
    tm.set_weights(jw)
    for a, b in zip(tm.get_weights(), jw):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        tm.set_weights(jw[:-1])
    # weight files both ways
    jm.save_weights(str(tmp_path / "j.npz"))
    tm2 = _net(TL, Sequential())
    tm2.compile(optimizer="sgd", loss="mse")
    tm2.load_weights(str(tmp_path / "j.npz"))
    for a, b in zip(tm2.get_weights(), jw):
        assert np.array_equal(a, b)
    tm.set_weights([w + 1.0 for w in jw])
    tm.save_weights(str(tmp_path / "t.npz"))
    jm.load_weights(str(tmp_path / "t.npz"))
    for a, b in zip(jm.get_weights(), tm.get_weights()):
        assert np.array_equal(a, b)
    other = Sequential()
    other.add(TL.Dense(4, input_shape=(5,)))
    other.compile(optimizer="sgd", loss="mse")
    with pytest.raises(ValueError, match="shape mismatch"):
        other.load_weights(str(tmp_path / "t.npz"))


def test_copy_weights_from_by_layer_name():
    a = _net(TL, Sequential())
    a.compile(optimizer="sgd", loss="mse")
    b = Sequential()
    b.add(TL.Dense(8, activation="relu", input_shape=(5,)))
    b.add(TL.Dense(4))               # another head: skipped
    b.compile(optimizer="sgd", loss="mse")
    wa, wb = a.get_weights(), b.get_weights()
    b.copy_weights_from(a)
    got = b.get_weights()
    assert np.array_equal(got[0], wa[0]) and np.array_equal(got[1], wa[1])
    assert np.array_equal(got[2], wb[2]) and np.array_equal(got[3], wb[3])
    with pytest.raises(ValueError, match="incompatible"):
        b.copy_weights_from(a, strict=True)


# -- Convolution2D's regularizers ---------------------------------------------

def test_convolution2d_regularizers_match_the_reference():
    from analytics_zoo_tpu_torch.ops import regularizers as treg
    from analytics_zoo_tpu.ops import regularizers as jreg
    rs = np.random.RandomState(6)
    mk = lambda lib, reg: lib.Convolution2D(
        4, 3, 3, w_regularizer=reg.l2(0.01), b_regularizer=reg.l1(0.02),
        input_shape=(6, 6, 2))
    jl, tl = mk(JL, jreg), mk(TL, treg)
    params = {"kernel": rs.randn(3, 3, 2, 4).astype(np.float32),
              "bias": rs.randn(4).astype(np.float32)}
    tl.init(torch.Generator().manual_seed(0))
    tl.set_params({k: torch.from_numpy(v) for k, v in params.items()})
    assert [k for k, _ in tl.regularizers()] == \
        [k for k, _ in jl.regularizers()] == ["kernel", "bias"]
    got = float(tl.regularization_loss(tl.params()))
    want = float(jl.regularization_loss(
        jax.tree_util.tree_map(np.asarray, params)))
    assert got == pytest.approx(want, rel=1e-6)
