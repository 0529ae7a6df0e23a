"""Multi-output models through the PyTorch port's Estimator against the
JAX package's, on the same numpy weights and data: two SGD steps with
one loss and with a list of losses, evaluate and predict, the Keras
``compile``/``fit`` surface, the mismatch errors, and the label rule
(``feature.normalize_labels``) both packages read labels by.

Tolerance 1e-5 of max(1, max|ref|) throughout: two f32 Dense heads on
one input, the same products and sums in another order.
"""

import jax
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.feature import feature_set as jfs
from analytics_zoo_tpu.ops import optimizers as jopt
from analytics_zoo_tpu.pipeline import estimator as jest_mod
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.api.keras import models as jmodels
from analytics_zoo_tpu.pipeline.api.keras.engine import Input as JInput
from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.feature import feature_set as tfs
from analytics_zoo_tpu_torch.ops import optimizers as topt
from analytics_zoo_tpu_torch.pipeline import estimator as test_mod
from analytics_zoo_tpu_torch.pipeline.api.keras import Input, Model
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL

TOL = 1e-5
B = 8


@pytest.fixture(autouse=True)
def _cpu():
    from analytics_zoo_tpu import init_nncontext
    init_nncontext(tpu_mesh={"data": 1}, devices=jax.devices("cpu")[:1])
    tzoo.init_nncontext(seed=0, device="cpu")
    yield
    tzoo.reset_nncontext()


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _tree_close(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k, v in want.items():
        if isinstance(v, dict):
            _tree_close(got[k], v, f"{path}/{k}")
        else:
            _close(got[k], v, f"{path}/{k}")


def _two_heads(L, inp):
    h = L.Dense(6, activation="tanh")(inp)
    return [L.Dense(2)(h), L.Dense(3)(h)]


def _models():
    jin, tin = JInput((4,)), Input((4,))
    jm = jmodels.Model(jin, _two_heads(JL, jin))
    tm = Model(tin, _two_heads(TL, tin))
    p = jax.device_get(jm.init_params(jax.random.key(0)))
    tm.load_params(p, device="cpu")
    return jm, tm, p


def _data(n=2 * B, seed=3):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 4).astype(np.float32),
            [rs.randn(n, 2).astype(np.float32),
             rs.randn(n, 3).astype(np.float32)])


def _estimators(loss):
    jm, tm, p = _models()
    jest = jest_mod.Estimator(jm, optimizer=jopt.SGD(lr=0.1), loss=loss)
    jest.params = jax.device_put(p)
    test = test_mod.Estimator(tm, optimizer=topt.SGD(lr=0.1), loss=loss)
    return jest, test, tm


@pytest.mark.parametrize("loss", ["mse", ["mse", "mae"]])
def test_two_sgd_steps_match_jax(loss):
    jest, test, tm = _estimators(loss)
    x, ys = _data()
    for i in range(2):                   # one step per call
        sl = slice(i * B, (i + 1) * B)
        jh = jest.train(x[sl], [y[sl] for y in ys], batch_size=B)
        th = test.train(x[sl], [y[sl] for y in ys], batch_size=B)
        _close(th.history[-1]["loss"], jh.history[-1]["loss"],
               f"step {i} loss")
    assert test.step == jest.step == 2
    _tree_close(params_to_numpy(tm), jax.device_get(jest.params))


@pytest.mark.parametrize("loss", ["mse", ["mse", "mae"]])
def test_evaluate_and_predict_match_jax(loss):
    jest, test, _ = _estimators(loss)
    x, ys = _data(n=13, seed=4)          # a tail batch of 3
    got = test.evaluate(x, ys, batch_size=5)
    want = jest.evaluate(x, ys, batch_size=5)
    _close(got["loss"], want["loss"], "loss")
    tp, jp = test.predict(x, batch_size=5), jest.predict(x, batch_size=5)
    assert isinstance(tp, list) and len(tp) == len(jp) == 2
    for a, b_ in zip(tp, jp):
        _close(a, b_, "predict")


def test_keras_surface_trains_multi_output_like_jax():
    # compile/fit/evaluate/predict on Model route to the same functions
    jm, tm, p = _models()
    jm.compile(optimizer=jopt.SGD(lr=0.1), loss=["mse", "mae"])
    tm.compile(optimizer=topt.SGD(lr=0.1), loss=["mse", "mae"])
    assert isinstance(tm.estimator.loss_fn, list)
    jm.estimator.params = jax.device_put(p)
    x, ys = _data()
    jh = jm.fit(x, ys, batch_size=B, nb_epoch=2).history
    th = tm.fit(x, ys, batch_size=B, nb_epoch=2).history
    _close([h["loss"] for h in th], [h["loss"] for h in jh], "fit losses")
    _tree_close(params_to_numpy(tm), jax.device_get(jm.estimator.params))
    _close(tm.evaluate(x, ys, batch_size=B)["loss"],
           jm.evaluate(x, ys, batch_size=B)["loss"], "evaluate")
    got, want = tm.predict(x, batch_size=B), jm.predict(x, batch_size=B)
    assert isinstance(got, list) and len(got) == 2
    for a, b_ in zip(got, want):
        _close(a, b_, "predict")


@pytest.mark.parametrize("loss,labels,match", [
    (["mse", "mse", "mse"], 2, "3 losses"),       # one loss too many
    ("mse", 3, "3 label columns"),                # a label column too many
    (["mse", "mae"], 1, "list of 2 losses"),      # one label array
])
def test_mismatches_raise_like_jax(loss, labels, match):
    x, ys = _data()
    rs = np.random.RandomState(5)
    y = (ys + [rs.randn(len(x), 1).astype(np.float32)])[:labels] \
        if labels > 1 else ys[0]
    jest, test, _ = _estimators(loss)
    with pytest.raises(ValueError, match=match) as jerr:
        jest.train(x, y, batch_size=B)
    with pytest.raises(ValueError, match=match) as terr:
        test.train(x, y, batch_size=B)
    # the same words; the type names in brackets are each framework's
    assert str(terr.value).split(" (")[0] == str(jerr.value).split(" (")[0]


def test_a_loss_list_needs_a_multi_output_model():
    # a single-output model given a list of losses, and rank_hinge inside
    # a list, are refused as the reference refuses them
    x, ys = _data()
    tin = Input((4,))
    tm = Model(tin, TL.Dense(2)(tin))
    tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    est = test_mod.Estimator(tm, optimizer="sgd", loss=["mse"])
    for y in ([ys[0]], ys[0]):
        with pytest.raises(ValueError, match="needs a multi-output model"):
            est.train(x, y, batch_size=B)
    for mod in (test_mod, jest_mod):
        with pytest.raises(ValueError, match="rank_hinge"):
            mod.Estimator(tm, loss=["mse", "rank_hinge"])


def test_metrics_are_refused_with_multi_output_models():
    _, tm, _ = _models()
    est = test_mod.Estimator(tm, optimizer="sgd", loss="mse",
                             metrics=["accuracy"])
    x, ys = _data()
    with pytest.raises(ValueError, match="multi-output"):
        est.evaluate(x, ys, batch_size=B)


def test_array_dataset_yields_one_label_batch_per_column():
    x, ys = _data(n=11)
    jb = list(jest_mod.ArrayDataset(x, ys).iter_batches(4, seed=2))
    tb = list(test_mod.ArrayDataset(x, ys).iter_batches(4, seed=2))
    assert len(tb) == len(jb) == 2
    for (jx, jy), (tx, ty) in zip(jb, tb):
        np.testing.assert_array_equal(tx, jx)
        assert isinstance(ty, list) and len(ty) == 2
        for a, b_ in zip(ty, jy):
            np.testing.assert_array_equal(a, b_)
    with pytest.raises(ValueError, match="sample counts"):
        test_mod.ArrayDataset(x, [ys[0], ys[1][:5]])


@pytest.mark.parametrize("labels,multi,shapes", [
    ([0, 1, 0, 1], False, [(4,)]),                  # per-sample scalars
    ([[0.5], [1.5], [2.5]], False, [(3, 1)]),       # per-sample rows
    ([np.zeros((3, 2)), np.ones((3, 1))], True, [(3, 2), (3, 1)]),
    (np.zeros((5, 2)), False, [(5, 2)]),            # one array
    (None, False, []),                              # unlabeled
])
def test_normalize_labels_matches_jax(labels, multi, shapes):
    for fn in (tfs.normalize_labels, jfs.normalize_labels):
        cols, is_multi = fn(labels)
        assert is_multi is multi
        assert [c.shape for c in cols] == shapes
    for got, want in zip(tfs.normalize_labels(labels)[0],
                         jfs.normalize_labels(labels)[0]):
        np.testing.assert_array_equal(got, want)


def test_normalize_labels_refuses_an_empty_list():
    for fn in (tfs.normalize_labels, jfs.normalize_labels):
        with pytest.raises(ValueError, match="empty label list"):
            fn([])


def test_rank_hinge_evaluates_over_pairs_like_jax():
    # the pairwise loss stays a single-output loss: its evaluate is the
    # mean over (positive, negative) row pairs, as in the reference
    jin, tin = JInput((4,)), Input((4,))
    jm, tm = jmodels.Model(jin, JL.Dense(1)(jin)), Model(tin, TL.Dense(1)(tin))
    p = jax.device_get(jm.init_params(jax.random.key(1)))
    tm.load_params(p, device="cpu")
    jest = jest_mod.Estimator(jm, optimizer=jopt.SGD(lr=0.1),
                              loss="rank_hinge")
    jest.params = jax.device_put(p)
    test = test_mod.Estimator(tm, optimizer=topt.SGD(lr=0.1),
                              loss="rank_hinge")
    x, _ = _data(n=12, seed=6)
    y = np.zeros((12, 1), np.float32)
    _close(test.evaluate(x, y, batch_size=4)["loss"],
           jest.evaluate(x, y, batch_size=4)["loss"], "evaluate")
    _close(test.train(x, y, batch_size=4).history[-1]["loss"],
           jest.train(x, y, batch_size=4).history[-1]["loss"], "train")
