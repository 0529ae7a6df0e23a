"""The port's nnframes against the JAX package's, on the CPU, part one:
``fit`` and ``transform`` of ``NNEstimator`` and ``NNClassifier``
(softmax argmax, one sigmoid output ``> 0.5``) on bridged weights, every
camelCase setter, the weight rules of ``fit`` (a compiled model trains
from its weights with its frozen layers fixed; the model carries the
trained weights; an ``NNModel`` keeps its fit's weights after a later
fit; a model never compiled starts from a fresh init on every fit), and
validation and checkpoint files. Part two,
``test_torch_nnframes_io.py``, holds persistence, ``NNImageReader`` and
the RDD and Spark sources.

Tolerances: trained weights and predictions within 1e-5 of max(1,
max|value|) (f32 sums in another order, over a few Adam steps);
classes, DataFrames of images, file names and chunk sizes exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as jinit
from analytics_zoo_tpu.feature.common import SeqToTensor as JSeqToTensor
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline import nnframes as jnn
from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.feature.common import SeqToTensor
from analytics_zoo_tpu_torch.pipeline import nnframes as tnn
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential

TOL = 1e-5


@pytest.fixture(autouse=True)
def _ctx(monkeypatch):
    monkeypatch.delenv("ZOO_TPU_DTYPE_POLICY", raising=False)
    monkeypatch.setenv("ZOO_TPU_SLO_TICK_S", "0")
    # no FLOP count in each fit's first step: no test here reads it
    monkeypatch.setenv("ZOO_TPU_GOODPUT_FLOPS", "0")
    tzoo.init_nncontext(seed=0, device="cpu")
    jinit(seed=0)
    yield
    tzoo.reset_nncontext()


def _net(lib, seq, outputs, activation=None):
    m = seq()
    m.add(lib.Dense(8, activation="tanh", input_shape=(4,), name="hidden"))
    m.add(lib.Dense(outputs, activation=activation, name="head"))
    return m


def _pair(outputs=1, activation=None, compiled=True, seed=0):
    """The same net in both packages, compiled, with the port's init in
    both; returns ``(port net, JAX net, initial weights)``."""
    t = _net(TL, Sequential, outputs, activation)
    j = _net(JL, JSequential, outputs, activation)
    t.init_params()
    w0 = params_to_numpy(t)
    if compiled:
        t.compile("adam", "mse")
        j.compile("adam", "mse")
        j.estimator._ensure_initialized()
        j.estimator.params = jax.tree_util.tree_map(jnp.asarray, w0)
    return t, j, w0


def _frame(n=32, seed=0, kind="regression"):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 4).astype(np.float32)
    if kind == "regression":
        y = (x @ np.array([1.0, -2.0, 0.5, 3.0], np.float32) + 0.1)
        y = y.astype(np.float64)
    else:
        y = (x.sum(1) > 0).astype(np.int64)
    return pd.DataFrame({"features": list(x), "label": y})


def _near(got, want, tol=TOL, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())),
        err_msg=msg)


def _host(tree):
    return {k: _host(v) if isinstance(v, dict) else np.asarray(
        v.detach().cpu() if hasattr(v, "detach") else v)
        for k, v in tree.items()}


def _close(got, want, tol=TOL):
    g, w = _host(got), jax.device_get(want)
    for k in w:
        for p in w[k]:
            _near(g[k][p], w[k][p], tol, f"{k}/{p}")


# -- fit and transform against the reference ----------------------------------

CASES = {
    # kind: (estimator, criterion, outputs, activation, frame kind)
    "regression": ("NNEstimator", "mse", 1, None, "regression"),
    "softmax": ("NNClassifier", "sparse_categorical_crossentropy", 2,
                "softmax", "classes"),
    "sigmoid": ("NNClassifier", "binary_crossentropy", 1, "sigmoid",
                "classes"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_transform_matches_the_reference(case):
    klass, loss, outputs, act, kind = CASES[case]
    t, j, _ = _pair(outputs, act)
    df = _frame(kind=kind)
    models = []
    for lib, net, pre in ((tnn, t, SeqToTensor((4,))),
                          (jnn, j, JSeqToTensor((4,)))):
        est = (getattr(lib, klass)(net, loss, pre).set_batch_size(8)
               .set_max_epoch(2).set_learning_rate(0.05)
               .set_optim_method("adam"))
        models.append(est.fit(df))
    tm, jm = models
    assert type(tm).__name__ == type(jm).__name__
    _close(tm.params, jm.estimator.params)
    got, want = tm.transform(df), jm.transform(df)
    assert list(got.columns) == list(want.columns)
    if klass == "NNClassifier":
        np.testing.assert_array_equal(got["prediction"].to_numpy(),
                                      want["prediction"].to_numpy())
        assert set(got["prediction"]) <= {0.0, 1.0}
    else:
        _near(np.stack(got["prediction"]), np.stack(want["prediction"]))


SETTERS = [("setFeaturesCol", ("f",)), ("setLabelCol", ("l",)),
           ("setPredictionCol", ("p",)), ("setBatchSize", (8.0,)),
           ("setMaxEpoch", ("3",)), ("setOptimMethod", ("sgd",)),
           ("setLearningRate", ("0.5",)),
           ("setValidation", (None, None, ["accuracy"])),
           ("setCheckpoint", ("ck",)), ("setTensorboard", ("tb", "app")),
           ("setGradientClippingByL2Norm", ("2",)),
           ("setConstantGradientClipping", (-1, 1))]
ATTRS = ["features_col", "label_col", "prediction_col", "batch_size",
         "max_epoch", "optim_method", "learning_rate", "validation_df",
         "validation_trigger", "metrics", "checkpoint_path",
         "checkpoint_trigger", "tensorboard", "clip_l2", "clip_const"]


@pytest.mark.parametrize("setter,args", SETTERS,
                         ids=[s for s, _ in SETTERS])
def test_camelcase_setter_matches_the_reference(setter, args):
    t, j, _ = _pair(compiled=False)
    te, je = tnn.NNEstimator(t, "mse"), jnn.NNEstimator(j, "mse")
    assert getattr(te, setter)(*args) is te
    getattr(je, setter)(*args)
    for a in ATTRS:
        assert getattr(te, a) == getattr(je, a), a
    with pytest.raises(AttributeError):
        te.setNoSuchParam
    tm = tnn.NNModel(t)
    for name, v in (("setFeaturesCol", "f"), ("setPredictionCol", "p"),
                    ("setBatchSize", "4")):
        assert getattr(tm, name)(v) is tm
    assert (tm.features_col, tm.prediction_col, tm.batch_size) == \
        ("f", "p", 4)


# -- the weight rules of fit --------------------------------------------------

def test_compiled_model_trains_from_its_weights_frozen_fixed():
    # (a) and (b): the reference's transfer-learning contract
    t, j, w0 = _pair(2)
    for net in (t, j):
        net.freeze("hidden")
    marked = {k: np.full_like(v, 0.125) for k, v in w0["hidden"].items()}
    t.load_params(dict(w0, hidden=marked))
    j.estimator.params = dict(j.estimator.params, hidden=jax.tree_util.
                              tree_map(jnp.asarray, marked))
    df = _frame(16, kind="classes")
    df["label"] = df["label"].astype(np.float64)
    out = []
    for lib, net, pre in ((tnn, t, SeqToTensor((4,))),
                          (jnn, j, JSeqToTensor((4,)))):
        out.append(lib.NNClassifier(net, "softmax_cross_entropy", pre)
                   .set_batch_size(8).set_max_epoch(2).fit(df))
    tm, jm = out
    for v in params_to_numpy(tm.params)["hidden"].values():
        np.testing.assert_array_equal(v, 0.125)
    _close(tm.params, jm.estimator.params)
    # the model carries the trained weights, in both packages
    _close(t.params(), j.estimator.params)
    _close(tm.params, params_to_numpy(t.params()), tol=0)
    _close(t.params(), params_to_numpy(tm.params), tol=0)
    assert t.estimator.opt_state is None and j.estimator.opt_state is None


def test_nnmodel_keeps_its_fit_weights_after_a_later_fit():
    # (c): each fit's NNModel predicts with that fit's weights. The
    # reference's second fit trains on the first NNModel's arrays and
    # donates them (its transform then raises), so its weights are read
    # before the second fit
    t, j, _ = _pair()
    df = _frame()
    fits = {}
    for key, lib, net, pre in (("port", tnn, t, SeqToTensor((4,))),
                               ("ref", jnn, j, JSeqToTensor((4,)))):
        est = lib.NNEstimator(net, "mse", pre).set_batch_size(8) \
            .set_max_epoch(1).set_optim_method("sgd") \
            .set_learning_rate(0.05)
        first = est.fit(df)
        pred = np.stack(first.transform(df)["prediction"])
        w1 = (params_to_numpy(first.params) if key == "port"
              else jax.device_get(first.estimator.params))
        fits[key] = (first, w1, pred, est.fit(df))
    (t1, tw1, tpred, t2), (_, jw1, jpred, j2) = fits["port"], fits["ref"]
    _close(tw1, jw1)
    _near(tpred, jpred)
    _close(t2.params, j2.estimator.params)
    # the port's first NNModel still holds and predicts with its weights
    _close(t1.params, tw1, tol=0)
    np.testing.assert_array_equal(np.stack(t1.transform(df)["prediction"]),
                                  tpred)
    # the second fit continued from the first, as the reference's
    w2 = params_to_numpy(t2.params)["head"]
    assert not all(np.allclose(w2[k], tw1["head"][k]) for k in w2)


def test_never_compiled_model_starts_fresh_on_every_fit():
    # (d): with a learning rate of 0 each fit's weights are its init
    t, j, _ = _pair(compiled=False)
    df = _frame(16)
    for lib, net, pre in ((tnn, t, SeqToTensor((4,))),
                          (jnn, j, JSeqToTensor((4,)))):
        est = lib.NNEstimator(net, "mse", pre).set_batch_size(8) \
            .set_max_epoch(1).set_optim_method("sgd") \
            .set_learning_rate(0.0)
        a, b = est.fit(df), est.fit(df)
        wa, wb = (params_to_numpy(m.params) if lib is tnn
                  else jax.device_get(m.estimator.params) for m in (a, b))
        ka, kb = (next(np.asarray(v) for v in w["hidden"].values()
                       if np.ndim(v) == 2) for w in (wa, wb))
        # two fresh draws: neither fit started from the other's weights
        assert ka.shape == (4, 8) and not np.array_equal(ka, kb)
        # glorot_uniform's range for a (4, 8) kernel
        assert max(np.abs(ka).max(), np.abs(kb).max()) <= np.sqrt(6 / 12)


def test_validation_and_checkpoint_write_the_reference_files(tmp_path):
    t, j, _ = _pair()
    names = []
    for key, lib, net in (("port", tnn, t), ("ref", jnn, j)):
        est = (lib.NNEstimator(net, "mse").set_batch_size(8)
               .set_max_epoch(2).set_validation(_frame(16, seed=1))
               .set_checkpoint(str(tmp_path / key)))
        est.fit(_frame())
        names.append(sorted(os.listdir(tmp_path / key)))
    assert names[0] == names[1]
    assert any(f.startswith("ckpt_") for f in names[0])
