"""Transfer-learning surgery of the port against the JAX package:
``Model.new_graph`` and ``Model.freeze_up_to`` freeze the same layers;
fine-tuning a new head with ``fit`` leaves every frozen trainable leaf
bit for bit as it was, moves the frozen BatchNorms' moving statistics as
the reference does (its ``apply`` returns their updates whatever
``trainable`` says, and its Estimator folds them in), and updates the
head as the reference does, on bridged weights (f32 within 1e-5). Also
the LeNet-5 and transfer-learning examples with ``--device cpu``."""

import jax
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as j_init
from analytics_zoo_tpu.models.image.imageclassification import archs as jarchs
from analytics_zoo_tpu.ops.optimizers import SGD as JSGD
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.api.keras import models as jmodels
from analytics_zoo_tpu.pipeline.api.keras.engine import Input as JInput
from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.examples import lenet_mnist, transfer_learning
from analytics_zoo_tpu_torch.models.image.imageclassification import \
    archs as tarchs
from analytics_zoo_tpu_torch.ops.optimizers import SGD as TSGD
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras import models as tmodels
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input as TInput

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    j_init(tpu_mesh={"data": 1}, devices=jax.devices("cpu")[:1])
    yield
    tzoo.reset_nncontext()


def _frozen(model):
    return sorted(lyr.name for lyr in model.layers if not lyr.trainable)


@pytest.mark.parametrize("node", ["globalaveragepooling2d_1",
                                  "concatenate_3", "stem2_bn"])
def test_new_graph_and_freeze_up_to_freeze_the_reference_layers(node):
    jm = jarchs.inception_v1(input_shape=(32, 32, 3), classes=7)
    tm = tarchs.inception_v1(input_shape=(32, 32, 3), classes=7)
    jt, tt = jm.new_graph([node]), tm.new_graph([node])
    assert sorted(tt.graph_layers) == sorted(lyr.name for lyr in jt.layers)
    assert [v.name for v in tt.outputs] == [node]
    assert tt.outputs[0].shape == jt.outputs[0].shape
    jt.freeze_up_to(node)
    tt.freeze_up_to(node)
    assert _frozen(tt) == _frozen(jt) and _frozen(tt)
    # the layers are shared with the full graph: its later layers train
    assert _frozen(tm) == _frozen(jm)
    assert tm.graph_layers["fc"].trainable
    with pytest.raises(ValueError, match="no graph nodes"):
        tt.new_graph(["nope"])
    with pytest.raises(ValueError, match="no graph nodes"):
        tt.freeze_up_to("nope")


def _backbone(L, Inp, M):
    inp = Inp((8, 8, 3), name="image")
    x = L.Convolution2D(6, 3, 3, border_mode="same", bias=False,
                        name="conv1")(inp)
    x = L.BatchNormalization(name="conv1_bn")(x)
    x = L.Activation("relu")(x)
    x = L.MaxPooling2D(name="pool1")(x)
    x = L.Convolution2D(8, 3, 3, border_mode="same", name="conv2")(x)
    x = L.BatchNormalization(name="conv2_bn")(x)
    feat = L.GlobalAveragePooling2D(name="features")(x)
    out = L.Dense(10, activation="softmax", name="old_head")(feat)
    return M.Model(inp, out, name="backbone")


def _tuned(L, M, backbone, sgd):
    trunk = backbone.new_graph(["features"])
    trunk.freeze_up_to("features")
    head = L.Dense(2, activation="softmax", name="cats_dogs")(
        trunk.outputs[0])
    tuned = M.Model(trunk.inputs, head, name="tuned")
    tuned.compile(optimizer=sgd(lr=0.1, momentum=0.9),
                  loss="sparse_categorical_crossentropy")
    tuned.copy_weights_from(backbone)
    return tuned


def _strip_state(tree):
    return {k: _strip_state(v) if isinstance(v, dict) else v
            for k, v in tree.items() if k != "_state"}


def test_fine_tune_keeps_frozen_leaves_moves_bn_state_and_head():
    jb = _backbone(JL, JInput, jmodels)
    tb = _backbone(TL, TInput, tmodels)
    jb.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    tb.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    jb.estimator._ensure_initialized()
    rs = np.random.RandomState(0)
    pb = jax.device_get(jb.estimator.params)
    # distinctive moving statistics, so their update is visible
    for bn in ("conv1_bn", "conv2_bn"):
        n = pb[bn]["gamma"].shape[0]
        pb[bn]["_state"] = {"moving_mean": rs.randn(n).astype(np.float32),
                            "moving_var": rs.rand(n).astype(np.float32) + .5}
    jb.estimator.params = pb
    tb.estimator.params = pb

    jt = _tuned(JL, jmodels, jb, JSGD)
    tt = _tuned(TL, tmodels, tb, TSGD)
    # the port's tuned net shares the backbone's layers: its first build
    # kept their weights, as the reference's copy does
    assert sorted(tt.graph_layers) == sorted(lyr.name for lyr in jt.layers)
    before = jax.device_get(jt.estimator.params)
    assert np.array_equal(before["conv1"]["kernel"], pb["conv1"]["kernel"])
    np.testing.assert_array_equal(
        params_to_numpy(tt)["conv1"]["kernel"], pb["conv1"]["kernel"])
    tt.estimator.params = before          # the JAX head's initial weights

    x = rs.rand(32, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 2, (32, 1)).astype(np.int32)
    jh = jt.fit(x, y, batch_size=8, nb_epoch=2).history
    th = tt.fit(x, y, batch_size=8, nb_epoch=2).history
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=TOL)
    assert np.isfinite([h["loss"] for h in th]).all()
    after_j = jax.device_get(jt.estimator.params)
    after_t = params_to_numpy(tt)
    frozen = [n for n in _frozen(tt) if _strip_state(before.get(n, {}))]
    assert sorted(frozen) == ["conv1", "conv1_bn", "conv2", "conv2_bn"]
    for name in frozen:   # every frozen trainable leaf, bit for bit
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               _strip_state(after_t[name]),
                               _strip_state(before[name]))
    for bn in ("conv1_bn", "conv2_bn"):   # the moving statistics moved
        for k, v in after_j[bn]["_state"].items():
            assert not np.allclose(v, before[bn]["_state"][k])
            np.testing.assert_allclose(after_t[bn]["_state"][k], v,
                                       rtol=TOL, atol=TOL)
    for k, v in after_j["cats_dogs"].items():     # the head moved alike
        assert not np.allclose(v, before["cats_dogs"][k])
        np.testing.assert_allclose(after_t["cats_dogs"][k], v, rtol=TOL,
                                   atol=TOL)


def test_first_build_keeps_shared_layers_and_a_rebuild_draws_anew():
    tb = _backbone(TL, TInput, tmodels)
    tb.init_params(torch.Generator().manual_seed(0), device="cpu")
    k0 = params_to_numpy(tb)["conv1"]["kernel"]
    trunk = tb.new_graph(["features"])
    trunk.init_params(torch.Generator().manual_seed(1), device="cpu")
    np.testing.assert_array_equal(params_to_numpy(trunk)["conv1"]["kernel"],
                                  k0)
    trunk.init_params(torch.Generator().manual_seed(1), device="cpu")
    assert not np.array_equal(params_to_numpy(trunk)["conv1"]["kernel"], k0)


def test_examples_run_on_the_cpu(capsys):
    m = lenet_mnist.main(["--device", "cpu", "--n-train", "64",
                          "--n-test", "32", "--epochs", "1"])
    assert set(m) >= {"loss", "accuracy"} and np.isfinite(m["loss"])
    tzoo.reset_nncontext()
    m = transfer_learning.main(["--device", "cpu", "--n", "64",
                                "--image-size", "16", "--epochs", "1"])
    assert np.isfinite(m["loss"]) and 0.0 <= m["accuracy"] <= 1.0
    out = capsys.readouterr().out
    assert "test metrics" in out and "frozen-backbone fine-tune" in out
