"""The PyTorch port's layers, initializers and graph engine against the
JAX package's, on the same numpy inputs and params.

Each port layer's ``call`` takes the numpy params its JAX counterpart
built (bridged as a copy). f32 tolerance 1e-5 (the golden bound of
tests/test_layers_golden.py) for elementwise layers, 1e-4 where a sum
runs in another order (conv, Dense, mean).
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu_torch.bridge import params_from_numpy
from analytics_zoo_tpu_torch.ops import activations, initializers
from analytics_zoo_tpu_torch.pipeline.api.keras import (
    Input, Model, Sequential)
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def _run_both(jlyr, tlyr, x, shape, params=None):
    """Build the JAX layer, hand its numpy params to the port layer, run
    both on ``x``; returns (jax out, port out, numpy params)."""
    p = jax.device_get(jlyr.init(jax.random.key(0), shape))
    if params is not None:
        p = params(p)
    want = np.asarray(jlyr.call(p, x))
    got = tlyr.call(params_from_numpy(p), torch.from_numpy(x)).numpy()
    return want, got, p


@pytest.mark.parametrize("border", ["same", "valid"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("extent", [8, 9])
@pytest.mark.parametrize("ksize", [3, 7])
def test_convolution2d_matches_jax(border, stride, extent, ksize):
    rs = np.random.RandomState(0)
    shape = (extent, extent, 3)
    x = rs.randn(2, *shape).astype(np.float32)
    kw = dict(border_mode=border, subsample=stride, bias=True)
    want, got, _ = _run_both(JL.Convolution2D(4, ksize, ksize, **kw),
                             TL.Convolution2D(4, ksize, ksize, **kw),
                             x, shape,
                             lambda p: dict(p, bias=rs.randn(4).astype(
                                 np.float32)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    lyr = TL.Convolution2D(4, ksize, ksize, **kw)
    assert lyr.compute_output_shape(shape) == want.shape[1:]


def test_batchnorm_eval_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 5, 5, 16).astype(np.float32)

    def stats(p):
        p["gamma"] = (rs.rand(16) + 0.5).astype(np.float32)
        p["beta"] = rs.randn(16).astype(np.float32)
        p["_state"] = {"moving_mean": rs.randn(16).astype(np.float32),
                       "moving_var": (rs.rand(16) + 0.1).astype(
                           np.float32)}
        return p
    want, got, _ = _run_both(JL.BatchNormalization(),
                             TL.BatchNormalization(), x, (5, 5, 16), stats)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_batchnorm_training_not_ported():
    # training is ported now: batch statistics shifted by the moving
    # mean, the moving-average update through apply's second result,
    # and gradients, all against the JAX layer on the same inputs
    rs = np.random.RandomState(9)
    x = (rs.randn(6, 3, 3, 8) * 2 + 1).astype(np.float32)
    c = rs.randn(6, 3, 3, 8).astype(np.float32)
    jl = JL.BatchNormalization()
    p = jax.device_get(jl.init(jax.random.key(0), (3, 3, 8)))
    p["gamma"] = (rs.rand(8) + 0.5).astype(np.float32)
    p["beta"] = rs.randn(8).astype(np.float32)
    p["_state"]["moving_mean"] = rs.randn(8).astype(np.float32)
    want, jupd = jl.apply(p, x, training=True)
    jgx, jgp = jax.grad(lambda x_, p_: (jl.apply(p_, x_, training=True)[0]
                                        * c).sum(), argnums=(0, 1))(x, p)
    tl = TL.BatchNormalization()
    tp = params_from_numpy(p)
    tx = torch.from_numpy(x).requires_grad_(True)
    for k in ("gamma", "beta"):
        tp[k].requires_grad_(True)
    got, tupd = tl.apply(tp, tx, training=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for k in ("moving_mean", "moving_var"):
        np.testing.assert_allclose(
            tupd["_state"][k].detach().numpy(),
            np.asarray(jupd["_state"][k]), rtol=1e-5, atol=1e-6)
    gx, gg, gb = torch.autograd.grad((got * torch.from_numpy(c)).sum(),
                                     [tx, tp["gamma"], tp["beta"]])
    for a, b in ((gx, jgx), (gg, jgp["gamma"]), (gb, jgp["beta"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    # eval mode makes no update, and call returns apply's output
    assert tl.apply(tp, tx, training=False)[1] == {}
    assert torch.equal(tl.call(tp, tx, training=True), got)


@pytest.mark.parametrize("extent", [112 // 8, 15])
@pytest.mark.parametrize("border", ["same", "valid"])
def test_maxpool2d_matches_jax(extent, border):
    # SAME 3x3/s2 pads with -inf, (0, 1) on an even extent
    rs = np.random.RandomState(2)
    shape = (extent, extent, 8)
    x = rs.randn(2, *shape).astype(np.float32)
    kw = dict(pool_size=3, strides=2, border_mode=border)
    want, got, _ = _run_both(JL.MaxPooling2D(**kw), TL.MaxPooling2D(**kw),
                             x, shape)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert TL.MaxPooling2D(**kw).compute_output_shape(shape) == \
        want.shape[1:]


def test_global_average_pooling_matches_jax():
    x = np.random.RandomState(3).randn(2, 7, 7, 32).astype(np.float32)
    want, got, _ = _run_both(JL.GlobalAveragePooling2D(),
                             TL.GlobalAveragePooling2D(), x, (7, 7, 32))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("activation", [None, "relu", "softmax"])
def test_dense_matches_jax(activation):
    rs = np.random.RandomState(4)
    x = rs.randn(3, 2, 7).astype(np.float32)
    want, got, _ = _run_both(
        JL.Dense(5, activation=activation),
        TL.Dense(5, activation=activation), x, (2, 7),
        lambda p: dict(p, bias=rs.randn(5).astype(np.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


ACTIVATIONS = ["linear", "relu", "relu6", "tanh", "sigmoid",
               "hard_sigmoid", "softmax", "log_softmax", "softplus",
               "softsign", "elu", "selu", "gelu", "silu", "swish", "exp"]


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_matches_jax(name):
    x = (np.random.RandomState(5).randn(4, 9) * 3).astype(np.float32)
    want, got, _ = _run_both(JL.Activation(name), TL.Activation(name), x,
                             (9,))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_activation_unknown_name_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        activations.get("nope")


def test_flatten_and_add_match_jax():
    rs = np.random.RandomState(6)
    x = rs.randn(2, 3, 4).astype(np.float32)
    want, got, _ = _run_both(JL.Flatten(), TL.Flatten(), x, (3, 4))
    np.testing.assert_array_equal(got, want)
    a, b = (rs.randn(2, 5).astype(np.float32) for _ in range(2))
    want = np.asarray(JL.Add().call({}, [a, b]))
    got = TL.Add().call({}, [torch.from_numpy(a), torch.from_numpy(b)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(64, 32), (3, 3, 64, 128),
                                   (7, 7, 3, 64)])
def test_glorot_uniform_matches_jax_fans(shape):
    # the two generators differ; the distribution must not: fans over
    # the receptive field, U(-limit, limit), limit = sqrt(6/(in+out))
    g = torch.Generator().manual_seed(0)
    w = initializers.glorot_uniform(g, shape).numpy()
    jw = np.asarray(jax.nn.initializers.glorot_uniform()(
        jax.random.key(0), shape))
    limit = np.abs(jw).max()     # ~ the JAX limit at these sizes
    assert w.shape == shape and w.dtype == np.float32
    assert np.abs(w).max() <= limit * 1.02
    assert np.abs(w).max() >= limit * 0.95
    np.testing.assert_allclose(w.std(), jw.std(), rtol=0.05)
    # same generator state, same weights
    g2 = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(
        initializers.glorot_uniform(g2, shape).numpy(), w)


def test_zero_one_initializers():
    g = torch.Generator()
    assert torch.equal(initializers.get("zero")(g, (3,)), torch.zeros(3))
    assert torch.equal(initializers.get("one")(g, (2,)), torch.ones(2))
    with pytest.raises(ValueError, match="unknown initializer"):
        initializers.get("nope")


def test_functional_model_names_and_params_match_jax():
    from analytics_zoo_tpu.pipeline.api.keras.engine import Input as JInput
    from analytics_zoo_tpu.pipeline.api.keras.models import Model as JModel

    def graph(L, inp):
        x = L.Convolution2D(8, 3, 3, border_mode="same")(inp)
        x = L.BatchNormalization()(x)
        x = L.Activation("relu")(x)
        x = L.MaxPooling2D(2)(x)
        x = L.Flatten()(x)
        return L.Dense(3)(x)
    jin = JInput((6, 6, 2))
    jm = JModel(jin, graph(JL, jin))
    tin = Input((6, 6, 2))
    tm = Model(tin, graph(TL, tin))
    jp = jax.device_get(jm.init_params(jax.random.key(0)))
    tp = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert sorted(tp) == sorted(jp)
    assert _shapes(tp) == _shapes(jp)
    x = np.random.RandomState(7).randn(3, 6, 6, 2).astype(np.float32)
    tm.load_params(jp)
    np.testing.assert_allclose(tm.predict(x, batch_size=2),
                               np.asarray(jm.forward(jp, x)),
                               rtol=1e-4, atol=1e-5)


def test_sequential_predict_and_param_tree():
    seq = Sequential([TL.Dense(4, input_shape=(3,)), TL.Activation("relu"),
                      TL.Dense(2)])
    params = seq.init_params(torch.Generator().manual_seed(0),
                             device="cpu")
    assert list(params) == ["dense_1", "activation_1", "dense_2"]
    x = np.random.RandomState(8).randn(5, 3).astype(np.float32)
    want = np.maximum(x @ params["dense_1"]["kernel"].numpy(), 0) @ \
        params["dense_2"]["kernel"].numpy()
    np.testing.assert_allclose(seq.predict(x), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="input_shape"):
        Sequential([TL.Dense(2)])


def test_set_params_checks_structure():
    lyr = TL.Dense(4)
    lyr.init(torch.Generator().manual_seed(0), (3,))
    with pytest.raises(ValueError, match="shape"):
        lyr.set_params({"kernel": torch.zeros(3, 5),
                        "bias": torch.zeros(4)})
    with pytest.raises(KeyError, match="keys"):
        lyr.set_params({"kernel": torch.zeros(3, 4)})
    # a layer is an nn.Module: its tree is its state
    assert sorted(lyr.state_dict()) == ["weights.bias", "weights.kernel"]
