"""int8 serving: the port's ``QuantizedModel`` against the JAX
package's on the same bridged numpy weights and calibration batch
(``pipeline/inference/quantize.py``), and through
``InferenceModel.load_keras_net(quantize=True)``.

Tolerances: weight scales, int8 weights and int32 accumulators bit for
bit (host numpy and integer arithmetic on both sides); the first int8
layer's activation scale bit for bit (its input is the calibration
batch itself), later ones within 1e-6 relative (their max|x| comes out
of an f32 float forward summed in another order); outputs within 1e-5
of max(1, max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu import init_nncontext as jinit
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu.pipeline.inference import \
    InferenceModel as JInferenceModel
from analytics_zoo_tpu.pipeline.inference import quantize as jq
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
from analytics_zoo_tpu_torch.pipeline.inference import (InferenceModel,
                                                        QuantizedModel)
from analytics_zoo_tpu_torch.pipeline.inference import quantize as tq

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    yield
    tzoo.reset_nncontext()


def _dense(lib):
    m = (JSequential() if lib is JL else Sequential())
    m.add(lib.Dense(32, activation="relu", input_shape=(16,)))
    m.add(lib.Dense(4))
    return m


def _conv(lib, border_mode, stride):
    m = (JSequential() if lib is JL else Sequential())
    m.add(lib.Convolution2D(8, 3, border_mode=border_mode,
                            subsample=stride, activation="relu",
                            input_shape=(9, 9, 3)))
    m.add(lib.GlobalAveragePooling2D())
    m.add(lib.Dense(5))
    return m


def _pair(build, x, quantize_types=("Dense",)):
    """The JAX QuantizedModel and the port's on the same weights."""
    jinit(seed=0)
    jm = build(JL)
    jm.compile(optimizer="sgd", loss="mse")
    params = jax.device_get(jm.init_params(jax.random.key(0)))
    jqm = jq.QuantizedModel(jm, params, x, quantize_types=quantize_types)
    tm = build(TL)
    tm.load_params(params)
    tqm = QuantizedModel(tm, x, quantize_types=quantize_types)
    return jqm, tqm


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale)


def _check_plans(jqm, tqm, x):
    """Scales, weights and every int8 layer's quantized input and int32
    accumulator against the reference, layer by layer on the
    reference's own float activations."""
    assert [e["mode"] for e in tqm.plan] == [e["mode"] for e in jqm._plan]
    first = True
    xj = jnp.asarray(x)
    for i, (je, te) in enumerate(zip(jqm._plan, tqm.plan)):
        layer = je["layer"]
        if je["mode"] == "int8":
            np.testing.assert_array_equal(te["w_q"], je["w_q"])
            np.testing.assert_array_equal(te["w_scale"], je["w_scale"])
            assert te["w_q"].dtype == np.int8
            if first:
                assert te["a_scale"] == je["a_scale"]
            else:
                np.testing.assert_allclose(te["a_scale"], je["a_scale"],
                                           rtol=1e-6)
            first = False
            # the quantized input, from the same scale and float input
            xq_want = np.array(jq._quantize_activation(xj, je["a_scale"]))
            xq_got = tq._quantize_activation(
                torch.from_numpy(np.array(xj)),
                torch.tensor(je["a_scale"]))
            np.testing.assert_array_equal(xq_got.numpy(), xq_want)
            if type(layer).__name__ == "Dense":
                acc_want = jax.lax.dot_general(
                    xq_want, je["w_q"],
                    (((xq_want.ndim - 1,), (0,)), ((), ())),
                    preferred_element_type=jnp.int32)
            else:
                acc_want = jax.lax.conv_general_dilated(
                    xq_want, je["w_q"], window_strides=layer.subsample,
                    padding=layer.border_mode.upper(),
                    rhs_dilation=layer.dilation,
                    dimension_numbers=layer._dn(),
                    preferred_element_type=jnp.int32)
            acc_got = tqm.accumulator(i, torch.from_numpy(xq_want))
            assert acc_got.dtype == torch.int32
            np.testing.assert_array_equal(acc_got.numpy(),
                                          np.asarray(acc_want))
        xj = layer.call(jqm.params.get(layer.name, {}), xj, training=False)
    assert not first, "no int8 layer in the plan"


def test_dense_scales_weights_and_accumulators_match_jax():
    x = np.random.RandomState(0).randn(24, 16).astype(np.float32)
    jqm, tqm = _pair(_dense, x)
    assert tqm.n_quantized == jqm.n_quantized == 2
    _check_plans(jqm, tqm, x)
    assert tqm.size_bytes() == jqm.size_bytes()
    f, q = tqm.size_bytes()
    assert f > 3 * q


def test_dense_outputs_match_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(24, 16).astype(np.float32)
    jqm, tqm = _pair(_dense, x)
    for xs in (x, rs.randn(5, 16).astype(np.float32) * 3):
        want = np.asarray(jqm.forward(jnp.asarray(xs)))
        with torch.inference_mode():
            got = tqm.forward(torch.from_numpy(xs)).numpy()
        _close(got, want)


@pytest.mark.parametrize("border_mode,stride",
                         [("same", 1), ("valid", 2), ("same", 2)])
def test_conv_opt_in_matches_jax(border_mode, stride):
    x = np.random.RandomState(2).randn(6, 9, 9, 3).astype(np.float32)

    def build(lib):
        return _conv(lib, border_mode, stride)
    types = ("Dense", "Convolution2D")
    jqm, tqm = _pair(build, x, quantize_types=types)
    assert tqm.n_quantized == jqm.n_quantized == 2
    _check_plans(jqm, tqm, x)
    want = np.asarray(jqm.forward(jnp.asarray(x)))
    with torch.inference_mode():
        got = tqm.forward(torch.from_numpy(x)).numpy()
    _close(got, want)
    # conv int8 is opt-in: Dense alone by default
    _, dense_only = _pair(build, x)
    assert dense_only.n_quantized == 1
    assert dense_only.plan[0]["mode"] == "float"


def test_load_keras_net_quantize_serves_int8_like_jax():
    rs = np.random.RandomState(3)
    x = rs.randn(16, 16).astype(np.float32)
    jinit(seed=0)
    jm = _dense(JL)
    jm.compile(optimizer="sgd", loss="mse")
    params = jax.device_get(jm.init_params(jax.random.key(0)))
    jim = JInferenceModel()
    jim.load_keras_net(jm, params=jax.tree_util.tree_map(jnp.asarray,
                                                          params),
                       example_inputs=[x], quantize=True)
    tim = InferenceModel().load_keras_net(_dense(TL), params=params,
                                          example_inputs=[x],
                                          quantize=True)
    assert tim.quantized.n_quantized == jim.quantized.n_quantized == 2
    _close(tim.predict(x), np.asarray(jim.predict(x)))
    # the int8 route is not the float one
    flt = InferenceModel().load_keras_net(_dense(TL), params=params)
    assert np.abs(tim.predict(x) - flt.predict(x)).max() > 0
    # a float reload replaces the int8 tables
    tim.load_keras_net(_dense(TL), params=params)
    assert tim.quantized is None


def test_quantize_needs_calibration_and_a_sequential():
    m = _dense(TL)
    with pytest.raises(ValueError, match="example_inputs"):
        InferenceModel().load_keras_net(m, quantize=True)
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model
    inp = Input(shape=(16,))
    fm = Model(inp, TL.Dense(4)(inp))
    fm.init_params()
    with pytest.raises(TypeError, match="Sequential"):
        QuantizedModel(fm, np.zeros((2, 16), np.float32))


def test_int8_matmul_pads_exactly():
    # the padding the card's product needs (rows, K and N) adds zeros
    # only: the padded product equals the unpadded one on the CPU
    rs = np.random.RandomState(4)
    a = torch.from_numpy(rs.randint(-127, 128, (3, 13)).astype(np.int8))
    b = torch.from_numpy(rs.randint(-127, 128, (13, 10)).astype(np.int8))
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)
    got = tq.int8_matmul(a, b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ap = torch.nn.functional.pad(a, (0, 3, 0, 14))
    bp = torch.nn.functional.pad(b, (0, 6, 0, 3))
    np.testing.assert_array_equal(tq.int8_matmul(ap, bp)[:3, :10].numpy(),
                                  want)
