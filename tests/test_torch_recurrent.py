"""The port's recurrent layers and Convolution1D against the JAX
package's, on the same numpy inputs and params: SimpleRNN, LSTM and GRU
with and without sequences and backwards, Bidirectional in its four
merge modes, TimeDistributed(Dense), ``call_with_state`` from a given
carry, Convolution1D (valid and same, strides 1 and 2) and its aliases,
the regularizers, the errors, and a bf16 LSTM under ``mixed_bfloat16``
against the port's f32.

Forward and gradient (of ``sum(out * w)`` for a fixed random ``w``, by
the input and every param) within f32 1e-5; the bf16 LSTM within 2e-2
of max|out|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu_torch.bridge import params_from_numpy
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
from analytics_zoo_tpu_torch.pipeline.estimator import Estimator

TOL = 1e-5
B, T, F, H = 3, 7, 5, 6


@pytest.fixture(autouse=True)
def _cpu():
    tzoo.init_nncontext(seed=0, device="cpu")
    yield
    tzoo.reset_nncontext()


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def _leaves(tree, prefix=""):
    out = []
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out += _leaves(v, path) if isinstance(v, dict) else [(path, v)]
    return out


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _with_bias(p, rs):
    """Non-zero biases, so that a wrong bias layout shows."""
    if isinstance(p, dict):
        return {k: (rs.randn(*np.shape(v)).astype(np.float32) * 0.3
                    if k == "bias" else _with_bias(v, rs))
                for k, v in p.items()}
    return p


def _call(lyr, p, x):
    return lyr.call(p, x)


def _fwd_grad(jlyr, tlyr, x, shape, fn=None):
    """Both layers on ``x`` with the JAX layer's params (biases made
    non-zero): outputs, output shapes and the gradients of ``sum(out *
    w)`` by the input and every param. ``fn(layer, params, x)`` runs a
    layer (default ``layer.call``)."""
    fn = fn or _call
    p = _with_bias(jax.device_get(jlyr.init(jax.random.key(0), shape)),
                   np.random.RandomState(4))
    jout = fn(jlyr, p, jnp.asarray(x))
    w = np.random.RandomState(9).randn(*jout.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda p, a: jnp.sum(fn(jlyr, p, a) * w),
                        argnums=(0, 1))(p, jnp.asarray(x))

    tp = params_from_numpy(p)
    leaves = _leaves(tp)
    for _, v in leaves:
        v.requires_grad_(True)
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    tout = fn(tlyr, tp, tx)
    _close(tout, jout, "out")
    if fn is _call:
        assert tlyr.compute_output_shape(shape) == \
            jlyr.compute_output_shape(shape) == tuple(jout.shape[1:])
    grads = torch.autograd.grad(torch.sum(tout * torch.from_numpy(w)),
                                [v for _, v in leaves] + [tx])
    for (path, _), g in zip(leaves, grads):
        _close(g, _get(jgp, path), f"grad {path}")
    _close(grads[-1], jgx, "grad input")
    return tout


def _x(shape=(B, T, F), seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("go_backwards", [False, True])
@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("kind", ["SimpleRNN", "LSTM", "GRU"])
def test_recurrent_layer_matches_jax(kind, return_sequences, go_backwards):
    kw = dict(return_sequences=return_sequences, go_backwards=go_backwards)
    out = _fwd_grad(getattr(JL, kind)(H, **kw), getattr(TL, kind)(H, **kw),
                    _x(), (T, F))
    assert out.shape == ((B, T, H) if return_sequences else (B, H))


@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("merge_mode", ["concat", "sum", "mul", "ave"])
def test_bidirectional_matches_jax(merge_mode, return_sequences):
    jl = JL.Bidirectional(JL.LSTM(H, return_sequences=return_sequences),
                          merge_mode=merge_mode)
    tl = TL.Bidirectional(TL.LSTM(H, return_sequences=return_sequences),
                          merge_mode=merge_mode)
    _fwd_grad(jl, tl, _x(seed=2), (T, F))
    assert sorted(tl.build(torch.Generator().manual_seed(0), (T, F))) == \
        ["backward", "forward"]


def test_bidirectional_gru_and_its_errors():
    _fwd_grad(JL.Bidirectional(JL.GRU(H, return_sequences=True)),
              TL.Bidirectional(TL.GRU(H, return_sequences=True)),
              _x(seed=3), (T, F))
    with pytest.raises(ValueError, match="merge_mode"):
        TL.Bidirectional(TL.LSTM(H), merge_mode="max")


def test_time_distributed_dense_matches_jax():
    _fwd_grad(JL.TimeDistributed(JL.Dense(4, activation="tanh")),
              TL.TimeDistributed(TL.Dense(4, activation="tanh")),
              _x(seed=5), (T, F))


@pytest.mark.parametrize("kind", ["LSTM", "GRU", "SimpleRNN"])
def test_call_with_state_from_a_given_carry_matches_jax(kind):
    rs = np.random.RandomState(6)
    h0 = rs.randn(B, H).astype(np.float32)
    c0 = rs.randn(B, H).astype(np.float32)

    def run(lyr, p, a):
        jax_side = not isinstance(a, torch.Tensor)
        wrap = jnp.asarray if jax_side else torch.from_numpy
        carry = (wrap(h0), wrap(c0)) if kind == "LSTM" else wrap(h0)
        outs, final = lyr.call_with_state(p, a, carry)
        finals = final if kind == "LSTM" else (final,)
        cat = jnp.concatenate if jax_side else torch.cat
        return cat([outs.reshape(B, -1)] + list(finals), 1)

    _fwd_grad(getattr(JL, kind)(H, go_backwards=True),
              getattr(TL, kind)(H, go_backwards=True), _x(seed=7), (T, F),
              fn=run)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("border_mode", ["valid", "same"])
def test_convolution1d_matches_jax(border_mode, stride):
    kw = dict(activation="relu", border_mode=border_mode,
              subsample_length=stride)
    out = _fwd_grad(JL.Convolution1D(4, 3, **kw),
                    TL.Convolution1D(4, 3, **kw), _x(seed=8), (T, F))
    want_t = -(-T // stride) if border_mode == "same" else \
        -(-(T - 2) // stride)
    assert out.shape == (B, want_t, 4)


def test_convolution1d_aliases_the_classifier_filter_and_errors():
    assert TL.Conv1D is TL.Convolution1D and TL.Conv2D is TL.Convolution2D
    # the text classifier's filter (5) on an even length, no bias
    _fwd_grad(JL.Conv1D(6, 5, border_mode="same", subsample=2, bias=False),
              TL.Conv1D(6, 5, border_mode="same", subsample=2, bias=False),
              _x((B, 10, F), seed=9), (10, F))
    with pytest.raises(ValueError, match="border_mode"):
        TL.Convolution1D(4, 3, border_mode="full")
    with pytest.raises(TypeError, match="unexpected kwargs"):
        TL.Convolution1D(4, 3, filter_size=2)


def test_recurrent_regularizers_match_jax():
    kw = dict(w_regularizer="l2", u_regularizer="l1", b_regularizer="l1l2")
    jl, tl = JL.LSTM(H, **kw), TL.LSTM(H, **kw)
    p = _with_bias(jax.device_get(jl.init(jax.random.key(0), (T, F))),
                   np.random.RandomState(4))
    want = float(jl.regularization_loss(p))
    got = float(tl.regularization_loss(params_from_numpy(p)))
    np.testing.assert_allclose(got, want, rtol=TOL)
    jb = JL.Bidirectional(JL.GRU(H, **kw))
    tb = TL.Bidirectional(TL.GRU(H, **kw))
    p = jax.device_get(jb.init(jax.random.key(1), (T, F)))
    np.testing.assert_allclose(
        float(tb.regularization_loss(params_from_numpy(p))),
        float(jb.regularization_loss(p)), rtol=TOL)


def test_port_builds_the_reference_layouts():
    gen = torch.Generator().manual_seed(0)
    for kind, g in (("SimpleRNN", 1), ("LSTM", 4), ("GRU", 3)):
        p = getattr(TL, kind)(H).build(gen, (T, F))
        assert {k: tuple(v.shape) for k, v in p.items()} == {
            "kernel": (F, g * H), "recurrent": (H, g * H), "bias": (g * H,)}
        # each gate's recurrent block is orthogonal
        for i in range(g):
            blk = p["recurrent"][:, i * H:(i + 1) * H]
            _close(blk.T @ blk, np.eye(H, dtype=np.float32), kind)
    td = TL.TimeDistributed(TL.Dense(4)).build(gen, (T, F))
    assert list(td) == ["layer"] and \
        tuple(td["layer"]["kernel"].shape) == (F, 4)
    c = TL.Convolution1D(4, 3).build(gen, (T, F))
    assert tuple(c["kernel"].shape) == (3, F, 4)


def test_bf16_lstm_under_mixed_bfloat16_against_f32():
    net = Sequential([TL.LSTM(16, return_sequences=True,
                              input_shape=(12, F)), TL.LSTM(16)])
    x = _x((8, 12, F), seed=10)
    f32 = Estimator(net, dtype_policy="float32").predict(x, batch_size=8)
    bf16 = Estimator(net, dtype_policy="mixed_bfloat16").predict(
        x, batch_size=8)
    assert bf16.dtype == np.float32 and bf16.shape == (8, 16)
    err = float(np.abs(bf16 - f32).max())
    assert 0 < err <= 2e-2 * float(np.abs(f32).max())
