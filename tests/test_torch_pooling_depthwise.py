"""The port's pooling family and DepthwiseConvolution2D against the JAX
package's, on the same numpy inputs and params: forward, and the
gradients of ``sum(out * w)`` for a fixed random ``w`` by the input (and
the params), within f32 1e-5. Max and average pools in 1, 2 and 3
dimensions, valid and same, strides 1 and 2, on spatial extents both
odd and even, channels last (``tf``) and first (``th``); the global
pools; the depthwise conv at depth multipliers 1 and 2, both strides,
both borders, with and without a bias. Also the FLOP counter's count of
a depthwise conv: ``2 x out elements x taps``, one input channel per
group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu_torch.bridge import params_from_numpy
from analytics_zoo_tpu_torch.perf import flops
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL

TOL = 1e-5
# spatial extents per rank: every pool meets an odd and an even extent
SPATIAL = {1: (7,), 2: (7, 6), 3: (5, 4, 3)}
CH = 3


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


def _fwd_grad(jlyr, tlyr, x, shape):
    """Both layers on ``x`` with the JAX layer's params: outputs, output
    shapes, and the gradients by the input and every param."""
    p = jax.device_get(jlyr.init(jax.random.key(0), shape))
    jout = jlyr.call(p, jnp.asarray(x))
    w = np.random.RandomState(9).randn(*jout.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda p, x: jnp.sum(jlyr.call(p, x) * w),
                        argnums=(0, 1))(p, jnp.asarray(x))
    tp = params_from_numpy(p)
    leaves = [v.requires_grad_(True) for v in tp.values()]
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    tout = tlyr.call(tp, tx)
    _close(tout, jout, "out")
    assert tlyr.compute_output_shape(shape) == jlyr.compute_output_shape(
        shape) == tuple(jout.shape[1:])
    grads = torch.autograd.grad((tout * torch.from_numpy(w)).sum(),
                                leaves + [tx])
    for (k, _), g in zip(tp.items(), grads[:-1]):
        _close(g, jgp[k], f"grad {k}")
    _close(grads[-1], jgx, "grad input")
    return tout


def _input(rank, ordering, seed=0):
    sp = SPATIAL[rank]
    shape = sp + (CH,) if ordering == "tf" else (CH,) + sp
    x = np.random.RandomState(seed).randn(2, *shape).astype(np.float32)
    return x, shape


_POOLS = ["MaxPooling1D", "AveragePooling1D", "MaxPooling2D",
          "AveragePooling2D", "MaxPooling3D", "AveragePooling3D"]


@pytest.mark.parametrize("ordering", ["tf", "th"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("border", ["valid", "same"])
@pytest.mark.parametrize("name", _POOLS)
def test_pool_matches_jax(name, border, stride, ordering):
    rank = int(name[-2])
    x, shape = _input(rank, ordering)
    if rank == 1:
        kw = dict(pool_length=3, stride=stride)
    else:
        kw = dict(pool_size=3, strides=stride)
    kw.update(border_mode=border, dim_ordering=ordering)
    _fwd_grad(getattr(JL, name)(**kw), getattr(TL, name)(**kw), x, shape)


@pytest.mark.parametrize("ordering", ["tf", "th"])
@pytest.mark.parametrize("name", [
    "GlobalMaxPooling1D", "GlobalAveragePooling1D", "GlobalMaxPooling2D",
    "GlobalAveragePooling2D", "GlobalMaxPooling3D",
    "GlobalAveragePooling3D"])
def test_global_pool_matches_jax(name, ordering):
    x, shape = _input(int(name[-2]), ordering, seed=1)
    _fwd_grad(getattr(JL, name)(dim_ordering=ordering),
              getattr(TL, name)(dim_ordering=ordering), x, shape)


def test_default_pool_size_and_same_edge_counts():
    """The defaults (pool 2, strides = pool) and a SAME average's edge
    windows, which divide by their real cells only: on ones, every
    output is 1."""
    x, shape = _input(2, "tf", seed=2)
    _fwd_grad(JL.AveragePooling2D(), TL.AveragePooling2D(), x, shape)
    ones = torch.ones(1, 7, 6, 2)
    y = TL.AveragePooling2D(pool_size=3, strides=2,
                            border_mode="same").call({}, ones)
    assert y.shape == (1, 4, 3, 2)
    torch.testing.assert_close(y, torch.ones_like(y), rtol=0, atol=0)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("border", ["same", "valid"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mult", [1, 2])
def test_depthwise_matches_jax(mult, stride, border, bias):
    x, shape = _input(2, "tf", seed=3)
    kw = dict(subsample=stride, border_mode=border, depth_multiplier=mult,
              bias=bias)
    if bias:   # a non-zero bias, so its gradient and add are both held
        kw["activation"] = "tanh"
    jl, tl = JL.DepthwiseConvolution2D(3, 3, **kw), \
        TL.DepthwiseConvolution2D(3, 3, **kw)
    out = _fwd_grad(jl, tl, x, shape)
    if stride == 2 and border == "same":
        assert out.shape == (2, 4, 3, CH * mult)
    assert tl.build(torch.Generator().manual_seed(0), shape)[
        "depthwise"].shape == (3, 3, 1, CH * mult)


def test_depthwise_channel_order_and_th():
    """Output channel ``c * mult + m`` is input channel c through filter
    m, as XLA's ``feature_group_count`` orders it; and channels first."""
    x = np.zeros((1, 3, 3, 2), np.float32)
    x[0, 1, 1] = (1.0, 10.0)
    k = np.zeros((1, 1, 1, 4), np.float32)
    k[0, 0, 0] = (1.0, 2.0, 3.0, 4.0)
    lyr = TL.DepthwiseConvolution2D(1, 1, depth_multiplier=2, bias=False)
    y = lyr.call({"depthwise": torch.from_numpy(k)}, torch.from_numpy(x))
    np.testing.assert_array_equal(y[0, 1, 1].numpy(), [1.0, 2.0, 30.0, 40.0])
    xt = np.random.RandomState(4).randn(2, CH, 7, 6).astype(np.float32)
    kw = dict(subsample=2, border_mode="same", depth_multiplier=2,
              dim_ordering="th")
    _fwd_grad(JL.DepthwiseConvolution2D(3, 2, **kw),
              TL.DepthwiseConvolution2D(3, 2, **kw), xt, (CH, 7, 6))


def test_depthwise_flops_are_one_channel_per_group():
    lyr = TL.DepthwiseConvolution2D(3, 3, subsample=2, border_mode="same",
                                    depth_multiplier=2, bias=False)
    p = lyr.build(torch.Generator().manual_seed(0), (8, 8, 5))
    x = torch.randn(2, 8, 8, 5)
    with flops.count() as c:
        y = lyr.call(p, x)
    assert y.shape == (2, 4, 4, 10)
    assert [o.kind for o in c.ops] == ["convolution"]
    assert c.total == 2.0 * y.numel() * 3 * 3
