"""The port's elementwise layers, advanced activations and conv-family
shape layers against the JAX package's on the CPU, on the same numpy
inputs and the JAX package's params (f32 within 1e-5, bf16 within
2e-2), with the cases of ``tests/test_layers_extra.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu_torch.bridge import params_from_numpy
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL

TOL = 1e-5


def both(make, x, in_shape=None, training=False, dtype=torch.float32):
    """``make(L)`` built in each package from the JAX package's params,
    applied to ``x``: ``(port output, reference output, layer pair)``."""
    jl, tl = make(JL), make(TL)
    shape = in_shape or tuple(np.shape(x)[1:])
    jp = jl.init(jax.random.key(0), shape)
    tl.init(torch.Generator().manual_seed(0), shape)
    tp = params_from_numpy(jax.device_get(jp))
    if isinstance(x, list):
        jx = [jnp.asarray(v) for v in x]
        tx = [torch.from_numpy(v).to(dtype) for v in x]
    else:
        jx = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16
                         else None)
        tx = torch.from_numpy(x).to(dtype)
    got = tl.call(tp, tx, training=training)
    want = jl.call(jp, jx, training=training)
    assert tuple(tl.compute_output_shape(shape)) == \
        tuple(jl.compute_output_shape(shape)) if not isinstance(
            tl.compute_output_shape(shape), list) else True
    return got, want, (tl, tp, jl, jp)


def close(got, want, tol=TOL):
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, tol)
        return
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(jnp.asarray(want, jnp.float32)
                   if jnp.asarray(want).dtype == jnp.bfloat16 else want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


X5 = np.array([[-2.0, -0.3, 0.0, 0.4, 3.0]], np.float32)
RS = np.random.RandomState(0)
X34 = RS.randn(3, 4).astype(np.float32)
IMG = RS.randn(2, 5, 6, 3).astype(np.float32)
IMG_TH = RS.randn(2, 3, 5, 6).astype(np.float32)

CASES = {
    "AddConstant": (lambda L: L.AddConstant(1.5), X5),
    "MulConstant": (lambda L: L.MulConstant(2.0), X5),
    "Power": (lambda L: L.Power(2.0, 2.0, 1.0), X5),
    "Negative": (lambda L: L.Negative(), X5),
    "Square": (lambda L: L.Square(), X5),
    "Exp": (lambda L: L.Exp(), X5),
    "Log": (lambda L: L.Log(), np.abs(X5) + 0.5),
    "Sqrt": (lambda L: L.Sqrt(), np.abs(X5)),
    "Identity": (lambda L: L.Identity(), X5),
    "BinaryThreshold": (lambda L: L.BinaryThreshold(0.0), X5),
    "Threshold": (lambda L: L.Threshold(0.0, -9.0), X5),
    "HardShrink": (lambda L: L.HardShrink(0.5), X5),
    "SoftShrink": (lambda L: L.SoftShrink(0.5), X5),
    "HardTanh": (lambda L: L.HardTanh(), X5),
    "RReLU": (lambda L: L.RReLU(0.1, 0.3), np.array([[-4.0, 4.0]],
                                                     np.float32)),
    "CAdd": (lambda L: L.CAdd((4,)), X34),
    "CMul": (lambda L: L.CMul((1, 4)), X34),
    "Mul": (lambda L: L.Mul(), X34),
    "Scale": (lambda L: L.Scale((4,)), X34),
    "GetShape": (lambda L: L.GetShape(), np.zeros((2, 1, 5), np.float32)),
    "Expand": (lambda L: L.Expand((-1, 4, 5)),
               RS.randn(2, 1, 5).astype(np.float32)),
    "Max": (lambda L: L.Max(2), RS.randn(2, 3, 4).astype(np.float32)),
    "Max_index": (lambda L: L.Max(1, return_value=False),
                  RS.randn(2, 3, 4).astype(np.float32)),
    "SplitTensor": (lambda L: L.SplitTensor(2, 2),
                    RS.randn(2, 3, 6).astype(np.float32)),
    "ResizeBilinear_up": (lambda L: L.ResizeBilinear(8, 10), IMG),
    "ResizeBilinear_down": (lambda L: L.ResizeBilinear(3, 4), IMG),
    "ResizeBilinear_align": (
        lambda L: L.ResizeBilinear(8, 10, align_corners=True), IMG),
    "ResizeBilinear_th": (
        lambda L: L.ResizeBilinear(3, 9, dim_ordering="th"), IMG_TH),
    "KerasLayerWrapper": (
        lambda L: L.KerasLayerWrapper(lambda x: x * 2 + 1), X34),
    "Highway": (lambda L: L.Highway(activation="relu"), X34),
    "MaxoutDense": (lambda L: L.MaxoutDense(4, nb_feature=3),
                    RS.randn(3, 5).astype(np.float32)),
    "LeakyReLU": (lambda L: L.LeakyReLU(0.2), X5),
    "ELU": (lambda L: L.ELU(0.7), X5),
    "ThresholdedReLU": (lambda L: L.ThresholdedReLU(0.3), X5),
    "PReLU": (lambda L: L.PReLU(), X34 - 0.5),
    "SReLU": (lambda L: L.SReLU(), X34 * 2),
    "Softmax": (lambda L: L.Softmax(), X34),
    "ZeroPadding1D": (lambda L: L.ZeroPadding1D((1, 2)),
                      RS.randn(2, 5, 3).astype(np.float32)),
    "ZeroPadding2D_tf": (lambda L: L.ZeroPadding2D((1, 2)), IMG),
    "ZeroPadding2D_th": (lambda L: L.ZeroPadding2D(
        ((0, 1), (2, 1)), dim_ordering="th"), IMG_TH),
    "ZeroPadding2D_neg_inf": (lambda L: L.ZeroPadding2D(
        1, dim_ordering="th", value=float("-inf")), IMG_TH),
    "Cropping1D": (lambda L: L.Cropping1D((1, 2)),
                   RS.randn(2, 6, 3).astype(np.float32)),
    "Cropping2D_tf": (lambda L: L.Cropping2D(((1, 0), (2, 1))), IMG),
    "Cropping2D_th": (lambda L: L.Cropping2D(1, dim_ordering="th"), IMG_TH),
    "UpSampling1D": (lambda L: L.UpSampling1D(3),
                     RS.randn(2, 4, 3).astype(np.float32)),
    "UpSampling2D_tf": (lambda L: L.UpSampling2D((2, 3)), IMG),
    "UpSampling2D_th": (lambda L: L.UpSampling2D(2, dim_ordering="th"),
                        IMG_TH),
    "UpSampling3D": (lambda L: L.UpSampling3D((2, 1, 2)),
                     RS.randn(2, 2, 3, 2, 4).astype(np.float32)),
    "Convolution2D_th_grouped": (lambda L: L.Convolution2D(
        12, 3, 3, dim_ordering="th", groups=4, border_mode="valid"),
        RS.randn(2, 8, 9, 9).astype(np.float32)),
    "Convolution2D_th_same_strided": (lambda L: L.Convolution2D(
        4, 3, 3, dim_ordering="th", border_mode="same", subsample=2),
        IMG_TH),
    "BatchNormalization_th": (lambda L: L.BatchNormalization(
        dim_ordering="th"), IMG_TH),
}


@pytest.mark.parametrize("case", list(CASES))
def test_layer_matches_reference(case):
    make, x = CASES[case]
    got, want, _ = both(make, x)
    if case == "ZeroPadding2D_neg_inf":
        assert got.min().item() == torch.finfo(torch.float32).min
    if case == "Max_index":
        assert got.dtype == torch.int32
    close(got, want, tol=1e-4 if case.startswith("Convolution") else TOL)


@pytest.mark.parametrize("case", ["Highway", "ResizeBilinear_down",
                                  "UpSampling2D_tf", "PReLU", "MaxoutDense"])
def test_layer_matches_reference_in_bf16(case):
    make, x = CASES[case]
    got, want, _ = both(make, x, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    close(got, want, tol=2e-2)


def test_rrelu_eval_uses_mean_slope_and_training_draws():
    x = np.array([[-4.0, 4.0]], np.float32)
    got, _, (tl, tp, _, _) = both(lambda L: L.RReLU(0.1, 0.3), x)
    np.testing.assert_allclose(got.numpy(), [[-0.8, 4.0]], rtol=1e-6)
    xs = torch.full((400, 50), -1.0)
    a = tl.call(tp, xs, training=True, rng=3)
    b = tl.call(tp, xs, training=True, rng=3)
    assert torch.equal(a, b)                      # one seed, one draw
    slopes = -a
    assert 0.1 <= slopes.min().item() and slopes.max().item() <= 0.3
    assert abs(slopes.mean().item() - 0.2) < 5e-3
    assert not torch.equal(a, tl.call(tp, xs, training=True, rng=4))


def test_gaussian_sampler():
    mean = np.ones((2, 3), np.float32)
    logv = np.zeros((2, 3), np.float32)
    got, want, (tl, tp, _, _) = both(lambda L: L.GaussianSampler(),
                                     [mean, logv], in_shape=[(3,), (3,)])
    close(got, want)
    tm, tv = torch.from_numpy(mean), torch.from_numpy(logv)
    # a seed without training stays deterministic (inference)
    np.testing.assert_allclose(tl.call(tp, [tm, tv], rng=0).numpy(), mean)
    big = [torch.zeros(500, 40), torch.full((500, 40), np.log(4.0))]
    out = tl.call(tp, big, training=True, rng=0)
    assert abs(out.std().item() - 2.0) < 0.05
    assert abs(out.mean().item()) < 0.05
    assert tl.compute_output_shape([(3,), (3,)]) == (3,)


def test_select_table_and_split_tensor_shapes():
    a, b = np.zeros((2, 3), np.float32), np.ones((2, 5), np.float32)
    got, want, (tl, _, jl, _) = both(lambda L: L.SelectTable(1), [a, b],
                                     in_shape=[(3,), (5,)])
    close(got, want)
    assert tl.compute_output_shape([(3,), (5,)]) == (5,)
    parts = TL.SplitTensor(2, 2).compute_output_shape((3, 6))
    assert parts == JL.SplitTensor(2, 2).compute_output_shape((3, 6))


def test_resize_bilinear_matches_torch_when_upsampling():
    # (jax.image.resize is torch's half-pixel bilinear when upsampling)
    for align in (False, True):
        got, _, _ = both(lambda L: L.ResizeBilinear(8, 10,
                                                    align_corners=align),
                         IMG)
        ref = F.interpolate(torch.from_numpy(IMG).permute(0, 3, 1, 2),
                            size=(8, 10), mode="bilinear",
                            align_corners=align).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_highway_passes_its_input_with_a_closed_gate():
    x = np.random.RandomState(2).randn(3, 6).astype(np.float32)
    lyr = TL.Highway()
    params = dict(lyr.init(torch.Generator().manual_seed(0), (6,)))
    params["gate_bias"] = torch.full((6,), -1e9)
    params["gate_kernel"] = torch.zeros((6, 6))
    np.testing.assert_allclose(lyr.call(params, torch.from_numpy(x)), x,
                               rtol=1e-5, atol=1e-5)


def test_layers_train_in_a_sequential():
    """A net of the new layers fits through the Estimator on the CPU."""
    import analytics_zoo_tpu_torch as tzoo
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
    tzoo.init_nncontext(device="cpu")
    try:
        net = Sequential([
            TL.ZeroPadding2D(1, dim_ordering="th", input_shape=(2, 6, 6)),
            TL.Convolution2D(4, 3, 3, dim_ordering="th"),
            TL.BatchNormalization(dim_ordering="th"),
            TL.PReLU(), TL.UpSampling2D(2, dim_ordering="th"),
            TL.Cropping2D(2, dim_ordering="th"), TL.CMul((1, 1, 1)),
            TL.Flatten(), TL.Highway(), TL.RReLU(), TL.MaxoutDense(3)])
        net.compile(optimizer="sgd", loss="mse")
        rs = np.random.RandomState(0)
        x = rs.randn(8, 2, 6, 6).astype(np.float32)
        y = rs.randn(8, 3).astype(np.float32)
        hist = net.fit(x, y, batch_size=4, nb_epoch=2)
        assert net.predict(x).shape == (8, 3)
        assert hist is not None
    finally:
        tzoo.reset_nncontext()
