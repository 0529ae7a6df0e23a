"""The image-classification family of the port on the card:
AveragePooling2D and DepthwiseConvolution2D against the CPU port, in
f32 (TF32 off) and bf16, forward and gradients, and a bf16 Inception-v1
forward against its f32 one.

Every test needs a CUDA card: it carries the ``cuda`` marker and skips
where there is none (the card is looked for inside the fixture). This
file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_image_archs_cuda.py -q

Tolerances: f32 1e-5 of max(1, max|CPU|) (sums in another order on the
card), bf16 2e-2 of max(1, max|CPU f32|); Inception-v1's bf16 logits
within 5e-2 of max(1, max|f32 logit|), its head scaled so that the
logits reach 10 (at random init they are ~1e-3, under that floor).
"""

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    tzoo.reset_nncontext()


def _on_both(lyr, shape, dev, dtype, seed=0):
    """``lyr`` on a seeded batch on the CPU (f32) and on ``dev`` in
    ``dtype``: outputs and the gradients of ``sum(out * w)`` by the
    input and every param, as host f32 arrays."""
    rs = np.random.RandomState(seed)
    x = rs.randn(2, *shape).astype(np.float32)
    p = lyr.build(torch.Generator().manual_seed(seed), shape)
    if "bias" in p:
        p["bias"] = torch.from_numpy(rs.randn(*p["bias"].shape)
                                     .astype(np.float32))
    res = []
    for d, dt in (("cpu", torch.float32), (dev, dtype)):
        tp = {k: v.to(d).requires_grad_(True) for k, v in p.items()}
        tx = torch.from_numpy(x).to(d, dt).requires_grad_(True)
        out = lyr.call(tp, tx)
        w = torch.from_numpy(np.random.RandomState(9).randn(*out.shape)
                             .astype(np.float32)).to(d, dt)
        grads = torch.autograd.grad((out * w).float().sum(),
                                    [tx] + list(tp.values()))
        res.append([t.detach().float().cpu().numpy()
                    for t in [out] + list(grads)])
    return res


def _close(got, want, rel):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        tol = rel * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("border,stride", [("valid", 2), ("same", 1),
                                           ("same", 2)])
def test_average_pooling_2d_against_the_cpu(cuda, dtype, rel, border,
                                            stride):
    lyr = TL.AveragePooling2D(pool_size=3, strides=stride,
                              border_mode=border)
    cpu, card = _on_both(lyr, (13, 14, 16), cuda, dtype)
    _close(card, cpu, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("mult,stride,border", [(1, 1, "same"),
                                                (1, 2, "same"),
                                                (2, 2, "valid")])
def test_depthwise_convolution_against_the_cpu(cuda, dtype, rel, mult,
                                               stride, border):
    lyr = TL.DepthwiseConvolution2D(3, 3, subsample=stride,
                                    border_mode=border,
                                    depth_multiplier=mult)
    cpu, card = _on_both(lyr, (14, 13, 32), cuda, dtype)
    _close(card, cpu, rel)


@pytest.mark.cuda
def test_inception_v1_bf16_forward_against_f32(cuda):
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    tzoo.init_nncontext(seed=0)
    net = ImageClassifier("inception-v1", input_shape=(224, 224, 3),
                          classes=1000).model
    net.init_params()
    rs = np.random.RandomState(0)
    scale = np.linspace(0.25, 2.0, 4).astype(np.float32)[:, None, None,
                                                         None]
    x = torch.from_numpy(rs.rand(4, 224, 224, 3).astype(np.float32) * scale)
    head = net.graph_layers["fc"].params()["kernel"]
    with torch.no_grad():
        head.mul_(10.0 / float(np.abs(net.predict(x)).max()))
    f32 = net.predict(x.to(cuda))
    bf16 = net.predict(x.to(cuda, torch.bfloat16))
    assert bf16.shape == f32.shape == (4, 1000)
    assert np.isfinite(bf16).all()
    tol = 5e-2 * max(1.0, float(np.abs(f32).max()))
    assert float(np.abs(bf16 - f32).max()) <= tol
    # the check can fail: the images move the logits by more than it
    assert float(np.median(np.ptp(f32, axis=0))) > tol
