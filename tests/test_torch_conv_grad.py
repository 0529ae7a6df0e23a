"""The port's phase-decomposed strided-conv backward
(``analytics_zoo_tpu_torch/ops/conv_grad.py``) against autograd of
``F.conv2d`` and against the JAX package's ``conv_grad.conv2d``
gradients on the same seeded numpy inputs, over stride, kernel,
padding and extent (the reference's
``test_conv2d_grads_match_transpose_rule`` grid); bf16; the
``ZOO_TPU_PHASE_BWD`` gate; and ``Convolution2D``'s route through it.

Tolerances: f32 within 1e-5 (the same sums reassociated, as the
reference's test holds its own); bf16 within the reference's bf16 test
bounds (0.1 relative, 0.1 or 0.2 absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from analytics_zoo_tpu.ops import conv_grad as jcg
from analytics_zoo_tpu_torch.ops import conv_grad as tcg


def _torch_ref(x, w, stride, padding):
    """Autograd of F.conv2d with the same explicit pads (NHWC/HWIO)."""
    pads = tcg.normalize_padding(padding, x.shape[1:3], w.shape[:2],
                                 (stride, stride))
    (lo_h, hi_h), (lo_w, hi_w) = pads
    xc = F.pad(x.permute(0, 3, 1, 2), (lo_w, hi_w, lo_h, hi_h))
    return F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride).permute(
        0, 2, 3, 1)


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("hw", [(8, 8), (9, 11)])
def test_phase_grads_match_autograd_and_the_reference(stride, k, padding,
                                                      hw):
    rs = np.random.RandomState(stride * 100 + k * 10 + hw[1])
    h, w_ = hw
    xn = rs.randn(2, h, w_, 5).astype(np.float32)
    wn = rs.randn(k, k, 5, 7).astype(np.float32)
    s = (stride, stride)
    x = torch.from_numpy(xn).requires_grad_()
    w = torch.from_numpy(wn).requires_grad_()
    y = tcg.conv2d(x, w, stride=s, padding=padding, phase_bwd=True)
    gn = rs.randn(*y.shape).astype(np.float32)
    dx, dw = torch.autograd.grad(y, (x, w), torch.from_numpy(gn))
    yr = _torch_ref(x, w, stride, padding)
    np.testing.assert_allclose(y.detach().numpy(), yr.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    dx_r, dw_r = torch.autograd.grad(yr, (x, w), torch.from_numpy(gn))
    for got, want in ((dx, dx_r), (dw, dw_r)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # the JAX package's phase backward on the same numbers
    _, vjp = jax.vjp(lambda a, b: jcg.conv2d(a, b, stride=s, padding=padding,
                                             phase_bwd=True),
                     jnp.asarray(xn), jnp.asarray(wn))
    jdx, jdw = vjp(jnp.asarray(gn))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)
    # the helpers alone, as the reference's are called
    pads = tcg.normalize_padding(padding, (h, w_), (k, k), s)
    assert pads == jcg.normalize_padding(padding, (h, w_), (k, k), s)
    g = torch.from_numpy(gn)
    np.testing.assert_allclose(
        tcg.phase_dx(g, w.detach(), (h, w_), s, pads).numpy(),
        np.asarray(jcg.phase_dx(jnp.asarray(gn), jnp.asarray(wn), (h, w_),
                                s, pads)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tcg.phase_dw(x.detach(), g, (k, k), s, pads).numpy(),
        np.asarray(jcg.phase_dw(jnp.asarray(xn), jnp.asarray(gn), (k, k),
                                s, pads)), rtol=1e-5, atol=1e-5)


def test_phase_grads_bf16():
    rs = np.random.RandomState(0)
    xn = rs.randn(2, 12, 12, 8).astype(np.float32)
    wn = (rs.randn(3, 3, 8, 16) * 0.1).astype(np.float32)
    gn = rs.randn(2, 6, 6, 16).astype(np.float32)
    x = torch.from_numpy(xn).to(torch.bfloat16).requires_grad_()
    w = torch.from_numpy(wn).to(torch.bfloat16).requires_grad_()
    y = tcg.conv2d(x, w, stride=2, phase_bwd=True)
    dx, dw = torch.autograd.grad(y, (x, w), torch.from_numpy(gn).to(
        torch.bfloat16))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.bfloat16
    _, vjp = jax.vjp(lambda a, b: jcg.conv2d(a, b, stride=(2, 2),
                                             phase_bwd=True),
                     jnp.asarray(xn, jnp.bfloat16),
                     jnp.asarray(wn, jnp.bfloat16))
    jdx, jdw = vjp(jnp.asarray(gn, jnp.bfloat16))
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx, np.float32), rtol=0.1,
                               atol=0.1)
    np.testing.assert_allclose(dw.float().numpy(),
                               np.asarray(jdw, np.float32), rtol=0.1,
                               atol=0.2)


def test_phase_flag_gates_backward(monkeypatch):
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(1, 8, 8, 4).astype(np.float32))
    w = torch.from_numpy(rs.randn(3, 3, 4, 4).astype(np.float32))

    def bumps():
        before = dict(tcg.invocations)
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        tcg.conv2d(xx, ww, stride=(2, 2)).sum().backward()
        return {k: tcg.invocations[k] - before[k] for k in before}

    # default on the CPU: the measured-win gate is off, cuDNN's rule
    monkeypatch.delenv("ZOO_TPU_PHASE_BWD", raising=False)
    assert tcg.PHASE_MEASURED_WIN is False
    assert not tcg.phase_bwd_enabled("cpu")
    d = bumps()
    assert d["bwd_ref"] == 1 and d["bwd_phase"] == 0
    monkeypatch.setenv("ZOO_TPU_PHASE_BWD", "1")
    d = bumps()
    assert d["bwd_phase"] == 1 and d["bwd_ref"] == 0
    monkeypatch.setenv("ZOO_TPU_PHASE_BWD", "0")
    d = bumps()
    assert d["bwd_ref"] == 1 and d["bwd_phase"] == 0
    # the gate on a CUDA device follows PHASE_MEASURED_WIN
    monkeypatch.delenv("ZOO_TPU_PHASE_BWD")
    monkeypatch.setattr(tcg, "PHASE_MEASURED_WIN", True)
    assert tcg.phase_bwd_enabled("cuda") and not tcg.phase_bwd_enabled("cpu")


@pytest.mark.parametrize("phase", ["0", "1"])
def test_strided_convolution2d_routes_through_conv_grad(monkeypatch, phase):
    # Convolution2D's strided convs go through conv_grad, as the
    # reference's do; its stride-1 convs stay plain
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
    monkeypatch.setenv("ZOO_TPU_PHASE_BWD", phase)
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(2, 9, 9, 3).astype(np.float32))
    for stride, calls in ((2, 1), (1, 0)):
        lyr = TL.Convolution2D(4, 3, 3, subsample=stride,
                               border_mode="same")
        params = lyr.init(torch.Generator().manual_seed(0), (9, 9, 3))
        before = dict(tcg.invocations)
        k = params["kernel"].clone().requires_grad_()
        y = lyr.call({**params, "kernel": k}, x)
        (dk,) = torch.autograd.grad(y.square().sum(), k)
        assert tcg.invocations["conv2d"] - before["conv2d"] == calls
        yr = _torch_ref(x, k, stride, "SAME") + params["bias"]
        (dkr,) = torch.autograd.grad(yr.square().sum(), k)
        np.testing.assert_allclose(y.detach().numpy(), yr.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dk.numpy(), dkr.numpy(), rtol=1e-5,
                                   atol=1e-4)
