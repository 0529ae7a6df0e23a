"""The PyTorch port's CUDA kernels against their plain PyTorch versions
on the card (``analytics_zoo_tpu_torch.ops.conv_bn``).

Every test here needs a CUDA card: it carries the ``cuda`` marker and
skips where there is none (the card is looked for inside the fixture).
This file imports no JAX, so it runs on a machine that has none
(``--noconftest`` skips tests/conftest.py, which imports JAX):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: f32 rtol/atol 1e-4 for the 1x1 fold and atol 1e-3 for the
3x3 (sums in another order, TF32 off); 2e-2 wherever a bf16 operand or
output is involved (one bf16 rounding, 2^-8 relative).
"""

import pytest
import torch

from analytics_zoo_tpu_torch.ops import conv_bn as tcb


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,w_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16"), ("float32", "bfloat16")])
def test_matmul_kernel_matches_plain_on_card(cuda, dtype, w_dtype):
    g = torch.Generator().manual_seed(0)
    m, k, n = 100, 128, 256
    x = torch.randn(m, k, generator=g).to(cuda, getattr(torch, dtype))
    w = (torch.randn(k, n, generator=g) * 0.1).to(
        cuda, getattr(torch, w_dtype))
    vec = {name: (torch.rand(size, generator=g) + 0.5).to(cuda)
           for name, size in (("in_scale", k), ("in_shift", k),
                              ("out_scale", n), ("out_shift", n))}
    r = torch.randn(m, n, generator=g).to(cuda, x.dtype)
    before = tcb.launches["matmul_bn_apply"]
    y = tcb.matmul_bn_apply(x, w, residual=r, relu_in=True, relu_out=True,
                            **vec)
    torch.cuda.synchronize()
    assert tcb.launches["matmul_bn_apply"] == before + 1
    want = tcb.matmul_bn_apply_ref(x, w, vec["in_scale"], vec["in_shift"],
                                   vec["out_scale"], vec["out_shift"], r,
                                   True, True, True)
    tol = 1e-4 if "bfloat16" not in (dtype, w_dtype) else 2e-2
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,stride", [((2, 8, 8, 64), 1),
                                          ((2, 8, 8, 64), 2),
                                          ((2, 7, 7, 64), 2)])
def test_conv3x3_kernel_matches_plain_on_card(cuda, dtype, shape, stride):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(*shape, generator=g).to(cuda, getattr(torch, dtype))
    w = (torch.randn(3, 3, 64, 128, generator=g) * 0.1).to(cuda)
    s = (torch.rand(64, generator=g) + 0.5).to(cuda)
    t = (torch.randn(64, generator=g) * 0.1).to(cuda)
    before = tcb.launches["conv3x3_bn_apply"]
    y = tcb.conv3x3_bn_apply(x, w, in_scale=s, in_shift=t, relu_in=True,
                             relu_out=True, stride=stride)
    torch.cuda.synchronize()
    assert tcb.launches["conv3x3_bn_apply"] == before + 1
    ones = torch.ones(128, device=cuda)
    want = tcb.conv3x3_bn_apply_ref(x, w, s, t, ones, ones * 0, True, True,
                                    True, stride)
    tol = dict(rtol=1e-4, atol=1e-3) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(y.float(), want.float(), **tol)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(64, 128, device=cuda)[:, ::2]      # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        tcb.matmul_bn_apply(x, torch.zeros(64, 64, device=cuda))
    with pytest.raises(TypeError, match="dtype"):
        tcb.matmul_bn_apply(torch.zeros(64, 64, device=cuda,
                                        dtype=torch.float16),
                            torch.zeros(64, 64, device=cuda))


# -- training kernels: B1 (matmul_bn), B2 (conv3x3_bn), B3 (dx), B4 (dW) ------

def _close(got, want, dtype):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = max(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,affine,residual", [
    (1, True, True), (1, False, False), (2, False, False)])
def test_matmul_bn_kernels_match_plain_on_card(cuda, dtype, stride, affine,
                                               residual):
    # B1 forward and B3/B4 backward on a ragged M (7x7 at stride 1 or 2)
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(2)
    b, h, w, k, n = 3, 7, 7, 128, 64
    ho = -(-h // stride)
    m = b * ho * ho
    x4 = torch.randn(b, h, w, k, generator=g).to(cuda, dt)
    wt = (torch.randn(k, n, generator=g) * 0.1).to(cuda, dt)
    s = (torch.rand(k, generator=g) + 0.5).to(cuda) if affine else None
    t = (torch.randn(k, generator=g) * 0.1).to(cuda) if affine else None
    r = torch.randn(m, k, generator=g).to(cuda, dt) if residual else None
    sh = (torch.randn(n, generator=g) * 0.1).to(cuda)
    before = dict(tcb.launches)
    y, ssum, ssq = tcb._matmul_bn_fwd(x4, wt, s, t, r, sh, stride, affine,
                                      affine)
    x2 = x4[:, ::stride, ::stride].reshape(m, k).contiguous()
    want = tcb.matmul_bn_ref(x2, wt, s, t, r, sh, affine, affine)
    for a, b_ in zip((y.reshape(m, n), ssum, ssq), want):
        _close(a, b_, dt)
    yy = torch.randn(m, n, generator=g).to(cuda, dt)
    dy = torch.randn(m, n, generator=g).to(cuda, dt)
    dsum = (torch.randn(n, generator=g) * 0.1).to(cuda)
    dsq = (torch.randn(n, generator=g) * 0.01).to(cuda)
    grads = (yy, dy, dsum, dsq, affine, affine)
    got = tcb._matmul_bn_dx(x2, wt, s, t, r, sh, *grads)
    want = tcb.matmul_bn_dx_ref(x2, wt, s, t, r, sh, *grads)
    for a, b_ in zip(got, want):
        assert (a is None) == (b_ is None)
        if a is not None:
            _close(a, b_, dt)
    _close(tcb._matmul_bn_dw(x2, s, t, r, sh, *grads),
           tcb.matmul_bn_dw_ref(x2, s, t, r, sh, *grads), dt)
    torch.cuda.synchronize()
    for name in ("matmul_bn", "matmul_bn_dx", "matmul_bn_dw"):
        assert tcb.launches[name] == before[name] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,stride", [((2, 8, 8, 64), 1),
                                          ((2, 8, 8, 64), 2),
                                          ((3, 7, 7, 64), 2)])
def test_conv3x3_bn_kernel_matches_plain_on_card(cuda, dtype, shape, stride):
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(*shape, generator=g).to(cuda, dt)
    w = (torch.randn(3, 3, 64, 128, generator=g) * 0.05).to(cuda)
    s = (torch.rand(64, generator=g) + 0.5).to(cuda)
    t = (torch.randn(64, generator=g) * 0.1).to(cuda)
    sh = (torch.randn(128, generator=g) * 0.1).to(cuda)
    before = tcb.launches["conv3x3_bn"]
    got = tcb._conv3x3_bn_fwd(x, w, s, t, sh, True, True, stride)
    want = tcb.conv3x3_bn_ref(x, w, s, t, sh, True, True, stride)
    torch.cuda.synchronize()
    assert tcb.launches["conv3x3_bn"] == before + 1
    for a, b_ in zip(got, want):
        _close(a, b_, dt)


@pytest.mark.cuda
def test_training_kernels_repeat_bit_for_bit(cuda):
    # fixed-order cross-block sums: no atomics, the same bits every run
    g = torch.Generator().manual_seed(4)
    x = torch.randn(4, 28, 28, 256, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(256, 64, generator=g) * 0.05).to(cuda, torch.bfloat16)
    sh = torch.zeros(64, device=cuda)
    a = tcb._matmul_bn_fwd(x, w, None, None, None, sh, 1, False, False)
    b = tcb._matmul_bn_fwd(x, w, None, None, None, sh, 1, False, False)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    x2 = x.reshape(-1, 256)
    dy = torch.randn(x2.shape[0], 64, generator=g).to(cuda, torch.bfloat16)
    args = (None, None, None, sh, a[0].reshape(-1, 64), dy, sh, sh, False,
            False)
    assert torch.equal(tcb._matmul_bn_dw(x2, *args),
                       tcb._matmul_bn_dw(x2, *args))


@pytest.mark.cuda
def test_fused_ops_backward_on_card_matches_cpu(cuda):
    # the autograd Functions on the card (B1-B4 and the cuDNN 3x3
    # backward) against the same graph on the CPU's plain versions
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 8, 8, 64, generator=g)
    w1 = torch.randn(64, 64, generator=g) * 0.1
    w3 = torch.randn(3, 3, 64, 64, generator=g) * 0.05
    c = torch.randn(2, 8, 8, 64, generator=g)

    def run(dev):
        xs = x.to(dev).requires_grad_(True)
        ws = [w.to(dev).requires_grad_(True) for w in (w1, w3)]
        y1, s1, q1 = tcb.conv1x1_bn(xs, ws[0])
        scale = torch.rsqrt(q1 / 128 - (s1 / 128) ** 2 + 1e-3)
        y2, s2, q2 = tcb.conv3x3_bn(y1, ws[1], in_scale=scale,
                                    in_shift=-s1 / 128 * scale,
                                    relu_in=True)
        loss = (y2 * c.to(dev)).sum() + s2.sum() + q2.sum() * 1e-3
        return [t.cpu() for t in
                torch.autograd.grad(loss, [xs] + ws)]
    for a, b in zip(run(cuda), run(torch.device("cpu"))):
        _close(a, b, torch.float32)
