"""The PyTorch port's CUDA kernels against their plain PyTorch versions
on the card (``analytics_zoo_tpu_torch.ops.conv_bn`` and
``analytics_zoo_tpu_torch.ops.flash_attention``, the decode kernel B11
included).

Every test here needs a CUDA card: it carries the ``cuda`` marker and
skips where there is none (the card is looked for inside the fixture).
This file imports no JAX, so it runs on a machine that has none
(``--noconftest`` skips tests/conftest.py, which imports JAX):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

B2 and B4 alone (their bf16 wgmma kernels and f32 templates):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py \
        -k "conv3x3_bn or dw"

B1 and B5 alone (the 1x1 forward kernels and their routes):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py \
        -k "b1_ or b5_"

The flash-attention kernels alone (B7-B11):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py \
        -k "flash"

Tolerances: f32 rtol/atol 1e-4 for the 1x1 fold and atol 1e-3 for the
3x3 (sums in another order, TF32 off); 2e-2 wherever a bf16 operand or
output is involved (one bf16 rounding, 2^-8 relative). The flash
kernels (B7-B10) are held within 1e-3 (f32) or 2e-2 (bf16) of each
output's own max|plain|, with no floor (attention's outputs and
gradients are far below 1), the bounds chip_smoke.py uses: f32 sums in
another order, and in bf16 p is rounded at the running row max on the
card and at the final one in the plain version. The f32 backward (B9,
B10: three tf32 passes) is also held to its plain version run in
float64: its max|error| at most twice the f32 plain version's plus one
f32 ulp of the output's max, plain TF32 the control that fails. The
decode kernel (B11) is held to the same bounds, read in place through
a page table against gather_layer + dequantize_rows + its plain
version, and must repeat bit for bit; a decode step of a small GPT
stack on the card to the same step on the CPU, and a 12-block stack's
step (no page-table gather) to its dense route, within 1e-4 of
max|logit| (products and sums in another order, TF32 off). B5's f32
product (three tf32 passes) is also held to the fold in float64 from
the same inputs: its max|error| at most twice that of the plain
version, cuBLAS f32 with TF32 off; with a bf16 x, whose y is rounded
to bf16, it must round y as cuBLAS f32 does (counted against the fold
in float64, beside plain TF32 as the control that fails that count).
"""

import os
import re
import time

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops import conv_bn as tcb
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.ops.cuda_build import last_kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# How a torch.profiler window lost kernels it launched on the card
# (scripts/profiler_windows.py reproduces the first two):
# - the profiler keeps a device activity only where it lies inside the
#   window on the host's clock, and the card's timestamps stray from it
#   by up to 5 ms, so a window that closed right after its synchronize
#   lost them now and then: the window is padded by _PAD_S each side;
# - with CUPTI kept attached between sessions (TEARDOWN_CUPTI=0, which
#   this file's fixture used to set), windows after the thousands of
#   launches between two route tests lost kernels: Kineto's default,
#   CUPTI torn down after each session, is kept;
# - the first window of the B5 route test (one f32 fold launch) recorded
#   its launch call and CUPTI's "Activity Buffer Request" but not the
#   kernel, in every whole-file run, unless a kernel of the window's own
#   ran first: the window opens with a short spin kernel.
# - where the libraries were compiled inside the test process, each at
#   its first use between tests (a cold build directory), the first
#   windows of the B7/B8 and B1/B5 route tests recorded no kernel all
#   the same: every library is built (one nvcc each, all together) and
#   loaded before the first test, and a first window is opened and
#   closed then (_libraries_built).
# The route tests read each library's own record of its last launch too.
_PAD_S = 0.1


@pytest.fixture(scope="session", autouse=True)
def _libraries_built():
    """Every kernel library built and loaded, and one profiler window
    opened and closed on the card, before the first test (nothing
    without a card)."""
    if not torch.cuda.is_available():
        return
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.ops import cuda_build
    names = list(tcb._SIGNATURES) + list(tfa._SIGNATURES)
    cuda_build.build(names)
    for name in names:
        cuda_build.load(name)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def _profiled_names(dev, fn):
    """The names of the kernels ``fn`` launches on the card, from one
    ``torch.profiler`` window after a warm call (a first launch loads the
    kernel's module). The route tests also read each library's own
    record of what it launched last (``last_kernel``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(_PAD_S)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(dev)
        fn()
        torch.cuda.synchronize(dev)
        time.sleep(_PAD_S)
    return " ".join(e.key for e in prof.key_averages())


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
    # B2's y and statistics (bf16: the wgmma kernel, many M tiles)
    w3 = (torch.randn(3, 3, 256, 128, generator=g) * 0.02).to(cuda)
    s = (torch.rand(256, generator=g) + 0.5).to(cuda)
    t = (torch.randn(256, generator=g) * 0.1).to(cuda)
    sh3 = (torch.randn(128, generator=g) * 0.1).to(cuda)
    a = tcb._conv3x3_bn_fwd(x, w3, s, t, sh3, True, True, 1)
    b = tcb._conv3x3_bn_fwd(x, w3, s, t, sh3, True, True, 1)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    # B4 with the affine and a residual over several splits
    r = torch.randn(x2.shape[0], 256, generator=g).to(cuda, torch.bfloat16)
    y = a[0].reshape(-1, 128)
    dy = torch.randn(x2.shape[0], 128, generator=g).to(cuda, torch.bfloat16)
    args = (s, t, r, sh3, y, dy, sh3 * 0.5, sh3 * 0.1, True, True)
    assert torch.equal(tcb._matmul_bn_dw(x2, *args),
                       tcb._matmul_bn_dw(x2, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [64, 128, 256, 512])
@pytest.mark.parametrize("b,h,w,stride", [(3, 7, 7, 1), (2, 14, 14, 1),
                                          (2, 10, 10, 2), (3, 9, 9, 2)])
def test_conv3x3_bn_widths_match_plain_on_card(cuda, dtype, channels, b, h,
                                               w, stride):
    # B2 at every ResNet width (bf16: the wgmma kernel's 64- and 128-wide
    # tiles, f32: the FMA template) on ragged M, strides 1 and 2 at even
    # and odd extents
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(16)
    c = channels
    x = torch.randn(b, h, w, c, generator=g).to(cuda, dt)
    wt = (torch.randn(3, 3, c, c, generator=g) * (9 * c) ** -0.5).to(cuda)
    s = (torch.rand(c, generator=g) + 0.5).to(cuda)
    t = (torch.randn(c, generator=g) * 0.1).to(cuda)
    sh = (torch.randn(c, generator=g) * 0.1).to(cuda)
    before = tcb.launches["conv3x3_bn"]
    got = tcb._conv3x3_bn_fwd(x, wt, s, t, sh, True, True, stride)
    want = tcb.conv3x3_bn_ref(x, wt, s, t, sh, True, True, stride)
    torch.cuda.synchronize()
    assert tcb.launches["conv3x3_bn"] == before + 1
    for a, b_ in zip(got, want):
        _close(a, b_, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(64, 64), (64, 256), (256, 64),
                                 (1024, 256), (512, 2048), (2048, 512)])
@pytest.mark.parametrize("affine,residual", [(True, True), (False, False),
                                             (True, False), (False, True)])
def test_matmul_bn_dw_tiles_match_plain_on_card(cuda, dtype, k, n, affine,
                                                residual):
    # B4 at each tile shape (BK and BN of 64 or 128) on a ragged M of 700
    # rows over several splits, with and without the affine and residual
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(17)
    m = 700
    x = torch.randn(m, k, generator=g).to(cuda, dt)
    s = (torch.rand(k, generator=g) + 0.5).to(cuda) if affine else None
    t = (torch.randn(k, generator=g) * 0.1).to(cuda) if affine else None
    r = torch.randn(m, k, generator=g).to(cuda, dt) if residual else None
    sh = (torch.randn(n, generator=g) * 0.1).to(cuda)
    y = torch.randn(m, n, generator=g).to(cuda, dt)
    dy = torch.randn(m, n, generator=g).to(cuda, dt)
    dsum = (torch.randn(n, generator=g) * 0.1).to(cuda)
    dsq = (torch.randn(n, generator=g) * 0.01).to(cuda)
    grads = (y, dy, dsum, dsq, affine, affine)
    assert tcb.dw_splits(m, k, n, dt)[0] > 1
    before = tcb.launches["matmul_bn_dw"]
    got = tcb._matmul_bn_dw(x, s, t, r, sh, *grads)
    torch.cuda.synchronize()
    assert tcb.launches["matmul_bn_dw"] == before + 1
    _close(got, tcb.matmul_bn_dw_ref(x, s, t, r, sh, *grads), dt)


# ResNet-50's 1x1 train-step shapes at batch 128 as B3 sees them,
# (M, K, N): x2 is (M, K), W (K, N)
B3_SHAPES = [(401408, 64, 64), (401408, 64, 256), (401408, 256, 64),
             (401408, 256, 128), (100352, 256, 512), (100352, 128, 512),
             (100352, 512, 128), (100352, 512, 256), (25088, 512, 1024),
             (25088, 256, 1024), (25088, 1024, 256), (25088, 1024, 512),
             (6272, 1024, 2048), (6272, 512, 2048), (6272, 2048, 512)]


def _dx_inputs(m, k, n, affine, residual, dt, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            dtype)
    x = randn(m, k, dtype=dt)
    w = randn(k, n, scale=k ** -0.5, dtype=dt)
    s = 1.0 + randn(k, scale=0.1) if affine else None
    t = randn(k, scale=0.1) if affine else None
    r = randn(m, k, dtype=dt) if residual else None
    sh = randn(n, scale=0.1)
    return (x, w, s, t, r, sh, randn(m, n, dtype=dt), randn(m, n, dtype=dt),
            randn(n, scale=0.1), randn(n, scale=0.01))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", B3_SHAPES)
@pytest.mark.parametrize("affine,relu,residual", [
    (True, True, False), (True, True, True), (False, False, False),
    (False, True, True)])
def test_matmul_bn_dx_bf16_matches_plain_at_train_shapes(cuda, m, k, n,
                                                         affine, relu,
                                                         residual):
    # B3's wgmma kernel at every train-step shape (its dx_tile there),
    # with and without the affine, the ReLU mask and the residual
    x, w, s, t, r, sh, y, dy, dsum, dsq = _dx_inputs(
        m, k, n, affine, residual, torch.bfloat16, cuda, 19)
    before = tcb.launches["matmul_bn_dx"]
    got = tcb._matmul_bn_dx(x, w, s, t, r, sh, y, dy, dsum, dsq, relu,
                            affine)
    want = tcb.matmul_bn_dx_ref(x, w, s, t, r, sh, y, dy, dsum, dsq, relu,
                                affine)
    torch.cuda.synchronize()
    assert tcb.launches["matmul_bn_dx"] == before + 1
    for a, b_ in zip(got, want):
        assert (a is None) == (b_ is None)
        if a is not None:
            _close(a, b_, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(147, 64, 64), (147, 2048, 512),
                                   (25088, 1024, 256), (6272, 512, 2048)])
@pytest.mark.parametrize("bk", [None, 64, 128, 256])
def test_matmul_bn_dx_bf16_tiles_ragged_and_repeat(cuda, monkeypatch, m, k,
                                                   n, bk):
    # a ragged M (3 images of 7x7), K 64 and K 2048, every tile width the
    # kernel takes, and the same bits on a second run for dx, dr, ds, dt
    if bk is not None:
        if bk > k:
            pytest.skip("the tile is wider than K")
        monkeypatch.setattr(tcb, "dx_tile", lambda k_: bk)
    args = _dx_inputs(m, k, n, True, True, torch.bfloat16, cuda, 20)
    a = tcb._matmul_bn_dx(*args, True, True)
    b = tcb._matmul_bn_dx(*args, True, True)
    want = tcb.matmul_bn_dx_ref(*args, True, True)
    torch.cuda.synchronize()
    for p, q, w_ in zip(a, b, want):
        assert torch.equal(p, q)
        _close(p, w_, torch.bfloat16)


# ResNet-50's 3x3 serving shapes, (H, W, Cin, Cout, stride)
B6_SHAPES = [(56, 56, 64, 64, 1), (56, 56, 128, 128, 2),
             (28, 28, 128, 128, 1), (28, 28, 256, 256, 2),
             (14, 14, 256, 256, 1), (14, 14, 512, 512, 2),
             (7, 7, 512, 512, 1)]


def _fold_inputs(b, h, w, cin, cout, prologue, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            dtype)
    x = randn(b, h, w, cin, dtype=torch.bfloat16)
    wt = randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    s = 1.0 + randn(cin, scale=0.1) if prologue else None
    t = randn(cin, scale=0.1) if prologue else None
    return x, wt, s, t, 1.0 + randn(cout, scale=0.1), randn(cout, scale=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("h,w,cin,cout,stride", B6_SHAPES)
@pytest.mark.parametrize("relu_out,prologue", [(True, False),
                                               (False, True)])
def test_conv3x3_bn_apply_bf16_matches_plain_at_serving_shapes(
        cuda, batch, h, w, cin, cout, stride, relu_out, prologue):
    # B6 on the tile conv3x3_apply_tile picks at serving's batches
    x, wt, s, t, os_, ot = _fold_inputs(batch, h, w, cin, cout, prologue,
                                        cuda, 21)
    fold = dict(in_scale=s, in_shift=t, relu_in=prologue, out_scale=os_,
                out_shift=ot, relu_out=relu_out, stride=stride)
    before = tcb.launches["conv3x3_bn_apply"]
    got = tcb.conv3x3_bn_apply(x, wt, **fold)
    again = tcb.conv3x3_bn_apply(x, wt, **fold)
    want = tcb.conv3x3_bn_apply_ref(x, wt, s, t, os_, ot, prologue,
                                    prologue, relu_out, stride)
    torch.cuda.synchronize()
    assert tcb.launches["conv3x3_bn_apply"] == before + 2
    assert torch.equal(got, again)
    _close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("window,bn", [(True, 128), (True, 64),
                                       (False, 256), (False, 128),
                                       (False, 64)])
@pytest.mark.parametrize("b,h,w,stride", [(3, 7, 7, 1), (2, 14, 14, 1),
                                          (2, 10, 10, 2), (3, 9, 9, 2)])
def test_conv3x3_bn_apply_bf16_every_tile(cuda, monkeypatch, window, bn, b,
                                          h, w, stride):
    # each kernel and tile B6 can be given, forced, on ragged M
    if window and stride != 1:
        pytest.skip("the window kernel takes stride 1 only")
    monkeypatch.setattr(tcb, "conv3x3_apply_tile",
                        lambda *a_: (window, bn))
    x, wt, s, t, os_, ot = _fold_inputs(b, h, w, 256, 256, True, cuda, 22)
    got = tcb.conv3x3_bn_apply(x, wt, in_scale=s, in_shift=t, relu_in=True,
                               out_scale=os_, out_shift=ot, relu_out=True,
                               stride=stride)
    want = tcb.conv3x3_bn_apply_ref(x, wt, s, t, os_, ot, True, True, True,
                                    stride)
    _close(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_bf16_dx_and_fold_run_the_wgmma_kernels(cuda):
    # B3 and B6 dispatch by dtype: bf16 to the sm90 kernels (B6 with the
    # fold epilogue), f32 to the FMA templates; by the profiler and by
    # each library's own record
    names, records = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        args = _dx_inputs(300, 128, 64, True, True, dtype, cuda, 23)
        x, wt, s, t, os_, ot = _fold_inputs(2, 8, 8, 64, 64, False, cuda,
                                            24)
        names[dtype] = _profiled_names(cuda, lambda: (
            tcb._matmul_bn_dx(*args, True, True),
            tcb.conv3x3_bn_apply(x.to(dtype), wt, out_scale=os_,
                                 out_shift=ot, relu_out=True)))
        records[dtype] = (last_kernel("matmul_bn_dx"),
                          last_kernel("conv3x3_bn_apply"))
    assert records[torch.bfloat16][0].startswith("matmul_bn_dx_sm90_kernel<")
    assert re.fullmatch(r"conv3x3_bn(_s1)?_sm90_kernel<\d+, true>",
                        records[torch.bfloat16][1])
    assert records[torch.float32] == ("conv_bn_dx_f32_kernel",
                                      "conv_bn_f32_kernel<float, 3, false>")
    bf, f32 = names[torch.bfloat16], names[torch.float32]
    assert "matmul_bn_dx_sm90_kernel" in bf and "conv_bn_dx_f32" not in bf
    assert re.search(r"conv3x3_bn(_s1)?_sm90_kernel<\d+, true>", bf)
    assert "conv_bn_bf16_kernel" not in bf
    assert "conv_bn_dx_f32_kernel" in f32 and "_sm90_kernel" not in f32
    assert "conv_bn_f32_kernel<float, 3, false>" in f32


@pytest.mark.cuda
def test_bf16_runs_the_wgmma_kernels_and_f32_the_templates(cuda):
    # B2 and B4 dispatch by dtype: bf16 to the sm90 kernels, f32 to the
    # FMA templates; one launch counted per call either way (a warm call
    # and the profiled one); by the profiler and by each library's own
    # record
    g = torch.Generator().manual_seed(18)
    names, records = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(2, 8, 8, 64, generator=g).to(cuda, dtype)
        w = (torch.randn(3, 3, 64, 64, generator=g) * 0.05).to(cuda)
        sh = torch.zeros(64, device=cuda)
        x2 = x.reshape(-1, 64)
        dy = torch.randn(128, 64, generator=g).to(cuda, dtype)
        before = dict(tcb.launches)
        names[dtype] = _profiled_names(cuda, lambda: (
            tcb._conv3x3_bn_fwd(x, w, None, None, sh, False, False, 1),
            tcb._matmul_bn_dw(x2, None, None, None, sh, x2, dy, sh, sh,
                              False, False)))
        assert tcb.launches["conv3x3_bn"] == before["conv3x3_bn"] + 2
        assert tcb.launches["matmul_bn_dw"] == before["matmul_bn_dw"] + 2
        records[dtype] = (last_kernel("conv3x3_bn"),
                          last_kernel("matmul_bn_dw"))
    assert re.fullmatch(r"conv3x3_bn(_s1)?_sm90_kernel<\d+, false>",
                        records[torch.bfloat16][0])
    assert records[torch.bfloat16][1].startswith("matmul_bn_dw_sm90_kernel<")
    assert records[torch.float32] == ("conv_bn_f32_kernel<float, 3, true>",
                                      "conv_bn_dw_f32_kernel")
    bf, f32 = names[torch.bfloat16], names[torch.float32]
    assert re.search(r"conv3x3_bn(_s1)?_sm90_kernel", bf)
    assert "conv_bn_f32_kernel" not in bf
    assert "matmul_bn_dw_sm90_kernel" in bf and "conv_bn_dw_f32" not in bf
    assert "conv_bn_f32_kernel" in f32 and "_sm90_kernel" not in f32
    assert "conv_bn_dw_f32_kernel" in f32


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


# -- flash attention: B7 (fwd), B8 (block partials), B9 (dK dV), B10 (dQ) ----

def _flash_inputs(dt, b, tq, tk, h, d, masked, seed, dev):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = [(torch.randn(b, t, h, d, generator=g) * 0.5).to(dev, dt)
                   for t in (tq, tk, tk, tq)]
    km = None
    if masked:
        km = torch.ones(b, tk)
        km[0, tk // 3:] = 0        # padding at the tail
        km[-1, :] = 0              # a sample that is all padding
        km = km.to(dev)
    return q, k, v, do, km


def _flash_close(got, want, dt):
    # the row max of a row that sees no key (-1e30) must match exactly;
    # the rest within the dtype's bound times max|want| over them
    tol = 1e-3 if dt == torch.float32 else 2e-2
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    dead = w.abs() >= 1e29
    assert torch.equal(g[dead], w[dead])
    g, w = g[~dead], w[~dead]
    if w.numel():
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= tol * scale


FLASH_CASES = [(128, 128, False, False), (128, 256, True, True),
               (256, 128, True, False), (256, 256, False, True),
               (256, 256, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("tq,tk,causal,masked", FLASH_CASES)
def test_flash_kernels_match_plain_on_card(cuda, dtype, d, tq, tk, causal,
                                           masked):
    dt = getattr(torch, dtype)
    q, k, v, do, km = _flash_inputs(dt, 2, tq, tk, 3, d, masked, 6, cuda)
    scale = d ** -0.5
    off = tk - tq
    before = dict(tfa.launches)
    _flash_close(tfa._flash_fwd(q, k, v, km, causal, scale),
                 tfa.flash_fwd_ref(q, k, v, km, causal, scale), dt)
    for off_b in (off, off - 64, tk + 64):   # B8's offset is any int
        got = tfa._block_partials(q, k, v, off_b, causal, scale, km)
        want = tfa.flash_block_ref(q, k, v, km, causal, scale, off_b)
        for a, b_ in zip(got, want):
            _flash_close(a, b_, torch.float32 if dt == torch.float32 else dt)
    _, m, l = tfa.flash_block_ref(q, k, v, km, causal, scale, off)
    out = tfa.flash_fwd_ref(q, k, v, km, causal, scale)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, km, m, l, delta, causal, scale, off)
    for a, b_ in zip(tfa._backward("flash_bwd_dkdv", *args),
                     tfa.flash_bwd_dkdv_ref(*args)):
        _flash_close(a, b_, dt)
    _flash_close(tfa._backward("flash_bwd_dq", *args),
                 tfa.flash_bwd_dq_ref(*args), dt)
    torch.cuda.synchronize()
    after = dict(tfa.launches)
    assert [after[n] - before[n] for n in
            ("flash_fwd", "flash_block", "flash_bwd_dkdv",
             "flash_bwd_dq")] == [1, 3, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_repeat_bit_for_bit(cuda, dtype):
    # every block owns its output tile: no atomics, the same bits
    dt = getattr(torch, dtype)
    q, k, v, do, km = _flash_inputs(dt, 2, 256, 256, 4, 64, True, 7, cuda)
    runs = []
    for _ in range(2):
        qs, ks, vs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = tfa.flash_attention(qs, ks, vs, causal=True, key_mask=km)
        out.backward(do)
        with torch.no_grad():
            o7 = tfa.flash_attention(q, k, v, causal=True, key_mask=km)
        runs.append([out, o7, qs.grad, ks.grad, vs.grad])
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_routes_and_reads_in_place_on_card(cuda, dtype):
    # q, k, v as column slices of one fused projection (read through
    # their strides); grad mode runs B8 + B9 + B10, no grad B7 only
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(8)
    b, t, h, d = 2, 256, 4, 64
    qkv = (torch.randn(b, t, 3 * h * d, generator=g) * 0.5).to(cuda, dt)
    qkv.requires_grad_(True)
    q, k, v = [x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1)]
    before = dict(tfa.launches)
    out = tfa.flash_attention(q, k, v)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    delta = {n: tfa.launches[n] - before[n] for n in before}
    assert delta == {"flash_fwd": 0, "flash_block": 1, "flash_bwd_dkdv": 1,
                     "flash_bwd_dq": 1, "flash_decode": 0}
    ref_in = qkv.detach().cpu().float().requires_grad_(True)
    rq, rk, rv = [x.reshape(b, t, h, d).to(dt)
                  for x in ref_in.split(h * d, dim=-1)]
    ref = tfa.flash_attention(rq, rk, rv)
    ref.float().square().sum().backward()
    _flash_close(out.cpu(), ref, dt)
    _flash_close(qkv.grad.cpu().float(), ref_in.grad,
                 torch.float32 if dt == torch.float32 else dt)
    with torch.no_grad():
        before = dict(tfa.launches)
        tfa.flash_attention(q, k, v)
        assert tfa.launches["flash_fwd"] == before["flash_fwd"] + 1
        assert tfa.launches["flash_block"] == before["flash_block"]


def _flash_bwd_case(dt, b, tq, tk, h, d, causal, km, seed, dev):
    """Inputs of B9/B10 with the plain forward's row statistics."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = [(torch.randn(b, t, h, d, generator=g) * 0.5).to(dev, dt)
                   for t in (tq, tk, tk, tq)]
    scale = d ** -0.5
    off = tk - tq
    _, m, l = tfa.flash_block_ref(q, k, v, km, causal, scale, off)
    out = tfa.flash_fwd_ref(q, k, v, km, causal, scale)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, do, km, m, l, delta, causal, scale, off)


def _flash_bwd_close(args, dt):
    for a, b_ in zip(tfa._backward("flash_bwd_dkdv", *args),
                     tfa.flash_bwd_dkdv_ref(*args)):
        _flash_close(a, b_, dt)
    _flash_close(tfa._backward("flash_bwd_dq", *args),
                 tfa.flash_bwd_dq_ref(*args), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(256, 256), (128, 384)])
def test_flash_bwd_dead_key_tiles_match_plain_on_card(cuda, dtype, d, causal,
                                                      tq, tk):
    # samples of length 0, 1, 63, 64, 65, 129 and Tk: whole 64-key tiles
    # dead (B10 skips them; B9 skips them against query tiles with no
    # row of m = -1e30), a sample that is all padding (its uniform p
    # still feeds dV), causal and a cross length
    dt = getattr(torch, dtype)
    lens = (0, 1, 63, 64, 65, 129, tk)
    km = torch.ones(len(lens), tk)
    for i, n in enumerate(lens):
        km[i, n:] = 0
    args = _flash_bwd_case(dt, len(lens), tq, tk, 2, d, causal, km.to(cuda),
                           21, cuda)
    _flash_bwd_close(args, dt)
    dk = tfa._backward("flash_bwd_dkdv", *args)[0]
    for i, n in enumerate(lens):
        assert float(dk[i, n:].abs().max() if n < tk else 0.0) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_bwd_dkdv", "flash_bwd_dq"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_bwd_every_route_and_tile_on_card(cuda, name, dtype, d):
    # the library runs the route and tile the wrapper names (bwd_route,
    # bwd_tile, bwd_smem), and each instance matches the plain version
    # over several tiles of both sides with a padding mask
    dt = getattr(torch, dtype)
    assert tfa.bwd_config_on_card(name, d, dt) == (
        tfa.bwd_route(d, dt).startswith("wgmma"), *tfa.bwd_tile(name, d, dt),
        tfa.bwd_smem(name, d, dt))
    km = torch.ones(2, 512)
    km[1, 300:] = 0
    args = _flash_bwd_case(dt, 2, 512, 512, 3, d, False, km.to(cuda), 22,
                           cuda)
    got = tfa._backward(name, *args)
    want = (tfa.flash_bwd_dkdv_ref if name == "flash_bwd_dkdv" else
            tfa.flash_bwd_dq_ref)(*args)
    for a, b_ in zip(*[(x,) if not isinstance(x, tuple) else x
                       for x in (got, want)]):
        _flash_close(a, b_, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,mask", [(16, 512, "lengths"), (32, 128, "ones")])
def test_flash_bwd_f32_within_twice_f32_error_of_float64(cuda, b, t, mask):
    # the f32 kernels multiply in three tf32 passes: against the plain
    # version run in float64 on the same inputs (q, k, v column slices of
    # one projection, as BERT has them), each output's max|error| is at
    # most twice the f32 plain version's (TF32 off) plus one f32 ulp of
    # its max|float64|; plain TF32 is the control that fails it
    h, d = 12, 64
    g = torch.Generator().manual_seed(23)
    qkv = (torch.randn(b, t, 3 * h * d, generator=g) * 0.5).to(cuda)
    q, k, v = [x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1)]
    do = (torch.randn(b, t, h, d, generator=g) * 0.5).to(cuda)
    km = torch.ones(b, t)
    if mask == "lengths":
        lens = torch.randint(128, t + 1, (b,), generator=g)
        lens[0] = t
        for i, n in enumerate(lens.tolist()):
            km[i, n:] = 0
    km = km.to(cuda)
    scale = d ** -0.5
    _, m, l = tfa.flash_block_ref(q, k, v, km, False, scale, 0)
    out = tfa.flash_fwd_ref(q, k, v, km, False, scale)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, km, m, l, delta, False, scale, 0)
    for name, ref in (("flash_bwd_dkdv", tfa.flash_bwd_dkdv_ref),
                      ("flash_bwd_dq", tfa.flash_bwd_dq_ref)):
        got = tfa._backward(name, *args)
        plain = ref(*args)
        exact = ref(*args, compute=torch.float64)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = ref(*args)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        outs = [x if isinstance(x, tuple) else (x,)
                for x in (got, plain, exact, tf32)]
        for a, p_, r, t_ in zip(*outs):
            e_k, e_p, e_t = ((x.double() - r).abs().max().item()
                             for x in (a, p_, t_))
            limit = 2 * e_p + 2.0 ** -23 * r.abs().max().item()
            assert e_k <= limit, (name, e_k, e_p)
            assert e_t > limit, (name, e_t, e_p)


@pytest.mark.cuda
def test_flash_dead_rows_are_zero_on_card(cuda):
    # causal Tq > Tk: rows 0 .. Tq - Tk - 1 see no key: 0 out, 0 grad
    q, k, v, do, _ = _flash_inputs(torch.float32, 1, 256, 128, 2, 32, False,
                                   9, cuda)
    qs = q.clone().requires_grad_(True)
    out = tfa.flash_attention(qs, k, v, causal=True)
    out.backward(do)
    assert out[:, :128].abs().max().item() == 0.0
    assert qs.grad[:, :128].abs().max().item() == 0.0
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v, causal=True)[:, :128].abs() \
            .max().item() == 0.0


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 128, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        tfa._flash_fwd(q, q, q, None, False, 1.0)
    q = torch.zeros(1, 128, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tfa._flash_fwd(q, q, q, None, False, 1.0)


@pytest.mark.cuda
def test_flash_attention_pads_other_head_dims_on_card(cuda):
    # D = 48 is supported (D <= 256): the wrapper zero-pads the head dim
    # to the next kernel size (64), which changes no dot product
    g = torch.Generator().manual_seed(10)
    q, k, v = [(torch.randn(1, 128, 2, 48, generator=g) * 0.5)
               for _ in range(3)]
    qs = q.to(cuda).requires_grad_(True)
    out = tfa.flash_attention(qs, k.to(cuda), v.to(cuda), causal=True)
    out.square().sum().backward()
    qc = q.clone().requires_grad_(True)
    ref = tfa.flash_attention(qc, k, v, causal=True)
    ref.square().sum().backward()
    _flash_close(out.cpu(), ref.detach(), torch.float32)
    _flash_close(qs.grad.cpu(), qc.grad, torch.float32)


# -- the forward, B7 and B8: routes, tiles, offsets, chip_smoke's shapes ------

def _chip_smoke():
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_cases", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fwd_close(q, k, v, km, causal, scale, off, dt):
    """B7 and B8 (at offset ``off``) against their plain versions; the
    outputs, for repeats."""
    o = tfa._flash_fwd(q, k, v, km, causal, scale)
    _flash_close(o, tfa.flash_fwd_ref(q, k, v, km, causal, scale), dt)
    part = tfa._block_partials(q, k, v, off, causal, scale, km)
    for a, b_ in zip(part, tfa.flash_block_ref(q, k, v, km, causal, scale,
                                               off)):
        _flash_close(a, b_, torch.float32 if dt == torch.float32 else dt)
    return (o, *part)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_fwd", "flash_block"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_fwd_every_route_and_tile_on_card(cuda, name, dtype, d):
    # the library runs the route and tile the wrapper names (fwd_route,
    # fwd_tile, fwd_smem), and each instance matches the plain version
    # over several query and key tiles with padding, causal or not
    dt = getattr(torch, dtype)
    assert tfa.fwd_config_on_card(name, d, dt) == (
        tfa.fwd_route(d, dt).startswith("wgmma"), *tfa.fwd_tile(name, d, dt),
        tfa.fwd_smem(name, d, dt))
    km = torch.ones(3, 512)
    km[1, 300:] = 0
    km[2, 65:] = 0
    q, k, v, _, _ = _flash_inputs(dt, 3, 512, 512, 3, d, False, 24, cuda)
    for causal in (False, True):
        _fwd_close(q, k, v, km.to(cuda), causal, d ** -0.5, 0, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_block_at_runtime_offsets_on_card(cuda, dtype, d, masked):
    # B8's causal offset is any int: rows that see no key (-128), a
    # diagonal inside the keys (64), every key visible (Tk + 1)
    dt = getattr(torch, dtype)
    q, k, v, _, km = _flash_inputs(dt, 2, 256, 384, 3, d, masked, 25, cuda)
    for off in (-128, 64, 384 + 1):
        got = tfa._block_partials(q, k, v, off, True, d ** -0.5, km)
        want = tfa.flash_block_ref(q, k, v, km, True, d ** -0.5, off)
        for a, b_ in zip(got, want):
            _flash_close(a, b_, torch.float32 if dt == torch.float32 else dt)
        if off < 0:      # rows 0 .. -off - 1 see no key
            assert float(got[0][:, :-off].abs().max()) == 0.0
            assert bool((got[1][..., :-off] == -1e30).all())
            assert float(got[2][..., :-off].abs().max()) == 0.0


def _smoke_fwd_cases():
    # chip_smoke.flash_cases() as (B, Tq, Tk, H, D, causal, mask, dtype,
    # strided): decided from the file, not the card
    return [c[1:9] + (c[10],) for c in _chip_smoke().flash_cases()]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _smoke_fwd_cases(),
                         ids=lambda c: "-".join(str(x) for x in c))
def test_flash_fwd_at_chip_smoke_shapes_on_card(cuda, case):
    # both forward kernels at every flash shape chip_smoke runs (the BERT
    # routes, dead key tiles of lengths 0, 1, 63, 64, 65, 129 and T,
    # causal, cross-length, dead-row and head-dim cases), q, k, v read
    # in place where chip_smoke slices them from one projection; a second
    # launch gives the same bits
    b, tq, tk, h, d, causal, mkind, dtype, strided = case
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(26)
    if strided:
        qkv = (torch.randn(b, tq, 3 * h * d, generator=g) * 0.5).to(cuda, dt)
        q, k, v = [t.reshape(b, tq, h, d) for t in qkv.split(h * d, -1)]
    else:
        q, k, v = [(torch.randn(b, t, h, d, generator=g) * 0.5).to(cuda, dt)
                   for t in (tq, tk, tk)]
    km = _chip_smoke()._key_mask(b, tk, mkind, cuda)
    first = _fwd_close(q, k, v, km, causal, d ** -0.5, tk - tq, dt)
    again = (tfa._flash_fwd(q, k, v, km, causal, d ** -0.5),
             *tfa._block_partials(q, k, v, tk - tq, causal, d ** -0.5, km))
    for a, b_ in zip(first, again):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_b7_and_b8_reach_the_kernels_their_routes_name(cuda):
    # D 64 and 128 run the wgmma template (one instance per dtype, D,
    # kernel and tile), D 32 and 256 the old kernels; a warm launch
    # first, then one profiled window per dtype and D
    dtypes = (("float32", "float"), ("bfloat16", "__nv_bfloat16"))
    for dtype, ctype in dtypes:
        dt = getattr(torch, dtype)
        for d in (32, 64, 128, 256):
            q, k, v, _, km = _flash_inputs(dt, 2, 256, 256, 2, d, True, 27,
                                           cuda)
            wgs, _, keys = tfa.fwd_tile("flash_fwd", d, dt)
            if tfa.fwd_route(d, dt).startswith("wgmma"):
                want = [f"flash_fwd_sm90_kernel<{ctype}, {d}, {p}, {wgs}, "
                        f"{keys}>" for p in ("false", "true")]
            else:
                old = "f32" if dtype == "float32" else "bf16"
                want = [f"flash_fwd_{old}_kernel<{d}, {p}>"
                        for p in ("false", "true")]
            names = _profiled_names(cuda, lambda: (
                tfa._flash_fwd(q, k, v, km, False, 0.125),
                tfa._block_partials(q, k, v, 0, False, 0.125, km)))
            assert [last_kernel("flash_fwd"),
                    last_kernel("flash_block")] == want, (dtype, d)
            for w in want:
                assert w in names, (dtype, d, w, names)


# -- flash decode: B11 --------------------------------------------------------

def _decode_inputs(dt, s, t, h, d, lens, seed, dev, strided=False):
    """q as a column slice of a fused projection; k, v contiguous, or
    (``strided``) the K and V halves of one (S, T, 2, H, D) buffer."""
    g = torch.Generator().manual_seed(seed)
    qkv = (torch.randn(s, 3 * h * d, generator=g) * 0.5).to(dev, dt)
    q = qkv[:, :h * d].reshape(s, h, d)
    if strided:
        kv = (torch.randn(s, t, 2, h, d, generator=g) * 0.5).to(dev, dt)
        k, v = kv[:, :, 0], kv[:, :, 1]
    else:
        k, v = [(torch.randn(s, t, h, d, generator=g) * 0.5).to(dev, dt)
                for _ in range(2)]
    km = (torch.arange(t)[None, :] < torch.tensor(lens)[:, None]).to(dev)
    return q, k, v, km


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("t,lens,strided", [
    (128, (17, 128, 1, 0), False), (512, (511, 3, 0, 300), True),
    (2048, (1, 2048, 700, 1500), False)])
def test_flash_decode_kernel_matches_plain_on_card(cuda, dtype, d, t, lens,
                                                   strided):
    # mixed lengths, a slot with no valid key (a uniform average), and
    # q, k, v read through their strides
    dt = getattr(torch, dtype)
    q, k, v, km = _decode_inputs(dt, len(lens), t, 3, d, lens, 11, cuda,
                                 strided)
    assert strided == (not k.is_contiguous())
    before = tfa.launches["flash_decode"]
    got = tfa.flash_decode_attention(q, k, v, km, d ** -0.5)
    torch.cuda.synchronize()
    assert tfa.launches["flash_decode"] == before + 1
    _flash_close(got, tfa.flash_decode_ref(q, k, v, km.float(), d ** -0.5),
                 dt)
    dead = [i for i, n in enumerate(lens) if n == 0]
    for i in dead:
        _flash_close(got[i], v[i].float().mean(0).to(dt), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_int8_cache_and_repeat_on_card(cuda, dtype):
    # int8 views are dequantized by the kernel as it reads them; the
    # groups and the chunks merge in a fixed order, so a second launch
    # gives the same bits
    from analytics_zoo_tpu_torch.ops import kv_cache as tkv
    dt = getattr(torch, dtype)
    q, k, v, km = _decode_inputs(dt, 4, 256, 2, 64, (5, 256, 0, 130), 12,
                                 cuda)
    (kq, ks), (vq, vs) = tkv.quantize_rows(k), tkv.quantize_rows(v)
    got = tfa.flash_decode_attention(q, kq, vq, km, 0.125, k_scales=ks,
                                     v_scales=vs)
    again = tfa.flash_decode_attention(q, kq, vq, km, 0.125, k_scales=ks,
                                       v_scales=vs)
    want = tfa.flash_decode_ref(q, tkv.dequantize_rows(kq, ks, dt),
                                tkv.dequantize_rows(vq, vs, dt),
                                km.float(), 0.125)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _flash_close(got, want, dt)


@pytest.mark.cuda
def test_flash_decode_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, km = _decode_inputs(torch.float32, 2, 200, 2, 64, (3, 4), 13,
                                 cuda)
    with pytest.raises(ValueError, match="divisible by 128"):
        tfa.flash_decode_attention(q, k, v, km, 0.125)
    q, k, v, km = _decode_inputs(torch.float16, 2, 128, 2, 64, (3, 4), 13,
                                 cuda)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_decode_attention(q, k, v, km, 0.125)
    q, k, v, km = _decode_inputs(torch.float32, 2, 128, 2, 64, (3, 4), 13,
                                 cuda)
    with pytest.raises(ValueError):
        tfa.flash_decode_attention(q, k.cpu(), v, km, 0.125)


@pytest.mark.cuda
def test_flash_decode_kernel_reads_a_float_mask_as_bool_on_card(cuda):
    # the kernel reads validity as bool; an f32 0/1 mask is converted
    # (> 0) in the wrapper and gives the bool mask's bits
    q, k, v, km = _decode_inputs(torch.float32, 4, 256, 2, 64,
                                 (17, 256, 0, 129), 14, cuda)
    got = tfa.flash_decode_attention(q, k, v, km.float(), 0.125)
    assert torch.equal(got, tfa.flash_decode_attention(q, k, v, km, 0.125))
    _flash_close(got, tfa.flash_decode_ref(q, k, v, km.float(), 0.125),
                 torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("short", ["table", "lens"])
def test_flash_decode_paged_refuses_short_table_or_lens_on_card(cuda, short):
    # a table or lengths one slot short of q would have the kernel read
    # past them: the wrapper raises before the launch
    q, kp, vp, table, ln, _ = _paged_inputs(torch.float32, "float32", 4, 16,
                                            16, 2, 64, [1, 256, 17, 0], 23,
                                            cuda)
    table, ln = (table[:-1], ln) if short == "table" else (table, ln[:-1])
    before = tfa.launches["flash_decode"]
    with pytest.raises(ValueError, match="one row each"):
        tfa.flash_decode_paged(q, kp, vp, table, ln, 0.125)
    assert tfa.launches["flash_decode"] == before


def _paged_inputs(dt, pool, s, pps, page, h, d, lens, seed, dev):
    """q (a column slice of a fused projection), pools of 3 * s * pps / 2
    pages of ``pool`` (int8 with scales), a permuted table with
    out-of-range ids past each slot's length, and the lengths."""
    from analytics_zoo_tpu_torch.ops import kv_cache as tkv
    g = torch.Generator().manual_seed(seed)
    n_pages = 3 * s * pps // 2
    qkv = (torch.randn(s, 3 * h * d, generator=g) * 0.5).to(dev, dt)
    q = qkv[:, :h * d].reshape(s, h, d)
    kp, vp = [torch.randn(n_pages, page, h, d, generator=g) * 0.5
              for _ in range(2)]
    table = torch.randperm(n_pages, generator=g)[:s * pps].reshape(
        s, pps).to(torch.int32)
    for i, n in enumerate(lens):
        past = -(-n // page) + 1
        if past < pps:
            table[i, past] = n_pages + 5 + i
    scales = {}
    if pool == "int8":
        (kp, ks), (vp, vs) = tkv.quantize_rows(kp), tkv.quantize_rows(vp)
        scales = dict(k_scales=ks.to(dev), v_scales=vs.to(dev))
    else:
        kp, vp = kp.to(getattr(torch, pool)), vp.to(getattr(torch, pool))
    return (q, kp.to(dev), vp.to(dev), table.to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev), scales)


def _paged_plain(q, kp, vp, table, lens, scale, k_scales=None,
                 v_scales=None):
    """The paged plain version: gather_layer, dequantize_rows (or the
    cast to q's type), flash_decode_ref."""
    from analytics_zoo_tpu_torch.ops import kv_cache as tkv
    t = table.shape[1] * kp.shape[1]
    k, v = [tkv.gather_layer(x, table, t) for x in (kp, vp)]
    if k_scales is None:
        k, v = k.to(q.dtype), v.to(q.dtype)
    else:
        k = tkv.dequantize_rows(k, tkv.gather_layer(k_scales, table, t),
                                q.dtype)
        v = tkv.dequantize_rows(v, tkv.gather_layer(v_scales, table, t),
                                q.dtype)
    return tfa.flash_decode_ref(q, k, v, tkv.length_mask(lens, t).float(),
                                scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pool", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("float32", "int8"),
    ("bfloat16", "int8"), ("float32", "bfloat16"), ("bfloat16", "float32")])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_decode_paged_matches_plain_on_card(cuda, dtype, pool, d):
    # the pools read in place through a permuted table, lengths on the
    # chunk edges of the plan (1, chunk - 1, chunk, chunk + 1, T) and a
    # slot with no valid key, which reads every row through clamped ids
    dt = getattr(torch, dtype)
    pps, page, h = 64, 16, 3
    t = pps * page
    chunk, _ = tfa.decode_plan(6, h, t, d, getattr(torch, pool))
    lens = [1, chunk - 1, chunk, chunk + 1, t, 0]
    q, kp, vp, table, ln, sc = _paged_inputs(dt, pool, 6, pps, page, h, d,
                                              lens, 21, cuda)
    before = tfa.launches["flash_decode"]
    got = tfa.flash_decode_paged(q, kp, vp, table, ln, d ** -0.5, **sc)
    torch.cuda.synchronize()
    assert tfa.launches["flash_decode"] == before + 1
    assert got.dtype == dt and got.shape == q.shape
    _flash_close(got, _paged_plain(q, kp, vp, table, ln, d ** -0.5, **sc),
                 dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pool", [("float32", "float32"),
                                        ("bfloat16", "bfloat16"),
                                        ("float32", "int8")])
def test_flash_decode_paged_repeats_bit_for_bit_on_card(cuda, dtype, pool):
    # the generation path's shape (8 slots, T 2048, 12 heads, D 64): the
    # last block of each (slot, head) merges the chunks in chunk order,
    # so every launch gives the same bits
    dt = getattr(torch, dtype)
    lens = [1, 2048, 700, 1500, 17, 255, 257, 0]
    q, kp, vp, table, ln, sc = _paged_inputs(dt, pool, 8, 128, 16, 12, 64,
                                              lens, 22, cuda)
    outs = [tfa.flash_decode_paged(q, kp, vp, table, ln, 0.125, **sc)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    _flash_close(outs[0], _paged_plain(q, kp, vp, table, ln, 0.125, **sc),
                 dt)


@pytest.mark.cuda
def test_flash_decode_plan_is_the_library_s_on_card(cuda):
    for d in (32, 64, 128, 256):
        for kv in (torch.float32, torch.bfloat16, torch.int8):
            assert tfa.decode_config_on_card(d, kv) == \
                (tfa.decode_lanes(d, kv), tfa.decode_keys(d, kv))


@pytest.mark.cuda
def test_decode_step_reads_pages_in_place_on_card(cuda, monkeypatch):
    # a 12-block stack at T 2048 ("auto" takes B11): 12 launches per
    # decode step, no page-table gather of the pools, and the same logits
    # as the dense route
    from analytics_zoo_tpu_torch.bridge import params_from_numpy
    from analytics_zoo_tpu_torch.ops import kv_cache as tkv
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.transformer \
        import TransformerLayer
    kw = dict(n_block=12, hidden_size=128, n_head=2, seq_len=2048, vocab=97,
              hidden_p_drop=0.0, attn_p_drop=0.0, embed_p_drop=0.0)
    net, dense = TransformerLayer(**kw), TransformerLayer(
        attention_impl="xla", **kw)
    params = params_from_numpy(
        net.build(torch.Generator().manual_seed(16), (2048,)), cuda)
    g = torch.Generator().manual_seed(17)
    ids = torch.randint(1, 97, (4, 32), generator=g).to(cuda)
    plens = torch.tensor([32, 5, 17, 0], dtype=torch.int32, device=cuda)
    gathers = []
    real = tkv.gather_layer

    def spy(*a, **k):
        gathers.append(tuple(a[0].shape))
        return real(*a, **k)
    with torch.no_grad():
        cache = net.init_kv_cache(4, 2048, page_size=16, device=cuda)
        cache, lg = net.prefill(params, cache, ids, plens)
        cache_d = cache.clone()
        tok = lg.argmax(-1).to(torch.int32)
        monkeypatch.setattr(tkv, "gather_layer", spy)
        before = tfa.launches["flash_decode"]
        cache, lg = net.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        assert tfa.launches["flash_decode"] - before == 12
        assert gathers == []
        _, lg_d = dense.decode_step(params, cache_d, tok)
        assert len(gathers) == 24      # the dense route gathers K and V
    scale = lg_d.abs().max().item()
    assert (lg - lg_d).abs().max().item() <= 1e-4 * scale


@pytest.mark.cuda
def test_decode_step_through_b11_on_card_matches_cpu(cuda):
    # a small GPT stack's prefill + decode steps on the card ("auto"
    # routes T = 2048 to B11) against the same steps on the CPU
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.transformer \
        import TransformerLayer
    net = TransformerLayer(n_block=2, hidden_size=64, n_head=2,
                           seq_len=2048, vocab=97, hidden_p_drop=0.0,
                           attn_p_drop=0.0, embed_p_drop=0.0)
    from analytics_zoo_tpu_torch.bridge import params_from_numpy
    params = net.build(torch.Generator().manual_seed(14), (2048,))
    on = {"cpu": params, "cuda": params_from_numpy(params, cuda)}
    g = torch.Generator().manual_seed(15)
    ids = torch.randint(1, 97, (3, 16), generator=g)
    plens = torch.tensor([16, 5, 9], dtype=torch.int32)
    logits = {}
    for dev, p in on.items():
        cache = net.init_kv_cache(3, 2048, page_size=16, device=dev)
        with torch.no_grad():
            cache, lg = net.prefill(p, cache, ids.to(dev), plens.to(dev))
            steps = [lg]
            tok = lg.argmax(-1).to(torch.int32)
            before = tfa.launches["flash_decode"]
            for _ in range(3):
                cache, lg = net.decode_step(p, cache, tok)
                steps.append(lg)
                tok = lg.argmax(-1).to(torch.int32)
        logits[dev] = torch.stack(steps).cpu()
        assert tfa.launches["flash_decode"] - before == \
            (6 if dev == "cuda" else 0)
    scale = logits["cpu"].abs().max().item()
    assert (logits["cuda"] - logits["cpu"]).abs().max().item() <= \
        1e-4 * scale


# -- B1 (matmul_bn) and B5 (matmul_bn_apply): the 1x1 forward kernels ------

# ResNet-50's distinct 1x1 train-step shapes at batch 128, (B, H, W, K,
# N, stride): c1 and c3 of each stage, and the downsamples
B1_SHAPES = [(128, 56, 56, 64, 64, 1), (128, 56, 56, 64, 256, 1),
             (128, 56, 56, 256, 64, 1), (128, 56, 56, 256, 128, 1),
             (128, 56, 56, 256, 512, 2), (128, 28, 28, 128, 512, 1),
             (128, 28, 28, 512, 128, 1), (128, 28, 28, 512, 256, 1),
             (128, 28, 28, 512, 1024, 2), (128, 14, 14, 256, 1024, 1),
             (128, 14, 14, 1024, 256, 1), (128, 14, 14, 1024, 512, 1),
             (128, 14, 14, 1024, 2048, 2), (128, 7, 7, 512, 2048, 1),
             (128, 7, 7, 2048, 512, 1)]


def _b1_inputs(b, h, w, k, n, stride, affine, residual, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            dtype)
    m = b * -(-h // stride) * -(-w // stride)
    x4 = randn(b, h, w, k, dtype=torch.bfloat16)
    wt = randn(k, n, scale=k ** -0.5, dtype=torch.bfloat16)
    s = 1.0 + randn(k, scale=0.1) if affine else None
    t = randn(k, scale=0.1) if affine else None
    r = randn(m, k, dtype=torch.bfloat16) if residual else None
    return x4, wt, s, t, r, randn(n, scale=0.1)


def _b1_check(x4, wt, s, t, r, sh, stride, relu, affine):
    """B1 against its plain version (y and both statistics), launched
    twice: one count each, and the same bits."""
    b, h, w, k = x4.shape
    m = b * -(-h // stride) * -(-w // stride)
    before = tcb.launches["matmul_bn"]
    got = tcb._matmul_bn_fwd(x4, wt, s, t, r, sh, stride, relu, affine)
    again = tcb._matmul_bn_fwd(x4, wt, s, t, r, sh, stride, relu, affine)
    want = tcb.matmul_bn_ref(x4[:, ::stride, ::stride].reshape(m, k), wt, s,
                             t, r, sh, relu, affine)
    torch.cuda.synchronize()
    assert tcb.launches["matmul_bn"] == before + 2
    for a, a2, b_ in zip((got[0].reshape(m, -1), got[1], got[2]),
                         (again[0].reshape(m, -1), again[1], again[2]),
                         want):
        assert torch.equal(a, a2)
        _close(a, b_, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,k,n,stride", B1_SHAPES)
@pytest.mark.parametrize("relu,affine,residual", [
    (True, True, False), (False, False, False), (True, True, True),
    (False, True, False)])
def test_b1_bf16_matches_plain_at_train_shapes(cuda, b, h, w, k, n, stride,
                                               relu, affine, residual):
    # B1's wgmma kernel at every train-step shape (its fwd_tile there),
    # with and without the affine, the ReLU and the in_residual; y and
    # the statistics repeat bit for bit
    args = _b1_inputs(b, h, w, k, n, stride, affine, residual, cuda, 30)
    _b1_check(*args, stride, relu, affine)


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [256, 128, 64])
@pytest.mark.parametrize("b,h,w,k,n,stride,residual", [
    (3, 7, 7, 64, 512, 1, False), (3, 7, 7, 2048, 512, 1, False),
    (3, 7, 7, 256, 512, 2, False), (2, 9, 9, 128, 256, 2, False),
    (3, 7, 7, 2048, 512, 1, True)])
def test_b1_bf16_every_tile_ragged(cuda, monkeypatch, bn, b, h, w, k, n,
                                   stride, residual):
    # every tile width B1 can be given, forced, on ragged M (3 images of
    # 7x7; stride 2 at an odd extent); an in_residual takes the 64-wide
    # tile only
    if residual and bn != 64:
        pytest.skip("an in_residual takes the 64-wide tile")
    monkeypatch.setattr(tcb, "fwd_tile", lambda *a_, **kw: bn)
    args = _b1_inputs(b, h, w, k, n, stride, True, residual, cuda, 31)
    _b1_check(*args, stride, True, True)


# ResNet-50's distinct 1x1 serving shapes per image, (H, W, K, N,
# stride, residual, relu): c1, c3 (with the block's residual) and the
# downsamples
B5_SHAPES = [(56, 56, 64, 64, 1, False, True), (56, 56, 64, 256, 1, True,
                                                True),
             (56, 56, 64, 256, 1, False, False),
             (56, 56, 256, 64, 1, False, True),
             (56, 56, 256, 128, 1, False, True),
             (56, 56, 256, 512, 2, False, False),
             (28, 28, 128, 512, 1, True, True),
             (28, 28, 512, 128, 1, False, True),
             (28, 28, 512, 256, 1, False, True),
             (28, 28, 512, 1024, 2, False, False),
             (14, 14, 256, 1024, 1, True, True),
             (14, 14, 1024, 256, 1, False, True),
             (14, 14, 1024, 512, 1, False, True),
             (14, 14, 1024, 2048, 2, False, False),
             (7, 7, 512, 2048, 1, True, True),
             (7, 7, 2048, 512, 1, False, True)]


def _b5_inputs(b, h, w, k, n, stride, residual, prologue, dt, wdt, dev,
               seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            dtype)
    ho, wo = -(-h // stride), -(-w // stride)
    x = randn(b, h, w, k, dtype=dt)
    wt = randn(k, n, scale=k ** -0.5, dtype=wdt)
    fold = dict(in_scale=1.0 + randn(k, scale=0.1) if prologue else None,
                in_shift=randn(k, scale=0.1) if prologue else None,
                relu_in=prologue, out_scale=1.0 + randn(n, scale=0.1),
                out_shift=randn(n, scale=0.1))
    res = randn(b, ho, wo, n, dtype=dt) if residual else None
    return x, wt, res, fold


def _b5_plain(x, wt, stride, res, fold, relu):
    b, h, w, k = x.shape
    ho, wo = -(-h // stride), -(-w // stride)
    m, n = b * ho * wo, wt.shape[1]
    x2 = x[:, ::stride, ::stride].reshape(m, k)
    r2 = None if res is None else res.reshape(m, n)
    pro = fold["relu_in"]
    y = tcb.matmul_bn_apply_ref(x2, wt, fold["in_scale"], fold["in_shift"],
                                fold["out_scale"], fold["out_shift"], r2,
                                pro, pro, relu)
    xd = x2.double()
    if pro:
        xd = torch.relu(xd * fold["in_scale"].double() +
                        fold["in_shift"].double())
    y64 = xd @ wt.double() * fold["out_scale"].double() + \
        fold["out_shift"].double()
    if r2 is not None:
        y64 = y64 + r2.double()
    return y.reshape(b, ho, wo, n), (torch.relu(y64) if relu else y64
                                     ).reshape(b, ho, wo, n)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,k,n,stride,residual,relu", B5_SHAPES)
def test_b5_f32_weights_meet_the_float64_gate(cuda, batch, dtype, h, w, k,
                                              n, stride, residual, relu):
    # B5 with the model's f32 weights at every serving shape and batch,
    # in both activation dtypes, with the residual and ReLU serving runs:
    # within the dtype's bound of the plain version, and against the fold
    # in float64 from the same inputs no worse than twice the plain
    # version's (cuBLAS f32, TF32 off) error
    dt = getattr(torch, dtype)
    x, wt, res, fold = _b5_inputs(batch, h, w, k, n, stride, residual,
                                  False, dt, torch.float32, cuda, 32)
    before = tcb.launches["matmul_bn_apply"]
    got = tcb.conv1x1_bn_apply(x, wt, stride=stride, residual=res,
                               relu_out=relu, **fold)
    want, want64 = _b5_plain(x, wt, stride, res, fold, relu)
    torch.cuda.synchronize()
    assert tcb.launches["matmul_bn_apply"] == before + 1
    assert got.dtype == dt and got.shape == want.shape
    tol = 1e-3 if dt == torch.float32 else 2e-2
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol * scale
    err = (got.double() - want64).abs().max().item()
    err_plain = (want.double() - want64).abs().max().item()
    assert err <= 2 * err_plain


def _bf16_misrounded(y, y64):
    """Elements of the bf16 ``y`` that differ from the fold in float64
    rounded once to bf16."""
    return int((y != y64.float().to(torch.bfloat16)).sum().item())


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,k,n,stride,residual,relu", B5_SHAPES)
def test_b5_bf16_x_f32_weights_round_as_cublas_f32(cuda, h, w, k, n, stride,
                                                   residual, relu):
    # serving's route (bf16 x, f32 weights, no prologue: two tf32
    # passes, A_hi W_hi + A_hi W_lo) at batch 32. Its y is bf16, which
    # hides the product's error from a max|error| gate; so count the
    # elements whose bf16 rounding differs from the float64 fold's: the
    # kernel may misround no more than twice as many as cuBLAS f32 (TF32
    # off), and plain TF32 (the route without its A_hi W_lo pass),
    # misrounding many more, is the control that shows the count bites
    x, wt, res, fold = _b5_inputs(32, h, w, k, n, stride, residual, False,
                                  torch.bfloat16, torch.float32, cuda, 35)
    assert tcb.fold_route(x.dtype, wt.dtype, False) == "tf32x2"
    got = tcb.conv1x1_bn_apply(x, wt, stride=stride, residual=res,
                               relu_out=relu, **fold)
    want, want64 = _b5_plain(x, wt, stride, res, fold, relu)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32, _ = _b5_plain(x, wt, stride, res, fold, relu)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    n_kernel = _bf16_misrounded(got, want64)
    n_f32 = _bf16_misrounded(want, want64)
    n_tf32 = _bf16_misrounded(tf32, want64)
    slack = 8 + got.numel() // 100000
    assert n_kernel <= 2 * n_f32 + slack, (n_kernel, n_f32, n_tf32)
    assert n_tf32 > 2 * n_f32 + slack, (n_kernel, n_f32, n_tf32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,w_dtype", [("float32", "float32"),
                                           ("bfloat16", "float32"),
                                           ("float32", "bfloat16"),
                                           ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("b,h,w,k,n,stride", [(3, 7, 7, 64, 64, 1),
                                              (3, 7, 7, 2048, 512, 1),
                                              (2, 9, 9, 256, 128, 2),
                                              (8, 28, 28, 128, 512, 1)])
def test_b5_prologue_residual_and_bf16_weights(cuda, dtype, w_dtype, b, h,
                                               w, k, n, stride):
    # B5 with a prologue, a residual and the ReLU on ragged M and at
    # stride 2, f32 weights (the three-pass route) and bf16 weights (B1's
    # kernel with the fold epilogue for a bf16 x, the one-pass tf32 route
    # for an f32 x) for either activation dtype
    dt, wdt = getattr(torch, dtype), getattr(torch, w_dtype)
    x, wt, res, fold = _b5_inputs(b, h, w, k, n, stride, True, True, dt,
                                  wdt, cuda, 33)
    got = tcb.conv1x1_bn_apply(x, wt, stride=stride, residual=res,
                               relu_out=True, **fold)
    want, want64 = _b5_plain(x, wt, stride, res, fold, True)
    torch.cuda.synchronize()
    assert got.dtype == dt
    _close(got, want, torch.float32 if "bfloat16" not in (dtype, w_dtype)
           else torch.bfloat16)
    if w_dtype == "float32":
        assert (got.double() - want64).abs().max().item() <= \
            2 * (want.double() - want64).abs().max().item()


@pytest.mark.cuda
def test_b1_and_b5_reach_the_kernels_their_routes_name(cuda):
    # which kernel each dtype pair reaches on the card: B1 in bf16 the
    # wgmma kernel, in f32 the FMA template; B5 by fold_route: f32
    # weights the tf32 split (two passes for a bf16 x without a
    # prologue), bf16 weights B1's kernel with the fold epilogue (bf16
    # x) or the tf32 kernel in one pass (f32 x); the old mma.sync 1x1
    # kernel is gone
    want = {("float32", "float32", False): ("tf32x3",
            "matmul_bn_apply_sm90_kernel<float, float, true>"),
            ("bfloat16", "float32", False): ("tf32x2",
            "matmul_bn_apply_sm90_kernel<__nv_bfloat16, float, false>"),
            ("bfloat16", "float32", True): ("tf32x3",
            "matmul_bn_apply_sm90_kernel<__nv_bfloat16, float, true>"),
            ("float32", "bfloat16", True): ("tf32x1",
            "matmul_bn_apply_sm90_kernel<float, __nv_bfloat16, false>"),
            ("bfloat16", "bfloat16", False): ("bf16",
            "matmul_bn_sm90_kernel<64, true>")}
    for (dtype, w_dtype, prologue), (route, kernel) in want.items():
        dt, wdt = getattr(torch, dtype), getattr(torch, w_dtype)
        assert tcb.fold_route(dt, wdt, prologue) == route
        x, wt, res, fold = _b5_inputs(2, 8, 8, 64, 128, 1, True, prologue,
                                      dt, wdt, cuda, 34)
        names = _profiled_names(cuda, lambda: tcb.conv1x1_bn_apply(
            x, wt, residual=res, **fold))
        assert last_kernel("matmul_bn_apply") == kernel
        assert kernel in names, (dtype, w_dtype, prologue, names)
        assert "conv_bn_bf16_kernel" not in names
    for dtype, kernel in (("bfloat16", "matmul_bn_sm90_kernel<128, false"),
                          ("float32", "conv_bn_f32_kernel<float, 1, true>")):
        dt = getattr(torch, dtype)
        x4 = torch.randn(2, 8, 8, 64, device=cuda).to(dt)
        wt = torch.randn(64, 128, device=cuda).to(dt)
        sh = torch.zeros(128, device=cuda)
        names = _profiled_names(cuda, lambda: tcb._matmul_bn_fwd(
            x4, wt, None, None, None, sh, 1, False, False))
        assert last_kernel("matmul_bn").startswith(kernel)
        assert kernel in names and "conv_bn_bf16_kernel" not in names


# -- the Estimator's input path on the card -----------------------------------

def _placed_batches(ds, dev, depth, fdt, batch, epochs):
    from analytics_zoo_tpu_torch.pipeline import estimator as em
    out = []
    for epoch in range(1, epochs + 1):
        place = em._CardPlacer(dev, depth, fdt)
        items = ((ds, sel) for sel in ds.iter_indices(batch, shuffle=True,
                                                      seed=epoch))
        it = em._prefetch_iter(items, place, depth)
        try:
            for b in it:
                assert isinstance(b[2], torch.cuda.Event)
                x, y = place.take(b)
                assert torch.cuda.current_stream(dev) != place.stream
                out.append(([t.clone() for t in em._flat(x)],
                            [t.clone() for t in em._flat(y)]))
        finally:
            it.close()
        assert all(buf.is_pinned() for ring in place._ring.values()
                   for buf in ring)
        assert len(next(iter(place._ring.values()))) == max(depth, 0) + 1
    return out


def _special_f32(rs, n):
    """n random f32 bit patterns with NaN, the infinities, f32
    subnormals and bf16 rounding ties among them."""
    u = np.concatenate([
        rs.randint(0, 2 ** 32, size=n, dtype=np.uint64),
        (rs.randint(0, 2 ** 16, size=n // 8, dtype=np.uint64) << 16) |
        0x8000,
        np.arange(0, 2 ** 16, 2 ** 16 // (n // 8), dtype=np.uint64),
        np.array([0x7F7FFFFF, 0x7F7F8000, 0xFF7F8000, 0x7F800000,
                  0xFF800000, 0x7FC00000, 0xFFC00001, 0x7F800001,
                  0xFFFFFFFF, 0x80000000, 0], dtype=np.uint64)])
    return u[rs.permutation(len(u))[:n]].astype(np.uint32).view(np.float32)


def _same_bits(a, b):
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    if a.dtype != b.dtype or a.device != b.device or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    it = ints[a.element_size()]
    return torch.equal(a.view(it), b.view(it))


@pytest.mark.cuda
@pytest.mark.parametrize("mixed,labels", [
    (False, "int32"), (True, "int32"), (True, "float32"),
    (True, "float64"), (True, "columns")])
def test_pinned_ring_gives_the_synchronous_batches(cuda, mixed, labels):
    # three shuffled epochs through the pinned ring and the copy stream,
    # each batch as the synchronous pageable copy gives it, bit for bit:
    # under mixed_bfloat16 the inputs cast on the card (NaN, the
    # infinities, subnormals and rounding ties among them) and the
    # labels not cast (regression targets, f64, per-output columns); the
    # compute stream works on each batch while later ones are copied
    from analytics_zoo_tpu_torch.pipeline import estimator as em
    rs = np.random.RandomState(1)
    x = _special_f32(rs, 100 * 8 * 8 * 3).reshape(100, 8, 8, 3)
    y = {"int32": rs.randint(0, 10, size=(100, 1)).astype(np.int32),
         "float32": _special_f32(rs, 100 * 4).reshape(100, 4),
         "float64": rs.randn(100, 1),
         "columns": [rs.rand(100, 10).astype(np.float32),
                     rs.randint(0, 2, size=(100,))]}[labels]
    ds = em.ArrayDataset(x, y)
    fdt = torch.bfloat16 if mixed else None
    got = _placed_batches(ds, cuda, 2, fdt, 16, 3)
    want = []
    for epoch in range(1, 4):
        for sel in ds.iter_indices(16, shuffle=True, seed=epoch):
            xb, yb = ds.gather(sel)
            want.append((em._flat(em._to_device(xb, cuda, fdt)),
                         em._flat(em._to_device(yb, cuda))))
    assert len(got) == len(want) == 18
    for (gx, gy), (wx, wy) in zip(got, want):
        assert len(gx) == len(wx) and len(gy) == len(wy)
        assert all(_same_bits(a, b) for a, b in zip(gx + gy, wx + wy))
        assert gx[0].dtype == (torch.bfloat16 if mixed else torch.float32)


class _Batches:
    """A dataset that only gives batches (``iter_batches``)."""

    def __init__(self, x, y):
        from analytics_zoo_tpu_torch.pipeline.estimator import ArrayDataset
        self.arrays = ArrayDataset(x, y)

    def iter_batches(self, batch_size, shuffle=True, seed=0,
                     drop_last=True):
        return self.arrays.iter_batches(batch_size, shuffle, seed,
                                        drop_last)


@pytest.mark.cuda
@pytest.mark.parametrize("labels", ["int", "float"])
def test_estimator_prefetch_matches_sync_on_card(cuda, monkeypatch,
                                                 labels):
    # train, evaluate and predict on the card give the same numbers at
    # ZOO_TPU_PREFETCH 0 and 3, from the arrays and from a dataset that
    # only gives batches, and leave no worker behind; float labels reach
    # the loss in f32 under mixed_bfloat16 (the evaluated MSE is the
    # one of the predictions against the f32 labels)
    import threading

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    rs = np.random.RandomState(7)
    x = rs.rand(96, 6).astype(np.float32)
    if labels == "int":
        y, loss, last = rs.randint(0, 3, size=(96, 1)), \
            "sparse_categorical_crossentropy", "softmax"
    else:
        y, loss, last = rs.rand(96, 3).astype(np.float32) + 1.0, "mse", None
    runs = []
    for depth, batches in ((0, False), (3, False), (3, True)):
        zoo.init_nncontext(seed=0, device=cuda)
        monkeypatch.setenv("ZOO_TPU_PREFETCH", str(depth))
        m = Sequential([L.Dense(16, input_shape=(6,), activation="relu"),
                        L.Dense(3, activation=last)])
        est = Estimator(m, optimizer="sgd", dtype_policy="mixed_bfloat16",
                        loss=loss)
        data, yy = (_Batches(x, y), None) if batches else (x, y)
        res = est.train(data, yy, batch_size=16, nb_epoch=2)
        runs.append(([h["losses"] for h in res.history],
                     est.evaluate(data, yy, batch_size=16)["loss"],
                     est.predict(x[:40] if not batches else
                                 _Batches(x[:40], None), batch_size=16)))
    for run in runs[1:]:
        assert run[0] == runs[0][0] and run[1] == runs[0][1]
        np.testing.assert_array_equal(run[2], runs[0][2])
    if labels == "float":
        pred = est.predict(x, batch_size=16)
        mse = float(np.mean((pred.astype(np.float64) - y) ** 2))
        assert abs(runs[0][1] - mse) <= 1e-5 * mse, (runs[0][1], mse)
    assert not any(t.name == "zoo-tpu-prefetch" and t.is_alive()
                   for t in threading.enumerate())
    zoo.reset_nncontext()
