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
