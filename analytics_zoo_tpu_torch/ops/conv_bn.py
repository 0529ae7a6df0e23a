"""Eval-mode conv + BatchNorm folds, with hand-written CUDA kernels.

Port of the inference half of ``analytics_zoo_tpu/ops/conv_bn.py``. In
eval mode every BatchNorm is a known moving-stats fold, so a whole
ResNet bottleneck runs as three fused convs whose epilogues apply the
BN (plus the residual add and ReLU) while the output tile is written:

- :func:`matmul_bn_apply` / :func:`conv1x1_bn_apply` replace the TPU
  kernel ``_apply_kernel`` (``_matmul_apply``);
- :func:`conv3x3_bn_apply` replaces ``_conv3_apply_kernel``
  (``_conv3_apply``).

Both CUDA kernels are one implicit-GEMM template
(``csrc/conv_bn_apply.cuh``, whose header note says what bounds them on
the H100 and what the design does about it). Each wrapper takes the
plain PyTorch version only for tensors on the CPU; for a CUDA tensor it
launches its kernel or raises, and counts the launch in
:data:`launches`.

dtype rules (the reference's): the 1x1 fold casts the prologue output
to the WEIGHT's type and multiplies in it, so bf16 activations with f32
weights give an f32 product; the 3x3 fold casts the weights to the
ACTIVATION's type. Accumulation and the epilogue are f32; scale and
shift vectors are f32; the output has the activation's type.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.ops import cuda_build

# launches of each CUDA kernel (CPU calls run the plain version and do
# not count)
launches = {"matmul_bn_apply": 0, "conv3x3_bn_apply": 0}
_launch_lock = threading.Lock()

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, w, in_scale, in_shift, out_scale, out_shift, res, y,
    # B, H, W, Cin, Ho, Wo, N, stride, affine_in, relu_in, relu_out,
    # x_bf16, w_bf16, stream
    "matmul_bn_apply": [_P] * 8 + [_I] * 13 + [_P],
    # x, w, in_scale, in_shift, out_scale, out_shift, y,
    # B, H, W, Cin, Ho, Wo, N, stride, pad_t, pad_l, affine_in,
    # relu_in, relu_out, x_bf16, w_bf16, stream
    "conv3x3_bn_apply": [_P] * 7 + [_I] * 15 + [_P],
}
_fns = {}


def reset_launches() -> None:
    with _launch_lock:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _launch_lock:
        launches[name] += 1


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(cuda_build.load(name), name + "_launch")
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def build_kernels():
    """Build both kernels' libraries now (one ``nvcc`` each, in
    parallel); returns the seconds each took."""
    return cuda_build.build(list(_SIGNATURES))


def tf_same_pads(extent: int, k: int, stride: int) -> Tuple[int, int, int]:
    """TF "SAME" padding of one spatial axis: ``(low, high, out)``.
    Asymmetric where the total is odd (the extra row goes high): the
    stem 7x7/s2 on 224 pads (2, 3), a 3x3/s2 on an even extent (0, 1)."""
    out = -(-extent // stride)
    total = max((out - 1) * stride + k - extent, 0)
    return total // 2, total - total // 2, out


def _vec(v: Optional[torch.Tensor], n: int, fill: float,
         like: torch.Tensor) -> torch.Tensor:
    if v is None:
        return torch.full((n,), fill, dtype=torch.float32,
                          device=like.device)
    if v.shape != (n,):
        raise ValueError(f"expected a ({n},) vector, got {tuple(v.shape)}")
    return v.to(device=like.device, dtype=torch.float32).contiguous()


def _prologue(x, s, t, relu_in, affine_in):
    xf = x.float()
    if affine_in:
        xf = xf * s + t
    if relu_in:
        xf = torch.relu(xf)
    return xf


def _epilogue(y, os_, ot, res, relu_out, dtype):
    y = y * os_ + ot
    if res is not None:
        y = y + res.float()
    if relu_out:
        y = torch.relu(y)
    return y.to(dtype)


def matmul_bn_apply_ref(x, w, s, t, os_, ot, res, relu_in, affine_in,
                        relu_out):
    """Plain version of the 1x1 fold on ``x (M, K)``, ``w (K, N)``:
    ``relu_out(prologue(x).to(w.dtype) @ w * os + ot [+ res])`` with an
    f32 product (the operands are exact in f32) and f32 epilogue."""
    xf = _prologue(x, s, t, relu_in, affine_in)
    y = torch.matmul(xf.to(w.dtype).float(), w.float())
    return _epilogue(y, os_, ot, res, relu_out, x.dtype)


def conv3x3_bn_apply_ref(x, w, s, t, os_, ot, relu_in, affine_in,
                         relu_out, stride):
    """Plain version of the 3x3 fold on NHWC ``x`` and HWIO ``w``: the
    prologue, then zero TF-SAME padding of the normalised input, a conv
    in ``x.dtype``-rounded operands with f32 accumulation, and the
    f32 epilogue."""
    xf = _prologue(x, s, t, relu_in, affine_in)
    xc = xf.to(x.dtype).float().permute(0, 3, 1, 2)
    pt, pb, _ = tf_same_pads(x.shape[1], 3, stride)
    pl, pr, _ = tf_same_pads(x.shape[2], 3, stride)
    xc = F.pad(xc, (pl, pr, pt, pb))
    wc = w.to(x.dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(xc, wc, stride=stride).permute(0, 2, 3, 1)
    return _epilogue(y, os_, ot, None, relu_out, x.dtype).contiguous()


def _check_cuda(name: str, x: torch.Tensor, **tensors) -> None:
    for tname, t in (("x", x),) + tuple(tensors.items()):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be 16-byte aligned")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x dtype {x.dtype} not in {_DTYPES}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _device_kind(name: str, x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return x.device.type


def _matmul_fold(x4, w, stride, residual, in_scale=None, in_shift=None,
                 relu_in=False, out_scale=None, out_shift=None,
                 relu_out=False):
    """The 1x1 fold over NHWC ``x4``, every ``stride``-th pixel."""
    name = "matmul_bn_apply"
    if w.dim() != 2:
        raise ValueError(f"{name}: w must be (K, N), got {tuple(w.shape)}")
    k, n = w.shape
    if k % 64 or n % 64:
        raise ValueError(f"K={k} and N={n} must be 64-multiples")
    b, h, wd, c = x4.shape
    if c != k:
        raise ValueError(f"{name}: x has {c} channels, w expects {k}")
    ho, wo = -(-h // stride), -(-wd // stride)
    m = b * ho * wo
    if residual is not None and residual.numel() != m * n:
        raise ValueError(f"{name}: residual must hold {m}x{n} values, "
                         f"got {tuple(residual.shape)}")
    affine_in = in_scale is not None or in_shift is not None
    s = _vec(in_scale, k, 1.0, x4) if affine_in else None
    t = _vec(in_shift, k, 0.0, x4) if affine_in else None
    os_ = _vec(out_scale, n, 1.0, x4)
    ot = _vec(out_shift, n, 0.0, x4)
    if _device_kind(name, x4) == "cpu":
        x2 = x4[:, ::stride, ::stride].reshape(m, k)
        res2 = None if residual is None else residual.reshape(m, n)
        y = matmul_bn_apply_ref(x2, w, s, t, os_, ot, res2, relu_in,
                                affine_in, relu_out)
        return y.reshape(b, ho, wo, n)
    _check_cuda(name, x4, w=w, residual=residual)
    if w.dtype not in _DTYPES:
        raise TypeError(f"{name}: w dtype {w.dtype} not in {_DTYPES}")
    if residual is not None and residual.dtype != x4.dtype:
        raise TypeError(f"{name}: residual dtype {residual.dtype} != "
                        f"x dtype {x4.dtype}")
    y = torch.empty((b, ho, wo, n), dtype=x4.dtype, device=x4.device)
    if m == 0:
        return y
    fn = _kernel_fn(name)
    with torch.cuda.device(x4.device):
        stream = torch.cuda.current_stream(x4.device).cuda_stream
        rc = fn(_ptr(x4), _ptr(w), _ptr(s), _ptr(t), _ptr(os_), _ptr(ot),
                _ptr(residual), _ptr(y), b, h, wd, k, ho, wo, n, stride,
                int(affine_in), int(relu_in), int(relu_out),
                int(x4.dtype == torch.bfloat16),
                int(w.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    _count(name)
    return y


def matmul_bn_apply(x: torch.Tensor, w: torch.Tensor,
                    in_scale: Optional[torch.Tensor] = None,
                    in_shift: Optional[torch.Tensor] = None,
                    relu_in: bool = False,
                    out_scale: Optional[torch.Tensor] = None,
                    out_shift: Optional[torch.Tensor] = None,
                    residual: Optional[torch.Tensor] = None,
                    relu_out: bool = False) -> torch.Tensor:
    """Inference fold of ``relu(prologue(x) @ w * out_scale + out_shift
    + residual)`` on ``x (M, K)``, ``w (K, N)``; K and N multiples of
    64, M arbitrary (the kernel masks the ragged edge). Returns
    ``y (M, N)`` in ``x.dtype``."""
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    y = _matmul_fold(x.reshape(m, 1, 1, k), w, 1, residual, in_scale,
                     in_shift, relu_in, out_scale, out_shift, relu_out)
    return y.reshape(m, -1)


def conv1x1_bn_apply(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     residual: Optional[torch.Tensor] = None,
                     **kwargs) -> torch.Tensor:
    """NHWC 1x1 conv over every ``stride``-th pixel, folded like
    :func:`matmul_bn_apply`. ``w``: (1, 1, C, F) or (C, F);
    ``residual``: (N, H', W', F), added before the ReLU."""
    if w.dim() == 4:
        w = w[0, 0]
    return _matmul_fold(x, w, int(stride), residual, **kwargs)


def conv3x3_bn_apply(x: torch.Tensor, w: torch.Tensor,
                     in_scale: Optional[torch.Tensor] = None,
                     in_shift: Optional[torch.Tensor] = None,
                     relu_in: bool = False,
                     out_scale: Optional[torch.Tensor] = None,
                     out_shift: Optional[torch.Tensor] = None,
                     relu_out: bool = False,
                     stride: int = 1) -> torch.Tensor:
    """Inference fold of the 3x3 SAME conv on NHWC ``x`` with HWIO
    ``w`` at stride 1 or 2, any extent: prologue, conv, this BN's fold
    and ReLU in the epilogue. Cin and Cout multiples of 64."""
    name = "conv3x3_bn_apply"
    stride = int(stride)
    if tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"kernel must be 3x3, got {tuple(w.shape[:2])}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    cin, cout = w.shape[2], w.shape[3]
    if cin % 64 or cout % 64:
        raise ValueError(f"Cin={cin} and Cout={cout} must be 64-multiples")
    if x.dim() != 4 or x.shape[-1] != cin:
        raise ValueError(f"{name}: x must be (B, H, W, {cin}), got "
                         f"{tuple(x.shape)}")
    affine_in = in_scale is not None or in_shift is not None
    s = _vec(in_scale, cin, 1.0, x) if affine_in else None
    t = _vec(in_shift, cin, 0.0, x) if affine_in else None
    os_ = _vec(out_scale, cout, 1.0, x)
    ot = _vec(out_shift, cout, 0.0, x)
    if _device_kind(name, x) == "cpu":
        return conv3x3_bn_apply_ref(x, w, s, t, os_, ot, relu_in,
                                    affine_in, relu_out, stride)
    w = w.to(x.dtype)
    _check_cuda(name, x, w=w)
    b, h, wd, _ = x.shape
    pt, _, ho = tf_same_pads(h, 3, stride)
    pl, _, wo = tf_same_pads(wd, 3, stride)
    y = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    fn = _kernel_fn(name)
    bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(_ptr(x), _ptr(w), _ptr(s), _ptr(t), _ptr(os_), _ptr(ot),
                _ptr(y), b, h, wd, cin, ho, wo, cout, stride, pt, pl,
                int(affine_in), int(relu_in), int(relu_out), bf16, bf16,
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    _count(name)
    return y
