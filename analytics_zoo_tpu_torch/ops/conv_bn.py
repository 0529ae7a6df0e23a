"""Conv + BatchNorm with hand-written CUDA kernels: the eval folds and
the training statistics with their backward.

Port of ``analytics_zoo_tpu/ops/conv_bn.py``. A ResNet bottleneck's
convs run as matmuls (1x1) or implicit GEMMs (3x3) whose prologue
applies the previous BN's folded affine + ReLU while the input tile is
staged, and whose epilogue either applies this BN's known fold (eval)
or reduces this BN's batch statistics from the f32 accumulator
(training). Every TPU kernel on the path is a CUDA kernel here:

- :func:`matmul_bn_apply` / :func:`conv1x1_bn_apply` replace
  ``_apply_kernel`` (``_matmul_apply``), B5: with f32 weights an
  f32-accurate three-pass tf32 product on wgmma
  (``csrc/matmul_bn_apply_sm90.cuh``), with bf16 x and weights B1's
  kernel with a fold epilogue;
- :func:`conv3x3_bn_apply` replaces ``_conv3_apply_kernel``, B6;
- :func:`matmul_bn` / :func:`conv1x1_bn` replace ``_kernel``
  (``_matmul_bn_fwd_pallas``), B1, and their backward replaces
  ``_dx_kernel`` (B3) and ``_dw_kernel`` (B4) of ``_bwd_pallas``;
- :func:`conv3x3_bn` replaces ``_conv3_kernel``, B2. Its backward is
  plain PyTorch (cuDNN conv grads), as the reference's is XLA convs.

The bf16 paths of B1-B4 and B6, and B5, run on Hopper's warpgroup MMA,
fed by rings of asynchronous copies (``csrc/matmul_bn_sm90.cuh`` for B1
and, with its fold epilogue, B5 with bf16 x and weights;
``csrc/matmul_bn_apply_sm90.cuh`` for B5's other dtype pairs, as
:func:`fold_route` names them; ``csrc/conv3x3_bn_sm90.cuh`` for B2 and,
with its fold epilogue, B6; ``csrc/matmul_bn_dx_sm90.cuh``,
``csrc/matmul_bn_dw_sm90.cuh``). The f32 training paths and the f32 3x3
fold run FMA templates (``csrc/conv_bn_fwd.cuh``,
``csrc/conv_bn_bwd.cuh``), and every cross-block sum a fixed-order
second pass (``csrc/colsum.cuh``). The bf16 tiles are picked here, where
the CPU tests see them: :func:`fwd_tile`, :func:`dx_tile`,
:func:`dw_tile` and :func:`dw_splits`, and :func:`conv3x3_apply_tile`
by M. Each header's note says what bounds
its kernels on the H100 and what the design does about it. Each
wrapper takes the plain PyTorch version only for tensors on the CPU;
for a CUDA tensor it launches its kernel or raises, and counts the
launch in :data:`launches` (B1's and B3's given an in_residual in
:data:`residual_launches` as well).

The eval folds B5 and B6 are torch operators,
``zoo_torch::matmul_bn_apply`` and ``zoo_torch::conv3x3_bn_apply``
(``torch.library.custom_op``): ``torch.export`` records them as nodes of
a serving program (``InferenceModel.export_compiled``), and everything
that needs the tensors' pointers (the vectors' alignment copies, the
route and tile choice, the launch count, the FLOP record) runs inside
their implementation, so a loaded program launches and counts the
kernels as the eager path does. The public functions hand fake tensors
(a trace) to the operator and real ones to its implementation directly:
the dispatcher's round trip cost about 3 ms of host per ResNet-50
forward on the card (PERF.md). Tracing a card tensor into any other
kernel raises (:func:`untraceable`).

dtype rules (the reference's): the 1x1 fold casts the prologue output
to the WEIGHT's type and multiplies in it, so bf16 activations with f32
weights give an f32 product (two or three tf32 passes, f32-accurate,
never plain TF32); the 3x3 fold and every training kernel cast the
weights to the ACTIVATION's type. Accumulation and the
epilogue are f32; scale, shift and statistics vectors are f32; outputs
have the activation's type, and so has the 1x1's dW (the cast's
backward lifts it to the f32 master weight).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.ops import cuda_build
from analytics_zoo_tpu_torch.perf import flops as _flops

# launches of each CUDA kernel (CPU calls run the plain version and do
# not count)
launches = {"matmul_bn_apply": 0, "conv3x3_bn_apply": 0, "matmul_bn": 0,
            "conv3x3_bn": 0, "matmul_bn_dx": 0, "matmul_bn_dw": 0}
# of those, the B1 and B3 launches given an in_residual (the deferred
# stage layout's c1 prologue, and its gradient dr)
residual_launches = {"matmul_bn": 0, "matmul_bn_dx": 0}
_launch_lock = threading.Lock()

# Whether the fused bottlenecks beat the unfused graph (cuDNN convs,
# separate BatchNorm and ReLU passes) on the card. chip_smoke.py's A/B
# in two runs on an H100 80GB HBM3 at 700 W (PERF.md §6): a batch-32
# request in bf16 9.255 / 10.186 ms fused against 18.168 / 13.215
# unfused, in f32 10.980 / 11.033 against 18.140 / 18.505; the bf16
# train step's device time 67.4 against 95.1 / 95.0 ms. The train
# step's wall time, timed in turns, is host-bound and did not resolve
# (1036.9 against 881.1 images/s in one run, 674.5 against 768.0 in
# the other). The "auto" default of ImageClassifier follows it.
MEASURED_WIN = True


def fused_profitable() -> bool:
    """Whether the "auto" fused-ResNet default may route to these
    kernels: the device is CUDA (the context's, or the first card where
    no context exists yet) and :data:`MEASURED_WIN`.
    ``ZOO_TPU_FUSED_WIN=0/1`` overrides both (1: CPU coverage and
    measurement runs; 0: a kill switch)."""
    env = os.environ.get("ZOO_TPU_FUSED_WIN")
    if env is not None:
        return env == "1"
    from analytics_zoo_tpu_torch.common.nncontext import get_nncontext
    try:
        on_card = get_nncontext(create_if_missing=False).device.type == \
            "cuda"
    except RuntimeError:    # no context yet: the default is the card
        on_card = torch.cuda.is_available()
    return MEASURED_WIN and on_card

_DTYPES = (torch.float32, torch.bfloat16)
# the H100's SMs, which the bf16 tile choices fill, and a block's
# largest shared memory
_SMS = 132
_SMEM_PER_BLOCK = 232448
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, w, in_scale, in_shift, out_scale, out_shift, res, y,
    # B, H, W, Cin, Ho, Wo, N, stride, affine_in, relu_in, relu_out,
    # x_bf16, route (FOLD_ROUTES' index), stream
    "matmul_bn_apply": [_P] * 8 + [_I] * 13 + [_P],
    # x, w, in_scale, in_shift, out_scale, out_shift, y,
    # B, H, W, Cin, Ho, Wo, N, stride, pad_t, pad_l, affine_in,
    # relu_in, relu_out, x_bf16, w_bf16, window, bn, stream
    "conv3x3_bn_apply": [_P] * 7 + [_I] * 17 + [_P],
    # x, w, in_scale, in_shift, in_res, sh, y, partial, work, stats,
    # B, H, W, Cin, Ho, Wo, N, stride, affine_in, relu_in, bf16, bn,
    # stream
    "matmul_bn": [_P] * 10 + [_I] * 12 + [_P],
    # x, w, in_scale, in_shift, sh, y, partial, work, stats,
    # B, H, W, Cin, Ho, Wo, N, stride, pad_t, pad_l, affine_in, relu_in,
    # x_bf16, w_bf16, stream
    "conv3x3_bn": [_P] * 9 + [_I] * 14 + [_P],
    # dy, y, x, w, s, t, r, sh, dsum, dsq, dx, dr, partial, work, dsdt,
    # M, K, N, affine_in, relu_in, bk, bf16, stream
    "matmul_bn_dx": [_P] * 15 + [_I] * 7 + [_P],
    # dy, y, x, s, t, r, sh, dsum, dsq, partial, work, dw,
    # M, K, N, affine_in, relu_in, splits, m_chunk, bk, bn, bf16, stream
    "matmul_bn_dw": [_P] * 12 + [_I] * 10 + [_P],
}
_fns = {}


def reset_launches() -> None:
    with _launch_lock:
        for counts in (launches, residual_launches):
            for k in counts:
                counts[k] = 0


def _count(name: str) -> None:
    with _launch_lock:
        launches[name] += 1


def _count_residual(name: str) -> None:
    with _launch_lock:
        residual_launches[name] += 1


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(cuda_build.load(name), name + "_launch")
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def build_kernels():
    """Build every kernel's library now (one ``nvcc`` each, in
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
    v = v.to(device=like.device, dtype=torch.float32).contiguous()
    # the kernels read these vectors in pairs: a view at an odd offset
    # gets its own copy
    return v.clone() if v.data_ptr() % 16 else v


def _prologue(x, s, t, relu_in, affine_in, r=None):
    """``relu_in?(affine_in?(x * s + t) [+ r])`` in f32: the residual
    adds after the affine, before the ReLU."""
    xf = x.float()
    if affine_in:
        xf = xf * s + t
    if r is not None:
        xf = xf + r.float()
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


def _traced(x: torch.Tensor) -> bool:
    """Whether ``x`` is a tracer's fake tensor (``torch.export``), not
    data. A plain tensor, every eager call's, is answered at once without
    ``is_fake``'s checks."""
    if type(x) is torch.Tensor:
        return False
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(x)


def untraceable(name: str, x: torch.Tensor) -> None:
    """Raise where ``torch.export`` traces a card tensor into a kernel
    that is no operator: its ctypes launch needs real pointers, and a
    program must not quietly record the plain version instead. Only B5
    and B6 are operators (``zoo_torch::matmul_bn_apply``,
    ``zoo_torch::conv3x3_bn_apply``)."""
    if x.device.type == "cuda" and _traced(x):
        raise NotImplementedError(
            f"{name}: no program exports through this kernel on the card "
            "(only B5 and B6 are operators; ROADMAP A13.7)")


def _device_kind(name: str, x: torch.Tensor) -> str:
    untraceable(name, x)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return x.device.type


def _check_1x1(name: str, x4: torch.Tensor, w: torch.Tensor):
    """Validate a 1x1's ``w (K, N)`` against NHWC ``x4``; returns K, N."""
    if w.dim() != 2:
        raise ValueError(f"{name}: w must be (K, N), got {tuple(w.shape)}")
    k, n = w.shape
    if k % 64 or n % 64:
        raise ValueError(f"K={k} and N={n} must be 64-multiples")
    if x4.shape[-1] != k:
        raise ValueError(f"{name}: x has {x4.shape[-1]} channels, w "
                         f"expects {k}")
    return k, n


def _check_3x3(name: str, x: torch.Tensor, w: torch.Tensor, stride: int):
    """Validate a 3x3's HWIO ``w`` and stride against NHWC ``x``;
    returns Cin, Cout."""
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
    return cin, cout


def _counted(name: str, m: int, k: int, n: int, taps: int = 1):
    """A kernel's products (``2 m k n`` per tap) in an open FLOP count
    (``perf/flops.py``): recorded the same on the card and on the CPU,
    where the plain version's aten ops are muted."""
    return _flops.kernel(
        name, "convolution" if taps > 1 else "dot", 2.0 * m * k * n * taps,
        f"m {m} k {k} n {n}" + (f" taps {taps}" if taps > 1 else ""),
        (("lhs_f", k), ("rhs_i", k), ("rhs_o", n)))


def _launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name``'s C entry point on the current stream of
    ``device``; raise if the launch was refused, else count it."""
    fn = _kernel_fn(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    _count(name)


def _matmul_fold(x4, w, stride, residual, in_scale=None, in_shift=None,
                 relu_in=False, out_scale=None, out_shift=None,
                 relu_out=False):
    """The 1x1 fold over NHWC ``x4``, every ``stride``-th pixel: B5,
    the op ``zoo_torch::matmul_bn_apply`` under tracing."""
    _check_1x1("matmul_bn_apply", x4, w)
    args = (x4, w, in_scale, in_shift, out_scale, out_shift, residual,
            int(stride), bool(relu_in), bool(relu_out))
    if _traced(x4):
        return torch.ops.zoo_torch.matmul_bn_apply.default(*args)
    return _matmul_fold_op(*args)


def _matmul_fold_op(x4: torch.Tensor, w: torch.Tensor,
                    in_scale: Optional[torch.Tensor],
                    in_shift: Optional[torch.Tensor],
                    out_scale: Optional[torch.Tensor],
                    out_shift: Optional[torch.Tensor],
                    residual: Optional[torch.Tensor], stride: int,
                    relu_in: bool, relu_out: bool) -> torch.Tensor:
    """``zoo_torch::matmul_bn_apply`` on real tensors: B5 on a CUDA
    tensor (or raise), the plain version on a CPU one. The FLOP record,
    the vectors' alignment copies, the route and the launch count run
    here, so a loaded program does them as the eager path does."""
    name = "matmul_bn_apply"
    k, n = w.shape
    b, h, wd, _ = x4.shape
    ho, wo = -(-h // stride), -(-wd // stride)
    with _counted(name, b * ho * wo, k, n):
        return _matmul_fold_launch(x4, w, stride, residual, in_scale,
                                   in_shift, relu_in, out_scale, out_shift,
                                   relu_out)


def _matmul_fold_launch(x4, w, stride, residual, in_scale, in_shift,
                        relu_in, out_scale, out_shift, relu_out):
    name = "matmul_bn_apply"
    k, n = w.shape
    b, h, wd, _ = x4.shape
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
    route = fold_route(x4.dtype, w.dtype, affine_in or relu_in)
    _launch(name, x4.device, _ptr(x4), _ptr(w), _ptr(s), _ptr(t),
            _ptr(os_), _ptr(ot), _ptr(residual), _ptr(y), b, h, wd, k, ho,
            wo, n, stride, int(affine_in), int(relu_in), int(relu_out),
            int(x4.dtype == torch.bfloat16), FOLD_ROUTES.index(route))
    return y


# B5's kernels, by route (``csrc/matmul_bn_apply.cu``)
FOLD_ROUTES = ("tf32x3", "tf32x2", "bf16", "tf32x1")


def fold_route(x_dtype: torch.dtype, w_dtype: torch.dtype,
               prologue: bool) -> str:
    """The kernel B5 runs on the card, as the product runs in the
    weights' type: f32 weights the f32-accurate three-pass tf32 split on
    wgmma (``"tf32x3"``, ``csrc/matmul_bn_apply_sm90.cuh``), or its
    two-pass instance where a bf16 x without a prologue is exact in tf32
    (``"tf32x2"``: the dropped pass's terms are all zero); bf16 weights
    with a bf16 x B1's wgmma kernel with the fold epilogue (``"bf16"``,
    ``csrc/matmul_bn_sm90.cuh``), with an f32 x the tf32 kernel in one
    pass on the bf16-rounded prologue (``"tf32x1"``: bf16 values are
    exact in tf32)."""
    if w_dtype == torch.bfloat16:
        return "bf16" if x_dtype == torch.bfloat16 else "tf32x1"
    return "tf32x2" if x_dtype == torch.bfloat16 and not prologue \
        else "tf32x3"


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
    and ReLU in the epilogue. Cin and Cout multiples of 64. B6, the op
    ``zoo_torch::conv3x3_bn_apply`` under tracing."""
    stride = int(stride)
    _check_3x3("conv3x3_bn_apply", x, w, stride)
    args = (x, w, in_scale, in_shift, out_scale, out_shift, stride,
            bool(relu_in), bool(relu_out))
    if _traced(x):
        return torch.ops.zoo_torch.conv3x3_bn_apply.default(*args)
    return _conv3x3_fold_op(*args)


def _conv3x3_fold_op(x: torch.Tensor, w: torch.Tensor,
                     in_scale: Optional[torch.Tensor],
                     in_shift: Optional[torch.Tensor],
                     out_scale: Optional[torch.Tensor],
                     out_shift: Optional[torch.Tensor], stride: int,
                     relu_in: bool, relu_out: bool) -> torch.Tensor:
    """``zoo_torch::conv3x3_bn_apply`` on real tensors: B6 on a CUDA
    tensor (or raise), the plain version on a CPU one, with the FLOP
    record, the alignment copies, the tile choice and the launch count
    inside."""
    name = "conv3x3_bn_apply"
    cin, cout = w.shape[2], w.shape[3]
    affine_in = in_scale is not None or in_shift is not None
    s = _vec(in_scale, cin, 1.0, x) if affine_in else None
    t = _vec(in_shift, cin, 0.0, x) if affine_in else None
    os_ = _vec(out_scale, cout, 1.0, x)
    ot = _vec(out_shift, cout, 0.0, x)
    m = x.shape[0] * tf_same_pads(x.shape[1], 3, stride)[2] * \
        tf_same_pads(x.shape[2], 3, stride)[2]
    with _counted(name, m, cin, cout, taps=9):
        return _conv3x3_apply_launch(x, w, s, t, os_, ot, relu_in,
                                     affine_in, relu_out, stride, cin, cout)


def _conv3x3_apply_launch(x, w, s, t, os_, ot, relu_in, affine_in, relu_out,
                          stride, cin, cout):
    name = "conv3x3_bn_apply"
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
    bf16 = int(x.dtype == torch.bfloat16)
    window, bn = conv3x3_apply_tile(b, h, wd, cin, cout, stride)
    _launch(name, x.device, _ptr(x), _ptr(w), _ptr(s), _ptr(t), _ptr(os_),
            _ptr(ot), _ptr(y), b, h, wd, cin, ho, wo, cout, stride, pt, pl,
            int(affine_in), int(relu_in), int(relu_out), bf16, bf16,
            int(window), bn)
    return y


def _window_smem(bn: int, cin: int, w: int) -> int:
    """Shared memory of B2/B6's stride-1 window kernel with ``bn``-wide
    tiles (``csrc/conv3x3_bn_sm90.cuh``: ``s1_smem_bytes``): a 5-slot
    weight ring, one or two windows of BM + 2W + 2 pixel rows of 64
    channels, s and t, alignment slack."""
    bm = 256 if bn == 128 else 128
    return (5 * 64 * bn * 2 + (2 if cin > 64 else 1) * (bm + 2 * w + 2)
            * 128 + 8 * cin + 1024)


def conv3x3_apply_tile(b: int, h: int, w: int, cin: int, cout: int,
                       stride: int) -> Tuple[bool, int]:
    """B6's bf16 kernel and tile, ``(window, bn)``, chosen by M (serving
    runs batches of 1 to 32, so M spans 49 to 100,352 rows): the
    stride-1 window kernel where its shared memory fits, else the
    generic kernel; 128 columns wide (256 x 128 window tiles, 128 x 128
    generic ones, one block per SM) where Cout allows and those tiles'
    blocks fill at least two thirds of the SMs, else 64 (128 x 64 tiles,
    two blocks per SM). Every kernel and width at every serving shape
    was timed on the H100 for this rule (``scripts/conv_bn_ab.py``,
    PERF.md): the wide tiles win once they nearly fill the card, the
    narrow ones below that."""
    m = b * -(-h // stride) * -(-w // stride)
    bn = 64
    if cout % 128 == 0:
        bm = 256 if stride == 1 and _window_smem(128, cin, w) <= \
            _SMEM_PER_BLOCK else 128
        if -(-m // bm) * (cout // 128) * 3 >= 2 * _SMS:
            bn = 128
    return (stride == 1 and _window_smem(bn, cin, w) <= _SMEM_PER_BLOCK,
            bn)


def _fold_1x1_fake(x4, w, in_scale, in_shift, out_scale, out_shift,
                   residual, stride, relu_in, relu_out):
    b, h, wd, _ = x4.shape
    return x4.new_empty((b, -(-h // stride), -(-wd // stride), w.shape[1]))


def _fold_3x3_fake(x, w, in_scale, in_shift, out_scale, out_shift, stride,
                   relu_in, relu_out):
    b, h, wd, _ = x.shape
    return x.new_empty((b, -(-h // stride), -(-wd // stride), w.shape[3]))


# B5 and B6 as opaque operators, so that ``torch.export`` records them as
# nodes of a program (``InferenceModel.export_compiled``) and a loaded
# program launches the kernels: the CUDA and CPU implementation is the
# wrapper above; the fake one gives the output's shape and dtype from the
# inputs' (a symbolic batch included). They have no autograd formula: the
# folds serve inference only.
torch.library.custom_op("zoo_torch::matmul_bn_apply", _matmul_fold_op,
                        mutates_args=(), device_types=("cpu", "cuda")
                        ).register_fake(_fold_1x1_fake)
torch.library.custom_op("zoo_torch::conv3x3_bn_apply", _conv3x3_fold_op,
                        mutates_args=(), device_types=("cpu", "cuda")
                        ).register_fake(_fold_3x3_fake)


# ---------------------------------------------------------------------------
# Training: conv + BN statistics (B1, B2) and the 1x1's backward (B3, B4)
# ---------------------------------------------------------------------------

def colsum_work_floats(rows: int, cols: int) -> int:
    """Floats of scratch the fixed-order column sum (``csrc/colsum.cuh``)
    needs to fold ``rows`` partial rows of ``cols`` values into one: the
    intermediate rows of every pass before the last, 64 rows per fold."""
    total, r = 0, rows
    while True:
        r = -(-r // 64)
        if r == 1:
            return total
        total += r * cols


def _partials(rows: int, cols: int, like: torch.Tensor):
    """The (rows, cols) partial-sum buffer and the column sum's scratch."""
    dev = like.device
    return (torch.empty(rows * cols, dtype=torch.float32, device=dev),
            torch.empty(max(1, colsum_work_floats(rows, cols)),
                        dtype=torch.float32, device=dev))


def _stats(acc: torch.Tensor, sh: torch.Tensor, dims):
    d = acc - sh
    return d.sum(dims), (d * d).sum(dims)


def matmul_bn_ref(x, w, s, t, r, sh, relu_in, affine_in):
    """Plain version of the 1x1 with statistics on ``x (M, K)``,
    ``w (K, N)`` (already in x's dtype): ``acc = prologue(x).to(w.dtype)
    @ w`` with f32 accumulation (the operands are exact in f32); returns
    ``(acc.to(x.dtype), sum(acc - sh), sum((acc - sh)^2))``, the sums
    over rows from the f32 accumulator, as the kernel takes them."""
    xp = _prologue(x, s, t, relu_in, affine_in, r)
    acc = torch.matmul(xp.to(w.dtype).float(), w.float())
    return (acc.to(x.dtype),) + _stats(acc, sh, 0)


def conv3x3_bn_ref(x, w, s, t, sh, relu_in, affine_in, stride):
    """Plain version of the 3x3 SAME conv with statistics on NHWC ``x``
    and HWIO ``w``: the prologue, zero TF-SAME padding of the normalised
    input, a conv in x.dtype-rounded operands with f32 accumulation;
    returns ``(acc.to(x.dtype), sum(acc - sh), sum((acc - sh)^2))``."""
    xf = _prologue(x, s, t, relu_in, affine_in)
    xc = xf.to(x.dtype).float().permute(0, 3, 1, 2)
    pt, pb, _ = tf_same_pads(x.shape[1], 3, stride)
    pl, pr, _ = tf_same_pads(x.shape[2], 3, stride)
    xc = F.pad(xc, (pl, pr, pt, pb))
    wc = w.to(x.dtype).float().permute(3, 2, 0, 1)
    acc = F.conv2d(xc, wc, stride=stride).permute(0, 2, 3, 1)
    return (acc.to(x.dtype).contiguous(),) + _stats(acc, sh, (0, 1, 2))


def _augmented_cotangent(dy, y, sh, dsum, dsq):
    """The statistics cotangents folded into one cotangent of y:
    ``g = dy + dsum + 2 (y - sh) dsq`` in f32 (y feeds y, sum(y - sh)
    and sum((y - sh)^2))."""
    return dy.float() + dsum + 2.0 * (y.float() - sh) * dsq


def _recompute_prologue(x, s, t, r, relu_in, affine_in):
    """The 1x1's prologue recomputed from x: ``(xa, xp)``, before and
    after the ReLU."""
    xa = _prologue(x, s, t, False, affine_in, r)
    return xa, (torch.relu(xa) if relu_in else xa)


def matmul_bn_dx_ref(x, w, s, t, r, sh, y, dy, dsum, dsq, relu_in,
                     affine_in):
    """Plain version of the 1x1's dx kernel (the dx half of the
    reference's ``_bwd_jax``) on ``x (M, K)``, ``w (K, N)`` in x's dtype:
    ``dxp = mask(g @ W^T)`` with g rounded to x's dtype and f32
    accumulation. Returns ``(dx, ds, dt, dr)``; ``ds``/``dt`` None
    without ``affine_in``, ``dr`` None without ``r``."""
    g = _augmented_cotangent(dy, y, sh, dsum, dsq)
    xa, _ = _recompute_prologue(x, s, t, r, relu_in, affine_in)
    dxp = torch.matmul(g.to(x.dtype).float(), w.to(x.dtype).float().t())
    if relu_in:
        dxp = torch.where(xa > 0, dxp, torch.zeros_like(dxp))
    ds = dt = None
    dx = dxp
    if affine_in:
        dx = dxp * s
        ds = (dxp * x.float()).sum(0)
        dt = dxp.sum(0)
    dr = None if r is None else dxp.to(r.dtype)
    return dx.to(x.dtype), ds, dt, dr


def matmul_bn_dw_ref(x, s, t, r, sh, y, dy, dsum, dsq, relu_in,
                     affine_in):
    """Plain version of the 1x1's dW kernel (the dW half of ``_bwd_jax``):
    ``prologue(x)^T @ g`` with both operands rounded to x's dtype and f32
    accumulation, returned rounded to x's dtype (the weight's type inside
    the custom VJP)."""
    g = _augmented_cotangent(dy, y, sh, dsum, dsq)
    _, xp = _recompute_prologue(x, s, t, r, relu_in, affine_in)
    cd = x.dtype
    return torch.matmul(xp.to(cd).float().t(), g.to(cd).float()).to(cd)


def conv3x3_bn_bwd(x, w, s, t, sh, y, dy, dsum, dsq, relu_in, affine_in,
                   stride):
    """Backward of :func:`conv3x3_bn`, plain PyTorch on every device (the
    reference's ``_conv3_vjp_bwd`` is XLA convs, no Pallas kernel): the
    augmented cotangent, the recomputed prologue, the conv's input and
    weight grads in x's dtype (cuDNN on the card: bf16 operands give
    bf16 grads, one rounding more than XLA's f32 results), then the ReLU
    mask, ``dx = dxp s`` and the ``ds``/``dt`` sums. SAME padding is
    asymmetric at stride 2 on an even extent (0, 1), so the prologue
    output is padded explicitly and dx cropped. Returns
    ``(dx, dw, ds, dt)``, dw in w's dtype."""
    h, wd = x.shape[1], x.shape[2]
    g = _augmented_cotangent(dy, y, sh, dsum, dsq)
    xa, xp = _recompute_prologue(x, s, t, None, relu_in, affine_in)
    cd = x.dtype
    pt, pb, _ = tf_same_pads(h, 3, stride)
    pl, pr, _ = tf_same_pads(wd, 3, stride)
    xpad = F.pad(xp.to(cd).permute(0, 3, 1, 2), (pl, pr, pt, pb))
    wk = w.to(cd).permute(3, 2, 0, 1)
    gi, gw, _ = torch.ops.aten.convolution_backward(
        g.to(cd).permute(0, 3, 1, 2), xpad, wk, None, [stride, stride],
        [0, 0], [1, 1], False, [0, 0], 1, [True, True, False])
    dxp = gi[:, :, pt:pt + h, pl:pl + wd].permute(0, 2, 3, 1).float()
    dw = gw.permute(2, 3, 1, 0).to(w.dtype)
    if relu_in:
        dxp = torch.where(xa > 0, dxp, torch.zeros_like(dxp))
    ds = dt = None
    dx = dxp
    if affine_in:
        dx = dxp * s
        ds = (dxp * x.float()).sum((0, 1, 2))
        dt = dxp.sum((0, 1, 2))
    return dx.to(x.dtype), dw, ds, dt


def _matmul_bn_fwd(x4, w, s, t, r, sh, stride, relu_in, affine_in):
    """B1 over NHWC ``x4``, every ``stride``-th pixel, ``w (K, N)`` in
    x's dtype, ``r (M, K)`` or None; returns ``(y (B, H', W', N), sum,
    sumsq)``."""
    name = "matmul_bn"
    b, h, wd, k = x4.shape
    n = w.shape[1]
    ho, wo = -(-h // stride), -(-wd // stride)
    m = b * ho * wo
    if _device_kind(name, x4) == "cpu":
        x2 = x4[:, ::stride, ::stride].reshape(m, k)
        y, ssum, ssq = matmul_bn_ref(x2, w, s, t, r, sh, relu_in,
                                     affine_in)
        return y.reshape(b, ho, wo, n), ssum, ssq
    _check_cuda(name, x4, w=w, in_residual=r)
    for tname, tt in (("w", w), ("in_residual", r)):
        if tt is not None and tt.dtype != x4.dtype:
            raise TypeError(f"{name}: {tname} dtype {tt.dtype} != x dtype "
                            f"{x4.dtype}")
    y = torch.empty((b, ho, wo, n), dtype=x4.dtype, device=x4.device)
    stats = torch.zeros(2 * n, dtype=torch.float32, device=x4.device)
    if m:
        partial, work = _partials(matmul_bn_partial_rows(m, x4.dtype),
                                  2 * n, x4)
        _launch(name, x4.device, _ptr(x4), _ptr(w), _ptr(s), _ptr(t),
                _ptr(r), _ptr(sh), _ptr(y), _ptr(partial), _ptr(work),
                _ptr(stats), b, h, wd, k, ho, wo, n, stride,
                int(affine_in), int(relu_in),
                int(x4.dtype == torch.bfloat16),
                fwd_tile(n, residual=r is not None))
        if r is not None:
            _count_residual(name)
    return y, stats[:n], stats[n:]


def _matmul_bn_dx(x, w, s, t, r, sh, y, dy, dsum, dsq, relu_in,
                  affine_in):
    """B3 on ``x (M, K)``: ``(dx, ds, dt, dr)`` like
    :func:`matmul_bn_dx_ref`."""
    name = "matmul_bn_dx"
    if _device_kind(name, x) == "cpu":
        return matmul_bn_dx_ref(x, w, s, t, r, sh, y, dy, dsum, dsq,
                                relu_in, affine_in)
    _check_cuda(name, x, w=w, r=r, y=y, dy=dy)
    m, k = x.shape
    n = w.shape[1]
    dx = torch.empty_like(x)
    dr = None if r is None else torch.empty_like(r)
    dsdt = torch.zeros(2 * k, dtype=torch.float32, device=x.device)
    if m:
        partial, work = _partials(dx_partial_rows(m, x.dtype), 2 * k, x) \
            if affine_in else (None, None)
        _launch(name, x.device, _ptr(dy), _ptr(y), _ptr(x), _ptr(w),
                _ptr(s), _ptr(t), _ptr(r), _ptr(sh), _ptr(dsum), _ptr(dsq),
                _ptr(dx), _ptr(dr), _ptr(partial), _ptr(work), _ptr(dsdt),
                m, k, n, int(affine_in), int(relu_in), dx_tile(k),
                int(x.dtype == torch.bfloat16))
        if r is not None:
            _count_residual(name)
    ds, dt = (dsdt[:k], dsdt[k:]) if affine_in else (None, None)
    return dx, ds, dt, dr


def _matmul_bn_dw(x, s, t, r, sh, y, dy, dsum, dsq, relu_in, affine_in):
    """B4 on ``x (M, K)``, ``y``/``dy (M, N)``: dW ``(K, N)`` in x's
    dtype, like :func:`matmul_bn_dw_ref`."""
    name = "matmul_bn_dw"
    if _device_kind(name, x) == "cpu":
        return matmul_bn_dw_ref(x, s, t, r, sh, y, dy, dsum, dsq, relu_in,
                                affine_in)
    _check_cuda(name, x, r=r, y=y, dy=dy)
    m, k = x.shape
    n = y.shape[1]
    bf16 = x.dtype == torch.bfloat16
    if not m:
        return torch.zeros((k, n), dtype=x.dtype, device=x.device)
    splits, chunk = dw_splits(m, k, n, x.dtype)
    if bf16:
        # the kernel sums its splits straight into the bf16 dW
        partial, work = torch.empty(splits * k * n, dtype=torch.float32,
                                    device=x.device), None
        dw = torch.empty((k, n), dtype=x.dtype, device=x.device)
    else:
        partial, work = _partials(splits, k * n, x)
        dw = torch.zeros((k, n), dtype=torch.float32, device=x.device)
    bk, bn = dw_tile(k, n)
    _launch(name, x.device, _ptr(dy), _ptr(y), _ptr(x), _ptr(s), _ptr(t),
            _ptr(r), _ptr(sh), _ptr(dsum), _ptr(dsq), _ptr(partial),
            _ptr(work), _ptr(dw), m, k, n, int(affine_in), int(relu_in),
            splits, chunk, bk, bn, int(bf16))
    return dw.to(x.dtype)


def fwd_tile(n: int, residual: bool = False) -> int:
    """B1's bf16 tile width BN: its tiles are 128 rows by BN columns of y
    (``csrc/matmul_bn_sm90.cuh``, one wave of blocks walking them), BN
    the widest of 256, 128 and 64 that divides N, so x is read N / BN
    times and the W slice once per 128 rows. Every width was timed at
    every train-step shape on the H100 (``scripts/conv_bn_ab.py``,
    PERF.md): the widest was best or within 1% at 14 of the 16, also
    where its tiles number fewer than the SMs (M 6,272); narrower ones
    won by 5-7% at two (0.04 ms of a step, no rule worth its keep). With
    an ``in_residual`` the tile is 64 wide (its second ring slice fits
    only there)."""
    if residual:
        return 64
    return 256 if n % 256 == 0 else 128 if n % 128 == 0 else 64


def matmul_bn_partial_rows(m: int, dtype: torch.dtype) -> int:
    """Rows of B1's statistics partials, one per M tile: 128 rows in
    bf16 (``csrc/matmul_bn_sm90.cuh``), 64 in f32
    (``csrc/conv_bn_fwd.cuh``)."""
    return -(-m // (128 if dtype == torch.bfloat16 else 64))


def dx_tile(k: int) -> int:
    """B3's bf16 tile width BK (its tiles are 128 rows by BK columns of
    dx; ``csrc/matmul_bn_dx_sm90.cuh``): min(K, 256), so g is formed
    once per M tile up to K 256. Narrower tiles at the late, small-M
    shapes fill more SMs but form g more often; on the H100 they were
    slower at every train-step shape (``scripts/conv_bn_ab.py``,
    PERF.md), so M does not narrow it."""
    return min(k, 256)


def dx_partial_rows(m: int, dtype: torch.dtype) -> int:
    """Rows of B3's ds/dt partials, one per M tile: 128-row tiles in
    bf16, 64-row ones in f32 (``csrc/conv_bn_bwd.cuh``)."""
    return -(-m // (128 if dtype == torch.bfloat16 else 64))


def dw_tile(k: int, n: int) -> Tuple[int, int]:
    """B4's bf16 output tile ``(BK, BN)``, which the wgmma kernel is
    launched with: 128 rows where K allows, else 64, and 128 columns
    where N allows, else 64."""
    return (128 if k % 128 == 0 else 64), (128 if n % 128 == 0 else 64)


def dw_splits(m: int, k: int, n: int,
              dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """``(splits, rows per split)`` of B4's M reduction, each split a
    whole number of the kernel's reduction slices. bf16 (the wgmma
    kernel): :func:`dw_tile`'s tiles and 64-row slices, and as many
    splits as fill one wave of blocks on the H100's 132 SMs (two blocks
    per SM for 64-column tiles, else one), so every block runs at once
    and the splits stay few and large. f32 (the FMA kernel): 64x64
    tiles, 32-row slices, about four blocks per SM."""
    if dtype == torch.bfloat16:
        (bk, bn), depth = dw_tile(k, n), 64
        tiles = (k // bk) * (n // bn)
        want = max(1, _SMS * (2 if bn == 64 else 1) // tiles)
    else:
        depth, tiles = 32, (k // 64) * (n // 64)
        want = -(-4 * _SMS // tiles)
    splits = max(1, min(-(-m // depth), want))
    chunk = -(-(-(-m // splits)) // depth) * depth
    return -(-m // chunk), chunk


def conv3x3_bn_partial_rows(m: int, dtype: torch.dtype) -> int:
    """Rows to allocate for B2's statistics partials, one per M tile:
    bf16 tiles have 128 or 256 rows (``csrc/conv3x3_bn_sm90.cuh`` picks),
    so one per 128 rows covers either; f32 tiles have 64
    (``csrc/conv_bn_fwd.cuh``)."""
    return -(-m // (128 if dtype == torch.bfloat16 else 64))


def _conv3x3_bn_fwd(x, w, s, t, sh, relu_in, affine_in, stride):
    """B2: the 3x3 SAME conv with statistics; ``w`` HWIO in any dtype
    (cast to x's)."""
    name = "conv3x3_bn"
    if _device_kind(name, x) == "cpu":
        return conv3x3_bn_ref(x, w, s, t, sh, relu_in, affine_in, stride)
    w = w.to(x.dtype)
    _check_cuda(name, x, w=w)
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    pt, _, ho = tf_same_pads(h, 3, stride)
    pl, _, wo = tf_same_pads(wd, 3, stride)
    y = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    stats = torch.zeros(2 * cout, dtype=torch.float32, device=x.device)
    m = b * ho * wo
    if m:
        partial, work = _partials(conv3x3_bn_partial_rows(m, x.dtype),
                                  2 * cout, x)
        bf16 = int(x.dtype == torch.bfloat16)
        _launch(name, x.device, _ptr(x), _ptr(w), _ptr(s), _ptr(t),
                _ptr(sh), _ptr(y), _ptr(partial), _ptr(work), _ptr(stats),
                b, h, wd, cin, ho, wo, cout, stride, pt, pl,
                int(affine_in), int(relu_in), bf16, bf16)
    return y, stats[:cout], stats[cout:]


class _MatmulBn(torch.autograd.Function):
    """The 1x1 with statistics (``_matmul_bn``'s custom VJP): B1 forward,
    B3 + B4 backward. ``stat_shift`` is not differentiated."""

    @staticmethod
    def forward(ctx, x4, w, s, t, r, sh, stride, relu_in, affine_in):
        b, h, wd, k = x4.shape
        m = b * -(-h // stride) * -(-wd // stride)
        with _counted("matmul_bn", m, k, w.shape[1]):
            y, ssum, ssq = _matmul_bn_fwd(x4, w, s, t, r, sh, stride,
                                          relu_in, affine_in)
        ctx.save_for_backward(x4, w, s, t, r, sh, y)
        ctx.cfg = (stride, relu_in, affine_in)
        return y, ssum, ssq

    @staticmethod
    def backward(ctx, dy, dsum, dsq):
        x4, w, s, t, r, sh, y = ctx.saved_tensors
        stride, relu_in, affine_in = ctx.cfg
        b, h, wd, k = x4.shape
        n = w.shape[1]
        x2 = x4[:, ::stride, ::stride].reshape(-1, k).contiguous()
        grads = (y.reshape(-1, n), dy.reshape(-1, n).contiguous(),
                 dsum.float().contiguous(), dsq.float().contiguous())
        m = x2.shape[0]
        with _counted("matmul_bn_dx", m, n, k):
            dx2, ds, dt, dr = _matmul_bn_dx(x2, w, s, t, r, sh, *grads,
                                            relu_in, affine_in)
        with _counted("matmul_bn_dw", m, k, n):
            dw = _matmul_bn_dw(x2, s, t, r, sh, *grads, relu_in,
                               affine_in)
        if stride == 1:
            dx = dx2.reshape(x4.shape)
        else:
            # the strided 1x1 reads every stride-th pixel: its backward
            # scatters into zeros
            dx = torch.zeros_like(x4)
            dx[:, ::stride, ::stride] = dx2.reshape(b, -(-h // stride),
                                                    -(-wd // stride), k)
        return dx, dw, ds, dt, dr, None, None, None, None


class _Conv3x3Bn(torch.autograd.Function):
    """The 3x3 with statistics (``_conv3``'s custom VJP): B2 forward, a
    plain-PyTorch backward (:func:`conv3x3_bn_bwd`)."""

    @staticmethod
    def forward(ctx, x, w, s, t, sh, stride, relu_in, affine_in):
        m = x.shape[0] * tf_same_pads(x.shape[1], 3, stride)[2] * \
            tf_same_pads(x.shape[2], 3, stride)[2]
        with _counted("conv3x3_bn", m, w.shape[2], w.shape[3], taps=9):
            y, ssum, ssq = _conv3x3_bn_fwd(x, w, s, t, sh, relu_in,
                                           affine_in, stride)
        ctx.save_for_backward(x, w, s, t, sh, y)
        ctx.cfg = (stride, relu_in, affine_in)
        return y, ssum, ssq

    @staticmethod
    def backward(ctx, dy, dsum, dsq):
        x, w, s, t, sh, y = ctx.saved_tensors
        stride, relu_in, affine_in = ctx.cfg
        dx, dw, ds, dt = conv3x3_bn_bwd(x, w, s, t, sh, y, dy, dsum.float(),
                                        dsq.float(), relu_in, affine_in,
                                        stride)
        return dx, dw, ds, dt, None, None, None, None


def _matmul_bn(x4, w, stride, in_scale, in_shift, relu_in, stat_shift,
               in_residual):
    k, n = _check_1x1("matmul_bn", x4, w)
    m = x4.shape[0] * -(-x4.shape[1] // stride) * -(-x4.shape[2] // stride)
    if in_residual is not None:
        if in_residual.numel() != m * k:
            raise ValueError(f"in_residual must hold {(m, k)} values, got "
                             f"{tuple(in_residual.shape)}")
        in_residual = in_residual.reshape(m, k)
    # shift-only callers get scale=1, not a silently dropped shift
    affine_in = in_scale is not None or in_shift is not None
    s = _vec(in_scale, k, 1.0, x4) if affine_in else None
    t = _vec(in_shift, k, 0.0, x4) if affine_in else None
    sh = _vec(stat_shift, n, 0.0, x4).detach()
    return _MatmulBn.apply(x4, w.to(x4.dtype), s, t, in_residual, sh,
                           stride, relu_in, affine_in)


def matmul_bn(x: torch.Tensor, w: torch.Tensor,
              in_scale: Optional[torch.Tensor] = None,
              in_shift: Optional[torch.Tensor] = None,
              relu_in: bool = False,
              stat_shift: Optional[torch.Tensor] = None,
              in_residual: Optional[torch.Tensor] = None):
    """``relu_in?(x * in_scale + in_shift [+ in_residual]) @ w`` with the
    BN-statistics epilogue, on ``x (M, K)``, ``w (K, N)``; K and N
    multiples of 64, M arbitrary (the kernel masks the ragged edge).
    Returns ``(y (M, N), sum (N,), sumsq (N,))``: the statistics are over
    ``acc - stat_shift`` in f32 (pass the BN's moving mean). ``w`` is
    cast to x's dtype. Differentiable in x, w, in_scale, in_shift and
    in_residual; the backward takes ``(dy, dsum, dsq)``."""
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    y, ssum, ssq = _matmul_bn(x.reshape(m, 1, 1, k), w, 1, in_scale,
                              in_shift, relu_in, stat_shift, in_residual)
    return y.reshape(m, -1), ssum, ssq


def conv1x1_bn(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               in_residual: Optional[torch.Tensor] = None, **kwargs):
    """NHWC 1x1 conv over every ``stride``-th pixel + BN statistics, via
    :func:`matmul_bn`. ``w``: (1, 1, C, F) or (C, F); ``in_residual``
    (N, H', W', C) joins the prologue. Returns ``(y (N, H', W', F), sum
    (F,), sumsq (F,))``."""
    if w.dim() == 4:
        w = w[0, 0]
    return _matmul_bn(x, w, int(stride), kwargs.pop("in_scale", None),
                      kwargs.pop("in_shift", None),
                      kwargs.pop("relu_in", False),
                      kwargs.pop("stat_shift", None), in_residual,
                      **kwargs)


def conv3x3_bn(x: torch.Tensor, w: torch.Tensor,
               in_scale: Optional[torch.Tensor] = None,
               in_shift: Optional[torch.Tensor] = None,
               relu_in: bool = False,
               stat_shift: Optional[torch.Tensor] = None,
               stride: int = 1):
    """Fused 3x3 SAME conv + BN statistics on NHWC ``x (B, H, W, Cin)``
    with HWIO ``w (3, 3, Cin, Cout)``, Cin and Cout multiples of 64,
    stride 1 or 2, any extent. Prologue and returns as
    :func:`matmul_bn`; ``stat_shift`` is not differentiated."""
    stride = int(stride)
    cin, cout = _check_3x3("conv3x3_bn", x, w, stride)
    affine_in = in_scale is not None or in_shift is not None
    s = _vec(in_scale, cin, 1.0, x) if affine_in else None
    t = _vec(in_shift, cin, 0.0, x) if affine_in else None
    sh = _vec(stat_shift, cout, 0.0, x).detach()
    return _Conv3x3Bn.apply(x, w, s, t, sh, stride, relu_in, affine_in)
