"""ONNX importer: an ONNX graph as a trainable layer that interprets its
nodes in torch (port of
``analytics_zoo_tpu/pipeline/api/onnx/onnx_loader.py``).

:class:`OnnxGraphLayer` walks the node list at every call, running each
op where its inputs are (the card, unless the caller asks for the CPU).
Float initializers become trainable params under ``"w"``, so an imported
model fine-tunes through the Estimator; integer initializers stay host
arrays. No hand-written kernel lies on this path: the reference
interprets the graph with ``lax.conv_general_dilated`` and ``jnp`` ops,
outside any Pallas kernel, and the port uses the library's convolutions
and products in the same places.

Semantics follow the reference op by op, including where it follows
JAX rather than ONNX:

- values that must be static (a Reshape's shape, Slice's bounds, Pad's
  pads, Range's operands) are read on the host, and a node whose inputs
  are all host arrays runs on the host and gives host arrays (``Shape``
  returns one), so a graph's shape arithmetic never reads the card; a
  static operand computed on the card raises, as a traced one does in
  the reference;
- float64 data becomes float32 (JAX without x64), including a Cast to
  DOUBLE;
- the integer convolutions and products (``ConvInteger``,
  ``MatMulInteger``, ``QLinearConv``, ``QLinearMatMul``, and MatMul on
  integers on the card) accumulate exactly: a float64 product of int8 or
  uint8 operands is exact, and is rounded back to int32;
- ``Resize``/``Upsample`` outside the exact gathers are
  ``jax.image.resize`` (:mod:`~analytics_zoo_tpu_torch.ops.resize`:
  antialiased downsampling, Keys cubic with a = -0.5);
- ``TopK`` takes the lower index first among ties (a stable sort), and
  ``ArgMax``/``ArgMin`` the first extreme whatever ``select_last_index``
  says, as ``jnp.argmax`` does in the reference;
- ``ScatterElements``/``ScatterND`` without a reduction raise when an
  index repeats, since the result would depend on the write order;
- ``Dropout`` in training draws its mask from a ``torch.Generator``
  seeded from the step's seed (``ops/rng.py``);
- an ``If`` whose condition lies on the card reads it (one sync) and
  runs the branch it names; the reference's jit path traces both.

``OnnxLoader.run_node`` executes one NodeProto on host arrays (the
backend-test hook) and returns host arrays.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common.utils import ceil_pool_extra
from analytics_zoo_tpu_torch.ops import resize as _resize
from analytics_zoo_tpu_torch.ops import rng as _rng
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer,
    as_shape,
    unique_name,
)
from analytics_zoo_tpu_torch.pipeline.api.onnx import onnx_pb
from analytics_zoo_tpu_torch.pipeline.api.onnx.helper import attribute_value
from analytics_zoo_tpu_torch.pipeline.api.onnx.onnx_pb import (
    ModelProto,
    NodeProto,
    tensor_to_numpy,
)

__all__ = ["OnnxLoader", "OnnxGraphLayer", "load", "run_node"]

# the device the running node's tensors go to
_DEVICE: "contextvars.ContextVar[torch.device]" = contextvars.ContextVar(
    "onnx_device", default=torch.device("cpu"))


@contextlib.contextmanager
def _on(device):
    token = _DEVICE.set(torch.device(device))
    try:
        yield
    finally:
        _DEVICE.reset(token)


def _attrs(node: NodeProto) -> Dict[str, Any]:
    return {a.name: attribute_value(a) for a in node.attribute}


_HOST = (np.ndarray, np.generic, bool, int, float)


def _host_array(x) -> np.ndarray:
    """A host value as the array JAX would hold: float64 as float32."""
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype in (np.uint16, np.uint32, np.uint64):
        a = a.astype(np.int64)
    return a


def _t(x) -> Optional[torch.Tensor]:
    """A graph value as a tensor: a tensor as it is, a host array on the
    running node's device."""
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(_host_array(x))).to(_DEVICE.get())


def _static(x) -> np.ndarray:
    """A graph value that must be static (a Reshape's shape, Slice's
    bounds, ...) as a host array; one computed on the card raises."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(
                "ONNX graph uses a data-dependent shape operand computed "
                f"on {x.device}; static operands must stay on the host")
        return x.detach().numpy()
    return np.asarray(x)


_TORCH_DTYPE = {
    np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float32, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.int32, np.dtype(np.uint32): torch.int64,
    np.dtype(np.uint64): torch.int64, np.dtype(np.bool_): torch.bool,
}


def _floating(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype.is_floating_point else x.float()


# -- op registry --------------------------------------------------------------

_OPS: Dict[str, Callable] = {}


def _register(*names: str):
    def deco(fn):
        for n in names:
            _OPS[n] = fn
        return fn
    return deco


def _pair_pads(pads: Sequence[int], n_spatial: int):
    """ONNX pads [b1..bn, e1..en] → [(b1,e1)..(bn,en)]."""
    if not pads:
        return [(0, 0)] * n_spatial
    return [(int(pads[i]), int(pads[i + n_spatial]))
            for i in range(n_spatial)]


def _auto_pads(auto_pad: str, in_spatial, kernel, strides, dilations):
    out = []
    for s, k, st, d in zip(in_spatial, kernel, strides, dilations):
        eff_k = (k - 1) * d + 1
        pad = max(0, (-(-s // st) - 1) * st + eff_k - s)
        if auto_pad == "SAME_UPPER":
            out.append((pad // 2, pad - pad // 2))
        else:  # SAME_LOWER
            out.append((pad - pad // 2, pad // 2))
    return out


def _pad_spatial(x, padding, value=0.0):
    """Pad the trailing len(padding) axes by (lo, hi) pairs; negative
    entries crop."""
    flat = []
    for lo, hi in reversed(padding):
        flat += [int(lo), int(hi)]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


def _unary(fn):
    return lambda a, i: fn(_t(i[0]))


def _binary(fn):
    return lambda a, i: fn(_t(i[0]), _t(i[1]))


def _stack_reduce(i, fn):
    if len(i) == 1:
        return _t(i[0])
    ts = torch.broadcast_tensors(*[_t(v) for v in i])
    return fn(torch.stack(ts))


# elementwise / unary
_register("Add")(_binary(torch.add))
_register("Sub")(_binary(torch.sub))
_register("Mul")(_binary(torch.mul))
_register("Div")(_binary(torch.true_divide))
_register("Pow")(lambda a, i: torch.pow(_t(i[0]),
                                        _t(i[1]).to(_t(i[0]).dtype)))
_register("Sqrt")(_unary(torch.sqrt))
_register("Exp")(_unary(torch.exp))
_register("Log")(_unary(torch.log))
_register("Abs")(_unary(torch.abs))
_register("Neg")(_unary(torch.neg))
_register("Sign")(_unary(torch.sign))
_register("Sin")(_unary(torch.sin))
_register("Cos")(_unary(torch.cos))
_register("Tan")(_unary(torch.tan))
_register("Asin")(_unary(torch.asin))
_register("Acos")(_unary(torch.acos))
_register("Atan")(_unary(torch.atan))
_register("Sinh")(_unary(torch.sinh))
_register("Cosh")(_unary(torch.cosh))
_register("Asinh")(_unary(torch.asinh))
_register("Acosh")(_unary(torch.acosh))
_register("Atanh")(_unary(torch.atanh))
_register("Floor")(_unary(torch.floor))
_register("Ceil")(_unary(torch.ceil))
_register("Round")(_unary(torch.round))
_register("Reciprocal")(_unary(lambda x: 1.0 / x))
_register("Erf")(_unary(torch.erf))
_register("Identity")(lambda a, i: i[0])
_register("Sum")(lambda a, i: sum((_t(v) for v in i[1:]), _t(i[0])))
_register("Max")(lambda a, i: _stack_reduce(i, lambda s: s.amax(0)))
_register("Min")(lambda a, i: _stack_reduce(i, lambda s: s.amin(0)))
_register("Mean")(lambda a, i: _stack_reduce(
    i, lambda s: _floating(s).mean(0)))

# comparisons / logic
_register("Equal")(_binary(torch.eq))
_register("Greater")(_binary(torch.gt))
_register("GreaterOrEqual")(_binary(torch.ge))
_register("Less")(_binary(torch.lt))
_register("LessOrEqual")(_binary(torch.le))
_register("And")(_binary(torch.logical_and))
_register("Or")(_binary(torch.logical_or))
_register("Not")(_unary(torch.logical_not))
_register("Where")(lambda a, i: torch.where(_t(i[0]).bool(), _t(i[1]),
                                            _t(i[2])))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# activations
_register("Relu")(_unary(torch.relu))
_register("LeakyRelu")(lambda a, i: (lambda x: torch.where(
    x >= 0, x, a.get("alpha", 0.01) * x))(_t(i[0])))
_register("PRelu")(lambda a, i: (lambda x, s: torch.where(
    x >= 0, x, s * x))(_t(i[0]), _t(i[1])))
_register("Sigmoid")(_unary(torch.sigmoid))
_register("HardSigmoid")(lambda a, i: torch.clamp(
    a.get("alpha", 0.2) * _t(i[0]) + a.get("beta", 0.5), 0.0, 1.0))
_register("Tanh")(_unary(torch.tanh))


def _softmax_family(tfn):
    def fn(a, i):
        x = _t(i[0])
        if a.get("__opset__", 13) >= 13:
            return tfn(x, a.get("axis", -1))
        # opset < 13: default axis 1, the flatten-to-2-D coercion
        axis = a.get("axis", 1) % x.dim()
        lead = math.prod(x.shape[:axis]) if axis else 1
        return tfn(x.reshape(lead, -1), -1).reshape(x.shape)
    return fn


_register("Softmax")(_softmax_family(torch.softmax))
_register("LogSoftmax")(_softmax_family(torch.log_softmax))
_register("Elu")(lambda a, i: (lambda x: torch.where(
    x > 0, x, a.get("alpha", 1.0) * (torch.exp(x) - 1)))(_t(i[0])))
_register("Selu")(lambda a, i: (lambda x: a.get(
    "gamma", 1.0507009873554805) * torch.where(
    x > 0, x, a.get("alpha", 1.6732632423543772) * (torch.exp(x) - 1)))(
    _t(i[0])))
_register("Softplus")(_unary(_softplus))
_register("Softsign")(_unary(lambda x: x / (1 + torch.abs(x))))
_register("ThresholdedRelu")(lambda a, i: (lambda x: torch.where(
    x > a.get("alpha", 1.0), x, torch.zeros_like(x)))(_t(i[0])))
_register("Gelu")(lambda a, i: F.gelu(
    _t(i[0]), approximate="tanh" if a.get("approximate", "none") == "tanh"
    else "none"))


@_register("Clip")
def _clip(a, i):
    lo = a.get("min") if len(i) < 2 or i[1] is None else i[1]
    hi = a.get("max") if len(i) < 3 or i[2] is None else i[2]
    x = _t(i[0])
    if lo is not None:
        x = torch.maximum(x, _t(lo))
    if hi is not None:
        x = torch.minimum(x, _t(hi))
    return x


# linear algebra
def _exact_int(fn, *args):
    """``fn`` over integer tensors, exactly: in float64 (exact while the
    sums stay below 2**53, as they do for 8-bit operands), rounded back
    to int32."""
    return torch.round(fn(*[a.double() for a in args])).to(torch.int32)


def _matmul(x, w):
    if not (x.dtype.is_floating_point or w.dtype.is_floating_point):
        if x.device.type != "cpu":
            return _exact_int(torch.matmul, x, w)
        return torch.matmul(x.to(torch.int32), w.to(torch.int32))
    return torch.matmul(x, w)


@_register("Gemm")
def _gemm(a, i):
    x, w = _t(i[0]), _t(i[1])
    if a.get("transA", 0):
        x = x.T
    if a.get("transB", 0):
        w = w.T
    y = a.get("alpha", 1.0) * _matmul(x, w)
    if len(i) > 2 and i[2] is not None:
        y = y + a.get("beta", 1.0) * _t(i[2])
    return y


_register("MatMul")(_binary(_matmul))


# convolution
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv_core(a, x, w, integer=False):
    """The shared NC... convolution (kernel/strides/dilations/group/
    pads, SAME_* auto-pad); ``integer`` accumulates integer operands
    exactly into int32."""
    n_sp = x.dim() - 2
    if n_sp not in _CONV:
        raise ValueError(f"Conv with {n_sp} spatial dims unsupported")
    kernel = a.get("kernel_shape", list(w.shape[2:]))
    strides = a.get("strides", [1] * n_sp)
    dilations = a.get("dilations", [1] * n_sp)
    group = a.get("group", 1)
    auto_pad = a.get("auto_pad", "NOTSET")
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        padding = _auto_pads(auto_pad, x.shape[2:], kernel, strides,
                             dilations)
    elif auto_pad == "VALID":
        padding = [(0, 0)] * n_sp
    else:
        padding = _pair_pads(a.get("pads", []), n_sp)
    conv = _CONV[n_sp]
    if all(lo == hi and lo >= 0 for lo, hi in padding):
        pad_arg = [lo for lo, _ in padding]
    else:
        x = _pad_spatial(x, padding)
        pad_arg = 0

    def run(x_, w_):
        return conv(x_, w_, stride=strides, padding=pad_arg,
                    dilation=dilations, groups=group)
    if integer:
        return _exact_int(run, x, w)
    return run(x, w)


@_register("Conv")
def _conv(a, i):
    x, w = _t(i[0]), _t(i[1])
    y = _conv_core(a, x, w.to(x.dtype))
    if len(i) > 2 and i[2] is not None:
        y = y + _t(i[2]).reshape((1, -1) + (1,) * (x.dim() - 2))
    return y


def _per_axis(vec, ndim, axis):
    """Broadcast a per-channel scale/zero-point vector to ``ndim`` dims
    along ``axis``; scalars (an omitted zero point too) pass through."""
    vec = _t(vec)
    if vec.dim() == 1 and vec.shape[0] > 1:
        if not -ndim <= axis < ndim:
            raise ValueError(
                f"per-channel quantization axis {axis} out of range "
                f"for rank-{ndim} input")
        shape = [1] * ndim
        shape[axis % ndim] = vec.shape[0]
        return vec.reshape(shape)
    return vec


def _zp_sub(x, zp, channel_axis=None):
    """An int32 tensor minus its zero point; a 1-D per-channel zero
    point aligns on ``channel_axis``."""
    x = _t(x).to(torch.int32)
    if zp is None:
        return x
    zp = _t(zp).to(torch.int32)
    if channel_axis is not None:
        zp = _per_axis(zp, x.dim(), channel_axis)
    return x - zp


def _requantize(y, y_zp):
    """Round, shift by the output zero point and saturate to its dtype
    (every QLinear* op)."""
    zp = _t(y_zp)
    info = torch.iinfo(zp.dtype)
    return torch.clamp(torch.round(y) + zp.to(torch.float32),
                       info.min, info.max).to(zp.dtype)


@_register("ConvInteger")
def _conv_integer(a, i):
    xz = i[2] if len(i) > 2 else None
    wz = i[3] if len(i) > 3 else None
    return _conv_core(a, _zp_sub(i[0], xz), _zp_sub(i[1], wz, 0),
                      integer=True)


@_register("MatMulInteger")
def _matmul_integer(a, i):
    x, w = _t(i[0]), _t(i[1])
    xz = i[2] if len(i) > 2 else None
    wz = i[3] if len(i) > 3 else None
    # the a-side 1-D zero point is per ROW (the second-to-last axis)
    return _exact_int(torch.matmul,
                      _zp_sub(x, xz, channel_axis=x.dim() - 2),
                      _zp_sub(w, wz))


@_register("QLinearConv")
def _qlinear_conv(a, i):
    (x, x_scale, x_zp, w, w_scale, w_zp, y_scale, y_zp) = i[:8]
    bias = i[8] if len(i) > 8 and i[8] is not None else None
    acc = _conv_core(a, _zp_sub(x, x_zp), _zp_sub(w, w_zp, 0),
                     integer=True)
    n_sp = _t(x).dim() - 2
    if bias is not None:   # int32 bias at scale x_scale * w_scale
        acc = acc + _t(bias).to(torch.int32).reshape(
            (1, -1) + (1,) * n_sp)
    ws = _per_axis(w_scale, n_sp + 2, 1)   # per output channel
    y = acc.to(torch.float32) * (_t(x_scale) * ws / _t(y_scale))
    return _requantize(y, y_zp)


@_register("ConvTranspose")
def _conv_transpose(a, i):
    x, w = _t(i[0]), _t(i[1])  # w: (C_in, C_out / group, k...)
    n_sp = x.dim() - 2
    strides = a.get("strides", [1] * n_sp)
    dilations = a.get("dilations", [1] * n_sp)
    group = a.get("group", 1)
    out_pad = a.get("output_padding", [0] * n_sp)
    kernel = list(w.shape[2:])
    auto_pad = a.get("auto_pad", "NOTSET")
    out_shape_attr = a.get("output_shape")
    if out_shape_attr or auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        # ONNX: total_padding = stride*(in-1) + out_pad + eff_k - out
        target = out_shape_attr or [s * st for s, st in
                                    zip(x.shape[2:], strides)]
        pads = []
        for s, st, k, d, op, ot in zip(x.shape[2:], strides, kernel,
                                       dilations, out_pad, target):
            total = max(st * (s - 1) + op + (k - 1) * d + 1 - ot, 0)
            if auto_pad == "SAME_LOWER":
                pads.append((total - total // 2, total // 2))
            else:
                pads.append((total // 2, total - total // 2))
    else:
        pads = _pair_pads(a.get("pads", []), n_sp)
    # the gradient-of-conv form: x dilated by the stride, convolved with
    # the spatially flipped kernel, padded so that
    # out = (in-1)*stride + eff_k - pad_b - pad_e + out_pad
    eff_k = [(k - 1) * d + 1 for k, d in zip(kernel, dilations)]
    padding = [(ek - 1 - pb, ek - 1 - pe + op)
               for ek, (pb, pe), op in zip(eff_k, pads, out_pad)]
    if any(s > 1 for s in strides):
        dil = torch.zeros(x.shape[:2] + tuple(
            (n - 1) * s + 1 for n, s in zip(x.shape[2:], strides)),
            dtype=x.dtype, device=x.device)
        dil[(slice(None), slice(None)) + tuple(
            slice(None, None, s) for s in strides)] = x
        x = dil
    w_flipped = torch.flip(w, dims=tuple(range(2, w.dim())))
    if group != 1:
        ci, co_g = w.shape[0], w.shape[1]
        w_g = w_flipped.reshape((group, ci // group, co_g)
                                + tuple(w.shape[2:])).transpose(1, 2)
        w_t = w_g.reshape((group * co_g, ci // group) + tuple(w.shape[2:]))
    else:
        w_t = w_flipped.transpose(0, 1)
    y = _CONV[n_sp](_pad_spatial(x, padding), w_t.to(x.dtype),
                    dilation=dilations, groups=group)
    if len(i) > 2 and i[2] is not None:
        y = y + _t(i[2]).reshape((1, -1) + (1,) * n_sp)
    return y


# pooling
_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _window_reduce(x, kernel, strides, dilations, padding, kind):
    """``lax.reduce_window`` of max (pad cells -inf) or sum (pad cells
    0) over the spatial axes of an NC... tensor."""
    n_sp = x.dim() - 2
    value = float("-inf") if kind == "max" else 0.0
    xp = _pad_spatial(x, padding, value)
    if x.dtype.is_floating_point and n_sp in (1, 2, 3):
        if kind == "max":
            return _MAXPOOL[n_sp](xp, kernel, strides, dilation=dilations)
        if all(d == 1 for d in dilations) and n_sp > 1:
            pool = F.avg_pool2d if n_sp == 2 else F.avg_pool3d
            return pool(xp, kernel, strides, divisor_override=1)
    # generic: windows as strided views, reduced
    y = xp
    for ax, (k, s, d) in enumerate(zip(kernel, strides, dilations)):
        y = y.unfold(2 + ax, (k - 1) * d + 1, s)[..., ::d]
    dims = tuple(range(-n_sp, 0))
    return y.amax(dims) if kind == "max" else y.sum(dims)


def _pool_common(a, x, kind):
    n_sp = x.dim() - 2
    kernel = a["kernel_shape"]
    strides = a.get("strides", [1] * n_sp)
    dilations = a.get("dilations", [1] * n_sp)
    auto_pad = a.get("auto_pad", "NOTSET")
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        padding = _auto_pads(auto_pad, x.shape[2:], kernel, strides,
                             dilations)
    elif auto_pad == "VALID":
        padding = [(0, 0)] * n_sp
    else:
        padding = _pair_pads(a.get("pads", []), n_sp)
    if a.get("ceil_mode", 0):
        # extend the trailing padding so floor windows give ceil mode's
        # count (torch/onnxruntime: the last window is dropped when it
        # starts past input + leading pad)
        padding = [
            (lo, hi + ceil_pool_extra(d, (k - 1) * dl + 1, st, lo, hi))
            for d, k, st, dl, (lo, hi) in zip(
                x.shape[2:], kernel, strides, dilations, padding)]
    return _window_reduce(x, kernel, strides, dilations, padding,
                          kind), padding


@_register("MaxPool")
def _maxpool(a, i):
    return _pool_common(a, _t(i[0]), "max")[0]


@_register("AveragePool")
def _avgpool(a, i):
    x = _t(i[0])
    if a.get("count_include_pad", 0) and a.get("ceil_mode", 0):
        raise NotImplementedError(
            "AveragePool ceil_mode with count_include_pad (divisor "
            "treatment of the ceil extension is runtime-ambiguous)")
    y, _ = _pool_common(a, x, "sum")
    if a.get("count_include_pad", 0):
        return y / float(np.prod(a["kernel_shape"]))
    counts, _ = _pool_common(a, torch.ones_like(x), "sum")
    return y / counts


_register("GlobalAveragePool")(lambda a, i: (lambda x: x.mean(
    dim=tuple(range(2, x.dim())), keepdim=True))(_t(i[0])))
_register("GlobalMaxPool")(lambda a, i: (lambda x: x.amax(
    dim=tuple(range(2, x.dim())), keepdim=True))(_t(i[0])))


# normalization
@_register("BatchNormalization")
def _batchnorm(a, i):
    x, scale, bias, mean, var = (_t(v) for v in i[:5])
    eps = a.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(var.float() + eps).to(x.dtype)
    return ((x - mean.reshape(shape)) * inv.reshape(shape)
            * scale.reshape(shape) + bias.reshape(shape))


@_register("InstanceNormalization")
def _instancenorm(a, i):
    x, scale, bias = (_t(v) for v in i[:3])
    eps = a.get("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, correction=0, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - mean) * torch.rsqrt(var + eps) * scale.reshape(shape)
            + bias.reshape(shape))


@_register("LayerNormalization")
def _layernorm(a, i):
    x, scale = _t(i[0]), _t(i[1])
    bias = _t(i[2]) if len(i) > 2 and i[2] is not None else None
    axes = tuple(range(a.get("axis", -1) % x.dim(), x.dim()))
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, correction=0, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + a.get("epsilon", 1e-5)) * scale
    return y + bias if bias is not None else y


@_register("LRN")
def _lrn(a, i):
    x = _t(i[0])
    size = a["size"]
    alpha, beta, bias = (a.get("alpha", 1e-4), a.get("beta", 0.75),
                         a.get("bias", 1.0))
    half = (size - 1) // 2
    sq = torch.movedim(x * x, 1, -1)
    acc = F.pad(sq, (half, size - 1 - half)).unfold(-1, size, 1).sum(-1)
    return x / torch.pow(bias + alpha / size * torch.movedim(acc, -1, 1),
                         beta)


# shape ops
@_register("Reshape")
def _reshape(a, i):
    shape = [int(v) for v in _static(i[1])] if len(i) > 1 else a["shape"]
    x = _t(i[0])
    out = [x.shape[idx] if s == 0 and not a.get("allowzero", 0) else int(s)
           for idx, s in enumerate(shape)]
    return x.reshape(out)


@_register("Flatten")
def _flatten(a, i):
    x = _t(i[0])
    axis = a.get("axis", 1)
    if axis < 0:  # ONNX: a negative axis counts from the rank
        axis += x.dim()
    lead = math.prod(x.shape[:axis]) if axis else 1
    return x.reshape(lead, -1)


_register("Transpose")(lambda a, i: (lambda x: x.permute(
    a.get("perm") or tuple(reversed(range(x.dim())))))(_t(i[0])))


@_register("Squeeze")
def _squeeze(a, i):
    axes = ([int(v) for v in _static(i[1])] if len(i) > 1 and
            i[1] is not None else a.get("axes"))
    x = _t(i[0])
    return torch.squeeze(x, tuple(axes)) if axes else torch.squeeze(x)


@_register("Unsqueeze")
def _unsqueeze(a, i):
    axes = ([int(v) for v in _static(i[1])] if len(i) > 1 and
            i[1] is not None else a["axes"])
    x = _t(i[0])
    out_rank = x.dim() + len(axes)  # negative axes index the OUTPUT rank
    for ax in sorted(ax % out_rank for ax in axes):
        x = x.unsqueeze(ax)
    return x


_register("Concat")(lambda a, i: torch.cat([_t(v) for v in i],
                                           dim=a["axis"]))


@_register("Split")
def _split(a, i):
    x = _t(i[0])
    axis = a.get("axis", 0)
    if len(i) > 1 and i[1] is not None:
        sizes = [int(v) for v in _static(i[1])]
    elif "split" in a:
        sizes = list(a["split"])
    else:
        # equal parts, as many as the node has outputs (handed in as
        # num_outputs); the last may be smaller
        n = a["num_outputs"]
        chunk = -(-x.shape[axis] // n)
        sizes = [chunk] * (n - 1) + [x.shape[axis] - chunk * (n - 1)]
    return tuple(torch.split(x, sizes, dim=axis))


@_register("Slice")
def _slice(a, i):
    x = _t(i[0])
    if len(i) > 1:  # opset >= 10: starts/ends/axes/steps as inputs
        starts = [int(v) for v in _static(i[1])]
        ends = [int(v) for v in _static(i[2])]
        axes = ([int(v) for v in _static(i[3])]
                if len(i) > 3 and i[3] is not None
                else list(range(len(starts))))
        steps = ([int(v) for v in _static(i[4])]
                 if len(i) > 4 and i[4] is not None else [1] * len(starts))
    else:  # opset 9: attributes
        starts, ends = a["starts"], a["ends"]
        axes = a.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    int64_min = -(1 << 63)
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = ax % x.dim()
        dim = x.shape[ax]
        if sp > 0:
            lo = max(st + dim, 0) if st < 0 else min(st, dim)
            if en >= (1 << 31) - 1:
                hi = dim
            else:
                hi = max(en + dim, 0) if en < 0 else min(en, dim)
            x = x[(slice(None),) * ax + (slice(lo, hi, sp),)]
        else:  # a negative step: torch slices forward only, so gather
            lo = max(st + dim, 0) if st < 0 else min(st, dim - 1)
            if en == int64_min or en + dim < 0:
                hi = None
            elif en < 0:
                hi = en + dim
            else:
                hi = min(en, dim)
            idx = list(range(dim))[slice(lo, hi, sp)]
            x = torch.index_select(x, ax, torch.tensor(
                idx, dtype=torch.int64, device=x.device))
    return x


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx)


@_register("Gather")
def _gather(a, i):
    x, idx = _t(i[0]), _t(i[1])
    axis = a.get("axis", 0) % x.dim()
    flat = torch.index_select(x, axis, _wrap(idx, x.shape[axis]).reshape(-1))
    return flat.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                        + tuple(x.shape[axis + 1:]))


@_register("GatherElements")
def _gather_elements(a, i):
    x, idx = _t(i[0]), _t(i[1])
    axis = a.get("axis", 0) % x.dim()
    return torch.gather(x, axis, _wrap(idx, x.shape[axis]))


@_register("Expand")
def _expand(a, i):
    target = [int(v) for v in _static(i[1])]
    x = _t(i[0])
    # numpy-style broadcast to the mutually broadcast shape
    return torch.broadcast_to(
        x, np.broadcast_shapes(tuple(x.shape), tuple(target)))


_register("Tile")(lambda a, i: torch.tile(
    _t(i[0]), tuple(int(v) for v in _static(i[1]))))

_PAD_MODES = {"reflect": "reflect", "edge": "edge", "wrap": "wrap"}


@_register("Pad")
def _pad(a, i):
    x = _t(i[0])
    mode = a.get("mode", "constant")
    pads = ([int(v) for v in _static(i[1])] if len(i) > 1 and
            i[1] is not None else a["pads"])
    value = 0.0
    if len(i) > 2 and i[2] is not None:
        value = float(_static(i[2]))
    elif "value" in a:
        value = a["value"]
    n = x.dim()
    pairs = [(pads[k], pads[k + n]) for k in range(n)]
    # ONNX allows negative pads (cropping): pad the positive part first
    pos = [(max(b, 0), max(e, 0)) for b, e in pairs]
    if mode == "constant":
        x = _pad_spatial(x, pos, value)
    else:
        # numpy's own edge rule per axis, as index gathers
        np_mode = _PAD_MODES[mode]
        for ax, (b, e) in enumerate(pos):
            if b or e:
                idx = np.pad(np.arange(x.shape[ax]), (b, e), mode=np_mode)
                x = torch.index_select(x, ax, torch.from_numpy(idx).to(
                    x.device))
    if any(b < 0 or e < 0 for b, e in pairs):
        x = x[tuple(slice(-min(b, 0), x.shape[k] + min(e, 0))
                    for k, (b, e) in enumerate(pairs))]
    return x


@_register("Shape")
def _shape(a, i):
    shape = np.asarray(tuple(i[0].shape), np.int64)
    return shape[a.get("start", 0):a.get("end")]


@_register("ConstantOfShape")
def _constant_of_shape(a, i):
    shape = [int(v) for v in _static(i[0])]
    t = a.get("value")
    if t is None:
        return torch.zeros(shape, dtype=torch.float32, device=_DEVICE.get())
    fill = _host_array(tensor_to_numpy(t))
    return torch.full(shape, fill.reshape(()).item(),
                      dtype=_TORCH_DTYPE[fill.dtype], device=_DEVICE.get())


@_register("Range")
def _range(a, i):
    vals = [_host_array(_static(v)) for v in i[:3]]
    dtype = _TORCH_DTYPE[np.result_type(*vals)]
    return torch.arange(*(v.item() for v in vals), dtype=dtype,
                        device=_DEVICE.get())


@_register("Cast")
def _cast(a, i):
    dt = onnx_pb._ONNX_TO_DTYPE.get(a["to"])
    if dt is None:
        if a["to"] == onnx_pb.TensorProto.BFLOAT16:
            return _t(i[0]).to(torch.bfloat16)
        raise TypeError(f"Cast to unsupported data_type {a['to']}")
    return _t(i[0]).to(_TORCH_DTYPE[np.dtype(dt)])


# reductions
def _prod(x, dims, keepdim):
    for d in sorted((d % x.dim() for d in dims), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


_REDUCERS = {
    "ReduceMean": lambda x, d, k: _floating(x).mean(d, keepdim=k),
    "ReduceSum": lambda x, d, k: x.sum(d, keepdim=k),
    "ReduceMax": lambda x, d, k: x.amax(d, keepdim=k),
    "ReduceMin": lambda x, d, k: x.amin(d, keepdim=k),
    "ReduceProd": _prod,
    "ReduceL1": lambda x, d, k: torch.abs(x).sum(d, keepdim=k),
    "ReduceSumSquare": lambda x, d, k: (x * x).sum(d, keepdim=k),
    "ReduceLogSum": lambda x, d, k: torch.log(x.sum(d, keepdim=k)),
    "ReduceL2": lambda x, d, k: torch.sqrt((x * x).sum(d, keepdim=k)),
    "ReduceLogSumExp": lambda x, d, k: torch.logsumexp(x, d, keepdim=k),
}


def _reduce(op_name):
    red = _REDUCERS[op_name]

    def fn(a, i):
        axes = a.get("axes")
        if axes is None and len(i) > 1 and i[1] is not None:
            axes = [int(v) for v in _static(i[1])]
        keep = bool(a.get("keepdims", 1))
        if axes is None and a.get("noop_with_empty_axes", 0):
            return i[0]
        x = _t(i[0])
        if axes is None:
            return red(x, tuple(range(x.dim())), keep)
        if not axes:
            # jnp reduces over no axis: each element alone
            return red(x.unsqueeze(0), (0,), False)
        return red(x, tuple(int(v) for v in axes), keep)
    return fn


for _name in _REDUCERS:
    _register(_name)(_reduce(_name))


def _rnn_common(a, i, n_gates):
    """The LSTM/GRU plumbing: X (T, B, I); W (D, G*H, I); R (D, G*H, H);
    B (D, 2*G*H) optional; sequence_lens and peepholes refused."""
    x, w, r = _t(i[0]), _t(i[1]), _t(i[2])
    b = _t(i[3]) if len(i) > 3 and i[3] is not None else None
    if len(i) > 4 and i[4] is not None:
        raise NotImplementedError("RNN sequence_lens")
    if len(i) > 7 and i[7] is not None:
        raise NotImplementedError("LSTM peephole weights (P)")
    for attr in ("activations", "activation_alpha",
                 "activation_beta", "clip", "input_forget"):
        if a.get(attr):
            raise NotImplementedError(f"RNN attribute {attr!r} "
                                      "(defaults only)")
    direction = a.get("direction", "forward")
    direction = direction.decode() if isinstance(direction, bytes) \
        else direction
    hidden = int(a["hidden_size"])
    dirs = w.shape[0]
    bsz = x.shape[1]
    if b is None:
        b = torch.zeros((dirs, 2 * n_gates * hidden), dtype=x.dtype,
                        device=x.device)
    return x, w, r, b, direction, hidden, dirs, bsz


def _lstm_dir(x, w, r, b, h, c, hidden):
    """One direction; ONNX gate order i, o, f, c."""
    wb, rb = b[:4 * hidden], b[4 * hidden:]
    ys = []
    for xt in x:
        g = xt @ w.T + h @ r.T + wb + rb
        i_, o_, f_, c_ = torch.chunk(g, 4, dim=-1)
        c = torch.sigmoid(f_) * c + torch.sigmoid(i_) * torch.tanh(c_)
        h = torch.sigmoid(o_) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys), h, c


def _reverse(direction, d):
    return direction == "reverse" or d == 1


@_register("LSTM")
def _lstm(a, i):
    x, w, r, b, direction, hidden, dirs, bsz = _rnn_common(a, i, 4)
    zeros = torch.zeros((dirs, bsz, hidden), dtype=x.dtype, device=x.device)
    h0 = _t(i[5]) if len(i) > 5 and i[5] is not None else zeros
    c0 = _t(i[6]) if len(i) > 6 and i[6] is not None else zeros
    outs = []
    for d in range(dirs):
        rev = _reverse(direction, d)
        ys, hT, cT = _lstm_dir(torch.flip(x, (0,)) if rev else x, w[d],
                               r[d], b[d], h0[d], c0[d], hidden)
        outs.append((torch.flip(ys, (0,)) if rev else ys, hT, cT))
    return (torch.stack([o[0] for o in outs], dim=1),   # (T, D, B, H)
            torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]))


@_register("GRU")
def _gru(a, i):
    x, w, r, b, direction, hidden, dirs, bsz = _rnn_common(a, i, 3)
    lbr = int(a.get("linear_before_reset", 0))
    h0 = (_t(i[5]) if len(i) > 5 and i[5] is not None else
          torch.zeros((dirs, bsz, hidden), dtype=x.dtype, device=x.device))

    def gru_dir(xd, wd, rd, bd, h):
        wz, wr_, wh = torch.chunk(wd, 3, dim=0)
        rz, rr, rh = torch.chunk(rd, 3, dim=0)
        wbz, wbr, wbh = torch.chunk(bd[:3 * hidden], 3)
        rbz, rbr, rbh = torch.chunk(bd[3 * hidden:], 3)
        ys = []
        for xt in xd:
            z = torch.sigmoid(xt @ wz.T + h @ rz.T + wbz + rbz)
            rt = torch.sigmoid(xt @ wr_.T + h @ rr.T + wbr + rbr)
            if lbr:
                hh = torch.tanh(xt @ wh.T + wbh + rt * (h @ rh.T + rbh))
            else:
                hh = torch.tanh(xt @ wh.T + wbh + (rt * h) @ rh.T + rbh)
            h = (1 - z) * hh + z * h
            ys.append(h)
        return torch.stack(ys), h

    outs = []
    for d in range(dirs):
        rev = _reverse(direction, d)
        ys, hT = gru_dir(torch.flip(x, (0,)) if rev else x, w[d], r[d],
                         b[d], h0[d])
        outs.append((torch.flip(ys, (0,)) if rev else ys, hT))
    return (torch.stack([o[0] for o in outs], dim=1),
            torch.stack([o[1] for o in outs]))


@_register("QuantizeLinear")
def _quantize_linear(a, i):
    x = _t(i[0])
    axis = int(a.get("axis", 1))
    scale = _per_axis(i[1], x.dim(), axis)
    zp = (i[2] if len(i) > 2 and i[2] is not None
          else np.zeros((), np.uint8))
    return _requantize(x / scale, _per_axis(zp, x.dim(), axis))


@_register("DequantizeLinear")
def _dequantize_linear(a, i):
    x = _t(i[0])
    axis = int(a.get("axis", 1))
    scale = _per_axis(i[1], x.dim(), axis)
    zp = (_t(i[2]) if len(i) > 2 and i[2] is not None
          else torch.zeros((), dtype=x.dtype, device=x.device))
    zp = _per_axis(zp, x.dim(), axis)
    return (x.to(torch.float32) - zp.to(torch.float32)) * scale


@_register("DynamicQuantizeLinear")
def _dynamic_quantize_linear(a, i):
    x = _t(i[0])
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    rmin = torch.minimum(x.min(), zero)
    rmax = torch.maximum(x.max(), zero)
    scale = (rmax - rmin) / 255.0
    # an all-zero input would give 0/0: a safe nonzero scale, as ORT
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zp = torch.clamp(torch.round(-rmin / scale), 0, 255).to(torch.uint8)
    q = torch.clamp(torch.round(x / scale) + zp.to(torch.float32),
                    0, 255).to(torch.uint8)
    return q, scale.to(torch.float32), zp


@_register("QLinearMatMul")
def _qlinear_matmul(a, i):
    (xa, a_scale, a_zp, xb, b_scale, b_zp, y_scale, y_zp) = i[:8]

    def a_side(v):
        # a-side 1-D scale/zero point is per ROW (second-to-last axis)
        v = _t(v)
        if v.dim() == 1 and v.shape[0] > 1:
            return v.reshape(tuple(v.shape) + (1,))
        return v
    af = _t(xa).to(torch.int32) - a_side(a_zp).to(torch.int32)
    bf = _t(xb).to(torch.int32) - _t(b_zp).to(torch.int32)
    acc = _exact_int(torch.matmul, af, bf)
    y = acc.to(torch.float32) * (a_side(a_scale) * _t(b_scale)
                                 / _t(y_scale))
    return _requantize(y, y_zp)


def _unique_or_raise(lin: torch.Tensor, op: str) -> None:
    """Refuse repeated target indices without a reduction: the
    reference's result would depend on the scatter's write order."""
    if lin.numel() and torch.unique(lin).numel() != lin.numel():
        raise NotImplementedError(
            f"{op} without a reduction and a repeated index: the result "
            "depends on the write order")


_SCATTER_REDUCE = {"add": "sum", "mul": "prod", "max": "amax",
                   "min": "amin"}


@_register("ScatterElements", "Scatter")
def _scatter_elements(a, i):
    x, idx, upd = _t(i[0]), _t(i[1]), _t(i[2])
    axis = int(a.get("axis", 0)) % x.dim()
    red = a.get("reduction", "none")
    idx = _wrap(idx, x.shape[axis])
    if red == "none":
        # the full target coordinates, linearised, must not repeat
        grids = torch.meshgrid(*[torch.arange(n, device=x.device)
                                 for n in idx.shape], indexing="ij")
        coords = list(grids)
        coords[axis] = idx
        lin = torch.zeros_like(idx)
        for c, n in zip(coords, x.shape):
            lin = lin * n + c
        _unique_or_raise(lin.reshape(-1), "ScatterElements")
        return x.scatter(axis, idx, upd.to(x.dtype))
    if red not in _SCATTER_REDUCE:
        raise NotImplementedError(f"ScatterElements reduction {red!r}")
    return x.scatter_reduce(axis, idx, upd.to(x.dtype),
                            reduce=_SCATTER_REDUCE[red], include_self=True)


_register("Celu")(lambda a, i: (lambda x, al: torch.clamp(x, min=0) + al *
                                torch.expm1(torch.clamp(x, max=0) / al))(
    _t(i[0]), a.get("alpha", 1.0)))


@_register("LpNormalization")
def _lp_normalization(a, i):
    x = _t(i[0])
    axis = int(a.get("axis", -1))
    p = int(a.get("p", 2))
    if p == 1:
        denom = torch.abs(x).sum(axis, keepdim=True)
    elif p == 2:
        denom = torch.sqrt((x * x).sum(axis, keepdim=True))
    else:
        raise NotImplementedError(f"LpNormalization p={p}")
    return x / denom


@_register("MeanVarianceNormalization")
def _mvn(a, i):
    x = _t(i[0])
    axes = tuple(a.get("axes", [0, 2, 3]))
    mean = x.mean(axes, keepdim=True)
    var = ((x - mean) ** 2).mean(axes, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-9)


_register("HardSwish")(_unary(lambda x: x * torch.clamp(
    x / 6.0 + 0.5, 0.0, 1.0)))
_register("Mish")(_unary(lambda x: x * torch.tanh(_softplus(x))))
_register("IsNaN")(_unary(torch.isnan))


@_register("IsInf")
def _isinf(a, i):
    x = _t(i[0])
    no = torch.zeros_like(x, dtype=torch.bool)
    pos = torch.isposinf(x) if a.get("detect_positive", 1) else no
    neg = torch.isneginf(x) if a.get("detect_negative", 1) else no
    return torch.logical_or(pos, neg)


@_register("Mod")
def _mod(a, i):
    if a.get("fmod", 0):
        return torch.fmod(_t(i[0]), _t(i[1]))
    return torch.remainder(_t(i[0]), _t(i[1]))


@_register("Shrink")
def _shrink(a, i):
    x = _t(i[0])
    lambd = a.get("lambd", 0.5)
    bias = a.get("bias", 0.0)
    return torch.where(x < -lambd, x + bias,
                       torch.where(x > lambd, x - bias,
                                   torch.zeros_like(x)))


@_register("GatherND")
def _gather_nd(a, i):
    x, idx = _t(i[0]), _t(i[1]).to(torch.int64)
    b = int(a.get("batch_dims", 0))
    lead = tuple(x.shape[:b])
    nb = math.prod(lead)
    xb = x.reshape((nb,) + tuple(x.shape[b:]))
    ib = idx.reshape((nb,) + tuple(idx.shape[b:]))
    batch = torch.arange(nb, device=x.device).reshape(
        (nb,) + (1,) * (ib.dim() - 2))
    out = xb[(batch,) + tuple(torch.movedim(ib, -1, 0))]
    return out.reshape(lead + tuple(out.shape[1:]))


@_register("ScatterND")
def _scatter_nd(a, i):
    x, idx, upd = _t(i[0]), _t(i[1]).to(torch.int64), _t(i[2])
    red = a.get("reduction", "none")
    red = red.decode() if isinstance(red, bytes) else red
    k = idx.shape[-1]
    lead = tuple(x.shape[:k])
    flat = x.reshape((math.prod(lead), -1))
    lin = torch.zeros(idx.shape[:-1], dtype=torch.int64, device=x.device)
    for j, n in enumerate(lead):
        lin = lin * n + _wrap(idx[..., j], n)
    lin = lin.reshape(-1)
    rows = upd.to(x.dtype).reshape((lin.numel(), flat.shape[1]))
    if red == "none":
        _unique_or_raise(lin, "ScatterND")
        return flat.index_copy(0, lin, rows).reshape(x.shape)
    if red not in _SCATTER_REDUCE:
        raise NotImplementedError(f"ScatterND reduction {red!r}")
    return flat.scatter_reduce(
        0, lin[:, None].expand(-1, flat.shape[1]), rows,
        reduce=_SCATTER_REDUCE[red], include_self=True).reshape(x.shape)


@_register("DepthToSpace")
def _depth_to_space(a, i):
    x = _t(i[0])
    b, c, h, w = x.shape
    bs = int(a["blocksize"])
    mode = a.get("mode", "DCR")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    if mode == "DCR":
        y = x.reshape(b, bs, bs, c // (bs * bs), h, w)
        y = y.permute(0, 3, 4, 1, 5, 2)
    else:  # CRD
        y = x.reshape(b, c // (bs * bs), bs, bs, h, w)
        y = y.permute(0, 1, 4, 2, 5, 3)
    return y.reshape(b, c // (bs * bs), h * bs, w * bs)


@_register("SpaceToDepth")
def _space_to_depth(a, i):
    x = _t(i[0])
    b, c, h, w = x.shape
    bs = int(a["blocksize"])
    y = x.reshape(b, c, h // bs, bs, w // bs, bs)
    y = y.permute(0, 3, 5, 1, 2, 4)
    return y.reshape(b, c * bs * bs, h // bs, w // bs)


@_register("OneHot")
def _onehot(a, i):
    indices, depth, values = i
    d = int(_static(depth).reshape(()))
    axis = int(a.get("axis", -1))
    vals = _host_array(_static(values))
    off_v, on_v = vals[0], vals[1]
    idx = _t(indices).to(torch.int64)
    idx = torch.where(idx < 0, idx + d, idx)   # ONNX's negative wrap
    vdt = _TORCH_DTYPE[vals.dtype]   # the output takes values' type
    oh = (idx.unsqueeze(-1) == torch.arange(d, device=idx.device)).to(vdt)
    if axis != -1:
        oh = torch.movedim(oh, -1, axis)
    return (oh * (on_v - off_v).item() + off_v.item()).to(vdt)


@_register("Trilu")
def _trilu(a, i):
    x = _t(i[0])
    k = int(_static(i[1]).reshape(())) if len(i) > 1 and \
        i[1] is not None else 0
    return torch.triu(x, k) if a.get("upper", 1) else torch.tril(x, k)


@_register("Einsum")
def _einsum(a, i):
    eq = a["equation"]
    eq = eq.decode() if isinstance(eq, bytes) else eq
    return torch.einsum(eq, *[_t(v) for v in i])


@_register("TopK")
def _topk(a, i):
    x = _t(i[0])
    k = int(_static(i[1]).reshape(())) if len(i) > 1 else int(a["k"])
    axis = int(a.get("axis", -1))
    largest = bool(a.get("largest", 1))
    xm = torch.movedim(x, axis, -1)
    # a stable sort: among equal values the lower index comes first, as
    # lax.top_k and the stable argsort give it
    vals, idx = torch.sort(xm, dim=-1, descending=largest, stable=True)
    return (torch.movedim(vals[..., :k], -1, axis),
            torch.movedim(idx[..., :k], -1, axis))


@_register("CumSum")
def _cumsum(a, i):
    axis = int(_static(i[1]).reshape(()))
    y = _t(i[0])
    if a.get("reverse", 0):
        y = torch.flip(y, (axis,))
    out = torch.cumsum(y, dim=axis)
    if a.get("exclusive", 0):
        n = out.shape[axis]
        out = torch.cat([torch.zeros_like(out.narrow(axis, 0, 1)),
                         out.narrow(axis, 0, n - 1)], dim=axis)
    if a.get("reverse", 0):
        out = torch.flip(out, (axis,))
    return out


def _arg(fn):
    def op(a, i):
        x = _t(i[0])
        return fn(x, dim=a.get("axis", 0),
                  keepdim=bool(a.get("keepdims", 1)))
    return op


_register("ArgMax")(_arg(torch.argmax))
_register("ArgMin")(_arg(torch.argmin))


def _resize_impl(a, i, ct, default_nearest="round_prefer_floor"):
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.elementwise \
        import align_corners_resize, nearest_round
    x = _t(i[0])
    mode = a.get("mode", "nearest")
    if len(i) >= 4 and i[3] is not None:  # Resize's sizes input
        sizes = [int(v) for v in _static(i[3])]
    else:
        scales_in = None
        for cand in (i[2] if len(i) > 2 else None,
                     i[1] if len(i) > 1 else None):
            if cand is not None and np.size(_static(cand)):
                scales_in = _static(cand)
                break
        if scales_in is None:
            scales_in = np.asarray(a.get("scales"))
        # ONNX: output_dim = floor(input_dim * scale)
        sizes = [int(np.floor(s * f)) for s, f in zip(x.shape, scales_in)]
    if mode == "nearest" and ct == "asymmetric":
        # opset-10 Upsample / torch Upsample: src = f(dst / scale) per
        # axis, integer gathers
        nearest = a.get("nearest_mode", default_nearest)
        for axis, (insz, outsz) in enumerate(zip(x.shape, sizes)):
            if insz == outsz:
                continue
            src = nearest_round(np.arange(outsz) * (insz / outsz), nearest)
            src = np.clip(src.astype(np.int64), 0, insz - 1)
            x = torch.index_select(x, axis, torch.from_numpy(src).to(
                x.device))
        return x
    method = {"nearest": "nearest", "linear": "linear",
              "cubic": "cubic"}[mode]
    if ct == "align_corners":
        return align_corners_resize(
            x, sizes, method=method,
            nearest_mode=a.get("nearest_mode", default_nearest))
    if ct not in ("half_pixel", "pytorch_half_pixel"):
        raise NotImplementedError(
            f"Resize coordinate_transformation_mode={ct!r} with "
            f"mode={mode!r}: only half_pixel(/pytorch_half_pixel), "
            "align_corners, or nearest+asymmetric, are supported")
    return _resize.resize(x, sizes, method)


@_register("Resize")
def _resize_op(a, i):
    return _resize_impl(
        a, i, a.get("coordinate_transformation_mode", "half_pixel"))


@_register("Upsample")
def _upsample(a, i):
    # opset <= 10 Upsample is asymmetric coordinates with floor
    return _resize_impl(a, i, "asymmetric", default_nearest="floor")


@_register("Dropout")
def _dropout(a, i, *, training=False, rng=None):
    x = _t(i[0])
    ratio = a.get("ratio", 0.5)
    if len(i) > 1 and i[1] is not None:
        ratio = float(_static(i[1]))
    if not training or ratio <= 0.0 or rng is None:
        return x
    keep = 1.0 - ratio
    u = torch.rand(x.shape, generator=_rng.generator(rng, x.device),
                   device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x)).to(x.dtype)


@_register("Constant")
def _constant(a, i):
    if "value" in a and a["value"] is not None:
        return tensor_to_numpy(a["value"])
    for k in ("value_float", "value_int"):
        if k in a:
            return np.asarray(a[k])
    if "value_floats" in a:
        return np.asarray(a["value_floats"], np.float32)
    if "value_ints" in a:
        return np.asarray(a["value_ints"], np.int64)
    raise ValueError("Constant node without value")


def _to_host(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    return v


def _call_op(node, op, attrs, args, training, rng):
    if node.op_type == "Dropout":
        return op(attrs, args, training=training, rng=rng)
    return op(attrs, args)


# -- graph interpreter layer --------------------------------------------------

class OnnxGraphLayer(KerasLayer):
    """A layer interpreting an ONNX GraphProto node by node.

    Float initializers become trainable params under ``"w"`` (float64 as
    float32); integer initializers stay host arrays. Inputs are the
    graph's non-initializer inputs, in order (a list for several).
    """

    def __init__(self, graph: onnx_pb.GraphProto,
                 name: Optional[str] = None, opset: int = 13,
                 input_shape=None):
        self.graph = graph
        self.opset = int(opset)
        self._constants: Dict[str, np.ndarray] = {}
        self._param_names: List[str] = []
        for t in graph.initializer:
            arr = tensor_to_numpy(t)
            self._constants[t.name] = arr
            if np.issubdtype(arr.dtype, np.floating):
                self._param_names.append(t.name)
        init_names = set(self._constants)
        self.input_names = [vi.name for vi in graph.input
                            if vi.name not in init_names]
        self.output_names = [vi.name for vi in graph.output]
        if input_shape is not None:
            shapes: Any = input_shape
        else:
            in_shapes = [_vi_shape(vi) for vi in graph.input
                         if vi.name not in init_names]
            for vi, s in zip(self.input_names, in_shapes):
                if any(d is None for d in s[1:]):
                    raise ValueError(
                        f"ONNX input {vi!r} has symbolic non-batch "
                        f"dims {s[1:]}; pass input_shape= to "
                        "OnnxLoader.load_model with concrete shapes "
                        "(batch dim excluded)")
            multi = len(in_shapes) > 1
            shapes = [s[1:] for s in in_shapes] if multi else \
                in_shapes[0][1:]
        super().__init__(input_shape=shapes,
                         name=name or unique_name("onnxgraph"))
        # the host constants the interpreter reads (params excluded)
        self._host = {k: v for k, v in self._constants.items()
                      if k not in set(self._param_names)}

    def build(self, generator, input_shape):
        del generator, input_shape
        return {"w": {n: torch.from_numpy(
            np.array(_host_array(self._constants[n])))
            for n in self._param_names}}

    def compute_output_shape(self, input_shape):
        multi = len(self.input_names) > 1
        shapes = input_shape if multi else [input_shape]
        params = {"w": {n: torch.from_numpy(
            np.array(_host_array(self._constants[n])))
            for n in self._param_names}}
        # shapes only: run on the meta device, or on the host's zeros
        # where an op has no meta version
        try:
            meta = torch.device("meta")
            with torch.no_grad():
                out = self._interpret(
                    {"w": {k: v.to(meta) for k, v in params["w"].items()}},
                    tuple(torch.empty((1,) + tuple(as_shape(s)),
                                      device=meta) for s in shapes),
                    training=False, rng=None)
        except (NotImplementedError, RuntimeError, ValueError):
            with torch.no_grad():
                out = self._interpret(
                    params, tuple(torch.zeros((1,) + tuple(as_shape(s)))
                                  for s in shapes), training=False,
                    rng=None)
        if len(self.output_names) > 1:
            return [tuple(o.shape[1:]) for o in out]
        return tuple(out[0].shape[1:])

    def call(self, params, inputs, *, training=False, rng=None):
        xs = (tuple(inputs) if isinstance(inputs, (list, tuple))
              else (inputs,))
        outs = self._interpret(params, xs, training=training, rng=rng)
        return list(outs) if len(outs) > 1 else outs[0]

    def _interpret(self, params, xs, *, training, rng):
        if len(xs) != len(self.input_names):
            raise ValueError(
                f"ONNX graph expects {len(self.input_names)} inputs "
                f"({self.input_names}), got {len(xs)}")
        devices = [v.device for v in list(xs) + list(
            params.get("w", {}).values()) if isinstance(v, torch.Tensor)]
        env: Dict[str, Any] = dict(self._host)
        env.update(params.get("w", {}))
        env.update(zip(self.input_names, xs))
        with _on(devices[0] if devices else "cpu"):
            self._run_nodes(self.graph.node, env, training=training,
                            rng=rng)
            missing = [n for n in self.output_names if n not in env]
            if missing:
                raise ValueError(
                    f"graph outputs never produced: {missing}")
            return tuple(_t(env[n]) for n in self.output_names)

    def _run_nodes(self, nodes, env, *, training, rng):
        """Interpret a node list into ``env`` (the top graph and If
        branches, which see the outer scope by name). A node whose
        inputs are all host arrays runs on the host and leaves host
        arrays."""
        for k, node in enumerate(nodes):
            sub_rng = (_rng.fold_in(rng, k) if rng is not None and
                       node.op_type in ("Dropout", "If") else None)
            if node.op_type == "If":
                self._run_if(node, env, training=training, rng=sub_rng)
                continue
            op = _OPS.get(node.op_type)
            if op is None:
                raise NotImplementedError(
                    f"ONNX op {node.op_type} (node {node.name or k})")
            args = [env[n] if n else None for n in node.input]
            attrs = _attrs(node)
            attrs["__opset__"] = self.opset
            if node.op_type == "Split":
                attrs.setdefault("num_outputs", len(node.output))
            if all(v is None or isinstance(v, _HOST) for v in args):
                with _on("cpu"):
                    out = _call_op(node, op, attrs, args, training,
                                   sub_rng)
                out = (tuple(_to_host(v) for v in out)
                       if isinstance(out, tuple) else _to_host(out))
            else:
                out = _call_op(node, op, attrs, args, training, sub_rng)
            if isinstance(out, tuple):
                for name, val in zip(node.output, out):
                    if name:
                        env[name] = val
            else:
                env[node.output[0]] = out

    def _run_if(self, node, env, *, training, rng):
        """ONNX If: the condition picks one branch, which alone is
        interpreted (the dead one may hold unsupported ops). A condition
        on the card is read there, one sync."""
        attrs = {a.name: a for a in node.attribute}
        cond = env[node.input[0]]
        if isinstance(cond, torch.Tensor):
            cond = bool(cond.reshape(()).item())
        else:
            cond = bool(np.asarray(cond).reshape(()))
        g = attribute_value(attrs["then_branch" if cond else "else_branch"])
        benv = dict(env)     # the outer scope, visible by name
        for t in g.initializer:
            benv[t.name] = tensor_to_numpy(t)
        self._run_nodes(g.node, benv, training=training, rng=rng)
        for name, o in zip(node.output, g.output):
            if name:
                env[name] = benv[o.name]


def _vi_shape(vi: onnx_pb.ValueInfoProto) -> tuple:
    """Shape from ValueInfo; symbolic (dim_param) or absent dims are
    None (the batch slot is ignored by the caller; non-batch Nones need
    an explicit input_shape)."""
    tt = vi.type.tensor_type if vi.type else None
    if tt is None or tt.shape is None:
        raise ValueError(f"graph input {vi.name} has no shape info")
    return tuple(int(d.dim_value) if d.dim_value else None
                 for d in tt.shape.dim)


# -- public API ---------------------------------------------------------------

class OnnxLoader:
    """Loads ONNX models as trainable nets and runs single nodes."""

    @staticmethod
    def load_model(path_or_bytes, input_shape=None) -> "Any":
        """An ONNX model (a path, bytes or a ``ModelProto``) as a
        ``Sequential`` of one :class:`OnnxGraphLayer`, its weights built
        on the first ``init_params``/``predict``/``compile`` (the
        context's device). ``input_shape`` (batch excluded; a list for
        several inputs) overrides the graph's declared shapes, and is
        needed where they are symbolic."""
        model_proto = (path_or_bytes
                       if isinstance(path_or_bytes, ModelProto)
                       else onnx_pb.load_model(path_or_bytes))
        opset = 13
        for op in model_proto.opset_import:
            if not op.domain:  # the default ONNX domain
                opset = int(op.version or 13)
        from analytics_zoo_tpu_torch.pipeline.api.keras.models import \
            Sequential
        layer = OnnxGraphLayer(model_proto.graph, opset=opset,
                               input_shape=input_shape)
        return Sequential([layer], name=model_proto.graph.name or None)

    @staticmethod
    def run_node(node: NodeProto, inputs: Sequence[Any], *, device=None,
                 **kwargs) -> List[np.ndarray]:
        """Execute one NodeProto on host arrays (or tensors) on
        ``device`` (default: the context's, the card) and return host
        arrays. ``opset``, ``training`` and ``rng`` (an int seed, for
        Dropout) as keywords."""
        op = _OPS.get(node.op_type)
        if op is None:
            raise NotImplementedError(f"ONNX op {node.op_type}")
        if device is None:
            from analytics_zoo_tpu_torch.common.nncontext import \
                get_nncontext
            device = get_nncontext().device
        args = [np.asarray(x) if isinstance(x, (list, tuple, int, float))
                else x for x in inputs]
        attrs = _attrs(node)
        attrs["__opset__"] = int(kwargs.get("opset", 13))
        if node.op_type == "Split":
            attrs.setdefault("num_outputs", len(node.output))
        with _on(device):
            out = _call_op(node, op, attrs, args,
                           kwargs.get("training", False), kwargs.get("rng"))
        outs = out if isinstance(out, tuple) else (out,)
        return [np.asarray(_to_host(o)) for o in outs]

    @staticmethod
    def supported_ops() -> List[str]:
        return sorted(_OPS)


load = OnnxLoader.load_model
run_node = OnnxLoader.run_node
