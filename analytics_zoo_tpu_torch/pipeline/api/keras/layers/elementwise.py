"""Elementwise and tensor-utility layers (port of
``analytics_zoo_tpu/pipeline/api/keras/layers/elementwise.py``), and the
resize helpers the ONNX importer shares with ``ResizeBilinear``.

The parametrised layers (CAdd, CMul, Mul, Scale, Highway, MaxoutDense)
keep the reference's param names and shapes and cast their params to the
input's dtype. RReLU and GaussianSampler draw in training from a
generator built from the seed the container hands them
(``ops/rng.py``); at inference RReLU uses the mean slope and
GaussianSampler returns the mean, as the reference does.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.ops import (activations, initializers,
                                         regularizers)
from analytics_zoo_tpu_torch.ops import resize as _resize
from analytics_zoo_tpu_torch.ops import rng as _rng
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, Shape, ShapeLike)


class AddConstant(KerasLayer):
    """y = x + constant."""

    def __init__(self, constant: float, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.constant = float(constant)

    def call(self, params, x, *, training=False, rng=None):
        return x + self.constant


class MulConstant(KerasLayer):
    """y = x * constant."""

    def __init__(self, constant: float, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.constant = float(constant)

    def call(self, params, x, *, training=False, rng=None):
        return x * self.constant


class CAdd(KerasLayer):
    """Learnable per-element bias of shape ``size``, broadcast against
    the input."""

    def __init__(self, size: Sequence[int], b_regularizer=None,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.size = tuple(int(d) for d in size)
        self.b_regularizer = regularizers.get(b_regularizer)

    def build(self, generator, input_shape: Shape) -> dict:
        return {"bias": torch.zeros(self.size)}

    def call(self, params, x, *, training=False, rng=None):
        return x + params["bias"].to(x.dtype)

    def regularizers(self):
        return ([("bias", self.b_regularizer)]
                if self.b_regularizer is not None else [])


class CMul(KerasLayer):
    """Learnable per-element scale of shape ``size``, broadcast against
    the input."""

    def __init__(self, size: Sequence[int], w_regularizer=None,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.size = tuple(int(d) for d in size)
        self.w_regularizer = regularizers.get(w_regularizer)

    def build(self, generator, input_shape: Shape) -> dict:
        return {"weight": torch.ones(self.size)}

    def call(self, params, x, *, training=False, rng=None):
        return x * params["weight"].to(x.dtype)

    def regularizers(self):
        return ([("weight", self.w_regularizer)]
                if self.w_regularizer is not None else [])


class Mul(KerasLayer):
    """One learnable scalar multiplier."""

    def build(self, generator, input_shape: Shape) -> dict:
        return {"weight": torch.ones(())}

    def call(self, params, x, *, training=False, rng=None):
        return x * params["weight"].to(x.dtype)


class Scale(KerasLayer):
    """CMul then CAdd over ``size``."""

    def __init__(self, size: Sequence[int], input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.size = tuple(int(d) for d in size)

    def build(self, generator, input_shape: Shape) -> dict:
        return {"weight": torch.ones(self.size),
                "bias": torch.zeros(self.size)}

    def call(self, params, x, *, training=False, rng=None):
        return (x * params["weight"].to(x.dtype)
                + params["bias"].to(x.dtype))


class Power(KerasLayer):
    """y = (shift + scale * x) ** power."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.power = float(power)
        self.scale = float(scale)
        self.shift = float(shift)

    def call(self, params, x, *, training=False, rng=None):
        return torch.pow(self.shift + self.scale * x, self.power)


class Negative(KerasLayer):
    """y = -x."""

    def call(self, params, x, *, training=False, rng=None):
        return -x


class Exp(KerasLayer):
    """y = exp(x)."""

    def call(self, params, x, *, training=False, rng=None):
        return torch.exp(x)


class Log(KerasLayer):
    """y = log(x)."""

    def call(self, params, x, *, training=False, rng=None):
        return torch.log(x)


class Sqrt(KerasLayer):
    """y = sqrt(x)."""

    def call(self, params, x, *, training=False, rng=None):
        return torch.sqrt(x)


class Square(KerasLayer):
    """y = x^2."""

    def call(self, params, x, *, training=False, rng=None):
        return torch.square(x)


class Identity(KerasLayer):
    """y = x."""

    def call(self, params, x, *, training=False, rng=None):
        return x


class BinaryThreshold(KerasLayer):
    """y = 1 where x > value, else 0, in x's dtype."""

    def __init__(self, value: float = 1e-6, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.value = float(value)

    def call(self, params, x, *, training=False, rng=None):
        return (x > self.value).to(x.dtype)


class Threshold(KerasLayer):
    """y = x where x > th, else ``value``."""

    def __init__(self, th: float = 1e-6, value: float = 0.0,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.th = float(th)
        self.value = float(value)

    def call(self, params, x, *, training=False, rng=None):
        return torch.where(x > self.th, x,
                           torch.full_like(x, self.value))


class HardShrink(KerasLayer):
    """y = x where |x| > value, else 0."""

    def __init__(self, value: float = 0.5, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.value = float(value)

    def call(self, params, x, *, training=False, rng=None):
        return torch.where(torch.abs(x) > self.value, x,
                           torch.zeros_like(x))


class SoftShrink(KerasLayer):
    """Soft shrinkage by ``value``."""

    def __init__(self, value: float = 0.5, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.value = float(value)

    def call(self, params, x, *, training=False, rng=None):
        lam = self.value
        return torch.where(x > lam, x - lam,
                           torch.where(x < -lam, x + lam,
                                       torch.zeros_like(x)))


class HardTanh(KerasLayer):
    """Clip to ``[min_value, max_value]``."""

    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    def call(self, params, x, *, training=False, rng=None):
        return torch.clamp(x, self.min_value, self.max_value)


class RReLU(KerasLayer):
    """Randomized leaky ReLU: training draws the negative slope
    uniformly from ``[lower, upper]`` per element; inference uses the
    mean slope."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.lower = float(lower)
        self.upper = float(upper)

    def call(self, params, x, *, training=False, rng=None):
        if training and rng is not None:
            u = torch.rand(x.shape, generator=_rng.generator(rng, x.device),
                           device=x.device, dtype=x.dtype)
            slope = self.lower + (self.upper - self.lower) * u
        else:
            slope = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, x * slope)


class GaussianSampler(KerasLayer):
    """VAE reparameterisation over inputs ``[mean, log_var]``: ``mean +
    exp(log_var / 2) * eps`` in training, ``mean`` at inference."""

    def call(self, params, inputs, *, training=False, rng=None):
        mean, log_var = inputs
        if not training or rng is None:
            return mean
        eps = torch.randn(mean.shape,
                          generator=_rng.generator(rng, mean.device),
                          device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(log_var * 0.5) * eps

    def compute_output_shape(self, input_shape: ShapeLike) -> Shape:
        return tuple(input_shape[0])


class GetShape(KerasLayer):
    """The input's shape, batch included, as an int32 row per sample."""

    def call(self, params, x, *, training=False, rng=None):
        vec = torch.tensor(tuple(x.shape), dtype=torch.int32,
                           device=x.device)
        return vec.expand(x.shape[0], vec.numel())

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return (len(input_shape) + 1,)


class Expand(KerasLayer):
    """Broadcast size-1 dims up to ``tgt_sizes`` (batch included; -1
    keeps a dim)."""

    def __init__(self, tgt_sizes: Sequence[int], input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.tgt_sizes = tuple(int(d) for d in tgt_sizes)

    def _target(self, shape):
        return tuple(s if t == -1 else t
                     for s, t in zip(shape, self.tgt_sizes))

    def call(self, params, x, *, training=False, rng=None):
        return torch.broadcast_to(x, self._target(tuple(x.shape)))

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return self._target((None,) + tuple(input_shape))[1:]


class Max(KerasLayer):
    """Max over the 1-indexed non-batch dim ``dim``; ``return_value=
    False`` gives the int32 index of the first maximum instead."""

    def __init__(self, dim: int, return_value: bool = True,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.dim = int(dim)
        self.return_value = bool(return_value)

    def call(self, params, x, *, training=False, rng=None):
        if self.return_value:
            return torch.amax(x, dim=self.dim)
        return torch.argmax(x, dim=self.dim).to(torch.int32)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        shape = list(input_shape)
        del shape[self.dim - 1]
        return tuple(shape)


def nearest_round(pos, mode: str):
    """ONNX Resize's ``nearest_mode`` rounding of sample positions (host
    arrays); an unknown mode raises."""
    if mode == "floor":
        return np.floor(pos)
    if mode == "ceil":
        return np.ceil(pos)
    if mode == "round_prefer_ceil":
        return np.floor(np.asarray(pos) + 0.5)
    if mode == "round_prefer_floor":
        return np.ceil(np.asarray(pos) - 0.5)
    raise NotImplementedError(f"Resize nearest_mode {mode!r}")


def align_corners_resize(x, sizes, method: str = "linear",
                         nearest_mode: str = "round_prefer_floor"):
    """Corner-aligned resize to ``sizes`` (every axis): output pixel i
    samples the input at ``i * (in - 1) / (out - 1)``, with no
    antialiasing on downscale. An axis of input size 1 repeats its
    pixel; an axis of output size 1 samples corner 0. "nearest" gathers
    exact rows by ``nearest_mode``; "linear" is
    :func:`~analytics_zoo_tpu_torch.ops.resize.scale_and_translate` with
    the corner-aligned scale and translation; cubic is refused (its
    kernel's coefficient is not ONNX's)."""
    sizes = tuple(int(v) for v in sizes)
    if method == "nearest":
        for ax, (insz, outsz) in enumerate(zip(x.shape, sizes)):
            if insz == outsz:
                continue
            pos = np.arange(outsz) * ((insz - 1) / max(outsz - 1, 1))
            src = nearest_round(pos, nearest_mode)
            idx = np.clip(src.astype(np.int64), 0, insz - 1)
            x = torch.index_select(x, ax, torch.from_numpy(idx).to(x.device))
        return x
    if method not in ("linear",):
        raise NotImplementedError(
            f"align_corners resize supports linear/nearest, not "
            f"{method!r} (cubic coefficient mismatch vs ONNX)")
    axes, scales, trans, bcast = [], [], [], []
    for ax, (insz, outsz) in enumerate(zip(x.shape, sizes)):
        if insz == outsz:
            continue
        if insz == 1:
            bcast.append(ax)
            continue
        axes.append(ax)
        k = (outsz - 1) / (insz - 1) if outsz > 1 else 1.0
        scales.append(k)
        trans.append(0.5 - 0.5 * k)
    if axes:
        mid = list(x.shape)
        for ax in axes:
            mid[ax] = sizes[ax]
        x = _resize.scale_and_translate(x, tuple(mid), tuple(axes), scales,
                                        trans, method=method,
                                        antialias=False)
    for ax in bcast:
        x = torch.repeat_interleave(x, sizes[ax], dim=ax)
    return x


class ResizeBilinear(KerasLayer):
    """Bilinear spatial resize to ``(output_height, output_width)``, NHWC
    (``dim_ordering="tf"``) or NCHW (``"th"``): ``jax.image.resize``'s
    bilinear (antialiased when downsampling), or corner-aligned with
    ``align_corners``."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False, dim_ordering: str = "tf",
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.output_height = int(output_height)
        self.output_width = int(output_width)
        self.align_corners = bool(align_corners)
        if dim_ordering not in ("tf", "th"):
            raise ValueError("dim_ordering must be 'tf' or 'th'")
        self.dim_ordering = dim_ordering

    def call(self, params, x, *, training=False, rng=None):
        h, w = self.output_height, self.output_width
        if self.dim_ordering == "tf":
            out_shape = (x.shape[0], h, w, x.shape[3])
        else:
            out_shape = (x.shape[0], x.shape[1], h, w)
        if not self.align_corners:
            return _resize.resize(x, out_shape, "bilinear")
        return align_corners_resize(x, out_shape, method="linear")

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        h, w = self.output_height, self.output_width
        if self.dim_ordering == "tf":
            return (h, w, input_shape[2])
        return (input_shape[0], h, w)


class SelectTable(KerasLayer):
    """The ``index``-th tensor of a multi-tensor input (0-indexed)."""

    def __init__(self, index: int, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.index = int(index)

    def call(self, params, inputs, *, training=False, rng=None):
        return inputs[self.index]

    def compute_output_shape(self, input_shape: ShapeLike) -> Shape:
        return tuple(input_shape[self.index])


class SplitTensor(KerasLayer):
    """Split the 1-indexed non-batch dim ``dimension`` into ``num``
    equal slices (a multi-output layer)."""

    def __init__(self, dimension: int, num: int, input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.dimension = int(dimension)
        self.num = int(num)

    def call(self, params, x, *, training=False, rng=None):
        return list(torch.chunk(x, self.num, dim=self.dimension))

    def compute_output_shape(self, input_shape: Shape) -> ShapeLike:
        shape = list(input_shape)
        d = self.dimension - 1
        if shape[d] % self.num != 0:
            raise ValueError(
                f"{self.name}: dim {self.dimension} size {shape[d]} not "
                f"divisible by {self.num}")
        shape[d] //= self.num
        return [tuple(shape) for _ in range(self.num)]


class KerasLayerWrapper(KerasLayer):
    """A params-free tensor function as a layer; ``output_shape_fn``
    maps the input shape to the output's (identity when omitted)."""

    def __init__(self, fn: Callable, output_shape_fn: Optional[Callable] =
                 None, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.fn = fn
        self.output_shape_fn = output_shape_fn

    def call(self, params, x, *, training=False, rng=None):
        return self.fn(x)

    def compute_output_shape(self, input_shape: ShapeLike) -> ShapeLike:
        if self.output_shape_fn is not None:
            return self.output_shape_fn(input_shape)
        return input_shape


class Highway(KerasLayer):
    """Highway dense block: ``t * h(x) + (1 - t) * x`` with ``t`` a
    sigmoid gate (its bias starts at -1, so an untrained block mostly
    carries its input)."""

    def __init__(self, activation=None, w_regularizer=None,
                 b_regularizer=None, bias: bool = True, input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.activation = activations.get(activation) or activations.linear
        self.w_regularizer = regularizers.get(w_regularizer)
        self.b_regularizer = regularizers.get(b_regularizer)
        self.bias = bias

    def build(self, generator, input_shape: Shape) -> dict:
        dim = input_shape[-1]
        init = initializers.get("glorot_uniform")
        params = {"kernel": init(generator, (dim, dim)),
                  "gate_kernel": init(generator, (dim, dim))}
        if self.bias:
            params["bias"] = torch.zeros((dim,))
            params["gate_bias"] = -torch.ones((dim,))
        return params

    def call(self, params, x, *, training=False, rng=None):
        h = x @ params["kernel"].to(x.dtype)
        t = x @ params["gate_kernel"].to(x.dtype)
        if self.bias:
            h = h + params["bias"].to(x.dtype)
            t = t + params["gate_bias"].to(x.dtype)
        t = torch.sigmoid(t)
        return t * self.activation(h) + (1.0 - t) * x

    def regularizers(self):
        out = []
        if self.w_regularizer is not None:
            out += [("kernel", self.w_regularizer),
                    ("gate_kernel", self.w_regularizer)]
        if self.b_regularizer is not None and self.bias:
            out += [("bias", self.b_regularizer),
                    ("gate_bias", self.b_regularizer)]
        return out


class MaxoutDense(KerasLayer):
    """Dense with a max over ``nb_feature`` linear pieces; kernel
    ``(nb_feature, in, out)``."""

    def __init__(self, output_dim: int, nb_feature: int = 4,
                 w_regularizer=None, b_regularizer=None, bias: bool = True,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.output_dim = int(output_dim)
        self.nb_feature = int(nb_feature)
        self.w_regularizer = regularizers.get(w_regularizer)
        self.b_regularizer = regularizers.get(b_regularizer)
        self.bias = bias

    def build(self, generator, input_shape: Shape) -> dict:
        init = initializers.get("glorot_uniform")
        params = {"kernel": init(generator, (self.nb_feature,
                                             input_shape[-1],
                                             self.output_dim))}
        if self.bias:
            params["bias"] = torch.zeros((self.nb_feature, self.output_dim))
        return params

    def call(self, params, x, *, training=False, rng=None):
        y = torch.einsum("bi,fio->bfo", x, params["kernel"].to(x.dtype))
        if self.bias:
            y = y + params["bias"].to(y.dtype)
        return torch.amax(y, dim=1)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return tuple(input_shape[:-1]) + (self.output_dim,)

    def regularizers(self):
        out = []
        if self.w_regularizer is not None:
            out.append(("kernel", self.w_regularizer))
        if self.b_regularizer is not None and self.bias:
            out.append(("bias", self.b_regularizer))
        return out
