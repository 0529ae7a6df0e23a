"""Convolution1D, Convolution2D and DepthwiseConvolution2D, and the
shape layers ZeroPadding1D/2D, Cropping1D/2D and UpSampling1D/2D/3D
(port of ``analytics_zoo_tpu/pipeline/api/keras/layers/conv.py``):
channels-last activations (NWC, NHWC) by default, WIO and HWIO kernels,
TF "SAME" or "VALID" padding.

PyTorch pads symmetrically, but TF "SAME" puts the odd extra row and
column at the high end (the stem 7x7/s2 on 224 pads (2, 3)), so an
asymmetric SAME pads explicitly before the convolution. A dilated
kernel pads for its dilated extent ``(k - 1) * d + 1`` (SSD's fc6, 3x3
at dilation 6, pads 6 each side). ``groups`` splits the input and
output channels into groups convolved apart, in XLA's
``feature_group_count`` order, which is PyTorch's. This layer is a
library convolution: in the reference it lies outside any Pallas kernel
(the stem and the unfused comparison graph). A strided convolution goes
through :func:`~analytics_zoo_tpu_torch.ops.conv_grad.conv2d`, as the
reference's does: the same forward, and a backward gated between cuDNN's
strided one and the phase decomposition (``ZOO_TPU_PHASE_BWD``). A
strided convolution with groups or dilation goes to ``F.conv2d``, as
the reference's goes to ``lax.conv_general_dilated``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.ops import (activations, conv_grad,
                                         initializers, regularizers)
from analytics_zoo_tpu_torch.ops.conv_bn import tf_same_pads
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, Shape)


def _norm_tuple(v, n, name):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    if len(v) != n:
        raise ValueError(f"{name} must have length {n}, got {v}")
    return v


def _conv_out_len(length, k, stride, border_mode, dilation=1):
    if border_mode == "same":
        return -(-length // stride)
    return -(-(length - (k - 1) * dilation) // stride)


def _dilated(kernel, dilation):
    """The extent each kernel axis covers at its dilation."""
    return tuple((k - 1) * d + 1 for k, d in zip(kernel, dilation))


def _check_groups(groups, nb_filter):
    groups = int(groups)
    if groups < 1 or int(nb_filter) % groups:
        raise ValueError(f"nb_filter {nb_filter} must divide by groups "
                         f"{groups}")
    return groups


def _grouped_in(input_shape, groups, channels_first=False):
    c = input_shape[0] if channels_first else input_shape[-1]
    if c % groups:
        raise ValueError(f"input channels {c} must divide "
                         f"by groups {groups}")
    return c // groups


def pad_nchw(x, kernel, strides, border_mode):
    """Zero-pad an NCHW view for TF-style ``border_mode``; returns the
    padded tensor and the symmetric ``padding=`` left for the op (a
    symmetric SAME is handed to the op instead of copied)."""
    if border_mode == "valid":
        return x, (0, 0)
    pt, pb, _ = tf_same_pads(x.shape[2], kernel[0], strides[0])
    pl, pr, _ = tf_same_pads(x.shape[3], kernel[1], strides[1])
    if (pt, pl) == (pb, pr):
        return x, (pt, pl)
    return F.pad(x, (pl, pr, pt, pb)), (0, 0)


class Convolution1D(KerasLayer):
    """1-D convolution over (steps, input_dim) with a ``(filter_length,
    input_dim, nb_filter)`` kernel (cast to the input's dtype), run as
    ``F.conv1d`` over a channels-first view; ``subsample_length`` is
    the stride (the reference maps it to ``subsample``); ``dilation``
    and ``groups`` as the reference's. A library convolution, as the
    reference's ``lax.conv_general_dilated`` is."""

    def __init__(self, nb_filter: int, filter_length: int,
                 init="glorot_uniform", activation=None,
                 border_mode: str = "valid", subsample_length: int = 1,
                 dilation=1, w_regularizer=None, b_regularizer=None,
                 bias: bool = True, groups: int = 1, input_shape=None,
                 name=None, **kwargs):
        subsample = kwargs.pop("subsample", subsample_length)
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode must be valid|same, "
                             f"got {border_mode}")
        self.groups = _check_groups(groups, nb_filter)
        self.nb_filter = int(nb_filter)
        self.kernel_size = _norm_tuple(filter_length, 1, "kernel_size")
        self.subsample = _norm_tuple(subsample, 1, "subsample")
        self.dilation = _norm_tuple(dilation, 1, "dilation")
        self.border_mode = border_mode
        self.kernel_init = initializers.get(init)
        self.activation = activations.get(activation)
        self.w_regularizer = regularizers.get(w_regularizer)
        self.b_regularizer = regularizers.get(b_regularizer)
        self.use_bias = bool(bias)

    def build(self, generator, input_shape: Shape) -> dict:
        params = {"kernel": self.kernel_init(
            generator, self.kernel_size + (
                _grouped_in(input_shape, self.groups), self.nb_filter))}
        if self.use_bias:
            params["bias"] = torch.zeros((self.nb_filter,))
        return params

    def call(self, params, x, *, training=False, rng=None):
        (k,), (stride,), (d,) = (self.kernel_size, self.subsample,
                                 self.dilation)
        xc = x.transpose(1, 2)
        if self.border_mode == "same":
            lo, hi, _ = tf_same_pads(xc.shape[2], (k - 1) * d + 1, stride)
            xc = F.pad(xc, (lo, hi))
        w = params["kernel"].to(x.dtype).permute(2, 1, 0)
        y = F.conv1d(xc, w, stride=stride, dilation=d,
                     groups=self.groups).transpose(1, 2)
        if self.use_bias:
            y = y + params["bias"].to(y.dtype)
        if self.activation is not None:
            y = self.activation(y)
        return y.contiguous()

    def regularizers(self):
        out = []
        if self.w_regularizer is not None:
            out.append(("kernel", self.w_regularizer))
        if self.b_regularizer is not None:
            out.append(("bias", self.b_regularizer))
        return out

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return (_conv_out_len(input_shape[0], self.kernel_size[0],
                              self.subsample[0], self.border_mode,
                              self.dilation[0]),
                self.nb_filter)


class Convolution2D(KerasLayer):
    """2-D convolution over NHWC input (``dim_ordering="tf"``) or NCHW
    input (``"th"``, the layout of the Caffe, BigDL and torch importers)
    with an HWIO kernel ``(kh, kw, in / groups, nb_filter)``, cast to
    the input's dtype. ``nb_row`` may be a ``(kh, kw)`` pair, as the
    importers pass it."""

    def __init__(self, nb_filter: int, nb_row, nb_col: Optional[int] = None,
                 init="glorot_uniform", activation=None,
                 border_mode: str = "valid", subsample=1, dilation=1,
                 dim_ordering: str = "tf", w_regularizer=None,
                 b_regularizer=None, bias: bool = True, groups: int = 1,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode must be valid|same, "
                             f"got {border_mode}")
        if dim_ordering not in ("tf", "th"):
            raise ValueError("dim_ordering must be 'tf' (channels-last) or "
                             "'th' (channels-first)")
        self.dim_ordering = dim_ordering
        self.groups = _check_groups(groups, nb_filter)
        self.nb_filter = int(nb_filter)
        self.kernel_size = _norm_tuple(
            nb_row if nb_col is None else (nb_row, nb_col), 2,
            "kernel_size")
        self.subsample = _norm_tuple(subsample, 2, "subsample")
        self.dilation = _norm_tuple(dilation, 2, "dilation")
        self.border_mode = border_mode
        self.kernel_init = initializers.get(init)
        self.activation = activations.get(activation)
        self.w_regularizer = regularizers.get(w_regularizer)
        self.b_regularizer = regularizers.get(b_regularizer)
        self.use_bias = bool(bias)

    def build(self, generator, input_shape: Shape) -> dict:
        params = {"kernel": self.kernel_init(
            generator, self.kernel_size + (
                _grouped_in(input_shape, self.groups,
                            self.dim_ordering == "th"), self.nb_filter))}
        if self.use_bias:
            params["bias"] = torch.zeros((self.nb_filter,))
        return params

    def call(self, params, x, *, training=False, rng=None):
        tf = self.dim_ordering == "tf"
        if (tf and max(self.subsample) > 1 and self.groups == 1
                and self.dilation == (1, 1)):
            y = conv_grad.conv2d(x, params["kernel"].to(x.dtype),
                                 stride=self.subsample,
                                 padding=self.border_mode)
        else:
            xc, padding = pad_nchw(x.permute(0, 3, 1, 2) if tf else x,
                                   _dilated(self.kernel_size, self.dilation),
                                   self.subsample, self.border_mode)
            w = params["kernel"].to(x.dtype).permute(3, 2, 0, 1)
            y = F.conv2d(xc, w, stride=self.subsample, padding=padding,
                         dilation=self.dilation, groups=self.groups)
            if tf:
                y = y.permute(0, 2, 3, 1)
        if self.use_bias:
            b = params["bias"].to(y.dtype)
            y = y + (b if tf else b.reshape(1, -1, 1, 1))
        if self.activation is not None:
            y = self.activation(y)
        return y.contiguous()

    def regularizers(self):
        out = []
        if self.w_regularizer is not None:
            out.append(("kernel", self.w_regularizer))
        if self.b_regularizer is not None:
            out.append(("bias", self.b_regularizer))
        return out

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        tf = self.dim_ordering == "tf"
        out = tuple(_conv_out_len(s, k, st, self.border_mode, d)
                    for s, k, st, d in zip(
                        input_shape[:2] if tf else input_shape[1:3],
                        self.kernel_size, self.subsample, self.dilation))
        return out + (self.nb_filter,) if tf else (self.nb_filter,) + out


class DepthwiseConvolution2D(KerasLayer):
    """Depthwise 2-D convolution (MobileNet's building block): each
    input channel convolved with ``depth_multiplier`` filters of its
    own. The kernel is kept as the reference keeps it, HWIO ``(kh, kw,
    1, in * mult)`` under ``"depthwise"``, and runs as a grouped
    ``F.conv2d`` (``groups = in``) with the weight viewed as ``(in *
    mult, 1, kh, kw)``: XLA's ``feature_group_count`` and PyTorch's
    groups both order the output channels ``c * mult + m``. A library
    convolution, as the reference's ``lax.conv`` is."""

    def __init__(self, nb_row: int, nb_col=None, init="glorot_uniform",
                 activation=None, border_mode="valid", subsample=(1, 1),
                 depth_multiplier=1, dim_ordering="tf", w_regularizer=None,
                 b_regularizer=None, bias=True, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode must be valid|same, "
                             f"got {border_mode}")
        if dim_ordering not in ("tf", "th"):
            raise ValueError("dim_ordering must be 'tf' or 'th'")
        self.kernel_size = (_norm_tuple(nb_row, 1, "nb_row")[0],
                            _norm_tuple(nb_col if nb_col is not None
                                        else nb_row, 1, "nb_col")[0])
        self.subsample = _norm_tuple(subsample, 2, "subsample")
        self.depth_multiplier = int(depth_multiplier)
        self.border_mode = border_mode
        self.dim_ordering = dim_ordering
        self.kernel_init = initializers.get(init)
        self.activation = activations.get(activation)
        self.w_regularizer = regularizers.get(w_regularizer)
        self.b_regularizer = regularizers.get(b_regularizer)
        self.bias = bias

    def _in_channels(self, input_shape):
        return (input_shape[-1] if self.dim_ordering == "tf"
                else input_shape[0])

    def build(self, generator, input_shape: Shape) -> dict:
        out_ch = self._in_channels(input_shape) * self.depth_multiplier
        params = {"depthwise": self.kernel_init(
            generator, self.kernel_size + (1, out_ch))}
        if self.bias:
            params["bias"] = torch.zeros((out_ch,))
        return params

    def call(self, params, x, *, training=False, rng=None):
        xc = x.permute(0, 3, 1, 2) if self.dim_ordering == "tf" else x
        xc, padding = pad_nchw(xc, self.kernel_size, self.subsample,
                               self.border_mode)
        w = params["depthwise"].to(x.dtype).permute(3, 2, 0, 1)
        y = F.conv2d(xc, w, stride=self.subsample, padding=padding,
                     groups=xc.shape[1])
        if self.bias:
            y = y + params["bias"].to(y.dtype).reshape(1, -1, 1, 1)
        if self.dim_ordering == "tf":
            y = y.permute(0, 2, 3, 1)
        if self.activation is not None:
            y = self.activation(y)
        return y.contiguous()

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        out_ch = self._in_channels(input_shape) * self.depth_multiplier
        spatial = (input_shape[:2] if self.dim_ordering == "tf"
                   else input_shape[1:3])
        out_sp = tuple(_conv_out_len(s, k, st, self.border_mode)
                       for s, k, st in zip(spatial, self.kernel_size,
                                           self.subsample))
        if self.dim_ordering == "tf":
            return out_sp + (out_ch,)
        return (out_ch,) + out_sp

    def regularizers(self):
        out = []
        if self.w_regularizer is not None:
            out.append(("depthwise", self.w_regularizer))
        if self.b_regularizer is not None:
            out.append(("bias", self.b_regularizer))
        return out


def _pad(x, pads, value=0.0):
    """Constant-pad ``x`` by ``pads``, one ``(before, after)`` pair per
    axis (batch included), as ``jnp.pad`` takes them."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [int(lo), int(hi)]
    return F.pad(x, flat, value=value)


class ZeroPadding1D(KerasLayer):
    """Zero-pad the steps axis of ``(steps, features)``."""

    def __init__(self, padding=1, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.padding = _norm_tuple(padding, 2, "padding") \
            if not isinstance(padding, int) else (padding, padding)

    def call(self, params, x, *, training=False, rng=None):
        return _pad(x, ((0, 0), self.padding, (0, 0)))

    def compute_output_shape(self, input_shape):
        return (input_shape[0] + sum(self.padding),) + tuple(input_shape[1:])


class ZeroPadding2D(KerasLayer):
    """Pad the two spatial axes, ``(pad_h, pad_w)`` each side or the
    asymmetric ``((top, bottom), (left, right))``. ``value`` (default 0)
    sets the pad constant: ``-inf`` (as a torch padded MaxPool2d is
    imported) pads with the dtype's lowest finite value, as the
    reference does."""

    def __init__(self, padding=(1, 1), dim_ordering="tf", input_shape=None,
                 name=None, value=0.0, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        if (isinstance(padding, (tuple, list)) and len(padding) == 2
                and all(isinstance(q, (tuple, list)) and len(q) == 2
                        for q in padding)):
            self.padding = (tuple(int(v) for v in padding[0]),
                            tuple(int(v) for v in padding[1]))
        else:
            p = _norm_tuple(padding, 2, "padding")
            self.padding = ((p[0], p[0]), (p[1], p[1]))
        self.dim_ordering = dim_ordering
        self.value = value

    def call(self, params, x, *, training=False, rng=None):
        if self.dim_ordering == "tf":
            pads = ((0, 0),) + self.padding + ((0, 0),)
        else:
            pads = ((0, 0), (0, 0)) + self.padding
        val = self.value
        if val == float("-inf"):
            val = (torch.finfo(x.dtype).min if x.dtype.is_floating_point
                   else torch.iinfo(x.dtype).min)
        return _pad(x, pads, val)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        h, w = (0, 1) if self.dim_ordering == "tf" else (1, 2)
        s[h] += sum(self.padding[0])
        s[w] += sum(self.padding[1])
        return tuple(s)


class Cropping1D(KerasLayer):
    """Crop ``(start, end)`` steps off ``(steps, features)``."""

    def __init__(self, cropping=(1, 1), input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.cropping = _norm_tuple(cropping, 2, "cropping")

    def call(self, params, x, *, training=False, rng=None):
        a, b = self.cropping
        return x[:, a:x.shape[1] - b, :]

    def compute_output_shape(self, input_shape):
        return (input_shape[0] - sum(self.cropping),) + \
            tuple(input_shape[1:])


class Cropping2D(KerasLayer):
    """Crop ``((top, bottom), (left, right))`` off the spatial axes."""

    def __init__(self, cropping=((0, 0), (0, 0)), dim_ordering="tf",
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        if isinstance(cropping, int):
            cropping = ((cropping, cropping), (cropping, cropping))
        self.cropping = tuple(tuple(int(v) for v in c) for c in cropping)
        self.dim_ordering = dim_ordering

    def call(self, params, x, *, training=False, rng=None):
        (t, b), (l, r) = self.cropping
        if self.dim_ordering == "tf":
            return x[:, t:x.shape[1] - b, l:x.shape[2] - r, :]
        return x[:, :, t:x.shape[2] - b, l:x.shape[3] - r]

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        (t, b), (l, r) = self.cropping
        h, w = (0, 1) if self.dim_ordering == "tf" else (1, 2)
        s[h] -= t + b
        s[w] -= l + r
        return tuple(s)


class UpSampling1D(KerasLayer):
    """Repeat each step ``length`` times."""

    def __init__(self, length=2, input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.length = int(length)

    def call(self, params, x, *, training=False, rng=None):
        return torch.repeat_interleave(x, self.length, dim=1)

    def compute_output_shape(self, input_shape):
        return (input_shape[0] * self.length,) + tuple(input_shape[1:])


class UpSampling2D(KerasLayer):
    """Repeat rows and columns ``size`` times (nearest upsampling)."""

    def __init__(self, size=(2, 2), dim_ordering="tf", input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.size = _norm_tuple(size, 2, "size")
        self.dim_ordering = dim_ordering

    def call(self, params, x, *, training=False, rng=None):
        h = 1 if self.dim_ordering == "tf" else 2
        y = torch.repeat_interleave(x, self.size[0], dim=h)
        return torch.repeat_interleave(y, self.size[1], dim=h + 1)

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        h = 0 if self.dim_ordering == "tf" else 1
        s[h] *= self.size[0]
        s[h + 1] *= self.size[1]
        return tuple(s)


class UpSampling3D(KerasLayer):
    """Repeat the three leading non-batch axes ``size`` times."""

    def __init__(self, size=(2, 2, 2), input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.size = _norm_tuple(size, 3, "size")

    def call(self, params, x, *, training=False, rng=None):
        y = x
        for i, s in enumerate(self.size):
            y = torch.repeat_interleave(y, s, dim=i + 1)
        return y

    def compute_output_shape(self, input_shape):
        s = list(input_shape)
        for i in range(3):
            s[i] *= self.size[i]
        return tuple(s)


# Keras-2 names of the same layers
Conv1D = Convolution1D
Conv2D = Convolution2D
