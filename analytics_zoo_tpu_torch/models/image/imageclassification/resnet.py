"""ResNet v1.5 for image classification (port of
``analytics_zoo_tpu/models/image/imageclassification/resnet.py``).

``fused=True`` builds every bottleneck as one :class:`FusedBottleneck`,
whose convs are hand-written CUDA kernels (``ops.conv_bn``): in eval
three folds with the BNs, the residual add and the ReLUs in their
epilogues; in training 1x1 and 3x3 convs whose prologue applies the
previous BN and whose epilogue reduces this BN's batch statistics, with
the 1x1s' backward kernels too. ``fused=False`` builds the unfused
per-layer graph (library convs, separate BN and ReLU), the comparison
path. Both keep the JAX package's param names, and
:func:`convert_resnet_params` maps between them. The stem 7x7 conv and
the ``fc`` Dense stay library calls in both, as they lie outside any
kernel in the reference.
"""

from __future__ import annotations

import math
import re

import torch

from analytics_zoo_tpu_torch.ops import initializers
from analytics_zoo_tpu_torch.ops.conv_bn import (
    conv1x1_bn, conv1x1_bn_apply, conv3x3_bn, conv3x3_bn_apply)
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    Input, KerasLayer, tree_leaves)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Activation, Add, BatchNormalization, Convolution2D, Dense,
    GlobalAveragePooling2D, MaxPooling2D)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.normalization \
    import bn_batch_stats, bn_fold
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model


def conv_bn(x, filters, kernel, stride=1, activation="relu", name=None):
    x = Convolution2D(filters, kernel, kernel, subsample=stride,
                      border_mode="same", bias=False, name=name)(x)
    x = BatchNormalization(name=None if name is None else name + "_bn")(x)
    if activation:
        x = Activation(activation)(x)
    return x


def _bottleneck(x, filters, stride=1, downsample=False, name=""):
    """v1.5 bottleneck: stride lives on the 3x3 conv."""
    shortcut = x
    y = conv_bn(x, filters, 1, 1, name=name + "_c1")
    y = conv_bn(y, filters, 3, stride, name=name + "_c2")
    y = Convolution2D(filters * 4, 1, 1, border_mode="same", bias=False,
                      name=name + "_c3")(y)
    y = BatchNormalization(name=name + "_c3_bn")(y)
    if downsample:
        shortcut = Convolution2D(filters * 4, 1, 1, subsample=stride,
                                 border_mode="same", bias=False,
                                 name=name + "_down")(x)
        shortcut = BatchNormalization(name=name + "_down_bn")(shortcut)
    out = Add()([y, shortcut])
    return Activation("relu")(out)


class FusedBottleneck(KerasLayer):
    """v1.5 bottleneck on fused conv+BN kernels.

    Eval: three folds, c1 (1x1, bn1 + ReLU in the epilogue), c2 (3x3 at
    the block's stride, bn2 + ReLU), c3 (1x1, bn3 + residual + ReLU); a
    downsample shortcut is a fourth 1x1 fold (bnd). The raw conv outputs
    never exist in device memory.

    Training: c1, c2 and c3 (and the shortcut) run with statistics
    epilogues; each conv's prologue applies the previous BN's batch
    fold + ReLU, so a normalised activation never exists in device
    memory, and one elementwise pass applies bn3, the residual and the
    ReLU. Same math as the unfused block.

    Params: ``c1/c2/c3[/down]`` HWIO kernels + ``bn1/bn2/bn3[/bnd]``
    groups of ``{gamma, beta, _state: {moving_mean, moving_var}}``, the
    per-layer content of the unfused block."""

    def __init__(self, filters: int, stride: int = 1,
                 downsample: bool = False, epsilon: float = 1e-3,
                 momentum: float = 0.99, init="glorot_uniform",
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.filters = int(filters)
        self.stride = int(stride)
        self.downsample = bool(downsample)
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        self.kernel_init = initializers.get(init)

    @staticmethod
    def _bn_init(n):
        return {"gamma": torch.ones((n,)), "beta": torch.zeros((n,)),
                "_state": {"moving_mean": torch.zeros((n,)),
                           "moving_var": torch.ones((n,))}}

    def build(self, generator, input_shape) -> dict:
        c = input_shape[-1]
        f = self.filters
        init = self.kernel_init
        params = {
            "c1": init(generator, (1, 1, c, f)),
            "c2": init(generator, (3, 3, f, f)),
            "c3": init(generator, (1, 1, f, 4 * f)),
            "bn1": self._bn_init(f),
            "bn2": self._bn_init(f),
            "bn3": self._bn_init(4 * f),
        }
        if self.downsample:
            params["down"] = init(generator, (1, 1, c, 4 * f))
            params["bnd"] = self._bn_init(4 * f)
        return params

    def _fold(self, bn):
        st = bn["_state"]
        return bn_fold(st["moving_mean"], st["moving_var"], bn["gamma"],
                       bn["beta"], self.epsilon)

    def _bn_vectors(self, bn, ssum, ssq, count):
        """Training ``(scale, shift, updates)`` from a conv's shifted
        sums, through the BatchNorm scheme the unfused layer runs."""
        mean, var, upd = bn_batch_stats(ssum, ssq, count, bn["_state"],
                                        self.momentum)
        scale, shift = bn_fold(mean, var, bn["gamma"], bn["beta"],
                               self.epsilon)
        return scale, shift, upd

    def apply(self, params, x, *, training=False, rng=None):
        if training:
            return self._apply_train(params, x)
        return self._apply_eval(params, x), {}

    def call(self, params, x, *, training=False, rng=None):
        return self.apply(params, x, training=training)[0]

    def _apply_train(self, params, x):
        """Training forward (the reference's ``_apply_train`` without its
        deferred-apply options, which ``FusedStage`` alone uses)."""
        updates = {}

        def mm(bn):
            return params[bn]["_state"]["moving_mean"].detach()

        def count(y):
            return float(math.prod(y.shape[:-1]))

        # c1: 1x1 + bn1 statistics epilogue
        y1, s1, q1 = conv1x1_bn(x, params["c1"], stat_shift=mm("bn1"))
        scale1, shift1, updates["bn1"] = self._bn_vectors(
            params["bn1"], s1, q1, count(y1))
        # c2: 3x3 at the block's stride, bn1 apply + ReLU in the
        # prologue, bn2 statistics in the epilogue
        y2, s2, q2 = conv3x3_bn(
            y1, params["c2"], in_scale=scale1, in_shift=shift1,
            relu_in=True, stat_shift=mm("bn2"), stride=self.stride)
        scale2, shift2, updates["bn2"] = self._bn_vectors(
            params["bn2"], s2, q2, count(y2))
        # c3: bn2 apply + ReLU prologue, bn3 statistics epilogue
        y3, s3, q3 = conv1x1_bn(
            y2, params["c3"], in_scale=scale2, in_shift=shift2,
            relu_in=True, stat_shift=mm("bn3"))
        scale3, shift3, updates["bn3"] = self._bn_vectors(
            params["bn3"], s3, q3, count(y3))
        if self.downsample:
            # the strided 1x1 shortcut reads every stride-th pixel
            ysc, sd, qd = conv1x1_bn(x, params["down"], stride=self.stride,
                                     stat_shift=mm("bnd"))
            scaled, shiftd, updates["bnd"] = self._bn_vectors(
                params["bnd"], sd, qd, count(ysc))
            shortcut = ysc * scaled.to(ysc.dtype) + shiftd.to(ysc.dtype)
        else:
            shortcut = x
        # bn3 apply + residual add + ReLU: one elementwise pass
        out = torch.relu(y3 * scale3.to(y3.dtype) + shift3.to(y3.dtype) +
                         shortcut.to(y3.dtype))
        return out, updates

    def _apply_eval(self, params, x):
        scale1, shift1 = self._fold(params["bn1"])
        scale2, shift2 = self._fold(params["bn2"])
        scale3, shift3 = self._fold(params["bn3"])
        z1 = conv1x1_bn_apply(x, params["c1"], out_scale=scale1,
                              out_shift=shift1, relu_out=True)
        z2 = conv3x3_bn_apply(z1, params["c2"], out_scale=scale2,
                              out_shift=shift2, relu_out=True,
                              stride=self.stride)
        if self.downsample:
            scaled, shiftd = self._fold(params["bnd"])
            shortcut = conv1x1_bn_apply(
                x, params["down"], stride=self.stride,
                out_scale=scaled, out_shift=shiftd)
        else:
            shortcut = x
        return conv1x1_bn_apply(z2, params["c3"], out_scale=scale3,
                                out_shift=shift3, residual=shortcut,
                                relu_out=True)

    def compute_output_shape(self, input_shape):
        h, w, _ = input_shape
        s = self.stride
        return ((h + s - 1) // s, (w + s - 1) // s, 4 * self.filters)


class ResNet:
    """Builder; ``ResNet(depth).build(input_shape, classes)`` → Model."""

    DEPTH_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
                    152: (3, 8, 36, 3)}

    def __init__(self, depth: int = 50):
        if depth not in self.DEPTH_BLOCKS:
            raise ValueError(f"depth must be one of "
                             f"{sorted(self.DEPTH_BLOCKS)}")
        self.depth = depth

    def build(self, input_shape=(224, 224, 3), classes: int = 1000,
              space_to_depth: bool = False, fused=False) -> Model:
        """``fused=True`` uses :class:`FusedBottleneck`; same math as
        the unfused graph, fewer passes over device memory."""
        if space_to_depth or fused == "defer":
            raise NotImplementedError(
                "the space-to-depth stem and the fused='defer' stage "
                "layout are not ported yet (ROADMAP queue)")
        if fused not in (False, True):
            raise ValueError(f"fused must be False/True, got {fused!r}")
        blocks = self.DEPTH_BLOCKS[self.depth]
        inp = Input(input_shape, name="image")
        x = conv_bn(inp, 64, 7, stride=2, name="stem")
        x = MaxPooling2D(pool_size=3, strides=2, border_mode="same")(x)
        filters = 64
        for stage, n_blocks in enumerate(blocks):
            first_stride = 2 if stage > 0 else 1
            for b in range(n_blocks):
                stride = first_stride if b == 0 else 1
                if fused:
                    x = FusedBottleneck(filters, stride=stride,
                                        downsample=(b == 0),
                                        name=f"s{stage}b{b}")(x)
                else:
                    x = _bottleneck(x, filters, stride=stride,
                                    downsample=(b == 0),
                                    name=f"s{stage}b{b}")
            filters *= 2
        x = GlobalAveragePooling2D()(x)
        out = Dense(classes, name="fc")(x)
        return Model(inp, out, name=f"resnet{self.depth}")


# fused param-group name ↔ unfused layer-name suffix, per block
_FUSED_PARTS = [("c1", "_c1", "kernel"), ("c2", "_c2", "kernel"),
                ("c3", "_c3", "kernel"), ("down", "_down", "kernel"),
                ("bn1", "_c1_bn", None), ("bn2", "_c2_bn", None),
                ("bn3", "_c3_bn", None), ("bnd", "_down_bn", None)]


def convert_resnet_params(src_params: dict, dst_params: dict) -> dict:
    """Translate a ResNet param tree between the fused and unfused
    layouts (same depth and classes): a fused block ``s{i}b{j}`` groups
    exactly the entries the unfused graph keeps as ``s{i}b{j}_c1``,
    ``s{i}b{j}_c1_bn``, ... Non-block layers copy by name. Leaves are
    passed through as they are (tensors or host arrays). Returns a tree
    shaped like ``dst_params``."""
    out = {}
    for name, sub in dst_params.items():
        if not tree_leaves(sub):
            out[name] = sub     # parameterless (Activation, pooling)
        elif name in src_params:
            out[name] = src_params[name]            # same layout
        elif isinstance(sub, dict) and "bn1" in sub and "c1" in sub:
            # dst fused ← src unfused
            grp = {}
            for key, suffix, leaf in _FUSED_PARTS:
                if key in sub:
                    layer = src_params[name + suffix]
                    grp[key] = layer[leaf] if leaf else layer
            out[name] = grp
        elif re.fullmatch(r"s\d+b\d+_(c\d|down)(_bn)?", name):
            # dst unfused ← src fused
            base, _, suffix = name.partition("_")
            key, _, leaf = next(p for p in _FUSED_PARTS
                                if p[1] == "_" + suffix)
            if base not in src_params:
                raise KeyError(f"no source block for {base!r}")
            grp = src_params[base][key]
            out[name] = {"kernel": grp} if leaf else grp
        else:
            raise KeyError(
                f"layer {name!r} has no counterpart in the source "
                "params (different depth?)")
    return out


def resnet50(input_shape=(224, 224, 3), classes: int = 1000,
             space_to_depth: bool = False, fused=False) -> Model:
    return ResNet(50).build(input_shape, classes,
                            space_to_depth=space_to_depth, fused=fused)
