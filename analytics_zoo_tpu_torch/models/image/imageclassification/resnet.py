"""ResNet v1.5 for image classification (port of
``analytics_zoo_tpu/models/image/imageclassification/resnet.py``).

``fused=True`` builds every bottleneck as one :class:`FusedBottleneck`,
whose convs are hand-written CUDA kernels (``ops.conv_bn``): in eval
three folds with the BNs, the residual add and the ReLUs in their
epilogues; in training 1x1 and 3x3 convs whose prologue applies the
previous BN and whose epilogue reduces this BN's batch statistics, with
the 1x1s' backward kernels too. ``fused="defer"`` runs each stage as one
:class:`FusedStage`, whose interior blocks hand their bn3 + residual +
ReLU tail to the next block's c1 prologue in training
(:func:`fused_stage_forward`). ``fused=False`` builds the unfused
per-layer graph (library convs, separate BN and ReLU), the comparison
path. All keep the JAX package's param names, and
:func:`convert_resnet_params` maps between them. ``space_to_depth=True``
builds the reference bench's stem: the 7x7/s2 conv as a 4x4/s1 conv over
the space-to-depth(2) image (:class:`S2DStemConv`). The stem conv and
the ``fc`` Dense stay library calls (cuDNN, cuBLAS), as they lie outside
any kernel in the reference.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F

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


class SpaceToDepth2D(KerasLayer):
    """NHWC space-to-depth: (H, W, C) → (H/b, W/b, b²·C), channels in
    (row offset, column offset, channel) order."""

    def __init__(self, block: int = 2, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.block = int(block)

    def call(self, params, x, *, training=False, rng=None):
        b = self.block
        n, h, w, c = x.shape
        x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h // b, w // b, b * b * c)

    def compute_output_shape(self, input_shape):
        h, w, c = input_shape
        b = self.block
        if h % b or w % b:
            raise ValueError(f"spatial dims {h}x{w} not divisible by "
                             f"block {b}")
        return (h // b, w // b, b * b * c)


class S2DStemConv(KerasLayer):
    """The space-to-depth stem: the 7x7/s2 SAME stem conv as a 4x4/s1
    conv over the space-to-depth(2) image with padding ((1, 2), (1,
    2)), the same map (:func:`s2d_stem_kernel` gives the kernel) with
    12 input channels and no strided reads. A zero pad and a cuDNN
    conv: the reference computes it with ``lax.conv``, outside any
    kernel."""

    def __init__(self, nb_filter: int = 64, init="glorot_uniform",
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.nb_filter = int(nb_filter)
        self.kernel_init = initializers.get(init)

    def build(self, generator, input_shape) -> dict:
        return {"kernel": self.kernel_init(
            generator, (4, 4, input_shape[-1], self.nb_filter))}

    def call(self, params, x, *, training=False, rng=None):
        xc = F.pad(x.permute(0, 3, 1, 2), (1, 2, 1, 2))
        w = params["kernel"].to(x.dtype).permute(3, 2, 0, 1)
        return F.conv2d(xc, w).permute(0, 2, 3, 1).contiguous()

    def compute_output_shape(self, input_shape):
        h, w, _ = input_shape
        return (h, w, self.nb_filter)


def s2d_stem_kernel(k7: np.ndarray) -> np.ndarray:
    """A (7, 7, C, F) SAME/s2 stem kernel → the (4, 4, 4C, F) kernel of
    :class:`S2DStemConv` over :class:`SpaceToDepth2D` (2) input that
    gives the same outputs: pad 7 → 8 with a zero last row and column,
    so stride 2 tiles the kernel, and fold the 2x2 phases into the
    channels."""
    kh, kw, c, f = k7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 kernel, got {kh}x{kw}")
    k8 = np.zeros((8, 8, c, f), k7.dtype)
    k8[:7, :7] = k7
    # K2d[u', v', (r, s, c)] = K8[2u' + r, 2v' + s, c]
    k8 = k8.reshape(4, 2, 4, 2, c, f)            # (u', r, v', s, c, f)
    k2d = np.transpose(k8, (0, 2, 1, 3, 4, 5))   # (u', v', r, s, c, f)
    return np.ascontiguousarray(k2d.reshape(4, 4, 4 * c, f))


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
    ReLU (or, in a :class:`FusedStage`, the next block's c1 prologue
    does). Same math as the unfused block.

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

    def _apply_train(self, params, x, *, pending_in=None, defer_out=False):
        """Training forward. ``pending_in`` and ``defer_out`` are the
        deferred-apply scheme of :func:`fused_stage_forward`: a pending
        value ``(y3, scale3, shift3, sc)`` stands for the previous
        block's output ``relu(y3 * scale3 + shift3 + sc)``, never
        written. With ``pending_in`` (``x`` unused), c1 applies it in
        its prologue (``conv1x1_bn(in_residual=)``) and the block's own
        shortcut derives it again as one elementwise pass; with
        ``defer_out`` (a stride-1 identity-shortcut block only) the
        block returns its own pending tuple instead of its output."""
        if pending_in is not None and self.downsample:
            raise ValueError("pending input requires an identity "
                             "shortcut (no downsample)")
        if defer_out and (self.stride != 1 or self.downsample):
            raise ValueError("defer_out requires a stride-1 "
                             "identity-shortcut block")
        updates = {}

        def mm(bn):
            return params[bn]["_state"]["moving_mean"].detach()

        def count(y):
            return float(math.prod(y.shape[:-1]))

        # c1: 1x1 + bn1 statistics epilogue; a pending input's bn3
        # apply, residual and ReLU join its prologue
        if pending_in is None:
            y1, s1, q1 = conv1x1_bn(x, params["c1"], stat_shift=mm("bn1"))
        else:
            y3p, s3p, t3p, scp = pending_in
            y1, s1, q1 = conv1x1_bn(
                y3p, params["c1"], in_scale=s3p, in_shift=t3p,
                relu_in=True, in_residual=scp, stat_shift=mm("bn1"))
            # the block's own shortcut: the previous output, derived
            # again (the reference leaves this to XLA to fuse into its
            # consumer; here it is a pass of its own)
            x = torch.relu(y3p * s3p.to(y3p.dtype) + t3p.to(y3p.dtype) +
                           scp.to(y3p.dtype))
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
        if defer_out:
            # the next block's c1 prologue applies the tail
            return (y3, scale3, shift3, shortcut), updates
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
        """``fused=True`` uses :class:`FusedBottleneck`, ``fused="defer"``
        one :class:`FusedStage` per stage; same math as the unfused
        graph, fewer passes over device memory. ``space_to_depth`` builds
        the stem as :class:`S2DStemConv` over :class:`SpaceToDepth2D`."""
        if fused not in (False, True, "defer"):
            raise ValueError(f"fused must be False/True/'defer', "
                             f"got {fused!r}")
        blocks = self.DEPTH_BLOCKS[self.depth]
        inp = Input(input_shape, name="image")
        if space_to_depth:
            x = SpaceToDepth2D(2, name="stem_s2d")(inp)
            x = S2DStemConv(64, name="stem")(x)
            x = BatchNormalization(name="stem_bn")(x)
            x = Activation("relu")(x)
        else:
            x = conv_bn(inp, 64, 7, stride=2, name="stem")
        x = MaxPooling2D(pool_size=3, strides=2, border_mode="same")(x)
        filters = 64
        for stage, n_blocks in enumerate(blocks):
            first_stride = 2 if stage > 0 else 1
            if fused == "defer":
                x = FusedStage(filters, n_blocks, first_stride=first_stride,
                               name=f"s{stage}")(x)
            else:
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


class FusedStage(KerasLayer):
    """One ResNet stage as one layer: its :class:`FusedBottleneck`
    blocks run through :func:`fused_stage_forward` (``resnet50(fused=
    "defer")``). Params nest per block, ``{"b0": <block params>, ...}``,
    so :func:`convert_resnet_params` maps them to and from the other
    layouts by name."""

    def __init__(self, filters: int, n_blocks: int, first_stride: int = 1,
                 epsilon: float = 1e-3, momentum: float = 0.99,
                 init="glorot_uniform", input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.filters = int(filters)
        self.n_blocks = int(n_blocks)
        self.first_stride = int(first_stride)
        # the blocks hold no state of their own: the stage's tree does
        self.blocks = tuple(
            FusedBottleneck(filters, stride=first_stride if b == 0 else 1,
                            downsample=(b == 0), epsilon=epsilon,
                            momentum=momentum, init=init, name=f"b{b}")
            for b in range(self.n_blocks))

    def build(self, generator, input_shape) -> dict:
        params = {}
        shape = input_shape
        for b, blk in enumerate(self.blocks):
            params[f"b{b}"] = blk.build(generator, shape)
            shape = blk.compute_output_shape(shape)
        return params

    def apply(self, params, x, *, training=False, rng=None):
        out, upds = fused_stage_forward(
            self.blocks, [params[f"b{b}"] for b in range(self.n_blocks)],
            x, training=training)
        return out, {f"b{b}": u for b, u in enumerate(upds) if u}

    def call(self, params, x, *, training=False, rng=None):
        return self.apply(params, x, training=training)[0]

    def compute_output_shape(self, input_shape):
        shape = input_shape
        for blk in self.blocks:
            shape = blk.compute_output_shape(shape)
        return shape


def stage_defers(blocks) -> "list[bool]":
    """Which blocks of a stage defer their tail in training: a block
    with a stride-1 identity shortcut whose successor has one too. Only
    whether the next block can consume a pending input decides: a block
    that consumed one may defer in turn."""
    def identity(blk):
        return blk.stride == 1 and not blk.downsample
    return [identity(blk) and i + 1 < len(blocks) and identity(blocks[i + 1])
            for i, blk in enumerate(blocks)]


def fused_stage_forward(blocks, params_list, x, training=True):
    """A stage of :class:`FusedBottleneck` blocks with chained deferred
    apply: in training every block with a stride-1 identity shortcut
    whose successor has one too defers its bn3 + residual + ReLU tail;
    the successor's c1 applies it in its prologue
    (``conv1x1_bn(in_residual=)``), derives its own shortcut from it
    again, and defers its own tail in turn. So all B - 1 interior tails
    of a B-block stage ride their successor's kernel. Same math as
    running the blocks one by one; eval chains the blocks' eval folds.
    Returns ``(out, updates_per_block)``."""
    if len(blocks) != len(params_list):
        raise ValueError(f"{len(blocks)} blocks but {len(params_list)} "
                         "param dicts")
    if not training:
        upds = []
        for blk, p in zip(blocks, params_list):
            x, u = blk.apply(p, x, training=False)
            upds.append(u)
        return x, upds
    updates_per_block = []
    pending = None
    for blk, p, defer in zip(blocks, params_list, stage_defers(blocks)):
        out, upd = blk._apply_train(p, x if pending is None else None,
                                    pending_in=pending, defer_out=defer)
        updates_per_block.append(upd)
        if defer:
            pending = out
        else:
            pending, x = None, out
    return x, updates_per_block


# fused param-group name ↔ unfused layer-name suffix, per block
_FUSED_PARTS = [("c1", "_c1", "kernel"), ("c2", "_c2", "kernel"),
                ("c3", "_c3", "kernel"), ("down", "_down", "kernel"),
                ("bn1", "_c1_bn", None), ("bn2", "_c2_bn", None),
                ("bn3", "_c3_bn", None), ("bnd", "_down_bn", None)]


def convert_resnet_params(src_params: dict, dst_params: dict) -> dict:
    """Translate a ResNet param tree between the unfused, the per-block
    fused and the stage layouts, in any direction (same depth, stem and
    classes): a fused block ``s{i}b{j}`` groups exactly the entries the
    unfused graph keeps as ``s{i}b{j}_c1``, ``s{i}b{j}_c1_bn``, ..., and
    a stage ``s{i}`` nests them as ``{"b{j}": <block group>}``.
    Non-block layers copy by name. Leaves are passed through as they
    are (tensors or host arrays). Returns a tree shaped like
    ``dst_params``."""

    def src_block(flat):
        """The fused group of block ``s{i}b{j}`` from a per-block fused
        or a stage source, or None."""
        if flat in src_params:
            return src_params[flat]
        m = re.fullmatch(r"(s\d+)(b\d+)", flat)
        if m and m.group(2) in src_params.get(m.group(1), {}):
            return src_params[m.group(1)][m.group(2)]
        return None

    def gather_unfused(flat, like):
        grp = {}
        for key, suffix, leaf in _FUSED_PARTS:
            if key in like:
                layer = src_params[flat + suffix]
                grp[key] = layer[leaf] if leaf else layer
        return grp

    def block(flat, like):
        grp = src_block(flat)
        return grp if grp is not None else gather_unfused(flat, like)

    out = {}
    for name, sub in dst_params.items():
        if not tree_leaves(sub):
            out[name] = sub     # parameterless (Activation, pooling)
        elif name in src_params:
            out[name] = src_params[name]            # same layout
        elif isinstance(sub, dict) and "bn1" in sub and "c1" in sub:
            # dst per-block fused ← src stage or unfused
            out[name] = block(name, sub)
        elif isinstance(sub, dict) and sub and all(
                re.fullmatch(r"b\d+", k) for k in sub):
            # dst stage ← src per-block fused or unfused
            out[name] = {bkey: block(name + bkey, bsub)
                         for bkey, bsub in sub.items()}
        elif re.fullmatch(r"s\d+b\d+_(c\d|down)(_bn)?", name):
            # dst unfused ← src per-block fused or stage
            base, _, suffix = name.partition("_")
            key, _, leaf = next(p for p in _FUSED_PARTS
                                if p[1] == "_" + suffix)
            grp = src_block(base)
            if grp is None:
                raise KeyError(f"no source block for {base!r}")
            out[name] = {"kernel": grp[key]} if leaf else grp[key]
        else:
            raise KeyError(
                f"layer {name!r} has no counterpart in the source "
                "params (different depth or stem?)")
    return out


def resnet50(input_shape=(224, 224, 3), classes: int = 1000,
             space_to_depth: bool = False, fused=False) -> Model:
    return ResNet(50).build(input_shape, classes,
                            space_to_depth=space_to_depth, fused=fused)
