"""SSD detection graphs (port of
``analytics_zoo_tpu/models/image/objectdetection/ssd.py``).

SSD300-VGG16: the VGG base (pool5 3x3/s1, a 3x3 fc6 at dilation 6, a
1x1 fc7), the extra feature layers and a loc/conf head per scale;
conv4_3 passes through a learnable-scale L2 normalization. NHWC
throughout; the heads reshape to (B, P, 4) and (B, P, C) and are
concatenated into one flat output, so that the Estimator's one-output
loss applies (``MultiBoxLoss.as_keras_loss``). At 300x300 the maps are
38/19/10/5/3/1 with 512/1024/512/256/256/256 channels: 8732 priors.

The convolutions are library convolutions, as the reference's are
``lax.conv_general_dilated``: no TPU kernel lies on this path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.image.objectdetection.prior_box import (
    SSD300_SPECS, generate_ssd_priors, num_priors_per_cell)
from analytics_zoo_tpu_torch.pipeline.api import autograd as A
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    Input, KerasLayer, Shape)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Concatenate, Convolution2D, MaxPooling2D)
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model


class L2NormScale(KerasLayer):
    """Channel-wise L2 normalization with a learnable per-channel scale
    (SSD's ``NormalizeScale`` on conv4_3, the scale starting at 20)."""

    def __init__(self, scale_init: float = 20.0, input_shape=None,
                 name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.scale_init = float(scale_init)

    def build(self, generator, input_shape: Shape) -> dict:
        return {"scale": torch.full((input_shape[-1],), self.scale_init)}

    def call(self, params, x, *, training=False, rng=None):
        norm = torch.sqrt(x.square().sum(dim=-1, keepdim=True) + 1e-10)
        return x / norm * params["scale"].to(x.dtype)


def _conv(x, filters, k, stride=1, pad="same", dilation=1, act="relu",
          name=None):
    return Convolution2D(filters, k, k, subsample=stride,
                         border_mode=pad, dilation=dilation,
                         activation=act, name=name)(x)


class SSDVGG:
    """The SSD300-VGG16 builder."""

    def __init__(self, n_classes: int, img_size: int = 300, specs=None):
        self.n_classes = int(n_classes)  # the background class 0 included
        self.img_size = int(img_size)
        self.specs = specs or SSD300_SPECS
        self.priors = generate_ssd_priors(self.specs, float(img_size))

    @property
    def num_priors(self) -> int:
        return self.priors.shape[0]

    def _backbone(self, x):
        # VGG16 through conv4_3 and fc7, as SSD modifies it
        for i, f in enumerate((64, 64)):
            x = _conv(x, f, 3, name=f"conv1_{i+1}")
        x = MaxPooling2D(border_mode="same")(x)
        for i, f in enumerate((128, 128)):
            x = _conv(x, f, 3, name=f"conv2_{i+1}")
        x = MaxPooling2D(border_mode="same")(x)
        for i, f in enumerate((256, 256, 256)):
            x = _conv(x, f, 3, name=f"conv3_{i+1}")
        x = MaxPooling2D(border_mode="same")(x)
        for i, f in enumerate((512, 512, 512)):
            x = _conv(x, f, 3, name=f"conv4_{i+1}")
        conv4_3 = x
        x = MaxPooling2D(border_mode="same")(x)
        for i, f in enumerate((512, 512, 512)):
            x = _conv(x, f, 3, name=f"conv5_{i+1}")
        x = MaxPooling2D(pool_size=3, strides=1, border_mode="same")(x)
        x = _conv(x, 1024, 3, dilation=6, name="fc6")   # the dilated fc6
        fc7 = _conv(x, 1024, 1, name="fc7")
        return conv4_3, fc7

    def _extras(self, x):
        feats = []
        x = _conv(x, 256, 1, name="conv6_1")
        x = _conv(x, 512, 3, stride=2, name="conv6_2")
        feats.append(x)
        if x.shape[0] > 1:
            x = _conv(x, 128, 1, name="conv7_1")
            x = _conv(x, 256, 3, stride=2, name="conv7_2")
            feats.append(x)
        # VALID 3x3 stages only while the map allows one (a small input
        # ends the pyramid early)
        for i in (8, 9):
            if x.shape[0] < 3:
                break
            x = _conv(x, 128, 1, name=f"conv{i}_1")
            x = _conv(x, 256, 3, pad="valid", name=f"conv{i}_2")
            feats.append(x)
        return feats

    def build(self) -> Model:
        inp = Input((self.img_size, self.img_size, 3), name="image")
        conv4_3, fc7 = self._backbone(inp)
        feats = [L2NormScale(name="conv4_3_norm")(conv4_3), fc7] + \
            self._extras(fc7)
        # the priors follow the graph: sizes from the feature maps (an
        # input size other than 300 reshapes the pyramid)
        self.specs = [dataclasses.replace(spec,
                                          feature_size=int(feat.shape[0]))
                      for feat, spec in zip(feats, self.specs)]
        self.priors = generate_ssd_priors(self.specs, float(self.img_size))
        locs, confs = [], []
        for i, (feat, spec) in enumerate(zip(feats, self.specs)):
            k = num_priors_per_cell(spec)
            f = spec.feature_size
            n_cell_priors = f * f * k
            loc = Convolution2D(k * 4, 3, 3, border_mode="same",
                                name=f"head{i}_loc")(feat)
            conf = Convolution2D(k * self.n_classes, 3, 3,
                                 border_mode="same",
                                 name=f"head{i}_conf")(feat)
            locs.append(A.Lambda(
                lambda t: t.reshape(t.shape[0], -1, 4),
                output_shape=(n_cell_priors, 4),
                name=f"head{i}_loc_r")(loc))
            confs.append(A.Lambda(
                lambda t, c=self.n_classes: t.reshape(t.shape[0], -1, c),
                output_shape=(n_cell_priors, self.n_classes),
                name=f"head{i}_conf_r")(conf))
        loc_all = Concatenate(axis=1)(locs)     # (B, P, 4)
        conf_all = Concatenate(axis=1)(confs)   # (B, P, C)
        # flattened into the one-output training contract
        p = self.num_priors
        flat = A.Lambda(
            lambda ts: torch.cat([ts[0].reshape(ts[0].shape[0], -1),
                                  ts[1].reshape(ts[1].shape[0], -1)],
                                 dim=-1),
            output_shape=(p * 4 + p * self.n_classes,),
            name="ssd_flat")
        out = _MultiInLambda(flat)([loc_all, conf_all])
        return Model(inp, out, name="ssd300_vgg16")


class _MultiInLambda(KerasLayer):
    """Adapter: an autograd Lambda over a list input."""

    def __init__(self, lam):
        super().__init__(name=lam.name + "_multi")
        self.lam = lam

    def call(self, params, inputs, *, training=False, rng=None):
        return self.lam.fn(inputs)

    def compute_output_shape(self, input_shape):
        return self.lam.shape_fn(input_shape)


def ssd300_vgg16(n_classes: int = 21) -> Tuple[Model, np.ndarray]:
    """-> (model, priors). ``n_classes`` counts the background (VOC:
    21)."""
    builder = SSDVGG(n_classes)
    return builder.build(), builder.priors
