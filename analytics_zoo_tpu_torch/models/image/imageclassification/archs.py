"""The named classification architectures of ``ImageClassifier`` other
than ResNet and LeNet (port of
``analytics_zoo_tpu/models/image/imageclassification/archs.py``):
VGG-16/19, Inception-v1, MobileNet v1 and v2, DenseNet-121 and
SqueezeNet v1.1, on the functional Keras API with the reference's layer
names and defaults, so a reference param tree loads by name.

Each is built from Convolution2D, BatchNormalization, pooling,
Concatenate and DepthwiseConvolution2D: library convolutions (cuDNN on
the card), as the reference's are XLA convolutions outside any Pallas
kernel. Inception replaces GoogLeNet's local response normalization by
BatchNorm, as the reference does.
"""

from __future__ import annotations

from analytics_zoo_tpu_torch.models.image.imageclassification.resnet \
    import conv_bn as _cbr
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Activation, Add, AveragePooling2D, BatchNormalization, Concatenate,
    Convolution2D, Dense, DepthwiseConvolution2D, Dropout, Flatten,
    GlobalAveragePooling2D, MaxPooling2D)
from analytics_zoo_tpu_torch.pipeline.api.keras.models import (
    Model, Sequential)


# ---------------------------------------------------------------------------
# VGG (reference `ImageClassificationConfig` names vgg-16 / vgg-19)
# ---------------------------------------------------------------------------

_VGG_BLOCKS = {16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}


def vgg(depth: int = 16, input_shape=(224, 224, 3), classes: int = 1000
        ) -> Model:
    if depth not in _VGG_BLOCKS:
        raise ValueError(f"vgg depth must be one of {sorted(_VGG_BLOCKS)}")
    model = Sequential(name=f"vgg{depth}")
    filters = 64
    first = True
    for n_convs in _VGG_BLOCKS[depth]:
        for i in range(n_convs):
            kw = {"input_shape": input_shape} if first else {}
            first = False
            model.add(Convolution2D(min(filters, 512), 3, 3,
                                    border_mode="same", activation="relu",
                                    **kw))
        model.add(MaxPooling2D(pool_size=2, strides=2))
        filters *= 2
    model.add(Flatten())
    model.add(Dense(4096, activation="relu"))
    model.add(Dropout(0.5))
    model.add(Dense(4096, activation="relu"))
    model.add(Dropout(0.5))
    model.add(Dense(classes))
    return model


def vgg16(input_shape=(224, 224, 3), classes=1000) -> Model:
    return vgg(16, input_shape, classes)


def vgg19(input_shape=(224, 224, 3), classes=1000) -> Model:
    return vgg(19, input_shape, classes)


# ---------------------------------------------------------------------------
# Inception-v1 / GoogLeNet (reference training recipe
# `examples/inception/Train.scala:70-107` — the ImageNet headline example)
# ---------------------------------------------------------------------------



def _inception_module(x, f1, f3r, f3, f5r, f5, fp, name):
    b1 = _cbr(x, f1, 1, name=name + "_1x1")
    b3 = _cbr(x, f3r, 1, name=name + "_3x3r")
    b3 = _cbr(b3, f3, 3, name=name + "_3x3")
    b5 = _cbr(x, f5r, 1, name=name + "_5x5r")
    b5 = _cbr(b5, f5, 5, name=name + "_5x5")
    bp = MaxPooling2D(pool_size=3, strides=1, border_mode="same")(x)
    bp = _cbr(bp, fp, 1, name=name + "_pool")
    return Concatenate(axis=-1)([b1, b3, b5, bp])


def inception_v1(input_shape=(224, 224, 3), classes: int = 1000) -> Model:
    inp = Input(input_shape, name="image")
    x = _cbr(inp, 64, 7, stride=2, name="stem1")
    x = MaxPooling2D(pool_size=3, strides=2, border_mode="same")(x)
    x = _cbr(x, 64, 1, name="stem2r")
    x = _cbr(x, 192, 3, name="stem2")
    x = MaxPooling2D(pool_size=3, strides=2, border_mode="same")(x)
    x = _inception_module(x, 64, 96, 128, 16, 32, 32, "i3a")
    x = _inception_module(x, 128, 128, 192, 32, 96, 64, "i3b")
    x = MaxPooling2D(pool_size=3, strides=2, border_mode="same")(x)
    x = _inception_module(x, 192, 96, 208, 16, 48, 64, "i4a")
    x = _inception_module(x, 160, 112, 224, 24, 64, 64, "i4b")
    x = _inception_module(x, 128, 128, 256, 24, 64, 64, "i4c")
    x = _inception_module(x, 112, 144, 288, 32, 64, 64, "i4d")
    x = _inception_module(x, 256, 160, 320, 32, 128, 128, "i4e")
    x = MaxPooling2D(pool_size=3, strides=2, border_mode="same")(x)
    x = _inception_module(x, 256, 160, 320, 32, 128, 128, "i5a")
    x = _inception_module(x, 384, 192, 384, 48, 128, 128, "i5b")
    x = GlobalAveragePooling2D()(x)
    x = Dropout(0.4)(x)
    out = Dense(classes, name="fc")(x)
    return Model(inp, out, name="inception_v1")


# ---------------------------------------------------------------------------
# MobileNet v1 / v2
# ---------------------------------------------------------------------------

def _dw_block(x, filters, stride, name, alpha=1.0):
    """MobileNet v1 block: 3x3 depthwise + BN/relu, 1x1 pointwise +
    BN/relu."""
    x = DepthwiseConvolution2D(3, 3, subsample=stride, border_mode="same",
                               bias=False, name=name + "_dw")(x)
    x = BatchNormalization(name=name + "_dw_bn")(x)
    x = Activation("relu")(x)
    x = Convolution2D(int(filters * alpha), 1, 1, border_mode="same",
                      bias=False, name=name + "_pw")(x)
    x = BatchNormalization(name=name + "_pw_bn")(x)
    return Activation("relu")(x)


def mobilenet(input_shape=(224, 224, 3), classes: int = 1000,
              alpha: float = 1.0) -> Model:
    inp = Input(input_shape, name="image")
    x = Convolution2D(int(32 * alpha), 3, 3, subsample=2,
                      border_mode="same", bias=False, name="stem")(inp)
    x = BatchNormalization(name="stem_bn")(x)
    x = Activation("relu")(x)
    cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1)]
    for i, (f, s) in enumerate(cfg):
        x = _dw_block(x, f, s, f"b{i}", alpha=alpha)
    x = GlobalAveragePooling2D()(x)
    out = Dense(classes, name="fc")(x)
    return Model(inp, out, name="mobilenet")


def _inverted_residual(x, in_ch, filters, stride, expansion, name):
    """MobileNet v2 inverted residual with linear bottleneck."""
    hidden = in_ch * expansion
    y = x
    if expansion != 1:
        y = Convolution2D(hidden, 1, 1, border_mode="same", bias=False,
                          name=name + "_exp")(y)
        y = BatchNormalization(name=name + "_exp_bn")(y)
        y = Activation("relu6")(y)
    y = DepthwiseConvolution2D(3, 3, subsample=stride, border_mode="same",
                               bias=False, name=name + "_dw")(y)
    y = BatchNormalization(name=name + "_dw_bn")(y)
    y = Activation("relu6")(y)
    y = Convolution2D(filters, 1, 1, border_mode="same", bias=False,
                      name=name + "_proj")(y)
    y = BatchNormalization(name=name + "_proj_bn")(y)
    if stride == 1 and in_ch == filters:
        y = Add()([y, x])
    return y


def mobilenet_v2(input_shape=(224, 224, 3), classes: int = 1000) -> Model:
    inp = Input(input_shape, name="image")
    x = Convolution2D(32, 3, 3, subsample=2, border_mode="same",
                      bias=False, name="stem")(inp)
    x = BatchNormalization(name="stem_bn")(x)
    x = Activation("relu6")(x)
    # (expansion, out_channels, repeats, first_stride)
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    in_ch = 32
    bi = 0
    for t, c, n, s in cfg:
        for i in range(n):
            x = _inverted_residual(x, in_ch, c, s if i == 0 else 1, t,
                                   f"b{bi}")
            in_ch = c
            bi += 1
    x = Convolution2D(1280, 1, 1, border_mode="same", bias=False,
                      name="head")(x)
    x = BatchNormalization(name="head_bn")(x)
    x = Activation("relu6")(x)
    x = GlobalAveragePooling2D()(x)
    out = Dense(classes, name="fc")(x)
    return Model(inp, out, name="mobilenet_v2")


# ---------------------------------------------------------------------------
# DenseNet-121
# ---------------------------------------------------------------------------

def _dense_layer(x, growth, name):
    y = BatchNormalization(name=name + "_bn1")(x)
    y = Activation("relu")(y)
    y = Convolution2D(4 * growth, 1, 1, border_mode="same", bias=False,
                      name=name + "_c1")(y)
    y = BatchNormalization(name=name + "_bn2")(y)
    y = Activation("relu")(y)
    y = Convolution2D(growth, 3, 3, border_mode="same", bias=False,
                      name=name + "_c2")(y)
    return Concatenate(axis=-1)([x, y])


def densenet121(input_shape=(224, 224, 3), classes: int = 1000,
                growth: int = 32) -> Model:
    inp = Input(input_shape, name="image")
    x = Convolution2D(64, 7, 7, subsample=2, border_mode="same",
                      bias=False, name="stem")(inp)
    x = BatchNormalization(name="stem_bn")(x)
    x = Activation("relu")(x)
    x = MaxPooling2D(pool_size=3, strides=2, border_mode="same")(x)
    ch = 64
    for bi, n_layers in enumerate((6, 12, 24, 16)):
        for li in range(n_layers):
            x = _dense_layer(x, growth, f"d{bi}l{li}")
            ch += growth
        if bi < 3:  # transition
            ch //= 2
            x = BatchNormalization(name=f"t{bi}_bn")(x)
            x = Activation("relu")(x)
            x = Convolution2D(ch, 1, 1, border_mode="same", bias=False,
                              name=f"t{bi}_c")(x)
            x = AveragePooling2D(pool_size=2, strides=2)(x)
    x = BatchNormalization(name="final_bn")(x)
    x = Activation("relu")(x)
    x = GlobalAveragePooling2D()(x)
    out = Dense(classes, name="fc")(x)
    return Model(inp, out, name="densenet121")


# ---------------------------------------------------------------------------
# SqueezeNet v1.1
# ---------------------------------------------------------------------------

def _fire(x, squeeze, expand, name):
    s = Convolution2D(squeeze, 1, 1, border_mode="same",
                      activation="relu", name=name + "_sq")(x)
    e1 = Convolution2D(expand, 1, 1, border_mode="same",
                       activation="relu", name=name + "_e1")(s)
    e3 = Convolution2D(expand, 3, 3, border_mode="same",
                       activation="relu", name=name + "_e3")(s)
    return Concatenate(axis=-1)([e1, e3])


def squeezenet(input_shape=(224, 224, 3), classes: int = 1000) -> Model:
    inp = Input(input_shape, name="image")
    x = Convolution2D(64, 3, 3, subsample=2, border_mode="same",
                      activation="relu", name="stem")(inp)
    x = MaxPooling2D(pool_size=3, strides=2, border_mode="same")(x)
    x = _fire(x, 16, 64, "f2")
    x = _fire(x, 16, 64, "f3")
    x = MaxPooling2D(pool_size=3, strides=2, border_mode="same")(x)
    x = _fire(x, 32, 128, "f4")
    x = _fire(x, 32, 128, "f5")
    x = MaxPooling2D(pool_size=3, strides=2, border_mode="same")(x)
    x = _fire(x, 48, 192, "f6")
    x = _fire(x, 48, 192, "f7")
    x = _fire(x, 64, 256, "f8")
    x = _fire(x, 64, 256, "f9")
    x = Dropout(0.5)(x)
    x = Convolution2D(classes, 1, 1, border_mode="same",
                      activation="relu", name="conv10")(x)
    out = GlobalAveragePooling2D()(x)
    return Model(inp, out, name="squeezenet")
