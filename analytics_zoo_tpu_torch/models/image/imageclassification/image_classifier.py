"""ImageClassifier (port of
``analytics_zoo_tpu/models/image/imageclassification/image_classifier.py``):
a ZooModel that builds a named architecture from one name→builder
registry, loads a model by published name or by path, and for the
ResNets chooses the fused conv+BN kernels or the unfused graph."""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

from analytics_zoo_tpu_torch.models.common import ZooModel


def _fused_resnet() -> bool:
    """``ZOO_TPU_FUSED_RESNET``: "1"/"0" pin the fused conv+BN
    bottlenecks (``ops/conv_bn.py``) on or off; "auto" (the default)
    routes to them where ``conv_bn.fused_profitable()`` says so."""
    mode = os.environ.get("ZOO_TPU_FUSED_RESNET", "auto")
    if mode == "auto":
        from analytics_zoo_tpu_torch.ops.conv_bn import fused_profitable
        return fused_profitable()
    return mode == "1"


def _build_resnet(depth, s, c, fused=False):
    from analytics_zoo_tpu_torch.models.image.imageclassification.resnet \
        import ResNet
    return ResNet(depth).build(s, c, fused=fused)


def _builders():
    """The single name→builder registry; ``ARCHS`` is its keys, so the
    names accepted and the names built cannot drift apart. The ResNet
    builders take ``fused=``; the rest have one layout."""
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        archs
    from analytics_zoo_tpu_torch.models.image.imageclassification.lenet \
        import lenet5
    reg = {
        "lenet-5": lenet5,
        "vgg-16": archs.vgg16,
        "vgg-19": archs.vgg19,
        "inception-v1": archs.inception_v1,
        "mobilenet": archs.mobilenet,
        "mobilenet-v2": archs.mobilenet_v2,
        "densenet-121": archs.densenet121,
        "squeezenet": archs.squeezenet,
    }
    for d in (50, 101, 152):
        reg[f"resnet-{d}"] = functools.partial(_build_resnet, d)
    return reg


class ImageClassifier(ZooModel):
    """``ImageClassifier(model_name="resnet-50")``: a named architecture
    for image classification. ``fused=True`` (ResNets only) builds the
    bottlenecks as fused conv+BN kernels (the serving path on the card),
    ``False`` the unfused graph; None resolves ``ZOO_TPU_FUSED_RESNET``
    when the classifier is built, and the resolved value stays in
    ``hyper_parameters`` (a saved model comes back with the layout it
    was saved with, whatever the loading process's environment)."""

    class _ArchList:
        """Class-level descriptor: ``ImageClassifier.ARCHS`` and
        ``instance.ARCHS`` both give the tuple of names."""

        def __get__(self, obj, objtype=None):
            return tuple(_builders())

    ARCHS = _ArchList()

    def __init__(self, model_name: str = "resnet-50",
                 input_shape: Tuple[int, int, int] = (224, 224, 3),
                 classes: int = 1000, fused: Optional[bool] = None):
        super().__init__()
        name = model_name.lower()
        if name not in _builders():
            raise ValueError(f"unknown architecture '{model_name}'; "
                             f"known: {tuple(_builders())}")
        self.model_name = name
        self.input_shape = tuple(input_shape)
        self.classes = int(classes)
        if fused is None:
            fused = name.startswith("resnet-") and _fused_resnet()
        self.fused = bool(fused)
        if self.fused and not name.startswith("resnet-"):
            raise ValueError(f"fused=True is ResNet-only, not {name}")

    def hyper_parameters(self):
        return {"model_name": self.model_name,
                "input_shape": self.input_shape,
                "classes": self.classes,
                "fused": self.fused}

    def build_model(self):
        builder = _builders()[self.model_name]
        if self.model_name.startswith("resnet-"):
            return builder(self.input_shape, self.classes,
                           fused=self.fused)
        return builder(self.input_shape, self.classes)

    @classmethod
    def load_model(cls, path_or_name: str, weights_path=None,
                   input_shape=(224, 224, 3), classes: int = 1000,
                   allow_random: bool = False):
        """Load by published name or by path: a known architecture name
        (``"resnet-50"``, or the reference's
        ``"analytics-zoo_<arch>_<dataset>_<version>"``), or a name with
        an artifact under ``$ZOO_TPU_PRETRAINED_DIR``, goes through
        :meth:`ImageClassificationConfig.create` (weights from
        ``weights_path`` or that directory, shapes checked; raising
        when none is found unless ``allow_random=True``); anything else
        is a :meth:`save_model` file."""
        from analytics_zoo_tpu_torch.models.config import (
            ImageClassificationConfig, _resolve_weights,
            _strip_published_name)
        arch = _strip_published_name(path_or_name).lower()
        if arch in _builders() or _resolve_weights(
                path_or_name, arch, None) is not None:
            return ImageClassificationConfig.create(
                path_or_name, input_shape=input_shape, classes=classes,
                weights_path=weights_path, allow_random=allow_random)
        return super().load_model(path_or_name)
