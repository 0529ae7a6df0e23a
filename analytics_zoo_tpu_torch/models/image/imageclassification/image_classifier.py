"""ImageClassifier (port of
``analytics_zoo_tpu/models/image/imageclassification/image_classifier.py``
for the ResNets)."""

from __future__ import annotations

import os
from typing import Optional, Tuple

from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.models.image.imageclassification.resnet \
    import ResNet

ARCHS = ("resnet-50", "resnet-101", "resnet-152")


def _fused_resnet() -> bool:
    """``ZOO_TPU_FUSED_RESNET``: "1"/"0" pin the fused conv+BN
    bottlenecks (``ops/conv_bn.py``) on or off; "auto" (the default)
    routes to them where ``conv_bn.fused_profitable()`` says so."""
    mode = os.environ.get("ZOO_TPU_FUSED_RESNET", "auto")
    if mode == "auto":
        from analytics_zoo_tpu_torch.ops.conv_bn import fused_profitable
        return fused_profitable()
    return mode == "1"


class ImageClassifier(ZooModel):
    """``ImageClassifier("resnet-50", fused=True)``: a named ResNet.
    ``fused=True`` builds the bottlenecks as fused conv+BN kernels
    (the serving path on the card), ``False`` the unfused graph; None
    resolves ``ZOO_TPU_FUSED_RESNET`` when the classifier is built, and
    the resolved value stays in ``hyper_parameters`` (a saved model
    comes back with the layout it was saved with, whatever the loading
    process's environment)."""

    ARCHS = ARCHS

    def __init__(self, model_name: str = "resnet-50",
                 input_shape: Tuple[int, int, int] = (224, 224, 3),
                 classes: int = 1000, fused: Optional[bool] = None):
        super().__init__()
        name = model_name.lower()
        if name not in ARCHS:
            raise ValueError(f"unknown architecture '{model_name}'; "
                             f"known: {ARCHS}")
        self.model_name = name
        self.input_shape = tuple(input_shape)
        self.classes = int(classes)
        self.fused = bool(_fused_resnet() if fused is None else fused)

    def hyper_parameters(self):
        return {"model_name": self.model_name,
                "input_shape": self.input_shape,
                "classes": self.classes,
                "fused": self.fused}

    def build_model(self):
        depth = int(self.model_name.split("-")[1])
        return ResNet(depth).build(self.input_shape, self.classes,
                                   fused=self.fused)
