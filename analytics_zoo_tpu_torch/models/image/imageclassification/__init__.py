"""Image classification models of the port (ResNet)."""

from analytics_zoo_tpu_torch.models.image.imageclassification \
    .image_classifier import ImageClassifier
from analytics_zoo_tpu_torch.models.image.imageclassification.resnet \
    import (FusedBottleneck, ResNet, convert_resnet_params, resnet50)

__all__ = ["FusedBottleneck", "ImageClassifier", "ResNet",
           "convert_resnet_params", "resnet50"]
