"""Image classification models of the port (ResNet)."""

from analytics_zoo_tpu_torch.models.image.imageclassification \
    .image_classifier import ImageClassifier
from analytics_zoo_tpu_torch.models.image.imageclassification.resnet \
    import (FusedBottleneck, FusedStage, ResNet, S2DStemConv, SpaceToDepth2D,
            convert_resnet_params, fused_stage_forward, resnet50,
            s2d_stem_kernel)

__all__ = ["FusedBottleneck", "FusedStage", "ImageClassifier", "ResNet",
           "S2DStemConv", "SpaceToDepth2D", "convert_resnet_params",
           "fused_stage_forward", "resnet50", "s2d_stem_kernel"]
