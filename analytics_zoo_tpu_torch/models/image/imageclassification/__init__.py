"""Image classification models of the port: ``ImageClassifier`` and its
registry (ResNet, LeNet-5, VGG, Inception-v1, MobileNet v1/v2,
DenseNet-121, SqueezeNet)."""

from analytics_zoo_tpu_torch.models.image.imageclassification \
    .image_classifier import ImageClassifier
from analytics_zoo_tpu_torch.models.image.imageclassification.resnet \
    import (FusedBottleneck, FusedStage, ResNet, S2DStemConv, SpaceToDepth2D,
            convert_resnet_params, fused_stage_forward, resnet50,
            s2d_stem_kernel)
from analytics_zoo_tpu_torch.models.image.imageclassification.lenet import \
    lenet5
from analytics_zoo_tpu_torch.models.image.imageclassification.archs import (
    densenet121, inception_v1, mobilenet, mobilenet_v2, squeezenet, vgg16,
    vgg19)

__all__ = ["FusedBottleneck", "FusedStage", "ImageClassifier", "ResNet",
           "S2DStemConv", "SpaceToDepth2D", "convert_resnet_params",
           "densenet121", "fused_stage_forward", "inception_v1", "lenet5",
           "mobilenet", "mobilenet_v2", "resnet50", "s2d_stem_kernel",
           "squeezenet", "vgg16", "vgg19"]
