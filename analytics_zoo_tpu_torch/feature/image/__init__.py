"""The image data path (port of ``analytics_zoo_tpu/feature/image``):
``ImageSet``/``ImageFeature`` and the 24 host transformers; per-batch
augmentation on the card is ``feature.image.device_transforms``."""

from analytics_zoo_tpu_torch.feature.image.imageset import (
    ImageFeature, ImageSet, LocalImageSet)
from analytics_zoo_tpu_torch.feature.image.transforms import (
    ImageBrightness, ImageBytesToMat, ImageCenterCrop,
    ImageChannelNormalize, ImageChannelOrder, ImageContrast,
    ImageExpand, ImageFiller, ImageFixedCrop, ImageHFlip, ImageHue,
    ImageMatToFloats, ImageMatToTensor, ImagePixelBytesToMat,
    ImagePixelNormalizer, ImageRandomCrop, ImageRandomPreprocessing,
    ImageResize, ImageSaturation, ImageSetToSample, ImageAspectScale,
    ImageChannelScaledNormalizer, ImageRandomAspectScale,
    ImageColorJitter)

__all__ = [
    "ImageFeature", "ImageSet", "LocalImageSet",
    "ImageResize", "ImageCenterCrop", "ImageRandomCrop", "ImageHFlip",
    "ImageBrightness", "ImageContrast", "ImageSaturation", "ImageHue",
    "ImageChannelNormalize", "ImagePixelNormalizer", "ImageMatToTensor",
    "ImageSetToSample", "ImageExpand", "ImageFiller",
    "ImageRandomPreprocessing", "ImageAspectScale",
    "ImageRandomAspectScale", "ImageChannelScaledNormalizer",
    "ImageColorJitter", "ImageBytesToMat", "ImagePixelBytesToMat",
    "ImageChannelOrder", "ImageFixedCrop", "ImageMatToFloats",
]
