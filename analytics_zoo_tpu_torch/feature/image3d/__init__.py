"""3-D image (volumetric, medical) transforms (port of
``analytics_zoo_tpu/feature/image3d``): ``AffineTransform3D``, ``Crop3D``
with its random and centre variants, ``Rotation3D`` and
``WarpTransformer`` on ``ImageFeature3D`` records; host numpy, volumes
(D, H, W) or (D, H, W, C)."""

from analytics_zoo_tpu_torch.feature.image3d.transforms import (  # noqa: F401
    AffineTransform3D,
    CenterCrop3D,
    Crop3D,
    ImageFeature3D,
    RandomCrop3D,
    Rotation3D,
    WarpTransformer,
    trilinear_sample,
)

__all__ = [
    "ImageFeature3D", "AffineTransform3D", "Crop3D", "RandomCrop3D",
    "CenterCrop3D", "Rotation3D", "WarpTransformer", "trilinear_sample",
]
