"""3-D image transforms on the host (port of
``analytics_zoo_tpu/feature/image3d/transforms.py``, numpy, kept as a
copy; the Scala originals are ``Z/feature/image3d/``).

- ``AffineTransform3D``: trilinear resampling under an affine map about
  the volume's centre (``Affine.scala``).
- ``Crop3D`` / ``RandomCrop3D`` / ``CenterCrop3D``: sub-volume
  extraction (``Cropper.scala``: ``Crop3D.apply(start, patchSize)``).
- ``Rotation3D``: Euler-angle rotation, an affine special case
  (``Rotation.scala``).
- ``WarpTransformer``: dense displacement-field warping
  (``Warp.scala``).

Volumes are numpy (D, H, W) or (D, H, W, C); channels transform
independently, on the host, as the 2-D pipeline's decode and
augmentation do.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.feature.common import Preprocessing


class ImageFeature3D(dict):
    """Record for one volume (reference `ImageFeature3D.scala`)."""

    IMAGE = "image"
    LABEL = "label"
    URI = "uri"
    ORIGINAL_SIZE = "original_size"

    def __init__(self, image: Optional[np.ndarray] = None, label=None,
                 uri: Optional[str] = None):
        super().__init__()
        if image is not None:
            image = np.asarray(image)
            if image.ndim not in (3, 4):
                raise ValueError(
                    f"expected (D,H,W[,C]) volume, got {image.shape}")
            self[self.IMAGE] = image
            self[self.ORIGINAL_SIZE] = image.shape
        if label is not None:
            self[self.LABEL] = label
        if uri is not None:
            self[self.URI] = uri

    @property
    def image(self) -> np.ndarray:
        return self[self.IMAGE]

    @image.setter
    def image(self, v):
        self[self.IMAGE] = v


class ImagePreprocessing3D(Preprocessing):
    """Base: transforms the `image` volume of an ImageFeature3D (raw
    ndarrays are wrapped on the fly)."""

    def apply_volume(self, vol: np.ndarray,
                     feature: ImageFeature3D) -> np.ndarray:
        raise NotImplementedError

    def apply(self, feature):
        if not isinstance(feature, ImageFeature3D):
            feature = ImageFeature3D(np.asarray(feature))
        feature[ImageFeature3D.IMAGE] = self.apply_volume(
            feature[ImageFeature3D.IMAGE], feature)
        return feature


def _split_channels(vol: np.ndarray):
    """(D,H,W) → [(D,H,W)]; (D,H,W,C) → per-channel list."""
    if vol.ndim == 3:
        return [vol], False
    return [vol[..., c] for c in range(vol.shape[-1])], True


def _merge_channels(chans, had_channels: bool):
    return np.stack(chans, axis=-1) if had_channels else chans[0]


def trilinear_sample(vol: np.ndarray, coords: np.ndarray,
                     pad_mode: str = "clamp",
                     pad_value: float = 0.0) -> np.ndarray:
    """Sample `vol` (D,H,W) at float `coords` (3, N) trilinearly.

    pad_mode "clamp": out-of-bounds coordinates clamp to the border
    (reference Affine's default); "constant": fill `pad_value`.
    """
    d, h, w = vol.shape
    z, y, x = coords
    if pad_mode == "constant":
        oob = ((z < 0) | (z > d - 1) | (y < 0) | (y > h - 1) |
               (x < 0) | (x > w - 1))
    z = np.clip(z, 0.0, d - 1)
    y = np.clip(y, 0.0, h - 1)
    x = np.clip(x, 0.0, w - 1)
    z0 = np.floor(z).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x0 = np.floor(x).astype(np.int64)
    z1 = np.minimum(z0 + 1, d - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fz, fy, fx = z - z0, y - y0, x - x0
    out = np.zeros(z.shape, np.float64)
    for zz, wz in ((z0, 1 - fz), (z1, fz)):
        for yy, wy in ((y0, 1 - fy), (y1, fy)):
            for xx, wx in ((x0, 1 - fx), (x1, fx)):
                out += vol[zz, yy, xx].astype(np.float64) * \
                    (wz * wy * wx)
    if pad_mode == "constant":
        out = np.where(oob, pad_value, out)
    return out.astype(vol.dtype if np.issubdtype(
        vol.dtype, np.floating) else np.float32)


class AffineTransform3D(ImagePreprocessing3D):
    """Affine resample about the volume center (reference
    `Affine.scala`): for each output voxel o, samples input at
    ``mat^-1 @ (o - center - translation) + center``.

    `mat` is the 3x3 forward transform; `translation` a 3-vector.
    """

    def __init__(self, mat: np.ndarray,
                 translation: Sequence[float] = (0.0, 0.0, 0.0),
                 clamp_mode: str = "clamp", pad_value: float = 0.0):
        self.mat = np.asarray(mat, np.float64).reshape(3, 3)
        self.translation = np.asarray(translation, np.float64)
        if clamp_mode not in ("clamp", "padding"):
            raise ValueError("clamp_mode must be 'clamp' or 'padding'")
        self.clamp_mode = clamp_mode
        self.pad_value = float(pad_value)

    def apply_volume(self, vol, feature):
        chans, had_c = _split_channels(np.asarray(vol))
        shape = chans[0].shape
        center = (np.asarray(shape, np.float64) - 1.0) / 2.0
        inv = np.linalg.inv(self.mat)
        grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                                    indexing="ij"), axis=0
                        ).reshape(3, -1).astype(np.float64)
        src = inv @ (grid - center[:, None] -
                     self.translation[:, None]) + center[:, None]
        mode = "clamp" if self.clamp_mode == "clamp" else "constant"
        out = [trilinear_sample(c, src, pad_mode=mode,
                                pad_value=self.pad_value
                                ).reshape(shape) for c in chans]
        return _merge_channels(out, had_c)


class Rotation3D(AffineTransform3D):
    """Euler rotation (reference `Rotation.scala`): `rotation_angles`
    are radians about the (z, y, x) axes, composed Rz @ Ry @ Rx."""

    def __init__(self, rotation_angles: Sequence[float],
                 clamp_mode: str = "clamp", pad_value: float = 0.0):
        az, ay, ax = (float(a) for a in rotation_angles)
        cz, sz = math.cos(az), math.sin(az)
        cy, sy = math.cos(ay), math.sin(ay)
        cx, sx = math.cos(ax), math.sin(ax)
        rz = np.array([[1, 0, 0], [0, cz, -sz], [0, sz, cz]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rx = np.array([[cx, -sx, 0], [sx, cx, 0], [0, 0, 1]])
        super().__init__(rz @ ry @ rx, clamp_mode=clamp_mode,
                         pad_value=pad_value)
        self.rotation_angles = (az, ay, ax)


class Crop3D(ImagePreprocessing3D):
    """Fixed sub-volume (reference `Cropper.scala` `Crop3D`): `start`
    (z, y, x) corner + `patch_size` (d, h, w)."""

    def __init__(self, start: Sequence[int], patch_size: Sequence[int]):
        self.start = tuple(int(v) for v in start)
        self.patch = tuple(int(v) for v in patch_size)
        if len(self.start) != 3 or len(self.patch) != 3:
            raise ValueError("start and patch_size must be length 3")

    def apply_volume(self, vol, feature):
        for dim, (s, p) in enumerate(zip(self.start, self.patch)):
            if s < 0 or s + p > vol.shape[dim]:
                raise ValueError(
                    f"crop [{s}:{s + p}] exceeds dim {dim} of size "
                    f"{vol.shape[dim]}")
        z, y, x = self.start
        d, h, w = self.patch
        return vol[z:z + d, y:y + h, x:x + w]


class RandomCrop3D(ImagePreprocessing3D):
    """(reference `RandomCrop3D`)"""

    def __init__(self, crop_depth: int, crop_height: int,
                 crop_width: int, seed: Optional[int] = None):
        self.patch = (int(crop_depth), int(crop_height),
                      int(crop_width))
        self._rng = np.random.RandomState(seed)

    def apply_volume(self, vol, feature):
        starts = []
        for dim, p in enumerate(self.patch):
            if p > vol.shape[dim]:
                raise ValueError(
                    f"crop size {p} exceeds dim {dim} of "
                    f"size {vol.shape[dim]}")
            starts.append(self._rng.randint(0, vol.shape[dim] - p + 1))
        z, y, x = starts
        d, h, w = self.patch
        return vol[z:z + d, y:y + h, x:x + w]


class CenterCrop3D(ImagePreprocessing3D):
    """(reference `CenterCrop3D`)"""

    def __init__(self, crop_depth: int, crop_height: int,
                 crop_width: int):
        self.patch = (int(crop_depth), int(crop_height),
                      int(crop_width))

    def apply_volume(self, vol, feature):
        starts = []
        for dim, p in enumerate(self.patch):
            if p > vol.shape[dim]:
                raise ValueError(
                    f"crop size {p} exceeds dim {dim} of "
                    f"size {vol.shape[dim]}")
            starts.append((vol.shape[dim] - p) // 2)
        z, y, x = starts
        d, h, w = self.patch
        return vol[z:z + d, y:y + h, x:x + w]


class WarpTransformer(ImagePreprocessing3D):
    """Dense displacement warp (reference `Warp.scala`): samples input
    at ``grid + offset`` where `offset` is a (D, H, W, 3) field of
    (dz, dy, dx) displacements."""

    def __init__(self, offset: np.ndarray, clamp_mode: str = "clamp",
                 pad_value: float = 0.0):
        self.offset = np.asarray(offset, np.float64)
        if self.offset.ndim != 4 or self.offset.shape[-1] != 3:
            raise ValueError("offset must be (D, H, W, 3)")
        if clamp_mode not in ("clamp", "padding"):
            raise ValueError("clamp_mode must be 'clamp' or 'padding'")
        self.clamp_mode = clamp_mode
        self.pad_value = float(pad_value)

    def apply_volume(self, vol, feature):
        chans, had_c = _split_channels(np.asarray(vol))
        shape = chans[0].shape
        if self.offset.shape[:3] != shape:
            raise ValueError(
                f"offset field {self.offset.shape[:3]} does not match "
                f"volume {shape}")
        grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                                    indexing="ij"), axis=0
                        ).astype(np.float64)
        src = (grid + np.moveaxis(self.offset, -1, 0)).reshape(3, -1)
        mode = "clamp" if self.clamp_mode == "clamp" else "constant"
        out = [trilinear_sample(c, src, pad_mode=mode,
                                pad_value=self.pad_value
                                ).reshape(shape) for c in chans]
        return _merge_channels(out, had_c)
