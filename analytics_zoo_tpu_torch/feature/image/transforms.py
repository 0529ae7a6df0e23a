"""Image preprocessing transformers on the host (port of
``analytics_zoo_tpu/feature/image/transforms.py``, numpy and PIL, kept as
a copy; the Scala originals are the OpenCV transformers of
``Z/feature/image/*.scala``: resize, crops, flip, colour jitter,
expand and filler, normalisation, Mat to tensor, to sample).

PIL plays OpenCV's role and is imported only by the transformers that
decode or resize (``ImageResize``, ``ImageAspectScale``,
``ImageRandomAspectScale``, ``ImageBytesToMat``). Each random
transformer draws from its own ``np.random.RandomState(seed)`` in the
reference's order, so one seed gives the reference's pixels bit for
bit. Per-batch augmentation on the card is ``device_transforms``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.feature.common import Preprocessing, Sample
from analytics_zoo_tpu_torch.feature.image.imageset import ImageFeature


class ImagePreprocessing(Preprocessing):
    """Base: operates on ImageFeature, transforming the `image` ndarray."""

    def apply_image(self, img: np.ndarray, feature: ImageFeature
                    ) -> np.ndarray:
        raise NotImplementedError

    def apply(self, feature: ImageFeature) -> ImageFeature:
        feature[ImageFeature.IMAGE] = self.apply_image(
            feature[ImageFeature.IMAGE], feature)
        return feature


class ImageResize(ImagePreprocessing):
    """(reference `ImageResize.scala`)"""

    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = int(resize_h), int(resize_w)

    def apply_image(self, img, feature):
        from PIL import Image
        pil = Image.fromarray(img.astype(np.uint8) if
                              img.dtype != np.uint8 else img)
        return np.asarray(pil.resize((self.w, self.h),
                                     Image.BILINEAR), img.dtype)


class ImageAspectScale(ImagePreprocessing):
    """Resize the short side to `scale` keeping aspect ratio, cap long
    side (reference `ImageAspectScale.scala`)."""

    def __init__(self, scale: int, max_size: int = 1000):
        self.scale, self.max_size = int(scale), int(max_size)

    def apply_image(self, img, feature):
        from PIL import Image
        h, w = img.shape[:2]
        ratio = self.scale / min(h, w)
        if round(ratio * max(h, w)) > self.max_size:
            ratio = self.max_size / max(h, w)
        nh, nw = int(round(h * ratio)), int(round(w * ratio))
        pil = Image.fromarray(img.astype(np.uint8))
        return np.asarray(pil.resize((nw, nh), Image.BILINEAR), img.dtype)


class ImageRandomAspectScale(ImagePreprocessing):
    """Pick a random short-side scale (reference
    `ImageRandomAspectScale`)."""

    def __init__(self, scales: Sequence[int], max_size: int = 1000,
                 seed: Optional[int] = None):
        self.scales = list(scales)
        self.max_size = max_size
        self.rng = np.random.RandomState(seed)

    def apply_image(self, img, feature):
        scale = self.scales[self.rng.randint(len(self.scales))]
        return ImageAspectScale(scale, self.max_size) \
            .apply_image(img, feature)


class ImageCenterCrop(ImagePreprocessing):
    """(reference `ImageCenterCrop.scala`)"""

    def __init__(self, crop_h: int, crop_w: int):
        self.h, self.w = int(crop_h), int(crop_w)

    def apply_image(self, img, feature):
        h, w = img.shape[:2]
        top = max((h - self.h) // 2, 0)
        left = max((w - self.w) // 2, 0)
        return img[top:top + self.h, left:left + self.w]


class ImageRandomCrop(ImagePreprocessing):
    """(reference `ImageRandomCrop.scala`)"""

    def __init__(self, crop_h: int, crop_w: int,
                 seed: Optional[int] = None):
        self.h, self.w = int(crop_h), int(crop_w)
        self.rng = np.random.RandomState(seed)

    def apply_image(self, img, feature):
        h, w = img.shape[:2]
        top = self.rng.randint(max(h - self.h, 0) + 1)
        left = self.rng.randint(max(w - self.w, 0) + 1)
        return img[top:top + self.h, left:left + self.w]


class ImageHFlip(ImagePreprocessing):
    """Horizontal flip with probability p (reference `ImageHFlip`)."""

    def __init__(self, p: float = 0.5, seed: Optional[int] = None):
        self.p = float(p)
        self.rng = np.random.RandomState(seed)

    def apply_image(self, img, feature):
        if self.rng.rand() < self.p:
            return img[:, ::-1]
        return img


class ImageBrightness(ImagePreprocessing):
    """Additive brightness jitter in [delta_low, delta_high] (reference
    `ImageBrightness`)."""

    def __init__(self, delta_low: float = -32.0, delta_high: float = 32.0,
                 seed: Optional[int] = None):
        self.lo, self.hi = float(delta_low), float(delta_high)
        self.rng = np.random.RandomState(seed)

    def apply_image(self, img, feature):
        delta = self.rng.uniform(self.lo, self.hi)
        return np.clip(img.astype(np.float32) + delta, 0, 255) \
            .astype(img.dtype)


class ImageContrast(ImagePreprocessing):
    """Multiplicative contrast jitter (reference `ImageContrast`)."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5,
                 seed: Optional[int] = None):
        self.lo, self.hi = float(delta_low), float(delta_high)
        self.rng = np.random.RandomState(seed)

    def apply_image(self, img, feature):
        scale = self.rng.uniform(self.lo, self.hi)
        return np.clip(img.astype(np.float32) * scale, 0, 255) \
            .astype(img.dtype)


def _rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    import colorsys
    del colorsys  # vectorized below
    arr = img.astype(np.float32) / 255.0
    mx = arr.max(-1)
    mn = arr.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    h = np.where(mx == r, (g - b) / diff % 6,
                 np.where(mx == g, (b - r) / diff + 2,
                          (r - g) / diff + 4)) * 60.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    return np.stack([h, s, mx], axis=-1)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    c = v * s
    hp = (h / 60.0) % 6
    x = c * (1 - np.abs(hp % 2 - 1))
    z = np.zeros_like(c)
    conds = [
        (hp < 1, np.stack([c, x, z], -1)),
        ((hp >= 1) & (hp < 2), np.stack([x, c, z], -1)),
        ((hp >= 2) & (hp < 3), np.stack([z, c, x], -1)),
        ((hp >= 3) & (hp < 4), np.stack([z, x, c], -1)),
        ((hp >= 4) & (hp < 5), np.stack([x, z, c], -1)),
        (hp >= 5, np.stack([c, z, x], -1)),
    ]
    rgb = np.zeros(hsv.shape, np.float32)
    for cond, val in conds:
        rgb = np.where(cond[..., None], val, rgb)
    m = (v - c)[..., None]
    return np.clip((rgb + m) * 255.0, 0, 255)


class ImageSaturation(ImagePreprocessing):
    """Saturation jitter via HSV (reference `ImageSaturation`)."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5,
                 seed: Optional[int] = None):
        self.lo, self.hi = float(delta_low), float(delta_high)
        self.rng = np.random.RandomState(seed)

    def apply_image(self, img, feature):
        hsv = _rgb_to_hsv(img)
        hsv[..., 1] = np.clip(
            hsv[..., 1] * self.rng.uniform(self.lo, self.hi), 0, 1)
        return _hsv_to_rgb(hsv).astype(img.dtype)


class ImageHue(ImagePreprocessing):
    """Hue rotation in degrees (reference `ImageHue`)."""

    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0,
                 seed: Optional[int] = None):
        self.lo, self.hi = float(delta_low), float(delta_high)
        self.rng = np.random.RandomState(seed)

    def apply_image(self, img, feature):
        hsv = _rgb_to_hsv(img)
        hsv[..., 0] = (hsv[..., 0] +
                       self.rng.uniform(self.lo, self.hi)) % 360.0
        return _hsv_to_rgb(hsv).astype(img.dtype)


class ImageColorJitter(ImagePreprocessing):
    """Random brightness+contrast+saturation+hue (reference
    `ImageColorJitter`)."""

    def __init__(self, seed: Optional[int] = None):
        self.stages = [ImageBrightness(seed=seed),
                       ImageContrast(seed=seed),
                       ImageSaturation(seed=seed),
                       ImageHue(seed=seed)]

    def apply_image(self, img, feature):
        for s in self.stages:
            img = s.apply_image(img, feature)
        return img


class ImageExpand(ImagePreprocessing):
    """Place the image on a larger mean-filled canvas (reference
    `ImageExpand` — SSD augmentation)."""

    def __init__(self, means: Sequence[float] = (123.0, 117.0, 104.0),
                 max_expand_ratio: float = 4.0,
                 seed: Optional[int] = None):
        self.means = np.asarray(means, np.float32)
        self.max_ratio = float(max_expand_ratio)
        self.rng = np.random.RandomState(seed)

    def apply_image(self, img, feature):
        ratio = self.rng.uniform(1.0, self.max_ratio)
        h, w = img.shape[:2]
        nh, nw = int(h * ratio), int(w * ratio)
        canvas = np.broadcast_to(
            self.means, (nh, nw, img.shape[2])).astype(img.dtype).copy()
        top = self.rng.randint(nh - h + 1)
        left = self.rng.randint(nw - w + 1)
        canvas[top:top + h, left:left + w] = img
        feature["expand_offset"] = (top, left, ratio)
        return canvas


class ImageFiller(ImagePreprocessing):
    """Fill a sub-rectangle with a value (reference `ImageFiller`)."""

    def __init__(self, start_x: float, start_y: float, end_x: float,
                 end_y: float, value: int = 255):
        self.box = (start_x, start_y, end_x, end_y)
        self.value = value

    def apply_image(self, img, feature):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        img = img.copy()
        img[int(y1 * h):int(y2 * h), int(x1 * w):int(x2 * w)] = self.value
        return img


class ImageChannelNormalize(ImagePreprocessing):
    """(x - mean) / std per channel (reference
    `ImageChannelNormalize.scala`)."""

    def __init__(self, mean_r: float, mean_g: float, mean_b: float,
                 std_r: float = 1.0, std_g: float = 1.0,
                 std_b: float = 1.0):
        self.mean = np.asarray([mean_r, mean_g, mean_b], np.float32)
        self.std = np.asarray([std_r, std_g, std_b], np.float32)

    def apply_image(self, img, feature):
        return (img.astype(np.float32) - self.mean) / self.std


class ImageChannelScaledNormalizer(ImagePreprocessing):
    """(x - mean) * scale (reference `ImageChannelScaledNormalizer`)."""

    def __init__(self, mean_r: float, mean_g: float, mean_b: float,
                 scale: float):
        self.mean = np.asarray([mean_r, mean_g, mean_b], np.float32)
        self.scale = float(scale)

    def apply_image(self, img, feature):
        return (img.astype(np.float32) - self.mean) * self.scale


class ImagePixelNormalizer(ImagePreprocessing):
    """Subtract a per-pixel mean image (reference
    `ImagePixelNormalizer`)."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def apply_image(self, img, feature):
        return img.astype(np.float32) - self.means


class ImageMatToTensor(ImagePreprocessing):
    """uint8 HWC → float32 tensor (reference `ImageMatToTensor`; stays
    HWC, the layout the port's convolutions take; pass `to_chw=True` for
    CHW)."""

    def __init__(self, to_chw: bool = False):
        self.to_chw = to_chw

    def apply_image(self, img, feature):
        out = np.asarray(img, np.float32)
        if self.to_chw:
            out = out.transpose(2, 0, 1)
        return out


class ImageSetToSample(ImagePreprocessing):
    """Wrap image (+label) into a Sample (reference
    `ImageSetToSample.scala`)."""

    def __init__(self, input_keys=(ImageFeature.IMAGE,),
                 target_keys=(ImageFeature.LABEL,)):
        self.input_keys = list(input_keys)
        self.target_keys = list(target_keys)

    def apply(self, feature: ImageFeature) -> ImageFeature:
        inputs = [np.asarray(feature[k], np.float32)
                  for k in self.input_keys]
        label = None
        if self.target_keys and self.target_keys[0] in feature:
            label = np.asarray(feature[self.target_keys[0]])
        feature[ImageFeature.SAMPLE] = Sample(
            feature=inputs if len(inputs) > 1 else inputs[0], label=label)
        return feature


class ImageRandomPreprocessing(ImagePreprocessing):
    """Apply an inner transform with probability p (reference
    `ImageRandomPreprocessing`)."""

    def __init__(self, preprocessing: ImagePreprocessing, prob: float,
                 seed: Optional[int] = None):
        self.inner = preprocessing
        self.prob = float(prob)
        self.rng = np.random.RandomState(seed)

    def apply(self, feature):
        if self.rng.rand() < self.prob:
            return self.inner.apply(feature)
        return feature


class ImageBytesToMat(ImagePreprocessing):
    """Decode encoded image bytes (JPEG/PNG) into an HWC uint8 array
    (reference `ImageBytesToMat.scala` — there OpenCV imdecode; here
    PIL). Reads the feature's `bytes` field when the image slot holds
    raw bytes."""

    def __init__(self, channel_order: str = "RGB"):
        if channel_order not in ("RGB", "BGR"):
            raise ValueError("channel_order must be RGB|BGR")
        self.channel_order = channel_order

    def apply(self, feature: ImageFeature) -> ImageFeature:
        import io

        from PIL import Image
        raw = feature[ImageFeature.IMAGE]
        if isinstance(raw, np.ndarray) and raw.ndim >= 2:
            # already decoded — framework decoders produce RGB, so
            # still honor a BGR request
            if self.channel_order == "BGR":
                feature[ImageFeature.IMAGE] = \
                    ImageChannelOrder().apply_image(raw, feature)
            return feature
        # np.array(PIL) is already a fresh contiguous writable array
        img = np.array(
            Image.open(io.BytesIO(bytes(raw))).convert("RGB"))
        if self.channel_order == "BGR":
            img = np.ascontiguousarray(img[..., ::-1])
        feature[ImageFeature.IMAGE] = img
        return feature


class ImagePixelBytesToMat(ImagePreprocessing):
    """Raw pixel bytes + (h, w, c) shape → ndarray (reference
    `ImagePixelBytesToMat.scala`)."""

    def __init__(self, height: int, width: int, channels: int = 3):
        self.shape = (int(height), int(width), int(channels))

    def apply(self, feature: ImageFeature) -> ImageFeature:
        raw = feature[ImageFeature.IMAGE]
        arr = np.frombuffer(bytes(raw), np.uint8).reshape(self.shape)
        # frombuffer views are read-only; own the memory
        feature[ImageFeature.IMAGE] = arr.copy()
        return feature


class ImageChannelOrder(ImagePreprocessing):
    """Swap RGB↔BGR (reference `ImageChannelOrder.scala`). No-op for
    grayscale (a channel swap is identity without channels — guarding
    keeps 2-D images from being mirrored along width)."""

    def apply_image(self, img, feature):
        if img.ndim < 3 or img.shape[-1] not in (3, 4):
            return img
        if img.shape[-1] == 4:  # RGBA: swap color planes, keep alpha
            return np.ascontiguousarray(np.concatenate(
                [img[..., 2::-1], img[..., 3:]], axis=-1))
        return np.ascontiguousarray(img[..., ::-1])


class ImageFixedCrop(ImagePreprocessing):
    """Crop a fixed region (reference `ImageFixedCrop.scala`):
    (x1, y1, x2, y2), normalized [0, 1] when ``normalized=True`` else
    absolute pixel coordinates."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 normalized: bool = True):
        self.box = (float(x1), float(y1), float(x2), float(y2))
        self.normalized = normalized

    def apply_image(self, img, feature):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, x2 = x1 * w, x2 * w
            y1, y2 = y1 * h, y2 * h
        x1 = int(np.clip(round(x1), 0, w - 1))
        x2 = int(np.clip(round(x2), x1 + 1, w))
        y1 = int(np.clip(round(y1), 0, h - 1))
        y2 = int(np.clip(round(y2), y1 + 1, h))
        return np.ascontiguousarray(img[y1:y2, x1:x2])


class ImageMatToFloats(ImagePreprocessing):
    """Flatten the image into a float32 vector (reference
    `ImageMatToFloats.scala` — the raw-floats handoff used by the
    serving path)."""

    def apply_image(self, img, feature):
        return np.asarray(img, np.float32).reshape(-1)
