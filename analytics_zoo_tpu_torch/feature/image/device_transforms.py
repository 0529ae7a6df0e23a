"""Batched image augmentation on the card (port of
``analytics_zoo_tpu/feature/image/device_transforms.py``).

The host transformers (``feature/image/transforms.py``) augment one
record at a time; these ops augment a whole float NHWC batch on its own
device inside the train step (``Estimator(augment=...)``), so the host's
cores stay free for decoding and the batch never goes back to the host.

Each op is an :class:`AugmentOp` with two halves:

- ``sample(seed, images)`` draws the op's per-image parameters as
  tensors on ``images.device``, from a ``torch.Generator`` made there
  from ``seed`` (``ops/rng.py``);
- ``apply(images, params)`` is a pure function of the images and those
  parameters.

Calling the op, ``op(seed, images)``, is ``apply(images, sample(seed,
images))``. The split lets a caller hand ``apply`` parameters drawn
elsewhere (the tests hand it the JAX package's own ``jax.random``
draws). The draws come from ``torch.Generator``, so one seed gives other
numbers than ``jax.random``'s.

No op reads anything back to the host and none loops over images in
Python: crops gather rows and columns by batched index arithmetic,
cutout is a mask, and the resized crop builds one resampling matrix per
image and axis and contracts them with two batched products (in full
f32: TF32 off, as the reference's ``precision=HIGHEST``).

Example::

    aug = augment_pipeline(
        random_resized_crop((224, 224), scale=(0.32, 1.0)), random_hflip(),
        random_brightness(32.0), random_saturation(0.3),
        normalize((123.68, 116.779, 103.939), (58.393, 57.12, 57.375)))
    images = aug(seed, images)             # float NHWC on the card

Compose ops with :func:`augment_pipeline`: op ``i``'s seed is
``fold_in(seed, i)``, so appending an op keeps the earlier ops' draws.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.ops.rng import fold_in, generator

Params = Dict[str, torch.Tensor]

# the reference's threshold on a resampling column's weight sum
# (``jax.image``'s ``compute_weight_mat``): below it the column is zero
_WEIGHT_EPS = 1000.0 * float(np.finfo(np.float32).eps)


class AugmentOp:
    """An augmentation over a float NHWC batch: :meth:`sample` draws its
    per-image parameters, :meth:`apply` applies them; ``op(seed,
    images)`` does both. An op without randomness samples ``{}``."""

    def __init__(self, name: str,
                 apply: Callable[[torch.Tensor, Params], torch.Tensor],
                 sample: Optional[Callable[[torch.Generator, torch.Tensor],
                                           Params]] = None):
        self.name = name
        self._apply = apply
        self._sample = sample

    def sample(self, seed: int, images: torch.Tensor) -> Params:
        if self._sample is None:
            return {}
        return self._sample(generator(seed, images.device), images)

    def apply(self, images: torch.Tensor, params: Params) -> torch.Tensor:
        return self._apply(images, params)

    def __call__(self, seed: int, images: torch.Tensor) -> torch.Tensor:
        return self.apply(images, self.sample(seed, images))

    def __repr__(self) -> str:
        return f"AugmentOp({self.name})"


class AugmentPipeline:
    """Ops applied left to right under one seed; op ``i`` gets
    ``fold_in(seed, i)``: appending ops never changes the earlier ones'
    draws, inserting or reordering does."""

    def __init__(self, ops: Sequence[AugmentOp]):
        self.ops = list(ops)

    def __call__(self, seed: int, images: torch.Tensor) -> torch.Tensor:
        for i, op in enumerate(self.ops):
            images = op(fold_in(seed, i), images)
        return images


def augment_pipeline(*ops: AugmentOp) -> AugmentPipeline:
    """Compose ops left to right under one seed (see
    :class:`AugmentPipeline`)."""
    return AugmentPipeline(ops)


# -- draws --------------------------------------------------------------------

def _uniform(g: torch.Generator, shape, lo: float, hi: float,
             device) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def _randint(g: torch.Generator, n: int, high: int, device) -> torch.Tensor:
    """``n`` ints uniform in ``[0, high)``."""
    return torch.randint(0, high, (n,), generator=g, device=device)


def _const(cache: dict, values, device) -> torch.Tensor:
    """``values`` as an f32 tensor on ``device``, copied once per device
    (a non-blocking copy: no stream sync, even the first time)."""
    key = str(device)
    t = cache.get(key)
    if t is None:
        t = cache[key] = torch.tensor(values, dtype=torch.float32).to(
            device, non_blocking=True)
    return t


# -- crops and flips ----------------------------------------------------------

def _check_fits(ch: int, cw: int, h: int, w: int) -> None:
    if h < ch or w < cw:
        raise ValueError(f"crop {ch}x{cw} larger than input {h}x{w}")


def random_crop(size: Tuple[int, int]) -> AugmentOp:
    """A random ``(h, w)`` window per image (the host
    ``ImageRandomCrop``); params ``y``, ``x``: each window's corner."""
    ch, cw = int(size[0]), int(size[1])

    def sample(g, images):
        n, h, w, _ = images.shape
        _check_fits(ch, cw, h, w)
        return {"y": _randint(g, n, h - ch + 1, images.device),
                "x": _randint(g, n, w - cw + 1, images.device)}

    def apply(images, p):
        n, h, w, _ = images.shape
        _check_fits(ch, cw, h, w)
        # each image's window gathered at its own corner by index
        # arithmetic: no per-image slicing
        dev = images.device
        rows = p["y"].long()[:, None] + torch.arange(ch, device=dev)
        cols = p["x"].long()[:, None] + torch.arange(cw, device=dev)
        b = torch.arange(n, device=dev)[:, None, None]
        return images[b, rows[:, :, None], cols[:, None, :]]

    return AugmentOp("random_crop", apply, sample)


def center_crop(size: Tuple[int, int]) -> AugmentOp:
    """The centre ``(h, w)`` window (the eval twin of
    :func:`random_crop`); no params."""
    ch, cw = int(size[0]), int(size[1])

    def apply(images, p):
        _, h, w, _ = images.shape
        _check_fits(ch, cw, h, w)
        y, x = (h - ch) // 2, (w - cw) // 2
        return images[:, y:y + ch, x:x + cw, :]

    return AugmentOp("center_crop", apply)


def random_hflip(p: float = 0.5) -> AugmentOp:
    """A horizontal flip with probability ``p`` per image (the host
    ``ImageHFlip``); params ``flip``: a bool per image."""
    p = float(p)

    def sample(g, images):
        n = images.shape[0]
        return {"flip": torch.rand(n, generator=g,
                                   device=images.device) < p}

    def apply(images, prm):
        flip = prm["flip"].to(torch.bool)[:, None, None, None]
        return torch.where(flip, images.flip(2), images)

    return AugmentOp("random_hflip", apply, sample)


# -- colour -------------------------------------------------------------------

def random_brightness(delta_low: float,
                      delta_high: Optional[float] = None) -> AugmentOp:
    """An additive delta per image in pixel units, uniform in
    ``[delta_low, delta_high]`` (one argument ``d``: ``[-|d|, |d|]``),
    clipped to [0, 255]: the host ``ImageBrightness``. Params
    ``delta`` (n, 1, 1, 1)."""
    lo, hi = ((-abs(delta_low), abs(delta_low))
              if delta_high is None else (delta_low, delta_high))

    def sample(g, images):
        return {"delta": _uniform(g, (images.shape[0], 1, 1, 1), lo, hi,
                                  images.device)}

    def apply(images, p):
        return torch.clamp(images + p["delta"], 0.0, 255.0)

    return AugmentOp("random_brightness", apply, sample)


def _factor_range(delta_low, delta_high, default=(0.5, 1.5)):
    """Uniform-factor bounds around the identity 1.0: no arguments give
    ``default`` (the host transformers' default); one argument ``d``
    gives ``[max(0, 1 - d), 1 + d]`` (negative factors would invert
    images); two give ``[delta_low, delta_high]``, which must not be
    empty."""
    if delta_low is None:
        return default
    if delta_high is None:
        return (max(0.0, 1.0 - delta_low), 1.0 + delta_low)
    if delta_high < delta_low:
        raise ValueError(f"empty factor range [{delta_low}, "
                         f"{delta_high}]")
    return (float(delta_low), float(delta_high))


def _factor_sample(lo: float, hi: float):
    def sample(g, images):
        return {"factor": _uniform(g, (images.shape[0], 1, 1, 1), lo, hi,
                                   images.device)}
    return sample


def random_contrast(delta_low: Optional[float] = None,
                    delta_high: Optional[float] = None) -> AugmentOp:
    """``x * f`` per image, clipped to [0, 255] (the host
    ``ImageContrast``), ``f`` uniform in :func:`_factor_range`'s bounds.
    Params ``factor`` (n, 1, 1, 1)."""
    lo, hi = _factor_range(delta_low, delta_high)

    def apply(images, p):
        return torch.clamp(images * p["factor"], 0.0, 255.0)

    return AugmentOp("random_contrast", apply, _factor_sample(lo, hi))


def random_saturation(delta_low: Optional[float] = None,
                      delta_high: Optional[float] = None) -> AugmentOp:
    """A blend with the ITU-R 601 luma grey image by a factor per image
    uniform in :func:`_factor_range`'s bounds, clipped to [0, 255]:
    close to the host ``ImageSaturation``'s HSV round trip and cheaper.
    Params ``factor`` (n, 1, 1, 1)."""
    lo, hi = _factor_range(delta_low, delta_high)

    def apply(images, p):
        gray = (0.299 * images[..., 0] + 0.587 * images[..., 1]
                + 0.114 * images[..., 2])[..., None]
        return torch.clamp((images - gray) * p["factor"] + gray, 0.0, 255.0)

    return AugmentOp("random_saturation", apply, _factor_sample(lo, hi))


def random_hue(delta_low: Optional[float] = None,
               delta_high: Optional[float] = None) -> AugmentOp:
    """A hue shift by an angle per image in degrees: no arguments
    ``[-18, 18]`` (the host ``ImageHue``'s default), one argument ``d``
    ``[-|d|, |d|]``, two as given. A chroma rotation in YIQ space, an
    approximation of the host's HSV round trip; positive degrees turn red
    towards green, as HSV's do. Params ``theta`` (n, 1, 1) in
    radians."""
    if delta_low is None:
        delta_low, delta_high = -18.0, 18.0
    elif delta_high is None:
        delta_low, delta_high = -abs(delta_low), abs(delta_low)
    elif delta_high < delta_low:
        raise ValueError(f"empty degree range [{delta_low}, "
                         f"{delta_high}]")
    lo, hi = float(delta_low), float(delta_high)

    def sample(g, images):
        deg = _uniform(g, (images.shape[0], 1, 1), lo, hi, images.device)
        return {"theta": deg * (math.pi / 180.0)}

    def apply(images, p):
        theta = p["theta"]
        r, g, b = images[..., 0], images[..., 1], images[..., 2]
        yy = 0.299 * r + 0.587 * g + 0.114 * b
        ii = 0.596 * r - 0.274 * g - 0.322 * b
        qq = 0.211 * r - 0.523 * g + 0.312 * b
        # rotate the chroma by -theta: HSV's hue and YIQ's chroma angle
        # turn in opposite directions
        c, s = torch.cos(theta), torch.sin(theta)
        i2 = c * ii + s * qq
        q2 = -s * ii + c * qq
        r2 = yy + 0.956 * i2 + 0.621 * q2
        g2 = yy - 0.272 * i2 - 0.647 * q2
        b2 = yy - 1.106 * i2 + 1.703 * q2
        return torch.clamp(torch.stack([r2, g2, b2], dim=-1), 0.0, 255.0)

    return AugmentOp("random_hue", apply, sample)


# -- the resized crop ---------------------------------------------------------

def _resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """Bilinear resampling matrices ``(n, out_size, in_size)``, one per
    image, for the map ``out = in * scale + translation`` (``scale``,
    ``translation``: (n,) f32): ``jax.image.scale_and_translate``'s
    weights with ``antialias=True``. The triangle kernel is widened by
    1/scale on a downscale; each output sample's weights are normalised,
    and zero where their sum is below 1000 f32 epsilons or where the
    sample's centre lies outside ``[-0.5, in_size - 0.5]``."""
    dev = scale.device
    inv = (1.0 / scale)[:, None]                                  # (n, 1)
    kernel_scale = torch.clamp(inv, min=1.0)
    sample_f = ((torch.arange(out_size, device=dev, dtype=torch.float32)
                 + 0.5) * inv - translation[:, None] * inv - 0.5)  # (n, out)
    x = (sample_f[:, :, None]
         - torch.arange(in_size, device=dev, dtype=torch.float32)
         ).abs() / kernel_scale[:, :, None]                   # (n, out, in)
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(-1, keepdim=True)
    weights = torch.where(total.abs() > _WEIGHT_EPS,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, :, None], weights, 0.0)


@contextlib.contextmanager
def _full_f32():
    """cuBLAS f32 products without TF32 (restored on exit)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def random_resized_crop(size: Tuple[int, int],
                        scale: Tuple[float, float] = (0.08, 1.0),
                        ratio: Tuple[float, float] = (0.75, 4 / 3)
                        ) -> AugmentOp:
    """Inception's crop: a window per image whose area is a fraction in
    ``scale`` of the image's and whose aspect ratio is log-uniform in
    ``ratio`` (clamped to at least one pixel and at most the image),
    placed uniformly, resampled bilinearly to ``size``: the standard
    ImageNet training crop. Params ``y0``, ``x0``, ``wh``, ``ww`` (n,):
    each window's corner and extent in pixels."""
    th, tw = int(size[0]), int(size[1])
    log_lo, log_hi = math.log(ratio[0]), math.log(ratio[1])

    def sample(g, images):
        n, h, w, _ = images.shape
        dev = images.device
        area = _uniform(g, (n,), scale[0], scale[1], dev) * (h * w)
        r = torch.exp(_uniform(g, (n,), log_lo, log_hi, dev))
        ww = torch.clamp(torch.sqrt(area * r), 1.0, float(w))
        wh = torch.clamp(torch.sqrt(area / r), 1.0, float(h))
        y0 = torch.rand(n, generator=g, device=dev) * (h - wh)
        x0 = torch.rand(n, generator=g, device=dev) * (w - ww)
        return {"y0": y0, "x0": x0, "wh": wh, "ww": ww}

    def apply(images, p):
        _, h, w, _ = images.shape
        # output pixel i samples the input at y0 + i * wh / th: the map
        # out = in * sy + ty with sy = th / wh and ty = -y0 * sy
        sy, sx = th / p["wh"], tw / p["ww"]
        wy = _resample_weights(h, th, sy, -p["y0"] * sy)       # (n, th, h)
        wx = _resample_weights(w, tw, sx, -p["x0"] * sx)       # (n, tw, w)
        with _full_f32():
            out = torch.einsum("niy,nyxc->nixc", wy, images)
            out = torch.einsum("njx,nixc->nijc", wx, out)
        return out.contiguous()

    return AugmentOp("random_resized_crop", apply, sample)


# -- normalisation and cutout -------------------------------------------------

def normalize(mean: Sequence[float],
              std: Sequence[float] = (1.0, 1.0, 1.0)) -> AugmentOp:
    """Per-channel ``(x - mean) / std`` (the host
    ``ImageChannelNormalize``); no params."""
    mean, std = [float(v) for v in mean], [float(v) for v in std]
    cache: dict = {}

    def apply(images, p):
        m = _const(cache, [mean, std], images.device)
        return (images - m[0]) / m[1]

    return AugmentOp("normalize", apply)


def cutout(size: int, fill: float = 0.0) -> AugmentOp:
    """A random ``size`` x ``size`` square per image set to ``fill`` (a
    regulariser with no Scala original). Params ``y``, ``x`` (n,): each
    square's corner."""
    s = int(size)
    fill = float(fill)

    def sample(g, images):
        n, h, w, _ = images.shape
        return {"y": _randint(g, n, max(h - s, 0) + 1, images.device),
                "x": _randint(g, n, max(w - s, 0) + 1, images.device)}

    def apply(images, p):
        _, h, w, _ = images.shape
        dev = images.device
        y0 = p["y"].long()[:, None, None]
        x0 = p["x"].long()[:, None, None]
        yy = torch.arange(h, device=dev)[None, :, None]
        xx = torch.arange(w, device=dev)[None, None, :]
        inside = (yy >= y0) & (yy < y0 + s) & (xx >= x0) & (xx < x0 + s)
        return images.masked_fill(inside[..., None], fill)

    return AugmentOp("cutout", apply, sample)
