"""SSD prior (anchor) boxes (port of
``analytics_zoo_tpu/models/image/objectdetection/prior_box.py``, a copy:
numpy on the host). Caffe's PriorBox: per feature-map cell, boxes of
min_size, sqrt(min_size * max_size) and the aspect ratios, flipped
where asked. SSD300's six maps give 8732 priors."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class PriorBoxSpec:
    feature_size: int             # feature map is feature_size²
    min_size: float               # in input-image pixels
    max_size: float
    aspect_ratios: "tuple" = (2.0,)
    flip: bool = True
    clip: bool = False
    step: float = 0.0             # pixels per cell; 0 → image/feature


def _cell_priors(spec: PriorBoxSpec, img_size: float) -> np.ndarray:
    """Prior (w, h) list for one cell, normalized."""
    sizes = []
    s_min = spec.min_size / img_size
    sizes.append((s_min, s_min))
    s_prime = math.sqrt(spec.min_size * spec.max_size) / img_size
    sizes.append((s_prime, s_prime))
    for ar in spec.aspect_ratios:
        w = s_min * math.sqrt(ar)
        h = s_min / math.sqrt(ar)
        sizes.append((w, h))
        if spec.flip:
            sizes.append((h, w))
    return np.asarray(sizes, np.float32)


def generate_ssd_priors(specs: Sequence[PriorBoxSpec],
                        img_size: float = 300.0) -> np.ndarray:
    """→ (num_priors, 4) corner-format normalized priors."""
    all_boxes = []
    for spec in specs:
        f = spec.feature_size
        step = (spec.step / img_size) if spec.step else (1.0 / f)
        whs = _cell_priors(spec, img_size)       # (K, 2)
        ys, xs = np.meshgrid(np.arange(f), np.arange(f), indexing="ij")
        centers = np.stack([(xs + 0.5) * step, (ys + 0.5) * step],
                           axis=-1).reshape(-1, 1, 2)   # (F², 1, 2)
        wh = whs.reshape(1, -1, 2)                       # (1, K, 2)
        boxes = np.concatenate(
            [centers - wh / 2, centers + wh / 2],
            axis=-1).reshape(-1, 4)                      # (F²·K, 4)
        if spec.clip:
            boxes = np.clip(boxes, 0.0, 1.0)
        all_boxes.append(boxes.astype(np.float32))
    return np.concatenate(all_boxes, axis=0)


def num_priors_per_cell(spec: PriorBoxSpec) -> int:
    return 2 + len(spec.aspect_ratios) * (2 if spec.flip else 1)


# canonical SSD300 config (VGG variant, reference SSDVGG)
SSD300_SPECS = [
    PriorBoxSpec(38, 30.0, 60.0, (2.0,)),
    PriorBoxSpec(19, 60.0, 111.0, (2.0, 3.0)),
    PriorBoxSpec(10, 111.0, 162.0, (2.0, 3.0)),
    PriorBoxSpec(5, 162.0, 213.0, (2.0, 3.0)),
    PriorBoxSpec(3, 213.0, 264.0, (2.0,)),
    PriorBoxSpec(1, 264.0, 315.0, (2.0,)),
]
