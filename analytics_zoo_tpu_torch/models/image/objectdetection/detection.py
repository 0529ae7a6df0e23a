"""Detection post-processing and visualization (port of
``analytics_zoo_tpu/models/image/objectdetection/detection.py``, a copy:
numpy on the host, as in the reference). ``DetectionOutput`` decodes,
runs a per-class NMS and keeps the top k; ``Visualizer`` draws labelled
boxes (it imports PIL when it draws, and nothing else here does).

The geometry is :mod:`bbox_util`'s on CPU tensors, as the reference's
is its jnp functions on host arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.image.objectdetection import bbox_util


def _host(fn, *arrays) -> np.ndarray:
    """``fn`` of :mod:`bbox_util` on host arrays, as a host array."""
    return fn(*(torch.from_numpy(np.ascontiguousarray(a))
                for a in arrays)).numpy()


def iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    return _host(bbox_util.iou_matrix, np.asarray(boxes_a, np.float32),
                 np.asarray(boxes_b, np.float32))


def decode_boxes(loc: np.ndarray, priors: np.ndarray) -> np.ndarray:
    return _host(bbox_util.decode_boxes, np.asarray(loc, np.float32),
                 np.asarray(priors, np.float32))


def clip_boxes(boxes: np.ndarray) -> np.ndarray:
    return np.clip(boxes, 0.0, 1.0)


@dataclass
class Detection:
    class_id: int
    score: float
    box: np.ndarray  # (4,) normalized corners


def _nms_numpy(boxes: np.ndarray, scores: np.ndarray,
               iou_threshold: float) -> "list[int]":
    order = np.argsort(-scores)
    keep: "list[int]" = []
    iou = np.asarray(iou_matrix(boxes, boxes))
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        suppressed |= iou[i] > iou_threshold
        suppressed[i] = True
    return keep


class DetectionOutput:
    """(loc (B, P, 4), conf (B, P, C) logits-or-probs, priors) →
    per-image Detection lists."""

    def __init__(self, n_classes: int, conf_threshold: float = 0.01,
                 nms_threshold: float = 0.45, top_k: int = 200,
                 conf_is_logits: bool = True):
        self.n_classes = int(n_classes)
        self.conf_threshold = float(conf_threshold)
        self.nms_threshold = float(nms_threshold)
        self.top_k = int(top_k)
        self.conf_is_logits = conf_is_logits

    def __call__(self, loc: np.ndarray, conf: np.ndarray,
                 priors: np.ndarray) -> "list[list[Detection]]":
        loc = np.asarray(loc)
        conf = np.asarray(conf, np.float64)
        if self.conf_is_logits:
            conf = conf - conf.max(-1, keepdims=True)
            e = np.exp(conf)
            conf = e / e.sum(-1, keepdims=True)
        out = []
        for b in range(loc.shape[0]):
            boxes = np.asarray(clip_boxes(
                decode_boxes(loc[b], priors)))
            dets: "list[Detection]" = []
            for c in range(1, self.n_classes):  # skip background 0
                scores = conf[b, :, c]
                mask = scores > self.conf_threshold
                if not mask.any():
                    continue
                cb, cs = boxes[mask], scores[mask]
                for i in _nms_numpy(cb, cs, self.nms_threshold):
                    dets.append(Detection(c, float(cs[i]), cb[i]))
            dets.sort(key=lambda d: -d.score)
            out.append(dets[:self.top_k])
        return out

    def from_flat(self, flat: np.ndarray, priors: np.ndarray
                  ) -> "list[list[Detection]]":
        """Accepts the SSD model's flattened output."""
        p = priors.shape[0]
        b = flat.shape[0]
        loc = flat[:, :p * 4].reshape(b, p, 4)
        conf = flat[:, p * 4:].reshape(b, p, self.n_classes)
        return self(loc, conf, priors)


class Visualizer:
    """Draw detections on an image (reference `Visualizer.scala:29`)."""

    def __init__(self, class_names: Sequence[str],
                 score_threshold: float = 0.3):
        self.class_names = list(class_names)
        self.score_threshold = float(score_threshold)

    def draw(self, image: np.ndarray,
             detections: "list[Detection]") -> np.ndarray:
        from PIL import Image, ImageDraw
        img = Image.fromarray(np.asarray(image, np.uint8))
        draw = ImageDraw.Draw(img)
        w, h = img.size
        for det in detections:
            if det.score < self.score_threshold:
                continue
            x1, y1, x2, y2 = det.box
            box = (x1 * w, y1 * h, x2 * w, y2 * h)
            draw.rectangle(box, outline=(255, 0, 0), width=2)
            label = (self.class_names[det.class_id]
                     if det.class_id < len(self.class_names)
                     else str(det.class_id))
            draw.text((box[0] + 2, box[1] + 2),
                      f"{label} {det.score:.2f}", fill=(255, 0, 0))
        return np.asarray(img)
