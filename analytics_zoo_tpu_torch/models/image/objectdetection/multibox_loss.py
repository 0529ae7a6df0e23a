"""MultiBoxLoss (port of
``analytics_zoo_tpu/models/image/objectdetection/multibox_loss.py``):
SSD's training loss, SmoothL1 localization on the matched priors plus a
softmax confidence loss with 3:1 hard-negative mining, normalized by the
number of matches.

The whole loss, the matching included, runs batched on the tensors'
device. The ground truth arrives padded to a fixed size (label -1 is
padding). Hard-negative mining keeps every negative whose loss is at
least the ``n_neg``-th largest, ties included, as the reference's sort
does: it is not a ``topk``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.image.objectdetection.bbox_util import (
    bipartite_and_per_prediction_match, encode_boxes, iou_matrix)


def match_priors(gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                 priors: torch.Tensor, iou_threshold: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Padded GT ``(..., max_gt, 4)`` and labels ``(..., max_gt)`` (-1
    pads) against priors ``(P, 4)`` -> ``(loc_targets (..., P, 4),
    cls_targets (..., P) int64 with 0 the background, matched (...,
    P))``."""
    valid = gt_labels >= 0
    iou = iou_matrix(gt_boxes, priors)                 # (..., max_gt, P)
    iou = torch.where(valid[..., :, None], iou, torch.zeros_like(iou))
    match_idx, matched = bipartite_and_per_prediction_match(
        iou, iou_threshold)
    safe_idx = match_idx.clamp_min(0)
    matched_boxes = gt_boxes.gather(
        -2, safe_idx[..., None].expand(*safe_idx.shape, 4))
    loc_targets = encode_boxes(matched_boxes, priors)
    # class targets: the GT label + 1 (0 is the background)
    labels = gt_labels.gather(-1, safe_idx).long()
    cls_targets = torch.where(matched, labels + 1, torch.zeros_like(labels))
    return loc_targets, cls_targets, matched


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


class MultiBoxLoss:
    """Callable loss: ``(priors, loc_pred, conf_pred, gt_boxes,
    gt_labels)`` -> scalar. Shapes: loc_pred (B, P, 4); conf_pred (B,
    P, C) logits, C counting the background class 0; the GT padded,
    (B, max_gt, 4) and (B, max_gt) with label -1 for padding."""

    def __init__(self, n_classes: int, iou_threshold: float = 0.5,
                 neg_pos_ratio: float = 3.0, loc_weight: float = 1.0):
        self.n_classes = int(n_classes)
        self.iou_threshold = float(iou_threshold)
        self.neg_pos_ratio = float(neg_pos_ratio)
        self.loc_weight = float(loc_weight)

    def __call__(self, priors: torch.Tensor, loc_pred: torch.Tensor,
                 conf_pred: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_labels: torch.Tensor) -> torch.Tensor:
        loc_t, cls_t, matched = match_priors(gt_boxes, gt_labels, priors,
                                             self.iou_threshold)
        num_pos = matched.sum(dim=1)                    # (B,)

        # localization: SmoothL1 over the matched priors
        loc_loss = (smooth_l1(loc_pred - loc_t) *
                    matched[..., None]).sum(dim=(1, 2))

        # confidence: softmax cross-entropy, negatives mined 3:1 by loss
        logp = torch.log_softmax(conf_pred.float(), dim=-1)
        ce = -logp.gather(-1, cls_t[..., None])[..., 0]  # (B, P)
        neg_ce = torch.where(matched, torch.full_like(ce, float("-inf")),
                             ce)
        n_neg = torch.clamp_max(
            (num_pos.float() * self.neg_pos_ratio).to(torch.int64),
            ce.shape[1] - 1)
        sorted_neg = neg_ce.sort(dim=1, descending=True).values
        kth = sorted_neg.gather(1, (n_neg - 1).clamp_min(0)[:, None])
        keep_neg = ((neg_ce >= kth) & (n_neg[:, None] > 0) &
                    torch.isfinite(neg_ce))
        conf_loss = (ce * (matched | keep_neg)).sum(dim=1)

        norm = num_pos.float().clamp_min(1.0)
        total = (self.loc_weight * loc_loss + conf_loss) / norm
        return total.mean()

    def as_keras_loss(self, priors):
        """The Estimator's ``(y_true, y_pred)`` form: ``y_pred`` is
        ``concat[loc (P * 4), conf (P * C)]`` per image, ``y_true``
        ``concat[gt_boxes (max_gt * 4), gt_labels (max_gt)]``. The
        priors go to ``y_pred``'s device once."""
        priors = np.asarray(priors, np.float32)
        p = priors.shape[0]
        c = self.n_classes
        placed = {}

        def loss_fn(y_true, y_pred):
            dev = y_pred.device
            if dev not in placed:
                placed[dev] = torch.from_numpy(priors).to(dev)
            b = y_pred.shape[0]
            loc = y_pred[:, :p * 4].reshape(b, p, 4)
            conf = y_pred[:, p * 4:].reshape(b, p, c)
            max_gt = y_true.shape[1] // 5
            gt_boxes = y_true[:, :max_gt * 4].reshape(b, max_gt, 4)
            gt_labels = y_true[:, max_gt * 4:].reshape(b, max_gt).to(
                torch.int32)
            return self(placed[dev], loc, conf, gt_boxes, gt_labels)

        return loss_fn
