"""Detection evaluation: mean average precision (port of
``analytics_zoo_tpu/models/image/objectdetection/evaluation.py``, a
copy: numpy on the host). VOC-style AP: the 11-point interpolation or
the continuous area.
"""

from __future__ import annotations


import numpy as np

from analytics_zoo_tpu_torch.models.image.objectdetection.detection import (
    Detection, iou_matrix)


class MeanAveragePrecision:
    def __init__(self, n_classes: int, iou_threshold: float = 0.5,
                 use_07_metric: bool = False):
        self.n_classes = int(n_classes)
        self.iou_threshold = float(iou_threshold)
        self.use_07_metric = use_07_metric

    def _ap(self, recall: np.ndarray, precision: np.ndarray) -> float:
        if self.use_07_metric:  # VOC2007 11-point
            ap = 0.0
            for t in np.linspace(0, 1, 11):
                p = precision[recall >= t].max() if \
                    (recall >= t).any() else 0.0
                ap += p / 11.0
            return float(ap)
        # continuous area under monotone precision envelope
        mrec = np.concatenate([[0.0], recall, [1.0]])
        mpre = np.concatenate([[0.0], precision, [0.0]])
        mpre = np.maximum.accumulate(mpre[::-1])[::-1]
        idx = np.flatnonzero(mrec[1:] != mrec[:-1])
        return float(np.sum((mrec[idx + 1] - mrec[idx]) *
                            mpre[idx + 1]))

    def evaluate(self,
                 detections: "list[list[Detection]]",
                 gt_boxes: "list[np.ndarray]",
                 gt_labels: "list[np.ndarray]"
                 ) -> "tuple[float, dict[int, float]]":
        """→ (mAP, per-class AP). gt label ids use the detection class
        ids (background excluded)."""
        aps: "dict[int, float]" = {}
        for c in range(1, self.n_classes):
            records: "list[tuple[float, bool]]" = []
            n_gt = 0
            for dets, boxes, labels in zip(detections, gt_boxes,
                                           gt_labels):
                cls_gt = np.asarray(boxes)[np.asarray(labels) == c] \
                    if len(boxes) else np.zeros((0, 4))
                n_gt += len(cls_gt)
                cls_dets = [d for d in dets if d.class_id == c]
                cls_dets.sort(key=lambda d: -d.score)
                taken = np.zeros(len(cls_gt), bool)
                for d in cls_dets:
                    if len(cls_gt) == 0:
                        records.append((d.score, False))
                        continue
                    ious = np.asarray(iou_matrix(
                        d.box[None], cls_gt))[0]
                    j = int(np.argmax(ious))
                    if ious[j] >= self.iou_threshold and not taken[j]:
                        taken[j] = True
                        records.append((d.score, True))
                    else:
                        records.append((d.score, False))
            if n_gt == 0:
                continue
            if not records:
                aps[c] = 0.0
                continue
            records.sort(key=lambda r: -r[0])
            tp = np.cumsum([r[1] for r in records])
            fp = np.cumsum([not r[1] for r in records])
            recall = tp / n_gt
            precision = tp / np.maximum(tp + fp, 1e-12)
            aps[c] = self._ap(recall, precision)
        mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
        return mean_ap, aps
