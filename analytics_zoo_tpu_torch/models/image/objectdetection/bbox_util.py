"""Bounding-box geometry: IoU, the SSD codec, NMS and clipping (port of
``analytics_zoo_tpu/models/image/objectdetection/bbox_util.py``).

Every function is vectorized over tensors on their own device, so the
detection head and the loss's matching run on the card. Leading batch
axes broadcast (``iou_matrix`` of ``(B, G, 4)`` against ``(P, 4)`` is
``(B, G, P)``), where the reference maps a single image with ``vmap``.

Box format: (x_min, y_min, x_max, y_max), normalized to [0, 1].
"""

from __future__ import annotations

from typing import Tuple

import torch

# SSD/Caffe variance defaults
DEFAULT_VARIANCES = (0.1, 0.1, 0.2, 0.2)


def _area(boxes: torch.Tensor) -> torch.Tensor:
    return ((boxes[..., 2] - boxes[..., 0]).clamp_min(0.0) *
            (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0))


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) pairwise IoU."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    inter_min = torch.maximum(a[..., :2], b[..., :2])
    inter_max = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (inter_max - inter_min).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(boxes_a)[..., :, None] + _area(boxes_b)[..., None, :] - \
        inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12),
                       torch.zeros_like(inter))


def _to_center(boxes):
    wh = boxes[..., 2:] - boxes[..., :2]
    c = (boxes[..., :2] + boxes[..., 2:]) * 0.5
    return c, wh


def _variances(variances, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(variances, dtype=like.dtype, device=like.device)


def encode_boxes(gt_boxes: torch.Tensor, priors: torch.Tensor,
                 variances=DEFAULT_VARIANCES) -> torch.Tensor:
    """Ground-truth corner boxes -> SSD regression targets against
    ``priors``."""
    v = _variances(variances, gt_boxes)
    g_c, g_wh = _to_center(gt_boxes)
    p_c, p_wh = _to_center(priors)
    p_wh = p_wh.clamp_min(1e-8)
    g_wh = g_wh.clamp_min(1e-8)
    d_xy = (g_c - p_c) / (p_wh * v[:2])
    d_wh = torch.log(g_wh / p_wh) / v[2:]
    return torch.cat([d_xy, d_wh], dim=-1)


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor,
                 variances=DEFAULT_VARIANCES) -> torch.Tensor:
    """Regression outputs -> corner boxes."""
    v = _variances(variances, loc)
    p_c, p_wh = _to_center(priors)
    c = loc[..., :2] * v[:2] * p_wh + p_c
    wh = torch.exp(loc[..., 2:] * v[2:]) * p_wh
    return torch.cat([c - wh * 0.5, c + wh * 0.5], dim=-1)


def clip_boxes(boxes: torch.Tensor) -> torch.Tensor:
    return boxes.clamp(0.0, 1.0)


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        iou_threshold: float = 0.45, max_output: int = 100,
        score_threshold: float = 0.0
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-maximum suppression with a fixed-size output: ``max_output``
    argmax steps over the boxes not yet taken or suppressed, each a few
    launches on the boxes' device with no read back to the host.

    Returns ``(indices (max_output,), valid (max_output,))``; invalid
    slots hold index 0. ``argmax`` takes the first of equal scores, as
    ``jnp.argmax`` does."""
    n = boxes.shape[0]
    max_output = min(int(max_output), n)
    iou = iou_matrix(boxes, boxes)
    neg_inf = torch.full_like(scores, float("-inf"))
    order_scores = torch.where(scores > score_threshold, scores, neg_inf)
    positions = torch.arange(n, device=boxes.device)
    remaining = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    idxs, valids = [], []
    for _ in range(max_output):
        masked = torch.where(remaining, order_scores, neg_inf)
        idx = masked.argmax(0, keepdim=True)
        valids.append(masked.gather(0, idx) > float("-inf"))
        suppress = iou.index_select(0, idx)[0] > iou_threshold
        remaining = remaining & ~suppress & (positions != idx)
        idxs.append(idx)
    if not idxs:
        empty = torch.zeros((0,), dtype=torch.int64, device=boxes.device)
        return empty, empty.bool()
    return torch.cat(idxs), torch.cat(valids)


def bipartite_and_per_prediction_match(
        iou: torch.Tensor, threshold: float = 0.5
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD's prior-to-GT matching:

    1. per prediction: each prior takes its best GT where that IoU
       exceeds ``threshold``;
    2. bipartite: each GT's best prior is set to that GT, or, for a GT
       that overlaps no prior (a padding row), to the prior's match
       from step 1.

    iou: (..., num_gt, num_priors). Returns ``(match_idx (...,
    num_priors) int64, GT index or -1; matched mask)``.

    Where several GTs share a best prior, the highest GT index's write
    wins, as the reference's scatter gives on the CPU (XLA leaves the
    order unspecified; a repeated index in ``scatter_`` is
    nondeterministic on CUDA). Each write that a later GT repeats goes
    to a spare column, which is dropped, so the writes that are kept
    share no index."""
    num_gt, num_priors = iou.shape[-2], iou.shape[-1]
    best_gt = iou.argmax(dim=-2)                      # per prior
    best_gt_iou = iou.amax(dim=-2)
    minus_one = torch.full_like(best_gt, -1)
    match_idx = torch.where(best_gt_iou > threshold, best_gt, minus_one)

    best_prior = iou.argmax(dim=-1)                   # (..., num_gt)
    gt_has_box = iou.amax(dim=-1) > 0.0
    gt_ids = torch.arange(num_gt, device=iou.device).expand_as(best_prior)
    value = torch.where(gt_has_box, gt_ids,
                        match_idx.gather(-1, best_prior))
    same = best_prior[..., :, None] == best_prior[..., None, :]
    later = torch.ones((num_gt, num_gt), dtype=torch.bool,
                       device=iou.device).triu(1)
    overridden = (same & later).any(dim=-1)
    target = torch.where(overridden,
                         torch.full_like(best_prior, num_priors), best_prior)
    spare = torch.cat([match_idx, minus_one[..., :1]], dim=-1)
    match_idx = spare.scatter(-1, target, value)[..., :num_priors]
    return match_idx, match_idx >= 0
