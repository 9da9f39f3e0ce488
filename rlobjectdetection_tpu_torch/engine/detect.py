"""Test-time detection post-processing (counterpart of
`rlobjectdetection_tpu/engine/detect.py`).

Unnormalise the per-class deltas, decode, clip to the image, rescale to the
original image, then per-class NMS and the global top `max_per_image`. The
JAX package's vmap over classes 1..C-1 is a batch dimension here; invalid
lanes carry the -1.0 sentinel, and a detection's class is its lane's
`index // max_per_image + 1`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.boxes import bbox_transform_inv, clip_boxes
from ..ops.nms import nms_select


def postprocess_detections(rois, cls_prob, bbox_pred, im_info, roi_valid, *,
                           num_classes: int, class_agnostic: bool = False,
                           max_per_image: int = 100, nms_thresh: float = 0.3,
                           score_thresh: float = 0.0, bbox_reg: bool = True,
                           normalize_stds=(0.1, 0.1, 0.2, 0.2),
                           normalize_means=(0.0, 0.0, 0.0, 0.0)):
    """One image: rois `[R, 5]`, cls_prob `[R, C]`, bbox_pred `[R, 4C]` (or
    `[R, 4]`), im_info `[3]` (h, w, scale), roi_valid `[R]`.

    Returns (boxes `[max_per_image, 4]` in original image coordinates,
    scores `[max_per_image]`, classes `[max_per_image]` int32, valid)."""
    if score_thresh < 0.0:
        raise ValueError(f"score_thresh must be >= 0 (the -1.0 invalid-lane "
                         f"sentinel relies on it), got {score_thresh}")
    r = rois.shape[0]
    boxes = rois[:, 1:5]
    k = bbox_pred.shape[-1] // 4
    if bbox_reg:
        f32 = dict(dtype=torch.float32, device=bbox_pred.device)
        stds = torch.tensor(normalize_stds, **f32).repeat(k)
        means = torch.tensor(normalize_means, **f32).repeat(k)
        deltas = bbox_pred * stds + means
        pred = bbox_transform_inv(boxes[None], deltas[None])[0]        # [R, 4K]
        pred = clip_boxes(pred[None], im_info[None, :2])[0]
    else:
        pred = boxes.repeat(1, k)
    pred = pred / im_info[2]

    if class_agnostic:
        per_class = pred[:, None, :4].expand(r, num_classes, 4)
    else:
        per_class = pred.reshape(r, num_classes, 4)
    # background (class 0) is skipped; classes 1..C-1 are the batch dim
    scores = cls_prob[:, 1:].t()                                       # [C-1, R]
    cls_boxes = per_class[:, 1:].permute(1, 0, 2)                      # [C-1, R, 4]
    valid = roi_valid[None, :] & (scores > score_thresh)
    sb, ss, sv = nms_select(cls_boxes, scores, nms_thresh, max_per_image, valid=valid)

    flat_scores = torch.where(sv, ss, torch.full_like(ss, -1.0)).reshape(-1)
    top_scores, top_idx = torch.sort(flat_scores, descending=True, stable=True)
    top_scores, top_idx = top_scores[:max_per_image], top_idx[:max_per_image]
    out_valid = top_scores > score_thresh
    cls_of = top_idx // max_per_image + 1
    out_boxes = sb.reshape(-1, 4)[top_idx]
    return out_boxes, top_scores, cls_of.to(torch.int32), out_valid


def detections_to_all_boxes(det_batches, num_classes: int):
    """Per-image (boxes, scores, classes, valid) → the reference's
    all_boxes[cls][img] = `[N, 5]` numpy structure."""
    num_images = len(det_batches)
    all_boxes = [[np.empty((0, 5), dtype=np.float32) for _ in range(num_images)]
                 for _ in range(num_classes)]
    for i, (boxes, scores, classes, valid) in enumerate(det_batches):
        boxes, scores = np.asarray(boxes), np.asarray(scores)
        classes, valid = np.asarray(classes), np.asarray(valid)
        for j in range(1, num_classes):
            sel = valid & (classes == j)
            all_boxes[j][i] = np.concatenate(
                [boxes[sel], scores[sel, None]], axis=1).astype(np.float32)
    return all_boxes
