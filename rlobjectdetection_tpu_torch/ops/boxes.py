"""Box geometry with the Caffe "+1 width" convention.

Counterpart of `rlobjectdetection_tpu/ops/boxes.py` (box_wh_ctr,
bbox_transform_inv, clip_boxes, bbox_overlaps): batched, fixed-shape tensor
functions on `[..., 4]` boxes in (x1, y1, x2, y2).
"""

from __future__ import annotations

import torch


def box_wh_ctr(boxes: torch.Tensor):
    """widths, heights, center x, center y of `[..., 4]` boxes."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    return w, h, cx, cy


def bbox_transform_inv(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Decode deltas on top of boxes: boxes `[..., N, 4]`, deltas
    `[..., N, 4K]` with per-class groups of 4 → `[..., N, 4K]`."""
    w, h, cx, cy = box_wh_ctr(boxes)
    k = deltas.shape[-1] // 4
    d = deltas.reshape(deltas.shape[:-1] + (k, 4))
    pred_cx = d[..., 0] * w[..., None] + cx[..., None]
    pred_cy = d[..., 1] * h[..., None] + cy[..., None]
    pred_w = torch.exp(d[..., 2]) * w[..., None]
    pred_h = torch.exp(d[..., 3]) * h[..., None]
    out = torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                       pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h], dim=-1)
    return out.reshape(deltas.shape)


def clip_boxes(boxes: torch.Tensor, im_hw: torch.Tensor) -> torch.Tensor:
    """Clamp `[B, N, 4K]` boxes to [0, W-1] × [0, H-1]; im_hw `[B, 2]`
    (height, width) per image."""
    hmax = im_hw[..., 0] - 1.0
    wmax = im_hw[..., 1] - 1.0
    # broadcast the per-image bounds over the (boxes, class-group) dims
    for _ in range(boxes.ndim - hmax.ndim):
        hmax = hmax[..., None]
        wmax = wmax[..., None]
    b = boxes.reshape(boxes.shape[:-1] + (boxes.shape[-1] // 4, 4))
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(b[..., 0], zero), wmax)
    y1 = torch.minimum(torch.maximum(b[..., 1], zero), hmax)
    x2 = torch.minimum(torch.maximum(b[..., 2], zero), wmax)
    y2 = torch.minimum(torch.maximum(b[..., 3], zero), hmax)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(boxes.shape)


def _inter_union(boxes: torch.Tensor, query_boxes: torch.Tensor):
    """Pairwise intersection and union areas, `[..., N, K]` each."""
    b = boxes[..., :, None, :]
    q = query_boxes[..., None, :, :]
    iw = (torch.minimum(b[..., 2], q[..., 2])
          - torch.maximum(b[..., 0], q[..., 0]) + 1.0).clamp_min(0.0)
    ih = (torch.minimum(b[..., 3], q[..., 3])
          - torch.maximum(b[..., 1], q[..., 1]) + 1.0).clamp_min(0.0)
    area_b = (boxes[..., 2] - boxes[..., 0] + 1.0) * (boxes[..., 3] - boxes[..., 1] + 1.0)
    area_q = (query_boxes[..., 2] - query_boxes[..., 0] + 1.0) * (
        query_boxes[..., 3] - query_boxes[..., 1] + 1.0)
    inter = iw * ih
    union = area_b[..., :, None] + area_q[..., None, :] - inter
    return inter, union


def bbox_overlaps(boxes: torch.Tensor, query_boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: boxes `[..., N, 4]`, query_boxes `[..., K, 4]` → `[..., N, K]`."""
    inter, union = _inter_union(boxes, query_boxes)
    return inter / union
