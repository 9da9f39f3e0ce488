"""Boxes under the Caffe "+1 width" convention, anchors and greedy NMS, in
float32 PyTorch (NMS's greedy walk in NumPy on the host)."""

from __future__ import annotations

import numpy as np
import torch


def anchors_base(scales, ratios, base_size: int = 16) -> np.ndarray:
    """`[A, 4]` base anchors: ratio-major, scale-minor, around a base_size²
    window (generate_anchors.py: _ratio_enum then _scale_enum)."""
    area = float(base_size) ** 2
    out = []
    ctr = (base_size - 1) / 2.0
    for r in ratios:
        w = np.round(np.sqrt(area / r))
        h = np.round(w * r)
        for s in scales:
            ws, hs = w * s, h * s
            out.append([ctr - (ws - 1) / 2, ctr - (hs - 1) / 2,
                        ctr + (ws - 1) / 2, ctr + (hs - 1) / 2])
    return np.asarray(out, dtype=np.float32)


def grid_anchors(h: int, w: int, stride: int, scales, ratios) -> np.ndarray:
    """`[H·W·A, 4]` anchors of a feature map in (h, w, a) order."""
    base = anchors_base(scales, ratios)
    ys, xs = np.meshgrid(np.arange(h) * stride, np.arange(w) * stride, indexing="ij")
    shifts = np.stack([xs.ravel(), ys.ravel(), xs.ravel(), ys.ravel()], 1).astype(np.float32)
    return (shifts[:, None, :] + base[None]).reshape(-1, 4)


def wh_ctr(b):
    w = b[..., 2] - b[..., 0] + 1.0
    h = b[..., 3] - b[..., 1] + 1.0
    return w, h, b[..., 0] + 0.5 * w, b[..., 1] + 0.5 * h


def encode(ex, gt):
    """Regression targets (dx, dy, dw, dh) of gt boxes against example boxes."""
    ew, eh, ex_, ey = wh_ctr(ex)
    gw, gh, gx, gy = wh_ctr(gt)
    return torch.stack([(gx - ex_) / ew, (gy - ey) / eh, torch.log(gw / ew),
                        torch.log(gh / eh)], -1)


def decode(boxes, deltas):
    """boxes `[..., N, 4]`, deltas `[..., N, 4K]` → `[..., N, 4K]`."""
    w, h, cx, cy = (t[..., None] for t in wh_ctr(boxes))
    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    px, py = d[..., 0] * w + cx, d[..., 1] * h + cy
    pw, ph = torch.exp(d[..., 2]) * w, torch.exp(d[..., 3]) * h
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph],
                       -1).reshape(deltas.shape)


def clip(boxes, h, w):
    """Clamp `[..., 4K]` boxes to [0, w-1] × [0, h-1] (h, w python floats or
    tensors broadcastable to the box dims)."""
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    x = torch.minimum(b[..., 0::2].clamp_min(0.0), torch.as_tensor(w - 1.0, device=b.device))
    y = torch.minimum(b[..., 1::2].clamp_min(0.0), torch.as_tensor(h - 1.0, device=b.device))
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1).reshape(boxes.shape)


def iou(a, b):
    """Pairwise IoU `[..., N, K]` of a `[..., N, 4]` and b `[..., K, 4]`."""
    iw = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0]) + 1.0).clamp_min(0.0)
    ih = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1]) + 1.0).clamp_min(0.0)
    aa = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    ab = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    inter = iw * ih
    return inter / (aa[..., :, None] + ab[..., None, :] - inter)


def overlaps_with_gt(boxes, gt):
    """IoU of boxes `[B, N, 4]` with gt `[B, G, 5]`; zero-padded gt rows
    (zero area under +1) overlap 0, a box of zero area overlaps -1."""
    ov = iou(boxes, gt[..., :4])
    gz = ((gt[..., 2] - gt[..., 0]) == 0) & ((gt[..., 3] - gt[..., 1]) == 0)
    bz = ((boxes[..., 2] - boxes[..., 0]) == 0) & ((boxes[..., 3] - boxes[..., 1]) == 0)
    ov = ov.masked_fill(gz[..., None, :], 0.0)
    return ov.masked_fill(bz[..., :, None], -1.0)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
               max_keep: int | None = None, valid: torch.Tensor | None = None) -> np.ndarray:
    """Greedy NMS (py_cpu_nms): indices of the kept boxes in descending score
    order (ties keep input order); a box is dropped when a kept box overlaps
    it with IoU > thresh. Stops at `max_keep` kept boxes."""
    order = torch.argsort(-scores, stable=True)
    if valid is not None:
        order = order[valid[order]]
    if order.numel() == 0:
        return np.zeros((0,), np.int64)
    over = (iou(boxes[order], boxes[order]) > thresh).cpu().numpy()
    order = order.cpu().numpy()
    dropped = np.zeros(len(order), bool)
    keep = []
    for i in range(len(order)):
        if dropped[i]:
            continue
        keep.append(order[i])
        if max_keep is not None and len(keep) == max_keep:
            break
        dropped |= over[i]
    return np.asarray(keep, np.int64)


def unsuppressed(cand, cand_score, taken, kept, kept_score, thresh: float, *, cut=None,
                 score_abs: float = 0.0, score_rel: float = 0.0, iou_eps: float = 0.0,
                 chunk: int = 2048) -> int:
    """Drops that greedy NMS cannot have made: candidates `[M, 4]` not
    `taken` whose score lies above `cut` (None: any score) by more than the
    band (`score_abs + score_rel·score`), and that no kept box `[K, 4]` of a
    score not below theirs (less the band) overlaps with IoU above `thresh −
    iou_eps` (float64). Greedy NMS drops a box only under a kept box ahead
    of it that overlaps it above the threshold, so a sound keep list leaves
    none; the bands leave out what rounding can decide."""
    cs, ks = cand_score.double(), kept_score.double()
    check = ~taken
    if cut is not None:
        check &= cs > cut + score_abs + score_rel * abs(cut)
    idx = torch.nonzero(check).flatten()
    kb = kept.double()
    bad = 0
    for s in range(0, len(idx), chunk):
        i = idx[s:s + chunk]
        ahead = ks[None, :] >= (cs[i] - score_abs - score_rel * cs[i].abs())[:, None]
        hit = ((iou(cand[i].double(), kb) > thresh - iou_eps) & ahead).any(1)
        bad += int((~hit).sum())
    return bad
