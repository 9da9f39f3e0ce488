"""Region Proposal Network: head convs + fixed-shape proposal generation
(counterpart of `rlobjectdetection_tpu/models/rpn.py`).

The cls conv's 2A channels are [A bg, A fg] and the bbox conv's 4A channels
are A groups of (dx, dy, dw, dh). Maps are NHWC and are flattened in
(h, w, a) order, the order of `shifted_anchors`: an NCHW flatten here would
pair scores with the wrong anchors. Top-k ties break lower index first, as
`jax.lax.top_k` does, through a stable descending sort.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import pageable_to
from ..ops.anchors import shifted_anchors
from ..ops.boxes import bbox_transform_inv, clip_boxes
from ..ops.nms import nms_select
from .backbones.resnet import conv, nhwc_to_nchw


class RPNHead(nn.Module):
    """3×3 conv-512 + ReLU, then 1×1 2A-way cls and 4A-way bbox convs."""

    def __init__(self, num_anchors: int = 9, in_channels: int = 1024):
        super().__init__()
        self.num_anchors = num_anchors
        self.RPN_Conv = conv(in_channels, 512, 3, bias=True)
        self.RPN_cls_score = conv(512, 2 * num_anchors, 1, bias=True)
        self.RPN_bbox_pred = conv(512, 4 * num_anchors, 1, bias=True)

    def forward(self, base_feat: torch.Tensor):
        """base_feat `[B, H, W, C]` → (`[B, H, W, 2A]`, `[B, H, W, 4A]`)."""
        x = torch.relu(self.RPN_Conv(nhwc_to_nchw(base_feat)))
        cls_score = self.RPN_cls_score(x).permute(0, 2, 3, 1)
        bbox_pred = self.RPN_bbox_pred(x).permute(0, 2, 3, 1)
        return cls_score, bbox_pred


def rpn_fg_probs(cls_score: torch.Tensor, num_anchors: int) -> torch.Tensor:
    """Per-anchor foreground probability `[B, H, W, A]` (f32): the 2-way
    softmax of (bg_a, fg_a) is sigmoid(fg - bg)."""
    s = cls_score.float()
    return torch.sigmoid(s[..., num_anchors:] - s[..., :num_anchors])


def proposal_layer(fg_probs: torch.Tensor, bbox_deltas: torch.Tensor,
                   im_info: torch.Tensor, *, feat_stride: int, anchor_scales,
                   anchor_ratios, pre_nms_top_n: int, post_nms_top_n: int,
                   nms_thresh: float, nms_tile: int = 256):
    """Decode → clip → top-k → per-image NMS → top survivors.

    fg_probs `[B, H, W, A]`, bbox_deltas `[B, H, W, 4A]`, im_info `[B, 3]`.
    Returns (rois `[B, post_n, 5]` with the batch index in column 0 and zero
    padding, roi_scores `[B, post_n]`, roi_valid `[B, post_n]`)."""
    b, h, w, a = fg_probs.shape
    anchors = pageable_to(shifted_anchors(
        h, w, feat_stride, ratios=tuple(anchor_ratios),
        scales=tuple(anchor_scales)), fg_probs.device)             # [H*W*A, 4]
    scores = fg_probs.reshape(b, h * w * a)
    deltas = bbox_deltas.float().reshape(b, h * w * a, 4)
    proposals = bbox_transform_inv(anchors[None].expand(b, -1, -1), deltas)
    proposals = clip_boxes(proposals, im_info[:, :2])                # [B, N, 4]

    n = scores.shape[1]
    k = min(pre_nms_top_n, n) if pre_nms_top_n > 0 else n
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = torch.take_along_dim(proposals, top_idx[..., None], dim=1)

    sel_boxes, sel_scores, sel_valid = nms_select(
        top_boxes, top_scores, nms_thresh, post_nms_top_n, tile_size=nms_tile)
    batch_col = torch.arange(b, dtype=sel_boxes.dtype, device=sel_boxes.device)
    batch_col = batch_col[:, None, None].expand(b, post_nms_top_n, 1)
    rois = torch.cat([batch_col, sel_boxes], dim=2)
    return rois, sel_scores, sel_valid
