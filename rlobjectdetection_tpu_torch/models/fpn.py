"""Faster R-CNN with a Feature Pyramid Network: Detectron2's
`faster_rcnn_R_101_FPN_3x` on the port (Lin et al., "Feature Pyramid Networks
for Object Detection", arXiv:1612.03144).

ResNet trunk (`ResNetBase(..., layer4=True).pyramid`: C2..C5 at strides 4,
8, 16, 32, layer4 on the whole map) → neck (1×1 laterals to 256 channels,
nearest 2× top-down sums, 3×3 outputs P2..P5, P6 = P5 max-pooled with
kernel 1 stride 2) → one RPN head shared over P2..P6 (3×3 conv-256 + ReLU,
1×1 objectness of A = 3 logits and 1×1 deltas of 4A) over anchors of one
size a level (32..512 pixels at strides 4..64, ratios 0.5, 1, 2) → the
proposal layer (the top PRE_NMS_TOP_N logits of each level, decoded with dw
and dh clamped at log(1000/16), clipped, empty boxes dropped, NMS within
each level as lanes `[B·5, ≤ PRE_NMS_TOP_N]` of `ops/nms.py::nms_select`,
then the image's POST_NMS_TOP_N best of all levels: Detectron2's
`batched_nms` with level ids keeps the same set) → (train: 512 rois an
image sampled from the proposals and the gt boxes, a quarter fg at IoU ≥
0.5, without replacement) → multi-level RoIAlignV2 (`rlod::roi_align_levels`)
→ box head (fc 12544 → 1024 → 1024, ReLU each) → class logits and per-class
deltas.

Train losses (Detectron2's): RPN, sigmoid cross-entropy over the 256
sampled anchors an image and L1 of the positives' deltas, each summed and
divided by 256·B; R-CNN, cross-entropy over the sampled rois and L1 of the
foreground's deltas, summed over the sampled count. Anchor targets count
every anchor (BOUNDARY_THRESH −1): IoU < 0.3 negative, ≥ 0.7 positive, and
each gt box's best anchors positive (low-quality matches); 128 positives
at most, negatives up to 256 in all, without replacement. Box arithmetic
is the port's ("+1" widths, `ops/boxes.py`), anchors are centred on their
cell as the C4 model's are, and the R-CNN targets are normalised by
TRAIN.BBOX_NORMALIZE_STDS (0.1, 0.1, 0.2, 0.2), which are Detectron2's
weights (10, 10, 5, 5).

Parameter names: `base.*` (the trunk, layer4 included), `fpn.lateral{2..5}`,
`fpn.output{2..5}`, `rpn.conv`, `rpn.objectness`, `rpn.deltas`,
`box_head.fc6`, `box_head.fc7`, `RCNN_cls_score`, `RCNN_bbox_pred`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..device import compute_dtype, pageable_to, resolve_device
from ..ops.anchors import pyramid_anchors
from ..ops.boxes import bbox_overlaps_masked, bbox_transform, bbox_transform_inv, clip_boxes
from ..ops.nms import nms_select
from ..ops.roi_align_levels import roi_align_levels, roi_levels
from ..utils import tracing
from .backbones.resnet import Dense, ResNetBase, conv, nchw_to_nhwc
from .faster_rcnn import FasterRCNN, init_weights
from .targets import BIG_NEG, _random_keep, _top_indices, uniform_source

CHANNELS = 256
STRIDES = (4, 8, 16, 32, 64)              # P2..P6
ANCHOR_SIZES = (32, 64, 128, 256, 512)
POOLED_LEVELS = 4                          # P2..P5 feed the box head
SCALE_CLAMP = math.log(1000.0 / 16)        # Detectron2's Box2BoxTransform clamp
HEAD_DIM = 1024
TEST_SCORE_THRESH = 0.05


class FPN(nn.Module):
    """The neck: C2..C5 (NCHW, channels 256..2048) → P2..P6 (NCHW, 256)."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels: int = CHANNELS):
        super().__init__()
        for lvl, cin in zip(range(2, 6), in_channels):
            setattr(self, f"lateral{lvl}", conv(cin, out_channels, 1, bias=True))
            setattr(self, f"output{lvl}", conv(out_channels, out_channels, 3, bias=True))

    def forward(self, feats: list) -> list:
        inner = self.lateral5(feats[3])
        outs = [self.output5(inner)]
        for lvl in (4, 3, 2):
            lateral = getattr(self, f"lateral{lvl}")(feats[lvl - 2])
            inner = lateral + F.interpolate(inner, scale_factor=2.0, mode="nearest")
            outs.insert(0, getattr(self, f"output{lvl}")(inner))
        outs.append(F.max_pool2d(outs[-1], kernel_size=1, stride=2))
        return outs


class FPNRPNHead(nn.Module):
    """One head for every level: 3×3 conv + ReLU, 1×1 objectness (A
    logits) and 1×1 deltas (A groups of dx, dy, dw, dh)."""

    def __init__(self, channels: int = CHANNELS, num_anchors: int = 3):
        super().__init__()
        self.conv = conv(channels, channels, 3, bias=True)
        self.objectness = conv(channels, num_anchors, 1, bias=True)
        self.deltas = conv(channels, 4 * num_anchors, 1, bias=True)

    def forward(self, feats: list):
        """P2..P6 (NCHW) → (logits `[B, N]`, deltas `[B, N, 4]`), both f32, the
        levels one after the other, each in (h, w, a) order; and each level's
        (H, W)."""
        logits, deltas, hw = [], [], []
        for x in feats:
            t = torch.relu(self.conv(x))
            b, _, h, w = t.shape
            logits.append(self.objectness(t).permute(0, 2, 3, 1).reshape(b, -1))
            deltas.append(self.deltas(t).permute(0, 2, 3, 1).reshape(b, -1, 4))
            hw.append((h, w))
        return torch.cat(logits, 1).float(), torch.cat(deltas, 1).float(), hw


class BoxHead(nn.Module):
    """Two fc layers with ReLU over the pooled `[R, 7, 7, C]` (flattened in
    (c, y, x) order, as Detectron2 flattens NCHW)."""

    def __init__(self, in_dim: int = CHANNELS * 49, dim: int = HEAD_DIM):
        super().__init__()
        self.fc6 = Dense(in_dim, dim)
        self.fc7 = Dense(dim, dim)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.permute(0, 3, 1, 2).reshape(pooled.shape[0], -1)
        return torch.relu(self.fc7(torch.relu(self.fc6(x))))


def fpn_proposals(logits: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor,
                  sizes: list, im_info: torch.Tensor, *, pre_nms_top_n: int,
                  post_nms_top_n: int, nms_thresh: float, nms_tile: int = 256):
    """The proposal layer over the levels. logits `[B, N]` and deltas
    `[B, N, 4]` (levels concatenated, `sizes[k]` anchors of level k),
    anchors `[N, 4]`, im_info `[B, 3]`. Each level's top `pre_nms_top_n`
    logits (stable: ties to the lower index) are decoded, clipped and kept
    where non-empty (x2 > x1, y2 > y1) and finite; NMS runs within each
    (image, level) lane; the image keeps its `post_nms_top_n` best
    survivors of all levels. Returns (rois `[B, post_n, 5]` with the batch
    index in column 0 and zero rows past the kept count, roi_scores (the
    logits), roi_valid)."""
    b = logits.shape[0]
    k = max(min(pre_nms_top_n, n) for n in sizes)
    lanes_boxes, lanes_scores, lanes_valid = [], [], []
    at = 0
    for n in sizes:
        kn = min(pre_nms_top_n, n)
        s, idx = torch.sort(logits[:, at:at + n], dim=1, descending=True, stable=True)
        s, idx = s[:, :kn], idx[:, :kn] + at
        d = torch.take_along_dim(deltas, idx[..., None], dim=1)
        d = torch.cat([d[..., :2], d[..., 2:].clamp_max(SCALE_CLAMP)], -1)
        boxes = clip_boxes(bbox_transform_inv(anchors[idx], d), im_info[:, :2])
        valid = ((boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
                 & torch.isfinite(s) & torch.isfinite(boxes).all(-1))
        pad = k - kn
        lanes_boxes.append(F.pad(boxes, (0, 0, 0, pad)))
        lanes_scores.append(F.pad(s, (0, pad)))
        lanes_valid.append(F.pad(valid, (0, pad)))
        at += n
    levels = len(sizes)
    boxes = torch.stack(lanes_boxes, 1)                                # [B, L, K, 4]
    scores = torch.stack(lanes_scores, 1)
    valid = torch.stack(lanes_valid, 1)
    tracing.count("fpn.nms_lanes", b * levels)
    sel_b, sel_s, sel_v = nms_select(boxes.reshape(b * levels, k, 4),
                                     scores.reshape(b * levels, k), nms_thresh,
                                     post_nms_top_n, valid=valid.reshape(b * levels, k),
                                     tile_size=nms_tile)
    key = torch.where(sel_v, sel_s, torch.full_like(sel_s, -math.inf)).reshape(b, -1)
    top_s, top_i = torch.sort(key, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :post_nms_top_n], top_i[:, :post_nms_top_n]
    roi_valid = torch.take_along_dim(sel_v.reshape(b, -1), top_i, dim=1)
    sel = torch.take_along_dim(sel_b.reshape(b, -1, 4), top_i[..., None], dim=1)
    sel = torch.where(roi_valid[..., None], sel, torch.zeros_like(sel))
    batch_col = torch.arange(b, dtype=sel.dtype, device=sel.device)[:, None, None]
    rois = torch.cat([batch_col.expand(b, sel.shape[1], 1), sel], dim=2)
    return rois, torch.where(roi_valid, top_s, torch.zeros_like(top_s)), roi_valid


class RPNTargets(NamedTuple):
    labels: torch.Tensor        # [B, N] f32 in {-1, 0, 1}
    targets: torch.Tensor       # [B, N, 4]


@torch.no_grad()
def fpn_anchor_target(uniform, anchors: torch.Tensor, gt_boxes: torch.Tensor, *,
                      batch_size: int = 256, fg_fraction: float = 0.5,
                      positive_overlap: float = 0.7,
                      negative_overlap: float = 0.3) -> RPNTargets:
    """Labels and regression targets of every anchor `[N, 4]` (no boundary
    filter) against gt_boxes `[B, G, 5]` (zero rows pad). Draws the fg and
    then the bg priorities `[B, N]`."""
    b, n = gt_boxes.shape[0], anchors.shape[0]
    anchors_b = anchors[None].expand(b, n, 4)
    overlaps = bbox_overlaps_masked(anchors_b, gt_boxes)                 # [B, N, G]
    max_ov, arg = overlaps.max(dim=2)
    gt_max = overlaps.max(dim=1).values                                  # [B, G]
    gt_max = torch.where(gt_max == 0, torch.full_like(gt_max, 1e-5), gt_max)
    best_for_gt = (overlaps == gt_max[:, None, :]).any(dim=2)
    labels = torch.full((b, n), -1.0, device=anchors.device)
    labels = torch.where(max_ov < negative_overlap, torch.zeros_like(labels), labels)
    labels = torch.where((max_ov >= positive_overlap) | best_for_gt, torch.ones_like(labels),
                         labels)
    num_fg = int(fg_fraction * batch_size)
    u_fg, u_bg = uniform((b, n)), uniform((b, n))
    fg, bg = labels == 1, labels == 0
    keep_fg = _random_keep(u_fg, fg, num_fg, num_fg)
    keep_bg = _random_keep(u_bg, bg, batch_size - keep_fg.sum(dim=1), batch_size)
    labels = torch.where((fg & ~keep_fg) | (bg & ~keep_bg), torch.full_like(labels, -1.0),
                         labels)
    matched = torch.take_along_dim(gt_boxes[..., :4], arg[..., None], dim=1)
    return RPNTargets(labels, bbox_transform(anchors_b, matched))


class RoiTargets(NamedTuple):
    rois: torch.Tensor          # [B, R, 5]
    labels: torch.Tensor        # [B, R] int64 (0: background)
    valid: torch.Tensor         # [B, R] bool: a sampled roi (else padding)
    targets: torch.Tensor       # [B, R, 4], normalised; 0 off the foreground


@torch.no_grad()
def fpn_proposal_target(uniform, rois: torch.Tensor, roi_valid: torch.Tensor,
                        gt_boxes: torch.Tensor, *, rois_per_image: int = 512,
                        fg_fraction: float = 0.25, fg_thresh: float = 0.5,
                        bbox_normalize_stds=(0.1, 0.1, 0.2, 0.2)) -> RoiTargets:
    """Samples up to `rois_per_image` rois an image from the valid proposals
    `[B, P, 5]` and the gt boxes `[B, G, 5]` (appended as candidates): at
    most fg_fraction of them foreground (IoU ≥ fg_thresh), the rest
    background, each without replacement; foreground slots first, then
    background, then padding (invalid). Draws the fg and then the bg
    priorities `[B, P+G]`."""
    b, p, _ = rois.shape
    g = gt_boxes.shape[1]
    dev = rois.device
    r = rois_per_image
    gt_rois = torch.cat([torch.zeros((b, g, 1), device=dev), gt_boxes[..., :4]], dim=2)
    cand = torch.cat([rois, gt_rois], dim=1)                              # [B, N, 5]
    cand_valid = torch.cat([roi_valid, gt_boxes[..., 4] > 0], dim=1)
    n = p + g
    max_ov, arg = bbox_overlaps_masked(cand[..., 1:5], gt_boxes).max(dim=2)
    fg = cand_valid & (max_ov >= fg_thresh)
    bg = cand_valid & (max_ov < fg_thresh)
    n_fg = fg.sum(1).clamp_max(int(fg_fraction * r))
    n_bg = bg.sum(1).clamp_max(r - n_fg)
    k = min(r, n)
    u_fg, u_bg = uniform((b, n)), uniform((b, n))
    fg_order = _top_indices(torch.where(fg, u_fg, torch.full_like(u_fg, BIG_NEG)), k)[1]
    bg_order = _top_indices(torch.where(bg, u_bg, torch.full_like(u_bg, BIG_NEG)), k)[1]
    slot = torch.arange(r, device=dev)[None].expand(b, r)
    is_fg = slot < n_fg[:, None]
    valid = slot < (n_fg + n_bg)[:, None]
    at_fg = torch.take_along_dim(fg_order, slot.clamp_max(k - 1), dim=1)
    at_bg = torch.take_along_dim(bg_order, (slot - n_fg[:, None]).clamp(0, k - 1), dim=1)
    keep = torch.where(is_fg, at_fg, torch.where(valid, at_bg, torch.zeros_like(at_bg)))
    out = torch.take_along_dim(cand, keep[..., None], dim=1)
    out[..., 0] = torch.arange(b, dtype=out.dtype, device=dev)[:, None]
    gt_of = torch.take_along_dim(arg, keep, dim=1)
    labels = torch.where(is_fg, torch.take_along_dim(gt_boxes[..., 4], gt_of, dim=1),
                         torch.zeros_like(out[..., 0])).long()
    matched = torch.take_along_dim(gt_boxes[..., :4], gt_of[..., None], dim=1)
    stds = torch.tensor(bbox_normalize_stds, dtype=torch.float32, device=dev)
    targets = bbox_transform(out[..., 1:5], matched) / stds
    targets = torch.where(is_fg[..., None], targets, torch.zeros_like(targets))
    return RoiTargets(out, labels, valid, targets)


class FPNFasterRCNN(nn.Module):
    """`FPNFasterRCNN(num_classes, "resnet101_fpn", cfg)`: the same eval and
    train interface as `FasterRCNN` (eval: {rois, roi_valid, cls_prob,
    bbox_pred}; train: also the four losses and rois_label, -1 on padding
    slots). cfg gives the compute dtype, the stem and layer1 kernels,
    RESNET.FIXED_BLOCKS, ANCHOR_RATIOS, NMS_TILE and, in TRAIN and TEST,
    RPN_PRE_NMS_TOP_N (a level), RPN_POST_NMS_TOP_N (an image),
    RPN_NMS_THRESH, and for training RPN_BATCHSIZE, RPN_FG_FRACTION,
    RPN_POSITIVE_OVERLAP, RPN_NEGATIVE_OVERLAP, BATCH_SIZE (rois an image),
    FG_FRACTION, FG_THRESH and BBOX_NORMALIZE_STDS."""

    test_score_thresh = TEST_SCORE_THRESH

    def __init__(self, num_classes: int, backbone: str = "resnet101_fpn",
                 cfg: Config = Config(), class_agnostic: bool = False, *,
                 device: str | torch.device = "cuda", seed: int = 3):
        super().__init__()
        if not (backbone.startswith("resnet") and backbone.endswith("_fpn")):
            raise ValueError(f"FPNFasterRCNN takes a resnet*_fpn backbone, got {backbone!r}")
        self.num_classes = num_classes
        self.class_agnostic = class_agnostic
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.DTYPE)
        self.num_anchors = len(cfg.ANCHOR_RATIOS)
        self.base = ResNetBase(int(backbone[len("resnet"):-len("_fpn")]), self.dtype,
                               conv1_fused=cfg.CONV1_FUSED, layer1_fused=cfg.LAYER1_FUSED,
                               stages_fused=cfg.STAGE_FUSED,
                               frozen_stages=cfg.RESNET.FIXED_BLOCKS, layer4=True)
        self.fpn = FPN()
        self.rpn = FPNRPNHead(CHANNELS, self.num_anchors)
        self.box_head = BoxHead()
        self.RCNN_cls_score = Dense(HEAD_DIM, num_classes)
        self.RCNN_bbox_pred = Dense(HEAD_DIM, 4 if class_agnostic else 4 * num_classes)
        init_weights(self, seed)
        self.to(resolve_device(device))
        self._anchor_cache = {}

    def anchors(self, level_hw, device) -> torch.Tensor:
        """The pyramid's anchors `[N, 4]` for these level sizes, on `device`
        (kept a canvas)."""
        key = (tuple(level_hw), str(device))
        if key not in self._anchor_cache:
            self._anchor_cache[key] = pageable_to(pyramid_anchors(
                level_hw, STRIDES, ANCHOR_SIZES, tuple(self.cfg.ANCHOR_RATIOS)), device)
        return self._anchor_cache[key]

    def features(self, im_data: torch.Tensor, fwd_only: bool = False) -> list:
        """P2..P6, NCHW views of channels-last memory in the compute dtype."""
        with tracing.span("model.trunk"):
            c = self.base.pyramid(im_data, fwd_only=fwd_only)
        with tracing.span("model.fpn"):
            return self.fpn(c)

    def _propose(self, logits, deltas, level_hw, im_info, phase):
        """The proposal layer on detached RPN outputs."""
        with tracing.span("model.proposals"):
            return fpn_proposals(
                logits.detach(), deltas.detach(), self.anchors(level_hw, logits.device),
                [h * w * self.num_anchors for h, w in level_hw], im_info,
                pre_nms_top_n=phase.RPN_PRE_NMS_TOP_N, post_nms_top_n=phase.RPN_POST_NMS_TOP_N,
                nms_thresh=phase.RPN_NMS_THRESH, nms_tile=self.cfg.NMS_TILE)

    def _scores(self, feats: list, rois: torch.Tensor):
        """Pooled features of rois `[B, R, 5]` + box head + classifiers:
        (cls_score `[B·R, C]`, bbox_pred `[B·R, 4C]`), f32."""
        with tracing.span("model.head"):
            flat = rois.reshape(-1, 5)
            if tracing.enabled():
                per = torch.bincount(roi_levels(flat), minlength=POOLED_LEVELS).tolist()
                for lvl, n in zip(range(2, 6), per):
                    tracing.count(f"fpn.rois_p{lvl}", n)
            pooled = roi_align_levels([nchw_to_nhwc(f) for f in feats[:POOLED_LEVELS]], flat)
            x = self.box_head(pooled.to(self.dtype))
            return self.RCNN_cls_score(x).float(), self.RCNN_bbox_pred(x).float()

    def forward(self, im_data: torch.Tensor, im_info: torch.Tensor, gt_boxes=None,
                num_boxes=None, *, train: bool = False, generator=None, dropout=None,
                global_batch=None):
        """As `FasterRCNN.forward`. A data-parallel rank passes its rows and
        the group's `GlobalBatch`: it draws the global batch's uniforms and
        keeps its rows, and divides the R-CNN losses by its share of the
        global count of sampled rois (the RPN's divisor, 256 an image, needs
        no exchange)."""
        if not train:
            with torch.no_grad():
                feats = self.features(im_data, fwd_only=True)
                with tracing.span("model.rpn"):
                    logits, deltas, hw = self.rpn(feats)
                rois, _, roi_valid = self._propose(logits, deltas, hw, im_info, self.cfg.TEST)
                b, r = rois.shape[:2]
                cls_score, bbox_pred = self._scores(feats, rois)
            return dict(rois=rois, roi_valid=roi_valid,
                        cls_prob=torch.softmax(cls_score, -1).reshape(b, r, -1),
                        bbox_pred=bbox_pred.reshape(b, r, -1))
        if gt_boxes is None or generator is None:
            raise ValueError("the train forward needs gt_boxes and a generator")
        uniform = uniform_source(generator, im_data.device)
        if global_batch is not None:
            uniform = global_batch.uniform(uniform)
        return self._train_forward(im_data, im_info, gt_boxes, uniform, global_batch)

    def _train_forward(self, im_data, im_info, gt_boxes, uniform, global_batch=None):
        t = self.cfg.TRAIN
        b = im_data.shape[0]
        feats = self.features(im_data)
        with tracing.span("model.rpn"):
            logits, deltas, hw = self.rpn(feats)
        rois, _, roi_valid = self._propose(logits, deltas, hw, im_info, t)
        with tracing.span("model.anchor_target"):
            at = fpn_anchor_target(uniform, self.anchors(hw, logits.device), gt_boxes,
                                   batch_size=t.RPN_BATCHSIZE, fg_fraction=t.RPN_FG_FRACTION,
                                   positive_overlap=t.RPN_POSITIVE_OVERLAP,
                                   negative_overlap=t.RPN_NEGATIVE_OVERLAP)
        with tracing.span("model.loss"):
            norm = float(t.RPN_BATCHSIZE * b)
            sampled, pos = (at.labels >= 0).float(), (at.labels == 1).float()
            bce = F.binary_cross_entropy_with_logits(logits, at.labels.clamp_min(0),
                                                     reduction="none")
            rpn_loss_cls = (bce * sampled).sum() / norm
            rpn_loss_box = ((deltas - at.targets).abs().sum(-1) * pos).sum() / norm
        with tracing.span("model.proposal_target"):
            pt = fpn_proposal_target(uniform, rois, roi_valid, gt_boxes,
                                     rois_per_image=t.BATCH_SIZE, fg_fraction=t.FG_FRACTION,
                                     fg_thresh=t.FG_THRESH,
                                     bbox_normalize_stds=t.BBOX_NORMALIZE_STDS)
        r = pt.rois.shape[1]
        cls_score, bbox_pred = self._scores(feats, pt.rois)
        with tracing.span("model.loss"):
            labels, valid = pt.labels.reshape(-1), pt.valid.reshape(-1).float()
            count = (valid.sum().clamp_min(1.0) if global_batch is None
                     else global_batch.count_share(valid.sum()))
            ce = F.cross_entropy(cls_score, labels, reduction="none")
            rcnn_loss_cls = (ce * valid).sum() / count
            if not self.class_agnostic:
                bbox_pred = torch.take_along_dim(
                    bbox_pred.reshape(-1, self.num_classes, 4), labels[:, None, None], dim=1)[:, 0]
            fg = (labels > 0).float() * valid
            rcnn_loss_bbox = ((bbox_pred - pt.targets.reshape(-1, 4)).abs().sum(-1)
                              * fg).sum() / count
        return dict(
            rois=pt.rois, roi_valid=pt.valid,
            cls_prob=torch.softmax(cls_score, dim=-1).reshape(b, r, -1),
            bbox_pred=bbox_pred.reshape(b, r, -1), rpn_loss_cls=rpn_loss_cls,
            rpn_loss_box=rpn_loss_box, rcnn_loss_cls=rcnn_loss_cls,
            rcnn_loss_bbox=rcnn_loss_bbox,
            rois_label=torch.where(pt.valid, pt.labels, torch.full_like(pt.labels, -1)))


def build_detector(num_classes: int, backbone: str, cfg: Config = Config(), **kw):
    """The detector for `backbone`: `FPNFasterRCNN` for a `resnet*_fpn` one,
    else `FasterRCNN`."""
    cls = FPNFasterRCNN if backbone.endswith("_fpn") else FasterRCNN
    return cls(num_classes, backbone, cfg, **kw)
