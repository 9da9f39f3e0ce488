"""Faster R-CNN detector, eval and train forward (counterpart of
`rlobjectdetection_tpu/models/faster_rcnn.py`).

backbone → RPN → proposal layer → (train: proposal-target sampling) →
RoI features (POOLING_MODE: `align`, RoIAlignAvg on its CUDA kernels;
`pool`, quantized max pool; `crop`, bilinear crop and a 2×2 max) → head
(ResNet layer4, or VGG-16 fc6/fc7 with dropout in train) → class
probabilities + per-class box regression (train: the group of each roi's
label) → (train: the RPN and R-CNN cross-entropy and smooth-L1 losses).
Parameters are f32; compute runs in cfg.DTYPE. Module and parameter names follow the JAX param
tree (`base/layer1/block0/conv1/kernel` is `base.layer1.block0.conv1.weight`,
`head/fc6/kernel` is `head.fc6.weight`), which is what
`engine/checkpoint.py` maps.

The frozen backbone prefix (ResNet: conv1 and RESNET.FIXED_BLOCKS stages;
VGG-16: conv blocks 1-2) takes no gradient; every other parameter requires
grad, and the eval forward runs under `torch.no_grad()`. Every backbone
serves and trains in every POOLING_MODE.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import Config
from ..device import compute_dtype, resolve_device
from ..ops.roi_align_kernel import roi_align_avg
from ..ops.roi_crop import roi_crop
from ..ops.roi_pool import roi_pool
from .backbones.resnet import (Conv2d, Dense, ResNetBase, ResNetHead, conv, nchw_to_nhwc,
                               nhwc_to_nchw)
from .backbones.vgg import VGGBase, VGGHead
from .losses import smooth_l1_loss, softmax_cross_entropy
from .rpn import RPNHead, proposal_layer, rpn_fg_probs
from .targets import anchor_target, proposal_target, uniform_source


class TinyBase(nn.Module):
    """A test backbone: x / 128, then four 3×3 stride-2 convs of 64 channels,
    each with a ReLU (`base/stem{i}`): `[B, H, W, 3]` → `[B, H/16, W/16, 64]`
    in the compute dtype."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        for i in range(4):
            setattr(self, f"stem{i}", conv(3 if i == 0 else 64, 64, 3, stride=2, bias=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw((x * (1.0 / 128.0)).to(self.dtype))
        for i in range(4):
            x = torch.relu(getattr(self, f"stem{i}")(x))
        return nchw_to_nhwc(x)


class TinyHead(nn.Module):
    """The test backbone's head: the mean over the pooled cells, then a
    Dense layer of 256 (`head/fc`) and a ReLU."""

    def __init__(self, in_ch: int = 64, out_ch: int = 256):
        super().__init__()
        self.fc = Dense(in_ch, out_ch)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.fc(pooled.mean(dim=(1, 2))))


class FasterRCNN(nn.Module):
    """`FasterRCNN(num_classes, "resnet101" | "vgg16" | "tiny", cfg)`;
    weights are made from `seed` (the JAX model's initialisers, numbers from
    a torch.Generator). `tiny` is the JAX package's test backbone."""

    def __init__(self, num_classes: int, backbone: str = "resnet101",
                 cfg: Config = Config(), class_agnostic: bool = False, *,
                 device: str | torch.device = "cuda", seed: int = 3):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.class_agnostic = class_agnostic
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.DTYPE)
        self.num_anchors = len(cfg.ANCHOR_SCALES) * len(cfg.ANCHOR_RATIOS)
        if backbone == "vgg16":
            self.base = VGGBase(self.dtype, conv1_fused=cfg.CONV1_FUSED)
            self.head = VGGHead(cfg.POOLING_SIZE)
            base_ch, head_ch = 512, 4096
        elif backbone.startswith("resnet"):
            layers = int(backbone[len("resnet"):])
            self.base = ResNetBase(layers, self.dtype, conv1_fused=cfg.CONV1_FUSED,
                                   layer1_fused=cfg.LAYER1_FUSED,
                                   stages_fused=cfg.STAGE_FUSED,
                                   frozen_stages=cfg.RESNET.FIXED_BLOCKS)
            self.head = ResNetHead(layers)
            base_ch, head_ch = 1024, 2048
        elif backbone == "tiny":
            self.base, self.head = TinyBase(self.dtype), TinyHead()
            base_ch, head_ch = 64, 256
        else:
            raise ValueError(f"unknown backbone {backbone!r}")
        self.rpn = RPNHead(self.num_anchors, base_ch)
        self.RCNN_cls_score = Dense(head_ch, num_classes)
        self.RCNN_bbox_pred = Dense(head_ch, 4 if class_agnostic else 4 * num_classes)
        init_weights(self, seed)
        self.to(dev)

    def proposals(self, base_feat: torch.Tensor, im_info: torch.Tensor, phase=None):
        """RPN + proposal layer at `phase`'s top-N and NMS threshold
        (cfg.TRAIN or cfg.TEST, the default): (rois `[B, R, 5]`, roi_scores,
        roi_valid)."""
        rpn_cls, rpn_delta = self.rpn(base_feat)
        return self._propose(rpn_cls, rpn_delta, im_info, phase or self.cfg.TEST)

    def _propose(self, rpn_cls, rpn_delta, im_info, phase):
        """The proposal layer on detached RPN outputs."""
        c = self.cfg
        return proposal_layer(
            rpn_fg_probs(rpn_cls, self.num_anchors).detach(), rpn_delta.detach(), im_info,
            feat_stride=c.FEAT_STRIDE[0], anchor_scales=c.ANCHOR_SCALES,
            anchor_ratios=c.ANCHOR_RATIOS, pre_nms_top_n=phase.RPN_PRE_NMS_TOP_N,
            post_nms_top_n=phase.RPN_POST_NMS_TOP_N, nms_thresh=phase.RPN_NMS_THRESH,
            nms_tile=c.NMS_TILE)

    def extract_roi_features(self, base_feat: torch.Tensor,
                             rois_flat: torch.Tensor) -> torch.Tensor:
        """The POOLING_MODE dispatch for rois `[N, 5]`: `[N, P, P, C]` in the
        compute dtype."""
        c = self.cfg
        base_feat, rois_flat = base_feat.contiguous(), rois_flat.contiguous()
        if c.POOLING_MODE == "align":
            pooled = roi_align_avg(base_feat, rois_flat, c.POOLING_SIZE, 1.0 / 16.0)
        elif c.POOLING_MODE == "pool":
            pooled = roi_pool(base_feat, rois_flat, c.POOLING_SIZE, c.POOLING_SIZE, 1.0 / 16.0)
        elif c.POOLING_MODE == "crop":
            grid = c.POOLING_SIZE * 2 if c.CROP_RESIZE_WITH_MAX_POOL else c.POOLING_SIZE
            pooled = roi_crop(base_feat, rois_flat, grid, 1.0 / 16.0,
                              max_pool=c.CROP_RESIZE_WITH_MAX_POOL)
        else:
            raise ValueError(f"unknown POOLING_MODE {c.POOLING_MODE!r}")
        return pooled.to(self.dtype)

    def _scores(self, base_feat: torch.Tensor, rois: torch.Tensor, dropout=None):
        """RoI features + head + classifiers for rois `[B, R, 5]`: (cls_score
        `[B·R, C]` f32, bbox_pred `[B·R, 4C]` f32). `dropout` (a uniform
        source) puts the VGG head in train; the ResNet head has none."""
        pooled = self.extract_roi_features(base_feat, rois.reshape(-1, 5))
        if isinstance(self.head, VGGHead):
            feat = self.head(pooled, train=dropout is not None, dropout=dropout)
        else:
            feat = self.head(pooled)                       # [B*R, 2048 | 4096]
        return self.RCNN_cls_score(feat).float(), self.RCNN_bbox_pred(feat).float()

    def detect_head(self, base_feat: torch.Tensor, rois: torch.Tensor):
        """RoI features + head + classifiers for rois `[B, R, 5]`: (cls_prob
        `[B, R, C]` f32 softmax, bbox_pred `[B, R, 4C]` f32)."""
        b, r = rois.shape[:2]
        cls_score, bbox_pred = self._scores(base_feat, rois)
        cls_prob = torch.softmax(cls_score, dim=-1)
        return cls_prob.reshape(b, r, -1), bbox_pred.reshape(b, r, -1)

    def forward(self, im_data: torch.Tensor, im_info: torch.Tensor, gt_boxes=None,
                num_boxes=None, *, train: bool = False, generator=None, dropout=None):
        """im_data `[B, H, W, 3]` (BGR, pixel means subtracted); im_info
        `[B, 3]` (h, w, scale). Eval (no gradient) returns {rois, roi_valid,
        cls_prob, bbox_pred}. Train takes gt_boxes `[B, G, 5]` (x1, y1, x2,
        y2, cls; zero rows pad) and `generator` (a torch.Generator on the
        model's device, or a `targets.Uniform` source) for the sampling, and
        returns also the four losses and rois_label `[B, R]`, with rois the
        sampled ones and bbox_pred each roi's label group. The VGG head's
        dropout draws from `dropout` (a Generator or a source), by default
        from `generator` itself, after the sampling draws; the ResNet head
        draws none. num_boxes is unused (the zero rows mark the padding), as
        in the JAX model."""
        if not train:
            # eval takes no gradient, so the frozen-stage kernels
            # (STAGE_FUSED) engage whatever FIXED_BLOCKS says, as in the JAX
            # model
            with torch.no_grad():
                base_feat = (self.base(im_data, fwd_only=True)
                             if isinstance(self.base, ResNetBase) else self.base(im_data))
                rois, _, roi_valid = self.proposals(base_feat, im_info)
                cls_prob, bbox_pred = self.detect_head(base_feat, rois)
            return dict(rois=rois, roi_valid=roi_valid, cls_prob=cls_prob, bbox_pred=bbox_pred)
        if self.cfg.TRAIN.RPN_POSITIVE_WEIGHT >= 0:
            # only the uniform branch exists: the reference's non-uniform one
            # is broken upstream, so a setting that asks for it is refused
            raise ValueError("TRAIN.RPN_POSITIVE_WEIGHT >= 0 (non-uniform anchor weighting) is "
                             "not implemented")
        if gt_boxes is None or generator is None:
            raise ValueError("the train forward needs gt_boxes and a generator")
        sampling = uniform_source(generator, im_data.device)
        drop = sampling if dropout is None else uniform_source(dropout, im_data.device)
        return self._train_forward(im_data, im_info, gt_boxes, sampling, drop)

    def _train_forward(self, im_data, im_info, gt_boxes, uniform, dropout):
        c, t = self.cfg, self.cfg.TRAIN
        b, a = im_data.shape[0], self.num_anchors
        base_feat = self.base(im_data)
        rpn_cls, rpn_delta = self.rpn(base_feat)
        rois, _, _ = self._propose(rpn_cls, rpn_delta, im_info, t)

        at = anchor_target(
            uniform, tuple(base_feat.shape[1:3]), gt_boxes, im_info,
            feat_stride=c.FEAT_STRIDE[0], anchor_scales=c.ANCHOR_SCALES,
            anchor_ratios=c.ANCHOR_RATIOS, rpn_batch_size=t.RPN_BATCHSIZE,
            fg_fraction=t.RPN_FG_FRACTION, positive_overlap=t.RPN_POSITIVE_OVERLAP,
            negative_overlap=t.RPN_NEGATIVE_OVERLAP, clobber_positives=t.RPN_CLOBBER_POSITIVES)
        # the RPN's 2-way logits per anchor, in the targets' (h, w, a) order
        logits2 = torch.stack([rpn_cls[..., :a].reshape(b, -1),
                               rpn_cls[..., a:].reshape(b, -1)], dim=-1)
        rpn_loss_cls = softmax_cross_entropy(logits2, at.labels.clamp_min(0), at.labels >= 0)
        rpn_loss_box = smooth_l1_loss(rpn_delta.float().reshape(b, -1, 4), at.bbox_targets,
                                      at.bbox_inside_weights, at.bbox_outside_weights,
                                      sigma=3.0, reduce_dims=(1, 2))

        pt = proposal_target(
            uniform, rois, gt_boxes, rois_per_image=t.BATCH_SIZE, fg_fraction=t.FG_FRACTION,
            fg_thresh=t.FG_THRESH, bg_thresh_hi=t.BG_THRESH_HI, bg_thresh_lo=t.BG_THRESH_LO,
            bbox_normalize_means=t.BBOX_NORMALIZE_MEANS,
            bbox_normalize_stds=t.BBOX_NORMALIZE_STDS,
            bbox_inside_weights=t.BBOX_INSIDE_WEIGHTS,
            normalize_targets=t.BBOX_NORMALIZE_TARGETS_PRECOMPUTED)
        r = pt.rois.shape[1]
        cls_score, bbox_pred = self._scores(base_feat, pt.rois, dropout)
        labels = pt.labels.reshape(-1)
        if not self.class_agnostic:
            # each roi's regression group, picked by its label (one-hot, as
            # the JAX model does)
            sel = torch.nn.functional.one_hot(labels.long(), self.num_classes).float()
            bbox_pred = torch.einsum("ncd,nc->nd",
                                     bbox_pred.reshape(-1, self.num_classes, 4), sel)
        rcnn_loss_cls = softmax_cross_entropy(cls_score, labels)
        rcnn_loss_bbox = smooth_l1_loss(bbox_pred, pt.bbox_targets.reshape(-1, 4),
                                        pt.bbox_inside_weights.reshape(-1, 4),
                                        pt.bbox_outside_weights.reshape(-1, 4),
                                        sigma=1.0, reduce_dims=(-1,))
        return dict(
            rois=pt.rois, roi_valid=torch.ones((b, r), dtype=torch.bool, device=pt.rois.device),
            cls_prob=torch.softmax(cls_score, dim=-1).reshape(b, r, -1),
            bbox_pred=bbox_pred.reshape(b, r, -1), rpn_loss_cls=rpn_loss_cls,
            rpn_loss_box=rpn_loss_box, rcnn_loss_cls=rcnn_loss_cls,
            rcnn_loss_bbox=rcnn_loss_bbox, rois_label=pt.labels)


def lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """lecun_normal as the JAX model draws it: truncated normal (±2σ) of
    variance 1/fan_in."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


@torch.no_grad()
def init_weights(model: FasterRCNN, seed: int) -> None:
    """The JAX model's initialisers: lecun-normal backbone convs and VGG
    fc6/fc7 (flax's Dense default), normal(0.01) RPN convs and class scores,
    normal(0.001) box regression, zero biases, identity frozen BN (the BN
    buffers' defaults)."""
    gen = torch.Generator().manual_seed(seed)
    for name, mod in model.named_modules():
        if not isinstance(mod, (Conv2d, Dense)):
            continue
        if name.startswith("rpn.") or name == "RCNN_cls_score":
            nn.init.normal_(mod.weight, 0.0, 0.01, generator=gen)
        elif name == "RCNN_bbox_pred":
            nn.init.normal_(mod.weight, 0.0, 0.001, generator=gen)
        else:
            lecun_normal_(mod.weight, gen)
        if mod.bias is not None:
            mod.bias.zero_()
