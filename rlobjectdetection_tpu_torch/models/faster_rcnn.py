"""Faster R-CNN detector, eval forward (counterpart of
`rlobjectdetection_tpu/models/faster_rcnn.py`).

backbone → RPN → proposal layer → RoIAlignAvg → head (ResNet layer4, or
VGG-16 fc6/fc7) → class probabilities + per-class box regression.
Parameters are f32; compute runs in cfg.DTYPE. Module and parameter names
follow the JAX param tree (`base/layer1/block0/conv1/kernel` is
`base.layer1.block0.conv1.weight`, `head/fc6/kernel` is `head.fc6.weight`),
which is what `engine/checkpoint.py` maps.

The port serves the ResNet and VGG-16 backbones with POOLING_MODE "align".
Training and the pool / crop modes are later slices (ROADMAP.md §1), and
asking for them raises.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import Config
from ..device import compute_dtype, resolve_device
from ..ops.roi_align_kernel import roi_align_avg
from .backbones.resnet import Conv2d, Dense, ResNetBase, ResNetHead
from .backbones.vgg import VGGBase, VGGHead
from .rpn import RPNHead, proposal_layer, rpn_fg_probs


class FasterRCNN(nn.Module):
    """`FasterRCNN(num_classes, "resnet101" | "vgg16", cfg)`; weights are
    made from `seed` (the JAX model's initialisers, numbers from a
    torch.Generator)."""

    def __init__(self, num_classes: int, backbone: str = "resnet101",
                 cfg: Config = Config(), class_agnostic: bool = False, *,
                 device: str | torch.device = "cuda", seed: int = 3):
        super().__init__()
        dev = resolve_device(device)
        if cfg.POOLING_MODE != "align":
            raise NotImplementedError(
                f"POOLING_MODE {cfg.POOLING_MODE!r}: only 'align' is ported so "
                f"far; pool and crop are ROADMAP.md §1 item 12")
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
        else:
            raise ValueError(f"unknown backbone {backbone!r}")
        self.rpn = RPNHead(self.num_anchors, base_ch)
        self.RCNN_cls_score = Dense(head_ch, num_classes)
        self.RCNN_bbox_pred = Dense(head_ch, 4 if class_agnostic else 4 * num_classes)
        init_weights(self, seed)
        self.requires_grad_(False)
        self.to(dev)

    def proposals(self, base_feat: torch.Tensor, im_info: torch.Tensor):
        """RPN + proposal layer: (rois `[B, R, 5]`, roi_scores, roi_valid)."""
        c = self.cfg
        rpn_cls, rpn_delta = self.rpn(base_feat)
        return proposal_layer(
            rpn_fg_probs(rpn_cls, self.num_anchors), rpn_delta, im_info,
            feat_stride=c.FEAT_STRIDE[0], anchor_scales=c.ANCHOR_SCALES,
            anchor_ratios=c.ANCHOR_RATIOS, pre_nms_top_n=c.TEST.RPN_PRE_NMS_TOP_N,
            post_nms_top_n=c.TEST.RPN_POST_NMS_TOP_N, nms_thresh=c.TEST.RPN_NMS_THRESH,
            nms_tile=c.NMS_TILE)

    def detect_head(self, base_feat: torch.Tensor, rois: torch.Tensor):
        """RoIAlignAvg + head + classifiers for rois `[B, R, 5]`: (cls_prob
        `[B, R, C]` f32 softmax, bbox_pred `[B, R, 4C]` f32)."""
        b, r = rois.shape[:2]
        pooled = roi_align_avg(base_feat.contiguous(), rois.reshape(-1, 5).contiguous(),
                               self.cfg.POOLING_SIZE, 1.0 / 16.0).to(self.dtype)
        feat = self.head(pooled)                           # [B*R, 2048 | 4096]
        cls_score = self.RCNN_cls_score(feat).float()
        bbox_pred = self.RCNN_bbox_pred(feat).float()
        cls_prob = torch.softmax(cls_score, dim=-1)
        return cls_prob.reshape(b, r, -1), bbox_pred.reshape(b, r, -1)

    def forward(self, im_data: torch.Tensor, im_info: torch.Tensor, *, train: bool = False):
        """im_data `[B, H, W, 3]` (BGR, pixel means subtracted); im_info
        `[B, 3]` (h, w, scale). Returns {rois, roi_valid, cls_prob, bbox_pred}."""
        if train:
            raise NotImplementedError(
                "the train forward (targets, losses, train step) is the training "
                "slice, ROADMAP.md §1 item 11")
        # eval takes no gradient, so the frozen-stage kernels (STAGE_FUSED)
        # engage whatever FIXED_BLOCKS says, as in the JAX model
        base_feat = (self.base(im_data, fwd_only=True) if isinstance(self.base, ResNetBase)
                     else self.base(im_data))
        rois, _, roi_valid = self.proposals(base_feat, im_info)
        cls_prob, bbox_pred = self.detect_head(base_feat, rois)
        return dict(rois=rois, roi_valid=roi_valid, cls_prob=cls_prob, bbox_pred=bbox_pred)


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
