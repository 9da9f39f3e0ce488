"""RL action-value net: ResNet trunk + RoIAlignAvg + action head
(counterpart of `rlobjectdetection_tpu/models/rl/policy.py`).

Trunk conv1..layer3 frozen (`frozen_stages=3`, so the stem, layer1 and stage
kernels all engage, in training too); RoIAlignAvg 7×7 at 1/16 on the
detection boxes; layer4 at stride 1 with a trainable BN affine (frozen
statistics) + spatial mean; fc8 (2048 → 4096) + ReLU; fc (4096 → num_acts);
weighted MSE against ±1 targets. Parameters are f32 and compute runs in
`dtype`; names follow the JAX param tree (`head/layer4/block0/bn1/scale` is
`head.layer4.block0.bn1.scale`), which `engine/checkpoint.py` maps.
"""

from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from ...ops.roi_align_kernel import roi_align_avg
from ..backbones.resnet import Conv2d, Dense, ResNetBase, ResNetHead
from ..faster_rcnn import lecun_normal_
from ..losses import weighted_mse_loss


class RLPolicyNet(nn.Module):
    """`RLPolicyNet(num_acts, num_layers, dtype, ...)`; weights are made
    from `seed` (the JAX net's initialisers: lecun-normal convs and dense
    kernels, zero biases, identity BN)."""

    def __init__(self, num_acts: int = 56, num_layers: int = 101,
                 dtype: torch.dtype = torch.float32, conv1_fused: bool = False,
                 layer1_fused: bool = False, stages_fused: int = 0, *,
                 device: str | torch.device = "cuda", seed: int = 3):
        super().__init__()
        dev = resolve_device(device)
        self.num_acts = num_acts
        self.dtype = dtype
        self.base = ResNetBase(num_layers, dtype, conv1_fused=conv1_fused,
                               layer1_fused=layer1_fused, stages_fused=stages_fused,
                               frozen_stages=3)
        self.head = ResNetHead(num_layers, stride=1, bn_affine_trainable=True)
        self.fc8 = Dense(2048, 4096)
        self.fc = Dense(4096, num_acts)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (Conv2d, Dense)):
                    lecun_normal_(mod.weight, gen)
                    if mod.bias is not None:
                        mod.bias.zero_()
        self.to(dev)

    def forward(self, img, bboxes, targets=None, weights=None, num_dts=None, *,
                images=None, image_mask=None):
        """img `[B, H, W, 3]` normalised RGB; bboxes `[B, N, 5+]` (batch_id,
        x1, y1, x2, y2, ...); targets / weights `[B, N, num_acts]`; num_dts
        true detection counts, whose max sets the loss's denominator to
        B · max(num_dts) · A and masks the padded rows.

        A data-parallel rank passes the global batch's `num_dts`, `images`
        = the global batch's images / the world size in place of B, and
        `image_mask` `[B]` (False on the zero images that pad a ragged
        batch to the world), so that the ranks' mean loss is the global
        batch's.

        Returns (pred `[B·N, num_acts]` f32, loss, noweight loss); the loss
        terms are 0 without targets."""
        rois = bboxes.reshape(-1, bboxes.shape[-1])[:, :5].float().contiguous()
        x = self.base(img)
        roi_feat = roi_align_avg(x.contiguous(), rois, 7, 1.0 / 16.0)
        pooled = self.head(roi_feat.to(self.dtype))                  # [B·N, 2048]
        pred = self.fc(torch.relu(self.fc8(pooled))).float()         # [B·N, A]
        if targets is None:
            zero = torch.zeros((), device=pred.device)
            return pred, zero, zero
        t = targets.reshape(-1, self.num_acts)
        w = weights.reshape(-1, self.num_acts)
        denom = row_mask = None
        if num_dts is not None:
            max_true = torch.clamp(num_dts.max(), min=1)
            denom = (img.shape[0] if images is None else images) * self.num_acts * max_true
            # rows past the exact batch max exist only because of the
            # collate's padding to a multiple of 16
            slot_ok = torch.arange(bboxes.shape[1], device=pred.device) < max_true
            if image_mask is None:
                row_mask = slot_ok.repeat(img.shape[0])
            else:
                row_mask = (image_mask[:, None] & slot_ok[None, :]).reshape(-1)
        loss, noweight = weighted_mse_loss(pred, t, w, denom=denom, row_mask=row_mask)
        return pred, loss, noweight


def warm_start_from_detector(rl_state: dict, detector_state: dict) -> dict:
    """The RL net's state dict with the detector's `base.*` (conv1..layer3)
    and `head.*` (layer4) entries copied in wherever the key exists and the
    shape matches (the reference's strict=False load)."""
    out = dict(rl_state)
    for key, val in detector_state.items():
        if (key.startswith(("base.", "head.")) and key in out
                and tuple(out[key].shape) == tuple(val.shape)):
            out[key] = val
    return out
