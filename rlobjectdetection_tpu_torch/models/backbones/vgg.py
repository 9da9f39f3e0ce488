"""VGG-16 backbone (counterpart of
`rlobjectdetection_tpu/models/backbones/vgg.py`).

  * base = torchvision vgg16 features minus the last max-pool: 13 3×3 convs
    with biases and ReLU, 2×2/2 floor-mode max-pools after blocks 1-4 →
    `[B, H/16, W/16, 512]`;
  * head = fc6 (25088 → 4096) + ReLU + fc7 (4096 → 4096) + ReLU; dropout is
    the identity in eval. fc6 flattens the pooled features in (C, H, W)
    order, as the JAX head and the converted torch weights do.

Public tensors are NHWC; inside, convs take NCHW views of NHWC memory, as in
`resnet.py`. With `conv1_fused`, block 1 (conv1_1, conv1_2 and pool1) is the
CUDA kernel of `ops/vgg_block1_kernel.py`, which takes the raw image and
casts it itself, and block 2 skips its leading pool; the plain path casts
the input to the compute dtype first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.vgg_block1_kernel import fused_vgg_block1
from .resnet import Dense, conv, nchw_to_nhwc, nhwc_to_nchw

# (block, convs in the block, channels)
VGG16_CFG = ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512))


class VGGBase(nn.Module):
    """conv1_1 .. conv5_3 (no pool5): `[B, H, W, 3]` → `[B, H/16, W/16, 512]`."""

    def __init__(self, dtype: torch.dtype = torch.float32, conv1_fused: bool = False):
        super().__init__()
        self.dtype = dtype
        self.conv1_fused = conv1_fused
        cin = 3
        for block, n_convs, ch in VGG16_CFG:
            for i in range(1, n_convs + 1):
                setattr(self, f"conv{block}_{i}", conv(cin, ch, 3, bias=True))
                cin = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv1_fused:
            c1, c2 = self.conv1_1, self.conv1_2
            x = nhwc_to_nchw(fused_vgg_block1(x.contiguous(), c1.weight, c1.bias, c2.weight,
                                              c2.bias, dtype=self.dtype))
        else:
            x = nhwc_to_nchw(x.to(self.dtype))
        for block, n_convs, _ in VGG16_CFG:
            if block == 1 and self.conv1_fused:
                continue
            if block > 1 and not (block == 2 and self.conv1_fused):
                x = F.max_pool2d(x, 2, 2)
            for i in range(1, n_convs + 1):
                x = torch.relu(getattr(self, f"conv{block}_{i}")(x))
        return nchw_to_nhwc(x)


class VGGHead(nn.Module):
    """fc6 + fc7: pooled `[R, P, P, 512]` NHWC → `[R, 4096]`."""

    def __init__(self, pooled_size: int = 7):
        super().__init__()
        self.fc6 = Dense(512 * pooled_size * pooled_size, 4096)
        self.fc7 = Dense(4096, 4096)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.permute(0, 3, 1, 2).reshape(pooled.shape[0], -1)   # (C, H, W) order
        return torch.relu(self.fc7(torch.relu(self.fc6(x))))
