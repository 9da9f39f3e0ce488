"""VGG-16 backbone (counterpart of
`rlobjectdetection_tpu/models/backbones/vgg.py`).

  * base = torchvision vgg16 features minus the last max-pool: 13 3×3 convs
    with biases and ReLU, 2×2/2 floor-mode max-pools after blocks 1-4 →
    `[B, H/16, W/16, 512]`;
  * head = fc6 (25088 → 4096) + ReLU + dropout + fc7 (4096 → 4096) + ReLU +
    dropout; dropout is the identity in eval. fc6 flattens the pooled
    features in (C, H, W) order, as the JAX head and the converted torch
    weights do;
  * blocks 1..`frozen_blocks` (the reference freezes 1-2) take no gradient:
    their parameters are made requires_grad=False and the activation is
    detached after the last of them, as the JAX module's stop_gradient cuts
    it, so autograd keeps no graph there.

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

from ...ops.pack_cache import PinnedPacks
from ...ops.vgg_block1_kernel import fused_vgg_block1, packed_vgg_block1
from ..targets import Uniform
from .resnet import Dense, conv, nchw_to_nhwc, nhwc_to_nchw

# (block, convs in the block, channels)
VGG16_CFG = ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512))
DROPOUT_RATE = 0.5


class VGGBase(nn.Module):
    """conv1_1 .. conv5_3 (no pool5): `[B, H, W, 3]` → `[B, H/16, W/16, 512]`."""

    def __init__(self, dtype: torch.dtype = torch.float32, conv1_fused: bool = False,
                 frozen_blocks: int = 2):
        super().__init__()
        self.dtype = dtype
        self.conv1_fused = conv1_fused
        self.frozen_blocks = frozen_blocks
        cin = 3
        for block, n_convs, ch in VGG16_CFG:
            for i in range(1, n_convs + 1):
                layer = conv(cin, ch, 3, bias=True).requires_grad_(block > frozen_blocks)
                setattr(self, f"conv{block}_{i}", layer)
                cin = ch
        self.pinned = None

    def pin_packs(self) -> None:
        """Pack block 1's kernel operands once and hold them as buffers, as
        `ResNetBase.pin_packs` does (for `torch.export`)."""
        packs = {}
        if self.conv1_fused:
            c1, c2 = self.conv1_1, self.conv1_2
            with torch.no_grad():
                packs["block1"] = packed_vgg_block1(c1.weight, c1.bias, c2.weight, c2.bias,
                                                    self.dtype, c1.weight.device)
        self.pinned = PinnedPacks(packs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv1_fused:
            c1, c2 = self.conv1_1, self.conv1_2
            pinned = {} if self.pinned is None else {"packed": self.pinned.get("block1")}
            x = nhwc_to_nchw(fused_vgg_block1(x.contiguous(), c1.weight, c1.bias, c2.weight,
                                              c2.bias, dtype=self.dtype, **pinned))
        else:
            x = nhwc_to_nchw(x.to(self.dtype))
        for block, n_convs, _ in VGG16_CFG:
            if not (block == 1 and self.conv1_fused):
                if block > 1 and not (block == 2 and self.conv1_fused):
                    x = self.pool(x)
                for i in range(1, n_convs + 1):
                    x = torch.relu(getattr(self, f"conv{block}_{i}")(x))
            if block == self.frozen_blocks:
                x = x.detach()
        return nchw_to_nhwc(x)

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        """The 2×2/2 max-pool before blocks 2-5 (`vgg_ties` swaps it per
        instance to hold two runs' gradient routes equal)."""
        return F.max_pool2d(x, 2, 2)


def apply_dropout(x: torch.Tensor, uniform: Uniform, rate: float = DROPOUT_RATE) -> torch.Tensor:
    """flax's `nn.Dropout` in train: keep where `u < 1 - rate` for uniforms
    `u` of x's shape from `uniform` (as `jax.random.bernoulli` draws), the
    kept values scaled by `x / (1 - rate)` in x's dtype, the rest 0."""
    keep_prob = 1.0 - rate
    keep = uniform(tuple(x.shape)) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class VGGHead(nn.Module):
    """fc6 + fc7: pooled `[R, P, P, 512]` NHWC → `[R, 4096]`. In train each
    ReLU is followed by dropout at rate 0.5, fc6's then fc7's uniforms
    `[R, 4096]` drawn from `dropout` (a `models.targets.Uniform` source)."""

    def __init__(self, pooled_size: int = 7):
        super().__init__()
        self.fc6 = Dense(512 * pooled_size * pooled_size, 4096)
        self.fc7 = Dense(4096, 4096)

    def forward(self, pooled: torch.Tensor, train: bool = False,
                dropout: Uniform | None = None) -> torch.Tensor:
        if train and dropout is None:
            raise ValueError("the VGG head's train forward needs a dropout source")
        drop = (lambda x: apply_dropout(x, dropout)) if train else (lambda x: x)
        x = pooled.permute(0, 3, 1, 2).reshape(pooled.shape[0], -1)   # (C, H, W) order
        return drop(torch.relu(self.fc7(drop(torch.relu(self.fc6(x))))))
