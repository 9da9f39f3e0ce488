"""Frozen-BatchNorm fold (counterpart of `rlobjectdetection_tpu/ops/bn_fold.py`).

BN is frozen throughout the detector, so it is an affine map y = x*mul + add
with constants. The fused kernels fold `mul` into the preceding conv's
weights and apply only `add`; the plain path applies both.
"""

from __future__ import annotations

import torch


def bn_mul_add(scale, bias, mean, var, eps: float = 1e-5):
    """FrozenBatchNorm fold, computed in f32: y = x*mul + add."""
    inv = torch.rsqrt(var.float() + eps)
    mul = scale.float() * inv
    add = bias.float() - mean.float() * mul
    return mul, add


def fold_conv_bn(conv, bn, eps: float = 1e-5):
    """A conv's weight (OIHW) scaled per output channel by its BN's mul, in
    f32, and that BN's add."""
    mul, add = bn_mul_add(bn.scale, bn.bias, bn.mean, bn.var, eps)
    return conv.weight.float() * mul[:, None, None, None], add
