"""ResNet backbone, C4 Faster R-CNN flavour (counterpart of
`rlobjectdetection_tpu/models/backbones/resnet.py`).

  * base = conv1..layer3 → `[B, H/16, W/16, 1024]`; head = layer4 (stride 2)
    + spatial mean → `[R, 2048]`;
  * caffe flavour: the stride sits on the 1×1 conv1 and the 1×1 downsample,
    never on the 3×3;
  * the max-pool is 3×3/2, padding 0, ceil mode;
  * BatchNorm is frozen: `FrozenBatchNorm` holds scale/bias/mean/var as
    buffers and applies x*mul + add, mul/add computed in f32 then cast to
    the compute dtype, as the JAX module does. A bottleneck's BN, its
    residual and its ReLU are one call, `ops/frozen_bn_act.py::
    frozen_bn_act` (on the card one pass of `csrc/frozen_bn_act.cu`, the
    same bits as the modules' chain); a bottleneck built with a trainable
    affine calls the modules' chain instead (`trainable_bn_act`).

Public tensors are NHWC like the JAX package's. Inside, convs take NCHW
views of NHWC memory (PyTorch's channels-last format), so no layout copy is
made between the NHWC kernels and cuDNN's convs. With `conv1_fused` the stem
is the CUDA kernel of `ops/stem_kernel.py`, and with `layer1_fused` as well
layer1 is `ops/layer1_kernel.py` (the fused layer1 consumes the fused stem's
output). `stages_fused` (digit-coded 2, 3 or 23) runs layer2 / layer3
through `ops/res_stage_kernel.py`. The forward-only kernels engage as in the
JAX `ResNetBase`: layer1 and stage n only where they take no gradient,
i.e. `frozen_stages >= n` or the caller passes `fwd_only=True`. Layer4 and
the unfused stages are plain convs, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.frozen_bn_act import frozen_bn_act, trainable_bn_act
from ...ops.layer1_kernel import fused_layer1, packed_layer1
from ...ops.pack_cache import PinnedPacks
from ...ops.res_stage_kernel import fused_res_stage, packed_res_stage
from ...ops.stem_kernel import fused_stem, packed_stem

LAYER_SPECS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NCHW view of NHWC memory (channels-last), no copy."""
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose weight (f32 parameter) is cast to the input's dtype at
    each call, as the JAX modules cast params to their compute dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding)


class Dense(nn.Linear):
    """nn.Linear whose f32 parameters are cast to the input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def conv(cin, cout, k, stride=1, bias=False):
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics on NCHW input: y = x*mul + add.

    scale/bias/mean/var are buffers; with `affine_trainable` (the RL net's
    layer4) scale and bias are parameters under the same state-dict keys,
    and the statistics stay buffers."""

    def __init__(self, features: int, eps: float = 1e-5, affine_trainable: bool = False):
        super().__init__()
        self.eps = eps
        if affine_trainable:
            self.scale = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_buffer("scale", torch.ones(features))
            self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def affine(self, dtype: torch.dtype):
        """(mul, add) `[C]` in `dtype`, computed in f32."""
        inv = torch.rsqrt(self.var + self.eps)
        mul = (self.scale * inv).to(dtype)
        add = (self.bias - self.mean * self.scale * inv).to(dtype)
        return mul, add

    def forward(self, x):
        mul, add = self.affine(x.dtype)
        return x * mul[:, None, None] + add[:, None, None]


def ceil_max_pool(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel 3, stride 2, padding 0, ceil_mode=True) on NCHW."""
    return F.max_pool2d(x, 3, 2, 0, ceil_mode=True)


class Bottleneck(nn.Module):
    """1×1 → 3×3 → 1×1 bottleneck, expansion 4, stride on the 1×1 conv1."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, bn_affine_trainable: bool = False):
        super().__init__()
        bn = lambda f: FrozenBatchNorm(f, affine_trainable=bn_affine_trainable)
        self.conv1 = conv(inplanes, planes, 1, stride)
        self.bn1 = bn(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = bn(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = bn(planes * 4)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = conv(inplanes, planes * 4, 1, stride)
            self.downsample_bn = bn(planes * 4)
        self.bn_affine_trainable = bn_affine_trainable

    def forward(self, x):
        act = trainable_bn_act if self.bn_affine_trainable else frozen_bn_act
        out = act(self.conv1(x), self.bn1)
        out = act(self.conv2(out), self.bn2)
        out = self.conv3(out)
        if self.downsample:
            return act(out, self.bn3, self.downsample_conv(x), self.downsample_bn)
        return act(out, self.bn3, x)


class ResLayer(nn.Module):
    """A residual stage: strided block0 with downsample + identity blocks,
    as attributes `block0`, `block1`, ... (the JAX param names)."""

    def __init__(self, inplanes: int, planes: int, blocks: int, stride: int = 1,
                 bn_affine_trainable: bool = False):
        super().__init__()
        self.blocks = blocks
        self.planes = planes
        self.block0 = Bottleneck(inplanes, planes, stride, downsample=True,
                                 bn_affine_trainable=bn_affine_trainable)
        for i in range(1, blocks):
            setattr(self, f"block{i}", Bottleneck(planes * 4, planes,
                                                  bn_affine_trainable=bn_affine_trainable))

    def forward(self, x):
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class ResNetBase(nn.Module):
    """conv1..layer3: `[B, H, W, 3]` → `[B, H/16, W/16, 1024]`, both NHWC.

    `frozen_stages` (RESNET.FIXED_BLOCKS): conv1 and layer1..layer n for
    n = frozen_stages take no gradient. Their parameters are made
    requires_grad=False and the activation is detached after layer n, as the
    JAX module's stop_gradient cuts it, so autograd keeps no graph there.

    With `layer4` the base also holds layer4 (stride 2 on its 1×1 convs)
    and `pyramid` gives C2..C5 of a feature pyramid: layer1..layer4's
    outputs at strides 4, 8, 16 and 32, layer4 run on the whole map."""

    def __init__(self, num_layers: int = 101, dtype: torch.dtype = torch.float32,
                 conv1_fused: bool = False, layer1_fused: bool = False,
                 stages_fused: int = 0, frozen_stages: int = 1, layer4: bool = False):
        super().__init__()
        if stages_fused not in (0, 2, 3, 23):
            raise ValueError(f"stages_fused must be one of 0/2/3/23 (digit-coded), got "
                             f"{stages_fused!r}")
        specs = LAYER_SPECS[num_layers]
        self.dtype = dtype
        self.conv1_fused = conv1_fused
        self.layer1_fused = layer1_fused
        self.stages_fused = stages_fused
        self.frozen_stages = frozen_stages
        self.conv1 = conv(3, 64, 7, 2)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1 = ResLayer(64, 64, specs[0], 1)
        self.layer2 = ResLayer(256, 128, specs[1], 2)
        self.layer3 = ResLayer(512, 256, specs[2], 2)
        if layer4:
            self.layer4 = ResLayer(1024, 512, specs[3], 2)
        for frozen in (self.conv1, self.layer1, self.layer2, self.layer3)[:1 + min(frozen_stages, 3)]:
            frozen.requires_grad_(False)
        self.pinned = None

    def pin_packs(self) -> None:
        """Pack the operands of every kernel the eval forward
        (`fwd_only=True`) runs, once, and hold them as buffers
        (`ops/pack_cache.py::PinnedPacks`) that the forward then reads
        instead of its caches: what `torch.export` needs, since it cannot
        key a cache on a traced tensor's storage. Weights edited after this
        are not repacked."""
        with torch.no_grad():
            self.pinned = PinnedPacks(self._packs())

    def _packs(self) -> dict:
        dev = self.conv1.weight.device
        packs = {}
        if self.conv1_fused:
            bn = self.bn1
            packs["stem"] = packed_stem(self.conv1.weight, bn.scale, bn.bias, bn.mean, bn.var,
                                        self.dtype, dev)
            if self.layer1_fused:
                packs["layer1"] = packed_layer1(self.layer1, self.dtype, dev)
        for n, layer in ((2, self.layer2), (3, self.layer3)):
            if str(n) in str(self.stages_fused):
                packs[f"layer{n}"] = packed_res_stage(layer, layer.blocks, layer.planes,
                                                      self.dtype, dev)
        return packs

    def _pinned(self, name: str) -> dict:
        """The `packed=` argument of a kernel wrapper where `pin_packs` ran
        (else none: the wrapper packs and caches)."""
        return {} if self.pinned is None else {"packed": self.pinned.get(name)}

    def _cut(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        return x.detach() if min(self.frozen_stages, 3) == stage else x

    def _stage(self, layer: ResLayer, x: torch.Tensor, fuse: bool) -> torch.Tensor:
        """A stride-2 stage on NCHW (channels-last) x; fused, it runs on the
        even-coordinate grid its 1×1 stride-2 entry reads."""
        if not fuse:
            return layer(x)
        xs = nchw_to_nhwc(x)[:, ::2, ::2].contiguous()
        name = "layer2" if layer is self.layer2 else "layer3"
        return nhwc_to_nchw(fused_res_stage(xs, layer, blocks=layer.blocks, width=layer.planes,
                                            dtype=self.dtype, **self._pinned(name)))

    def forward(self, x: torch.Tensor, fwd_only: bool = False) -> torch.Tensor:
        return nchw_to_nhwc(self._stages(x, fwd_only)[-1])

    def pyramid(self, x: torch.Tensor, fwd_only: bool = False) -> list:
        """C2..C5 (layer1..layer4's outputs) as NCHW views of channels-last
        memory; needs `layer4`."""
        c2, c3, c4 = self._stages(x, fwd_only)
        return [c2, c3, c4, self.layer4(c4)]

    def _stages(self, x: torch.Tensor, fwd_only: bool) -> list:
        """layer1..layer3's outputs, NCHW views of channels-last memory, each
        cut where its stage is the last frozen one."""
        fuse = lambda n: self.frozen_stages >= n or fwd_only
        if self.conv1_fused:
            bn = self.bn1
            x = fused_stem(x.contiguous(), self.conv1.weight, bn.scale, bn.bias,
                           bn.mean, bn.var, dtype=self.dtype,
                           **self._pinned("stem"))                  # NHWC
            x = nhwc_to_nchw(self._cut(x, 0))
            if self.layer1_fused and fuse(1):
                x = nhwc_to_nchw(fused_layer1(nchw_to_nhwc(x), self.layer1, dtype=self.dtype,
                                              **self._pinned("layer1")))
            else:
                x = self.layer1(x)
        else:
            x = nhwc_to_nchw(x.to(self.dtype))
            x = self._cut(ceil_max_pool(frozen_bn_act(self.conv1(x), self.bn1)), 0)
            x = self.layer1(x)
        c2 = self._cut(x, 1)
        c3 = self._cut(self._stage(self.layer2, c2, "2" in str(self.stages_fused) and fuse(2)), 2)
        c4 = self._stage(self.layer3, c3, "3" in str(self.stages_fused) and fuse(3))
        return [c2, c3, self._cut(c4, 3)]


class ResNetHead(nn.Module):
    """layer4 + spatial mean: pooled `[R, P, P, 1024]` NHWC → `[R, 2048]`.
    The RL net's head has stride 1 and a trainable layer4 BN affine."""

    def __init__(self, num_layers: int = 101, stride: int = 2,
                 bn_affine_trainable: bool = False):
        super().__init__()
        self.layer4 = ResLayer(1024, 512, LAYER_SPECS[num_layers][3], stride,
                               bn_affine_trainable=bn_affine_trainable)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.layer4(nhwc_to_nchw(pooled)).mean(dim=(2, 3))
