"""Fused ResNet layer1: three frozen Bottleneck(64) blocks at stride 1,
64 → 256 channels, block0 with a 1×1 downsample shortcut.

Counterpart of `rlobjectdetection_tpu/ops/layer1_pallas.py::fused_layer1`.
BN is folded into the conv weights as in its `_pack_params` (f32 fold, then
one cast to the compute dtype); only the BN adds remain, kept in f32. On a
CUDA tensor `fused_layer1` launches `csrc/layer1.cu` once per block; on a CPU
tensor it runs `layer1_plain`, the same arithmetic in plain PyTorch, which
is also what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .bn_fold import bn_mul_add

_DTYPES = (torch.float32, torch.bfloat16)


def _fold(conv, bn, eps):
    """Conv weight (OIHW) scaled per output channel by its BN's mul (f32),
    and that BN's add."""
    mul, add = bn_mul_add(bn.scale, bn.bias, bn.mean, bn.var, eps)
    return conv.weight.float() * mul[:, None, None, None], add


def pack_layer1(layer, dtype: torch.dtype, eps: float = 1e-5) -> list[dict]:
    """Kernel operands of each block of a layer1 module (`block0..2`, each
    with conv1..3 / bn1..3, block0 also downsample_conv / downsample_bn):
    w1 `[Cin, 64]`, w2 `[9, 64, 64]` (tap, ci, co), w3 `[64, 256]`,
    wd `[Cin, 256]` or None, in `dtype`; b1, b2, b3 in f32 (block0's b3
    includes the downsample BN's add)."""
    packed = []
    for i in range(3):
        blk = getattr(layer, f"block{i}")
        w1, b1 = _fold(blk.conv1, blk.bn1, eps)
        w2, b2 = _fold(blk.conv2, blk.bn2, eps)
        w3, b3 = _fold(blk.conv3, blk.bn3, eps)
        wd = None
        if i == 0:
            wd, bd = _fold(blk.downsample_conv, blk.downsample_bn, eps)
            wd = wd[:, :, 0, 0].t().contiguous().to(dtype)
            b3 = b3 + bd
        packed.append(dict(
            w1=w1[:, :, 0, 0].t().contiguous().to(dtype),
            w2=w2.permute(2, 3, 1, 0).reshape(9, 64, 64).contiguous().to(dtype),
            w3=w3[:, :, 0, 0].t().contiguous().to(dtype),
            wd=wd, b1=b1.contiguous(), b2=b2.contiguous(), b3=b3.contiguous()))
    return packed


def _block_plain(x: torch.Tensor, pk: dict, dtype: torch.dtype) -> torch.Tensor:
    """One folded bottleneck on NCHW f32 values that are `dtype`-exact; the
    kernel's arithmetic: f32 sums, intermediates rounded to `dtype`."""
    rnd = lambda t: t.to(dtype).float()
    w1 = pk["w1"].float().t()[:, :, None, None]
    w2 = pk["w2"].float().reshape(3, 3, 64, 64).permute(3, 2, 0, 1)
    w3 = pk["w3"].float().t()[:, :, None, None]
    a1 = rnd(torch.relu(F.conv2d(x, w1) + pk["b1"][:, None, None]))
    a2 = rnd(torch.relu(F.conv2d(a1, w2, padding=1) + pk["b2"][:, None, None]))
    y = F.conv2d(a2, w3) + pk["b3"][:, None, None]
    if pk["wd"] is not None:
        y = y + F.conv2d(x, pk["wd"].float().t()[:, :, None, None])
    else:
        y = y + x
    return rnd(torch.relu(y))


def layer1_plain(x: torch.Tensor, packed: list[dict], dtype: torch.dtype) -> torch.Tensor:
    """Plain version: x `[B, H, W, 64]` NHWC → `[B, H, W, 256]` in `dtype`."""
    y = x.to(dtype).float().permute(0, 3, 1, 2)
    for pk in packed:
        y = _block_plain(y, pk, dtype)
    return y.permute(0, 2, 3, 1).to(dtype).contiguous()


def _entry():
    fn = _build.load("layer1").rlod_layer1_block
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


@torch.no_grad()
def fused_layer1(x: torch.Tensor, layer, *, dtype=torch.bfloat16,
                 eps: float = 1e-5) -> torch.Tensor:
    """Run the frozen layer1 stage. x `[B, H, W, 64]` NHWC in `dtype` (the
    stem's output); layer: the module holding `block0..2`. Returns
    `[B, H, W, 256]` NHWC in `dtype`."""
    packed = pack_layer1(layer, dtype, eps)
    if x.device.type == "cpu":
        return layer1_plain(x, packed, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer1: unsupported device {x.device}")
    if (x.ndim != 4 or x.shape[-1] != 64 or x.dtype != dtype or dtype not in _DTYPES
            or not x.is_contiguous()):
        raise ValueError(f"fused_layer1: x must be a contiguous [B, H, W, 64] tensor "
                         f"of dtype {dtype}, got {tuple(x.shape)} {x.dtype}")
    b, h, w, _ = x.shape
    fn = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for pk in packed:
        cin = x.shape[-1]
        out = torch.empty((b, h, w, 256), dtype=dtype, device=x.device)
        wd = pk["wd"].data_ptr() if pk["wd"] is not None else None
        err = fn(x.data_ptr(), pk["w1"].data_ptr(), pk["b1"].data_ptr(),
                 pk["w2"].data_ptr(), pk["b2"].data_ptr(), pk["w3"].data_ptr(),
                 pk["b3"].data_ptr(), wd, out.data_ptr(), b, h, w, cin,
                 _build.dtype_code(dtype), stream)
        _build.check(err, "layer1 kernel")
        fused_layer1.launches += 1
        x = out
    return x


fused_layer1.launches = 0
