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

from . import _build
from .bn_fold import fold_conv_bn
from .res_stage_kernel import res_stage_plain

_DTYPES = (torch.float32, torch.bfloat16)


def pack_layer1(layer, dtype: torch.dtype, eps: float = 1e-5) -> list[dict]:
    """Kernel operands of each block of a layer1 module (`block0..2`, each
    with conv1..3 / bn1..3, block0 also downsample_conv / downsample_bn):
    w1 `[Cin, 64]`, w2 `[9, 64, 64]` (tap, ci, co), w3 `[64, 256]`,
    wd `[Cin, 256]` or None, in `dtype`; b1, b2, b3 in f32 (block0's b3
    includes the downsample BN's add)."""
    packed = []
    for i in range(3):
        blk = getattr(layer, f"block{i}")
        w1, b1 = fold_conv_bn(blk.conv1, blk.bn1, eps)
        w2, b2 = fold_conv_bn(blk.conv2, blk.bn2, eps)
        w3, b3 = fold_conv_bn(blk.conv3, blk.bn3, eps)
        wd = None
        if i == 0:
            wd, bd = fold_conv_bn(blk.downsample_conv, blk.downsample_bn, eps)
            wd = wd[:, :, 0, 0].t().contiguous().to(dtype)
            b3 = b3 + bd
        packed.append(dict(
            w1=w1[:, :, 0, 0].t().contiguous().to(dtype),
            w2=w2.permute(2, 3, 1, 0).reshape(9, 64, 64).contiguous().to(dtype),
            w3=w3[:, :, 0, 0].t().contiguous().to(dtype),
            wd=wd, b1=b1.contiguous(), b2=b2.contiguous(), b3=b3.contiguous()))
    return packed


def layer1_plain(x: torch.Tensor, packed: list[dict], dtype: torch.dtype) -> torch.Tensor:
    """Plain version: x `[B, H, W, 64]` NHWC → `[B, H, W, 256]` in `dtype`;
    the residual stage's plain arithmetic on the weights transposed to its
    [N][K] layout."""
    t = lambda w: None if w is None else w.t()
    return res_stage_plain(x, [dict(pk, w1=t(pk["w1"]), w2=pk["w2"].transpose(1, 2),
                                    w3=t(pk["w3"]), wd=t(pk["wd"])) for pk in packed], dtype)


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
