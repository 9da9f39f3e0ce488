"""Fused ResNet residual stage (layer2 / layer3): a frozen chain of
caffe-flavour bottlenecks on an already-strided NHWC input, BN folded.

Counterpart of `rlobjectdetection_tpu/ops/res_stage_pallas.py::
fused_res_stage`. The caller passes `x[:, ::2, ::2, :]` for a stride-2 stage:
the stride sits on block0's 1×1 conv1 and downsample, which read only the
even-coordinate grid, so every block works on the output grid. On a CUDA
tensor `fused_res_stage` launches `csrc/res_stage.cu` once per block; on a
CPU tensor it runs `res_stage_plain`, the same arithmetic in plain PyTorch,
which is also what the kernel is held against on the card.

Packing (`pack_res_stage`): each BN's mul is folded into its conv in f32,
then cast once to the compute dtype; the adds stay in f32, block0's conv3
add carrying the downsample's. Weights are [N][K] (output channel, input
channel), the layout the kernel's B fragments read: w1 `[w, Cin]`, w2
`[9, w, w]` (tap, co, ci), w3 `[4w, w]`, wd `[4w, Cin]`. The trunk is frozen
wherever this runs, so the packed weights are cached on the stage module per
dtype and device, and packed again only when a weight of the stage changes.

Rounding points, the TPU kernel's: conv1 and conv2 outputs are rounded to
the compute dtype after bias and ReLU; the block output after residual and
ReLU; block0's downsample sum stays in f32 until that last rounding; later
blocks read their residual from the rounded activation.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .bn_fold import fold_conv_bn
from .pack_cache import cached_pack

_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_WIDTHS = (128, 256)   # layer2, layer3: the widths the kernel is built for


def pack_res_stage(layer, blocks: int, width: int, dtype: torch.dtype,
                   eps: float = 1e-5) -> list[dict]:
    """Kernel operands of each block of a residual stage module (`block0..`,
    each with conv1..3 / bn1..3, block0 also downsample_conv /
    downsample_bn): w1, w2, w3 and wd (block0, else None) in `dtype`, b1, b2,
    b3 in f32."""
    packed = []
    for i in range(blocks):
        blk = getattr(layer, f"block{i}")
        w1, b1 = fold_conv_bn(blk.conv1, blk.bn1, eps)
        w2, b2 = fold_conv_bn(blk.conv2, blk.bn2, eps)
        w3, b3 = fold_conv_bn(blk.conv3, blk.bn3, eps)
        if tuple(w2.shape) != (width, width, 3, 3) or w3.shape[0] != 4 * width:
            raise ValueError(f"block{i}: conv shapes {tuple(w2.shape)} {tuple(w3.shape)} "
                             f"are not those of a width-{width} bottleneck")
        wd = None
        if i == 0:
            wd, bd = fold_conv_bn(blk.downsample_conv, blk.downsample_bn, eps)
            wd = wd[:, :, 0, 0].to(dtype).contiguous()
            b3 = b3 + bd
        packed.append(dict(
            w1=w1[:, :, 0, 0].to(dtype).contiguous(),
            w2=w2.permute(2, 3, 0, 1).reshape(9, width, width).to(dtype).contiguous(),
            w3=w3[:, :, 0, 0].to(dtype).contiguous(),
            wd=wd, b1=b1.contiguous(), b2=b2.contiguous(), b3=b3.contiguous()))
    return packed


def packed_on(packed: list[dict], device) -> list[dict]:
    """Each block's packed operands moved to `device`."""
    return [{k: None if v is None else v.to(device) for k, v in pk.items()} for pk in packed]


def _packed(layer, blocks, width, dtype, device, eps) -> list[dict]:
    """`pack_res_stage` of `layer` on `device`, cached on the module per
    dtype (`pack_cache.cached_pack`)."""
    return cached_pack(layer, "_res_stage_packed", dtype, (blocks, width, eps, device),
                       [*layer.parameters(), *layer.buffers()],
                       lambda: packed_on(pack_res_stage(layer, blocks, width, dtype, eps),
                                         device))


def _block_plain(x: torch.Tensor, pk: dict, dtype: torch.dtype) -> torch.Tensor:
    """One folded bottleneck on NCHW f32 values that are `dtype`-exact; the
    kernel's arithmetic: f32 sums, intermediates rounded to `dtype`."""
    rnd = lambda t: t.to(dtype).float()
    w = pk["w1"].shape[0]
    w2 = pk["w2"].float().reshape(3, 3, w, w).permute(2, 3, 0, 1)
    a1 = rnd(torch.relu(F.conv2d(x, pk["w1"].float()[:, :, None, None])
                        + pk["b1"][:, None, None]))
    a2 = rnd(torch.relu(F.conv2d(a1, w2, padding=1) + pk["b2"][:, None, None]))
    y = F.conv2d(a2, pk["w3"].float()[:, :, None, None]) + pk["b3"][:, None, None]
    if pk["wd"] is not None:
        y = y + F.conv2d(x, pk["wd"].float()[:, :, None, None])
    else:
        y = y + x
    return rnd(torch.relu(y))


def res_stage_plain(x: torch.Tensor, packed: list[dict], dtype: torch.dtype) -> torch.Tensor:
    """Plain version: x `[B, Ho, Wo, Cin]` NHWC (already strided) →
    `[B, Ho, Wo, 4w]` in `dtype`."""
    y = x.to(dtype).float().permute(0, 3, 1, 2)
    for pk in packed:
        y = _block_plain(y, pk, dtype)
    return y.permute(0, 2, 3, 1).to(dtype).contiguous()


def _entry():
    fn = _build.load("res_stage").rlod_res_stage_block
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def fused_res_stage(x: torch.Tensor, layer, *, blocks: int, width: int,
                    dtype: torch.dtype = torch.bfloat16, eps: float = 1e-5) -> torch.Tensor:
    """Run a frozen residual stage on an ALREADY-STRIDED NHWC input.

    x `[B, Ho, Wo, Cin]` in `dtype`; layer: the module holding
    `block0..block{blocks-1}` of width `width`. Returns `[B, Ho, Wo, 4*width]`
    NHWC in `dtype`. Forward only, as the TPU kernel is: it raises where
    autograd would need its gradient (grad enabled and `x` or a weight of the
    stage requires grad)."""
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(p.requires_grad for p in layer.parameters())):
        raise RuntimeError(
            "fused_res_stage is forward-only: it serves frozen trunk stages and the "
            "no-gradient eval path; freeze the stage or detach its input")
    if dtype not in _DTYPES:
        raise ValueError(f"fused_res_stage: unsupported dtype {dtype}")
    with torch.no_grad():
        packed = _packed(layer, blocks, width, dtype, x.device, eps)
        if x.device.type == "cpu":
            return res_stage_plain(x, packed, dtype)
        if x.device.type != "cuda":
            raise ValueError(f"fused_res_stage: unsupported device {x.device}")
        cin = packed[0]["w1"].shape[1]
        if (x.ndim != 4 or x.shape[-1] != cin or x.dtype != dtype or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"fused_res_stage: x must be a contiguous, 16-byte aligned "
                             f"[B, Ho, Wo, {cin}] tensor of dtype {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if width not in KERNEL_WIDTHS or cin % 16:
            raise ValueError(f"fused_res_stage: the kernel takes widths {KERNEL_WIDTHS} and "
                             f"input channels a multiple of 16, got {width}, {cin}")
        b, h, w, _ = x.shape
        fn = _entry()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        bufs = [torch.empty((b, h, w, 4 * width), dtype=dtype, device=x.device)
                for _ in range(min(2, blocks))]
        for i, pk in enumerate(packed):
            out = bufs[i % 2]
            wd = pk["wd"].data_ptr() if pk["wd"] is not None else None
            err = fn(x.data_ptr(), pk["w1"].data_ptr(), pk["b1"].data_ptr(),
                     pk["w2"].data_ptr(), pk["b2"].data_ptr(), pk["w3"].data_ptr(),
                     pk["b3"].data_ptr(), wd, out.data_ptr(), b, h, w, x.shape[-1], width,
                     _build.dtype_code(dtype), stream)
            _build.check(err, "res_stage kernel")
            fused_res_stage.launches += 1
            x = out
        return x


fused_res_stage.launches = 0
