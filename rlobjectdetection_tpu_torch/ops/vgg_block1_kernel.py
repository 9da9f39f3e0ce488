"""Fused VGG-16 block 1: conv1_1 (3×3, pad 1, 3→64, bias) + ReLU + conv1_2
(3×3, pad 1, 64→64, bias) + ReLU + 2×2/2 max-pool (floor mode).

Counterpart of `rlobjectdetection_tpu/ops/vgg_stem_pallas.py::
fused_vgg_block1`. On a CUDA tensor `fused_vgg_block1` launches the
hand-written kernel `csrc/vgg_block1.cu`; on a CPU tensor it runs
`vgg_block1_plain`, the same function in plain PyTorch, which is also what
the kernel is held against on the card.

Rounding points, the TPU kernel's: the image and the weights are rounded to
the compute dtype; conv1_1 sums in f32, adds its bias in f32, applies ReLU
and is rounded to the compute dtype; conv1_2 sums, adds its bias and applies
ReLU in f32; the 2×2 max is rounded to the compute dtype. conv1_2's zero
padding is literal: conv1_1 outputs outside the image are 0, not relu(b1).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


def vgg_block1_plain(x, w1, b1, w2, b2, *, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version. x `[B, H, W, 3]` (any float type); w1 `[64, 3, 3, 3]`,
    w2 `[64, 64, 3, 3]` (OIHW); b1, b2 `[64]`. Returns `[B, H/2, W/2, 64]`
    (NHWC) in `dtype`."""
    rnd = lambda t: t.to(dtype).float()
    xc = rnd(x).permute(0, 3, 1, 2)
    y1 = rnd(torch.relu(F.conv2d(xc, rnd(w1), b1.float(), padding=1)))
    y2 = torch.relu(F.conv2d(y1, rnd(w2), b2.float(), padding=1))
    return F.max_pool2d(y2, 2, 2).permute(0, 2, 3, 1).to(dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _fragment_index(device: torch.device):
    """(tap, ci, co) of each element of the packed bf16 B fragments
    `[36, 8, 32, 4]`: k-step s (tap s // 4, input channels 16 (s % 4) ..
    +15), N tile j (output channels 8j .. 8j + 7), lane, element e. For
    mma.sync m16n8k16, lane (g, t) = (lane // 4, lane % 4) holds B[k][n] at
    n = g and k = 2t + (e % 2) + 8 (e // 2)."""
    s = torch.arange(36, device=device)[:, None, None, None]
    j = torch.arange(8, device=device)[None, :, None, None]
    lane = torch.arange(32, device=device)[None, None, :, None]
    e = torch.arange(4, device=device)[None, None, None, :]
    ci = (s % 4) * 16 + (lane % 4) * 2 + e % 2 + 8 * (e // 2)
    return s // 4, ci, j * 8 + lane // 4


def pack_w2(w2: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """conv1_2's weight `[64, 64, 3, 3]` (OIHW) as the kernel reads it: f32
    `[9, 64, 64]` (tap, ci, co), or for bf16 the tensor-core B fragments
    `[36, 8, 32, 4]` (see `_fragment_index`)."""
    wt = w2.to(dtype).permute(2, 3, 1, 0).reshape(9, 64, 64)
    if dtype == torch.bfloat16:
        wt = wt[_fragment_index(w2.device)]
    return wt.contiguous()


def _entry():
    fn = _build.load("vgg_block1").rlod_vgg_block1_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


@torch.no_grad()
def fused_vgg_block1(x, w1, b1, w2, b2, *, dtype=torch.bfloat16) -> torch.Tensor:
    """conv1_1 + ReLU + conv1_2 + ReLU + 2×2 max-pool in one kernel.

    x `[B, H, W, 3]` f32 or bf16, contiguous, H and W even; w1
    `[64, 3, 3, 3]`, w2 `[64, 64, 3, 3]` (OIHW); b1, b2 `[64]`. Returns
    `[B, H/2, W/2, 64]` (NHWC) in `dtype`, the compute dtype."""
    if x.ndim != 4 or x.shape[-1] != 3 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"fused_vgg_block1: x must be a contiguous [B, H, W, 3] f32/bf16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"fused_vgg_block1: H and W must be even, got {tuple(x.shape)}")
    if tuple(w1.shape) != (64, 3, 3, 3) or tuple(w2.shape) != (64, 64, 3, 3):
        raise ValueError(f"fused_vgg_block1: weights must be [64, 3, 3, 3] and "
                         f"[64, 64, 3, 3], got {tuple(w1.shape)} {tuple(w2.shape)}")
    if dtype not in _DTYPES:
        raise ValueError(f"fused_vgg_block1: unsupported dtype {dtype}")
    if x.device.type == "cpu":
        return vgg_block1_plain(x, w1, b1, w2, b2, dtype=dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_vgg_block1: unsupported device {x.device}")
    b, h, w, _ = x.shape
    dev = x.device
    # taps (ky, kx, ci) × 64 channels, f32 holding compute-dtype values
    w1k = w1.to(device=dev, dtype=dtype).float().permute(2, 3, 1, 0).reshape(27, 64)
    w1k = w1k.contiguous()
    w2k = pack_w2(w2.to(dev), dtype)
    b1k, b2k = (v.to(device=dev, dtype=torch.float32).contiguous() for v in (b1, b2))
    out = torch.empty((b, h // 2, w // 2, 64), dtype=dtype, device=dev)
    err = _entry()(x.data_ptr(), _build.dtype_code(x.dtype), w1k.data_ptr(), b1k.data_ptr(),
                   w2k.data_ptr(), b2k.data_ptr(), out.data_ptr(), _build.dtype_code(dtype),
                   b, h, w, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "vgg_block1 kernel")
    fused_vgg_block1.launches += 1
    return out


fused_vgg_block1.launches = 0
