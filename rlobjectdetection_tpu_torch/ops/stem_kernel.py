"""Fused ResNet stem: conv1 (7×7/2, pad 3, no bias, 3→64) + frozen BN +
ReLU + ceil-mode 3×3/2 max-pool.

Counterpart of `rlobjectdetection_tpu/ops/stem_pallas.py::fused_stem`. On a
CUDA tensor `fused_stem` launches the hand-written kernel `csrc/stem.cu`; on
a CPU tensor it runs `stem_plain`, the same function in plain PyTorch, which
is also what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .bn_fold import bn_mul_add

_DTYPES = (torch.float32, torch.bfloat16)


def stem_out_shapes(h: int, w: int) -> tuple[int, int, int, int]:
    """(conv_h, conv_w, pool_h, pool_w) of the stem for an H×W input."""
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    ph = -(-(oh - 3) // 2) + 1
    pw = -(-(ow - 3) // 2) + 1
    return oh, ow, ph, pw


def stem_plain(x, weight, scale, bias, mean, var, *, dtype=torch.bfloat16,
               eps: float = 1e-5) -> torch.Tensor:
    """Plain version. x `[B, H, W, 3]` (any float type, cast to `dtype` first
    as the kernel does); weight `[64, 3, 7, 7]` (OIHW). The conv, BN and ReLU
    run in f32 on `dtype`-rounded inputs; the result is `[B, PH, PW, 64]` in
    `dtype`."""
    xc = x.to(dtype).float().permute(0, 3, 1, 2)
    y = F.conv2d(xc, weight.to(dtype).float(), stride=2, padding=3)
    mul, add = bn_mul_add(scale, bias, mean, var, eps)
    y = torch.relu(y * mul[:, None, None] + add[:, None, None])
    y = F.max_pool2d(y, 3, 2, 0, ceil_mode=True)
    return y.permute(0, 2, 3, 1).to(dtype).contiguous()


def _entry():
    fn = _build.load("stem").rlod_stem_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    fn.argtypes += [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return fn


@torch.no_grad()
def fused_stem(x, weight, scale, bias, mean, var, *, dtype=torch.bfloat16,
               eps: float = 1e-5) -> torch.Tensor:
    """conv1 + frozen BN + ReLU + ceil-mode max-pool in one kernel.

    x `[B, H, W, 3]` f32 or bf16, contiguous; weight `[64, 3, 7, 7]`;
    scale/bias/mean/var `[64]`. Returns `[B, PH, PW, 64]` (NHWC) in `dtype`,
    the compute dtype: inputs and weights are rounded to it, sums are f32."""
    if x.device.type == "cpu":
        return stem_plain(x, weight, scale, bias, mean, var, dtype=dtype, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stem: unsupported device {x.device}")
    if x.ndim != 4 or x.shape[-1] != 3 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"fused_stem: x must be a contiguous [B, H, W, 3] f32/bf16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if tuple(weight.shape) != (64, 3, 7, 7):
        raise ValueError(f"fused_stem: weight must be [64, 3, 7, 7], got {tuple(weight.shape)}")
    if dtype not in _DTYPES:
        raise ValueError(f"fused_stem: unsupported dtype {dtype}")
    b, h, w, _ = x.shape
    if h < 3 or w < 3:
        raise ValueError(f"fused_stem: image {h}x{w} is smaller than the 3x3 pool")
    oh, ow, ph, pw = stem_out_shapes(h, w)
    # HWIO f32 holding compute-dtype values: the kernel reads 64 channels of
    # one tap as one coalesced row
    wk = weight.to(device=x.device, dtype=dtype).float().permute(2, 3, 1, 0).contiguous()
    mul, add = bn_mul_add(scale, bias, mean, var, eps)
    mul, add = mul.to(x.device).contiguous(), add.to(x.device).contiguous()
    out = torch.empty((b, ph, pw, 64), dtype=dtype, device=x.device)
    err = _entry()(x.data_ptr(), _build.dtype_code(x.dtype),
                   int(dtype == torch.bfloat16), wk.data_ptr(), mul.data_ptr(),
                   add.data_ptr(), out.data_ptr(), _build.dtype_code(dtype),
                   b, h, w, oh, ow, ph, pw, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "stem kernel")
    fused_stem.launches += 1
    return out


fused_stem.launches = 0
