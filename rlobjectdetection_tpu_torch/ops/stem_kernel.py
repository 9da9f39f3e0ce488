"""Fused ResNet stem: conv1 (7×7/2, pad 3, no bias, 3→64) + frozen BN +
ReLU + ceil-mode 3×3/2 max-pool.

Counterpart of `rlobjectdetection_tpu/ops/stem_pallas.py::fused_stem`.
`fused_stem` calls the op `rlod::stem` (`ops/library.py`) on the kernel's
operands (`pack_stem`): on a CUDA tensor it launches the hand-written
kernel `csrc/stem.cu`, on a CPU tensor it runs the same function in plain
PyTorch (`stem_plain_packed`, `stem_plain` on the unpacked weights), which
is also what the kernel is held against on the card. The operands are
cached on the weight tensor per dtype and device, and packed again only
when one of the five source tensors changes; a caller that holds them
already (an exported model's pinned packs) passes them as `packed`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .bn_fold import bn_mul_add
from .guards import forward_only
from .pack_cache import cached_pack

_DTYPES = (torch.float32, torch.bfloat16)
STEM_ROW_TAPS = 32   # taps a kernel row in the bf16 packing: 21 used, padded to 2 k-steps


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
    mul, add = bn_mul_add(scale, bias, mean, var, eps)
    return _stem_folded(x, weight.to(dtype), mul, add, dtype)


def _stem_folded(x, w, mul, add, dtype) -> torch.Tensor:
    """conv (OIHW weight `w` in `dtype`) → x·mul + add → ReLU → ceil max-pool."""
    xc = x.to(dtype).float().permute(0, 3, 1, 2)
    y = F.conv2d(xc, w.float().contiguous(), stride=2, padding=3)
    y = torch.relu(y * mul[:, None, None] + add[:, None, None])
    y = F.max_pool2d(y, 3, 2, 0, ceil_mode=True)
    return y.permute(0, 2, 3, 1).to(dtype).contiguous()


def pack_stem(weight, scale, bias, mean, var, dtype: torch.dtype, eps: float = 1e-5):
    """Kernel operands (w, mul, add). w for bf16: `[64, 224]`, output
    channel by the 7 kernel rows of STEM_ROW_TAPS taps (kx, ci), zero past
    tap 21 of a row (the tensor-core kernel's K); for f32: `[7, 7, 3, 64]`
    (HWIO, the FMA kernel's coalesced rows). mul, add: the BN fold in f32."""
    w = weight.to(dtype)
    if dtype == torch.bfloat16:
        wk = torch.zeros(64, 7, STEM_ROW_TAPS, dtype=dtype, device=weight.device)
        wk[:, :, :21] = w.permute(0, 2, 3, 1).reshape(64, 7, 21)    # (co, ky, (kx, ci))
        wk = wk.reshape(64, 7 * STEM_ROW_TAPS)
    else:
        wk = w.permute(2, 3, 1, 0).contiguous()
    mul, add = bn_mul_add(scale, bias, mean, var, eps)
    return wk, mul.contiguous(), add.contiguous()


def stem_plain_packed(x, packed, dtype) -> torch.Tensor:
    """`stem_plain` on `pack_stem`'s operands (w, mul, add): the same
    weights, unpacked, and the same arithmetic."""
    wk, mul, add = packed
    if wk.dtype == torch.bfloat16:
        w = wk.reshape(64, 7, STEM_ROW_TAPS)[:, :, :21].reshape(64, 7, 7, 3).permute(0, 3, 1, 2)
    else:
        w = wk.permute(3, 2, 0, 1)
    return _stem_folded(x, w, mul, add, dtype)


def packed_stem(weight, scale, bias, mean, var, dtype, device, eps: float = 1e-5):
    """`pack_stem` on `device`, cached on the weight tensor per dtype and
    keyed on all five tensors (`pack_cache.cached_pack`)."""
    src = (weight, scale, bias, mean, var)
    return cached_pack(weight, "_stem_packed", dtype, (eps, device), src,
                       lambda: tuple(t.to(device) for t in pack_stem(*src, dtype, eps)))


def _entry():
    fn = _build.load("stem").rlod_stem_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
    fn.argtypes += [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return fn


def launch_stem(x: torch.Tensor, packed, dtype: torch.dtype) -> torch.Tensor:
    """One kernel launch on packed operands already on x's device: x
    `[B, H, W, 3]` CUDA NHWC f32 or bf16 → `[B, PH, PW, 64]` in `dtype`."""
    if x.ndim != 4 or x.shape[-1] != 3 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"fused_stem: x must be a contiguous [B, H, W, 3] f32/bf16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    b, h, w, _ = x.shape
    if h < 3 or w < 3:
        raise ValueError(f"fused_stem: image {h}x{w} is smaller than the 3x3 pool")
    oh, ow, ph, pw = stem_out_shapes(h, w)
    wk, mul, add = packed
    out = torch.empty((b, ph, pw, 64), dtype=dtype, device=x.device)
    err = _entry()(x.data_ptr(), _build.dtype_code(x.dtype), wk.data_ptr(), mul.data_ptr(),
                   add.data_ptr(), out.data_ptr(), _build.dtype_code(dtype),
                   b, h, w, oh, ow, ph, pw, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "stem kernel")
    fused_stem.launches += 1
    return out


def stem_info(dtype: torch.dtype) -> dict:
    """Launch resources of the kernel for `dtype` as the runtime reports
    them: registers a thread, shared memory bytes a CTA, CTAs an SM, spill
    bytes a thread."""
    fn = _build.load("stem").rlod_stem_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    buf = (ctypes.c_int * 4)()
    _build.check(fn(_build.dtype_code(dtype), buf), "stem info")
    return dict(zip(("registers", "smem_bytes", "ctas_per_sm", "spill_bytes"), buf))


def fused_stem(x, weight, scale, bias, mean, var, *, dtype=torch.bfloat16,
               eps: float = 1e-5, packed=None) -> torch.Tensor:
    """conv1 + frozen BN + ReLU + ceil-mode max-pool in one kernel.

    x `[B, H, W, 3]` f32 or bf16, contiguous; weight `[64, 3, 7, 7]`;
    scale/bias/mean/var `[64]`. Returns `[B, PH, PW, 64]` (NHWC) in `dtype`,
    the compute dtype: inputs and weights are rounded to it, sums are f32.
    Forward only: raises where autograd would need its gradient
    (`guards.forward_only`). `packed`: `packed_stem`'s operands, where the
    caller holds them."""
    forward_only("fused_stem", (x, weight, scale, bias, mean, var))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_stem: unsupported device {x.device}")
    if tuple(weight.shape) != (64, 3, 7, 7):
        raise ValueError(f"fused_stem: weight must be [64, 3, 7, 7], got {tuple(weight.shape)}")
    if dtype not in _DTYPES:
        raise ValueError(f"fused_stem: unsupported dtype {dtype}")
    with torch.no_grad():
        if packed is None:
            packed = packed_stem(weight, scale, bias, mean, var, dtype, x.device, eps)
        return torch.ops.rlod.stem(x, *packed, dtype)


fused_stem.launches = 0
