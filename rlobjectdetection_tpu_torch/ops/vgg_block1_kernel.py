"""Fused VGG-16 block 1: conv1_1 (3×3, pad 1, 3→64, bias) + ReLU + conv1_2
(3×3, pad 1, 64→64, bias) + ReLU + 2×2/2 max-pool (floor mode).

Counterpart of `rlobjectdetection_tpu/ops/vgg_stem_pallas.py::
fused_vgg_block1`. On a CUDA tensor `fused_vgg_block1` launches the
hand-written kernel `csrc/vgg_block1.cu`; on a CPU tensor it runs
`vgg_block1_plain`, the same function in plain PyTorch, which is also what
the kernel is held against on the card. The kernel's operands
(`pack_vgg_block1`) are cached on conv1_2's weight per dtype and device and
packed again only when one of the four source tensors changes.

Rounding points, the TPU kernel's: the image and the weights are rounded to
the compute dtype; conv1_1 sums in f32, adds its bias in f32, applies ReLU
and is rounded to the compute dtype; conv1_2 sums, adds its bias and applies
ReLU in f32; the 2×2 max is rounded to the compute dtype. conv1_2's zero
padding is literal: conv1_1 outputs outside the image are 0, not relu(b1).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .guards import forward_only
from .pack_cache import cached_pack
from .res_stage_kernel import swizzle128

_DTYPES = (torch.float32, torch.bfloat16)
CONV11_TAPS = 27   # conv1_1's K: taps (ky, kx, ci); the bf16 image pads it to 64 with zeros
VGG_KEYS = ("w", "w1", "w2", "b1", "b2")   # the op's operands (`rlod::vgg_block1`), in order


def vgg_block1_plain(x, w1, b1, w2, b2, *, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version. x `[B, H, W, 3]` (any float type); w1 `[64, 3, 3, 3]`,
    w2 `[64, 64, 3, 3]` (OIHW); b1, b2 `[64]`. Returns `[B, H/2, W/2, 64]`
    (NHWC) in `dtype`."""
    rnd = lambda t: t.to(dtype).float()
    xc = rnd(x).permute(0, 3, 1, 2)
    y1 = rnd(torch.relu(F.conv2d(xc, rnd(w1), b1.float(), padding=1)))
    y2 = torch.relu(F.conv2d(y1, rnd(w2), b2.float(), padding=1))
    return F.max_pool2d(y2, 2, 2).permute(0, 2, 3, 1).to(dtype).contiguous()


def pack_vgg_block1(w1, b1, w2, b2, dtype: torch.dtype) -> dict:
    """The kernel's operands, on the weights' device. bf16: `w` the weight
    image `[10, 4096]` bf16 the kernel copies into shared memory as it is:
    tiles 0-8 conv1_2 at tap ky·3 + kx (64 output × 64 input channels),
    tile 9 conv1_1 (64 output channels × K = 64, tap (ky, kx, ci) at
    ky·9 + kx·3 + ci, zero from 27 on), each `swizzle128`d (wgmma's
    128-byte-swizzled K-major layout). f32: `w1` `[27, 64]` (tap, output
    channel) and `w2` `[9, 64, 64]` (tap, input, output channel), the FMA
    kernel's coalesced rows. b1, b2: f32."""
    b1k, b2k = (v.float().contiguous() for v in (b1, b2))
    if dtype == torch.bfloat16:
        conv12 = w2.to(dtype).permute(2, 3, 0, 1).reshape(9, 64, 64)      # (tap, co, ci)
        conv11 = torch.zeros(1, 64, 64, dtype=dtype, device=w1.device)
        conv11[0, :, :CONV11_TAPS] = w1.to(dtype).permute(0, 2, 3, 1).reshape(64, CONV11_TAPS)
        image = swizzle128(torch.cat([conv12, conv11]))
        return dict(w=image.reshape(10, 64 * 64).contiguous(), b1=b1k, b2=b2k)
    return dict(w1=w1.float().permute(2, 3, 1, 0).reshape(CONV11_TAPS, 64).contiguous(),
                w2=w2.float().permute(2, 3, 1, 0).reshape(9, 64, 64).contiguous(),
                b1=b1k, b2=b2k)


def vgg_block1_plain_packed(x, packed: dict, dtype) -> torch.Tensor:
    """`vgg_block1_plain` on `pack_vgg_block1`'s operands: the bf16 image
    unswizzled (`swizzle128` is its own inverse) or the f32 rows, the same
    weights and the same arithmetic."""
    if packed.get("w") is not None:
        tiles = swizzle128(packed["w"].reshape(10, 64, 64))
        w2 = tiles[:9].reshape(3, 3, 64, 64).permute(2, 3, 0, 1)
        w1 = tiles[9][:, :CONV11_TAPS].reshape(64, 3, 3, 3).permute(0, 3, 1, 2)
    else:
        w1 = packed["w1"].reshape(3, 3, 3, 64).permute(3, 2, 0, 1)
        w2 = packed["w2"].reshape(3, 3, 64, 64).permute(3, 2, 0, 1)
    return vgg_block1_plain(x, w1.contiguous(), packed["b1"], w2.contiguous(), packed["b2"],
                            dtype=dtype)


def packed_vgg_block1(w1, b1, w2, b2, dtype: torch.dtype, device) -> dict:
    """`pack_vgg_block1` on `device`, cached on conv1_2's weight per dtype
    and keyed on all four tensors (`pack_cache.cached_pack`)."""
    src = (w1, b1, w2, b2)
    return cached_pack(w2, "_vgg_block1_packed", dtype, device, src,
                       lambda: {k: v.to(device) for k, v in
                                pack_vgg_block1(*src, dtype).items()})


def _entry():
    fn = _build.load("vgg_block1").rlod_vgg_block1_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


def _check_image(x: torch.Tensor) -> None:
    if x.ndim != 4 or x.shape[-1] != 3 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"fused_vgg_block1: x must be a contiguous [B, H, W, 3] f32/bf16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"fused_vgg_block1: H and W must be even, got {tuple(x.shape)}")


def launch_vgg_block1(x: torch.Tensor, packed: dict, dtype: torch.dtype) -> torch.Tensor:
    """One kernel launch on operands packed by `packed_vgg_block1` on x's
    device: x `[B, H, W, 3]` CUDA NHWC f32 or bf16, contiguous, 16-byte
    aligned, H and W even → `[B, H/2, W/2, 64]` in `dtype`."""
    _check_image(x)
    if x.data_ptr() % 16:
        raise ValueError("fused_vgg_block1: x must be 16-byte aligned")
    b, h, w, _ = x.shape
    out = torch.empty((b, h // 2, w // 2, 64), dtype=dtype, device=x.device)
    if dtype == torch.bfloat16:
        w1, w2 = None, packed["w"].data_ptr()
    else:
        w1, w2 = packed["w1"].data_ptr(), packed["w2"].data_ptr()
    err = _entry()(x.data_ptr(), _build.dtype_code(x.dtype), w1, packed["b1"].data_ptr(), w2,
                   packed["b2"].data_ptr(), out.data_ptr(), _build.dtype_code(dtype), b, h, w,
                   torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "vgg_block1 kernel")
    fused_vgg_block1.launches += 1
    return out


def vgg_block1_info(dtype: torch.dtype) -> dict:
    """Launch resources of the kernel for `dtype` (bf16: on an f32 image, as
    the main path runs it) as the runtime reports them: registers a thread,
    shared memory bytes a CTA, CTAs an SM, spill bytes a thread."""
    fn = _build.load("vgg_block1").rlod_vgg_block1_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    buf = (ctypes.c_int * 4)()
    _build.check(fn(_build.dtype_code(dtype), buf), "vgg_block1 info")
    return dict(zip(("registers", "smem_bytes", "ctas_per_sm", "spill_bytes"), buf))


def fused_vgg_block1(x, w1, b1, w2, b2, *, dtype=torch.bfloat16, packed=None) -> torch.Tensor:
    """conv1_1 + ReLU + conv1_2 + ReLU + 2×2 max-pool in one kernel.

    x `[B, H, W, 3]` f32 or bf16, contiguous, H and W even; w1
    `[64, 3, 3, 3]`, w2 `[64, 64, 3, 3]` (OIHW); b1, b2 `[64]`. Returns
    `[B, H/2, W/2, 64]` (NHWC) in `dtype`, the compute dtype. Forward only:
    raises where autograd would need its gradient (`guards.forward_only`).
    It runs as the op `rlod::vgg_block1` (`ops/library.py`): the kernel on
    a CUDA tensor, the plain version on a CPU tensor. `packed`:
    `packed_vgg_block1`'s operands, where the caller holds them."""
    forward_only("fused_vgg_block1", (x, w1, b1, w2, b2))
    _check_image(x)
    if tuple(w1.shape) != (64, 3, 3, 3) or tuple(w2.shape) != (64, 64, 3, 3):
        raise ValueError(f"fused_vgg_block1: weights must be [64, 3, 3, 3] and "
                         f"[64, 64, 3, 3], got {tuple(w1.shape)} {tuple(w2.shape)}")
    if dtype not in _DTYPES:
        raise ValueError(f"fused_vgg_block1: unsupported dtype {dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_vgg_block1: unsupported device {x.device}")
    with torch.no_grad():
        if packed is None:
            packed = packed_vgg_block1(w1, b1, w2, b2, dtype, x.device)
        return torch.ops.rlod.vgg_block1(x, [packed.get(k) for k in VGG_KEYS], dtype)


fused_vgg_block1.launches = 0
