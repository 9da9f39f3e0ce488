"""Fused ResNet layer1: three frozen Bottleneck(64) blocks at stride 1,
64 → 256 channels, block0 with a 1×1 downsample shortcut.

Counterpart of `rlobjectdetection_tpu/ops/layer1_pallas.py::fused_layer1`.
BN is folded into the conv weights as in its `_pack_params` (f32 fold, then
one cast to the compute dtype); only the BN adds remain, kept in f32. The
packing is the residual stage's (`pack_res_stage` at width 64, weights
[N][K]), and so is the plain version. `fused_layer1` calls the op
`rlod::layer1` (`ops/library.py`): on a CUDA tensor it launches
`csrc/layer1.cu` once per block, on a CPU tensor it runs `layer1_plain`,
the same arithmetic in plain PyTorch, which is also what the kernel is
held against on the card. The packed weights are cached on the layer
module per dtype and device, and packed again only when a weight of the
layer changes; a caller that holds them passes them as `packed`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .guards import forward_only
from .pack_cache import cached_pack
from .res_stage_kernel import flat_blocks, pack_res_stage, packed_on, res_stage_plain

_DTYPES = (torch.float32, torch.bfloat16)


def pack_layer1(layer, dtype: torch.dtype, eps: float = 1e-5) -> list[dict]:
    """Kernel operands of each block of a layer1 module (`block0..2`, each
    with conv1..3 / bn1..3, block0 also downsample_conv / downsample_bn):
    w1 `[64, Cin]`, w2 `[9, 64, 64]` (tap, co, ci), w3 `[256, 64]`,
    wd `[256, Cin]` or None, in `dtype`; b1, b2, b3 in f32 (block0's b3
    includes the downsample BN's add)."""
    return pack_res_stage(layer, 3, 64, dtype, eps)


def layer1_plain(x: torch.Tensor, packed: list[dict], dtype: torch.dtype) -> torch.Tensor:
    """Plain version: x `[B, H, W, 64]` NHWC → `[B, H, W, 256]` in `dtype`,
    the residual stage's plain arithmetic."""
    return res_stage_plain(x, packed, dtype)


def packed_layer1(layer, dtype: torch.dtype, device, eps: float = 1e-5) -> list[dict]:
    """`pack_layer1` of `layer` on `device`, cached on the module."""
    return cached_pack(layer, "_layer1_packed", dtype, (eps, device),
                       [*layer.parameters(), *layer.buffers()],
                       lambda: packed_on(pack_layer1(layer, dtype, eps), device))


def _entry():
    fn = _build.load("layer1").rlod_layer1_block
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return fn


def launch_layer1(x: torch.Tensor, packed: list[dict], dtype: torch.dtype) -> torch.Tensor:
    """The three kernel launches on packed operands already on x's device:
    x `[B, H, W, 64]` CUDA NHWC in `dtype` → `[B, H, W, 256]`."""
    if (x.ndim != 4 or x.shape[-1] != 64 or x.dtype != dtype or dtype not in _DTYPES
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"fused_layer1: x must be a contiguous, 16-byte aligned "
                         f"[B, H, W, 64] tensor of dtype {dtype}, got {tuple(x.shape)} "
                         f"{x.dtype}")
    b, h, w, _ = x.shape
    fn = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for pk in packed:
        out = torch.empty((b, h, w, 256), dtype=dtype, device=x.device)
        wd = pk["wd"].data_ptr() if pk["wd"] is not None else None
        err = fn(x.data_ptr(), pk["w1"].data_ptr(), pk["b1"].data_ptr(),
                 pk["w2"].data_ptr(), pk["b2"].data_ptr(), pk["w3"].data_ptr(),
                 pk["b3"].data_ptr(), wd, out.data_ptr(), b, h, w, x.shape[-1],
                 _build.dtype_code(dtype), stream)
        _build.check(err, "layer1 kernel")
        fused_layer1.launches += 1
        x = out
    return x


def layer1_info(dtype: torch.dtype) -> dict:
    """Launch resources of block0's (cin 64) and blocks 1-2's (cin 256)
    kernels as the runtime reports them: registers a thread, shared memory
    bytes a CTA, CTAs an SM, spill bytes a thread."""
    fn = _build.load("layer1").rlod_layer1_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    res = {}
    for cin in (64, 256):
        buf = (ctypes.c_int * 4)()
        _build.check(fn(cin, _build.dtype_code(dtype), buf), "layer1 info")
        res[f"cin {cin}"] = dict(zip(("registers", "smem_bytes", "ctas_per_sm", "spill_bytes"),
                                     buf))
    return res


def fused_layer1(x: torch.Tensor, layer, *, dtype=torch.bfloat16,
                 eps: float = 1e-5, packed=None) -> torch.Tensor:
    """Run the frozen layer1 stage. x `[B, H, W, 64]` NHWC in `dtype` (the
    stem's output); layer: the module holding `block0..2`. Returns
    `[B, H, W, 256]` NHWC in `dtype`. Forward only: raises where autograd
    would need its gradient (`guards.forward_only`). `packed`:
    `packed_layer1`'s operands, where the caller holds them."""
    forward_only("fused_layer1", [x, *layer.parameters()])
    if dtype not in _DTYPES:
        raise ValueError(f"fused_layer1: unsupported dtype {dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_layer1: unsupported device {x.device}")
    with torch.no_grad():
        if packed is None:
            packed = packed_layer1(layer, dtype, x.device, eps)
        return torch.ops.rlod.layer1(x, flat_blocks(packed), dtype)


fused_layer1.launches = 0
