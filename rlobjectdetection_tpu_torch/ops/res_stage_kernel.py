"""Fused ResNet residual stage (layer2 / layer3): a frozen chain of
caffe-flavour bottlenecks on an already-strided NHWC input, BN folded.

Counterpart of `rlobjectdetection_tpu/ops/res_stage_pallas.py::
fused_res_stage`. The caller passes `x[:, ::2, ::2, :]` for a stride-2 stage:
the stride sits on block0's 1×1 conv1 and downsample, which read only the
even-coordinate grid, so every block works on the output grid. On a CUDA
tensor `fused_res_stage` launches `csrc/res_stage.cu` once per block (bf16:
the wgmma kernel, a cluster of two CTAs an 8×8 tile; f32: the FMA kernel);
on a CPU tensor it runs `res_stage_plain`, the same arithmetic in plain
PyTorch, which is also what the kernel is held against on the card.

Packing (`pack_res_stage`): each BN's mul is folded into its conv in f32,
then cast once to the compute dtype; the adds stay in f32, block0's conv3
add carrying the downsample's. Weights are [N][K] (output channel, input
channel): w1 `[w, Cin]`, w2 `[9, w, w]` (tap, co, ci), w3 `[4w, w]`, wd
`[4w, Cin]`; the f32 kernel reads them so. The bf16 kernel reads
`pack_res_stage_stream` of them: each CTA's weights as the byte image of the
shared-memory stages it streams, in the order it consumes them. The trunk
is frozen wherever this runs, so `packed_res_stage` caches the packed
operands on the stage module per dtype and device, and packs again only
when a weight of the stage changes; `launch_res_stage` runs the kernels on
them.

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
from .guards import forward_only
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


BLOCK_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3", "wd", "stream")


def flat_blocks(packed: list[dict]) -> list:
    """A stage's packed blocks (`pack_res_stage`'s dicts) as the ops' flat
    `Tensor?[]` (`rlod::layer1`, `rlod::res_stage`): BLOCK_KEYS of each
    block in order, None where absent."""
    return [pk.get(k) for pk in packed for k in BLOCK_KEYS]


def blocks_of(flat) -> list[dict]:
    """`flat_blocks`' inverse."""
    n = len(BLOCK_KEYS)
    return [dict(zip(BLOCK_KEYS, flat[i:i + n])) for i in range(0, len(flat), n)]


def packed_on(packed: list[dict], device) -> list[dict]:
    """Each block's packed operands moved to `device`."""
    return [{k: None if v is None else v.to(device) for k, v in pk.items()} for pk in packed]


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


STAGE_ROWS = STAGE_K = 64   # a weight stage of the bf16 kernel: 64 output x 64 input channels


def stream_stages(width: int, cin: int, down: bool) -> int:
    """Weight stages a CTA of the bf16 kernel streams for one block
    (`stream_stages` in csrc/res_stage.cu)."""
    k1, k = cin // STAGE_K, width // STAGE_K
    return k1 * (width // 128) + 9 * k * (width // 128) + k * 2 * (k + (k1 if down else 0))


def _tiles(w: torch.Tensor) -> torch.Tensor:
    """[..., N, K] → [..., N/64, K/64, 64, 64]: the 64×64 blocks of w."""
    *lead, n, k = w.shape
    return w.reshape(*lead, n // STAGE_ROWS, STAGE_ROWS, k // STAGE_K, STAGE_K).transpose(-3, -2)


def swizzle128(tiles: torch.Tensor) -> torch.Tensor:
    """[..., 64, 64] (row n, k) tiles of bf16 → wgmma's 128-byte-swizzled
    K-major image: row n at 128 bytes a row, its 16-byte chunk c (k // 8) at
    chunk c ^ (n % 8)."""
    n = torch.arange(STAGE_ROWS, device=tiles.device)[:, None]
    src = torch.arange(8, device=tiles.device)[None, :] ^ (n % 8)   # chunk stored at j
    chunks = tiles.reshape(*tiles.shape[:-1], 8, 8)
    idx = src[..., None].expand(STAGE_ROWS, 8, 8).expand_as(chunks)
    return torch.gather(chunks, -2, idx).reshape(tiles.shape)


def pack_res_stage_stream(pk: dict, width: int) -> torch.Tensor:
    """The bf16 kernel's weight image of one block, from `pack_res_stage`'s
    bf16 [N][K] weights: `[2, stages, 4096]` bf16, CTA r's stages in the
    order it consumes them (csrc/res_stage.cu `stream_stages`), each
    `swizzle128`d. CTA r computes conv1/conv2 channels r·w/2 .. and conv3
    channels r·2w ..:
      conv1: for each 64-wide k slice of Cin, its w/128 stages of channels;
      conv2: for each tap and k slice of w, its w/128 stages;
      conv3: for each pass of 128 channels, each k slice of w (then of Cin
             for the downsample), the pass's two stages."""
    w1, w2, w3, wd = pk["w1"], pk["w2"], pk["w3"], pk["wd"]
    cin, wh, c3 = w1.shape[1], width // 2, 2 * width
    if width % 128 or cin % STAGE_K:
        raise ValueError(f"pack_res_stage_stream: width {width} must be a multiple of 128 and "
                         f"Cin {cin} of {STAGE_K}")
    ranks = []
    for r in range(2):
        half, mine = slice(r * wh, (r + 1) * wh), slice(r * c3, (r + 1) * c3)
        conv1 = _tiles(w1[half]).transpose(0, 1)                       # (k slice, stage)
        conv2 = _tiles(w2[:, half]).transpose(1, 2)                    # (tap, k slice, stage)
        conv3 = [_tiles(w3[mine]).reshape(c3 // 128, 2, width // STAGE_K, 64, 64)]
        if wd is not None:
            conv3.append(_tiles(wd[mine]).reshape(c3 // 128, 2, cin // STAGE_K, 64, 64))
        conv3 = torch.cat([t.transpose(1, 2) for t in conv3], 1)       # (pass, k slice, stage)
        ranks.append(torch.cat([t.reshape(-1, 64, 64) for t in (conv1, conv2, conv3)]))
    image = swizzle128(torch.stack(ranks))
    assert image.shape[1] == stream_stages(width, cin, wd is not None)
    return image.reshape(2, -1, STAGE_ROWS * STAGE_K).contiguous()


def packed_res_stage(layer, blocks: int, width: int, dtype: torch.dtype, device,
                     eps: float = 1e-5) -> list[dict]:
    """`pack_res_stage` of `layer` on `device`, cached on the module per
    dtype (`pack_cache.cached_pack`); on a CUDA device in bf16 each block
    also carries its kernel's weight image, `stream`."""
    device = torch.device(device)

    def pack():
        packed = pack_res_stage(layer, blocks, width, dtype, eps)
        if dtype == torch.bfloat16 and device.type == "cuda":
            for pk in packed:
                pk["stream"] = pack_res_stage_stream(pk, width)
        return packed_on(packed, device)

    return cached_pack(layer, "_res_stage_packed", dtype, (blocks, width, eps, device),
                       [*layer.parameters(), *layer.buffers()], pack)


def _entry(dtype: torch.dtype):
    lib = _build.load("res_stage")
    if dtype == torch.bfloat16:
        fn = lib.rlod_res_stage_block_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
    else:
        fn = lib.rlod_res_stage_block_f32
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_res_stage(x: torch.Tensor, packed: list[dict], dtype: torch.dtype) -> torch.Tensor:
    """The kernel launches of a stage, one a block, on operands packed by
    `packed_res_stage` on x's device: x `[B, Ho, Wo, Cin]` CUDA NHWC in
    `dtype` → `[B, Ho, Wo, 4w]`."""
    width, cin = packed[0]["w1"].shape
    if (x.ndim != 4 or x.shape[-1] != cin or x.dtype != dtype or dtype not in _DTYPES
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"fused_res_stage: x must be a contiguous, 16-byte aligned "
                         f"[B, Ho, Wo, {cin}] tensor of dtype {dtype}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    k_align = STAGE_K if dtype == torch.bfloat16 else 16
    if width not in KERNEL_WIDTHS or cin % k_align:
        raise ValueError(f"fused_res_stage: the {dtype} kernel takes widths {KERNEL_WIDTHS} "
                         f"and input channels a multiple of {k_align}, got {width}, {cin}")
    b, h, w, _ = x.shape
    fn = _entry(dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bufs = [torch.empty((b, h, w, 4 * width), dtype=dtype, device=x.device)
            for _ in range(min(2, len(packed)))]
    for i, pk in enumerate(packed):
        out = bufs[i % 2]
        down = pk["wd"] is not None
        if dtype == torch.bfloat16:
            err = fn(x.data_ptr(), pk["stream"].data_ptr(), pk["b1"].data_ptr(),
                     pk["b2"].data_ptr(), pk["b3"].data_ptr(), int(down), out.data_ptr(), b, h,
                     w, x.shape[-1], width, stream)
        else:
            err = fn(x.data_ptr(), pk["w1"].data_ptr(), pk["b1"].data_ptr(),
                     pk["w2"].data_ptr(), pk["b2"].data_ptr(), pk["w3"].data_ptr(),
                     pk["b3"].data_ptr(), pk["wd"].data_ptr() if down else None,
                     out.data_ptr(), b, h, w, x.shape[-1], width, stream)
        _build.check(err, "res_stage kernel")
        fused_res_stage.launches += 1
        x = out
    return x


# (width, Ho, Wo) of layer2 and layer3 on an 800×1216 image
MAIN_PATH_SHAPES = {"layer2": (128, 100, 152), "layer3": (256, 50, 76)}


def res_stage_info(dtype: torch.dtype) -> dict:
    """Launch resources of block0's and the identity blocks' kernels of
    layer2 and layer3 as the runtime reports them (registers a thread,
    shared memory bytes a CTA, CTAs an SM, spill bytes a thread), with the
    grid at the main path's shapes at batch 1, the CTAs a cluster and the
    CTAs the card runs at once."""
    fn = _build.load("res_stage").rlod_res_stage_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    keys = ("registers", "smem_bytes", "ctas_per_sm", "spill_bytes")
    res = {}
    for name, (width, ho, wo) in MAIN_PATH_SHAPES.items():
        for down, blocks in ((1, "block0"), (0, "blocks 1+")):
            buf = (ctypes.c_int * 9)()
            _build.check(fn(width, down, _build.dtype_code(dtype), 1, ho, wo, buf),
                         "res_stage info")
            res[f"{name} {blocks}"] = dict(zip(keys, buf[:4]), grid=tuple(buf[4:7]),
                                           cluster=buf[7], ctas_at_once=buf[8])
    return res


def fused_res_stage(x: torch.Tensor, layer, *, blocks: int, width: int,
                    dtype: torch.dtype = torch.bfloat16, eps: float = 1e-5,
                    packed=None) -> torch.Tensor:
    """Run a frozen residual stage on an ALREADY-STRIDED NHWC input.

    x `[B, Ho, Wo, Cin]` in `dtype`; layer: the module holding
    `block0..block{blocks-1}` of width `width`. Returns `[B, Ho, Wo, 4*width]`
    NHWC in `dtype`. Forward only, as the TPU kernel is: it raises where
    autograd would need its gradient (grad enabled and `x` or a weight of the
    stage requires grad). It runs as the op `rlod::res_stage`
    (`ops/library.py`): the kernel on a CUDA tensor, `res_stage_plain` on a
    CPU tensor. `packed`: `packed_res_stage`'s operands, where the caller
    holds them."""
    forward_only("fused_res_stage", [x, *layer.parameters()])
    if dtype not in _DTYPES:
        raise ValueError(f"fused_res_stage: unsupported dtype {dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_res_stage: unsupported device {x.device}")
    with torch.no_grad():
        if packed is None:
            packed = packed_res_stage(layer, blocks, width, dtype, x.device, eps)
        return torch.ops.rlod.res_stage(x, flat_blocks(packed), dtype)


fused_res_stage.launches = 0
