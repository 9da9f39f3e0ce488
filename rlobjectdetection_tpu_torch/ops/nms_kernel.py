"""Greedy NMS on the card: the CUDA implementation of `rlod::nms_sorted_mask`.

`launch_nms` takes what the op takes (boxes `[..., N, 4]` already sorted by
descending score, valid `[..., N]`, the threshold, the tile size of the
body's IoU form, `max_keep`), flattens the leading dimensions into lanes
and launches `csrc/nms.cu`: one launch where the C side needs no scratch
(N <= 512: suppression words in shared memory), two where it does (the
words in global scratch, then the walk in score order); `scratch_words`
asks it which. It never reads the card, except that with the span
recorder on (`utils/tracing.py`) it reads back how many candidates each
lane walked before its `max_keep` stop, for the counter `nms.walked`: one
blocking read a call, inside the `model.nms` span, which `nms.host_syncs`
(the body's counter) does not count.
Every call counts `nms.kernel_calls`; `launch_nms.launches` counts the
launches. The plain version is the op's body, `ops/nms.py::_nms_sorted_mask`.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import tracing
from . import _build

def _entry():
    fn = _build.load("nms").rlod_nms
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return fn


def scratch_words(lanes: int, n: int) -> int:
    """The 64-bit words of global scratch the kernel needs for `lanes`
    lanes of `n` boxes: 0 where it takes them in one launch, -1 where it
    cannot take that many lanes."""
    fn = _build.load("nms").rlod_nms_scratch_words
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    return fn(lanes, n)


def _check(boxes: torch.Tensor, valid: torch.Tensor, tile_size: int, max_keep) -> None:
    if boxes.device.type != "cuda":
        raise ValueError(f"nms kernel: unsupported device {boxes.device}")
    if (boxes.ndim < 2 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32
            or not boxes.is_contiguous()):
        raise ValueError(f"nms kernel: boxes must be a contiguous [..., N, 4] f32 tensor, got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    if (valid.shape != boxes.shape[:-1] or valid.dtype != torch.bool
            or valid.device != boxes.device or not valid.is_contiguous()):
        raise ValueError(f"nms kernel: valid must be a contiguous {tuple(boxes.shape[:-1])} "
                         f"bool tensor on {boxes.device}, got {tuple(valid.shape)} "
                         f"{valid.dtype} on {valid.device}")
    if tile_size < 1:
        raise ValueError(f"nms kernel: tile_size must be >= 1, got {tile_size}")
    if max_keep is not None and max_keep < 0:
        raise ValueError(f"nms kernel: max_keep must be None or >= 0, got {max_keep}")


def launch_nms(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
               tile_size: int, max_keep: int | None) -> torch.Tensor:
    """The keep mask `[..., N]` of `rlod::nms_sorted_mask` on CUDA tensors:
    boxes a contiguous `[..., N, 4]` f32 tensor, valid a contiguous
    `[..., N]` bool tensor on the same card. Raises on anything else."""
    with tracing.span("model.nms"):
        _check(boxes, valid, tile_size, max_keep)
        n = boxes.shape[-2]
        lanes = valid.numel() // n if n else 0
        keep = torch.empty(valid.shape, dtype=torch.bool, device=boxes.device)
        tracing.count("nms.kernel_calls")
        if lanes == 0:
            return keep
        if max_keep == 0:
            return keep.zero_()
        words = scratch_words(lanes, n)
        if words < 0:
            raise ValueError(f"nms kernel: too many lanes ({lanes}) of {n} boxes")
        mask = torch.empty(words, dtype=torch.int64, device=boxes.device) if words else None
        walked = (torch.empty(lanes, dtype=torch.int32, device=boxes.device)
                  if tracing.enabled() else None)
        err = _entry()(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                       None if mask is None else mask.data_ptr(),
                       None if walked is None else walked.data_ptr(), lanes, n,
                       float(iou_threshold), int(n <= 2 * tile_size),
                       -1 if max_keep is None else int(max_keep),
                       torch.cuda.current_stream(boxes.device).cuda_stream)
        _build.check(err, "nms kernel")
        launch_nms.launches += 1 if mask is None else 2
        if walked is not None:
            tracing.count("nms.walked", int(walked.sum()))
        return keep


def nms_info() -> dict:
    """Launch resources of the three kernels (small, mask, walk) as the
    runtime reports them: registers a thread, static shared memory bytes a
    CTA, spill bytes a thread."""
    fn = _build.load("nms").rlod_nms_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_int * 9)()
    _build.check(fn(buf), "nms info")
    keys = ("registers", "smem_bytes", "spill_bytes")
    return {k: dict(zip(keys, buf[3 * i:3 * i + 3]))
            for i, k in enumerate(("small", "mask", "walk"))}


launch_nms.launches = 0
