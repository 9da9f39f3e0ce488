"""RoIAlignAvg forward: (P+1)² single-sample RoIAlign + stride-1 2×2 mean.

Counterpart of `rlobjectdetection_tpu/ops/roi_align_pallas.py::
roi_align_fwd_pallas` + `roi_align_avg_pallas`. In eval every ALIGN_IMPL
computes this same forward, so on a CUDA tensor the port's RoIAlignAvg is
the hand-written kernel `csrc/roi_align.cu` whatever ALIGN_IMPL says; on a
CPU tensor it is the plain `ops/roi_align.py::roi_align_avg`. There is no
backward yet (ROADMAP §2 item 6): the serving path takes no gradient, and in
the RL net its input is the frozen trunk's output, so the wrapper raises
where autograd would need the features' gradient (`guards.forward_only`).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .guards import forward_only
from .roi_align import roi_align_avg as roi_align_avg_plain

_DTYPES = (torch.float32, torch.bfloat16)
POOLED_SIZE = 7  # the kernel's compile-time P (cfg.POOLING_SIZE)


def _entry():
    fn = _build.load("roi_align").rlod_roi_align_avg_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def roi_align_avg(features: torch.Tensor, rois: torch.Tensor, pooled_size: int = 7,
                  spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """features `[B, H, W, C]` NHWC f32/bf16, contiguous; rois `[R, 5]` f32
    (batch_idx, x1, y1, x2, y2), any image order. Returns `[R, P, P, C]` in
    the feature dtype (f32 weights and sums inside the kernel). Forward
    only: raises when grad is enabled and the features require grad."""
    forward_only("roi_align_avg", (features,))
    with torch.no_grad():
        if features.device.type == "cpu":
            return roi_align_avg_plain(features, rois, pooled_size, spatial_scale)
        if features.device.type != "cuda":
            raise ValueError(f"roi_align_avg: unsupported device {features.device}")
        if pooled_size != POOLED_SIZE:
            raise ValueError(f"roi_align_avg: the kernel is built for pooled_size "
                             f"{POOLED_SIZE}, got {pooled_size}")
        if features.ndim != 4 or features.dtype not in _DTYPES or not features.is_contiguous():
            raise ValueError(f"roi_align_avg: features must be a contiguous [B, H, W, C] "
                             f"f32/bf16 tensor, got {tuple(features.shape)} {features.dtype}")
        if (rois.ndim != 2 or rois.shape[1] != 5 or rois.dtype != torch.float32
                or rois.device != features.device or not rois.is_contiguous()):
            raise ValueError(f"roi_align_avg: rois must be a contiguous [R, 5] f32 tensor "
                             f"on {features.device}, got {tuple(rois.shape)} {rois.dtype} "
                             f"on {rois.device}")
        b, h, w, c = features.shape
        if h < 2 or w < 2:
            raise ValueError(f"roi_align_avg: feature map {h}x{w} is smaller than 2x2")
        r = rois.shape[0]
        out = torch.empty((r, pooled_size, pooled_size, c), dtype=features.dtype,
                          device=features.device)
        if r == 0:
            return out
        err = _entry()(features.data_ptr(), rois.data_ptr(), out.data_ptr(), r, b, h, w, c,
                       spatial_scale, _build.dtype_code(features.dtype),
                       torch.cuda.current_stream(features.device).cuda_stream)
        _build.check(err, "roi_align kernel")
        roi_align_avg.launches += 1
        return out


roi_align_avg.launches = 0
