"""RoIAlignAvg, forward and backward: (P+1)² single-sample RoIAlign + stride-1
2×2 mean, and the features' gradient.

Counterpart of `rlobjectdetection_tpu/ops/roi_align_pallas.py::
roi_align_fwd_pallas` + `roi_align_avg_pallas` (forward) and of
`ops/roi_align_vjp.py::roi_align_avg_cvjp`'s backward (XLA in JAX). Every
ALIGN_IMPL computes this same function, so on a CUDA tensor the port's
RoIAlignAvg is the hand-written kernels of `csrc/roi_align.cu` whatever
ALIGN_IMPL says; on a CPU tensor it is the plain `ops/roi_align.py`
versions. `roi_align_avg` is an autograd Function: the forward kernel, then
`roi_align_avg_bwd` for the features' gradient; the rois take none. Each
counts its own launches (`roi_align_avg.launches`, `roi_align_avg_bwd.launches`).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .roi_align import roi_align_avg as roi_align_avg_plain
from .roi_align import roi_align_avg_backward

_DTYPES = (torch.float32, torch.bfloat16)
POOLED_SIZE = 7  # the kernels' compile-time P (cfg.POOLING_SIZE)


def _entry(name: str, n_ptrs: int):
    fn = getattr(_build.load("roi_align"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _check_cuda(op: str, features_like: torch.Tensor, rois: torch.Tensor, pooled_size: int):
    if features_like.device.type != "cuda":
        raise ValueError(f"{op}: unsupported device {features_like.device}")
    if pooled_size != POOLED_SIZE:
        raise ValueError(f"{op}: the kernel is built for pooled_size {POOLED_SIZE}, got "
                         f"{pooled_size}")
    if (rois.ndim != 2 or rois.shape[1] != 5 or rois.dtype != torch.float32
            or rois.device != features_like.device or not rois.is_contiguous()):
        raise ValueError(f"{op}: rois must be a contiguous [R, 5] f32 tensor on "
                         f"{features_like.device}, got {tuple(rois.shape)} {rois.dtype} on "
                         f"{rois.device}")


def _forward(features: torch.Tensor, rois: torch.Tensor, pooled_size: int,
             spatial_scale: float) -> torch.Tensor:
    """The forward kernel (plain version on a CPU tensor), no gradient."""
    with torch.no_grad():
        if features.device.type == "cpu":
            return roi_align_avg_plain(features, rois, pooled_size, spatial_scale)
        _check_cuda("roi_align_avg", features, rois, pooled_size)
        if features.ndim != 4 or features.dtype not in _DTYPES or not features.is_contiguous():
            raise ValueError(f"roi_align_avg: features must be a contiguous [B, H, W, C] "
                             f"f32/bf16 tensor, got {tuple(features.shape)} {features.dtype}")
        b, h, w, c = features.shape
        if h < 2 or w < 2:
            raise ValueError(f"roi_align_avg: feature map {h}x{w} is smaller than 2x2")
        r = rois.shape[0]
        out = torch.empty((r, pooled_size, pooled_size, c), dtype=features.dtype,
                          device=features.device)
        if r == 0:
            return out
        err = _entry("rlod_roi_align_avg_fwd", 3)(
            features.data_ptr(), rois.data_ptr(), out.data_ptr(), r, b, h, w, c, spatial_scale,
            _build.dtype_code(features.dtype),
            torch.cuda.current_stream(features.device).cuda_stream)
        _build.check(err, "roi_align kernel")
        roi_align_avg.launches += 1
        return out


def roi_align_avg_bwd(grad: torch.Tensor, rois: torch.Tensor, feat_shape,
                      spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """The backward kernel (plain `roi_align_avg_backward` on a CPU tensor):
    grad `[R, P, P, C]` f32/bf16 contiguous, rois `[R, 5]` as the forward's,
    feat_shape (B, H, W, C) → d features `[B, H, W, C]` in grad's dtype.
    f32 atomic sums into a zeroed f32 scratch, so their order, and the last
    bits of the result, vary from run to run."""
    with torch.no_grad():
        if grad.device.type == "cpu":
            return roi_align_avg_backward(grad, rois, feat_shape, grad.dtype, spatial_scale)
        p = grad.shape[1] if grad.ndim == 4 else -1
        _check_cuda("roi_align_avg backward", grad, rois, p)
        b, h, w, c = feat_shape
        if (grad.ndim != 4 or tuple(grad.shape) != (rois.shape[0], p, p, c)
                or grad.dtype not in _DTYPES or not grad.is_contiguous()):
            raise ValueError(f"roi_align_avg backward: grad must be a contiguous "
                             f"[{rois.shape[0]}, {p}, {p}, {c}] f32/bf16 tensor, got "
                             f"{tuple(grad.shape)} {grad.dtype}")
        if h < 2 or w < 2:
            raise ValueError(f"roi_align_avg backward: feature map {h}x{w} is smaller than 2x2")
        scratch = torch.empty((b, h, w, c), dtype=torch.float32, device=grad.device)
        out = scratch if grad.dtype == torch.float32 else torch.empty_like(scratch,
                                                                           dtype=grad.dtype)
        err = _entry("rlod_roi_align_avg_bwd", 4)(
            grad.data_ptr(), rois.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            rois.shape[0], b, h, w, c, spatial_scale, _build.dtype_code(grad.dtype),
            torch.cuda.current_stream(grad.device).cuda_stream)
        _build.check(err, "roi_align backward kernel")
        roi_align_avg_bwd.launches += 1
        return out


class _RoIAlignAvg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, rois, pooled_size, spatial_scale):
        ctx.save_for_backward(rois)
        ctx.feat_shape = tuple(features.shape)
        ctx.spatial_scale = spatial_scale
        return _forward(features, rois, pooled_size, spatial_scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (rois,) = ctx.saved_tensors
        dfeat = roi_align_avg_bwd(grad.contiguous(), rois, ctx.feat_shape, ctx.spatial_scale)
        return dfeat, None, None, None


def roi_align_avg(features: torch.Tensor, rois: torch.Tensor, pooled_size: int = 7,
                  spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """features `[B, H, W, C]` NHWC f32/bf16, contiguous; rois `[R, 5]` f32
    (batch_idx, x1, y1, x2, y2), any image order. Returns `[R, P, P, C]` in
    the feature dtype (f32 weights and sums inside the kernel). The features'
    gradient comes from `roi_align_avg_bwd`; the rois take none. The kernels
    run on CUDA tensors, the plain versions on CPU tensors."""
    return _RoIAlignAvg.apply(features, rois, pooled_size, spatial_scale)


roi_align_avg.launches = 0
roi_align_avg_bwd.launches = 0
