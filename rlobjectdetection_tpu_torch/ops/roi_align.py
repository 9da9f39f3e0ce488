"""RoIAlign (single-sample bilinear) in plain PyTorch.

Port of `rlobjectdetection_tpu/ops/roi_align.py:26-104`. This flavour is not
Detectron's 4-sample align: each cell takes ONE bilinear sample at
(p·bin_h + y1, q·bin_w + x1) with bin sizes over (A-1), corner starts clamped
to H-2 / W-2, and cells whose sample falls outside [0, H) × [0, W) set to 0.
RoIAlignAvg runs align at (P+1)² then a stride-1 2×2 mean, RoIAlignMax a
2×2 max.

Features are NHWC, so each of the four corner fetches is a gather of whole
C-rows. This module holds the plain versions the CUDA kernels
(`roi_align_kernel.py`) are held against, forward and backward; they are
what runs on CPU tensors.
"""

from __future__ import annotations

import torch


def roi_align_coords(rois: torch.Tensor, h: int, w: int, ah: int, aw: int,
                     spatial_scale: float):
    """Sample-point geometry: batch index, corner row/col, bilinear ratios and
    the inside-image mask (all f32 math, as the JAX `roi_align_coords`)."""
    batch_idx = rois[:, 0].to(torch.int32)
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale
    roi_w = (x2 - x1 + 1.0).clamp_min(0.0)
    roi_h = (y2 - y1 + 1.0).clamp_min(0.0)
    bin_h = roi_h / (ah - 1.0)
    bin_w = roi_w / (aw - 1.0)
    grid_h = torch.arange(ah, dtype=torch.float32, device=rois.device)
    grid_w = torch.arange(aw, dtype=torch.float32, device=rois.device)
    ys = grid_h[None, :] * bin_h[:, None] + y1[:, None]
    xs = grid_w[None, :] * bin_w[:, None] + x1[:, None]
    hstart = torch.clamp_max(torch.floor(ys), h - 2.0)
    wstart = torch.clamp_max(torch.floor(xs), w - 2.0)
    h_ratio = ys - hstart                                     # [R, AH]
    w_ratio = xs - wstart                                     # [R, AW]
    inside = (((ys >= 0) & (ys < h))[:, :, None]
              & ((xs >= 0) & (xs < w))[:, None, :])           # [R, AH, AW]
    hs = hstart.to(torch.int32).clamp(0, h - 2)
    ws_ = wstart.to(torch.int32).clamp(0, w - 2)
    return batch_idx, hs, ws_, h_ratio, w_ratio, inside


def roi_align(features: torch.Tensor, rois: torch.Tensor, aligned_height: int = 7,
              aligned_width: int = 7, spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """features `[B, H, W, C]` (NHWC); rois `[R, 5]` (batch_idx, x1, y1, x2, y2).
    Returns `[R, aligned_height, aligned_width, C]` in the feature dtype."""
    b, h, w, c = features.shape
    r = rois.shape[0]
    ah, aw = aligned_height, aligned_width
    batch_idx, hs, ws_, h_ratio, w_ratio, inside = roi_align_coords(
        rois, h, w, ah, aw, spatial_scale)
    flat = features.reshape(b * h * w, c)
    base = (batch_idx * h)[:, None] + hs                      # [R, AH]
    idx_ul = (base[:, :, None] * w + ws_[:, None, :]).long().reshape(-1)

    def gather(offset):
        return flat.index_select(0, idx_ul + offset).reshape(r, ah, aw, c)

    # weights in f32, cast once to the feature dtype; the products and sums
    # run in the feature dtype, as in the JAX path
    dt = features.dtype
    hr = h_ratio[:, :, None, None]
    wr = w_ratio[:, None, :, None]
    out = (gather(0) * ((1.0 - hr) * (1.0 - wr)).to(dt)
           + gather(1) * ((1.0 - hr) * wr).to(dt)
           + gather(w) * (hr * (1.0 - wr)).to(dt)
           + gather(w + 1) * (hr * wr).to(dt))
    return torch.where(inside[..., None], out, torch.zeros((), dtype=dt, device=out.device))


def roi_align_avg(features: torch.Tensor, rois: torch.Tensor, pooled_size: int = 7,
                  spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """RoIAlignAvg: (P+1)² align then stride-1 2×2 mean → `[R, P, P, C]`."""
    x = roi_align(features, rois, pooled_size + 1, pooled_size + 1, spatial_scale)
    return 0.25 * (x[:, :-1, :-1] + x[:, :-1, 1:] + x[:, 1:, :-1] + x[:, 1:, 1:])


def roi_align_max(features: torch.Tensor, rois: torch.Tensor, pooled_size: int = 7,
                  spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """RoIAlignMax: (P+1)² align then stride-1 2×2 max → `[R, P, P, C]`, as
    nested maxima in the JAX order. `torch.maximum` splits a tie's gradient
    in halves, as `jnp.maximum` does. The detector does not call it."""
    x = roi_align(features, rois, pooled_size + 1, pooled_size + 1, spatial_scale)
    return torch.maximum(torch.maximum(x[:, :-1, :-1], x[:, :-1, 1:]),
                         torch.maximum(x[:, 1:, :-1], x[:, 1:, 1:]))


def roi_align_avg_backward(grad: torch.Tensor, rois: torch.Tensor, feat_shape,
                           dtype: torch.dtype, spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """The features' gradient of `roi_align_avg`: grad `[R, P, P, C]`, rois
    `[R, 5]`, feat_shape (B, H, W, C) → `[B, H, W, C]` in `dtype`.

    As JAX `roi_align_avg_cvjp` (its `_bwd` behind the 2×2 mean): the mean
    spreads each pooled cell's gradient ¼ to its four samples; samples
    outside the image get zero; each sample adds its gradient times its four
    bilinear weights into its four corners. The sums run in f32 and are cast
    once to `dtype`. The rois get no gradient."""
    b, h, w, c = feat_shape
    r, p = grad.shape[0], grad.shape[1]
    a = p + 1
    g = 0.25 * grad.float()
    gs = torch.zeros((r, a, a, c), dtype=torch.float32, device=grad.device)
    for dy in (0, 1):
        for dx in (0, 1):
            gs[:, dy:dy + p, dx:dx + p] += g
    batch_idx, hs, ws_, h_ratio, w_ratio, inside = roi_align_coords(rois, h, w, a, a,
                                                                    spatial_scale)
    gs = torch.where(inside[..., None], gs, torch.zeros((), device=gs.device))
    hr = h_ratio[:, :, None, None]
    wr = w_ratio[:, None, :, None]
    base = (batch_idx * h)[:, None] + hs
    idx_ul = (base[:, :, None] * w + ws_[:, None, :]).long().reshape(-1)
    flat = torch.zeros((b * h * w, c), dtype=torch.float32, device=grad.device)
    for offset, weight in ((0, (1.0 - hr) * (1.0 - wr)), (1, (1.0 - hr) * wr),
                           (w, hr * (1.0 - wr)), (w + 1, hr * wr)):
        flat.index_add_(0, idx_ul + offset, (weight * gs).reshape(-1, c))
    return flat.reshape(b, h, w, c).to(dtype)
