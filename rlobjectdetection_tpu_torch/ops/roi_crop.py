"""RoI crop, the `crop` mode: a uniform grid × grid lattice of bilinear
samples spanning each roi corner to corner in feature coordinates, then
(with `max_pool`) a stride-2 2×2 max. Plain PyTorch, forward and autograd
backward (counterpart of `rlobjectdetection_tpu/ops/roi_crop.py`, which is
XLA in JAX: there is no TPU kernel to port).

As the JAX function: a corner outside the image contributes 0, its index
clipped into the map before the gather; the corner weights are f32 and
promote the gathered values, and the sum is cast once to the feature dtype;
the lattice is `jnp.linspace(0, 1, grid)` to the bit (`crop_lattice`); the
2×2 max is an `amax`, whose gradient splits a tie evenly as `max(axis=(2,
4))` does (out-of-image samples tie at exactly 0).
"""

from __future__ import annotations

import torch


def crop_lattice(grid_size: int, device=None) -> torch.Tensor:
    """`jnp.linspace(0., 1., grid_size)` bit for bit: XLA computes `i / (g-1)`
    as `i · f32(1 / (g-1))` and appends 1.0 (`torch.linspace` computes its
    second half from the end and differs)."""
    if grid_size == 1:
        return torch.zeros(1, device=device)
    step = torch.ones((), device=device) / (grid_size - 1)           # f32 division
    i = torch.arange(grid_size - 1, dtype=torch.float32, device=device)
    return torch.cat([i * step, torch.ones(1, device=device)])


def bilinear_sample(features: torch.Tensor, batch_idx: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """features `[B, H, W, C]`; batch_idx `[R]` int; ys, xs `[R, ...]` f32
    pixel coordinates → `[R, ..., C]` in the feature dtype, zero outside."""
    b, h, w, c = features.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    flat = features.reshape(b * h * w, c)
    bi = batch_idx.to(torch.int64).reshape((-1,) + (1,) * (ys.ndim - 1))
    zero = torch.zeros((), dtype=features.dtype, device=features.device)

    def corner(dy, dx):
        yy, xx = y0i + dy, x0i + dx
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = (bi * h + yy.clamp(0, h - 1)) * w + xx.clamp(0, w - 1)
        g = flat.index_select(0, idx.reshape(-1)).reshape(idx.shape + (c,))
        return torch.where(ok[..., None], g, zero)

    out = (corner(0, 0) * ((1 - wy) * (1 - wx))[..., None]
           + corner(0, 1) * ((1 - wy) * wx)[..., None]
           + corner(1, 0) * (wy * (1 - wx))[..., None]
           + corner(1, 1) * (wy * wx)[..., None])
    return out.to(features.dtype)


def roi_crop(features: torch.Tensor, rois: torch.Tensor, grid_size: int = 14,
             spatial_scale: float = 1.0 / 16.0, max_pool: bool = True) -> torch.Tensor:
    """features `[B, H, W, C]`; rois `[R, 5]` f32 (batch_idx, x1, y1, x2, y2).
    Returns `[R, g/2, g/2, C]` with `max_pool`, else `[R, g, g, C]`, in the
    feature dtype."""
    r = rois.shape[0]
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale for i in (1, 2, 3, 4))
    lin = crop_lattice(grid_size, rois.device)
    ys = y1[:, None, None] + (y2 - y1)[:, None, None] * lin[None, :, None]
    xs = x1[:, None, None] + (x2 - x1)[:, None, None] * lin[None, None, :]
    shape = (r, grid_size, grid_size)
    out = bilinear_sample(features, rois[:, 0].to(torch.int32), ys.expand(shape),
                          xs.expand(shape))
    if max_pool:
        g2 = grid_size // 2
        out = out.reshape(r, g2, 2, g2, 2, -1).amax(dim=(2, 4))
    return out
