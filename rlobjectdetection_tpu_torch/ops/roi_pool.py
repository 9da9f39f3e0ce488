"""RoI max pooling, the `pool` mode, in plain PyTorch, forward and autograd
backward (counterpart of `rlobjectdetection_tpu/ops/roi_pool.py`, which is
XLA in JAX: there is no TPU kernel to port).

Each roi's corners are rounded half away from zero at feature scale
(`sign(x)·floor(|x|+0.5)`, the CUDA `round`, not `torch.round`'s half to
even: integer rois at odd multiples of 8 land on .5), its extent is forced
to at least 1×1, and cell (ph, pw) covers rows `[floor(ph·h/P),
ceil((ph+1)·h/P))` and the like for columns, offset by the roi's start and
clipped to the map. Empty cells, and cells whose max is at or below
`NEG_INF / 2`, are 0.

The per-cell windows become masked maxima over the whole W axis, then over
the whole H axis, each an `amax`, as the JAX function reduces: a reduction's
gradient splits a tie evenly among the tied elements, so a cell's gradient
splits evenly among its tied rows and each row's share among that row's
tied columns (features out of a ReLU tie at 0 over dead regions). The rois
go through in chunks of `chunk`; with a gradient to keep, each chunk is
recomputed in the backward (`torch.utils.checkpoint`), as `jax.checkpoint`
does there: one chunk's masked broadcast is `[chunk, H, PW, W, C]`.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _cround(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero, to int32."""
    return (torch.sign(x) * torch.floor(x.abs() + 0.5)).to(torch.int32)


class _Broadcast(torch.autograd.Function):
    """x unsqueezed at `dim` and expanded to `n` there; the backward sums the
    `n` slices one after another in index order, in the gradient's dtype,
    as XLA sums a broadcast's transpose (`Tensor.sum` orders its sums
    otherwise, which moves the last bit of a cell that overlaps others)."""

    @staticmethod
    def forward(ctx, x, dim, n):
        ctx.dim = dim
        shape = list(x.shape)
        shape.insert(dim, n)
        return x.unsqueeze(dim).expand(shape)

    @staticmethod
    def backward(ctx, grad):
        slices = grad.unbind(ctx.dim)
        acc = slices[0]
        for s in slices[1:]:
            acc = acc + s
        return acc, None, None


class _TakeRows(torch.autograd.Function):
    """`x.index_select(0, idx)`; the backward adds the rows' gradients into
    their sources one after another in index order, each add rounded to the
    gradient's dtype, as XLA's scatter-add does (`index_add_` sums bf16 in
    f32 on the CPU and with atomics on the card)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        acc = grad.new_zeros((ctx.rows,) + tuple(grad.shape[1:]))
        for i in range(idx.shape[0]):
            acc.index_add_(0, idx[i:i + 1], grad[i:i + 1])
        return acc, None


def _pool_chunk(features: torch.Tensor, rois: torch.Tensor, ph_n: int, pw_n: int,
                spatial_scale: float) -> torch.Tensor:
    _, h, w, _ = features.shape
    dev = features.device
    rs_w, rs_h, re_w, re_h = (_cround(rois[:, i] * spatial_scale) for i in (1, 2, 3, 4))
    roi_w = (re_w - rs_w + 1).clamp_min(1)
    roi_h = (re_h - rs_h + 1).clamp_min(1)
    # exact integer cell bounds; the ceil is the negated floor division of a
    # negative (// on int tensors is floor division)
    pidx_h = torch.arange(ph_n, dtype=torch.int32, device=dev)
    pidx_w = torch.arange(pw_n, dtype=torch.int32, device=dev)
    hstart = ((pidx_h[None] * roi_h[:, None]) // ph_n + rs_h[:, None]).clamp(0, h)
    hend = (-((-(pidx_h[None] + 1) * roi_h[:, None]) // ph_n) + rs_h[:, None]).clamp(0, h)
    wstart = ((pidx_w[None] * roi_w[:, None]) // pw_n + rs_w[:, None]).clamp(0, w)
    wend = (-((-(pidx_w[None] + 1) * roi_w[:, None]) // pw_n) + rs_w[:, None]).clamp(0, w)

    feat = _TakeRows.apply(features, rois[:, 0].to(torch.int64))      # [K, H, W, C]
    hh = torch.arange(h, device=dev)[None, None]
    mask_h = (hh >= hstart[:, :, None]) & (hh < hend[:, :, None])    # [K, PH, H]
    ww = torch.arange(w, device=dev)[None, None]
    mask_w = (ww >= wstart[:, :, None]) & (ww < wend[:, :, None])    # [K, PW, W]
    # W first: [K, H, PW, W, C] → [K, H, PW, C]; then H: [K, PH, H, PW, C] → [K, PH, PW, C]
    red_w = torch.where(mask_w[:, None, :, :, None], _Broadcast.apply(feat, 2, pw_n),
                        NEG_INF).amax(dim=3)
    out = torch.where(mask_h[:, :, :, None, None], _Broadcast.apply(red_w, 1, ph_n),
                      NEG_INF).amax(dim=2)
    empty = (hend <= hstart)[:, :, None, None] | (wend <= wstart)[:, None, :, None]
    return torch.where(empty | (out <= NEG_INF / 2), torch.zeros((), dtype=out.dtype,
                                                                  device=dev), out)


def roi_pool(features: torch.Tensor, rois: torch.Tensor, pooled_height: int = 7,
             pooled_width: int = 7, spatial_scale: float = 1.0 / 16.0,
             chunk: int = 16) -> torch.Tensor:
    """features `[B, H, W, C]` (NHWC); rois `[R, 5]` f32 (batch_idx, x1, y1,
    x2, y2). Returns `[R, pooled_height, pooled_width, C]` in the feature
    dtype; the features' gradient splits ties as the JAX function's does."""
    remat = torch.is_grad_enabled() and features.requires_grad
    outs = []
    for part in rois.split(chunk):
        if remat:
            outs.append(checkpoint(_pool_chunk, features, part, pooled_height, pooled_width,
                                   spatial_scale, use_reentrant=False, preserve_rng_state=False))
        else:
            outs.append(_pool_chunk(features, part, pooled_height, pooled_width,
                                    spatial_scale))
    if not outs:
        return features.new_zeros((0, pooled_height, pooled_width, features.shape[-1]))
    return torch.cat(outs).to(features.dtype)
