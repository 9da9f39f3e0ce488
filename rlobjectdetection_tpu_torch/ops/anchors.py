"""Anchor generation (numpy copy of `rlobjectdetection_tpu/ops/anchors.py`).

Ratio enumeration then scale enumeration around a base_size² window with the
"+1 width" convention. Anchors are static given the config, so they are
computed once in numpy.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _generate_anchors_cached(base_size, ratios, scales) -> np.ndarray:
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    # integer (w, h) per ratio, rounded BEFORE scaling: every scaled anchor of
    # one ratio shares the same aspect quantization
    area = float(base_size) ** 2
    w_r = np.round(np.sqrt(area / ratios))
    h_r = np.round(w_r * ratios)
    # ratio-major, scale-minor
    ws = (w_r[:, None] * scales[None, :]).reshape(-1)
    hs = (h_r[:, None] * scales[None, :]).reshape(-1)
    ctr = (base_size - 1) / 2.0
    half_w = (ws - 1.0) / 2.0
    half_h = (hs - 1.0) / 2.0
    out = np.stack([ctr - half_w, ctr - half_h, ctr + half_w, ctr + half_h], axis=1)
    return out.astype(np.float32)


def generate_anchors(base_size: int = 16, ratios=(0.5, 1, 2), scales=(8, 16, 32)) -> np.ndarray:
    """[A, 4] base anchor windows (x1, y1, x2, y2)."""
    return _generate_anchors_cached(base_size, tuple(ratios), tuple(scales)).copy()


def shifted_anchors(feat_height: int, feat_width: int, feat_stride: int,
                    ratios=(0.5, 1, 2), scales=(8, 16, 32), base_size: int = 16) -> np.ndarray:
    """All anchors of a feature map, `[H*W*A, 4]` in flat (h, w, a) order:
    row-major over the grid, anchor-minor — the order of the RPN maps
    flattened from NHWC (models/rpn.py relies on it)."""
    base = generate_anchors(base_size, ratios=ratios, scales=scales)
    shift_x = np.arange(0, feat_width) * feat_stride
    shift_y = np.arange(0, feat_height) * feat_stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    all_anchors = base[None, :, :] + shifts[:, None, :].astype(np.float32)
    return all_anchors.reshape(-1, 4).astype(np.float32)


def pyramid_anchors(level_hw, strides, sizes, ratios=(0.5, 1, 2)) -> np.ndarray:
    """The anchors of a feature pyramid, `[Σ H·W·A, 4]`: level by level, each
    in (h, w, a) order, one size a level (`sizes[k]` pixels at
    `strides[k]`) and every ratio, built as `shifted_anchors` builds them
    with a base window of the level's stride (so centred on each cell, as
    the C4 model's are at stride 16)."""
    return np.concatenate([
        shifted_anchors(h, w, s, ratios=ratios, scales=(size / s,), base_size=s)
        for (h, w), s, size in zip(level_hw, strides, sizes)])
