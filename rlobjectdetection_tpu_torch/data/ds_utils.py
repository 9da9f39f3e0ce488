"""Box-list utilities (copy of the JAX package's `data/ds_utils.py`).

Deduplication is an exact row-wise unique on the quantized coordinates
(the upstream dot-product hash can collide for coordinates >= 1000); the
keep-sets are the same where the hash does not collide.
"""

from __future__ import annotations

import numpy as np


def unique_boxes(boxes: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Indices (ascending) of the first occurrence of each distinct box after
    quantizing coords with `round(x * scale)`."""
    quant = np.round(np.asarray(boxes, dtype=np.float64) * scale).astype(np.int64)
    _, first = np.unique(quant, axis=0, return_index=True)
    return np.sort(first)


def xywh_to_xyxy(boxes: np.ndarray) -> np.ndarray:
    """(x, y, w, h) → (x1, y1, x2, y2) under the +1 pixel-area convention."""
    b = np.asarray(boxes)
    xy = b[:, 0:2]
    return np.concatenate([xy, xy + b[:, 2:4] - 1], axis=1)


def xyxy_to_xywh(boxes: np.ndarray) -> np.ndarray:
    """(x1, y1, x2, y2) → (x, y, w, h) under the +1 pixel-area convention."""
    b = np.asarray(boxes)
    return np.concatenate([b[:, 0:2], b[:, 2:4] - b[:, 0:2] + 1], axis=1)


def validate_boxes(boxes: np.ndarray, width: int = 0, height: int = 0) -> None:
    """Assert every box is well-formed and inside a width×height image."""
    b = np.asarray(boxes).reshape(-1, 4)
    ok = (
        (b[:, 0:2] >= 0).all()
        and (b[:, 2:4] >= b[:, 0:2]).all()
        and (b[:, 2] < width).all()
        and (b[:, 3] < height).all()
    )
    assert ok, "boxes out of range or inverted"


def filter_small_boxes(boxes: np.ndarray, min_size: float) -> np.ndarray:
    """Indices of boxes at least min_size on both sides.

    The width test is inclusive (>=) while the height test is strict (>) —
    an upstream asymmetry (ds_utils.py:46-47) preserved deliberately so
    proposal keep-sets match; tests/test_data.py pins it.
    """
    b = np.asarray(boxes)
    wh = b[:, 2:4] - b[:, 0:2]
    return np.flatnonzero((wh[:, 0] >= min_size) & (wh[:, 1] > min_size))
