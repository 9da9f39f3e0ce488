"""Losses of the port (counterpart of `rlobjectdetection_tpu/models/losses.py`;
so far the RL net's only)."""

from __future__ import annotations

import torch


def weighted_mse_loss(pred, targets, weights, denom=None, row_mask=None):
    """RL action-value loss: mean((pred - t)² · w), and the unweighted mean
    for logging.

    `denom` replaces the element count of the mean: the collate pads the
    detection axis to a multiple of 16, the reference only to the exact
    batch max, so callers pass B · max_n · A. `row_mask` (`[rows]` bool)
    zeroes the padded rows out of the unweighted term as well (their weights
    are 0 already)."""
    noweight = (pred - targets) ** 2
    if row_mask is not None:
        noweight = noweight * row_mask[:, None].to(noweight.dtype)
    weighted = noweight * weights
    if denom is None:
        return weighted.mean(), noweight.mean()
    denom = torch.clamp(torch.as_tensor(denom, dtype=torch.float32), min=1.0)
    return weighted.sum() / denom, noweight.sum() / denom
