"""Losses of the port (counterpart of `rlobjectdetection_tpu/models/losses.py`):
the detector's smooth-L1 and masked cross-entropy, the RL net's weighted
MSE."""

from __future__ import annotations

import torch


def smooth_l1_loss(bbox_pred, bbox_targets, bbox_inside_weights, bbox_outside_weights,
                   sigma: float = 1.0, reduce_dims=(-1,)):
    """Smooth-L1 with the reference's σ and inside / outside weights: summed
    over `reduce_dims`, then the mean of the rest."""
    sigma_2 = sigma ** 2
    in_box_diff = bbox_inside_weights * (bbox_pred - bbox_targets)
    abs_in = in_box_diff.abs()
    sign = (abs_in < 1.0 / sigma_2).to(bbox_pred.dtype)
    in_loss = (in_box_diff ** 2) * (sigma_2 / 2.0) * sign + (abs_in - 0.5 / sigma_2) * (1.0 - sign)
    return (bbox_outside_weights * in_loss).sum(dim=tuple(reduce_dims)).mean()


def softmax_cross_entropy(logits, labels, valid_mask=None, denom=None):
    """Mean cross-entropy of `[..., C]` logits (log-softmax in f32) at int
    `labels` `[...]`; with `valid_mask` `[...]` bool, the mean over the
    valid entries (at least 1 in the denominator). `denom` replaces that
    count: a data-parallel rank passes its share of the global batch's
    (`parallel.distributed.GlobalBatch.count_share`)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if valid_mask is None:
        return -ll.mean()
    valid = valid_mask.float()
    return -(ll * valid).sum() / (valid.sum().clamp_min(1.0) if denom is None else denom)


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
