"""Target assignment of the train forward (counterpart of
`rlobjectdetection_tpu/models/targets.py`): anchor labels and regression
targets for the RPN, sampled rois and their targets for the R-CNN head.
Fixed shapes and masks throughout, batched over images, no gradient.

Random draws come from an explicit source, a `Uniform`: a callable that
takes a shape and returns f32 uniforms in [0, 1) of that shape on the
targets' device. `uniform_source(generator, device)` makes one from a
`torch.Generator`; a test may pass its own (a replay of the JAX package's
draws). The draws, in order: anchor_target's fg and bg priorities
`[B, N]` (row i is image i's `_random_keep` uniforms), then
proposal_target's fg priorities `[B, P+G]` and slot uniforms `[B, R]`.
Fed the same uniforms as the JAX functions, these give the same labels,
rois and keep indices.

The JAX module's quirks are kept: the inside-image bounds come from
`im_info[0]` for the whole batch; the bg budget counts the fg anchors before
their subsampling; fg rois are drawn without replacement when both pools
exist and bg rois with replacement; an image with neither pool falls back to
candidate 0 as bg; gt boxes join the candidates; targets are normalised by
the precomputed means and stds.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..device import pageable_to
from ..ops.anchors import shifted_anchors
from ..ops.boxes import bbox_overlaps_masked, bbox_transform

BIG_NEG = -1e9

Uniform = Callable[[tuple], torch.Tensor]


def uniform_source(generator: torch.Generator | Uniform, device) -> Uniform:
    """The draw source: a Generator's `torch.rand` on `device`, or `generator`
    itself when it is already a callable source."""
    if isinstance(generator, torch.Generator):
        return lambda shape: torch.rand(shape, generator=generator, device=device)
    return generator


def _top_indices(pri: torch.Tensor, k: int):
    """(values, indices) of the k largest of each row, ties to the lower
    index (as `jax.lax.top_k`)."""
    vals, idx = torch.sort(pri, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _random_keep(u: torch.Tensor, mask: torch.Tensor, budget, k_max: int) -> torch.Tensor:
    """Keep-mask `[B, N]` of min(budget, mask.sum()) elements of each row's
    True set, chosen uniformly without replacement by the priorities `u`
    `[B, N]`. `budget` is an int or a `[B]` tensor, clamped to [0, k_max]."""
    k_max = min(k_max, mask.shape[-1])
    pri = torch.where(mask, u, torch.full_like(u, BIG_NEG))
    top_vals, top_idx = _top_indices(pri, k_max)
    budget = torch.as_tensor(budget, device=mask.device).clamp(0, k_max)
    slots = torch.arange(k_max, device=mask.device)
    sel = (slots < budget.reshape(-1, 1)) & (top_vals > BIG_NEG / 2)
    return torch.zeros_like(mask).scatter(-1, top_idx, sel)


class AnchorTargets(NamedTuple):
    labels: torch.Tensor               # [B, N] f32 in {-1, 0, 1}
    bbox_targets: torch.Tensor         # [B, N, 4]
    bbox_inside_weights: torch.Tensor  # [B, N, 4]
    bbox_outside_weights: torch.Tensor  # [B, N, 4]


@torch.no_grad()
def anchor_target(uniform: Uniform, feat_hw, gt_boxes: torch.Tensor, im_info: torch.Tensor, *,
                  feat_stride: int, anchor_scales, anchor_ratios, rpn_batch_size: int = 256,
                  fg_fraction: float = 0.5, positive_overlap: float = 0.7,
                  negative_overlap: float = 0.3, clobber_positives: bool = False,
                  allowed_border: float = 0.0) -> AnchorTargets:
    """Anchor labels and regression targets over the whole anchor grid,
    flat `[B, H·W·A]` in (h, w, a) order. gt_boxes `[B, G, 5]` (x1, y1, x2,
    y2, cls), zero-padded; im_info `[B, 3]`."""
    h, w = feat_hw
    dev = gt_boxes.device
    anchors = pageable_to(shifted_anchors(h, w, feat_stride, ratios=tuple(anchor_ratios),
                                          scales=tuple(anchor_scales)), dev)
    n, b = anchors.shape[0], gt_boxes.shape[0]
    im_h, im_w = im_info[0, 0], im_info[0, 1]
    inside = ((anchors[:, 0] >= -allowed_border) & (anchors[:, 1] >= -allowed_border)
              & (anchors[:, 2] < im_w + allowed_border)
              & (anchors[:, 3] < im_h + allowed_border))                 # [N]

    anchors_b = anchors[None].expand(b, n, 4)
    overlaps = bbox_overlaps_masked(anchors_b, gt_boxes)                 # [B, N, G]
    max_overlaps, argmax_overlaps = overlaps.max(dim=2)
    # each gt's best anchor is searched among the inside anchors only
    overlaps_in = torch.where(inside[None, :, None], overlaps, torch.full_like(overlaps, -1.0))
    gt_max = overlaps_in.max(dim=1).values                               # [B, G]
    gt_max = torch.where(gt_max == 0, torch.full_like(gt_max, 1e-5), gt_max)
    best_for_gt = (overlaps_in == gt_max[:, None, :]).any(dim=2)         # [B, N]

    labels = torch.full((b, n), -1.0, device=dev)
    one, zero = torch.ones_like(labels), torch.zeros_like(labels)
    if not clobber_positives:
        labels = torch.where(max_overlaps < negative_overlap, zero, labels)
    labels = torch.where(best_for_gt, one, labels)
    labels = torch.where(max_overlaps >= positive_overlap, one, labels)
    if clobber_positives:
        labels = torch.where(max_overlaps < negative_overlap, zero, labels)
    labels = torch.where(inside[None, :], labels, -one)

    num_fg = int(fg_fraction * rpn_batch_size)
    u_fg, u_bg = uniform((b, n)), uniform((b, n))
    fg, bg = labels == 1, labels == 0
    labels = torch.where(fg & ~_random_keep(u_fg, fg, num_fg, num_fg), -one, labels)
    # the bg budget counts the fg anchors before their subsampling
    num_bg = rpn_batch_size - fg.sum(dim=1)
    labels = torch.where(bg & ~_random_keep(u_bg, bg, num_bg, rpn_batch_size), -one, labels)

    matched_gt = torch.take_along_dim(gt_boxes[..., :4], argmax_overlaps[..., None], dim=1)
    bbox_targets = bbox_transform(anchors_b, matched_gt)

    inside_w = (labels == 1).float()[..., None].expand(b, n, 4)
    num_examples = (labels >= 0).sum(dim=1).clamp_min(1)                # per image
    uniform_w = (1.0 / num_examples.float())[:, None].expand(b, n)
    outside_w = torch.where(labels >= 0, uniform_w, zero)[..., None].expand(b, n, 4)
    keep_t = (labels != -1)[..., None] & inside[None, :, None]
    bbox_targets = torch.where(keep_t, bbox_targets, torch.zeros_like(bbox_targets))
    return AnchorTargets(labels, bbox_targets, inside_w, outside_w)


class ProposalTargets(NamedTuple):
    rois: torch.Tensor                 # [B, R, 5] (batch_idx, x1, y1, x2, y2)
    labels: torch.Tensor               # [B, R] int32 class labels (0 = bg)
    bbox_targets: torch.Tensor         # [B, R, 4]
    bbox_inside_weights: torch.Tensor  # [B, R, 4]
    bbox_outside_weights: torch.Tensor  # [B, R, 4]


def _true_list(mask: torch.Tensor) -> torch.Tensor:
    """Row-wise list of the True indices in index order, `[B, N]` int64;
    entries past the row's count are 0."""
    b, n = mask.shape
    dest = torch.where(mask, torch.cumsum(mask, dim=1) - 1,
                       torch.full_like(mask, n, dtype=torch.long))
    src = torch.arange(n, device=mask.device).expand(b, n)
    return torch.zeros((b, n + 1), dtype=torch.long, device=mask.device).scatter(
        1, dest, src)[:, :n]


@torch.no_grad()
def proposal_target(uniform: Uniform, all_rois: torch.Tensor, gt_boxes: torch.Tensor, *,
                    rois_per_image: int = 128, fg_fraction: float = 0.25,
                    fg_thresh: float = 0.5, bg_thresh_hi: float = 0.5,
                    bg_thresh_lo: float = 0.1, bbox_normalize_means=(0.0, 0.0, 0.0, 0.0),
                    bbox_normalize_stds=(0.1, 0.1, 0.2, 0.2),
                    bbox_inside_weights=(1.0, 1.0, 1.0, 1.0),
                    normalize_targets: bool = True) -> ProposalTargets:
    """Sample `rois_per_image` rois an image from the proposals `[B, P, 5]`
    and the gt boxes `[B, G, 5]`, fg/bg balanced, with their labels and
    regression targets."""
    b, p, _ = all_rois.shape
    g = gt_boxes.shape[1]
    dev = all_rois.device
    r = rois_per_image
    fg_rois_per_image = max(1, int(round(fg_fraction * rois_per_image)))

    gt_as_rois = torch.cat([torch.zeros((b, g, 1), device=dev), gt_boxes[..., :4]], dim=2)
    cand = torch.cat([all_rois, gt_as_rois], dim=1)                     # [B, P+G, 5]
    n = p + g
    overlaps = bbox_overlaps_masked(cand[..., 1:5], gt_boxes)           # [B, N, G]
    max_overlaps, gt_assignment = overlaps.max(dim=2)
    labels_all = torch.take_along_dim(gt_boxes[..., 4], gt_assignment, dim=1)
    fg_mask = max_overlaps >= fg_thresh
    bg_mask = (max_overlaps < bg_thresh_hi) & (max_overlaps >= bg_thresh_lo)

    fg_num, bg_num = fg_mask.sum(dim=1), bg_mask.sum(dim=1)             # [B]
    # fg without replacement: a random order of the fg pool by priorities
    k_rand = min(r, n)
    fg_pri = torch.where(fg_mask, uniform((b, n)), torch.full((b, n), BIG_NEG, device=dev))
    fg_rand = _top_indices(fg_pri, k_rand)[1]
    fg_all, bg_all = _true_list(fg_mask), _true_list(bg_mask)

    both = (fg_num > 0) & (bg_num > 0)
    neither = (fg_num == 0) & (bg_num == 0)
    fg_this = torch.where(both, fg_num.clamp_max(fg_rois_per_image),
                          torch.where(fg_num > 0, torch.full_like(fg_num, r),
                                      torch.zeros_like(fg_num)))
    slot = torch.arange(r, device=dev)[None, :]
    is_fg_slot = slot < fg_this[:, None]                                # [B, R]
    u = uniform((b, r))
    fg_wo = torch.take_along_dim(
        fg_rand, torch.minimum(slot, (fg_num.clamp_max(k_rand) - 1).clamp_min(0)[:, None]), dim=1)

    def wr_idx(n_):
        # u·n can round up to n in f32: clamp to the pool's last index
        pick = (u * n_.clamp_min(1)[:, None].float()).to(torch.int64)
        return torch.minimum(pick, (n_ - 1).clamp_min(0)[:, None])

    fg_wr = torch.take_along_dim(fg_all, wr_idx(fg_num), dim=1)
    fg_pick = torch.where(both[:, None], fg_wo, fg_wr)
    bg_pick = torch.take_along_dim(bg_all, wr_idx(bg_num), dim=1)
    keep = torch.where(is_fg_slot, fg_pick, bg_pick)
    keep = torch.where(neither[:, None], torch.zeros_like(keep), keep)
    labels = torch.take_along_dim(labels_all, keep, dim=1)
    labels = torch.where(is_fg_slot & ~neither[:, None], labels, torch.zeros_like(labels))

    rois = torch.take_along_dim(cand, keep[..., None], dim=1)           # [B, R, 5]
    rois[..., 0] = torch.arange(b, dtype=rois.dtype, device=dev)[:, None]
    matched_gt = torch.take_along_dim(
        gt_boxes, torch.take_along_dim(gt_assignment, keep, dim=1)[..., None], dim=1)
    targets = bbox_transform(rois[..., 1:5], matched_gt[..., :4])
    if normalize_targets:
        means = torch.tensor(bbox_normalize_means, dtype=torch.float32, device=dev)
        stds = torch.tensor(bbox_normalize_stds, dtype=torch.float32, device=dev)
        targets = (targets - means) / stds

    fg_sel = (labels > 0)[..., None]
    bbox_targets = torch.where(fg_sel, targets, torch.zeros_like(targets))
    inside_w = torch.where(fg_sel, torch.tensor(bbox_inside_weights, dtype=torch.float32,
                                                device=dev), torch.zeros_like(targets))
    outside_w = (inside_w > 0).float()
    return ProposalTargets(rois, labels.to(torch.int32), bbox_targets, inside_w, outside_w)
