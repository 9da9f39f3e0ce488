"""The detector's train step in plain float32 PyTorch: anchor targets, the
RPN's losses, proposal targets (fg/bg sampling of 128 rois an image), the
R-CNN losses, autograd and SGD with momentum over the reference's groups
(weights at lr with weight decay, biases without it, at 2·lr where the
configuration's `double_bias` says so).

Sampling draws uniforms from a caller's source in a fixed order: the
anchor layer's fg priorities `[B, N]` and bg priorities `[B, N]`, then the
proposal layer's fg priorities `[B, P+G]` and slot uniforms `[B, R]`. A
random subset of k elements is the k highest priorities (ties to the lower
index); with-replacement picks are ⌊u·n⌋ into the pool in index order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .boxes import encode, grid_anchors, overlaps_with_gt
from .detector import F32, head, proposals, rpn, trainable, trunk

NEG = -1e9


def _top_keep(pri, mask, budget, k_max):
    """Keep-mask of min(budget, |mask|) elements of each row chosen by the
    highest priorities."""
    k_max = min(k_max, mask.shape[1])
    p = torch.where(mask, pri, torch.full_like(pri, NEG))
    vals, idx = torch.sort(p, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k_max], idx[:, :k_max]
    budget = torch.as_tensor(budget, device=mask.device).clamp(0, k_max).reshape(-1, 1)
    sel = (torch.arange(k_max, device=mask.device)[None] < budget) & (vals > NEG / 2)
    return torch.zeros_like(mask).scatter(1, idx, sel)


def anchor_targets(uniform, feat_hw, gt, im_info, c: dict):
    """(labels `[B, N]` in {-1, 0, 1}, targets `[B, N, 4]`, inside and
    outside weights `[B, N, 4]`). Anchors count as inside by the first
    image's bounds, for the whole batch."""
    t = c["train"]
    dev = gt.device
    anchors = torch.from_numpy(grid_anchors(*feat_hw, c["feat_stride"], c["anchor_scales"],
                                            c["anchor_ratios"])).to(dev)
    b, n = gt.shape[0], anchors.shape[0]
    ih, iw = im_info[0, 0], im_info[0, 1]
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0) & (anchors[:, 2] < iw)
              & (anchors[:, 3] < ih))
    ov = overlaps_with_gt(anchors[None].expand(b, n, 4), gt)
    best, arg = ov.max(dim=2)
    ov_in = torch.where(inside[None, :, None], ov, torch.full_like(ov, -1.0))
    gt_best = ov_in.max(dim=1).values
    gt_best = torch.where(gt_best == 0, torch.full_like(gt_best, 1e-5), gt_best)
    is_best = (ov_in == gt_best[:, None, :]).any(dim=2)
    labels = torch.full((b, n), -1.0, device=dev)
    labels[best < t["rpn_negative_overlap"]] = 0.0
    labels[is_best] = 1.0
    labels[best >= t["rpn_positive_overlap"]] = 1.0
    labels[:, ~inside] = -1.0
    n_fg = int(t["rpn_fg_fraction"] * t["rpn_batchsize"])
    u_fg, u_bg = uniform((b, n)), uniform((b, n))
    fg, bg = labels == 1, labels == 0
    labels[fg & ~_top_keep(u_fg, fg, n_fg, n_fg)] = -1.0
    n_bg = t["rpn_batchsize"] - fg.sum(dim=1)
    labels[bg & ~_top_keep(u_bg, bg, n_bg, t["rpn_batchsize"])] = -1.0
    matched = torch.gather(gt[..., :4], 1, arg[..., None].expand(b, n, 4))
    targets = encode(anchors[None].expand(b, n, 4), matched)
    targets = torch.where(((labels != -1) & inside[None])[..., None], targets,
                          torch.zeros_like(targets))
    inside_w = (labels == 1).float()[..., None].expand(b, n, 4)
    count = (labels >= 0).sum(dim=1).clamp_min(1).float()
    outside_w = torch.where(labels >= 0, 1.0 / count[:, None],
                            torch.zeros_like(labels))[..., None].expand(b, n, 4)
    return labels, targets, inside_w, outside_w


def _index_list(mask):
    """Row-wise indices of the True entries in order, zero past the count."""
    b, n = mask.shape
    out = torch.zeros((b, n), dtype=torch.long, device=mask.device)
    for i in range(b):
        idx = torch.nonzero(mask[i]).flatten()
        out[i, :len(idx)] = idx
    return out


def proposal_targets(uniform, rois, gt, c: dict):
    """Sample R rois an image from the proposals `[B, P, 5]` and the gt
    boxes: (rois `[B, R, 5]`, labels `[B, R]`, targets, inside and outside
    weights `[B, R, 4]`)."""
    t = c["train"]
    b, p, _ = rois.shape
    g = gt.shape[1]
    dev = rois.device
    r = t["rois_per_image"]
    fg_per = max(1, int(round(t["fg_fraction"] * r)))
    cand = torch.cat([rois, torch.cat([torch.zeros((b, g, 1), device=dev), gt[..., :4]], 2)], 1)
    n = p + g
    ov = overlaps_with_gt(cand[..., 1:5], gt)
    best, arg = ov.max(dim=2)
    cls_all = torch.gather(gt[..., 4], 1, arg)
    fg = best >= t["fg_thresh"]
    bg = (best < t["bg_thresh_hi"]) & (best >= t["bg_thresh_lo"])
    nfg, nbg = fg.sum(1), bg.sum(1)
    k = min(r, n)
    fg_order = torch.sort(torch.where(fg, uniform((b, n)), torch.full((b, n), NEG, device=dev)),
                          dim=1, descending=True, stable=True)[1][:, :k]
    both, neither = (nfg > 0) & (nbg > 0), (nfg == 0) & (nbg == 0)
    n_fg_slots = torch.where(both, nfg.clamp_max(fg_per),
                             torch.where(nfg > 0, torch.full_like(nfg, r), torch.zeros_like(nfg)))
    slot = torch.arange(r, device=dev)[None]
    fg_slot = slot < n_fg_slots[:, None]
    u = uniform((b, r))

    def with_replacement(pool, count):
        pick = (u * count.clamp_min(1)[:, None].float()).long()
        return torch.gather(pool, 1, torch.minimum(pick, (count - 1).clamp_min(0)[:, None]))

    fg_no_rep = torch.gather(fg_order, 1, torch.minimum(
        slot.expand(b, r), (nfg.clamp_max(k) - 1).clamp_min(0)[:, None]))
    fg_pick = torch.where(both[:, None], fg_no_rep, with_replacement(_index_list(fg), nfg))
    keep = torch.where(fg_slot, fg_pick, with_replacement(_index_list(bg), nbg))
    keep = torch.where(neither[:, None], torch.zeros_like(keep), keep)
    labels = torch.gather(cls_all, 1, keep)
    labels = torch.where(fg_slot & ~neither[:, None], labels, torch.zeros_like(labels))
    out = torch.gather(cand, 1, keep[..., None].expand(b, r, 5)).clone()
    out[..., 0] = torch.arange(b, device=dev, dtype=out.dtype)[:, None]
    matched = torch.gather(gt, 1, torch.gather(arg, 1, keep)[..., None].expand(b, r, 5))
    targets = encode(out[..., 1:5], matched[..., :4])
    targets = targets / torch.tensor(t["bbox_normalize_stds"], device=dev)
    is_fg = (labels > 0)[..., None]
    targets = torch.where(is_fg, targets, torch.zeros_like(targets))
    inside_w = is_fg.float().expand(b, r, 4)
    return out, labels.long(), targets, inside_w, inside_w


def smooth_l1(pred, target, w_in, w_out, sigma, dims):
    s2 = sigma ** 2
    d = w_in * (pred - target)
    a = d.abs()
    small = (a < 1.0 / s2).float()
    loss = d * d * (s2 / 2.0) * small + (a - 0.5 / s2) * (1.0 - small)
    return (w_out * loss).sum(dim=dims).mean()


def losses(p, batch, rois, uniform, c: dict, q=F32) -> dict:
    """The four losses of a train forward from the trunk to the classifiers,
    with `rois` `[B, P, 5]` as the proposal layer's output."""
    data, info, gt = batch["data"], batch["im_info"], batch["gt_boxes"]
    b = data.shape[0]
    feat = trunk(p, data, q, frozen_stages=c["train"]["fixed_blocks"])
    cls, deltas = rpn(p, feat, q)
    a = cls.shape[-1] // 2
    labels, targets, w_in, w_out = anchor_targets(uniform, tuple(feat.shape[1:3]), gt, info, c)
    logits = torch.stack([cls[..., :a].reshape(b, -1), cls[..., a:].reshape(b, -1)], -1)
    sampled = (labels >= 0).float()
    logp = torch.log_softmax(logits, -1)
    ll = torch.gather(logp, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    rpn_cls = -(ll * sampled).sum() / sampled.sum().clamp_min(1.0)
    rpn_box = smooth_l1(deltas.reshape(b, -1, 4), targets, w_in, w_out, 3.0, (1, 2))
    s_rois, s_labels, s_targets, s_in, s_out = proposal_targets(uniform, rois, gt, c)
    logits, bbox = head(p, feat, s_rois.reshape(-1, 5), q)
    lab = s_labels.reshape(-1)
    bbox = bbox.reshape(len(lab), -1, 4)[torch.arange(len(lab), device=lab.device), lab]
    rcnn_cls = F.cross_entropy(logits, lab)
    rcnn_box = smooth_l1(bbox, s_targets.reshape(-1, 4), s_in.reshape(-1, 4),
                         s_out.reshape(-1, 4), 1.0, (-1,))
    return dict(rpn_cls=rpn_cls, rpn_box=rpn_box, rcnn_cls=rcnn_cls, rcnn_box=rcnn_box,
                fg=(s_labels > 0).sum())


class SGD:
    """SGD with momentum over the trainable leaves: d = g + wd·p (weights),
    d = g (biases, at 2·lr with `double_bias`), m ← d + μ·m (m = d at the
    first step), p ← p − lr·m."""

    def __init__(self, params: dict, names, lr: float, momentum: float, wd: float,
                 double_bias: bool):
        self.p, self.names = params, list(names)
        self.lr, self.mu, self.wd = lr, momentum, wd
        self.bias_lr = 2 * lr if double_bias else lr
        self.m = {}

    def step(self, grads: dict) -> dict:
        """Applies one step; returns each leaf's d (the gradient as the
        optimizer takes it)."""
        out = {}
        with torch.no_grad():
            for n in self.names:
                bias = n.endswith(".bias")
                d = grads[n] if bias else grads[n] + self.wd * self.p[n]
                self.m[n] = d.clone() if n not in self.m else d + self.mu * self.m[n]
                self.p[n] -= (self.bias_lr if bias else self.lr) * self.m[n]
                out[n] = d
        return out


def train_steps(params: dict, batches, rois, uniforms, c: dict, q=F32):
    """Steps of SGD from `params` (modified in place). `rois[k]` is step k's
    proposal layer output, or None: then the proposal layer runs here, on
    this precision's RPN. Returns each step's losses as floats, the first
    step's d of each trainable leaf, the leaves' names and the rois used."""
    t = c["train"]
    names = [n for n in params if trainable(n, t["fixed_blocks"])]
    opt = SGD(params, names, t["lr"], t["momentum"], t["weight_decay"], t["double_bias"])
    history, first_d, used = [], None, []
    for batch, r, uniform in zip(batches, rois, uniforms):
        if r is None:
            with torch.no_grad():
                cls, deltas = rpn(params, trunk(params, batch["data"], q), q)
                r = proposals(cls, deltas, batch["im_info"], c, t["rpn_pre_nms_top_n"],
                              t["rpn_post_nms_top_n"], t["rpn_nms_thresh"])
        used.append(r)
        for n in names:
            params[n].requires_grad_(True)
        out = losses(params, batch, r, uniform, c, q)
        total = out["rpn_cls"] + out["rpn_box"] + out["rcnn_cls"] + out["rcnn_box"]
        grads = dict(zip(names, torch.autograd.grad(total, [params[n] for n in names])))
        for n in names:
            params[n].requires_grad_(False)
        d = opt.step(grads)
        first_d = d if first_d is None else first_d
        history.append({k: float(v.detach()) for k, v in out.items()} | {"loss": float(total.detach())})
    return history, first_d, names, used
