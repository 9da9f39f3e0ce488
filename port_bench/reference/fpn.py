"""Faster R-CNN R101-FPN (Detectron2's COCO-Detection/faster_rcnn_R_101_FPN_3x)
in plain float32 PyTorch, over a flat dict of parameters keyed as the
benchmark's weights are: the eval forward, the train targets and losses,
and SGD.

Trunk: the C4 reference's ResNet-101 (caffe flavour, frozen BN, ceil-mode
3×3/2 max pool) with layer4 run on the whole map (stride 2 on its 1×1
convs), C2..C5 its four stages' outputs. Neck: P_l = conv3×3(lateral_l(C_l)
+ nearest 2× upsampling of the inner map above), P6 = P5[::2, ::2] (a max
pool of kernel 1, stride 2). RPN: one head over P2..P6 (3×3 conv-256 +
ReLU, 1×1 objectness of 3 logits, 1×1 deltas of 12), anchors of 32..512
pixels at strides 4..64, ratios 0.5, 1, 2. Proposals: each level's top
`pre_n` logits of an image, decoded (dw, dh clamped at log(1000/16)),
clipped, empty boxes (x2 ≤ x1 or y2 ≤ y1) dropped, greedy NMS within the
level, then the image's `post_n` best survivors of all levels. Pooler:
level ⌊4 + log2(√area / 224 + 1e-8)⌋ in [2, 5], RoIAlign with aligned=True
and sampling_ratio 0 (each bin the mean of a ⌈h/7⌉ × ⌈w/7⌉ grid of
bilinear samples, a sample outside [−1, size] 0), written out from those
equations. Box head: fc 12544 → 1024 → 1024 with ReLU, then 81 class
logits and 81 × 4 deltas. Training: every anchor labelled (IoU < 0.3
negative, ≥ 0.7 positive, each gt box's best anchors positive), 256
sampled an image at most half positive, sigmoid cross-entropy and L1 over
256 · images; 512 rois an image sampled from the proposals and the gt
boxes, at most a quarter at IoU ≥ 0.5, each pool without replacement,
cross-entropy and the foreground's L1 over the sampled count; SGD with
momentum and weight decay on every trained leaf, biases included, its
learning rate warmed up linearly (`lr_at`).

Departures from Detectron2 that the port keeps, and so does this
reference: box arithmetic with "+1" widths (IoU, encode, decode, clip to
[0, size − 1]) and anchors centred on their cell (jwyang's anchor windows
with a base of the level's stride); the trunk's ceil-mode stem pool; BGR
pixel means; the test-time decode without Detectron2's clamp. The program
computes in bf16, this reference in float32 (TF32 off).

Random subsets are the highest priorities among a caller's uniforms (ties
to the lower index), drawn in this order: the anchors' fg and bg
priorities `[B, N]`, then the rois' fg and bg priorities `[B, P + G]`.
The proposal layer can take another computation's proposals. The L1
residuals (box head, RPN) that lie within rounding of 0 are this
computation's own band (`box_l1`); `absorb_flips` lets a comparison take
another computation's gradient with such a residual's sign the other way
round, as rounding may decide it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .boxes import anchors_base, clip, decode, encode, greedy_nms, overlaps_with_gt, unsuppressed
from .detector import BLOCKS, F32, _bn, _conv, _stage, trainable

STRIDES = (4, 8, 16, 32, 64)
SIZES = (32, 64, 128, 256, 512)
CLAMP = math.log(1000.0 / 16)
NEG = -1e9


def param_shapes(num_classes: int, num_anchors: int = 3, layers: int = 101) -> dict:
    """{name: shape} of every weight and BN constant of the detector."""
    shapes = {}

    def conv(name, cout, cin, k, bias=False):
        shapes[name + ".weight"] = (cout, cin, k, k)
        if bias:
            shapes[name + ".bias"] = (cout,)

    def bn(name, c):
        for s in ("scale", "bias", "mean", "var"):
            shapes[f"{name}.{s}"] = (c,)

    conv("base.conv1", 64, 3, 7)
    bn("base.bn1", 64)
    cin = 64
    for k, (planes, blocks) in enumerate(zip((64, 128, 256, 512), BLOCKS[layers]), start=1):
        for i in range(blocks):
            pre = f"base.layer{k}.block{i}"
            conv(pre + ".conv1", planes, cin if i == 0 else planes * 4, 1)
            bn(pre + ".bn1", planes)
            conv(pre + ".conv2", planes, planes, 3)
            bn(pre + ".bn2", planes)
            conv(pre + ".conv3", planes * 4, planes, 1)
            bn(pre + ".bn3", planes * 4)
            if i == 0:
                conv(pre + ".downsample_conv", planes * 4, cin, 1)
                bn(pre + ".downsample_bn", planes * 4)
        cin = planes * 4
    for lvl, c in zip(range(2, 6), (256, 512, 1024, 2048)):
        conv(f"fpn.lateral{lvl}", 256, c, 1, bias=True)
        conv(f"fpn.output{lvl}", 256, 256, 3, bias=True)
    conv("rpn.conv", 256, 256, 3, bias=True)
    conv("rpn.objectness", num_anchors, 256, 1, bias=True)
    conv("rpn.deltas", 4 * num_anchors, 256, 1, bias=True)
    shapes["box_head.fc6.weight"] = (1024, 256 * 49)
    shapes["box_head.fc6.bias"] = (1024,)
    shapes["box_head.fc7.weight"] = (1024, 1024)
    shapes["box_head.fc7.bias"] = (1024,)
    shapes["RCNN_cls_score.weight"] = (num_classes, 1024)
    shapes["RCNN_cls_score.bias"] = (num_classes,)
    shapes["RCNN_bbox_pred.weight"] = (4 * num_classes, 1024)
    shapes["RCNN_bbox_pred.bias"] = (4 * num_classes,)
    return shapes


def trunk(p, data, q=F32, hook=None, frozen_stages: int = 1) -> list:
    """data `[B, H, W, 3]` → C2..C5, NCHW."""
    x = data.permute(0, 3, 1, 2)
    x = torch.relu(_bn(p, "base.bn1", _conv(p, "base.conv1", x, q, 2), q, hook))
    x = F.max_pool2d(x, 3, 2, 0, ceil_mode=True)
    if frozen_stages == 0:
        x = x.detach()
    out = []
    for k in range(1, 5):
        x = _stage(p, f"base.layer{k}", x, 1 if k == 1 else 2, q, hook)
        if k == frozen_stages:
            x = x.detach()
        out.append(x)
    return out


def neck(p, cs, q=F32) -> list:
    """C2..C5 → P2..P6, NCHW."""
    inner = _conv(p, "fpn.lateral5", cs[3], q)
    outs = [_conv(p, "fpn.output5", inner, q)]
    for lvl in (4, 3, 2):
        up = inner.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        inner = _conv(p, f"fpn.lateral{lvl}", cs[lvl - 2], q) + up
        outs.insert(0, _conv(p, f"fpn.output{lvl}", inner, q))
    outs.append(outs[-1][:, :, ::2, ::2])
    return outs


def rpn(p, ps, q=F32, features: bool = False):
    """→ (logits `[B, N]`, deltas `[B, N, 4]`, each level's (H, W)), the levels
    one after the other, each flattened in (h, w, a) order; with `features`
    also each level's hidden map `[B, 256, H, W]` (the 1×1 convs' input)."""
    logits, deltas, hw, hidden = [], [], [], []
    for x in ps:
        t = torch.relu(_conv(p, "rpn.conv", x, q))
        b, _, h, w = t.shape
        logits.append(_conv(p, "rpn.objectness", t, q).permute(0, 2, 3, 1).reshape(b, -1))
        deltas.append(_conv(p, "rpn.deltas", t, q).permute(0, 2, 3, 1).reshape(b, -1, 4))
        hw.append((h, w))
        hidden.append(t)
    out = (torch.cat(logits, 1), torch.cat(deltas, 1), hw)
    return out + (hidden,) if features else out


def anchors(hw, ratios, device) -> tuple[torch.Tensor, list]:
    """(`[N, 4]` anchors of every level in the heads' order, anchors a level)."""
    out, sizes = [], []
    for (h, w), stride, size in zip(hw, STRIDES, SIZES):
        base = anchors_base((size / stride,), ratios, base_size=stride)
        ys, xs = np.meshgrid(np.arange(h) * stride, np.arange(w) * stride, indexing="ij")
        shifts = np.stack([xs.ravel(), ys.ravel(), xs.ravel(), ys.ravel()], 1).astype(np.float32)
        out.append((shifts[:, None, :] + base[None]).reshape(-1, 4))
        sizes.append(h * w * len(base))
    return torch.from_numpy(np.concatenate(out)).to(device), sizes


def level_candidates(logits, deltas, anc, sizes, im_info, pre_n: int):
    """One image's candidates of each level: [(indices into the level's
    anchors in descending logit order, their logits, decoded and clipped
    boxes, non-empty)] of its top `pre_n`."""
    out, at = [], 0
    for n in sizes:
        lg = logits[at:at + n]
        top = torch.argsort(-lg, stable=True)[:pre_n]
        d = deltas[at:at + n][top].clone()
        d[:, 2:] = d[:, 2:].clamp_max(CLAMP)
        boxes = clip(decode(anc[at:at + n][top], d), float(im_info[0]), float(im_info[1]))
        ok = ((boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
              & torch.isfinite(lg[top]) & torch.isfinite(boxes).all(1))
        out.append((top, lg[top], boxes, ok))
        at += n
    return out


def proposals(logits, deltas, hw, im_info, c: dict, pre_n: int, post_n: int, thresh: float):
    """The proposal layer: (rois `[B, post_n, 5]`, valid `[B, post_n]`)."""
    b = logits.shape[0]
    anc, sizes = anchors(hw, c["anchor_ratios"], logits.device)
    rois = torch.zeros((b, post_n, 5), device=logits.device)
    valid = torch.zeros((b, post_n), dtype=torch.bool, device=logits.device)
    for i in range(b):
        boxes, scores = [], []
        for _, s, bx, ok in level_candidates(logits[i], deltas[i], anc, sizes, im_info[i], pre_n):
            keep = torch.from_numpy(greedy_nms(bx, s, thresh, max_keep=post_n, valid=ok))
            boxes.append(bx[keep.to(bx.device)])
            scores.append(s[keep.to(bx.device)])
        boxes, scores = torch.cat(boxes), torch.cat(scores)
        best = torch.argsort(-scores, stable=True)[:post_n]
        rois[i, :len(best), 0] = i
        rois[i, :len(best), 1:] = boxes[best]
        valid[i, :len(best)] = True
    return rois, valid


def proposal_faults(logits, deltas, hw, im_info, rois, roi_scores, c: dict, pre_n: int,
                    post_n: int, thresh: float, box_tol: float = 1e-2, score_eps: float = 1e-4,
                    iou_eps: float = 1e-3) -> tuple[int, int]:
    """One image's kept rois `[K, 5]` and their logits `[K]` (in the
    program's order) against the RPN outputs its proposal layer was given,
    logits `[N]` and deltas `[N, 4]`. Returns (foreign, missing): kept
    boxes that are no level's top-`pre_n` non-empty candidate (its box to
    `box_tol` px and its logit to `score_eps`; two levels may keep the
    same box, clipped to the image, under other logits) or that leave
    descending logit order; and candidates that must have been kept (in
    their level's top `pre_n` for sure, above the image's last kept logit
    where `post_n` were kept) but were not, with no kept box of their level
    and of a logit not below theirs overlapping them above `thresh`.
    Logits within `score_eps` and IoUs within `iou_eps` of the threshold
    count as ties, which rounding decides."""
    logits, deltas = logits.float(), deltas.float()
    anc, sizes = anchors(hw, c["anchor_ratios"], logits.device)
    cands = level_candidates(logits, deltas, anc, sizes, im_info, pre_n)
    at, may_b, may_s, may_l, must = 0, [], [], [], []
    for lvl, (n, (top, s, bx, ok)) in enumerate(zip(sizes, cands)):
        k = min(pre_n, n)
        srt = torch.sort(logits[at:at + n], descending=True).values
        kth = float(srt[k - 1])
        near = torch.nonzero(logits[at:at + n] >= kth - score_eps).flatten()
        extra = near[~torch.isin(near, top)]
        if len(extra):
            d = deltas[at:at + n][extra].clone()
            d[:, 2:] = d[:, 2:].clamp_max(CLAMP)
            eb = clip(decode(anc[at:at + n][extra], d), float(im_info[0]), float(im_info[1]))
            bx, s = torch.cat([bx, eb]), torch.cat([s, logits[at:at + n][extra]])
            ok = torch.cat([ok, (eb[:, 2] > eb[:, 0]) & (eb[:, 3] > eb[:, 1])])
        sure = torch.ones_like(s, dtype=torch.bool) if k == n else s > kth + score_eps
        may_b.append(bx[ok])
        may_s.append(s[ok])
        may_l.append(torch.full((int(ok.sum()),), lvl, device=s.device))
        must.append(sure[ok])
        at += n
    bm, sm, lm, must = torch.cat(may_b), torch.cat(may_s), torch.cat(may_l), torch.cat(must)
    got, got_s = rois[:, 1:5].float(), roi_scores.float()
    # each kept box, in order, takes the candidate of its box and logit
    # (the nearest logit) that no earlier one took
    near = torch.cat([(((got[s:s + 256, None, :] - bm[None]).abs().amax(-1) <= box_tol)
                       & ((got_s[s:s + 256, None] - sm[None]).abs() <= score_eps)).cpu()
                      for s in range(0, len(got), 256)]).numpy() if len(got) else None
    scores, want = sm.cpu().numpy(), got_s.cpu().numpy()
    used = np.zeros(len(scores), bool)
    picks = []
    for i in range(len(got)):
        cand = np.flatnonzero(near[i] & ~used)
        j = int(cand[np.argmin(np.abs(scores[cand] - want[i]))]) if len(cand) else -1
        if j >= 0:
            used[j] = True
        picks.append(j)
    match = torch.tensor(picks, dtype=torch.long, device=bm.device)
    ok = match >= 0
    ms = torch.where(ok, sm[match.clamp_min(0)], torch.full_like(got[:, 0], math.inf))
    foreign = int((~ok).sum()) + int(((ms[1:] > ms[:-1] + score_eps) & ok[1:] & ok[:-1]).sum())
    taken = torch.zeros_like(sm, dtype=torch.bool)
    taken[match[ok]] = True
    cut = float(ms[-1]) if len(got) == post_n and bool(ok[-1]) else None
    missing = 0
    kl = lm[match.clamp_min(0)]
    for lvl in range(len(sizes)):
        here = (lm == lvl) & must
        mine = ok & (kl == lvl)
        missing += unsuppressed(bm[here], sm[here], taken[here], got[mine], ms[mine], thresh,
                                cut=cut, score_abs=score_eps, iou_eps=iou_eps)
    return foreign, missing


def roi_levels(rois) -> torch.Tensor:
    """Each roi's pyramid level, 2..5: v = √area / 224 + 1e-8 in float32,
    then ⌊4 + log2 v⌋ in float64 (in float32, 4 + log2 v rounds up to the
    next integer where v lies within 2.4e-7 below a power of two)."""
    x1, y1, x2, y2 = rois[:, 1], rois[:, 2], rois[:, 3], rois[:, 4]
    v = torch.sqrt((x2 - x1) * (y2 - y1)) / 224 + 1e-8
    k = torch.floor(4 + torch.log2(v.double()))
    return k.nan_to_num(2.0).clamp(2, 5).long()


def _bilinear(fmap, y, x):
    """fmap `[H, W, C]`; y, x `[S]` sample coordinates → `[S, C]`, 0 outside
    [−1, H] × [−1, W] (torchvision's `bilinear_interpolate`)."""
    h, w = fmap.shape[:2]
    out_of = (y < -1.0) | (y > h) | (x < -1.0) | (x > w)
    y, x = y.clamp_min(0.0), x.clamp_min(0.0)
    y0, x0 = y.floor().long(), x.floor().long()
    y_top, x_top = y0 >= h - 1, x0 >= w - 1
    y0, x0 = torch.where(y_top, h - 1, y0), torch.where(x_top, w - 1, x0)
    y1, x1 = torch.where(y_top, y0, y0 + 1), torch.where(x_top, x0, x0 + 1)
    y, x = torch.where(y_top, y0.float(), y), torch.where(x_top, x0.float(), x)
    ly, lx = y - y0, x - x0
    hy, hx = 1 - ly, 1 - lx
    v = (fmap[y0, x0] * (hy * hx)[:, None] + fmap[y0, x1] * (hy * lx)[:, None]
         + fmap[y1, x0] * (ly * hx)[:, None] + fmap[y1, x1] * (ly * lx)[:, None])
    return torch.where(out_of[:, None], torch.zeros_like(v), v)


def roi_align_v2(ps: list, rois) -> torch.Tensor:
    """P2..P5 (NCHW) and rois `[R, 5]` → `[R, 256, 7, 7]`: each roi on its
    level, bins of 7×7, each the mean of its adaptive sample grid."""
    maps = [x.permute(0, 2, 3, 1) for x in ps]
    out = torch.zeros((len(rois), ps[0].shape[1], 7, 7), device=rois.device)
    lvl = roi_levels(rois)
    scale = 1.0 / (2.0 ** lvl.float())
    x0 = rois[:, 1] * scale - 0.5
    y0 = rois[:, 2] * scale - 0.5
    rw = rois[:, 3] * scale - 0.5 - x0
    rh = rois[:, 4] * scale - 0.5 - y0
    gh, gw = torch.ceil(rh / 7).long(), torch.ceil(rw / 7).long()
    rows = []
    # rois of one level, image and sample grid go together
    key = torch.stack([lvl, rois[:, 0].long(), gh, gw], 1)
    for k in torch.unique(key, dim=0).tolist():
        lv, bi, ny, nx = k
        idx = torch.nonzero((key == torch.tensor(k, device=key.device)).all(1)).flatten()
        if ny <= 0 or nx <= 0:
            continue
        fmap = maps[lv - 2][bi]
        bh, bw = rh[idx] / 7, rw[idx] / 7
        g = torch.arange(7, device=rois.device, dtype=torch.float32)
        iy = torch.arange(ny, device=rois.device, dtype=torch.float32)
        ix = torch.arange(nx, device=rois.device, dtype=torch.float32)
        ys = (y0[idx, None, None] + g[None, :, None] * bh[:, None, None]) \
            + (iy[None, None, :] + 0.5) * bh[:, None, None] / ny            # [r, 7, ny]
        xs = (x0[idx, None, None] + g[None, :, None] * bw[:, None, None]) \
            + (ix[None, None, :] + 0.5) * bw[:, None, None] / nx            # [r, 7, nx]
        r = len(idx)
        yy = ys[:, :, :, None, None].expand(r, 7, ny, 7, nx).reshape(-1)
        xx = xs[:, None, None, :, :].expand(r, 7, ny, 7, nx).reshape(-1)
        v = _bilinear(fmap, yy, xx).reshape(r, 7, ny, 7, nx, -1)
        rows.append((idx, v.sum(dim=(2, 4)) / (ny * nx)))
    for idx, v in rows:
        out = out.index_copy(0, idx, v.permute(0, 3, 1, 2))
    return out


def box_head(p, pooled, q=F32, features: bool = False):
    """`[R, 256, 7, 7]` → (class logits `[R, C]`, box deltas `[R, 4C]`), and
    with `features` the classifiers' input `[R, 1024]` after them."""
    x = q(pooled).reshape(len(pooled), -1)
    x = torch.relu(F.linear(x, q(p["box_head.fc6.weight"]), p["box_head.fc6.bias"]))
    x = torch.relu(F.linear(q(x), q(p["box_head.fc7.weight"]), p["box_head.fc7.bias"]))
    out = (F.linear(q(x), q(p["RCNN_cls_score.weight"]), p["RCNN_cls_score.bias"]),
           F.linear(q(x), q(p["RCNN_bbox_pred.weight"]), p["RCNN_bbox_pred.bias"]))
    return out + (x,) if features else out


def detect_forward(p, data, im_info, c: dict, q=F32, hook=None, out=None):
    """The eval forward of one image: (rois `[R, 5]`, valid `[R]`, class
    probabilities `[R, C]`, box deltas `[R, 4C]`). `out` given: its "rpn"
    takes (logits, deltas, level sizes) of the image."""
    t = c["test"]
    with torch.no_grad():
        ps = neck(p, trunk(p, data, q, hook), q)
        logits, deltas, hw = rpn(p, ps, q)
        if out is not None:
            out["rpn"] = (logits[0], deltas[0], hw)
        rois, valid = proposals(logits, deltas, hw, im_info, c, t["rpn_pre_nms_top_n"],
                                t["rpn_post_nms_top_n"], t["rpn_nms_thresh"])
        logit, bbox = box_head(p, roi_align_v2(ps[:4], rois[0]), q)
    return rois[0], valid[0], torch.softmax(logit, -1), bbox


def postprocess(rois, valid, prob, bbox, im_info, c: dict):
    """Test-time detections of one image: each class's boxes (deltas times
    the normalising stds, decoded, clipped, over the scale), scores above
    `score_thresh`, greedy NMS at TEST.NMS, the image's `max_per_image`
    best. Returns (boxes `[M, 4]`, scores `[M]`, classes `[M]`)."""
    t = c["test"]
    ncls = prob.shape[1]
    stds = torch.tensor(c["train"]["bbox_normalize_stds"], device=bbox.device).repeat(ncls)
    boxes = clip(decode(rois[:, 1:5], bbox * stds), float(im_info[0]), float(im_info[1]))
    boxes = (boxes / float(im_info[2])).reshape(-1, ncls, 4)
    cand = []
    for j in range(1, ncls):
        ok = valid & (prob[:, j] > t["score_thresh"])
        keep = greedy_nms(boxes[:, j], prob[:, j], t["nms"], max_keep=t["max_per_image"],
                          valid=ok)
        cand.extend((float(prob[k, j]), j, int(k)) for k in keep)
    cand.sort(key=lambda s: -s[0])
    cand = cand[:t["max_per_image"]]
    idx = torch.tensor([k for _, _, k in cand], dtype=torch.long, device=prob.device)
    cls = torch.tensor([j for _, j, _ in cand], dtype=torch.long, device=prob.device)
    return (boxes[idx, cls].cpu().numpy(), np.asarray([s for s, _, _ in cand], np.float32),
            cls.cpu().numpy())


def _first_k(pri, mask, k: int):
    """Indices `[B, k]` of each row's highest priorities among `mask`."""
    p = torch.where(mask, pri, torch.full_like(pri, NEG))
    return torch.sort(p, dim=1, descending=True, stable=True)[1][:, :k]


def anchor_targets(uniform, anc, gt, c: dict):
    """(labels `[B, N]` in {-1, 0, 1}, targets `[B, N, 4]`)."""
    t = c["train"]
    b, n = gt.shape[0], anc.shape[0]
    ov = overlaps_with_gt(anc[None].expand(b, n, 4), gt)
    best, arg = ov.max(dim=2)
    gt_best = ov.max(dim=1).values
    gt_best = torch.where(gt_best == 0, torch.full_like(gt_best, 1e-5), gt_best)
    is_best = (ov == gt_best[:, None, :]).any(dim=2)
    labels = torch.full((b, n), -1.0, device=gt.device)
    labels[best < t["rpn_negative_overlap"]] = 0.0
    labels[(best >= t["rpn_positive_overlap"]) | is_best] = 1.0
    u_fg, u_bg = uniform((b, n)), uniform((b, n))
    n_fg_max = int(t["rpn_fg_fraction"] * t["rpn_batchsize"])
    fg, bg = labels == 1, labels == 0
    new = torch.full_like(labels, -1.0)
    for i in range(b):
        nf = min(int(fg[i].sum()), n_fg_max)
        nb = min(int(bg[i].sum()), t["rpn_batchsize"] - nf)
        new[i, _first_k(u_fg[i:i + 1], fg[i:i + 1], nf)[0]] = 1.0
        new[i, _first_k(u_bg[i:i + 1], bg[i:i + 1], nb)[0]] = 0.0
    matched = torch.gather(gt[..., :4], 1, arg[..., None].expand(b, n, 4))
    return new, encode(anc[None].expand(b, n, 4), matched)


def roi_targets(uniform, rois, valid, gt, c: dict):
    """(rois `[B, R, 5]`, labels `[B, R]`, sampled `[B, R]`, normalised
    targets `[B, R, 4]`): R = rois_per_image slots an image, foreground
    first, then background, then unsampled padding."""
    t = c["train"]
    b, p, _ = rois.shape
    g = gt.shape[1]
    r = t["rois_per_image"]
    dev = rois.device
    cand = torch.cat([rois, torch.cat([torch.zeros((b, g, 1), device=dev), gt[..., :4]], 2)], 1)
    ok = torch.cat([valid, gt[..., 4] > 0], 1)
    best, arg = overlaps_with_gt(cand[..., 1:5], gt).max(dim=2)
    fg = ok & (best >= t["fg_thresh"])
    bg = ok & (best < t["fg_thresh"])
    n = p + g
    u_fg, u_bg = uniform((b, n)), uniform((b, n))
    out = torch.zeros((b, r, 5), device=dev)
    labels = torch.zeros((b, r), dtype=torch.long, device=dev)
    sampled = torch.zeros((b, r), dtype=torch.bool, device=dev)
    targets = torch.zeros((b, r, 4), device=dev)
    stds = torch.tensor(t["bbox_normalize_stds"], device=dev)
    for i in range(b):
        nf = min(int(fg[i].sum()), int(t["fg_fraction"] * r))
        nb = min(int(bg[i].sum()), r - nf)
        fi = _first_k(u_fg[i:i + 1], fg[i:i + 1], nf)[0]
        bi = _first_k(u_bg[i:i + 1], bg[i:i + 1], nb)[0]
        pick = torch.cat([fi, bi])
        m = len(pick)
        out[i, :m, 1:] = cand[i, pick, 1:]
        out[i, :m, 0] = i
        out[i, m:, 0] = i
        out[i, m:, 1:] = cand[i, 0, 1:]
        sampled[i, :m] = True
        labels[i, :nf] = gt[i, arg[i, fi], 4].long()
        targets[i, :nf] = encode(cand[i, fi, 1:], gt[i, arg[i, fi], :4]) / stds
    return out, labels, sampled, targets


# An L1 residual within this share of its head's largest prediction has a
# sign that rounding may decide: the gt boxes join the rois with targets of
# exactly 0, against predictions near 0 at the published init (normal
# 0.001), and among the RPN's thousand positive deltas a step some lie that
# near their targets. bf16 rounds each operand to 2^-8, and a prediction
# summed from 256-1024 terms that cancel is ~16× smaller than their
# magnitudes, so two computations of it differ by up to ~2^-5 of the
# largest prediction
BOX_TIE_BAND = 2.0 ** -5

# each head's last layer, which an L1 residual's gradient reaches directly
# (the classifier `RCNN_bbox_pred` and the RPN's 1×1 `rpn.deltas`)
LAST_LAYER = {"box": ("RCNN_bbox_pred.weight", "RCNN_bbox_pred.bias"),
              "rpn": ("rpn.deltas.weight", "rpn.deltas.bias")}


def box_l1(pred, target, fg):
    """|pred − target| `[R, 4]`, and its band: the `fg` rows' residuals that
    lie within `BOX_TIE_BAND` of the largest |pred| `[R, 4]` (bool), whose
    gradient sign rounding may decide."""
    res = pred - target
    band = fg[:, None] & (res.detach().abs() <= BOX_TIE_BAND * pred.detach().abs().max())
    return res.abs(), band


def band_entries(res, band, rows, x, div: float) -> tuple:
    """The band's residuals as (k, x, s, div): each one's output of its head's
    last layer (`rows` `[R]`: the first of the row's 4 outputs), that
    layer's input `[M, D]`, the residual's sign and the loss's divisor; the
    entry's gradient in that layer is s / div on the bias's k and s / div ·
    x on the weight's row k."""
    r, j = band.nonzero(as_tuple=True)
    return ((rows[r] + j).detach(), x[r].detach(), torch.sign(res[r, j]).detach(), div)


def absorb_flips(diff: dict, entries: list, weights: list, last: dict = LAST_LAYER):
    """`diff` {leaf: got − want} of a gradient or an update, corrected in
    place where `got`'s computation took a band residual's sign the other
    way round: `entries[i]` {head: (k, x, s, div)} are step i's band
    (`band_entries`), and step i's gradient enters `diff` times
    `weights[i]`. A flipped sign moves `diff` by −2·w·v on the head's last
    layer (v the entry's gradient there); each entry in turn takes
    `diff += c·w·v` with c in [0, 2] closest to `diff`, which makes no
    leaf's ‖diff‖ larger. Returns the entries whose c exceeds 1 (a flip
    more than not)."""
    flips = 0
    for step, w in zip(entries, weights):
        for head, (k, x, s, div) in step.items():
            wn, bn = last[head]
            dw, db = diff[wn].view(diff[wn].shape[0], -1), diff[bn]
            for kk, xx, ss in zip(k.tolist(), x, s.tolist()):
                if ss == 0.0:
                    continue
                v = w * ss / div
                c = -(float(dw[kk] @ xx) + float(db[kk])) / (v * (float(xx @ xx) + 1.0))
                c = min(max(c, 0.0), 2.0)
                dw[kk] += c * v * xx
                db[kk] += c * v
                flips += c > 1.0
    return flips


def losses(p, batch, rois, valid, uniform, c: dict, q=F32) -> dict:
    """The four losses of a train forward, with (`rois` `[B, P, 5]`,
    `valid`) as the proposal layer's output. Also returns the L1 residuals
    within rounding of 0 of each head (`bands`: {"box", "rpn"} as
    `band_entries`) and their count (`box_ties`, `rpn_ties`)."""
    data, gt = batch["data"], batch["gt_boxes"]
    b = data.shape[0]
    t = c["train"]
    ps = neck(p, trunk(p, data, q, frozen_stages=t["fixed_blocks"]), q)
    logits, deltas, hw, hidden = rpn(p, ps, q, features=True)
    anc, _ = anchors(hw, c["anchor_ratios"], data.device)
    labels, targets = anchor_targets(uniform, anc, gt, c)
    norm = float(t["rpn_batchsize"] * b)
    keep = labels >= 0
    rpn_cls = F.binary_cross_entropy_with_logits(logits[keep], labels[keep], reduction="sum")
    pos = labels == 1
    rpn_l1, rpn_band = box_l1(deltas[pos], targets[pos], torch.ones_like(pos[pos]))
    rpn_box = rpn_l1.sum()
    s_rois, s_labels, sampled, s_targets = roi_targets(uniform, rois, valid, gt, c)
    flat = s_rois.reshape(-1, 5)
    logit, bbox, x7 = box_head(p, roi_align_v2(ps[:4], flat), q, features=True)
    lab, smp = s_labels.reshape(-1), sampled.reshape(-1)
    count = max(int(smp.sum()), 1)
    rcnn_cls = F.cross_entropy(logit[smp], lab[smp], reduction="sum") / count
    fg = smp & (lab > 0)
    rows = torch.arange(len(lab), device=lab.device)
    per = bbox.reshape(len(lab), -1, 4)[rows, lab]
    s_targets = s_targets.reshape(-1, 4)
    l1, box_band = box_l1(per, s_targets, fg)
    rcnn_box = l1[fg].sum() / count
    # the RPN's positive anchors: their hidden vectors, and the deltas conv's
    # output of each (anchor a of a cell: outputs 4a..4a+3)
    ib, n = pos.nonzero(as_tuple=True)
    a = len(c["anchor_ratios"])
    flat_hidden = torch.cat([h.permute(0, 2, 3, 1).reshape(b, -1, h.shape[1])
                             for h in hidden], 1)
    bands = {"box": band_entries(per - s_targets, box_band, 4 * lab, x7, count),
             "rpn": band_entries(deltas[pos] - targets[pos], rpn_band, 4 * (n % a),
                                 flat_hidden[ib, n // a], norm)}
    return dict(rpn_cls=rpn_cls / norm, rpn_box=rpn_box / norm, rcnn_cls=rcnn_cls,
                rcnn_box=rcnn_box, fg=fg.sum(), bands=bands, box_ties=box_band.sum(),
                rpn_ties=rpn_band.sum())


def lr_at(t: dict, i: int) -> float:
    """The learning rate of step i (from 0): Detectron2's linear warm-up,
    lr · (f·(1 − i/W) + i/W) for i < W (f `warmup_factor`, W
    `warmup_iters`), then lr."""
    w = t.get("warmup_iters", 0)
    if i >= w:
        return t["lr"]
    a = i / w
    return t["lr"] * (t["warmup_factor"] * (1 - a) + a)


class SGD:
    """SGD with momentum and weight decay on every trained leaf: d = g +
    wd·p, m ← d + μ·m (m = d at the first step), p ← p − lr·m."""

    def __init__(self, params: dict, names, momentum: float, wd: float):
        self.p, self.names = params, list(names)
        self.mu, self.wd = momentum, wd
        self.m = {}

    def step(self, grads: dict, lr: float) -> dict:
        out = {}
        with torch.no_grad():
            for n in self.names:
                d = grads[n] + self.wd * self.p[n]
                self.m[n] = d.clone() if n not in self.m else d + self.mu * self.m[n]
                self.p[n] -= lr * self.m[n]
                out[n] = d
        return out


def train_steps(params: dict, batches, proposals_given, uniforms, c: dict, q=F32):
    """Steps of SGD from `params` (modified in place). `proposals_given[k]`
    is step k's proposal layer output (rois, valid), or None: then the
    proposal layer runs here, on this precision's RPN. Returns each step's
    losses as floats (with `box_ties`, `rpn_ties`), the first step's d of
    each trainable leaf, the leaves' names, the proposals used, and each
    step's L1 band (`losses`' `bands`)."""
    t = c["train"]
    names = [n for n in params if trainable(n, t["fixed_blocks"])]
    opt = SGD(params, names, t["momentum"], t["weight_decay"])
    history, first_d, used, bands = [], None, [], []
    for i, (batch, props, uniform) in enumerate(zip(batches, proposals_given, uniforms)):
        if props is None:
            with torch.no_grad():
                logits, deltas, hw = rpn(params, neck(params, trunk(params, batch["data"], q), q),
                                         q)
                props = proposals(logits, deltas, hw, batch["im_info"], c,
                                  t["rpn_pre_nms_top_n"], t["rpn_post_nms_top_n"],
                                  t["rpn_nms_thresh"])
        used.append(props)
        for n in names:
            params[n].requires_grad_(True)
        out = losses(params, batch, props[0], props[1], uniform, c, q)
        bands.append(out.pop("bands"))
        total = out["rpn_cls"] + out["rpn_box"] + out["rcnn_cls"] + out["rcnn_box"]
        grads = dict(zip(names, torch.autograd.grad(total, [params[n] for n in names])))
        for n in names:
            params[n].requires_grad_(False)
        d = opt.step(grads, lr_at(t, i))
        first_d = d if first_d is None else first_d
        history.append({k: float(v.detach()) for k, v in out.items()}
                       | {"loss": float(total.detach())})
    return history, first_d, names, used, bands
