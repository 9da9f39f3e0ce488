"""Faster R-CNN with a ResNet-101 C4 trunk in plain float32 PyTorch, over a
flat dict of parameters keyed as the benchmark's weights are.

Trunk (conv1..layer3, caffe flavour: stride on the 1×1 convs, 3×3/2 max
pool with ceil mode, frozen BN y = x·s/√(v+ε) + (b − m·s/√(v+ε))), RPN
(3×3 conv-512, 2A-way and 4A-way 1×1 convs; maps flattened in (h, w, a)
order, scores [A bg, A fg]), the proposal layer (decode, clip, top-N,
greedy NMS), RoIAlignAvg (one bilinear sample a cell on an 8×8 grid with
bins over (A−1), then a 2×2 mean to 7×7; samples outside the map are 0),
the layer4 head with a spatial mean, and the two classifiers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .boxes import clip, decode, grid_anchors, greedy_nms, unsuppressed

BLOCKS = {101: (3, 4, 23, 3)}
STAGES = (("layer1", 64, 1), ("layer2", 128, 2), ("layer3", 256, 2))


class Precision:
    """Where the reference rounds: float32 everywhere, or with `fp8` every
    convolution's and matrix product's operands rounded to float8 e4m3 with
    one scale a tensor (the products summed in float32)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
        q = (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        # straight-through: the rounding's gradient is taken as 1
        return t + (q - t).detach()


F32 = Precision()


def param_shapes(num_classes: int, num_anchors: int, layers: int = 101) -> dict:
    """{name: shape} of every weight and BN constant of the detector."""
    shapes = {}

    def conv(name, cout, cin, k, bias=False):
        shapes[name + ".weight"] = (cout, cin, k, k)
        if bias:
            shapes[name + ".bias"] = (cout,)

    def bn(name, c):
        for s in ("scale", "bias", "mean", "var"):
            shapes[f"{name}.{s}"] = (c,)

    def stage(prefix, cin, planes, blocks):
        for i in range(blocks):
            p = f"{prefix}.block{i}"
            conv(p + ".conv1", planes, cin if i == 0 else planes * 4, 1)
            bn(p + ".bn1", planes)
            conv(p + ".conv2", planes, planes, 3)
            bn(p + ".bn2", planes)
            conv(p + ".conv3", planes * 4, planes, 1)
            bn(p + ".bn3", planes * 4)
            if i == 0:
                conv(p + ".downsample_conv", planes * 4, cin, 1)
                bn(p + ".downsample_bn", planes * 4)

    conv("base.conv1", 64, 3, 7)
    bn("base.bn1", 64)
    cin = 64
    for (name, planes, _), blocks in zip(STAGES, BLOCKS[layers]):
        stage("base." + name, cin, planes, blocks)
        cin = planes * 4
    conv("rpn.RPN_Conv", 512, 1024, 3, bias=True)
    conv("rpn.RPN_cls_score", 2 * num_anchors, 512, 1, bias=True)
    conv("rpn.RPN_bbox_pred", 4 * num_anchors, 512, 1, bias=True)
    stage("head.layer4", 1024, 512, BLOCKS[layers][3])
    shapes["RCNN_cls_score.weight"] = (num_classes, 2048)
    shapes["RCNN_cls_score.bias"] = (num_classes,)
    shapes["RCNN_bbox_pred.weight"] = (4 * num_classes, 2048)
    shapes["RCNN_bbox_pred.bias"] = (4 * num_classes,)
    return shapes


def trainable(name: str, fixed_blocks: int = 1) -> bool:
    """Trained by SGD: not a BN constant, not conv1, not layer1..fixed_blocks."""
    if "bn" in name.split(".")[-2] or name.split(".")[-2].endswith("_bn"):
        return False
    if name.startswith("base.conv1"):
        return False
    return not any(name.startswith(f"base.layer{i}.") for i in range(1, fixed_blocks + 1))


def _conv(p, name, x, q, stride=1):
    w = p[name + ".weight"]
    b = p.get(name + ".bias")
    return F.conv2d(q(x), q(w), b, stride, w.shape[-1] // 2)


def _bn(p, name, x, q, hook=None, eps=1e-5):
    """Frozen BN; its output in the precision `q` (the control keeps every
    activation in fp8)."""
    if hook is not None:
        hook(name, x)
    inv = torch.rsqrt(p[name + ".var"] + eps)
    mul = p[name + ".scale"] * inv
    add = p[name + ".bias"] - p[name + ".mean"] * mul
    return q(x * mul[:, None, None] + add[:, None, None])


def _block(p, pre, x, stride, q, hook):
    out = torch.relu(_bn(p, pre + ".bn1", _conv(p, pre + ".conv1", x, q, stride), q, hook))
    out = torch.relu(_bn(p, pre + ".bn2", _conv(p, pre + ".conv2", out, q), q, hook))
    out = _bn(p, pre + ".bn3", _conv(p, pre + ".conv3", out, q), q, hook)
    if pre + ".downsample_conv.weight" in p:
        x = _bn(p, pre + ".downsample_bn", _conv(p, pre + ".downsample_conv", x, q, stride),
                q, hook)
    return q(torch.relu(out + x))


def _stage(p, prefix, x, stride, q, hook):
    i = 0
    while f"{prefix}.block{i}.conv1.weight" in p:
        x = _block(p, f"{prefix}.block{i}", x, stride if i == 0 else 1, q, hook)
        i += 1
    return x


def trunk(p, data, q=F32, hook=None, frozen_stages: int = 1):
    """data `[B, H, W, 3]` (BGR, means subtracted) → `[B, H/16, W/16, 1024]`.
    `hook(bn_name, input)` sees each BN's input first (calibration)."""
    x = data.permute(0, 3, 1, 2)
    x = torch.relu(_bn(p, "base.bn1", _conv(p, "base.conv1", x, q, 2), q, hook))
    x = F.max_pool2d(x, 3, 2, 0, ceil_mode=True)
    for n, (name, _, stride) in enumerate(STAGES, start=1):
        x = _stage(p, "base." + name, x, stride, q, hook)
        if n == frozen_stages:
            x = x.detach()
    return x.permute(0, 2, 3, 1)


def rpn(p, feat, q=F32):
    """→ (scores `[B, H, W, 2A]`, deltas `[B, H, W, 4A]`)."""
    x = torch.relu(_conv(p, "rpn.RPN_Conv", feat.permute(0, 3, 1, 2), q))
    return (_conv(p, "rpn.RPN_cls_score", x, q).permute(0, 2, 3, 1),
            _conv(p, "rpn.RPN_bbox_pred", x, q).permute(0, 2, 3, 1))


def proposals(cls, deltas, im_info, c: dict, pre_n: int, post_n: int, thresh: float):
    """The proposal layer of each image: `[B, post_n, 5]` rois (batch index
    first, zero rows past the kept count)."""
    b, h, w, a2 = cls.shape
    a = a2 // 2
    anchors = torch.from_numpy(grid_anchors(h, w, c["feat_stride"], c["anchor_scales"],
                                            c["anchor_ratios"])).to(cls.device)
    fg = torch.sigmoid(cls[..., a:] - cls[..., :a]).reshape(b, -1)
    boxes = decode(anchors, deltas.reshape(b, -1, 4))
    out = torch.zeros((b, post_n, 5), device=cls.device)
    for i in range(b):
        bi = clip(boxes[i], float(im_info[i, 0]), float(im_info[i, 1]))
        top = torch.argsort(-fg[i], stable=True)[:pre_n]
        keep = greedy_nms(bi[top], fg[i][top], thresh, max_keep=post_n)
        sel = top[torch.from_numpy(keep).to(cls.device)]
        out[i, :len(sel), 0] = i
        out[i, :len(sel), 1:] = bi[sel]
    return out


def proposal_faults(cls, deltas, im_info, rois, c: dict, pre_n: int, post_n: int,
                    thresh: float, box_tol: float = 1e-2, score_eps: float = 1e-6,
                    iou_eps: float = 1e-3) -> tuple[int, int]:
    """The proposal layer of one image held against the RPN outputs it was
    given, `cls` `[H, W, 2A]` and `deltas` `[H, W, 4A]`: its kept rois
    `[K, 5]` (in its order). Returns (foreign, missing): kept boxes that are
    no top-`pre_n` candidate's decoded and clipped box (to `box_tol` px) or
    that come out of descending score order, and candidates that greedy
    NMS at `thresh` must have kept ahead of the last kept one (all, when
    fewer than `post_n` were kept) and that no kept box suppresses. Scores
    within `score_eps`, IoUs within `iou_eps` of the threshold count as
    ties, which rounding decides."""
    h, w, a2 = cls.shape
    a = a2 // 2
    anchors = torch.from_numpy(grid_anchors(h, w, c["feat_stride"], c["anchor_scales"],
                                            c["anchor_ratios"])).to(cls.device)
    cls = cls.float()
    fg = torch.sigmoid(cls[..., a:] - cls[..., :a]).reshape(-1)
    boxes = clip(decode(anchors, deltas.float().reshape(-1, 4)), float(im_info[0]),
                 float(im_info[1]))
    n = fg.numel()
    k = min(pre_n, n)
    s_k = float(torch.sort(fg, descending=True).values[k - 1])
    may = torch.nonzero(fg >= s_k - score_eps).flatten()
    must = torch.ones_like(fg, dtype=torch.bool) if k == n else fg > s_k + score_eps
    got = rois[:, 1:5].float()
    bm, fm = boxes[may], fg[may]
    match = torch.full((len(got),), -1, dtype=torch.long, device=fg.device)
    for s in range(0, len(got), 256):
        d = (got[s:s + 256, None, :] - bm[None]).abs().amax(-1)
        near = d <= box_tol
        best = torch.where(near, fm[None], torch.full_like(d, -1.0)).argmax(1)
        match[s:s + 256] = torch.where(near.any(1), may[best], torch.full_like(best, -1))
    ok = match >= 0
    ms = torch.where(ok, fg[match.clamp_min(0)], torch.full_like(got[:, 0], float("inf")))
    foreign = int((~ok).sum()) + int(((ms[1:] > ms[:-1] + score_eps) & ok[1:] & ok[:-1]).sum())
    taken = torch.zeros_like(fg, dtype=torch.bool)
    taken[match[ok]] = True
    cut = float(ms[-1]) if len(got) == post_n and bool(ok[-1]) else None
    missing = unsuppressed(boxes[must], fg[must], taken[must], got, ms, thresh, cut=cut,
                           score_abs=score_eps, iou_eps=iou_eps)
    return foreign, missing


def rpn_gap(got, want) -> float:
    """The RPN outputs' largest gap over the reference's largest magnitude,
    the worse of scores and deltas: `got` and `want` each (scores, deltas)."""
    return max(float((g.float() - r).abs().max() / r.abs().max().clamp_min(1e-30))
               for g, r in zip(got, want))


def roi_align_avg(feat, rois, pooled: int = 7, scale: float = 1.0 / 16.0):
    """feat `[B, H, W, C]`, rois `[R, 5]` → `[R, P, P, C]`."""
    bsz, h, w, c = feat.shape
    a = pooled + 1
    bi = rois[:, 0].long()
    x1, y1, x2, y2 = (rois[:, k] * scale for k in range(1, 5))
    bin_w = (x2 - x1 + 1.0).clamp_min(0.0) / (a - 1.0)
    bin_h = (y2 - y1 + 1.0).clamp_min(0.0) / (a - 1.0)
    g = torch.arange(a, dtype=torch.float32, device=feat.device)
    ys = g[None] * bin_h[:, None] + y1[:, None]                     # [R, A]
    xs = g[None] * bin_w[:, None] + x1[:, None]
    y0 = torch.floor(ys).clamp_max(h - 2.0)
    x0 = torch.floor(xs).clamp_max(w - 2.0)
    fy, fx = ys - y0, xs - x0
    yi, xi = y0.long().clamp(0, h - 2), x0.long().clamp(0, w - 2)
    inside = ((ys >= 0) & (ys < h))[:, :, None] & ((xs >= 0) & (xs < w))[:, None, :]
    flat = feat.reshape(-1, c)
    row = (bi[:, None] * h + yi)[:, :, None] * w + xi[:, None, :]    # [R, A, A]

    def at(dy, dx):
        return flat[(row + dy * w + dx).reshape(-1)].reshape(len(rois), a, a, c)

    fy, fx = fy[:, :, None, None], fx[:, None, :, None]
    s = (at(0, 0) * ((1 - fy) * (1 - fx)) + at(0, 1) * ((1 - fy) * fx)
         + at(1, 0) * (fy * (1 - fx)) + at(1, 1) * (fy * fx))
    s = s * inside[..., None]
    return 0.25 * (s[:, :-1, :-1] + s[:, :-1, 1:] + s[:, 1:, :-1] + s[:, 1:, 1:])


def head(p, feat, rois, q=F32, hook=None):
    """RoIAlignAvg + layer4 + mean + classifiers for rois `[R, 5]`:
    (class logits `[R, C]`, box deltas `[R, 4C]`)."""
    x = q(roi_align_avg(feat, rois)).permute(0, 3, 1, 2)
    x = _stage(p, "head.layer4", x, 2, q, hook).mean(dim=(2, 3))
    return (F.linear(q(x), q(p["RCNN_cls_score.weight"]), p["RCNN_cls_score.bias"]),
            F.linear(q(x), q(p["RCNN_bbox_pred.weight"]), p["RCNN_bbox_pred.bias"]))


def detect_forward(p, data, im_info, c: dict, q=F32, hook=None, rois=None, out=None):
    """The eval forward of one image: (rois `[R, 5]`, class probabilities
    `[R, C]`, box deltas `[R, 4C]`). `rois` given: those instead of the
    proposal layer's. `out` given: its "rpn" takes the RPN's (scores,
    deltas) of the image."""
    with torch.no_grad():
        feat = trunk(p, data, q, hook)
        if rois is None or out is not None:
            cls, deltas = rpn(p, feat, q)
            if out is not None:
                out["rpn"] = (cls[0], deltas[0])
        if rois is None:
            t = c["test"]
            rois = proposals(cls, deltas, im_info, c, t["rpn_pre_nms_top_n"],
                             t["rpn_post_nms_top_n"], t["rpn_nms_thresh"])[0]
        logits, bbox = head(p, feat, rois, q, hook)
    return rois, torch.softmax(logits, -1), bbox


def class_boxes(rois, bbox, im_info, c: dict):
    """Each roi's box for each class `[R, C, 4]` in the image's own pixels:
    the deltas un-normalised and decoded, clipped to the blob's image,
    divided by its scale."""
    ncls = bbox.shape[1] // 4
    stds = torch.tensor(c["train"]["bbox_normalize_stds"], device=bbox.device).repeat(ncls)
    boxes = decode(rois[:, 1:5], bbox * stds)
    boxes = clip(boxes, float(im_info[0]), float(im_info[1])) / float(im_info[2])
    return boxes.reshape(-1, ncls, 4)


def postprocess(rois, prob, bbox, im_info, c: dict):
    """Test-time detections of one image (test_net.py): `class_boxes`, per
    class greedy NMS at TEST.NMS, the image's `max_per_image` best.
    Returns (boxes `[M, 4]`, scores `[M]`, classes `[M]`) in score order."""
    t = c["test"]
    boxes = class_boxes(rois, bbox, im_info, c)
    cand = []
    for j in range(1, prob.shape[1]):
        keep = greedy_nms(boxes[:, j], prob[:, j], t["nms"], max_keep=t["max_per_image"])
        cand.extend((float(prob[k, j]), j, int(k)) for k in keep)
    cand.sort(key=lambda s: -s[0])
    cand = cand[:t["max_per_image"]]
    idx = torch.tensor([k for _, _, k in cand], dtype=torch.long, device=prob.device)
    cls = torch.tensor([j for _, j, _ in cand], dtype=torch.long, device=prob.device)
    return (boxes[idx, cls].cpu().numpy(), np.asarray([s for s, _, _ in cand], np.float32),
            cls.cpu().numpy())
