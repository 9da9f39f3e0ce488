"""The RL box-refinement net and its data in plain float32 PyTorch and
NumPy (jbr97/RLObjectDetection): 56 actions move an xywh detection by
±delta·(w, h, w, h) on one coordinate; an action's label is +1 where it
raises the detection's best IoU with the same category's gt (crowd gt by
intersection over the detection's area), else −1, weighted by
exp(|ΔIoU|) times the dataset-wide balance of positives and negatives.
The net: the detector's trunk (frozen), RoIAlignAvg 7×7 at 1/16 on the
detections, layer4 at stride 1 with a trainable BN affine, the spatial
mean, fc8 (4096) + ReLU, fc (56); the loss is the weighted squared error
over B · max(detections) · 56; SGD with momentum, weights at lr with
weight decay (BN scales included), biases at 2·lr without.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from .detector import F32, _stage, roi_align_avg, trunk


def action_deltas(deltas) -> np.ndarray:
    """`[56, 4]`: for each coordinate, +δ0, −δ0, +δ1, −δ1, ... on its column."""
    mags = np.asarray(deltas, np.float32)
    rows = []
    for coord in range(4):
        for m in mags:
            for sign in (1.0, -1.0):
                r = np.zeros(4, np.float32)
                r[coord] = np.float32(sign) * m
                rows.append(r)
    return np.stack(rows)


def iou_xywh(dt, gt, crowd) -> np.ndarray:
    dt, gt = np.asarray(dt, np.float64), np.asarray(gt, np.float64)
    iw = (np.minimum((dt[:, 0] + dt[:, 2])[:, None], (gt[:, 0] + gt[:, 2])[None])
          - np.maximum(dt[:, None, 0], gt[None, :, 0]))
    ih = (np.minimum((dt[:, 1] + dt[:, 3])[:, None], (gt[:, 1] + gt[:, 3])[None])
          - np.maximum(dt[:, None, 1], gt[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    da = (dt[:, 2] * dt[:, 3])[:, None]
    union = da + (gt[:, 2] * gt[:, 3])[None] - inter
    union = np.where(np.asarray(crowd, bool)[None], da, union)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def dious(deltas, box, gts) -> np.ndarray:
    """ΔIoU of each action on one xywh box against its gt list."""
    gtb = [g["bbox"] for g in gts] or [[0, 0, 0, 0]]
    crowd = [int(g.get("iscrowd", 0)) for g in gts] or [0]
    box = np.asarray(box, np.float64)
    origin = iou_xywh([box], gtb, crowd).max()
    moved = box[None] + deltas * np.array([box[2], box[3], box[2], box[3]])
    return iou_xywh(moved, gtb, crowd).max(axis=1) - origin


def _weights(di) -> np.ndarray:
    """exp(|ΔIoU|), taken one value at a time."""
    return np.array([np.exp(np.abs(x)) for x in di])


class Labels:
    """The ΔIoU labels of a COCO gt json and a detections json. The balance
    is taken over the first `max_stat_dets` detections in the order
    RandomState(3) shuffles them, summed in `stat_workers` strided chunks,
    each in order, the chunks' sums then in order."""

    def __init__(self, ann_file, dt_file, c: dict):
        with open(ann_file) as f:
            ann = json.load(f)
        with open(dt_file) as f:
            dts = json.load(f)
        self.images = {im["id"]: im for im in ann["images"]}
        self.img_ids = sorted(self.images)
        self.cat_ids = sorted(cat["id"] for cat in ann["categories"])
        self.gt = defaultdict(list)
        for a in ann["annotations"]:
            self.gt[a["image_id"], a["category_id"]].append(a)
        self.dt = defaultdict(list)
        for d in dts:
            self.dt[d["image_id"], d["category_id"]].append(d)
        self.deltas = action_deltas(c["act_delta"])
        cats = set(self.cat_ids)
        flat = [(k, d) for k, ds in self.dt.items() for d in ds
                if k[0] in self.images and k[1] in cats]
        np.random.RandomState(3).shuffle(flat)
        flat = flat[:c["max_stat_dets"]]
        parts = []
        for chunk in ([flat[i::c["stat_workers"]] for i in range(c["stat_workers"])]
                      if c["stat_workers"] > 1 and len(flat) > 64 else [flat]):
            pt = nt = 0
            pw = nw = 0.0
            for k, d in chunk:
                di = dious(self.deltas, d["bbox"], self.gt.get(k, []))
                pos = di > c["act_iou_thres"]
                w = _weights(di)
                pt, nt = pt + int(pos.sum()), nt + int((~pos).sum())
                pw, nw = pw + float(w[pos].sum()), nw + float(w[~pos].sum())
            parts.append((pt, nt, pw, nw))
        tot = sum(p[0] for p in parts) + sum(p[1] for p in parts)
        self.pos_ratio = tot / max(sum(p[2] for p in parts), 1e-8) / 2.0
        self.neg_ratio = tot / max(sum(p[3] for p in parts), 1e-8) / 2.0
        self.c = c

    def image(self, img_id):
        """(boxes `[n, 7]` = x1, y1, x2, y2, score, cat, img_id; labels
        `[n, 56, 3]` = action, ±1, weight), category by category."""
        boxes, labels = [], []
        for cat in self.cat_ids:
            for d in self.dt.get((img_id, cat), ()):
                b = np.asarray(d["bbox"], np.float64)
                di = dious(self.deltas, b, self.gt.get((img_id, cat), []))
                pos = di > self.c["act_iou_thres"]
                w = _weights(di) * np.where(pos, self.pos_ratio, self.neg_ratio)
                labels.append(np.stack([np.arange(len(di)), np.where(pos, 1.0, -1.0), w], 1))
                boxes.append([b[0], b[1], b[0] + b[2], b[1] + b[3], d["score"], cat, img_id])
        return np.asarray(boxes, np.float32), np.asarray(labels, np.float32)

    def sample(self, root, idx: int, seed: int, epoch: int):
        """The idx-th image of `epoch`: normalised RGB resized (short side
        drawn in [min, max] of `img_short`, long side within `img_size`,
        floors, PIL's default filter), its boxes scaled."""
        c = self.c
        meta = self.images[self.img_ids[idx]]
        rng = np.random.RandomState([seed, epoch, idx])
        img = Image.open(os.path.join(root, meta["file_name"])).convert("RGB")
        w, h = img.size
        size = rng.randint(min(c["img_short"]), max(c["img_short"]) + 1)
        scale = min(size / min(w, h), c["img_size"] / max(w, h))
        img = img.resize((int(np.floor(w * scale)), int(np.floor(h * scale))))
        boxes, labels = self.image(self.img_ids[idx])
        boxes = boxes.copy()
        boxes[:, :4] *= scale
        x = np.asarray(img, np.float32) / 255.0
        x = (x - np.asarray(c["normalize_mean"], np.float32)) / np.asarray(c["normalize_std"],
                                                                          np.float32)
        return x, boxes, labels


def collate(samples) -> dict:
    """Images zero-padded to the batch's canvas (multiples of 32),
    detections to a multiple of 16 with a batch-id column first."""
    ph = (max(s[0].shape[0] for s in samples) + 31) // 32 * 32
    pw = (max(s[0].shape[1] for s in samples) + 31) // 32 * 32
    n = -(-max(max(len(s[1]) for s in samples), 1) // 16) * 16
    a = samples[0][2].shape[1]
    out = {"data": np.zeros((len(samples), ph, pw, 3), np.float32),
           "bboxes": np.zeros((len(samples), n, 8), np.float32),
           "labels": np.zeros((len(samples), n, a, 3), np.float32),
           "num_dts": np.zeros((len(samples),), np.int32)}
    for i, (x, b, lab) in enumerate(samples):
        out["data"][i, :x.shape[0], :x.shape[1]] = x
        out["bboxes"][i, :len(b), 0] = i
        out["bboxes"][i, :len(b), 1:] = b
        out["labels"][i, :len(b)] = lab
        out["num_dts"][i] = len(b)
    return out


def plan(n: int, batch: int, seed: int, epoch: int) -> list:
    order = np.arange(n)
    np.random.RandomState([seed, epoch]).shuffle(order)
    return [(epoch, [int(i) for i in order[s:s + batch]]) for s in range(0, n, batch)]


def trainable(name: str) -> bool:
    return (name.startswith("fc") or (name.startswith("head.") and not
                                       name.endswith((".mean", ".var"))))


def forward(p, data, bboxes, q=F32):
    """Action values `[B·N, 56]`."""
    rois = bboxes.reshape(-1, bboxes.shape[-1])[:, :5].contiguous()
    with torch.no_grad():
        feat = trunk(p, data, q, frozen_stages=3)
    x = _stage(p, "head.layer4", q(roi_align_avg(feat, rois)).permute(0, 3, 1, 2), 1, q, None)
    x = torch.relu(F.linear(q(x.mean(dim=(2, 3))), q(p["fc8.weight"]), p["fc8.bias"]))
    return F.linear(q(x), q(p["fc.weight"]), p["fc.bias"])


def loss_of(pred, batch):
    a = pred.shape[1]
    t = batch["labels"][..., 1].reshape(-1, a)
    w = batch["labels"][..., 2].reshape(-1, a)
    n = int(batch["num_dts"].max().clamp_min(1))
    b, slots = batch["bboxes"].shape[:2]
    mask = (torch.arange(slots, device=pred.device) < n).repeat(b).float()[:, None]
    err = (pred - t) ** 2
    return (err * w).sum() / (b * a * n), (err * mask).sum() / (b * a * n)


def train_steps(params: dict, batches, c: dict, q=F32):
    """SGD steps from `params` (in place): each step's loss, the first
    step's action values and d of each trainable leaf, the leaves."""
    names = [n for n in params if trainable(n)]
    m, hist, first = {}, [], None
    for batch in batches:
        for n in names:
            params[n].requires_grad_(True)
        pred = forward(params, batch["data"], batch["bboxes"], q)
        loss, noweight = loss_of(pred, batch)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        d1 = {}
        with torch.no_grad():
            for n, g in zip(names, grads):
                params[n].requires_grad_(False)
                bias = n.endswith(".bias")
                d = g if bias else g + c["weight_decay"] * params[n]
                m[n] = d.clone() if n not in m else d + c["momentum"] * m[n]
                params[n] -= (2 if bias else 1) * c["lr"] * m[n]
                d1[n] = d
        if first is None:
            first = (pred.detach(), d1)
        hist.append({"loss": float(loss.detach()), "noweight": float(noweight.detach())})
    return hist, first[0], first[1], names
