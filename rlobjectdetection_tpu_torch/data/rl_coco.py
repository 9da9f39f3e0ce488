"""RL refinement dataset: ΔIoU action labels over base-detector detections
(counterpart of `rlobjectdetection_tpu/data/rl_coco.py`, numpy and PIL only).

For each detection and each of the actions, the xywh box moves by
delta·[w, h, w, h]; its ΔIoU is the change of its best IoU against the
same-category gt (crowd gt by IoF). A label is +1 where ΔIoU > iou_thres,
else −1, weighted by wtrans(ΔIoU) times `pos_wratio` or `neg_wratio`, the
dataset-wide balance of `get_weights_statistics`:
pos_wratio = (pos_tot + neg_tot) / pos_weights / 2.

A sample is (image `[H, W, 3]` normalised RGB, bboxes `[n, 7]` = (x1, y1, x2,
y2, score, cat, img_id) in resized-image coordinates with x2 = x + w (no −1,
unlike the detector's boxes), labels `[n, num_acts, 3]` = (action, target
±1, weight), im_info = [h, w, scale, orig_h, orig_w, filename]).

`COCODataLoader` batches them: the order of an epoch comes from
`RandomState([seed, epoch])` and each item's resize and flip draws from
`RandomState([seed, epoch, index])`, so a resumed run replays the batches
of the run it continues, and `batch_plan()` / `assemble_job(job)` let
`AsyncLoader` assemble them on threads and still yield what `__iter__`
yields.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np
from PIL import Image

from .blob import pad_shape
from .coco_api import COCO, iou_xywh


def normalize_image(rgb: np.ndarray, mean, std) -> np.ndarray:
    """`[H, W, 3]` RGB pixels in 0..255 → (x / 255 - mean) / std, float32
    (ToTensor's scaling, then the RLConfig.normalize_* statistics)."""
    img = np.asarray(rgb, dtype=np.float32) / 255.0
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def collate(samples, num_acts: int, pad_multiple: int = 32) -> dict:
    """Batch samples: images zero-padded to the batch max H/W rounded up to
    `pad_multiple`; detections padded to the batch max rounded up to a
    multiple of 16 (zero label weight there), with a batch-id column
    prepended, so bboxes is `[B, N, 8]` = (batch_id, x1, y1, x2, y2, score,
    cat, img_id). Returns {data, bboxes, labels, num_dts, im_info}."""
    b = len(samples)
    ph, pw = pad_shape(max(s[0].shape[0] for s in samples),
                       max(s[0].shape[1] for s in samples), pad_multiple)
    max_n = max(max(s[1].shape[0] for s in samples), 1)
    max_n = -(-max_n // 16) * 16
    imgs = np.zeros((b, ph, pw, 3), dtype=np.float32)
    bboxes = np.zeros((b, max_n, 8), dtype=np.float32)
    labels = np.zeros((b, max_n, num_acts, 3), dtype=np.float32)
    num_dts = np.zeros((b,), dtype=np.int32)
    im_infos = []
    for i, (img, bx, lb, info) in enumerate(samples):
        imgs[i, : img.shape[0], : img.shape[1]] = img
        n = bx.shape[0]
        num_dts[i] = n
        if n:
            bboxes[i, :n, 0] = i
            bboxes[i, :n, 1:] = bx
            labels[i, :n] = lb
        im_infos.append(info)
    return {"data": imgs, "bboxes": bboxes, "labels": labels,
            "num_dts": num_dts, "im_info": im_infos}


def action_dious(bbox_action, bbox, gts):
    """(origin IoU, ΔIoU `[num_acts]`) of one xywh detection against its
    (image, category) gt list; an empty list counts as one zero box (IoU 0
    everywhere)."""
    gtb = [g["bbox"] for g in gts] or [[0, 0, 0, 0]]
    iscrowd = [int(g.get("iscrowd", 0)) for g in gts] or [0]
    bbox = np.asarray(bbox, dtype=np.float64)
    w, h = bbox[2], bbox[3]
    origin = iou_xywh([bbox], gtb, iscrowd).max()
    moved = bbox[None, :] + bbox_action.actDeltas * np.array([w, h, w, h])
    dious = iou_xywh(moved, gtb, iscrowd).max(axis=1) - origin
    return float(origin), dious


def _stat_chunk(chunk, gt_boxes, bbox_action):
    """(pos_tot, neg_tot, pos_weights, neg_weights) over ((img, cat), dt)
    pairs."""
    pos_tot = neg_tot = 0
    pos_weights = neg_weights = 0.0
    for (img_id, cat_id), dt in chunk:
        _, dious = action_dious(bbox_action, dt["bbox"], gt_boxes[img_id, cat_id])
        pos = dious > bbox_action.iou_thres
        wts = np.array([bbox_action.wtrans(d) for d in dious])
        pos_tot += int(pos.sum())
        neg_tot += int((~pos).sum())
        pos_weights += float(wts[pos].sum())
        neg_weights += float(wts[~pos].sum())
    return pos_tot, neg_tot, pos_weights, neg_weights


def get_weights_statistics(imgIds, catIds, dt_boxes, gt_boxes, bbox_action,
                           shuffle: bool = True, maxDets: int | None = None,
                           num_workers: int = 0):
    """(pos_tot, neg_tot, pos_weights, neg_weights): the label counts over
    the dataset's detections, and the sums of wtrans(ΔIoU) over them.

    The detections are shuffled by `RandomState(3)` and the first `maxDets`
    kept (`None`: all of them). With `num_workers` > 1 (and more than 64
    detections) the pass runs on that many threads over strided chunks: the
    counts are the same, the weight sums equal up to the order of the
    float additions."""
    rng = np.random.RandomState(3)
    # the keys that exist only: probing a defaultdict over imgIds × catIds
    # would insert an empty list for every pair
    img_set, cat_set = set(imgIds), set(catIds)
    flat = [(key, dt) for key, dts in dt_boxes.items()
            if key[0] in img_set and key[1] in cat_set
            for dt in dts]
    if shuffle:
        rng.shuffle(flat)
    if maxDets is not None:
        flat = flat[:maxDets]

    if num_workers and num_workers > 1 and len(flat) > 64:
        from concurrent.futures import ThreadPoolExecutor

        chunks = [flat[i::num_workers] for i in range(num_workers)]
        with ThreadPoolExecutor(num_workers) as pool:
            parts = list(pool.map(lambda c: _stat_chunk(c, gt_boxes, bbox_action), chunks))
    else:
        parts = [_stat_chunk(flat, gt_boxes, bbox_action)]

    pos_tot = sum(p[0] for p in parts)
    neg_tot = sum(p[1] for p in parts)
    pos_weights = max(sum(p[2] for p in parts), 1e-8)
    neg_weights = max(sum(p[3] for p in parts), 1e-8)
    return pos_tot, neg_tot, pos_weights, neg_weights


class COCOTransform:
    """A short side drawn from `rng.randint(min(sizes), max(sizes) + 1)`,
    capped so the long side stays within `max_size`; sizes floored; PIL's
    `Image.resize` with its default filter; with `flip`, a left-right flip
    where `rng.random() < 0.5`. `rng` is the item's stream where the loader
    gives one, else the transform's own (seeded) stream."""

    def __init__(self, sizes, max_size, flip: bool = False, seed: int = 3):
        if not isinstance(sizes, (list, tuple)):
            sizes = [sizes]
        self.scale_min = min(sizes)
        self.scale_max = max(sizes)
        self.max_size = max_size
        self.flip = flip
        self.rng = np.random.RandomState(seed)

    def __call__(self, img: Image.Image, bboxes: np.ndarray,
                 rng: np.random.RandomState | None = None):
        """Returns (scale, resized image, boxes scaled and flipped)."""
        rng = self.rng if rng is None else rng
        image_w, image_h = img.size
        short, large = min(image_w, image_h), max(image_w, image_h)
        size = rng.randint(self.scale_min, self.scale_max + 1)
        scale = min(size / short, self.max_size / large)
        new_w, new_h = int(np.floor(image_w * scale)), int(np.floor(image_h * scale))
        img = img.resize((new_w, new_h))
        if bboxes.shape[0] > 0:
            bboxes = bboxes.copy()
            bboxes[:, :4] *= scale
        if self.flip and rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if bboxes.shape[0] > 0:
                x1 = bboxes[:, 0].copy()
                bboxes[:, 0] = new_w - scale - bboxes[:, 2]
                bboxes[:, 2] = new_w - scale - x1
        return scale, img, bboxes


class COCODataset:
    """The RL training set over a COCO gt json and a detections json
    (`[{image_id, category_id, bbox xywh, score}, ...]`).
    `max_stat_dets` is `get_weights_statistics`'s `maxDets` (None: every
    detection), `stat_workers` its threads."""

    def __init__(self, root_dir, ann_file, dt_file, bbox_action,
                 transform_fn=None, normalize_mean=None, normalize_std=None,
                 max_stat_dets: int | None = 5000, stat_workers: int = 0):
        self.root_dir = root_dir
        self.transform_fn = transform_fn
        self.normalize_mean = normalize_mean
        self.normalize_std = normalize_std
        self.cocoGt = COCO(ann_file, quiet=True)
        self.imgIds = sorted(self.cocoGt.getImgIds())
        self.catIds = sorted(self.cocoGt.getCatIds())

        annIds = self.cocoGt.getAnnIds(imgIds=self.imgIds, catIds=self.catIds)
        self.gt_boxes = defaultdict(list)
        for gt in self.cocoGt.loadAnns(annIds):
            self.gt_boxes[gt["image_id"], gt["category_id"]].append(gt)

        with open(dt_file) as f:
            dt_list = json.load(f)
        self.dt_boxes = defaultdict(list)
        for dt in dt_list:
            self.dt_boxes[dt["image_id"], dt["category_id"]].append(dt)

        self.bbox_action = bbox_action
        self.pos_tot, self.neg_tot, self.pos_weights, self.neg_weights = (
            get_weights_statistics(self.imgIds, self.catIds, self.dt_boxes, self.gt_boxes,
                                   bbox_action, shuffle=True, maxDets=max_stat_dets,
                                   num_workers=stat_workers))
        self.pos_wratio = (self.pos_tot + self.neg_tot) / self.pos_weights / 2.0
        self.neg_wratio = (self.pos_tot + self.neg_tot) / self.neg_weights / 2.0

    def __len__(self):
        return len(self.imgIds)

    def label_detections(self, img_id):
        """(bboxes `[n, 7]` f32, labels `[n, num_acts, 3]` f32) of one
        image's detections, category by category."""
        num_acts = self.bbox_action.num_acts
        bboxes_out, labels_out = [], []
        for cat_id in self.catIds:
            # .get: indexing the defaultdicts would insert an empty list for
            # every (image, category) pair without detections
            for dt_box in self.dt_boxes.get((img_id, cat_id), ()):
                bbox = np.asarray(dt_box["bbox"], dtype=np.float64)
                _, dious = action_dious(self.bbox_action, bbox,
                                        self.gt_boxes.get((img_id, cat_id), []))
                pos = dious > self.bbox_action.iou_thres
                wts = np.array([self.bbox_action.wtrans(d) for d in dious])
                wts = np.where(pos, wts * self.pos_wratio, wts * self.neg_wratio)
                labels_out.append(np.stack([np.arange(num_acts), np.where(pos, 1.0, -1.0),
                                            wts], axis=1))
                xyxy = [bbox[0], bbox[1], bbox[0] + bbox[2], bbox[1] + bbox[3]]
                bboxes_out.append(xyxy + [dt_box["score"], cat_id, img_id])
        if not bboxes_out:
            return (np.zeros((0, 7), dtype=np.float32),
                    np.zeros((0, num_acts, 3), dtype=np.float32))
        return (np.asarray(bboxes_out, dtype=np.float32),
                np.asarray(labels_out, dtype=np.float32))

    def __getitem__(self, idx, rng: np.random.RandomState | None = None):
        """(image, bboxes, labels, im_info) of the idx-th image id; `rng`
        feeds the transform's draws."""
        img_id = self.imgIds[idx]
        meta = self.cocoGt.imgs[img_id]
        filename = os.path.join(self.root_dir, meta["file_name"])
        oh, ow = meta["height"], meta["width"]
        img = Image.open(filename)
        if img.mode != "RGB":
            img = img.convert("RGB")
        bboxes, labels = self.label_detections(img_id)
        if self.transform_fn:
            scale, img, bboxes = self.transform_fn(img, bboxes, rng=rng)
        else:
            scale = 1.0
        rw, rh = img.size
        if self.normalize_mean is not None:
            img_data = normalize_image(img, self.normalize_mean, self.normalize_std)
        else:
            img_data = np.asarray(img, dtype=np.float32) / 255.0
        return img_data, bboxes, labels, [rh, rw, scale, oh, ow, filename]


class COCODataLoader:
    """Batches of `collate` over a `COCODataset`, `batch_size` images each
    (the last may hold fewer); with `shuffle` the order of each epoch is a
    permutation keyed on (seed, epoch)."""

    def __init__(self, dataset: COCODataset, batch_size: int, shuffle: bool = True,
                 pad_multiple: int = 32, seed: int = 3):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.pad_multiple = pad_multiple
        self.seed = seed
        self._epoch = 0     # the epoch of the next batch_plan() / __iter__()

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the next `batch_plan()` / `__iter__()` to epoch's stream."""
        self._epoch = int(epoch)

    def batch_plan(self) -> list:
        """The next epoch's jobs, (epoch, indices) each, in order; the epoch
        after it is next."""
        epoch = self._epoch
        self._epoch += 1
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState([self.seed, epoch]).shuffle(order)
        return [(epoch, [int(i) for i in order[s: s + self.batch_size]])
                for s in range(0, len(order), self.batch_size)]

    def assemble_job(self, job) -> dict:
        """One collated batch of `batch_plan()`; each item draws from
        `RandomState([seed, epoch, index])`."""
        epoch, idxs = job
        return self.collate([self.dataset.__getitem__(
            i, rng=np.random.RandomState([self.seed, epoch, i])) for i in idxs])

    def __iter__(self):
        for job in self.batch_plan():
            yield self.assemble_job(job)

    def collate(self, samples) -> dict:
        return collate(samples, self.dataset.bbox_action.num_acts, self.pad_multiple)
