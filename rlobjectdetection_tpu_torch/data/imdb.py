"""Image database (imdb) base class and roidb preparation (copy of the JAX
package's `data/imdb.py`).

An imdb names a list of images with their gt box annotations (the
"roidb"). Preparation adds flipped copies and each entry's max-overlap
fields, drops images without boxes, and ranks entries by aspect ratio for
grouped batching (ratio clamped to [0.5, 2], `need_crop` set where it was).
Host-side numpy, as in the JAX package; the dataset root is
`$RLOD_DATA_DIR` (default `./data`).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np


class imdb:
    """Abstract image database (lib/datasets/imdb.py:25)."""

    def __init__(self, name: str, classes=None):
        self._name = name
        self._classes = classes or []
        self._image_index: List = []
        self._roidb = None
        self._roidb_handler = self.default_roidb
        self.config = {}

    @property
    def name(self):
        return self._name

    @property
    def classes(self):
        return self._classes

    @property
    def num_classes(self):
        return len(self._classes)

    @property
    def image_index(self):
        return self._image_index

    @property
    def num_images(self):
        return len(self._image_index)

    @property
    def roidb(self):
        if self._roidb is None:
            self._roidb = self._roidb_handler()
        return self._roidb

    @property
    def roidb_handler(self):
        return self._roidb_handler

    @roidb_handler.setter
    def roidb_handler(self, val):
        self._roidb_handler = val

    @property
    def cache_path(self):
        path = os.path.join(self._data_root(), "cache")
        os.makedirs(path, exist_ok=True)
        return path

    def _data_root(self):
        return os.environ.get("RLOD_DATA_DIR", os.path.join(os.getcwd(), "data"))

    def image_path_at(self, i):
        raise NotImplementedError

    def image_id_at(self, i):
        return i

    def default_roidb(self):
        raise NotImplementedError

    def gt_roidb(self):
        raise NotImplementedError

    def evaluate_detections(self, all_boxes, output_dir=None):
        """all_boxes[cls][image] = N x 5 array (x1, y1, x2, y2, score)
        (imdb.py:99-108)."""
        raise NotImplementedError

    @staticmethod
    def _mirror_entry(entry, width):
        """One flipped roidb entry: x-mirror the boxes under the +1 pixel
        convention (new x1/x2 = width-1 minus old x2/x1)."""
        boxes = entry["boxes"].copy()
        boxes[:, [2, 0]] = width - 1 - boxes[:, [0, 2]]
        assert (boxes[:, 2] >= boxes[:, 0]).all()
        return dict(entry, boxes=boxes, flipped=True)

    def append_flipped_images(self):
        """Horizontal-flip augmentation (imdb.py:114-129): boxes mirrored in x,
        entries appended with flipped=True; image_index doubled."""
        mirrored = [self._mirror_entry(e, w)
                    for e, w in zip(list(self.roidb), self._get_widths())]
        self.roidb.extend(mirrored)
        self._image_index = self._image_index + self._image_index

    def _get_widths(self):
        return [r["width"] for r in self.roidb]

    # recall buckets, keyed by the SIDE bounds (squared below): imdb.py:139-151
    _AREA_SIDES = {"all": (0, 1e5), "small": (0, 32), "medium": (32, 96),
                   "large": (96, 1e5), "96-128": (96, 128),
                   "128-256": (128, 256), "256-512": (256, 512),
                   "512-inf": (512, 1e5)}

    def _recall_candidates(self, i, lo2, hi2, candidate_boxes, limit):
        """Per-image (proposals, in-bucket crowd-free gt boxes, #gt) for
        evaluate_recall."""
        entry = self.roidb[i]
        is_gt = (entry["gt_classes"] > 0) & (entry["gt_overlaps"].max(axis=1) == 1)
        gt_boxes = entry["boxes"][is_gt]
        if "seg_areas" in entry:
            sizes = entry["seg_areas"][is_gt]
        else:
            wh = gt_boxes[:, 2:4] - gt_boxes[:, 0:2] + 1
            sizes = wh[:, 0] * wh[:, 1]
        in_bucket = (sizes >= lo2) & (sizes <= hi2)
        if candidate_boxes is None:
            props = entry["boxes"][entry["gt_classes"] == 0]
        else:
            props = candidate_boxes[i]
        if limit is not None:
            props = props[:limit]
        return props, gt_boxes[in_bucket], int(in_bucket.sum())

    def evaluate_recall(self, candidate_boxes=None, thresholds=None, area="all",
                        limit=None):
        """Proposal-recall eval (imdb.py:131-219), gt-overlap based."""
        lo, hi = self._AREA_SIDES[area]
        gt_overlaps = np.zeros(0)
        num_pos = 0
        for i in range(self.num_images):
            boxes, gt_boxes, n_in = self._recall_candidates(
                i, lo * lo, hi * hi, candidate_boxes, limit)
            num_pos += n_in
            if not (boxes.shape[0] and gt_boxes.shape[0]):
                continue
            ov = bbox_overlaps_np(boxes.astype(float), gt_boxes.astype(float))
            # Greedy one-to-one matching: claim the best remaining
            # (proposal, gt) pair each round and retire both. gt-major flat
            # argmax reproduces the reference's tie order (first gt, then
            # first proposal — imdb.py:187-214).
            picked = np.zeros(gt_boxes.shape[0])
            for j in range(min(gt_boxes.shape[0], boxes.shape[0])):
                # fewer proposals than gts exhausts the matrix: the surplus
                # gts keep overlap 0 (the -1 retirement sentinel must not
                # leak into the returned gt_overlaps)
                gi, bi = divmod(int(ov.T.argmax()), ov.shape[0])
                if ov[bi, gi] < 0:
                    break
                picked[j] = ov[bi, gi]
                ov[bi, :] = -1
                ov[:, gi] = -1
            gt_overlaps = np.hstack((gt_overlaps, picked))
        gt_overlaps = np.sort(gt_overlaps)
        if thresholds is None:
            thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
        thresholds = np.asarray(thresholds, dtype=np.float64)
        recalls = (gt_overlaps[None, :] >= thresholds[:, None]).sum(axis=1) \
            / float(max(num_pos, 1))
        ar = recalls.mean()
        return {"ar": ar, "recalls": recalls, "thresholds": thresholds,
                "gt_overlaps": gt_overlaps}

    def _boxlist_entry(self, boxes, gt_entry):
        """One proposal-file roidb entry: class-0 boxes whose per-class
        gt_overlaps row carries max-IoU against the matching gt class."""
        n = boxes.shape[0]
        cls_iou = np.zeros((n, self.num_classes), dtype=np.float32)
        if gt_entry is not None and gt_entry["boxes"].size:
            iou = bbox_overlaps_np(boxes.astype(float),
                                   gt_entry["boxes"].astype(float))
            best = iou.argmax(axis=1)
            hit = iou[np.arange(n), best]
            rows = np.flatnonzero(hit > 0)
            cls_iou[rows, gt_entry["gt_classes"][best[rows]]] = hit[rows]
        return {"boxes": boxes, "gt_classes": np.zeros(n, np.int32),
                "gt_overlaps": cls_iou, "flipped": False,
                "seg_areas": np.zeros(n, np.float32)}

    def create_roidb_from_box_list(self, box_list, gt_roidb):
        """Proposal-file roidbs (imdb.py:221-248)."""
        assert len(box_list) == self.num_images, "box list length mismatch"
        gts = gt_roidb if gt_roidb is not None else [None] * self.num_images
        return [self._boxlist_entry(b, g) for b, g in zip(box_list, gts)]

    _MERGE = (("boxes", np.vstack), ("gt_classes", np.hstack),
              ("gt_overlaps", np.vstack), ("seg_areas", np.hstack))

    @staticmethod
    def merge_roidbs(a, b):
        assert len(a) == len(b), "roidb length mismatch"
        for ea, eb in zip(a, b):
            for key, cat in imdb._MERGE:
                ea[key] = cat((ea[key], eb[key]))
        return a


def bbox_overlaps_np(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """IoU matrix `[N, K]` with the +1 pixel convention (the upstream
    Cython `bbox_overlaps`)."""
    iw = (
        np.minimum(boxes[:, None, 2], query[None, :, 2])
        - np.maximum(boxes[:, None, 0], query[None, :, 0]) + 1
    )
    ih = (
        np.minimum(boxes[:, None, 3], query[None, :, 3])
        - np.maximum(boxes[:, None, 1], query[None, :, 1]) + 1
    )
    iw = np.clip(iw, 0, None)
    ih = np.clip(ih, 0, None)
    area_b = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    area_q = (query[:, 2] - query[:, 0] + 1) * (query[:, 3] - query[:, 1] + 1)
    inter = iw * ih
    return inter / (area_b[:, None] + area_q[None, :] - inter)


def prepare_roidb(im_db: imdb):
    """Add image size / max_overlap / max_class fields (roidb.py:13-46)."""
    roidb = im_db.roidb
    for i in range(len(roidb)):
        roidb[i]["img_id"] = im_db.image_id_at(i % im_db.num_images)
        roidb[i]["image"] = im_db.image_path_at(i % im_db.num_images)
        gt_overlaps = roidb[i]["gt_overlaps"]
        max_overlaps = gt_overlaps.max(axis=1)
        max_classes = gt_overlaps.argmax(axis=1)
        roidb[i]["max_classes"] = max_classes
        roidb[i]["max_overlaps"] = max_overlaps
        zero_inds = np.where(max_overlaps == 0)[0]
        assert all(max_classes[zero_inds] == 0)
        nonzero_inds = np.where(max_overlaps > 0)[0]
        assert all(max_classes[nonzero_inds] != 0)


def rank_roidb_ratio(roidb):
    """Aspect-ratio sort with clamp to [0.5, 2] + need_crop flag (roidb.py:49-73)."""
    ratio_large = 2
    ratio_small = 0.5
    ratio_list = []
    for entry in roidb:
        width = entry["width"]
        height = entry["height"]
        ratio = width / float(height)
        if ratio > ratio_large:
            entry["need_crop"] = 1
            ratio = ratio_large
        elif ratio < ratio_small:
            entry["need_crop"] = 1
            ratio = ratio_small
        else:
            entry["need_crop"] = 0
        ratio_list.append(ratio)
    ratio_list = np.array(ratio_list)
    ratio_index = np.argsort(ratio_list)
    return ratio_list[ratio_index], ratio_index


def filter_roidb(roidb):
    """Drop images without any usable roi (roidb.py:75-86)."""
    out = [entry for entry in roidb if len(entry["boxes"]) > 0]
    print(f"before filtering, there are {len(roidb)} images...")
    print(f"after filtering, there are {len(out)} images...")
    return out


def combined_roidb(imdb_names: str, training: bool = True, use_flipped: bool = True):
    """Build (possibly '+'-concatenated) roidbs (roidb.py:88-132)."""
    from .factory import get_imdb

    def get_training_roidb(im_db):
        if use_flipped and training:
            print("Appending horizontally-flipped training examples...")
            im_db.append_flipped_images()
            print("done")
        print("Preparing training data...")
        prepare_roidb(im_db)
        print("done")
        return im_db.roidb

    def get_roidb(name):
        im_db = get_imdb(name)
        print(f"Loaded dataset `{im_db.name}`")
        roidb = get_training_roidb(im_db)
        return im_db, roidb

    names = imdb_names.split("+")
    pairs = [get_roidb(s) for s in names]
    im_db, roidb = pairs[0]
    for _, r in pairs[1:]:
        roidb.extend(r)
    if training:
        roidb = filter_roidb(roidb)
    ratio_list, ratio_index = rank_roidb_ratio(roidb)
    return im_db, roidb, ratio_list, ratio_index
