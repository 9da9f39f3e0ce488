"""COCO imdb (copy of the JAX package's `data/coco.py`).

The detection imdb over the COCO json annotations (crowd boxes get -1
overlaps), the results json with a uuid salt and its removal after
scoring, the COCOeval `evaluate_detections` with the mean and per-category
AP print, and `competition_mode`, on the port's own COCO API
(`coco_api.py`, `coco_eval.py`) rather than pycocotools.
"""

from __future__ import annotations

import json
import os
import pickle
import uuid

import numpy as np

from .coco_api import COCO
from .coco_eval import COCOeval
from .imdb import imdb


class coco(imdb):
    def __init__(self, image_set, year, data_path=None):
        super().__init__(f"coco_{year}_{image_set}")
        self._year = year
        self._image_set = image_set
        self._data_path = data_path or os.path.join(self._data_root(), "coco")
        # Results-file hygiene (reference coco.py:31-32): salt the json name so
        # concurrent evals in one output dir don't clobber each other, and
        # scrub it after eval. competition_mode(True) turns both off so the
        # submission file survives under its canonical name.
        self._eval_opts = {"salt": True, "scrub": True}
        self._view_map = {
            "minival2014": "val2014",
            "valminusminival2014": "val2014",
            "test-dev2015": "test2015",
        }
        self._COCO = COCO(self._get_ann_file())
        cats = self._COCO.loadCats(self._COCO.getCatIds())
        self._classes = tuple(["__background__"] + [c["name"] for c in cats])
        self._class_to_ind = dict(zip(self.classes, range(self.num_classes)))
        self._class_to_coco_cat_id = dict(
            zip([c["name"] for c in cats], self._COCO.getCatIds())
        )
        self._image_index = self._load_image_set_index()
        coco_name = image_set + year
        self._data_name = self._view_map.get(coco_name, coco_name)
        self._gt_splits = ("train", "val", "minival")
        self._roidb_handler = self.gt_roidb

    def _get_ann_file(self):
        prefix = "instances" if "test" not in self._image_set else "image_info"
        return os.path.join(
            self._data_path, "annotations",
            f"{prefix}_{self._image_set}{self._year}.json",
        )

    def _load_image_set_index(self):
        return self._COCO.getImgIds()

    def image_path_at(self, i):
        return self.image_path_from_index(self._image_index[i])

    def image_id_at(self, i):
        return self._image_index[i]

    def _stem(self, index):
        """COCO_<data_name>_<12-digit id> (the 2014-era file-name stem)."""
        return f"COCO_{self._data_name}_{index:012d}"

    def image_path_from_index(self, index):
        # images/<data_name>/COCO_<data_name>_<12-digit id>.jpg (coco.py:99-107)
        image_path = os.path.join(
            self._data_path, "images", self._data_name, self._stem(index) + ".jpg"
        )
        if not os.path.exists(image_path):
            # 2017-style layout fallback: images/<data_name>/<12-digit id>.jpg
            fallback = os.path.join(
                self._data_path, "images", self._data_name, f"{index:012d}.jpg"
            )
            assert os.path.exists(fallback), (
                f"image {index} not found under either layout: "
                f"{image_path} / {fallback}")   # reference coco.py asserts too
            image_path = fallback
        return image_path

    def gt_roidb(self):
        cache_file = os.path.join(self.cache_path, self.name + "_gt_roidb.pkl")
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as fid:
                roidb = pickle.load(fid)
            print(f"{self.name} gt roidb loaded from {cache_file}")
            return roidb
        gt_roidb = [self._annotation_record(index) for index in self._image_index]
        with open(cache_file, "wb") as fid:
            pickle.dump(gt_roidb, fid, pickle.HIGHEST_PROTOCOL)
        print(f"wrote gt roidb to {cache_file}")
        return gt_roidb

    def _annotation_record(self, index):
        """One image's annotations → roidb entry.

        Matches reference coco.py:132-188 semantics: xywh → inclusive-pixel
        xyxy with degenerate/zero-area objects dropped, crowd boxes marked
        with overlap −1 across ALL classes (excluded from training). The
        sanitization here is vectorized over the object list rather than the
        reference's per-object clamp chain — same outputs.
        """
        meta = self._COCO.loadImgs(index)[0]
        w, h = meta["width"], meta["height"]
        anns = self._COCO.loadAnns(self._COCO.getAnnIds(imgIds=index, iscrowd=None))

        raw = np.asarray([a["bbox"] for a in anns], dtype=np.float64).reshape(-1, 4)
        area = np.asarray([a["area"] for a in anns], dtype=np.float32)
        left = np.clip(raw[:, 0], 0.0, None)
        top = np.clip(raw[:, 1], 0.0, None)
        right = np.minimum(w - 1.0, left + np.clip(raw[:, 2] - 1.0, 0.0, None))
        bottom = np.minimum(h - 1.0, top + np.clip(raw[:, 3] - 1.0, 0.0, None))
        ok = (area > 0) & (right >= left) & (bottom >= top)

        cls_of_cat = {cid: self._class_to_ind[name]
                      for name, cid in self._class_to_coco_cat_id.items()}
        labels = np.asarray(
            [cls_of_cat[a["category_id"]] for a in anns], dtype=np.int32
        ).reshape(-1)
        crowd = np.asarray(
            [bool(a.get("iscrowd", 0)) for a in anns], dtype=bool
        ).reshape(-1)

        boxes = np.stack([left, top, right, bottom], axis=1)[ok].astype(np.uint16)
        labels = labels[ok]
        crowd = crowd[ok]
        n = int(ok.sum())
        overlaps = np.zeros((n, self.num_classes), dtype=np.float32)
        overlaps[np.arange(n), labels] = 1.0
        overlaps[crowd] = -1.0

        return {
            "width": w,
            "height": h,
            "boxes": boxes,
            "gt_classes": labels,
            "gt_overlaps": overlaps,
            "flipped": False,
            "seg_areas": area[ok],
        }

    def _get_box_file(self, index):
        # Sharded .mat layout for MCG-style proposals: the reference nests
        # file[:14]/file[:22]/file (coco.py:214-220), e.g.
        # COCO_val2014_0/COCO_val2014_000000447/COCO_val2014_000000447991.mat
        name = self._stem(index) + ".mat"
        return os.path.join(name[:14], name[:22], name)

    def _detections_as_json(self, all_boxes):
        """all_boxes[class][image] = [n, 5] xyxy+score → COCO result records
        (xywh, width/height measured in inclusive pixels: +1). Reference
        coco.py:254-301, restructured as one array pass per (class, image)."""
        records = []
        for j in range(1, self.num_classes):
            name = self.classes[j]
            print(f"Collecting {name} results ({j}/{self.num_classes - 1})")
            cat = self._class_to_coco_cat_id[name]
            for i, img_id in enumerate(self.image_index):
                arr = np.asarray(all_boxes[j][i], dtype=np.float64)
                if arr.size == 0:
                    continue
                size = arr[:, 2:4] - arr[:, 0:2] + 1.0
                records.extend(
                    {
                        "image_id": img_id,
                        "category_id": cat,
                        "bbox": [row[0], row[1], wh[0], wh[1]],
                        "score": row[4],
                    }
                    for row, wh in zip(arr, size)
                )
        return records

    @staticmethod
    def _masked_ap(precision_slab):
        """Mean of a COCOeval precision slab over its valid (> −1) cells."""
        valid = precision_slab > -1
        return float(np.mean(precision_slab[valid])) if valid.any() else -1.0

    def _print_detection_eval_metrics(self, coco_eval):
        """Mean + per-category AP over IoU [0.5, 0.95] in the reference's
        print format (coco.py:221-252)."""
        thrs = coco_eval.params.iouThrs
        span = slice(
            int(np.flatnonzero(np.isclose(thrs, 0.5))[0]),
            int(np.flatnonzero(np.isclose(thrs, 0.95))[0]) + 1,
        )
        # precision dims: (iou, recall, cls, area, maxdets); area 0 = all,
        # maxdets 2 = 100
        slab = coco_eval.eval["precision"][span, :, :, 0, 2]
        print("~~~~ Mean and per-category AP @ IoU=[0.50,0.95] ~~~~")
        print(f"{100 * self._masked_ap(slab):.1f}")
        for j in range(1, self.num_classes):   # skip __background__
            print(f"{100 * self._masked_ap(slab[:, :, j - 1]):.1f}")
        print("~~~~ Summary metrics ~~~~")

    def _do_detection_eval(self, res_file, output_dir):
        coco_dt = self._COCO.loadRes(res_file)
        coco_eval = COCOeval(self._COCO, coco_dt, iouType="bbox")
        coco_eval.evaluate()
        coco_eval.accumulate()
        self._print_detection_eval_metrics(coco_eval)
        stats = coco_eval.summarize()
        eval_file = os.path.join(output_dir, "detection_results.pkl")
        with open(eval_file, "wb") as fid:
            pickle.dump(coco_eval, fid, pickle.HIGHEST_PROTOCOL)
        print(f"Wrote COCO eval results to: {eval_file}")
        return stats

    def evaluate_detections(self, all_boxes, output_dir):
        tag = "" if not self._eval_opts["salt"] else f"_{uuid.uuid4()}"
        res_file = os.path.join(
            output_dir,
            f"detections_{self._image_set}{self._year}_results{tag}.json",
        )
        print(f"Writing results json to {res_file}")
        with open(res_file, "w") as fid:
            json.dump(self._detections_as_json(all_boxes), fid)
        stats = None
        if "test" not in self._image_set:
            stats = self._do_detection_eval(res_file, output_dir)
        if self._eval_opts["scrub"]:
            os.remove(res_file)
        return stats

    def competition_mode(self, on):
        # reference coco.py:319-325: submission runs keep the canonical,
        # un-salted results file on disk.
        self._eval_opts["salt"] = not on
        self._eval_opts["scrub"] = not on
