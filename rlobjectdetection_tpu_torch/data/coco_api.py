"""COCO annotation API (copy of the JAX package's `data/coco_api.py`).

Annotation indexing (createIndex, getAnnIds, getCatIds, getImgIds,
loadAnns, loadCats, loadImgs, info), the loading of detection and
segmentation results (`loadRes`), `annToRLE` / `annToMask` over the RLE
mask API (`data/mask.py`, `native.py`), `showAnns`, and bbox IoU with the
crowd rule (`iou_xywh`, maskApi.c's bbIou). `download` fetches over the
network and is not carried.
"""

from __future__ import annotations

import copy
import json
import time
from collections import defaultdict

import numpy as np


class COCO:
    def __init__(self, annotation_file: str | None = None, quiet: bool = False):
        self.dataset: dict = {}
        self.anns: dict = {}
        self.imgs: dict = {}
        self.cats: dict = {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        if annotation_file is not None:
            if not quiet:
                print("loading annotations into memory...")
            tic = time.time()
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            assert isinstance(self.dataset, dict)
            if not quiet:
                print(f"Done (t={time.time() - tic:0.2f}s)")
            self.createIndex(quiet=quiet)

    def createIndex(self, quiet: bool = False):
        anns, cats, imgs = {}, {}, {}
        imgToAnns = defaultdict(list)
        catToImgs = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            imgToAnns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            if "category_id" in ann:
                catToImgs[ann["category_id"]].append(ann["image_id"])
        self.anns = anns
        self.imgs = imgs
        self.cats = cats
        self.imgToAnns = imgToAnns
        self.catToImgs = catToImgs

    def getAnnIds(self, imgIds=None, catIds=None, areaRng=None, iscrowd=None):
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if imgIds:
            anns = [a for i in imgIds for a in self.imgToAnns.get(i, [])]
        else:
            anns = list(self.anns.values())
        if catIds:
            cs = set(catIds)
            anns = [a for a in anns if a["category_id"] in cs]
        if areaRng:
            anns = [a for a in anns if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=None, supNms=None, catIds=None):
        cats = list(self.cats.values())
        if catNms:
            s = set(_as_list(catNms))
            cats = [c for c in cats if c["name"] in s]
        if supNms:
            s = set(_as_list(supNms))
            cats = [c for c in cats if c.get("supercategory") in s]
        if catIds:
            s = set(_as_list(catIds))
            cats = [c for c in cats if c["id"] in s]
        return sorted(c["id"] for c in cats)

    def getImgIds(self, imgIds=None, catIds=None):
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        ids = set(imgIds) if imgIds else set(self.imgs.keys())
        for i, cid in enumerate(catIds):
            s = set(self.catToImgs.get(cid, []))
            ids = s if (i == 0 and not imgIds) else ids & s
        return sorted(ids)

    def loadAnns(self, ids):
        return [self.anns[i] for i in _as_list(ids)]

    def loadCats(self, ids):
        return [self.cats[i] for i in _as_list(ids)]

    def loadImgs(self, ids):
        return [self.imgs[i] for i in _as_list(ids)]

    def loadRes(self, resFile):
        """Load detection or segmentation results json → a result COCO
        (coco.py:287-325)."""
        res = COCO()
        res.dataset["images"] = [img for img in self.dataset.get("images", [])]
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        elif isinstance(resFile, np.ndarray):
            anns = self.loadNumpyAnnotations(resFile)
        else:
            anns = resFile
        assert isinstance(anns, list), "results in not an array of objects"
        annsImgIds = [ann["image_id"] for ann in anns]
        assert set(annsImgIds) == (set(annsImgIds) & set(self.getImgIds())), (
            "Results do not correspond to current coco set"
        )
        res.dataset["categories"] = copy.deepcopy(self.dataset.get("categories", []))
        for i, ann in enumerate(anns):
            if "bbox" in ann and ann["bbox"] != []:
                bb = ann["bbox"]
                x1, x2, y1, y2 = bb[0], bb[0] + bb[2], bb[1], bb[1] + bb[3]
                if "segmentation" not in ann:
                    ann["segmentation"] = [[x1, y1, x1, y2, x2, y2, x2, y1]]
                ann["area"] = bb[2] * bb[3]
                ann["id"] = i + 1
                ann["iscrowd"] = 0
            elif "segmentation" in ann:
                # segm results: area and bbox from the mask (coco.py:305-309)
                from . import mask as maskUtils

                rle = maskUtils.frPyObjects(ann["segmentation"], 0, 0) \
                    if isinstance(ann["segmentation"], dict) else None
                if rle is None:
                    img = self.imgs[ann["image_id"]]
                    rle = maskUtils.frPyObjects(
                        ann["segmentation"], img["height"], img["width"])
                    if isinstance(rle, list):
                        rle = maskUtils.merge(rle)
                ann["area"] = maskUtils.area(rle)
                ann["bbox"] = maskUtils.toBbox(rle).tolist()
                ann["id"] = i + 1
                ann["iscrowd"] = 0
        res.dataset["annotations"] = anns
        res.createIndex(quiet=True)
        return res

    def annToRLE(self, ann):
        """An annotation's segmentation → RLE (any COCO encoding)."""
        from . import mask as maskUtils

        return maskUtils.ann_to_rle(ann, self)

    def annToMask(self, ann):
        """An annotation's segmentation → binary `[H, W]` mask."""
        from .. import native

        return native.decode(self.annToRLE(ann))

    def info(self):
        """Print the dataset info block (coco.py:128-134)."""
        for key, value in self.dataset.get("info", {}).items():
            print(f"{key}: {value}")

    def showAnns(self, anns):
        """Draw polygon/RLE segmentations and bboxes onto the current
        matplotlib axes (coco.py:241-286); no-ops if matplotlib is absent."""
        if not anns:
            return
        try:
            import matplotlib.pyplot as plt
            from matplotlib.collections import PatchCollection
            from matplotlib.patches import Polygon, Rectangle
        except ImportError:
            return
        ax = plt.gca()
        polygons, colors = [], []
        rng = np.random.RandomState(0)
        for ann in anns:
            c = rng.rand(3) * 0.6 + 0.4
            seg = ann.get("segmentation")
            if isinstance(seg, list):
                for poly in seg:
                    pts = np.asarray(poly).reshape(-1, 2)
                    polygons.append(Polygon(pts, closed=True))
                    colors.append(c)
            elif "bbox" in ann:
                x, y, w, h = ann["bbox"]
                ax.add_patch(Rectangle((x, y), w, h, fill=False, color=c))
        if polygons:
            ax.add_collection(
                PatchCollection(polygons, facecolor=colors, alpha=0.4))

    def loadNumpyAnnotations(self, data):
        assert data.shape[1] == 7
        out = []
        for i in range(data.shape[0]):
            out.append(
                {
                    "image_id": int(data[i, 0]),
                    "bbox": [data[i, 1], data[i, 2], data[i, 3], data[i, 4]],
                    "score": data[i, 5],
                    "category_id": int(data[i, 6]),
                }
            )
        return out


def _as_list(x):
    if x is None:
        return []
    return x if isinstance(x, (list, tuple)) else [x]


def iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd=None) -> np.ndarray:
    """bbox IoU matching the vendored maskApi.c bbIou: crowd gt uses IoF
    (intersection / dt area). dt [N,4], gt [K,4] in xywh → [N,K]."""
    dt = np.asarray(dt, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    n, k = dt.shape[0], gt.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    dx2 = dt[:, 0] + dt[:, 2]
    dy2 = dt[:, 1] + dt[:, 3]
    gx2 = gt[:, 0] + gt[:, 2]
    gy2 = gt[:, 1] + gt[:, 3]
    iw = np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dt[:, None, 0], gt[None, :, 0])
    ih = np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dt[:, None, 1], gt[None, :, 1])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None, :]
    union = da + ga - inter
    if iscrowd is not None:
        crowd = np.asarray(iscrowd, dtype=bool)
        union = np.where(crowd[None, :], da, union)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(union > 0, inter / union, 0.0)
    return out
