"""COCO detection evaluation, bbox and segm (copy of the JAX package's
`data/coco_eval.py`).

A numpy rebuild of pycocotools' COCOeval: evaluate, evaluateImg,
accumulate and summarize with the canonical matching order, crowd and
ignore semantics, 101-point precision interpolation and the 12 summary
metrics. `iouType="segm"` computes mask IoU through the RLE core
(`data/mask.py`).
"""

from __future__ import annotations

import copy
import time
from collections import defaultdict

import numpy as np

from .coco_api import COCO, iou_xywh


class Params:
    def __init__(self):
        self.imgIds = []
        self.catIds = []
        self.iouThrs = np.linspace(0.5, 0.95, int(np.round((0.95 - 0.5) / 0.05)) + 1)
        self.recThrs = np.linspace(0.0, 1.00, int(np.round(1.00 / 0.01)) + 1)
        self.maxDets = [1, 10, 100]
        self.areaRng = [
            [0, 1e5 ** 2], [0, 32 ** 2], [32 ** 2, 96 ** 2], [96 ** 2, 1e5 ** 2]
        ]
        self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1
        self.iouType = "bbox"


class COCOeval:
    def __init__(self, cocoGt: COCO = None, cocoDt: COCO = None, iouType: str = "bbox"):
        if iouType not in ("bbox", "segm"):
            raise ValueError(f"unknown iouType {iouType!r}")
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params()
        self.params.iouType = iouType
        self.evalImgs = defaultdict(list)
        self.eval = {}
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        self.stats = []
        self.ious = {}
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    def _prepare(self):
        p = self.params
        gts = self.cocoGt.loadAnns(self.cocoGt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds if p.useCats else []))
        dts = self.cocoDt.loadAnns(self.cocoDt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds if p.useCats else []))
        for gt in gts:
            # an explicit ignore flag is honored IN ADDITION to crowd
            # (reference evaluateImg, cocoeval.py:214-218)
            gt["ignore"] = gt.get("ignore", 0) or (
                "iscrowd" in gt and gt["iscrowd"])
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            self._gts[gt["image_id"], gt["category_id"]].append(gt)
        for dt in dts:
            self._dts[dt["image_id"], dt["category_id"]].append(dt)
        self.evalImgs = defaultdict(list)
        self.eval = {}

    def evaluate(self):
        tic = time.time()
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        p.maxDets = sorted(p.maxDets)
        self.params = p
        self._prepare()
        catIds = p.catIds if p.useCats else [-1]
        self.ious = {
            (imgId, catId): self.computeIoU(imgId, catId)
            for imgId in p.imgIds for catId in catIds
        }
        maxDet = p.maxDets[-1]
        # keyed by (catId, areaRng, imgId) — accumulate() looks entries up
        # directly instead of recovering them from flat-list index arithmetic
        self.evalImgs = {
            (catId, tuple(areaRng), imgId):
                self.evaluateImg(imgId, catId, areaRng, maxDet)
            for catId in catIds
            for areaRng in p.areaRng
            for imgId in p.imgIds
        }
        self._paramsEval = copy.deepcopy(self.params)
        print(f"DONE (t={time.time() - tic:0.2f}s).")

    def computeIoU(self, imgId, catId):
        p = self.params
        if p.useCats:
            gt = self._gts[imgId, catId]
            dt = self._dts[imgId, catId]
        else:
            gt = [_ for cId in p.catIds for _ in self._gts[imgId, cId]]
            dt = [_ for cId in p.catIds for _ in self._dts[imgId, cId]]
        if len(gt) == 0 and len(dt) == 0:
            return []
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds]
        if len(dt) > p.maxDets[-1]:
            dt = dt[0:p.maxDets[-1]]
        iscrowd = [int(o.get("iscrowd", 0)) for o in gt]
        if p.iouType == "segm":
            from . import mask as maskUtils

            g = [maskUtils.ann_to_rle(gg, self.cocoGt) for gg in gt]
            d = [maskUtils.ann_to_rle(dd, self.cocoDt) for dd in dt]
            return maskUtils.iou(d, g, iscrowd)
        g = np.array([gg["bbox"] for gg in gt]).reshape(-1, 4)
        d = np.array([dd["bbox"] for dd in dt]).reshape(-1, 4)
        return iou_xywh(d, g, iscrowd)

    @staticmethod
    def _greedy_match(ious, crowd, ignored, thr):
        """One IoU threshold's greedy assignment over score-ordered dets.

        gts arrive sorted real-first/ignored-last. Each det takes the
        highest-IoU eligible gt at or above `thr`, where eligible means
        unmatched or crowd (crowd gts absorb any number of dets); a real gt
        is ALWAYS preferred over an ignored one, and exact IoU ties resolve
        to the highest gt index — both properties of the canonical COCO
        matcher, which the oracle tests pin bit-for-bit.

        Returns (det_to_gt, gt_to_det): matched counterpart index + 1 per
        slot, 0 = unmatched. For a re-matched crowd gt the LAST det wins.
        """
        n_det, n_gt = ious.shape
        n_real = int(np.count_nonzero(~ignored))
        floor = min(thr, 1 - 1e-10)
        det_to_gt = np.zeros(n_det, dtype=np.int64)
        gt_to_det = np.zeros(n_gt, dtype=np.int64)
        open_slot = ~np.zeros(n_gt, dtype=bool)

        def best(values, ok):
            """Index of the max eligible value, ties to the LAST index;
            -1 when nothing is eligible."""
            if not ok.any():
                return -1
            v = np.where(ok, values, -np.inf)
            top = v.max()
            if top < floor:
                return -1
            return int(np.nonzero(v == top)[0][-1])

        for d in range(n_det):
            row = ious[d]
            eligible = open_slot | crowd
            g = best(row[:n_real], eligible[:n_real])
            if g < 0:
                rel = best(row[n_real:], eligible[n_real:])
                g = -1 if rel < 0 else n_real + rel
            if g < 0:
                continue
            det_to_gt[d] = g + 1
            gt_to_det[g] = d + 1
            open_slot[g] = False
        return det_to_gt, gt_to_det

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        p = self.params
        if p.useCats:
            gt = self._gts[imgId, catId]
            dt = self._dts[imgId, catId]
        else:
            gt = [_ for cId in p.catIds for _ in self._gts[imgId, cId]]
            dt = [_ for cId in p.catIds for _ in self._dts[imgId, cId]]
        if len(gt) == 0 and len(dt) == 0:
            return None

        # a gt is ignored for this area range if flagged or outside the range;
        # sort real-first (stable) and reorder the cached IoU columns to match
        ig = np.array(
            [1 if (g["ignore"] or g["area"] < aRng[0] or g["area"] > aRng[1])
             else 0 for g in gt], dtype=np.int64)
        order = np.argsort(ig, kind="mergesort")
        gt = [gt[i] for i in order]
        ig = ig[order]
        dt = sorted(dt, key=lambda d: -d["score"])[:maxDet]
        # python sorted() is stable like the reference's mergesort argsort
        crowd = np.array([bool(g.get("iscrowd", 0)) for g in gt], dtype=bool)
        ious = self.ious[imgId, catId]
        ious = ious[:, order] if len(ious) > 0 else ious

        T = len(p.iouThrs)
        n_gt, n_dt = len(gt), len(dt)
        gt_ids = np.array([g["id"] for g in gt], dtype=np.float64)
        dt_ids = np.array([d["id"] for d in dt], dtype=np.float64)
        gtm = np.zeros((T, n_gt))
        dtm = np.zeros((T, n_dt))
        dtIg = np.zeros((T, n_dt))
        if len(ious) != 0:
            for ti, thr in enumerate(p.iouThrs):
                d2g, g2d = self._greedy_match(ious, crowd, ig.astype(bool), thr)
                hit = d2g > 0
                dtm[ti, hit] = gt_ids[d2g[hit] - 1]
                dtIg[ti, hit] = ig[d2g[hit] - 1]
                taken = g2d > 0
                gtm[ti, taken] = dt_ids[g2d[taken] - 1]
        # unmatched dets outside the area range are ignored, not FPs
        d_out = np.array([d["area"] < aRng[0] or d["area"] > aRng[1]
                          for d in dt], dtype=bool).reshape(1, n_dt)
        dtIg = np.logical_or(dtIg, (dtm == 0) & d_out)
        return {
            "image_id": imgId,
            "category_id": catId,
            "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": ig,
            "dtIgnore": dtIg,
        }

    def _pr_curve(self, matched, det_ignored, n_real_gt, rec_thrs):
        """Precision at the sampled recall points + final recall, for ONE IoU
        threshold's pooled detections (already score-sorted).

        The precision envelope is made monotonically non-increasing from the
        right (the canonical interpolated-AP rule), then sampled at rec_thrs
        with left-searchsorted indices; recall points past the curve's end
        keep precision 0."""
        counted = ~det_ignored
        tp = np.cumsum(matched & counted).astype(np.float64)
        fp = np.cumsum(~matched & counted).astype(np.float64)
        rc = tp / n_real_gt
        pr = tp / (tp + fp + np.spacing(1))
        final_recall = rc[-1] if rc.size else 0.0
        q = np.zeros(len(rec_thrs))
        if pr.size:
            envelope = np.maximum.accumulate(pr[::-1])[::-1]
            at = np.searchsorted(rc, rec_thrs, side="left")
            ok = at < envelope.size
            q[ok] = envelope[at[ok]]
        return q, final_recall

    def accumulate(self, p=None):
        """Accumulate per-image eval into precision/recall tables.

        Deviation from the reference cocoeval.py: when `p` is narrowed
        relative to what evaluate() ran (`_paramsEval`), results land at each
        category/area/maxDet's IN-PLACE index in `p.catIds` etc. (skipped
        slots stay -1), whereas the reference compacts indices. Standard
        usage (p is _paramsEval) is identical, and summarize()'s
        mean-over->-1 is unaffected either way; the in-place layout keeps
        `eval['precision'][..., k, a, m]` addressable by p's own indices.
        """
        print("Accumulating evaluation results...")
        tic = time.time()
        assert self.evalImgs, "Please run evaluate() first"
        if p is None:
            p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        T, R = len(p.iouThrs), len(p.recThrs)
        K, A, M = len(p.catIds), len(p.areaRng), len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        # restrict to what evaluate() actually computed (p may be narrower
        # or reordered relative to _paramsEval)
        _pe = self._paramsEval
        done_cats = set(_pe.catIds if _pe.useCats else [-1])
        done_areas = set(map(tuple, _pe.areaRng))
        done_imgs = [i for i in p.imgIds if i in set(_pe.imgIds)]
        done_dets = set(_pe.maxDets)

        for k, catId in enumerate(p.catIds):
            if catId not in done_cats:
                continue
            for a, areaRng in enumerate(map(tuple, p.areaRng)):
                if areaRng not in done_areas:
                    continue
                cell = [self.evalImgs.get((catId, areaRng, i))
                        for i in done_imgs]
                cell = [e for e in cell if e is not None]
                if not cell:
                    continue
                n_real_gt = int(sum(
                    np.count_nonzero(np.asarray(e["gtIgnore"]) == 0)
                    for e in cell))
                if n_real_gt == 0:
                    continue
                for m, maxDet in enumerate(p.maxDets):
                    if maxDet not in done_dets:
                        continue
                    # pool every image's top-maxDet dets, then order the pool
                    # by score (stable, like the per-image sort)
                    scores = np.concatenate(
                        [np.asarray(e["dtScores"][:maxDet]) for e in cell])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate(
                        [e["dtMatches"][:, :maxDet] for e in cell],
                        axis=1)[:, order]
                    dtIg = np.concatenate(
                        [e["dtIgnore"][:, :maxDet] for e in cell],
                        axis=1)[:, order]
                    for t in range(T):
                        q, rc_last = self._pr_curve(
                            dtm[t] > 0, dtIg[t] > 0, n_real_gt, p.recThrs)
                        precision[t, :, k, a, m] = q
                        recall[t, k, a, m] = rc_last
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "date": time.strftime("%Y-%m-%d %H:%M:%S"),
            "precision": precision,
            "recall": recall,
        }
        print(f"DONE (t={time.time() - tic:0.2f}s).")

    def summarize(self):
        def _summarize(ap=1, iouThr=None, areaRng="all", maxDets=100):
            p = self.params
            iStr = " {:<18} {} @[ IoU={:<9} | area={:>6s} | maxDets={:>3d} ] = {:0.3f}"
            titleStr = "Average Precision" if ap == 1 else "Average Recall"
            typeStr = "(AP)" if ap == 1 else "(AR)"
            iouStr = (
                f"{p.iouThrs[0]:0.2f}:{p.iouThrs[-1]:0.2f}"
                if iouThr is None
                else f"{iouThr:0.2f}"
            )
            aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
            mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
            if ap == 1:
                s = self.eval["precision"]
                if iouThr is not None:
                    t = np.where(iouThr == p.iouThrs)[0]
                    s = s[t]
                s = s[:, :, :, aind, mind]
            else:
                s = self.eval["recall"]
                if iouThr is not None:
                    t = np.where(iouThr == p.iouThrs)[0]
                    s = s[t]
                s = s[:, :, aind, mind]
            if len(s[s > -1]) == 0:
                mean_s = -1
            else:
                mean_s = np.mean(s[s > -1])
            print(iStr.format(titleStr, typeStr, iouStr, areaRng, maxDets, mean_s))
            return mean_s

        if not self.eval:
            raise Exception("Please run accumulate() first")
        stats = np.zeros((12,))
        stats[0] = _summarize(1)
        stats[1] = _summarize(1, iouThr=0.5, maxDets=self.params.maxDets[2])
        stats[2] = _summarize(1, iouThr=0.75, maxDets=self.params.maxDets[2])
        stats[3] = _summarize(1, areaRng="small", maxDets=self.params.maxDets[2])
        stats[4] = _summarize(1, areaRng="medium", maxDets=self.params.maxDets[2])
        stats[5] = _summarize(1, areaRng="large", maxDets=self.params.maxDets[2])
        stats[6] = _summarize(0, maxDets=self.params.maxDets[0])
        stats[7] = _summarize(0, maxDets=self.params.maxDets[1])
        stats[8] = _summarize(0, maxDets=self.params.maxDets[2])
        stats[9] = _summarize(0, areaRng="small", maxDets=self.params.maxDets[2])
        stats[10] = _summarize(0, areaRng="medium", maxDets=self.params.maxDets[2])
        stats[11] = _summarize(0, areaRng="large", maxDets=self.params.maxDets[2])
        self.stats = stats
        return stats


def cocoval(ann_file: str, res_file: str, iou_type: str = "bbox"):
    """End-to-end COCO eval of a detection json; returns the 12 stats."""
    coco = COCO(ann_file)
    cocoRes = coco.loadRes(res_file)
    cocoEval = COCOeval(coco, cocoRes, iouType=iou_type)
    cocoEval.params.imgIds = cocoRes.getImgIds()
    cocoEval.evaluate()
    cocoEval.accumulate()
    return cocoEval.summarize()
