"""PASCAL VOC AP evaluation (copy of the JAX package's `data/voc_eval.py`).

11-point (VOC07) or area-under-curve AP, difficult handling and the
annotation pickle cache, keyed by image set. The matching is vectorised:
per-image IoU matrices by `bbox_overlaps_np`, then tp/fp by the first
occurrence of each (image, gt) pair over the confidence ranking.

Matching semantics: each detection is compared with ALL gt of its class in
its image (difficult included); its candidate match is the argmax-IoU gt
only. IoU must exceed `ovthresh` strictly; a difficult match produces
neither tp nor fp; a gt already claimed by a higher-confidence detection
turns later matches into fp; `npos` counts non-difficult gt.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET

import numpy as np

from .imdb import bbox_overlaps_np


def parse_rec(filename):
    """Parse a PASCAL VOC xml annotation file into a list of object dicts."""
    tree = ET.parse(filename)
    objects = []
    for obj in tree.findall("object"):
        obj_struct = {
            "name": obj.find("name").text,
            "pose": obj.find("pose").text if obj.find("pose") is not None else "",
            "truncated": int(obj.find("truncated").text) if obj.find("truncated") is not None else 0,
            "difficult": int(obj.find("difficult").text) if obj.find("difficult") is not None else 0,
        }
        bbox = obj.find("bndbox")
        obj_struct["bbox"] = [
            int(float(bbox.find("xmin").text)),
            int(float(bbox.find("ymin").text)),
            int(float(bbox.find("xmax").text)),
            int(float(bbox.find("ymax").text)),
        ]
        objects.append(obj_struct)
    return objects


def voc_ap(rec, prec, use_07_metric=False):
    """AP from a precision/recall curve.

    use_07_metric: the VOC07 11-point average — at each threshold t the best
    precision among points with recall >= t (0 when none). Otherwise the exact
    area under the monotonized curve, summed at recall change points.
    The 11 thresholds use the same `np.arange(0, 1.1, 0.1)` float grid as the
    reference so boundary comparisons (e.g. rec == 0.3 vs t ≈ 0.30000000000000004)
    agree bit-for-bit.
    """
    rec = np.asarray(rec, dtype=np.float64)
    prec = np.asarray(prec, dtype=np.float64)
    if use_07_metric:
        thresholds = np.arange(0.0, 1.1, 0.1)
        reachable = rec[None, :] >= thresholds[:, None]           # [11, D]
        best = np.where(reachable, prec[None, :], 0.0).max(axis=1, initial=0.0)
        return best.sum() / 11.0
    # Envelope: running max of precision from the right, over padded endpoints.
    r = np.concatenate(([0.0], rec, [1.0]))
    p = np.concatenate(([0.0], prec, [0.0]))
    p = np.maximum.accumulate(p[::-1])[::-1]
    step = np.flatnonzero(r[1:] != r[:-1])
    return float(np.sum((r[step + 1] - r[step]) * p[step + 1]))


def _load_annotations(annopath, imagenames, cachefile):
    if os.path.isfile(cachefile):
        with open(cachefile, "rb") as f:
            return pickle.load(f)
    recs = {}
    for i, imagename in enumerate(imagenames):
        recs[imagename] = parse_rec(annopath.format(imagename))
        if i % 100 == 0:
            print(f"Reading annotation for {i + 1}/{len(imagenames)}")
    print(f"Saving cached annotations to {cachefile}")
    with open(cachefile, "wb") as f:
        pickle.dump(recs, f)
    return recs


def voc_eval(detpath, annopath, imagesetfile, classname, cachedir,
             ovthresh=0.5, use_07_metric=False):
    """Per-class VOC AP. detpath/annopath are templates filled with the class
    name / image id. Returns (rec, prec, ap)."""
    if not os.path.isdir(cachedir):
        os.makedirs(cachedir)
    with open(imagesetfile) as f:
        imagenames = [x.strip() for x in f.readlines()]
    # cache keyed by image set (reference voc_eval.py:104) — a shared
    # 'annots.pkl' would serve one split's annotations to another
    setname = os.path.splitext(os.path.basename(imagesetfile))[0]
    recs = _load_annotations(annopath, imagenames,
                             os.path.join(cachedir, f"{setname}_annots.pkl"))

    # Per-image gt for this class.
    gt_boxes = {}
    gt_difficult = {}
    npos = 0
    for imagename in imagenames:
        objs = [o for o in recs[imagename] if o["name"] == classname]
        gt_boxes[imagename] = np.array([o["bbox"] for o in objs],
                                       dtype=np.float64).reshape(-1, 4)
        diff = np.array([bool(o["difficult"]) for o in objs], dtype=bool)
        gt_difficult[imagename] = diff
        npos += int((~diff).sum())

    with open(detpath.format(classname)) as f:
        lines = [x.strip().split(" ") for x in f.readlines()]
    nd = len(lines)
    tp = np.zeros(nd)
    fp = np.zeros(nd)

    if nd > 0:
        image_ids = np.array([x[0] for x in lines])
        confidence = np.array([float(x[1]) for x in lines])
        det_boxes = np.array([[float(z) for z in x[2:]] for x in lines],
                             dtype=np.float64)

        rank = np.argsort(-confidence)
        image_ids = image_ids[rank]
        det_boxes = det_boxes[rank]

        # Candidate match of every detection: argmax-IoU gt in its image.
        best_iou = np.full(nd, -np.inf)
        best_gt = np.zeros(nd, dtype=np.int64)     # per-image gt index
        is_difficult = np.zeros(nd, dtype=bool)
        for imagename in np.unique(image_ids):
            sel = np.flatnonzero(image_ids == imagename)
            gtb = gt_boxes[imagename]
            if gtb.shape[0] == 0:
                continue
            iou = bbox_overlaps_np(det_boxes[sel], gtb)     # [nd_i, ngt_i]
            best_iou[sel] = iou.max(axis=1)
            best_gt[sel] = iou.argmax(axis=1)
            is_difficult[sel] = gt_difficult[imagename][best_gt[sel]]

        matched = best_iou > ovthresh
        live = matched & ~is_difficult
        # A gt is claimed by the highest-ranked live detection that picked it;
        # later picks of the same (image, gt) are duplicates → fp.
        img_codes = np.unique(image_ids, return_inverse=True)[1].astype(np.int64)
        pair_key = np.where(live, img_codes * (best_gt.max() + 1) + best_gt, -1 - np.arange(nd))
        first = np.zeros(nd, dtype=bool)
        first[np.unique(pair_key, return_index=True)[1]] = True

        tp[live & first] = 1.0
        fp[~matched | (live & ~first)] = 1.0
        # matched & difficult → neither.

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(rec, prec, use_07_metric)
    return rec, prec, ap
