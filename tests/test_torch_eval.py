"""The port's evaluation against the JAX package's, on the same detections.

Each package writes its synthetic VOC devkit and COCO tree from the same
seed into a root of its own; detections are made once, from the gt with a
seeded jitter, extra boxes and random scores, and scored by both:
`voc_eval` (with and without the VOC07 11-point metric),
`pascal_voc.evaluate_detections`' AP table, `iou_xywh` with crowd gt,
COCOeval's 12 stats on perfect and on shifted detections, and
`coco.evaluate_detections`' printed AP table and stats. Bound: 1e-9 (the
same numpy arithmetic). Detections equal to the gt score AP 1.0 in both.
"""

import copy
import os
import pickle
import re

import numpy as np
import pytest

from rlobjectdetection_tpu.data import coco_api as jax_coco_api
from rlobjectdetection_tpu.data import coco_eval as jax_coco_eval
from rlobjectdetection_tpu.data import synthetic as jax_synthetic
from rlobjectdetection_tpu.data import voc_eval as jax_voc_eval
from rlobjectdetection_tpu.data.coco import coco as jax_coco
from rlobjectdetection_tpu.data.pascal_voc import pascal_voc as jax_pascal_voc
from rlobjectdetection_tpu_torch.data import coco_api, coco_eval, synthetic, voc_eval
from rlobjectdetection_tpu_torch.data.coco import coco
from rlobjectdetection_tpu_torch.data.pascal_voc import pascal_voc
from test_torch_data import VOC_CLASSES, data_dir
import torch_threads  # noqa: F401  (xdist workers share the cores)

TOL = 1e-9


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    out = []
    for name, module in (("jax_eval", jax_synthetic), ("port_eval", synthetic)):
        root = tmp_path_factory.mktemp(name)
        module.make_voc_devkit(str(root), num_images=6, image_size=(72, 96),
                               classes=VOC_CLASSES)
        module.make_coco_dataset(str(root), num_images=8, image_size=(80, 64),
                                 crowd_fraction=0.3)
        out.append(root)
    return tuple(out)


def jittered(boxes, rng, extra=2, shift=6.0):
    """gt boxes `[G, 4]` moved by up to `shift` px, plus `extra` random
    boxes, each with a random score: `[G + extra, 5]`."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    moved = boxes + rng.uniform(-shift, shift, boxes.shape)
    xy = rng.uniform(0, 50, (extra, 2))
    fake = np.concatenate([xy, xy + rng.uniform(5, 30, (extra, 2))], 1)
    dets = np.concatenate([moved, fake])
    return np.concatenate([dets, rng.rand(len(dets), 1)], 1).astype(np.float32)


def all_boxes_from(roidb, num_classes, rng, exact=False):
    """all_boxes[cls][img] from each image's gt: exact with score 1, or
    jittered with extra boxes."""
    out = [[np.zeros((0, 5), np.float32) for _ in roidb] for _ in range(num_classes)]
    for i, e in enumerate(roidb):
        for c in range(1, num_classes):
            gt = e["boxes"][e["gt_classes"] == c].astype(np.float32)
            if exact:
                out[c][i] = np.concatenate([gt, np.ones((len(gt), 1), np.float32)], 1)
            elif len(gt) or rng.rand() < 0.3:
                out[c][i] = jittered(gt, rng, extra=int(rng.randint(0, 3)))
    return out


def _voc_imdbs(roots):
    with data_dir(roots[0]):
        want = jax_pascal_voc("test", "2007")
        want.gt_roidb()
    with data_dir(roots[1]):
        got = pascal_voc("test", "2007")
        got.gt_roidb()
    return got, want


@pytest.mark.parametrize("use_07_metric", [True, False])
def test_voc_eval_matches_jax(roots, tmp_path, use_07_metric):
    got_db, _ = _voc_imdbs(roots)
    rng = np.random.RandomState(11)
    detpath = str(tmp_path / "det_{:s}.txt")
    for cls in VOC_CLASSES:
        with open(detpath.format(cls), "w") as f:
            for idx, e in zip(got_db.image_index, got_db.roidb):
                gt = e["boxes"][e["gt_classes"] == got_db._class_to_ind[cls]]
                for d in jittered(gt + 1, rng):
                    f.write(f"{idx} {d[4]:.3f} {d[0]:.1f} {d[1]:.1f} {d[2]:.1f} {d[3]:.1f}\n")
    results = []
    for root, module in ((roots[1], voc_eval), (roots[0], jax_voc_eval)):
        voc = os.path.join(root, "VOCdevkit2007", "VOC2007")
        results.append([module.voc_eval(
            detpath, os.path.join(voc, "Annotations", "{:s}.xml"),
            os.path.join(voc, "ImageSets", "Main", "test.txt"), cls,
            str(tmp_path / f"cache_{module.__name__}"), 0.5, use_07_metric)
            for cls in VOC_CLASSES])
    for (grec, gprec, gap), (wrec, wprec, wap) in zip(*results):
        np.testing.assert_allclose(grec, wrec, rtol=0, atol=TOL)
        np.testing.assert_allclose(gprec, wprec, rtol=0, atol=TOL)
        assert abs(gap - wap) <= TOL and 0 < gap < 1
    rec = np.array([0.1, 0.3, 0.3, 0.5, 0.9])
    prec = np.array([1.0, 0.8, 0.7, 0.6, 0.4])
    assert abs(voc_eval.voc_ap(rec, prec, use_07_metric)
               - jax_voc_eval.voc_ap(rec, prec, use_07_metric)) <= TOL


def _ap_table(out_dir):
    return {cls: pickle.load(open(os.path.join(out_dir, cls + "_pr.pkl"), "rb"))["ap"]
            for cls in VOC_CLASSES}


@pytest.mark.parametrize("exact", [False, True])
def test_pascal_voc_evaluate_detections_matches_jax(roots, tmp_path, exact):
    got_db, want_db = _voc_imdbs(roots)
    all_boxes = all_boxes_from(got_db.roidb, got_db.num_classes, np.random.RandomState(12),
                               exact)
    with data_dir(roots[1]):
        got = got_db.evaluate_detections(copy.deepcopy(all_boxes), str(tmp_path / "port"))
    with data_dir(roots[0]):
        want = want_db.evaluate_detections(copy.deepcopy(all_boxes), str(tmp_path / "jax"))
    gtab, wtab = _ap_table(str(tmp_path / "port")), _ap_table(str(tmp_path / "jax"))
    assert abs(got - want) <= TOL
    for cls in VOC_CLASSES:
        assert abs(gtab[cls] - wtab[cls]) <= TOL, cls
        if exact:
            assert gtab[cls] == wtab[cls] == 1.0
    # the salted per-class result files are removed after scoring
    assert not any(f.endswith(".txt") for _, _, fs in os.walk(tmp_path / "port") for f in fs)


def test_iou_xywh_with_crowd_matches_jax():
    rng = np.random.RandomState(13)
    dt = np.concatenate([rng.uniform(0, 60, (9, 2)), rng.uniform(1, 40, (9, 2))], 1)
    gt = np.concatenate([dt[:5, :2] + rng.uniform(-5, 5, (5, 2)), rng.uniform(1, 40, (5, 2))], 1)
    crowd = np.array([0, 1, 0, 1, 0])
    got = coco_api.iou_xywh(dt, gt, crowd)
    want = jax_coco_api.iou_xywh(dt, gt, crowd)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert (got[:, 1] != coco_api.iou_xywh(dt, gt)[:, 1]).any()   # crowd: IoF
    assert coco_api.iou_xywh(dt[:0], gt).shape == (0, 5)


def _coco_results(gt_api, rng, shift):
    res = []
    for ann in gt_api.dataset["annotations"]:
        x, y, w, h = ann["bbox"]
        dx, dy = rng.uniform(-shift, shift, 2) if shift else (0.0, 0.0)
        res.append({"image_id": ann["image_id"], "category_id": ann["category_id"],
                    "bbox": [x + dx, y + dy, w, h], "score": float(rng.rand())})
    if shift:
        for img in gt_api.dataset["images"][:3]:
            res.append({"image_id": img["id"], "category_id": 1,
                        "bbox": [5.0, 5.0, 20.0, 15.0], "score": float(rng.rand())})
    return res


@pytest.mark.parametrize("shift", [0.0, 8.0])
def test_cocoeval_stats_match_jax(roots, shift):
    stats = []
    for root, api, ev in ((roots[1], coco_api, coco_eval), (roots[0], jax_coco_api,
                                                             jax_coco_eval)):
        ann = os.path.join(root, "coco", "annotations", "instances_minival2014.json")
        gt = api.COCO(ann, quiet=True)
        e = ev.COCOeval(gt, gt.loadRes(_coco_results(gt, np.random.RandomState(14), shift)))
        e.evaluate()
        e.accumulate()
        stats.append(e.summarize())
    np.testing.assert_allclose(stats[0], stats[1], rtol=0, atol=TOL)
    if shift == 0.0:
        assert stats[0][0] == stats[0][1] == 1.0
    else:
        assert 0 < stats[0][0] < 1


def test_cocoeval_refuses_segm(roots):
    """Only an unknown iouType is refused now: segm runs. On the COCO tree
    with each gt's box as its polygon, the shifted boxes' polygons as segm
    results give JAX's 12 stats (the same numpy on the same mask IoUs)."""
    with pytest.raises(ValueError, match="iouType"):
        coco_eval.COCOeval(iouType="keypoints")
    stats = []
    for root, api, ev in ((roots[1], coco_api, coco_eval), (roots[0], jax_coco_api,
                                                             jax_coco_eval)):
        ann = os.path.join(root, "coco", "annotations", "instances_minival2014.json")
        gt = api.COCO(ann, quiet=True)
        for a in gt.dataset["annotations"]:
            x, y, w, h = a["bbox"]
            a["segmentation"] = [[x, y, x + w, y, x + w, y + h, x, y + h]]
        res = []
        for r in _coco_results(gt, np.random.RandomState(14), 8.0):
            x, y, w, h = r.pop("bbox")
            res.append({**r, "segmentation": [[x, y, x + w, y, x + w, y + h, x, y + h]]})
        e = ev.COCOeval(gt, gt.loadRes(res), iouType="segm")
        e.evaluate()
        e.accumulate()
        stats.append(e.summarize())
    np.testing.assert_allclose(stats[0], stats[1], rtol=0, atol=TOL)
    assert 0 < stats[0][0] < 1


def _printed_table(text):
    block = text.split("~~~~ Mean and per-category AP @ IoU=[0.50,0.95] ~~~~")[1]
    return block.split("~~~~ Summary metrics ~~~~")[0].split()


def test_coco_evaluate_detections_matches_jax(roots, tmp_path, capsys):
    out = []
    for root, cls, name in ((roots[1], coco, "port"), (roots[0], jax_coco, "jax")):
        with data_dir(root):
            db = cls("minival", "2014")
            roidb = db.gt_roidb()
            boxes = all_boxes_from(roidb, db.num_classes, np.random.RandomState(15))
            os.makedirs(tmp_path / name)
            capsys.readouterr()
            stats = db.evaluate_detections(boxes, str(tmp_path / name))
        text = capsys.readouterr().out
        out.append((stats, _printed_table(text),
                    re.findall(r"\] = (-?[0-9.]+)", text)))
        # salted results json removed after scoring
        assert not [f for f in os.listdir(tmp_path / name) if f.endswith(".json")]
    (gstats, gtable, gsummary), (wstats, wtable, wsummary) = out
    np.testing.assert_allclose(gstats, wstats, rtol=0, atol=TOL)
    assert gtable == wtable and len(gtable) == 4       # mean + 3 categories
    assert gsummary == wsummary and len(gsummary) == 12
    assert 0 < gstats[0] < 1
