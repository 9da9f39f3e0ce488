"""The port's RLE mask core (`native.py`, `csrc/maskrle.cpp`), its
pycocotools-style API (`data/mask.py`) and the segm paths of its COCO API
and COCOeval against the JAX package, on the same seeded masks, polygons
and boxes. Everything is integer runs or float64 arithmetic on the same
inputs in the same order, so every comparison is exact.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rlobjectdetection_tpu import native as jax_native
from rlobjectdetection_tpu.data import mask as jax_mask
from rlobjectdetection_tpu.data.coco_api import COCO as JaxCOCO
from rlobjectdetection_tpu.data.coco_eval import COCOeval as JaxCOCOeval
from rlobjectdetection_tpu_torch import native
from rlobjectdetection_tpu_torch.data import mask
from rlobjectdetection_tpu_torch.data.coco_api import COCO
from rlobjectdetection_tpu_torch.data.coco_eval import COCOeval
import torch_threads  # noqa: F401  (xdist workers share the cores)


def _blob_mask(h, w, cx, cy, r):
    yy, xx = np.mgrid[0:h, 0:w]
    return ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.uint8)


def _masks(rng, n=6, h=37, w=53):
    out = [(rng.rand(h, w) < rng.rand()).astype(np.uint8) for _ in range(n // 2)]
    out += [_blob_mask(h, w, rng.randint(5, w - 5), rng.randint(5, h - 5), rng.randint(3, 15))
            for _ in range(n - n // 2)]
    out[0][:] = 0                                     # an empty mask
    return out


def _same_rle(a, b):
    assert (a.h, a.w) == (b.h, b.w)
    np.testing.assert_array_equal(a.counts, b.counts)


def test_native_matches_jax_on_seeded_masks(rng):
    masks = _masks(rng)
    port = [native.encode(m) for m in masks]
    want = [jax_native.encode(m) for m in masks]
    for m, p, j in zip(masks, port, want):
        _same_rle(p, j)
        np.testing.assert_array_equal(native.decode(p), m)
        assert native.area(p) == jax_native.area(j) == int(m.sum())
        np.testing.assert_array_equal(native.to_bbox(p), jax_native.to_bbox(j))
    for a, b in zip(port[:-1], port[1:]):
        ja, jb = jax_native.RLE(a.h, a.w, a.counts), jax_native.RLE(b.h, b.w, b.counts)
        for inter in (False, True):
            _same_rle(native.merge(a, b, inter), jax_native.merge(ja, jb, inter))
    crowd = [0, 1, 0, 1, 1, 0]
    np.testing.assert_array_equal(native.iou(port, port[::-1], crowd),
                                  jax_native.iou(want, want[::-1], crowd))
    np.testing.assert_array_equal(native.iou(port, port), jax_native.iou(want, want))
    with pytest.raises(ValueError):
        native.iou(port, port, [0, 1])


def test_native_boxes_and_polygons_match_jax(rng):
    h, w = 41, 59
    boxes = np.c_[rng.uniform(-5, w, 8), rng.uniform(-5, h, 8),
                  rng.uniform(0, 30, 8), rng.uniform(0, 25, 8)]
    for b in boxes:
        _same_rle(native.from_bbox(b, h, w), jax_native.from_bbox(b, h, w))
    crowd = rng.randint(0, 2, 8)
    np.testing.assert_array_equal(native.iou(boxes, boxes[::-1], crowd),
                                  jax_native.iou(boxes, boxes[::-1], crowd))
    for k in (3, 5, 9):
        poly = np.c_[rng.uniform(-3, w + 3, k), rng.uniform(-3, h + 3, k)].reshape(-1)
        _same_rle(native.from_poly(poly, h, w), jax_native.from_poly(poly, h, w))


def test_mask_api_matches_jax(rng):
    h, w = 33, 47
    masks = _masks(rng, 4, h, w)
    for m in masks:
        enc = mask.encode(m)
        assert enc == jax_mask.encode(m)
        counts = native.encode(m).counts
        assert mask.rle_to_string(counts) == jax_mask.rle_to_string(counts)
        assert mask.string_to_rle_counts(enc["counts"]) == \
            jax_mask.string_to_rle_counts(enc["counts"]) == counts.tolist()
        np.testing.assert_array_equal(mask.decode(enc), m)
        assert mask.area(enc) == jax_mask.area(enc)
        np.testing.assert_array_equal(mask.toBbox(enc), jax_mask.toBbox(enc))
        uncompressed = {"size": [h, w], "counts": counts.tolist()}
        _same_rle(mask.frPyObjects(uncompressed, h, w), jax_mask.frPyObjects(uncompressed, h, w))
    polys = [list(np.c_[rng.uniform(0, w, 5), rng.uniform(0, h, 5)].reshape(-1))
             for _ in range(3)]
    boxes = [list(rng.uniform(0, 20, 4)) for _ in range(3)]
    for objs in (polys, boxes, np.asarray(boxes), [mask.encode(m) for m in masks]):
        for p, j in zip(mask.frPyObjects(objs, h, w), jax_mask.frPyObjects(objs, h, w)):
            _same_rle(p, j)
    encs = [mask.encode(m) for m in masks]
    for inter in (False, True):
        _same_rle(mask.merge(encs, inter), jax_mask.merge(encs, inter))
    crowd = [1, 0, 0, 1]
    np.testing.assert_array_equal(mask.iou(encs, encs[::-1], crowd),
                                  jax_mask.iou(encs, encs[::-1], crowd))
    np.testing.assert_array_equal(mask.iou(boxes, boxes), jax_mask.iou(boxes, boxes))
    assert mask.iou([], encs).shape == (0, 4)
    coco = JaxCOCO()
    coco.imgs = {7: {"height": h, "width": w}}
    for seg in (polys, encs[1]):
        _same_rle(mask.ann_to_rle({"image_id": 7, "segmentation": seg}, coco),
                  jax_mask.ann_to_rle({"image_id": 7, "segmentation": seg}, coco))


def _segm_fixture(root, maskmod):
    """`tests/test_segm_eval.py`'s fixture: two images, three gt masks (one
    crowd), four segm detections (a shifted match, a duplicate, a false
    positive, one inside the crowd), encoded with `maskmod`."""
    h, w = 64, 96
    imgs = [{"id": i, "height": h, "width": w, "file_name": f"{i}.jpg"} for i in (1, 2)]
    cats = [{"id": 1, "name": "thing", "supercategory": "none"}]
    anns, dets = [], []

    def add_gt(img, m, iscrowd=0):
        enc = maskmod.encode(m)
        anns.append({"id": len(anns) + 1, "image_id": img, "category_id": 1,
                     "segmentation": {"size": enc["size"], "counts": enc["counts"]},
                     "bbox": maskmod.toBbox(enc).tolist(), "area": float(m.sum()),
                     "iscrowd": iscrowd})

    def add_dt(img, m, score):
        enc = maskmod.encode(m)
        dets.append({"image_id": img, "category_id": 1, "score": score,
                     "segmentation": {"size": enc["size"], "counts": enc["counts"]}})

    g1 = _blob_mask(h, w, 30, 30, 12)
    add_gt(1, g1)
    add_gt(1, _blob_mask(h, w, 70, 20, 8))
    add_gt(2, _blob_mask(h, w, 40, 40, 15), iscrowd=1)
    add_dt(1, np.roll(g1, 2, axis=1), 0.9)
    add_dt(1, np.roll(g1, 4, axis=0), 0.8)
    add_dt(1, _blob_mask(h, w, 85, 50, 6), 0.7)
    add_dt(2, _blob_mask(h, w, 42, 41, 10), 0.6)
    os.makedirs(root, exist_ok=True)
    gt_file, dt_file = os.path.join(root, "gt.json"), os.path.join(root, "dt.json")
    with open(gt_file, "w") as f:
        json.dump({"images": imgs, "annotations": anns, "categories": cats}, f)
    with open(dt_file, "w") as f:
        json.dump(dets, f)
    return gt_file, dt_file


def _segm_eval(coco_cls, eval_cls, gt_file, dt_file):
    gt = coco_cls(gt_file, quiet=True)
    dt = gt.loadRes(dt_file)
    ev = eval_cls(gt, dt, iouType="segm")
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return gt, dt, ev


def test_segm_cocoeval_matches_jax(tmp_path):
    port_files = _segm_fixture(str(tmp_path / "port"), mask)
    jax_files = _segm_fixture(str(tmp_path / "jax"), jax_mask)
    for a, b in zip(port_files, jax_files):
        assert open(a).read() == open(b).read()
    gt, dt, ev = _segm_eval(COCO, COCOeval, *port_files)
    jgt, jdt, jev = _segm_eval(JaxCOCO, JaxCOCOeval, *jax_files)
    np.testing.assert_array_equal(np.asarray(ev.stats), np.asarray(jev.stats))
    np.testing.assert_array_equal(ev.eval["precision"], jev.eval["precision"])
    np.testing.assert_array_equal(ev.eval["recall"], jev.eval["recall"])
    assert 0.0 < ev.stats[1] <= 1.0 and ev.stats[0] < 1.0
    for a, b in zip(dt.loadAnns(dt.getAnnIds()), jdt.loadAnns(jdt.getAnnIds())):
        assert (a["area"], a["bbox"], a["id"], a["iscrowd"]) == \
            (b["area"], b["bbox"], b["id"], b["iscrowd"])
    for a, b in zip(gt.loadAnns(gt.getAnnIds()), jgt.loadAnns(jgt.getAnnIds())):
        _same_rle(gt.annToRLE(a), jgt.annToRLE(b))
        np.testing.assert_array_equal(gt.annToMask(a), jgt.annToMask(b))


def test_segm_loadres_takes_polygons_and_gt_as_detections_score_1(tmp_path):
    """Polygon results get the merged mask's area and bbox; the gt masks
    scored as detections give AP 1.0 (and JAX's stats, exactly)."""
    h, w = 50, 70
    imgs = [{"id": 1, "height": h, "width": w}]
    cats = [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]
    polys = [[[5, 5, 30, 5, 30, 25, 5, 25]], [[40, 10, 65, 12, 60, 45, 42, 40]]]
    anns = []
    for k, poly in enumerate(polys):
        rle = mask.merge(mask.frPyObjects(poly, h, w))
        anns.append({"id": k + 1, "image_id": 1, "category_id": k + 1, "segmentation": poly,
                     "area": float(native.area(rle)), "bbox": native.to_bbox(rle).tolist(),
                     "iscrowd": 0})
    gt_file = tmp_path / "gt.json"
    gt_file.write_text(json.dumps({"images": imgs, "annotations": anns, "categories": cats}))
    dets = [{"image_id": 1, "category_id": a["category_id"], "score": 0.9,
             "segmentation": a["segmentation"]} for a in anns]
    stats = []
    for coco_cls, eval_cls in ((COCO, COCOeval), (JaxCOCO, JaxCOCOeval)):
        gt, dt, ev = _segm_eval(coco_cls, eval_cls, str(gt_file), json.loads(json.dumps(dets)))
        for a, g in zip(dt.loadAnns(dt.getAnnIds()), anns):
            assert a["area"] == g["area"] and a["bbox"] == g["bbox"]
        stats.append(np.asarray(ev.stats))
    # 1.0 but for COCOeval's precision denominator, tp + fp + np.spacing(1)
    assert 1.0 - 1e-12 < stats[0][0] <= 1.0
    np.testing.assert_array_equal(stats[0], stats[1])


def test_library_builds_into_the_port_and_is_keyed_on_the_source():
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert "rlobjectdetection_tpu_torch" in str(path) and path.exists()
    assert native.lib_path() == path


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "maskrle.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


_BUILD_AND_USE = """
import sys
from pathlib import Path
import numpy as np
from rlobjectdetection_tpu_torch import native
native.SRC, native.BUILD_DIR = Path(sys.argv[1]), Path(sys.argv[2])
print(native.area(native.encode(np.ones((3, 4), np.uint8))))
"""


def test_six_processes_building_at_once_each_load_a_whole_library(tmp_path):
    """Six fresh processes build one new source into one directory at once
    (the xdist workers' case): each loads a whole library, one is left."""
    src = tmp_path / "maskrle.cpp"
    src.write_bytes(native.SRC.read_bytes() + b"\n// a copy of its own\n")
    repo = str(native._PKG.parent)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_USE, str(src),
                               str(tmp_path / "build")], cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, outs
    assert [o.split()[-1] for o in outs] == ["12"] * 6
    built = sorted(f.name for f in (tmp_path / "build").iterdir())
    assert len(built) == 1 and built[0].startswith("libmaskrle-") and built[0].endswith(".so")
