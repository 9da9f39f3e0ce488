"""Seeded generators of the benchmark's inputs, driven by a traffic file's
parameters: a COCO-style train split written as JPEGs with its
`instances_<split><year>.json`, and a pool of decoded images to serve.

Every seed gets the same multiset of image sizes and of box counts (the
work a run does), in its own order and with its own boxes and pixels.
Boxes are inclusive pixel rectangles of integer corners; their areas are
log-uniform from 16² pixels to `max_area_share` of the image, their aspect
ratios log-uniform in [0.5, 2], classes uniform over 1..`classes`.
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image


def _counts(spec: dict, n: int) -> np.ndarray:
    """The fixed multiset of boxes an image (the same for every seed):
    1 + Poisson(mean − 1), capped at `max`."""
    b = spec["boxes_per_image"]
    fixed = np.random.default_rng(12345)
    return np.minimum(1 + fixed.poisson(b["mean"] - 1, n), b["max"]).astype(np.int64)


def _sizes(spec: dict, n: int) -> np.ndarray:
    """`[n, 2]` (width, height): the sizes in turn, each as often."""
    sizes = np.asarray(spec["sizes"], np.int64)
    return sizes[np.arange(n) % len(sizes)]


def boxes_for(rng: np.random.Generator, n: int, w: int, h: int, spec: dict) -> np.ndarray:
    """`[n, 4]` int boxes (x1, y1, x2, y2) inside a w×h image."""
    lo = np.log(16.0 * 16.0 / (w * h))
    area = np.exp(rng.uniform(lo, np.log(spec["max_area_share"]), n)) * w * h
    aspect = np.exp(rng.uniform(np.log(0.5), np.log(2.0), n))
    bw = np.clip(np.round(np.sqrt(area * aspect)), 4, w - 1).astype(np.int64)
    bh = np.clip(np.round(np.sqrt(area / aspect)), 4, h - 1).astype(np.int64)
    x1 = (rng.uniform(0, 1, n) * (w - bw)).astype(np.int64)
    y1 = (rng.uniform(0, 1, n) * (h - bh)).astype(np.int64)
    return np.stack([x1, y1, x1 + bw - 1, y1 + bh - 1], 1)


def draw(rng: np.random.Generator, w: int, h: int, boxes: np.ndarray, classes) -> np.ndarray:
    """`[h, w, 3]` uint8 RGB: a smooth background, each box filled with a
    colour of its class and a stripe texture, and some noise."""
    c0, c1 = rng.uniform(40, 215, 3), rng.uniform(-0.15, 0.15, (2, 3))
    xs = np.arange(w, dtype=np.float32)[:, None] * c1[0].astype(np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None] * c1[1].astype(np.float32)
    im = (c0.astype(np.float32) + ys[:, None, :]) + xs[None, :, :]
    for (x1, y1, x2, y2), c in zip(boxes, classes):
        colour = np.array([(c * 53) % 256, (c * 97) % 256, (c * 151) % 256], np.float32)
        f = np.float32(0.05 + 0.01 * (c % 7))
        wave = 25.0 * np.sin((np.arange(x1, x2 + 1, dtype=np.float32)[None, :]
                              + np.arange(y1, y2 + 1, dtype=np.float32)[:, None]) * f)
        im[y1:y2 + 1, x1:x2 + 1] = (0.3 * im[y1:y2 + 1, x1:x2 + 1] + 0.7 * colour
                                    + wave[..., None])
    im += rng.integers(-12, 13, (h, w, 1), dtype=np.int8)
    return np.clip(im, 0, 255).astype(np.uint8)


def coco_split(root: str, seed: int, spec: dict) -> list:
    """Writes `root/coco/images/<split><year>/COCO_<split><year>_<id>.jpg`
    and `root/coco/annotations/instances_<split><year>.json`; returns the
    images as records in id order: {id, path, width, height, boxes, classes}."""
    n, name = spec["images"], spec["split"] + spec["year"]
    rng = np.random.default_rng(int(seed))
    sizes = _sizes(spec, n)[rng.permutation(n)]
    counts = _counts(spec, n)[rng.permutation(n)]
    img_dir = os.path.join(root, "coco", "images", name)
    ann_dir = os.path.join(root, "coco", "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    images, anns, records = [], [], []
    for i in range(n):
        w, h = (int(v) for v in sizes[i])
        boxes = boxes_for(rng, int(counts[i]), w, h, spec)
        classes = rng.integers(1, spec["classes"] + 1, len(boxes))
        img_id = 1 + i
        fname = f"COCO_{name}_{img_id:012d}.jpg"
        path = os.path.join(img_dir, fname)
        Image.fromarray(draw(rng, w, h, boxes, classes)).save(path, quality=spec["jpeg_quality"])
        images.append({"id": img_id, "width": w, "height": h, "file_name": fname})
        for b, c in zip(boxes, classes):
            bw, bh = int(b[2] - b[0] + 1), int(b[3] - b[1] + 1)
            anns.append({"id": len(anns) + 1, "image_id": img_id, "category_id": int(c),
                         "bbox": [float(b[0]), float(b[1]), float(bw), float(bh)],
                         "area": float(bw * bh), "iscrowd": 0, "segmentation": []})
        records.append({"id": img_id, "path": path, "width": w, "height": h,
                        "boxes": boxes, "classes": classes})
    cats = [{"id": k, "name": f"category{k:02d}", "supercategory": "thing"}
            for k in range(1, spec["classes"] + 1)]
    with open(os.path.join(ann_dir, f"instances_{name}.json"), "w") as f:
        json.dump({"info": {"description": "synthetic"}, "images": images,
                   "annotations": anns, "categories": cats}, f)
    return records


def serve_pool(seed: int, spec: dict) -> list:
    """The served images: `[h, w, 3]` float32 BGR arrays, as decoded from
    JPEG files of quality `jpeg_quality`."""
    import io

    n = spec["images"]
    rng = np.random.default_rng(int(seed))
    k = len(spec["sizes"])
    # each block of k images holds every size once, in the seed's order, so a
    # window that ends inside a cycle of the pool serves every seed one mix
    sizes = _sizes(spec, n)[np.concatenate([b + rng.permutation(min(k, n - b))
                                            for b in range(0, n, k)])]
    counts = _counts(spec, n)[rng.permutation(n)]
    pool = []
    for i in range(n):
        w, h = (int(v) for v in sizes[i])
        boxes = boxes_for(rng, int(counts[i]), w, h, spec)
        buf = io.BytesIO()
        Image.fromarray(draw(rng, w, h, boxes, rng.integers(1, spec["classes"] + 1, len(boxes)))
                        ).save(buf, format="JPEG", quality=spec["jpeg_quality"])
        rgb = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"), np.float32)
        pool.append(rgb[:, :, ::-1].copy())
    return pool


def detections(records: list, seed: int, spec: dict) -> list:
    """A detector's results on the split, `per_image` an image (COCO's
    maxDets): for each gt box `copies` detections of its category jittered
    by N(0, `jitter`·size) on each side, scores in [0.5, 1), then false
    positives of random categories and boxes, scores in [0.01, 0.5), as
    `[{image_id, category_id, bbox xywh, score}]` rounded to 2 and 4
    decimals."""
    rng = np.random.default_rng(int(seed) + 1)
    out = []
    for r in records:
        w, h = r["width"], r["height"]
        dets = []
        for b, c in zip(r["boxes"], r["classes"]):
            bw, bh = b[2] - b[0] + 1, b[3] - b[1] + 1
            for _ in range(spec["copies"]):
                j = rng.normal(0.0, spec["jitter"], 4) * np.array([bw, bh, bw, bh])
                x1, y1 = np.clip(b[0] + j[0], 0, w - 2), np.clip(b[1] + j[1], 0, h - 2)
                x2, y2 = np.clip(b[2] + j[2], x1 + 1, w - 1), np.clip(b[3] + j[3], y1 + 1, h - 1)
                dets.append((int(c), [x1, y1, x2 - x1, y2 - y1], rng.uniform(0.5, 1.0)))
        dets = dets[:spec["per_image"]]
        extra = spec["per_image"] - len(dets)
        fp = boxes_for(rng, extra, w, h, spec)
        cls = rng.integers(1, spec["classes"] + 1, extra)
        for b, c in zip(fp, cls):
            dets.append((int(c), [b[0], b[1], b[2] - b[0], b[3] - b[1]], rng.uniform(0.01, 0.5)))
        for c, box, s in dets:
            out.append({"image_id": r["id"], "category_id": c,
                        "bbox": [round(float(v), 2) for v in box], "score": round(float(s), 4)})
    return out
