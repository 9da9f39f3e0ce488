"""Synthetic dataset fixtures (copy of the JAX package's `data/synthetic.py`):
a miniature VOC devkit or COCO tree on disk (real JPEGs, XML / JSON
annotations), so the data → detector → eval stack runs without a download.
Boxes are solid coloured rectangles on background noise.
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image


def _draw_image(rng, h, w, boxes, classes, num_classes):
    """Background noise + one solid color rectangle per box (class-coded hue)."""
    im = (rng.rand(h, w, 3) * 40 + 100).astype(np.uint8)
    for (x1, y1, x2, y2), c in zip(boxes, classes):
        color = np.zeros(3)
        color[c % 3] = 255 - 40 * (c // 3)
        im[int(y1) : int(y2) + 1, int(x1) : int(x2) + 1] = color.astype(np.uint8)
    return im


def _rand_boxes(rng, n, h, w, min_size=24):
    boxes = []
    for _ in range(n):
        bw = rng.randint(min_size, max(min_size + 1, w // 2))
        bh = rng.randint(min_size, max(min_size + 1, h // 2))
        x1 = rng.randint(0, w - bw)
        y1 = rng.randint(0, h - bh)
        boxes.append((x1, y1, x1 + bw - 1, y1 + bh - 1))
    return boxes


def make_voc_devkit(root: str, num_images: int = 8, year: str = "2007",
                    splits=("trainval", "test"), image_size=(240, 320),
                    classes=("widget", "gadget", "gizmo"), seed: int = 3):
    """Create data/VOCdevkit<year>/VOC<year>/{JPEGImages,Annotations,ImageSets}.

    Returns the list of class names used (subset of VOC-style setup: the caller
    should instantiate pascal_voc with matching classes or use these as-is via
    a custom imdb; for the stock 20-class imdb use voc class names).
    """
    h, w = image_size
    rng = np.random.RandomState(seed)
    voc = os.path.join(root, f"VOCdevkit{year}", f"VOC{year}")
    os.makedirs(os.path.join(voc, "JPEGImages"), exist_ok=True)
    os.makedirs(os.path.join(voc, "Annotations"), exist_ok=True)
    os.makedirs(os.path.join(voc, "ImageSets", "Main"), exist_ok=True)

    ids_by_split = {s: [] for s in splits}
    idx = 0
    for split in splits:
        for _ in range(num_images):
            img_id = f"{idx:06d}"
            idx += 1
            n = rng.randint(1, 4)
            boxes = _rand_boxes(rng, n, h, w)
            cls_ids = rng.randint(0, len(classes), size=n)
            im = _draw_image(rng, h, w, boxes, cls_ids, len(classes))
            Image.fromarray(im).save(os.path.join(voc, "JPEGImages", img_id + ".jpg"))
            objs = "".join(
                f"""
  <object>
    <name>{classes[c]}</name>
    <pose>Unspecified</pose>
    <truncated>0</truncated>
    <difficult>0</difficult>
    <bndbox><xmin>{b[0] + 1}</xmin><ymin>{b[1] + 1}</ymin><xmax>{b[2] + 1}</xmax><ymax>{b[3] + 1}</ymax></bndbox>
  </object>"""
                for b, c in zip(boxes, cls_ids)
            )
            xml = f"""<annotation>
  <folder>VOC{year}</folder>
  <filename>{img_id}.jpg</filename>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  <segmented>0</segmented>{objs}
</annotation>"""
            with open(os.path.join(voc, "Annotations", img_id + ".xml"), "w") as f:
                f.write(xml)
            ids_by_split[split].append(img_id)
        with open(os.path.join(voc, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("\n".join(ids_by_split[split]) + "\n")
    return classes


def make_coco_dataset(root: str, num_images: int = 8, split: str = "minival",
                      year: str = "2014", image_size=(240, 320),
                      classes=("widget", "gadget", "gizmo"), seed: int = 3,
                      crowd_fraction: float = 0.0, first_id: int = 1000):
    """Create data/coco/{annotations/instances_<split><year>.json, images/...}.
    Image ids (and file names) run from `first_id`: minival and
    valminusminival share the val image folder, so two such splits need
    ranges that do not meet."""
    h, w = image_size
    rng = np.random.RandomState(seed)
    data_name = {"minival": "val", "valminusminival": "val"}.get(split, split) + year
    img_dir = os.path.join(root, "coco", "images", data_name)
    ann_dir = os.path.join(root, "coco", "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    images, annotations, categories = [], [], []
    for i, name in enumerate(classes):
        categories.append({"id": i + 1, "name": name, "supercategory": "thing"})

    ann_id = 1
    for i in range(num_images):
        img_id = first_id + i
        n = rng.randint(1, 4)
        boxes = _rand_boxes(rng, n, h, w)
        cls_ids = rng.randint(0, len(classes), size=n)
        im = _draw_image(rng, h, w, boxes, cls_ids, len(classes))
        fname = f"COCO_{data_name}_{img_id:012d}.jpg"
        Image.fromarray(im).save(os.path.join(img_dir, fname))
        images.append({"id": img_id, "width": w, "height": h, "file_name": fname})
        for b, c in zip(boxes, cls_ids):
            bw = b[2] - b[0] + 1
            bh = b[3] - b[1] + 1
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": img_id,
                    "category_id": int(c) + 1,
                    "bbox": [float(b[0]), float(b[1]), float(bw), float(bh)],
                    "area": float(bw * bh),
                    "iscrowd": int(rng.rand() < crowd_fraction),
                    "segmentation": [],
                }
            )
            ann_id += 1

    ann = {
        "info": {"description": "synthetic"},
        "images": images,
        "annotations": annotations,
        "categories": categories,
    }
    path = os.path.join(ann_dir, f"instances_{split}{year}.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path
