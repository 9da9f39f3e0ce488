"""Synthetic dataset fixtures (a copy of the JAX package's
`data/synthetic.py`, and Visual Genome and ILSVRC DET layouts of the
port's own): a miniature VOC devkit, COCO tree, Visual Genome tree or
ILSVRC DET devkit on disk (real JPEGs, XML / JSON annotations), so the data
→ detector → eval stack runs without a download. Boxes are solid coloured
rectangles on background noise.
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


def _grid_boxes(rng, n, h, w):
    """n boxes, each inside its own cell of a grid over the image (no two
    overlap), at least half the cell in each side."""
    cols = int(np.ceil(np.sqrt(n * w / h)))
    rows = int(np.ceil(n / cols))
    ch, cw = h // rows, w // cols
    boxes = []
    for k in range(n):
        r, c = divmod(k, cols)
        bh, bw = rng.randint(ch // 2, ch), rng.randint(cw // 2, cw)
        y1 = r * ch + rng.randint(0, ch - bh + 1)
        x1 = c * cw + rng.randint(0, cw - bw + 1)
        boxes.append((x1, y1, x1 + bw - 1, y1 + bh - 1))
    return boxes


def make_vg_dataset(root: str, num_images: int = 16, image_size=(480, 640),
                    version: str = "1600-400-20", splits=("train", "val"),
                    max_attributes: int = 3, seed: int = 3):
    """A Visual Genome tree in the layout `data/vg.py` reads, under root:
    `genome/<version>/{objects,attributes,relations}_vocab.txt` at the
    version's sizes (every 7th vocabulary line carries a synonym), images
    over `vg/VG_100K` and `vg/VG_100K_2`, `genome/xml/<id>.xml`, and one
    "im_file ann_file" split file a split, each listing every image.

    Every class of the vocabulary is some image's object, once, on a grid
    cell of its own (a third of them named by their synonym); each image
    also holds an object outside the vocabulary, every 4th image an object
    with a degenerate box (the whole-image fallback), and each object up to
    `max_attributes` attributes. Relations: a valid triple, its duplicate
    and one with an unknown predicate. Returns the class names."""
    n_obj, n_att, n_rel = (int(v) for v in version.split("-"))
    h, w = image_size
    rng = np.random.RandomState(seed)
    genome = os.path.join(root, "genome")
    vdir = os.path.join(genome, version)
    os.makedirs(vdir, exist_ok=True)
    os.makedirs(os.path.join(genome, "xml"), exist_ok=True)

    def vocab(prefix, n):
        names = [f"{prefix}{i}" for i in range(n)]
        lines = [f"{x},{x}syn" if i % 7 == 3 else x for i, x in enumerate(names)]
        return names, lines

    classes, obj_lines = vocab("object", n_obj)
    atts, att_lines = vocab("attr", n_att)
    rels, rel_lines = vocab("rel", n_rel)
    for name, lines in (("objects", obj_lines), ("attributes", att_lines),
                        ("relations", rel_lines)):
        with open(os.path.join(vdir, f"{name}_vocab.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    order = rng.permutation(n_obj)
    per_image = int(np.ceil(n_obj / num_images))
    lines = []
    for i in range(num_images):
        img_id = 1000 + i
        folder = ("VG_100K", "VG_100K_2")[i % 2]
        cls_ids = list(order[i * per_image:(i + 1) * per_image])
        boxes = _grid_boxes(rng, len(cls_ids) + 2, h, w)
        im = _draw_image(rng, h, w, boxes[:len(cls_ids)], cls_ids, n_obj)
        os.makedirs(os.path.join(root, "vg", folder), exist_ok=True)
        Image.fromarray(im).save(os.path.join(root, "vg", folder, f"{img_id}.jpg"))
        objs = []
        for k, (c, b) in enumerate(zip(cls_ids, boxes)):
            name = classes[c] + ("syn" if c % 7 == 3 and k % 3 == 0 else "")
            if i % 4 == 0 and k == 0:
                b = (b[2], b[1], b[0] - 1, b[3])              # degenerate: x2 < x1
            picks = rng.randint(0, n_att, rng.randint(0, max_attributes + 1))
            att_names = [atts[a] + ("syn" if a % 7 == 3 else "") for a in picks]
            objs.append((k + 1, name, b, att_names))
        objs.append((len(objs) + 1, "notinvocab", boxes[-1], []))
        rel_xml = ""
        if len(cls_ids) >= 2:
            for sub, pred, obj in ((1, rels[0], 2), (1, rels[0], 2), (2, "notapredicate", 1)):
                rel_xml += (f"<relation><subject_id>{sub}</subject_id><predicate>{pred}"
                            f"</predicate><object_id>{obj}</object_id></relation>")
        body = "".join(
            f"<object><name>{name}</name><object_id>{oid}</object_id>"
            + "".join(f"<attribute>{a}</attribute>" for a in att_names)
            + f"<bndbox><xmin>{b[0]}</xmin><ymin>{b[1]}</ymin><xmax>{b[2]}</xmax>"
              f"<ymax>{b[3]}</ymax></bndbox></object>"
            for oid, name, b, att_names in objs)
        with open(os.path.join(genome, "xml", f"{img_id}.xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}</height>"
                    f"<depth>3</depth></size>{body}{rel_xml}</annotation>")
        lines.append(f"{folder}/{img_id}.jpg xml/{img_id}.xml")
    for split in splits:
        with open(os.path.join(genome, f"{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return classes


def make_imagenet_devkit(root: str, num_images: int = 8, image_size=(480, 640),
                         num_synsets: int = 200, split: str = "val", seed: int = 3):
    """An ILSVRC DET devkit in the layout `data/imagenet.py` reads, under
    root/ILSVRC: `devkit/data/synsets_det.txt` ("wnid name" lines),
    `ImageSets/DET/<split>.txt`, `Annotations/DET/<split>/<id>.xml` and
    `Data/DET/<split>/<id>.JPEG`. Each image holds 1-4 objects of random
    synsets on grid cells of their own and one of a wnid outside the list.
    Returns the class names."""
    h, w = image_size
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "ILSVRC")
    set_dir = "val" if split.startswith("val") else split
    for d in (os.path.join("devkit", "data"), os.path.join("ImageSets", "DET"),
              os.path.join("Annotations", "DET", set_dir), os.path.join("Data", "DET", set_dir)):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    wnids = [f"n{10000000 + i:08d}" for i in range(num_synsets)]
    names = [f"synset{i}" for i in range(num_synsets)]
    with open(os.path.join(base, "devkit", "data", "synsets_det.txt"), "w") as f:
        f.write("".join(f"{a} {b}\n" for a, b in zip(wnids, names)))
    ids = []
    for i in range(num_images):
        img_id = f"ILSVRC2013_{split}_{i:08d}"
        n = rng.randint(1, 5)
        boxes = _grid_boxes(rng, n + 1, h, w)
        cls_ids = rng.randint(0, num_synsets, n)
        im = _draw_image(rng, h, w, boxes[:n], cls_ids, num_synsets)
        Image.fromarray(im).save(os.path.join(base, "Data", "DET", set_dir, img_id + ".JPEG"))
        objs = [(wnids[c], b) for c, b in zip(cls_ids, boxes)] + [("n99999999", boxes[-1])]
        body = "".join(
            f"<object><name>{wn}</name><bndbox><xmin>{b[0]}</xmin><ymin>{b[1]}</ymin>"
            f"<xmax>{b[2]}</xmax><ymax>{b[3]}</ymax></bndbox></object>" for wn, b in objs)
        with open(os.path.join(base, "Annotations", "DET", set_dir, img_id + ".xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}</height></size>"
                    f"{body}</annotation>")
        ids.append(img_id)
    with open(os.path.join(base, "ImageSets", "DET", f"{split}.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    return names
