"""Visual Genome imdb and its evaluation (copy of the JAX package's
`data/vg.py`).

  * vocabularies with synonyms: `<data>/<version>/objects_vocab.txt` (one
    comma-separated synonym group a line; the first name is the class), and
    `attributes_vocab.txt` / `relations_vocab.txt` beside it. A flat
    `objects_vocab_<N>.txt` (one name a line) is also read.
  * splits: minitrain, smalltrain, minival and smallval are prefixes of the
    train or val list (1000, 20000, 100 and 2000 lines) where they have no
    file of their own; a split line is "im_file ann_file" (images over
    VG_100K / VG_100K_2, kept in an id→dir map) or a bare image id. The
    index keeps the images with at least one object of the vocabulary and
    is cached.
  * annotations: boxes (a degenerate box becomes the whole image),
    gt_classes, up to 16 attributes an object, and the relation triples
    (subject_ix, predicate, object_ix), deduplicated.
  * evaluation: per-class results files → `vg_eval` (AP, each class's
    score threshold that maximises F1, and the npos-weighted mean AP);
    `evaluate_attributes` runs the same over the attribute vocabulary.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET

import numpy as np

from .imdb import bbox_overlaps_np, imdb
from .voc_eval import voc_ap

SPLIT_CAPS = {"minitrain": 1000, "smalltrain": 20000,
              "minival": 100, "smallval": 2000}
SPLIT_BASE = {"minitrain": "train", "smalltrain": "train",
              "minival": "val", "smallval": "val"}
MAX_ATTRIBUTES = 16


def _load_vocab(path):
    """names[0] = background sentinel supplied by caller; returns
    (canonical names, name→index incl. synonyms)."""
    names, index = [], {}
    with open(path) as f:
        for count, line in enumerate((ln for ln in f if ln.strip()), start=1):
            syns = [n.lower().strip() for n in line.split(",")]
            names.append(syns[0])
            for n in syns:
                index[n] = count
    return names, index


class vg(imdb):
    def __init__(self, version, image_set, data_path=None):
        super().__init__(f"vg_{version}_{image_set}")
        self._version = version
        self._image_set = image_set
        self._data_path = data_path or os.path.join(self._data_root(), "genome")
        self._img_path = os.path.join(os.path.dirname(self._data_path), "vg")
        self._img_dir = os.path.join(self._data_path, "images")
        self._ann_dir = os.path.join(self._data_path, "xml")
        self.config = {"cleanup": False}

        self._classes, self._class_to_ind = self._load_classes()
        self._attributes, self._attribute_to_ind = self._load_aux_vocab(
            "attributes_vocab.txt", "__no_attribute__")
        self._relations, self._relation_to_ind = self._load_aux_vocab(
            "relations_vocab.txt", "__no_relation__")

        self._id_to_dir = {}
        self._image_index = self._load_image_set_index()
        self._roidb_handler = self.gt_roidb

    # ------------------------------------------------------------- vocab

    def _load_classes(self):
        classes = ["__background__"]
        mapping = {"__background__": 0}
        versioned = os.path.join(self._data_path, self._version,
                                 "objects_vocab.txt")
        if os.path.exists(versioned):
            names, idx = _load_vocab(versioned)
            classes.extend(names)
            mapping.update(idx)
            return classes, mapping
        vocab_size = self._version.split("-")[0]
        flat = os.path.join(self._data_path, f"objects_vocab_{vocab_size}.txt")
        if os.path.exists(flat):
            names, idx = _load_vocab(flat)
            classes.extend(names)
            mapping.update(idx)
        return classes, mapping

    def _load_aux_vocab(self, filename, background):
        names = [background]
        mapping = {background: 0}
        path = os.path.join(self._data_path, self._version, filename)
        if os.path.exists(path):
            more, idx = _load_vocab(path)
            names.extend(more)
            mapping.update(idx)
        return names, mapping

    @property
    def attributes(self):
        return self._attributes

    @property
    def relations(self):
        return self._relations

    # ------------------------------------------------------------- index

    def _split_path(self):
        base = SPLIT_BASE.get(self._image_set, self._image_set)
        direct = os.path.join(self._data_path, f"{self._image_set}.txt")
        if self._image_set in SPLIT_BASE and not os.path.exists(direct):
            return os.path.join(self._data_path, f"{base}.txt")
        return direct

    def _load_image_set_index(self):
        # the filtered index costs one XML parse per candidate image
        # (_has_vocab_object) — cache it like the reference's
        # vg_image_index_<set>.p (reference vg.py:81-95)
        cache_file = os.path.join(self.cache_path,
                                  self.name + "_image_index.pkl")
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as fid:
                index, self._id_to_dir = pickle.load(fid)
            return index
        index = self._build_image_set_index()
        with open(cache_file, "wb") as fid:
            pickle.dump((index, self._id_to_dir), fid, pickle.HIGHEST_PROTOCOL)
        return index

    def _build_image_set_index(self):
        split_file = self._split_path()
        if os.path.exists(split_file):
            with open(split_file) as f:
                lines = [ln.strip() for ln in f if ln.strip()]
            cap = SPLIT_CAPS.get(self._image_set)
            if cap:
                lines = lines[:cap]
            index = []
            for line in lines:
                parts = line.split()
                if len(parts) >= 2:   # "VG_100K/123.jpg xml/123.xml" layout
                    image_id = os.path.splitext(os.path.basename(parts[1]))[0]
                    self._id_to_dir[image_id] = parts[0].split("/")[0]
                else:
                    image_id = parts[0]
                if os.path.exists(self._annotation_path(image_id)) and \
                        self._has_vocab_object(image_id):
                    index.append(image_id)
            return index
        if os.path.isdir(self._ann_dir):   # fall back to every annotated image
            return sorted(os.path.splitext(f)[0] for f in os.listdir(self._ann_dir)
                          if f.endswith(".xml"))
        raise FileNotFoundError(f"no VG split file {split_file}")

    def _has_vocab_object(self, image_id):
        tree = ET.parse(self._annotation_path(image_id))
        for obj in tree.findall("object"):
            name = obj.find("name").text
            if name and name.lower().strip() in self._class_to_ind:
                return True
        return False

    def _annotation_path(self, index):
        return os.path.join(self._ann_dir, f"{index}.xml")

    def image_id_at(self, i):
        return i

    def image_path_at(self, i):
        index = self._image_index[i]
        if index in self._id_to_dir:   # two-directory VG_100K layout
            return os.path.join(self._img_path, self._id_to_dir[index],
                                f"{index}.jpg")
        return os.path.join(self._img_dir, f"{index}.jpg")

    # ------------------------------------------------------------- roidb

    def gt_roidb(self):
        cache_file = os.path.join(self.cache_path, self.name + "_gt_roidb.pkl")
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as fid:
                return pickle.load(fid)
        roidb = [self._load_vg_annotation(ix) for ix in self.image_index]
        with open(cache_file, "wb") as fid:
            pickle.dump(roidb, fid, pickle.HIGHEST_PROTOCOL)
        return roidb

    def _get_size(self, tree):
        size = tree.find("size")
        return int(size.find("width").text), int(size.find("height").text)

    def _load_vg_annotation(self, index):
        tree = ET.parse(self._annotation_path(index))
        width, height = self._get_size(tree)

        kept = []   # (element, class index)
        for obj in tree.findall("object"):
            name = obj.find("name").text
            if name and name.lower().strip() in self._class_to_ind:
                kept.append((obj, self._class_to_ind[name.lower().strip()]))

        num = len(kept)
        boxes = np.zeros((num, 4), dtype=np.uint16)
        gt_classes = np.zeros((num,), dtype=np.int32)
        gt_attributes = np.zeros((num, MAX_ATTRIBUTES), dtype=np.int32)
        overlaps = np.zeros((num, self.num_classes), dtype=np.float32)
        seg_areas = np.zeros((num,), dtype=np.float32)
        object_id_to_ix = {}

        for ix, (obj, cls) in enumerate(kept):
            bb = obj.find("bndbox")
            x1 = max(0.0, float(bb.find("xmin").text))
            y1 = max(0.0, float(bb.find("ymin").text))
            x2 = min(width - 1.0, float(bb.find("xmax").text))
            y2 = min(height - 1.0, float(bb.find("ymax").text))
            if x2 < x1 or y2 < y1:
                # a few VG boxes are degenerate: whole-image fallback (vg.py:235)
                x1 = y1 = 0.0
                x2, y2 = width - 1.0, height - 1.0
            oid = obj.find("object_id")
            if oid is not None:
                object_id_to_ix[oid.text] = ix
            n_att = 0
            for att in obj.findall("attribute"):
                a = (att.text or "").lower().strip()
                if a in self._attribute_to_ind:
                    gt_attributes[ix, n_att] = self._attribute_to_ind[a]
                    n_att += 1
                if n_att >= MAX_ATTRIBUTES:
                    break
            boxes[ix] = [x1, y1, x2, y2]
            gt_classes[ix] = cls
            overlaps[ix, cls] = 1.0
            seg_areas[ix] = (x2 - x1 + 1) * (y2 - y1 + 1)

        triples = set()
        for rel in tree.findall("relation"):
            pred = rel.find("predicate").text
            if not pred:
                continue
            pred = pred.lower().strip()
            sub = rel.find("subject_id")
            objid = rel.find("object_id")
            if (pred in self._relation_to_ind and sub is not None
                    and objid is not None
                    and sub.text in object_id_to_ix
                    and objid.text in object_id_to_ix):
                triples.add((object_id_to_ix[sub.text],
                             self._relation_to_ind[pred],
                             object_id_to_ix[objid.text]))
        gt_relations = np.array(sorted(triples), dtype=np.int32).reshape(-1, 3)

        return {
            "width": width, "height": height, "boxes": boxes,
            "gt_classes": gt_classes, "gt_attributes": gt_attributes,
            "gt_relations": gt_relations, "gt_overlaps": overlaps,
            "flipped": False, "seg_areas": seg_areas,
        }

    # ---------------------------------------------------------- evaluation

    def _results_file(self, output_dir, cls):
        return os.path.join(output_dir,
                            f"detections_{self._image_set}_{cls}.txt")

    def _write_results_files(self, classes, all_boxes, output_dir):
        for cls_ind, cls in enumerate(classes):
            if cls in ("__background__", "__no_attribute__"):
                continue
            with open(self._results_file(output_dir, cls), "w") as f:
                for im_ind, index in enumerate(self.image_index):
                    dets = all_boxes[cls_ind][im_ind]
                    for k in range(len(dets)):
                        f.write(f"{index} {dets[k, -1]:.3f} "
                                f"{dets[k, 0] + 1:.1f} {dets[k, 1] + 1:.1f} "
                                f"{dets[k, 2] + 1:.1f} {dets[k, 3] + 1:.1f}\n")

    def evaluate_detections(self, all_boxes, output_dir=None):
        return self._evaluate(self._classes, all_boxes, output_dir,
                              eval_attributes=False)

    def evaluate_attributes(self, all_boxes, output_dir=None):
        return self._evaluate(self._attributes, all_boxes, output_dir,
                              eval_attributes=True)

    def _evaluate(self, classes, all_boxes, output_dir, eval_attributes):
        import tempfile

        output_dir = output_dir or tempfile.mkdtemp(prefix="vg_eval_")
        os.makedirs(output_dir, exist_ok=True)
        self._write_results_files(classes, all_boxes, output_dir)

        roidb = self.gt_roidb()
        aps, nposs, thresh = [], [], []
        for i, cls in enumerate(classes):
            if cls in ("__background__", "__no_attribute__"):
                continue
            rec, prec, ap, scores, npos = vg_eval(
                self._results_file(output_dir, cls), roidb, self.image_index,
                i, ovthresh=0.5, eval_attributes=eval_attributes)
            # per-class detection threshold maximizing the F score (vg.py:364-369)
            if npos > 1 and len(scores):
                f1 = np.nan_to_num((prec * rec) / (prec + rec))
                thresh.append(scores[int(np.argmax(f1))])
            else:
                thresh.append(0.0)
            aps.append(ap)
            nposs.append(float(npos))
            print(f"AP for {cls} = {ap:.4f} (npos={npos:,})")
            with open(os.path.join(output_dir, cls + "_pr.pkl"), "wb") as f:
                pickle.dump({"rec": rec, "prec": prec, "ap": ap,
                             "scores": scores, "npos": npos}, f)

        thresh = np.asarray(thresh)
        nonzero = thresh[thresh != 0]
        avg_thresh = float(nonzero.mean()) if len(nonzero) else 0.0
        thresh = np.where(thresh == 0, avg_thresh, thresh)
        kind = "attribute" if eval_attributes else "object"
        with open(os.path.join(output_dir,
                               f"{kind}_thresholds_{self._image_set}.txt"), "w") as f:
            for cls, t in zip([c for c in classes
                               if c not in ("__background__", "__no_attribute__")],
                              thresh):
                f.write(f"{cls} {t:.3f}\n")

        weights = np.asarray(nposs)
        mean_ap = float(np.mean(aps)) if aps else 0.0
        if weights.sum() > 0:
            print(f"Weighted Mean AP = {np.average(aps, weights=weights):.4f}")
        print(f"Mean AP = {mean_ap:.4f}")
        print(f"Mean Detection Threshold = {avg_thresh:.3f}")
        if self.config["cleanup"]:
            for cls in classes:
                if cls in ("__background__", "__no_attribute__"):
                    continue
                os.remove(self._results_file(output_dir, cls))
        return mean_ap


def vg_eval(detfile, gt_roidb, image_index, cls_ind, ovthresh=0.5,
            use_07_metric=False, eval_attributes=False):
    """Per-class AP over roidb ground truth (rebuild of vg_eval.py:22-123).

    Returns (rec, prec, ap, sorted_scores, npos). For attributes, a gt object
    counts for class `cls_ind` when it carries that attribute id.
    """
    gt = {}
    npos = 0
    for i, index in enumerate(image_index):
        entry = gt_roidb[i]
        if eval_attributes:
            atts = np.asarray(entry["gt_attributes"])
            if hasattr(atts, "toarray"):
                atts = atts.toarray()
            sel = (atts == cls_ind).any(axis=1)
        else:
            sel = entry["gt_classes"] == cls_ind
        boxes = entry["boxes"][sel].astype(np.float64)
        npos += boxes.shape[0]
        gt[str(index)] = {"bbox": boxes, "det": np.zeros(len(boxes), bool)}

    if not os.path.exists(detfile):
        return np.zeros(0), np.zeros(0), 0.0, np.zeros(0), npos
    with open(detfile) as f:
        rows = [ln.strip().split(" ") for ln in f if ln.strip()]
    nd = len(rows)
    if nd == 0:
        return np.zeros(0), np.zeros(0), 0.0, np.zeros(0), npos

    ids = np.array([r[0] for r in rows])
    scores = np.array([float(r[1]) for r in rows])
    # The results files carry devkit 1-based coords and the reference
    # evaluator matches them VERBATIM against the 0-based roidb gt
    # (vg_eval.py:66-90) — a systematic 1-px shift we preserve for parity.
    boxes = np.array([[float(z) for z in r[2:6]] for r in rows])

    order = np.argsort(-scores)
    ids, scores, boxes = ids[order], scores[order], boxes[order]

    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        rec_entry = gt.get(ids[d])
        if rec_entry is None or rec_entry["bbox"].shape[0] == 0:
            fp[d] = 1.0
            continue
        ious = bbox_overlaps_np(boxes[d:d + 1], rec_entry["bbox"])[0]
        j = int(ious.argmax())
        if ious[j] > ovthresh and not rec_entry["det"][j]:
            tp[d] = 1.0
            rec_entry["det"][j] = True
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric), scores, npos


def vg_eval_all(db: vg, all_boxes, output_dir=None, ovthresh: float = 0.5):
    """Back-compat shim: full detection evaluation returning mean AP."""
    return db.evaluate_detections(all_boxes, output_dir)
