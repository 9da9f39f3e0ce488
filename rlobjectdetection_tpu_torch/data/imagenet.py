"""ILSVRC DET (200 classes) imdb (copy of the JAX package's
`data/imagenet.py`).

The devkit layout: `Annotations/DET/<set>/<index>.xml` with wnid object
names, `ImageSets/DET/<set>.txt` lists, `Data/DET/<set>/<index>.JPEG`
(val1 and val2 read the val release's directories). The 200 detection
synsets come from the devkit's `data/synsets_det.txt` ("wnid name" lines)
or else its `meta_det.mat` (through scipy.io). `evaluate_detections` is the
VOC-style matching loop (IoU strictly above 0.5) and its area-under-curve
AP, averaged over the classes with gt.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET

import numpy as np

from .imdb import imdb


def _load_synsets(devkit_path):
    txt = os.path.join(devkit_path, "data", "synsets_det.txt")
    if os.path.exists(txt):
        wnids, names = ["0"], ["__background__"]
        with open(txt) as f:
            for line in f:
                parts = line.strip().split(None, 1)
                if len(parts) == 2:
                    wnids.append(parts[0])
                    names.append(parts[1])
        return wnids[:201], names[:201]
    mat = os.path.join(devkit_path, "data", "meta_det.mat")
    import scipy.io as sio

    synsets = sio.loadmat(mat)["synsets"]
    wnids, names = ["0"], ["__background__"]
    for i in range(200):
        wnids.append(str(synsets[0][i][1][0]))
        names.append(str(synsets[0][i][2][0]))
    return wnids, names


class imagenet(imdb):
    def __init__(self, image_set, devkit_path=None, data_path=None):
        super().__init__("imagenet_" + image_set)
        self._image_set = image_set
        root = self._data_root()
        self._devkit_path = devkit_path or os.path.join(root, "ILSVRC", "devkit")
        self._data_path = data_path or os.path.join(root, "ILSVRC")
        wnids, names = _load_synsets(self._devkit_path)
        self._classes = names
        self._wnid = wnids
        self._wnid_to_ind = dict(zip(wnids, range(len(wnids))))
        self._class_to_ind = dict(zip(names, range(len(names))))
        self._image_ext = ".JPEG"
        self._image_index = self._load_image_set_index()
        self._roidb_handler = self.gt_roidb
        self.config = {"cleanup": True, "use_salt": True, "top_k": 2000}

    def image_path_at(self, i):
        return self.image_path_from_index(self._image_index[i])

    def image_path_from_index(self, index):
        return os.path.join(self._data_path, "Data", "DET",
                            self._set_dir(), index + self._image_ext)

    def _set_dir(self):
        # val1/val2 are subsets of the val release; train and test each have
        # their own Data/Annotations directory
        if self._image_set.startswith("val"):
            return "val"
        return self._image_set

    def _load_image_set_index(self):
        candidates = [
            os.path.join(self._data_path, "ImageSets", "DET", self._image_set + ".txt"),
            os.path.join(self._data_path, "ImageSets", self._image_set + ".txt"),
        ]
        for path in candidates:
            if os.path.exists(path):
                with open(path) as f:
                    return [line.split()[0] for line in f if line.strip()]
        raise FileNotFoundError(f"no image set file for {self._image_set}")

    def gt_roidb(self):
        cache_file = os.path.join(self.cache_path, self.name + "_gt_roidb.pkl")
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as fid:
                return pickle.load(fid)
        roidb = [self._load_imagenet_annotation(ix) for ix in self.image_index]
        with open(cache_file, "wb") as fid:
            pickle.dump(roidb, fid, pickle.HIGHEST_PROTOCOL)
        return roidb

    def _load_imagenet_annotation(self, index):
        filename = os.path.join(self._data_path, "Annotations", "DET",
                                self._set_dir(), index + ".xml")
        tree = ET.parse(filename)
        size = tree.find("size")
        width = int(size.find("width").text)
        height = int(size.find("height").text)
        objs = [o for o in tree.findall("object")
                if o.find("name").text in self._wnid_to_ind]
        num_objs = len(objs)
        boxes = np.zeros((num_objs, 4), dtype=np.uint16)
        gt_classes = np.zeros((num_objs,), dtype=np.int32)
        overlaps = np.zeros((num_objs, self.num_classes), dtype=np.float32)
        seg_areas = np.zeros((num_objs,), dtype=np.float32)
        for ix, obj in enumerate(objs):
            bb = obj.find("bndbox")
            x1 = max(float(bb.find("xmin").text), 0)
            y1 = max(float(bb.find("ymin").text), 0)
            x2 = min(float(bb.find("xmax").text), width - 1)
            y2 = min(float(bb.find("ymax").text), height - 1)
            cls = self._wnid_to_ind[obj.find("name").text]
            boxes[ix] = [x1, y1, x2, y2]
            gt_classes[ix] = cls
            overlaps[ix, cls] = 1.0
            seg_areas[ix] = (x2 - x1 + 1) * (y2 - y1 + 1)
        return {
            "width": width, "height": height, "boxes": boxes,
            "gt_classes": gt_classes, "gt_overlaps": overlaps,
            "flipped": False, "seg_areas": seg_areas,
        }

    def evaluate_detections(self, all_boxes, output_dir):
        """Mean AP via the VOC-style matching loop over ILSVRC xml annotations."""
        from .voc_eval import voc_ap
        from .imdb import bbox_overlaps_np

        aps = []
        roidb = self.roidb
        for cls_ind in range(1, self.num_classes):
            scores, tp, fp = [], [], []
            npos = 0
            for i in range(self.num_images):
                gt = roidb[i]
                gt_boxes = gt["boxes"][gt["gt_classes"] == cls_ind].astype(float)
                npos += len(gt_boxes)
                dets = all_boxes[cls_ind][i]
                if len(dets) == 0:
                    continue
                order = np.argsort(-dets[:, 4])
                matched = np.zeros(len(gt_boxes), dtype=bool)
                for d in order:
                    scores.append(dets[d, 4])
                    if len(gt_boxes):
                        ov = bbox_overlaps_np(dets[d : d + 1, :4].astype(float), gt_boxes)[0]
                        j = ov.argmax()
                        # strict >, the same matching protocol as voc_eval
                        # (ovmax > ovthresh) so APs are comparable across imdbs
                        if ov[j] > 0.5 and not matched[j]:
                            matched[j] = True
                            tp.append(1)
                            fp.append(0)
                            continue
                    tp.append(0)
                    fp.append(1)
            if npos == 0:
                continue
            order = np.argsort(-np.array(scores))
            tp = np.cumsum(np.array(tp)[order])
            fp = np.cumsum(np.array(fp)[order])
            rec = tp / npos
            prec = tp / np.maximum(tp + fp, 1e-9)
            aps.append(voc_ap(rec, prec))
        mean_ap = float(np.mean(aps)) if aps else 0.0
        print(f"ImageNet DET mean AP = {mean_ap:.4f}")
        return mean_ap
