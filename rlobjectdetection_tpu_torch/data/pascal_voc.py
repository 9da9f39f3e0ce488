"""PASCAL VOC imdb (copy of the JAX package's `data/pascal_voc.py`).

XML annotations with boxes made 0-based, the gt roidb with its pickle
cache, the per-class results files and the python `voc_eval`
`evaluate_detections`; selective-search `.mat` proposals (lazy
`scipy.io`) and RPN proposal pickles merge into the gt roidb.
"""

from __future__ import annotations

import os
import pickle
import uuid
import xml.etree.ElementTree as ET

import numpy as np

from .imdb import imdb
from .voc_eval import voc_eval

VOC_CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class pascal_voc(imdb):
    def __init__(self, image_set, year, devkit_path=None):
        super().__init__(f"voc_{year}_{image_set}", list(VOC_CLASSES))
        self._year = year
        self._image_set = image_set
        self._devkit_path = devkit_path or self._default_path()
        self._data_path = os.path.join(self._devkit_path, "VOC" + self._year)
        self._class_to_ind = dict(zip(self.classes, range(self.num_classes)))
        self._image_ext = ".jpg"
        self._image_index = self._load_image_set_index()
        self._roidb_handler = self.gt_roidb
        self._salt = str(uuid.uuid4())
        self._comp_id = "comp4"
        self.config = {
            "cleanup": True, "use_salt": True, "use_diff": False,
            "matlab_eval": False, "rpn_file": None, "min_size": 2,
        }
        assert os.path.exists(self._devkit_path), (
            f"VOCdevkit path does not exist: {self._devkit_path}"
        )

    def _default_path(self):
        return os.path.join(self._data_root(), "VOCdevkit" + self._year)

    def image_path_at(self, i):
        return self.image_path_from_index(self._image_index[i])

    def image_id_at(self, i):
        return i

    def image_path_from_index(self, index):
        path = os.path.join(self._data_path, "JPEGImages", index + self._image_ext)
        assert os.path.exists(path), f"Path does not exist: {path}"
        return path

    def _load_image_set_index(self):
        image_set_file = os.path.join(
            self._data_path, "ImageSets", "Main", self._image_set + ".txt"
        )
        assert os.path.exists(image_set_file), (
            f"Path does not exist: {image_set_file}"
        )
        with open(image_set_file) as f:
            return [x.strip() for x in f.readlines()]

    def gt_roidb(self):
        cache_file = os.path.join(self.cache_path, self.name + "_gt_roidb.pkl")
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as fid:
                roidb = pickle.load(fid)
            print(f"{self.name} gt roidb loaded from {cache_file}")
            return roidb
        gt_roidb = [
            self._load_pascal_annotation(index) for index in self.image_index
        ]
        with open(cache_file, "wb") as fid:
            pickle.dump(gt_roidb, fid, pickle.HIGHEST_PROTOCOL)
        print(f"wrote gt roidb to {cache_file}")
        return gt_roidb

    def _load_pascal_annotation(self, index):
        """XML → roidb entry; boxes made 0-based (pascal_voc.py:205-256)."""
        filename = os.path.join(self._data_path, "Annotations", index + ".xml")
        tree = ET.parse(filename)
        size = tree.find("size")
        width = int(size.find("width").text)
        height = int(size.find("height").text)
        objs = tree.findall("object")
        if not self.config["use_diff"]:
            non_diff_objs = [
                obj for obj in objs
                if (obj.find("difficult") is None or int(obj.find("difficult").text) == 0)
            ]
            objs = non_diff_objs
        num_objs = len(objs)

        boxes = np.zeros((num_objs, 4), dtype=np.uint16)
        gt_classes = np.zeros((num_objs), dtype=np.int32)
        overlaps = np.zeros((num_objs, self.num_classes), dtype=np.float32)
        seg_areas = np.zeros((num_objs), dtype=np.float32)
        ishards = np.zeros((num_objs), dtype=np.int32)

        for ix, obj in enumerate(objs):
            bbox = obj.find("bndbox")
            x1 = float(bbox.find("xmin").text) - 1
            y1 = float(bbox.find("ymin").text) - 1
            x2 = float(bbox.find("xmax").text) - 1
            y2 = float(bbox.find("ymax").text) - 1
            diffc = obj.find("difficult")
            ishards[ix] = 0 if diffc is None else int(diffc.text)
            cls = self._class_to_ind[obj.find("name").text.lower().strip()]
            boxes[ix, :] = [x1, y1, x2, y2]
            gt_classes[ix] = cls
            overlaps[ix, cls] = 1.0
            seg_areas[ix] = (x2 - x1 + 1) * (y2 - y1 + 1)

        return {
            "width": width,
            "height": height,
            "boxes": boxes,
            "gt_classes": gt_classes,
            "gt_ishard": ishards,
            "gt_overlaps": overlaps,
            "flipped": False,
            "seg_areas": seg_areas,
        }

    def selective_search_roidb(self):
        """gt + selective-search proposal roidb (pascal_voc.py:139-165):
        proposals from data/selective_search_data/<name>.pkl merged with gt
        (test split uses proposals alone)."""
        cache_file = os.path.join(self.cache_path,
                                  self.name + "_selective_search_roidb.pkl")
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as fid:
                return pickle.load(fid)
        if int(self._year) == 2007 or self._image_set != "test":
            gt = self.gt_roidb()
            ss = self._load_selective_search_roidb(gt)
            roidb = self.merge_roidbs(gt, ss)
        else:
            roidb = self._load_selective_search_roidb(None)
        with open(cache_file, "wb") as fid:
            pickle.dump(roidb, fid, pickle.HIGHEST_PROTOCOL)
        return roidb

    def _load_selective_search_roidb(self, gt_roidb):
        """Load the MATLAB-format proposal file (pascal_voc.py:177-191):
        boxes stored (y1, x1, y2, x2) 1-based → (x1, y1, x2, y2) 0-based."""
        import scipy.io as sio

        filename = os.path.join(
            self._data_root(), "selective_search_data", self.name + ".mat"
        )
        assert os.path.exists(filename), (
            f"Selective search data not found at: {filename}"
        )
        raw_data = sio.loadmat(filename)["boxes"].ravel()
        box_list = []
        for i in range(raw_data.shape[0]):
            boxes = raw_data[i][:, (1, 0, 3, 2)] - 1
            from .ds_utils import unique_boxes, filter_small_boxes

            keep = unique_boxes(boxes)
            boxes = boxes[keep, :]
            keep = filter_small_boxes(boxes, self.config["min_size"])
            box_list.append(boxes[keep, :])
        return self.create_roidb_from_box_list(box_list, gt_roidb)

    def rpn_roidb(self):
        """gt + precomputed-RPN proposal roidb (pascal_voc.py:167-203): proposal
        pickle path supplied via config['rpn_file']."""
        if int(self._year) == 2007 or self._image_set != "test":
            gt = self.gt_roidb()
            rpn = self._load_rpn_roidb(gt)
            return self.merge_roidbs(gt, rpn)
        return self._load_rpn_roidb(None)

    def _load_rpn_roidb(self, gt_roidb):
        filename = self.config["rpn_file"]
        print(f"loading {filename}")
        assert filename and os.path.exists(filename), (
            f"rpn data not found at: {filename}"
        )
        with open(filename, "rb") as f:
            box_list = pickle.load(f)
        return self.create_roidb_from_box_list(box_list, gt_roidb)

    def _get_comp_id(self):
        return (
            f"{self._comp_id}_{self._salt}" if self.config["use_salt"] else self._comp_id
        )

    def _get_voc_results_file_template(self, output_dir):
        filename = self._get_comp_id() + "_det_" + self._image_set + "_{:s}.txt"
        filedir = os.path.join(output_dir, "results", "VOC" + self._year, "Main")
        os.makedirs(filedir, exist_ok=True)
        return os.path.join(filedir, filename)

    def _write_voc_results_file(self, all_boxes, output_dir):
        for cls_ind, cls in enumerate(self.classes):
            if cls == "__background__":
                continue
            print(f"Writing {cls} VOC results file")
            filename = self._get_voc_results_file_template(output_dir).format(cls)
            with open(filename, "wt") as f:
                for im_ind, index in enumerate(self.image_index):
                    dets = all_boxes[cls_ind][im_ind]
                    if len(dets) == 0:
                        continue
                    for k in range(dets.shape[0]):
                        # VOCdevkit expects 1-based indices (pascal_voc.py:283-288)
                        f.write(
                            f"{index} {dets[k, -1]:.3f} "
                            f"{dets[k, 0] + 1:.1f} {dets[k, 1] + 1:.1f} "
                            f"{dets[k, 2] + 1:.1f} {dets[k, 3] + 1:.1f}\n"
                        )

    def _do_python_eval(self, output_dir="output"):
        annopath = os.path.join(self._data_path, "Annotations", "{:s}.xml")
        imagesetfile = os.path.join(
            self._data_path, "ImageSets", "Main", self._image_set + ".txt"
        )
        cachedir = os.path.join(self._devkit_path, "annotations_cache")
        aps = []
        use_07_metric = True if int(self._year) < 2010 else False
        print("VOC07 metric? " + ("Yes" if use_07_metric else "No"))
        os.makedirs(output_dir, exist_ok=True)
        for cls in self._classes:
            if cls == "__background__":
                continue
            filename = self._get_voc_results_file_template(output_dir).format(cls)
            rec, prec, ap = voc_eval(
                filename, annopath, imagesetfile, cls, cachedir,
                ovthresh=0.5, use_07_metric=use_07_metric,
            )
            aps += [ap]
            print(f"AP for {cls} = {ap:.4f}")
            with open(os.path.join(output_dir, cls + "_pr.pkl"), "wb") as f:
                pickle.dump({"rec": rec, "prec": prec, "ap": ap}, f)
        print(f"Mean AP = {np.mean(aps):.4f}")
        print("~~~~~~~~")
        print("Results:")
        for ap in aps:
            print(f"{ap:.3f}")
        print(f"{np.mean(aps):.3f}")
        print("~~~~~~~~")
        return float(np.mean(aps))

    def evaluate_detections(self, all_boxes, output_dir):
        self._write_voc_results_file(all_boxes, output_dir)
        mean_ap = self._do_python_eval(output_dir)
        if self.config["cleanup"]:
            for cls in self._classes:
                if cls == "__background__":
                    continue
                filename = self._get_voc_results_file_template(output_dir).format(cls)
                if os.path.exists(filename):
                    os.remove(filename)
        return mean_ap

    def competition_mode(self, on):
        if on:
            self.config["use_salt"] = False
            self.config["cleanup"] = False
        else:
            self.config["use_salt"] = True
            self.config["cleanup"] = True
