"""Serving: image → detections, the prep → forward → post-process pipeline
of `tools/demo.py::_make_detector`, without the drawing and the webcam.

    python -m rlobjectdetection_tpu_torch.engine.serve --image_dir D \
        [--load_npz P] [--net res101|vgg16] [--dataset coco] [--device cuda] \
        [--set TEST.SCALES "[800]" ...]

serves every image of a folder with seeded random weights, or with a
`save_net_npz` dump of the JAX package, and prints one line per image.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import DATASET_OVERRIDES, Config, cfg_from_list, cfg_update
from ..data.blob import PIXEL_MEANS_BGR, prep_im_for_blob, read_image_bgr
from ..data.minibatch import im_list_to_blob
from ..device import resolve_device
from ..models import FasterRCNN
from .checkpoint import load_net_npz
from .detect import postprocess_detections

NUM_CLASSES = {"pascal_voc": 21, "pascal_voc_0712": 21, "coco": 81}
# --net → FasterRCNN backbone, as tools/demo.py maps it
BACKBONES = {"vgg16": "vgg16", "res50": "resnet50", "res101": "resnet101",
             "res152": "resnet152"}


class Detector:
    """`detect(im_bgr)` → (boxes `[M, 4]`, scores `[M]`, classes `[M]`,
    valid `[M]`) as numpy, M = cfg.TEST.MAX_DETS_PER_IMAGE, boxes in the
    image's own coordinates."""

    def __init__(self, model, cfg: Config, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg

    def blob(self, im_bgr: np.ndarray):
        """Mean-subtracted, resized, 32-padded `[1, H, W, 3]` blob and its
        im_info `[1, 3]` (h, w, scale) as numpy."""
        im, im_scale = prep_im_for_blob(im_bgr, PIXEL_MEANS_BGR, self.cfg.TEST.SCALES[0])
        im_info = np.array([[im.shape[0], im.shape[1], im_scale]], dtype=np.float32)
        return im_list_to_blob([im]), im_info

    @torch.inference_mode()
    def detect(self, im_bgr: np.ndarray):
        blob, im_info = self.blob(im_bgr)
        data = torch.from_numpy(blob).to(self.device)
        info = torch.from_numpy(im_info).to(self.device)
        out = self.model(data, info)
        dets = postprocess_detections(
            out["rois"][0], out["cls_prob"][0], out["bbox_pred"][0], info[0],
            out["roi_valid"][0], num_classes=self.model.num_classes,
            class_agnostic=self.model.class_agnostic,
            max_per_image=self.cfg.TEST.MAX_DETS_PER_IMAGE, nms_thresh=self.cfg.TEST.NMS)
        return tuple(t.cpu().numpy() for t in dets)


def build_config(dataset: str, set_cfgs=None) -> Config:
    """Config() + the dataset's anchors (none for a name without overrides,
    such as an imdb name) + the fused kernels on + `--set`. VGG-16 reads
    CONV1_FUSED (its block-1 kernel) and ignores LAYER1_FUSED."""
    cfg = cfg_update(Config(), dict(DATASET_OVERRIDES.get(dataset, {}),
                                    CONV1_FUSED=True, LAYER1_FUSED=True))
    return cfg_from_list(cfg, set_cfgs) if set_cfgs else cfg


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Faster R-CNN detection over an image folder")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--load_npz", default=None, help="save_net_npz dump of the JAX package")
    p.add_argument("--net", default="res101", choices=sorted(BACKBONES))
    p.add_argument("--dataset", default="coco", choices=sorted(NUM_CLASSES))
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=None)
    args = p.parse_args(argv)

    cfg = build_config(args.dataset, args.set_cfgs)
    model = FasterRCNN(NUM_CLASSES[args.dataset], BACKBONES[args.net], cfg,
                       device=args.device)
    if args.load_npz:
        load_net_npz(args.load_npz, model)
    else:
        print("no --load_npz: serving seeded random weights")
    detector = Detector(model, cfg, args.device)
    names = sorted(f for f in os.listdir(args.image_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    for name in names:
        im = read_image_bgr(os.path.join(args.image_dir, name))
        t0 = time.perf_counter()
        boxes, scores, classes, valid = detector.detect(im)
        dt = time.perf_counter() - t0
        top = ", ".join(f"cls {c} {s:.3f} {np.round(b).astype(int).tolist()}"
                        for b, s, c in zip(boxes[valid][:3], scores[valid][:3],
                                           classes[valid][:3]))
        print(f"{name}: {int(valid.sum())} detections in {dt:.3f} s; top: {top}")


if __name__ == "__main__":
    main()
