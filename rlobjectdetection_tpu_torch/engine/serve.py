"""Serving: image → detections, the prep → forward → post-process pipeline
of `tools/demo.py::_make_detector`, without the drawing and the webcam.

    python -m rlobjectdetection_tpu_torch.engine.serve --image_dir D \
        [--load_npz P] [--net res101|res101_fpn|vgg16] [--dataset coco] [--device cuda] \
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

from ..config import (DATASET_OVERRIDES, LS_OVERRIDES, NET_OVERRIDES, Config, cfg_from_file,
                      cfg_from_list, cfg_update)
from ..data.blob import PIXEL_MEANS_BGR, pad_shape, prep_im_for_blob, read_image_bgr
from ..data.minibatch import im_list_to_blob
from ..device import pageable_to, resolve_device
from ..models import build_detector
from ..utils import tracing
from .checkpoint import load_net_npz
from .detect import postprocess_detections

NUM_CLASSES = {"pascal_voc": 21, "pascal_voc_0712": 21, "coco": 81}
# --net → the detector's backbone, as tools/demo.py maps it (`tiny`: the test
# backbone; `res101_fpn`: the FPN detector, `models/fpn.py`)
BACKBONES = {"vgg16": "vgg16", "res50": "resnet50", "res101": "resnet101",
             "res101_fpn": "resnet101_fpn", "res152": "resnet152", "tiny": "tiny"}


class Detector:
    """`detect(im_bgr)` → (boxes `[M, 4]`, scores `[M]`, classes `[M]`,
    valid `[M]`) as numpy, M = cfg.TEST.MAX_DETS_PER_IMAGE, boxes in the
    image's own coordinates."""

    def __init__(self, model, cfg: Config, device: str | torch.device = "cuda",
                 pad_to: tuple[int, int] | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.pad_to = None if pad_to is None else pad_shape(*pad_to)

    def blob(self, im_bgr: np.ndarray):
        """Mean-subtracted, resized, 32-padded `[1, H, W, 3]` blob and its
        im_info `[1, 3]` (h, w, scale) as numpy. With `pad_to` (snapped up
        to multiples of 32) the blob is that canvas wherever the image fits
        in it."""
        im, im_scale = prep_im_for_blob(im_bgr, PIXEL_MEANS_BGR, self.cfg.TEST.SCALES[0])
        im_info = np.array([[im.shape[0], im.shape[1], im_scale]], dtype=np.float32)
        blob = im_list_to_blob([im])
        if self.pad_to is not None and all(p >= s for p, s in zip(self.pad_to, blob.shape[1:3])):
            canvas = np.zeros((1, *self.pad_to, 3), dtype=np.float32)
            canvas[0, :im.shape[0], :im.shape[1]] = im
            blob = canvas
        return blob, im_info

    @torch.inference_mode()
    def detect(self, im_bgr: np.ndarray):
        """Spans `serve.request` around the call, and within it
        `serve.prep`, `serve.h2d`, the model's, `serve.postprocess` and
        `serve.d2h` (where the host waits for the card)."""
        with tracing.span("serve.request", shape=tuple(im_bgr.shape)):
            with tracing.span("serve.prep"):
                blob, im_info = self.blob(im_bgr)
            with tracing.span("serve.h2d"):
                data = pageable_to(blob, self.device)
                info = pageable_to(im_info, self.device)
            out = self.model(data, info)
            with tracing.span("serve.postprocess"):
                dets = postprocess_detections(
                    out["rois"][0], out["cls_prob"][0], out["bbox_pred"][0], info[0],
                    out["roi_valid"][0], num_classes=self.model.num_classes,
                    class_agnostic=self.model.class_agnostic,
                    max_per_image=self.cfg.TEST.MAX_DETS_PER_IMAGE, nms_thresh=self.cfg.TEST.NMS,
                    score_thresh=getattr(self.model, "test_score_thresh", 0.0))
            with tracing.span("serve.d2h"):
                return tuple(t.cpu().numpy() for t in dets)


def build_config(dataset: str | None = None, set_cfgs=None, *, large_scale: bool = False,
                 cfg_file: str | None = None, pooling_mode: str | None = None,
                 net: str | None = None) -> Config:
    """The config of every entry point: Config() with the fused stem and
    layer1 kernels on, then in the JAX trainer's order the dataset's
    overrides (none for a name without any, such as an imdb name), `--ls`,
    the `--net`'s recipe (`NET_OVERRIDES`), `--cfg`, `--set` and
    `--pooling_mode`. Layer1's kernel stays on only
    with the stem's and where RESNET.FIXED_BLOCKS >= 1: it reads the stem
    kernel's output and is forward-only. VGG-16 reads CONV1_FUSED (its
    block-1 kernel) and ignores LAYER1_FUSED."""
    cfg = Config(CONV1_FUSED=True, LAYER1_FUSED=True)
    if dataset in DATASET_OVERRIDES:
        cfg = cfg_update(cfg, DATASET_OVERRIDES[dataset])
    if large_scale:
        cfg = cfg_update(cfg, LS_OVERRIDES)
    if net in NET_OVERRIDES:
        cfg = cfg_update(cfg, NET_OVERRIDES[net])
    if cfg_file:
        cfg = cfg_from_file(cfg, cfg_file)
    if set_cfgs:
        cfg = cfg_from_list(cfg, set_cfgs)
    if pooling_mode:
        cfg = cfg_update(cfg, {"POOLING_MODE": pooling_mode})
    if cfg.LAYER1_FUSED and not (cfg.CONV1_FUSED and cfg.RESNET.FIXED_BLOCKS >= 1):
        cfg = cfg_update(cfg, {"LAYER1_FUSED": False})
    return cfg


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Faster R-CNN detection over an image folder")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--load_npz", default=None, help="save_net_npz dump of the JAX package")
    p.add_argument("--net", default="res101", choices=sorted(BACKBONES))
    p.add_argument("--dataset", default="coco", choices=sorted(NUM_CLASSES))
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=None)
    args = p.parse_args(argv)

    cfg = build_config(args.dataset, args.set_cfgs, net=args.net)
    model = build_detector(NUM_CLASSES[args.dataset], BACKBONES[args.net], cfg,
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
