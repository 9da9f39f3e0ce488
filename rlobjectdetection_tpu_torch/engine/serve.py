"""Serving: image → detections, the prep → forward → post-process pipeline
of `tools/demo.py::_make_detector`, without the drawing and the webcam.

    python -m rlobjectdetection_tpu_torch.engine.serve --image_dir D \
        [--load_npz P] [--net NET] [--dataset coco] [--device cuda] \
        [--set TEST.SCALES "[800]" ...]

serves every image of a folder with seeded random weights, or with a
`save_net_npz` dump of the JAX package, and prints one line per image.
NET is a name of `config.NETS` (default res101).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import NETS, Config, build_config
from ..data.blob import PIXEL_MEANS_BGR, pad_shape, prep_im_for_blob, read_image_bgr
from ..data.minibatch import im_list_to_blob
from ..device import pageable_to, resolve_device
from ..models import build_detector
from ..utils import tracing
from .checkpoint import load_net_npz
from .detect import postprocess_detections

NUM_CLASSES = {"pascal_voc": 21, "pascal_voc_0712": 21, "coco": 81}


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
                    score_thresh=self.model.test_score_thresh)
            with tracing.span("serve.d2h"):
                return tuple(t.cpu().numpy() for t in dets)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Faster R-CNN detection over an image folder")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--load_npz", default=None, help="save_net_npz dump of the JAX package")
    p.add_argument("--net", default="res101", choices=sorted(NETS))
    p.add_argument("--dataset", default="coco", choices=sorted(NUM_CLASSES))
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=None)
    args = p.parse_args(argv)

    cfg = build_config(args.dataset, args.set_cfgs, net=args.net)
    model = build_detector(NUM_CLASSES[args.dataset], NETS[args.net].backbone, cfg,
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
