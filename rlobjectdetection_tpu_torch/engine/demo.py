"""Demo: detect objects in a folder of images, draw them, write
`<name>_det.jpg` (the port's counterpart of the JAX package's
`tools/demo.py`).

    python -m rlobjectdetection_tpu_torch.engine.demo --image_dir D \
        [--net NET] [--load_name faster_rcnn_1_20.pth] \
        [--out_dir O] [--cag] [--vis_thresh 0.5] [--pad_to H W] [--device cuda] \
        [--set KEY VALUE ...]

NET is a name of `config.NETS` (default vgg16). Single-scale detection
through `serve.Detector` (per-class NMS at TEST.NMS, the top
TEST.MAX_DETS_PER_IMAGE), then at most 10 boxes a class above
`--vis_thresh` drawn with Pillow. `--load_name` is a `trainval_net`
checkpoint: its pooling_mode and class_agnostic are restored
(`config.checkpoint_config`), and its class names (VOC's 20 where it has
none) label the boxes; the config is `config.build_config` with no
dataset, the net's recipe and `--set`, so a checkpoint trained with other
anchors needs them set (`--set ANCHOR_SCALES "(4,8,16,32)"` for COCO).
`--pad_to H W` (snapped up to multiples of 32) pads every image that fits
to one canvas.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..config import NETS, build_config, checkpoint_config
from ..data.blob import read_image_bgr
from ..device import resolve_device
from ..models import build_detector
from .checkpoint import load_checkpoint, read_checkpoint
from .serve import Detector

VOC_CLASSES = (
    "__background__", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Faster R-CNN demo")
    p.add_argument("--net", default="vgg16", choices=sorted(NETS))
    p.add_argument("--image_dir", default="images")
    p.add_argument("--out_dir", default=None, help="where *_det.jpg go (default --image_dir)")
    p.add_argument("--load_name", default=None, help="trainval_net checkpoint (.pth)")
    p.add_argument("--cag", dest="class_agnostic", action="store_true")
    p.add_argument("--vis_thresh", default=0.5, type=float)
    p.add_argument("--pad_to", nargs=2, type=int, default=None, metavar=("H", "W"),
                   help="one canvas for every image that fits (snapped up to multiples of 32)")
    p.add_argument("--webcam_num", default=-1, type=int,
                   help="webcam index (>= 0): waits for cv2's video capture")
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=None)
    args = p.parse_args(argv)
    if args.webcam_num >= 0:
        p.exit(2, "demo: --webcam_num is not ported: it waits for cv2's video capture, "
                  "which the GPU machine lacks (ROADMAP §1, waiting)\n")
    return args


def vis_detections(draw, class_name: str, dets: np.ndarray, thresh: float = 0.8) -> None:
    """The first 10 of `dets` (`[N, 5]`: box, score) above `thresh`, drawn
    on a Pillow `ImageDraw`."""
    for i in range(min(10, dets.shape[0])):
        score = float(dets[i, -1])
        if score > thresh:
            x1, y1, x2, y2 = (int(np.round(x)) for x in dets[i, :4])
            draw.rectangle((x1, y1, x2, y2), outline=(0, 204, 0), width=2)
            draw.text((x1, y1 + 2), f"{class_name}: {score:.3f}", fill=(255, 0, 0))


def main(argv=None) -> dict:
    """Returns {image file name: (boxes, scores, classes, valid)}, the
    detections drawn into its `_det.jpg`."""
    from PIL import Image, ImageDraw

    args = parse_args(argv)
    dev = resolve_device(args.device)
    payload = read_checkpoint(args.load_name) if args.load_name else None
    cfg, class_agnostic = checkpoint_config(build_config(None, args.set_cfgs, net=args.net),
                                            payload, args.class_agnostic)
    classes = VOC_CLASSES if payload is None else tuple(payload.get("classes", VOC_CLASSES))
    model = build_detector(len(classes), NETS[args.net].backbone, cfg,
                           class_agnostic=class_agnostic, device=dev)
    if payload is not None:
        load_checkpoint(payload, model)
    else:
        print("WARNING: no --load_name; using seeded random weights")
    detector = Detector(model, cfg, dev, pad_to=args.pad_to)

    names = sorted(f for f in os.listdir(args.image_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")) and "_det" not in f)
    print(f"Loaded Photo: {len(names)} images.")
    out_dir = args.out_dir or args.image_dir
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    for name in names:
        path = os.path.join(args.image_dir, name)
        t0 = time.perf_counter()
        boxes, scores, cls, valid = results[name] = detector.detect(read_image_bgr(path))
        print(f"{name}: detect {time.perf_counter() - t0:.3f}s")
        im = Image.open(path).convert("RGB")
        draw = ImageDraw.Draw(im)
        for j in range(1, len(classes)):
            sel = valid & (cls == j)
            if sel.any():
                vis_detections(draw, classes[j],
                               np.concatenate([boxes[sel], scores[sel, None]], 1),
                               args.vis_thresh)
        out_path = os.path.join(out_dir, os.path.splitext(name)[0] + "_det.jpg")
        im.save(out_path)
        print(f"wrote {out_path}")
    return results


if __name__ == "__main__":
    main()
