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
from typing import NamedTuple

import numpy as np
import torch

from ..config import NETS, Config, build_config
from ..data.blob import PIXEL_MEANS_BGR, blob_scale, pad_shape, read_image_bgr, resized_shape
from ..device import resolve_device
from ..models import build_detector
from ..ops.image_blob import image_blob
from ..utils import tracing
from .checkpoint import load_net_npz
from .detect import postprocess_detections

NUM_CLASSES = {"pascal_voc": 21, "pascal_voc_0712": 21, "coco": 81}


class Staged(NamedTuple):
    """A request's input on the host, as `Detector.blob` leaves it: `host`,
    the bytes to copy (im_info's three f32, then the image from byte
    `INFO_BYTES`, `image_dtype`, `[h, w, 3]`), the resize factor, the
    resized size and the blob's padded shape."""

    host: torch.Tensor
    image_dtype: torch.dtype
    image_shape: tuple[int, int]
    scale: float
    size: tuple[int, int]
    pad: tuple[int, int]


INFO_BYTES = 16         # im_info's 12 bytes, the image 16-byte aligned after them


class Detector:
    """`detect(im_bgr)` → (boxes `[M, 4]`, scores `[M]`, classes `[M]`,
    valid `[M]`) as numpy, M = cfg.TEST.MAX_DETS_PER_IMAGE, boxes in the
    image's own coordinates.

    A request's input crosses as the decoded image: `blob` writes it and
    im_info into a staging buffer the detector owns (pinned on a CUDA
    detector; it grows only when a larger image arrives, counting
    `blob.staging_allocs`), `put` sends that buffer in one copy and builds
    the blob where the model runs (`ops/image_blob.py`: on the card one
    kernel launch), equal to `prep_im_for_blob` and the 32-pad to the
    bit."""

    def __init__(self, model, cfg: Config, device: str | torch.device = "cuda",
                 pad_to: tuple[int, int] | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.pad_to = None if pad_to is None else pad_shape(*pad_to)
        self.means = torch.tensor(PIXEL_MEANS_BGR.reshape(3), device=self.device)
        self._staging = None
        # recorded after each copy out of the staging buffer, waited on
        # before the buffer is written again
        self._copied = torch.cuda.Event() if self.device.type == "cuda" else None

    def _staging_buffer(self, nbytes: int) -> torch.Tensor:
        if self._copied is not None:
            self._copied.synchronize()
        if self._staging is None or self._staging.numel() < nbytes:
            self._staging = torch.empty(nbytes, dtype=torch.uint8,
                                        pin_memory=self.device.type == "cuda")
            tracing.count("blob.staging_allocs")
        return self._staging[:nbytes]

    def blob(self, im_bgr: np.ndarray) -> Staged:
        """The host's part of a request's input: the resize factor, the
        resized size and the padded shape (with `pad_to`, snapped up to
        multiples of 32, that canvas wherever the image fits in it), and
        im_info (h, w, scale) and the image in the staging buffer. A
        uint8 image stays uint8, any other is taken as f32."""
        h, w = im_bgr.shape[:2]
        scale = blob_scale(h, w, self.cfg.TEST.SCALES[0])
        size = resized_shape(h, w, scale)
        pad = pad_shape(*size)
        if self.pad_to is not None and all(p >= s for p, s in zip(self.pad_to, pad)):
            pad = self.pad_to
        dtype, image_dtype = ((np.uint8, torch.uint8) if im_bgr.dtype == np.uint8
                              else (np.float32, torch.float32))
        nbytes = INFO_BYTES + h * w * 3 * np.dtype(dtype).itemsize
        host = self._staging_buffer(nbytes)
        raw = host.numpy()
        raw[:12].view(np.float32)[:] = (size[0], size[1], scale)
        np.copyto(raw[INFO_BYTES:].view(dtype).reshape(h, w, 3), im_bgr, casting="unsafe")
        return Staged(host, image_dtype, (h, w), scale, size, pad)

    def put(self, staged: Staged):
        """The staged input on the detector's device in one copy (from
        pinned memory, not waited for), and the blob built there: (data
        `[1, H, W, 3]` f32, im_info `[1, 3]`)."""
        buf = staged.host.to(self.device, non_blocking=True, copy=True)
        if self._copied is not None:
            self._copied.record(torch.cuda.current_stream(self.device))
        info = buf[:12].view(torch.float32).view(1, 3)
        image = buf[INFO_BYTES:].view(staged.image_dtype).view(*staged.image_shape, 3)
        return image_blob(image, self.means, staged.scale, staged.size, staged.pad), info

    def inputs(self, im_bgr: np.ndarray):
        """(data, im_info) of one image on the detector's device, as
        `detect` gives them to the model."""
        return self.put(self.blob(im_bgr))

    @torch.inference_mode()
    def detect(self, im_bgr: np.ndarray):
        """Spans `serve.request` around the call, and within it
        `serve.prep` (`blob`), `serve.h2d` (`put`), the model's,
        `serve.postprocess` and `serve.d2h` (where the host waits for the
        card)."""
        with tracing.span("serve.request", shape=tuple(im_bgr.shape)):
            with tracing.span("serve.prep"):
                staged = self.blob(im_bgr)
            with tracing.span("serve.h2d"):
                data, info = self.put(staged)
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
