"""Export the detector's serving function as one `torch.export` artifact
(counterpart of the JAX package's `tools/export_model.py`).

    python -m rlobjectdetection_tpu_torch.engine.export_model --load_name C \
        [--net NET] --out output/model.pt2 --height 800 --width 1216 \
        [--classes 81] [--cag] [--max_per_image 100] [--batch N] [--device cuda] \
        [--set KEY VALUE ...]

writes the whole eval step, blob `[N, H, W, 3]` + im_info `[N, 3]` →
backbone, proposals, head, decode, per-class NMS and the top
`--max_per_image` → {boxes, scores, classes, valid}, at fixed shapes and
with the weights inside, as a `.pt2` file (`torch.export.save`). NET is a
name of `config.NETS` (default res101), built with its recipe; a
checkpoint's pooling_mode and class_agnostic are restored
(`config.checkpoint_config`). The
hand-written kernels appear in it as the `rlod::` ops of `ops/library.py`
with their packed operands pinned as buffers (`pin_packs`), so a replay
packs nothing and launches the same kernels. Without `--load_name` the
weights are seeded random ones (a smoke artifact). `--batch N` bakes N
images into the input shape and postprocesses each (outputs gain a
leading N); at 1 they are one image's.

    python -m rlobjectdetection_tpu_torch.engine.export_model --replay F \
        --height 800 --width 1216 [--batch N] [--bench ITERS] [--device cuda]

loads the artifact after importing `rlobjectdetection_tpu_torch.ops.library`
alone (no model code: that is what makes it self-contained) and runs a
synthetic frame; `--bench ITERS` (on the card only) times ITERS calls with
CUDA events and prints `{"metric":
"export_artifact_images_per_sec_per_chip", ...}` on a line of its own.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

import rlobjectdetection_tpu_torch.ops.library  # noqa: F401  (registers the rlod:: ops)

from ..config import NETS
from .detect import postprocess_detections

OUTPUT_KEYS = ("boxes", "scores", "classes", "valid")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export or replay the serving function")
    p.add_argument("--load_name", default=None, help="a trainval_net checkpoint (.pth)")
    p.add_argument("--net", default="res101", choices=sorted(NETS))
    p.add_argument("--out", default=os.path.join("output", "model.pt2"))
    p.add_argument("--replay", default=None, help="load this artifact and run a synthetic frame")
    p.add_argument("--height", default=800, type=int)
    p.add_argument("--width", default=1216, type=int)
    p.add_argument("--classes", default=81, type=int)
    p.add_argument("--cag", dest="class_agnostic", action="store_true")
    p.add_argument("--max_per_image", default=100, type=int)
    p.add_argument("--batch", default=1, type=int,
                   help="images baked into the artifact's input shape")
    p.add_argument("--bench", default=0, type=int, metavar="ITERS",
                   help="with --replay: time ITERS calls and print a bench JSON line")
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=None)
    return p.parse_args(argv)


class ServingModule(torch.nn.Module):
    """blob + im_info → {boxes, scores, classes, valid}: the eval forward,
    then `postprocess_detections` of each image (stacked along a leading
    batch dimension where `batch` > 1)."""

    def __init__(self, model, *, max_per_image: int, nms_thresh: float, batch: int = 1,
                 bbox_reg: bool = True, normalize_stds=(0.1, 0.1, 0.2, 0.2),
                 normalize_means=(0.0, 0.0, 0.0, 0.0)):
        super().__init__()
        self.model = model
        self.batch = batch
        self.post = dict(num_classes=model.num_classes, class_agnostic=model.class_agnostic,
                         max_per_image=max_per_image, nms_thresh=nms_thresh, bbox_reg=bbox_reg,
                         normalize_stds=tuple(normalize_stds),
                         normalize_means=tuple(normalize_means))

    def forward(self, data: torch.Tensor, im_info: torch.Tensor) -> dict:
        out = self.model(data, im_info)
        per = [postprocess_detections(out["rois"][i], out["cls_prob"][i], out["bbox_pred"][i],
                                      im_info[i], out["roi_valid"][i], **self.post)
               for i in range(data.shape[0])]
        if self.batch == 1:
            return dict(zip(OUTPUT_KEYS, per[0]))
        return {k: torch.stack([p[j] for p in per]) for j, k in enumerate(OUTPUT_KEYS)}


def build_serving_fn(model, *, max_per_image: int, nms_thresh: float, batch: int = 1,
                     cfg=None) -> ServingModule:
    """The serving module of a `FasterRCNN`, its kernels' operands packed
    once and pinned as buffers (`pin_packs`), in eval and frozen (the
    export runs under `torch.no_grad()`: the forward-only kernels need
    it)."""
    model.base.pin_packs()
    extra = {} if cfg is None else dict(bbox_reg=cfg.TEST.BBOX_REG,
                                        normalize_stds=cfg.TRAIN.BBOX_NORMALIZE_STDS,
                                        normalize_means=cfg.TRAIN.BBOX_NORMALIZE_MEANS)
    serving = ServingModule(model, max_per_image=max_per_image, nms_thresh=nms_thresh,
                            batch=batch, **extra)
    return serving.eval().requires_grad_(False)


def export_serving(serving: ServingModule, example: tuple, path: str) -> dict:
    """`torch.export.export` of `serving` on the example (blob, im_info) and
    `torch.export.save` to `path`; returns {path, bytes, seconds}."""
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(serving, example)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    return {"path": path, "bytes": os.path.getsize(path), "seconds": time.perf_counter() - t0}


def export_artifact(args) -> dict:
    """Build the detector of `args` (weights from `--load_name` or seeded
    random), export its serving function and write the artifact."""
    from ..config import build_config, checkpoint_config
    from ..device import resolve_device
    from ..models import build_detector
    from .checkpoint import load_checkpoint, read_checkpoint

    dev = resolve_device(args.device)
    payload = read_checkpoint(args.load_name) if args.load_name else None
    cfg, class_agnostic = checkpoint_config(build_config(None, args.set_cfgs, net=args.net),
                                            payload, args.class_agnostic)
    model = build_detector(args.classes, NETS[args.net].backbone, cfg,
                           class_agnostic=class_agnostic, device=dev, seed=3)
    if payload is not None:
        load_checkpoint(payload, model)
    else:
        print("no --load_name: exporting seeded random weights (a smoke artifact)")
    n, h, w = args.batch, args.height, args.width
    serving = build_serving_fn(model, max_per_image=args.max_per_image, nms_thresh=cfg.TEST.NMS,
                               batch=n, cfg=cfg)
    example = (torch.zeros((n, h, w, 3), device=dev),
               torch.tensor([[float(h), float(w), 1.0]] * n, device=dev))
    info = export_serving(serving, example, args.out)
    print(f"exported {info['bytes'] / 1e6:.1f} MB -> {args.out} in {info['seconds']:.1f} s "
          f"(input [{n},{h},{w},3] on {dev})")
    return info


def synthetic_frame(batch: int, h: int, w: int, device) -> tuple:
    """The replay's input: seeded noise ×10 and im_info (h, w, 1)."""
    rng = np.random.RandomState(0)
    data = torch.from_numpy((rng.randn(batch, h, w, 3) * 10).astype(np.float32)).to(device)
    info = torch.tensor([[float(h), float(w), 1.0]] * batch, device=device)
    return data, info


def bench_artifact(fn, data, info, iters: int) -> dict:
    """ITERS calls of the loaded artifact on CUDA tensors after 3 warm ones,
    timed with CUDA events; {images_per_sec, ms_per_call}."""
    for _ in range(3):
        fn(data, info)
    torch.cuda.synchronize(data.device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(data, info)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    return {"images_per_sec": data.shape[0] * 1e3 / ms, "ms_per_call": ms}


def replay_artifact(path: str, h: int, w: int, batch: int = 1, bench_iters: int = 0,
                    device="cuda") -> dict:
    """Load the artifact (no model code is imported) and run one synthetic
    frame; with `bench_iters`, time it and print the bench JSON line.
    Returns the outputs (numpy) and, benched, the rates."""
    dev = torch.device(device)
    if bench_iters and dev.type != "cuda":
        raise ValueError("--bench times the artifact on the card: it needs --device cuda")
    fn = torch.export.load(path).module()
    data, info = synthetic_frame(batch, h, w, dev)
    with torch.no_grad():
        out = fn(data, info)
        result = {k: out[k].cpu().numpy() for k in OUTPUT_KEYS}
        print(f"replayed {path}: {int(result['valid'].sum())} detections above threshold "
              f"(top score {float(result['scores'].max()):.4f})")
        if bench_iters:
            rate = bench_artifact(fn, data, info, bench_iters)
            line = {"metric": "export_artifact_images_per_sec_per_chip",
                    "value": rate["images_per_sec"], "unit": "images/s",
                    "ms_per_call": rate["ms_per_call"], "batch": batch, "iters": bench_iters,
                    "device": torch.cuda.get_device_name(dev)}
            print(json.dumps(line))
            result["bench"] = line
    return result


def main(argv=None):
    args = parse_args(argv)
    if args.replay:
        return replay_artifact(args.replay, args.height, args.width, batch=args.batch,
                               bench_iters=args.bench, device=args.device)
    return export_artifact(args)


if __name__ == "__main__":
    main()
