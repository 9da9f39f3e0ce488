"""Detector evaluation over a dataset (the port's counterpart of the JAX
package's `tools/test_net.py`).

    python -m rlobjectdetection_tpu_torch.engine.test_net --dataset coco \
        [--net res101|res50|vgg16|tiny] [--load_dir D [--s S] [--checkepoch E]] \
        [--weights F] [--load_npz P] [--batch N] [--device cuda] \
        [--cfg F] [--ls] [--cag] [--vis [--vis_max K]] [--set KEY VALUE ...]

builds the test roidb (`$RLOD_DATA_DIR`, as the JAX package reads it), runs
the detector over every image, writes `output/<net>/<imdb>/detections.pkl`
and scores it with the imdb's `evaluate_detections` (COCOeval for COCO,
`voc_eval` for VOC). The weights: a `trainval_net` checkpoint
(`<load_dir>/<net>/<dataset>/faster_rcnn_<s>_<checkepoch>.pth`, whose
pooling_mode replaces the config's; any of `--load_dir`, `--s` /
`--checksession` and `--checkepoch` asks for one, the others default to
`models`, 1 and 1), converted weights merged into the seeded ones
(`--weights`, `convert_torch_weights`' output), a `save_net_npz` dump of the
JAX package (`--load_npz`), or else the seeded random weights.

At `--batch 1` the loop runs over `device_prefetch`: batches are assembled
on worker threads and copied to the card ahead of the forward. At
`--batch N` images are grouped by padded shape (`eval_bucket_plan`) into
fixed `[N, H, W, 3]` canvases; padding rows are dropped. Either way each
image goes through `postprocess_detections`, and a batch's detections come
back to the host in one copy.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time

import numpy as np
import torch

from ..config import Config, cfg_update
from ..data.imdb import combined_roidb
from ..data.loader import RoiBatchLoader, eval_bucket_plan
from ..data.prefetch import AsyncLoader, device_prefetch, to_device
from ..device import resolve_device
from ..models import FasterRCNN
from .checkpoint import (checkpoint_path, load_checkpoint, load_net_npz, load_params,
                         read_checkpoint)
from .convert_torch_weights import merge_pretrained
from .detect import detections_to_all_boxes, postprocess_detections
from .serve import BACKBONES, build_config

DATASET_MAP = {
    "pascal_voc": "voc_2007_test",
    "pascal_voc_0712": "voc_2007_test",
    "coco": "coco_2014_minival",
    "imagenet": "imagenet_val",
    "vg": "vg_1600-400-20_val",
}
# batch assembly threads of the eval loop (AsyncLoader clamps to the cores)
ASSEMBLY_THREADS = 4
# flags of tools/test_net.py whose counterparts wait for a later part of the
# port: each exits with the ROADMAP item that brings it
WAITING_FLAGS = {"--packed_input": "it waits for ROADMAP §1 item 17b (data/packed.py)"}


def refuse_waiting_flags(parser, argv, waiting: dict, prog: str) -> None:
    """Exit with code 2 and the flag's reason on a flag of `waiting` given
    before `--set` (whose REMAINDER would swallow it)."""
    head = argv[:argv.index("--set")] if "--set" in argv else argv
    for flag in head:
        reason = waiting.get(flag.split("=", 1)[0])
        if reason is not None:
            parser.exit(2, f"{prog}: {flag} is not ported: {reason}\n")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a Faster R-CNN detector on a dataset")
    p.add_argument("--dataset", default="pascal_voc")
    p.add_argument("--net", default="res101", choices=sorted(BACKBONES))
    p.add_argument("--cfg", dest="cfg_file", default=None)
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    p.add_argument("--ls", dest="large_scale", action="store_true")
    p.add_argument("--cag", dest="class_agnostic", action="store_true")
    p.add_argument("--vis", action="store_true")
    p.add_argument("--vis_max", default=0, type=int,
                   help="cap on --vis overlays (0 = all images)")
    p.add_argument("--batch", default=1, type=int,
                   help="eval batch size; >1 groups images by padded-shape bucket")
    p.add_argument("--load_dir", default=None,
                   help="trainval_net's --save_dir (models where a checkpoint is asked for)")
    p.add_argument("--s", "--checksession", dest="session", default=None, type=int)
    p.add_argument("--checkepoch", default=None, type=int)
    p.add_argument("--weights", default=None,
                   help="converted weights (convert_torch_weights output)")
    p.add_argument("--load_npz", default=None, help="save_net_npz dump of the JAX package")
    p.add_argument("--device", default="cuda")
    argv = sys.argv[1:] if argv is None else list(argv)
    refuse_waiting_flags(p, argv, WAITING_FLAGS, "test_net")
    return p.parse_args(argv)


class EvalJobs:
    """The eval loop's batches as `AsyncLoader` jobs. At batch 1 the
    loader's own plan; at batch N `eval_bucket_plan`'s, each assembled on
    its bucket's `[N, H, W, 3]` canvas. A job's result is (indices, batch,
    host ms of its assembly)."""

    def __init__(self, loader: RoiBatchLoader, batch: int, scales):
        self.loader, self.batch = loader, batch
        if batch == 1:
            self.plan = [(idxs, None, seed) for idxs, _, seed in loader.batch_plan()]
        else:
            if len(scales) != 1:
                raise ValueError("--batch > 1 needs a single TEST scale (shape planning)")
            self.plan = [(idxs, hw, k) for k, (idxs, hw) in
                         enumerate(eval_bucket_plan(loader.roidb, scales[0], batch))]

    def batch_plan(self):
        return self.plan

    def assemble_job(self, job):
        idxs, hw, seed = job
        t0 = time.perf_counter()
        if hw is None:
            b = self.loader._assemble(idxs, 1.0, seed=seed)
        else:
            b = self.loader._assemble(idxs, 1.0, pad_hw=hw, pad_count=self.batch, seed=seed)
        return idxs, b, (time.perf_counter() - t0) * 1e3


def postprocess_batch(model, out, info, n: int, cfg: Config) -> torch.Tensor:
    """`postprocess_detections` on the first n rows of a batch's outputs,
    packed on the model's device as `[n, M, 7]` (x1, y1, x2, y2, score,
    class, valid), so the batch comes to the host in one copy."""
    rows = []
    for j in range(n):
        boxes, scores, classes, valid = postprocess_detections(
            out["rois"][j], out["cls_prob"][j], out["bbox_pred"][j], info[j],
            out["roi_valid"][j], num_classes=model.num_classes,
            class_agnostic=model.class_agnostic,
            max_per_image=cfg.TEST.MAX_DETS_PER_IMAGE, nms_thresh=cfg.TEST.NMS,
            bbox_reg=cfg.TEST.BBOX_REG, normalize_stds=cfg.TRAIN.BBOX_NORMALIZE_STDS,
            normalize_means=cfg.TRAIN.BBOX_NORMALIZE_MEANS)
        rows.append(torch.cat([boxes, scores[:, None], classes[:, None].float(),
                               valid[:, None].float()], 1))
    return torch.stack(rows)


def unpack_dets(packed_row: np.ndarray):
    """One image's `[M, 7]` row of `postprocess_batch` → (boxes, scores,
    classes int32, valid bool), as `Detector.detect` returns them."""
    return (packed_row[:, :4], packed_row[:, 4], packed_row[:, 5].astype(np.int32),
            packed_row[:, 6] > 0)


@torch.inference_mode()
def detect_loop(model, cfg: Config, roidb, ratio_list, ratio_index, batch: int = 1,
                on_batch=None):
    """Every image of the roidb through the detector. Returns (dets, stats):
    dets[i] = (boxes, scores, classes, valid) of image i, in original image
    coordinates; stats holds the loop's wall, device-timed and steady
    seconds, the seconds between batches after the first (the device idles
    while the loop waits on the loader and stages the next copies in pinned
    memory), host assembly ms an image, and the padded shapes seen.

    `on_batch(idxs, data, info, out)`, if given, sees each batch as the
    model saw it (the blob and im_info on the device, the model's output
    dict) after its detections are on the host, outside the timed spans."""
    dev = next(model.parameters()).device
    loader = RoiBatchLoader(roidb, ratio_list, ratio_index, 1, scales=cfg.TEST.SCALES,
                            max_num_gt=cfg.MAX_NUM_GT_BOXES, training=False)
    jobs = EvalJobs(loader, batch, cfg.TEST.SCALES)

    def put(job_out):
        idxs, b, asm_ms = job_out
        return idxs, b["data"].shape, asm_ms, to_device(b["data"], dev), to_device(b["im_info"], dev)

    n_images = len(roidb)
    dets = [None] * n_images
    t_det = t_steady = t_wait = 0.0
    n_done = n_steady = 0
    asm_ms, shape_buckets = [], {}
    t_wall0 = t_it = time.perf_counter()
    for idxs, shape, ms, data, info in device_prefetch(
            AsyncLoader(jobs, num_workers=ASSEMBLY_THREADS), put, device=dev):
        if n_done:
            # the device idles from the last batch's copy back until here
            t_wait += time.perf_counter() - t_it
        hw = tuple(shape[1:3])
        # a shape's first batch carries cuDNN's algorithm search for it
        warm = hw in shape_buckets
        shape_buckets[hw] = shape_buckets.get(hw, 0) + len(idxs)
        asm_ms.append(ms / len(idxs))
        t0 = time.perf_counter()
        out = model(data, info)
        packed = postprocess_batch(model, out, info, len(idxs), cfg).cpu().numpy()
        t_det += time.perf_counter() - t0
        if warm:
            t_steady += time.perf_counter() - t_it
            n_steady += len(idxs)
        if on_batch is not None:
            on_batch(idxs, data, info, out)
        for j, idx in enumerate(idxs):
            dets[idx] = unpack_dets(packed[j])
        prev, n_done = n_done, n_done + len(idxs)
        if n_done // 100 > prev // 100 or n_done == n_images or prev == 0:
            print(f"im_detect: {n_done}/{n_images} {t_det / n_done:.3f}s/img", flush=True)
        t_it = time.perf_counter()
    stats = dict(images=n_images, wall_s=time.perf_counter() - t_wall0, device_s=t_det,
                 steady_s=t_steady, steady_images=n_steady, wait_s=t_wait,
                 assembly_ms_per_image=float(np.mean(asm_ms)) if asm_ms else 0.0,
                 shape_buckets=shape_buckets)
    return dets, stats


def print_rates(stats) -> None:
    """The detect-loop rate line and the shape-bucket report."""
    n, wall = stats["images"], stats["wall_s"]
    print(f"detect loop: {n / wall:.1f} img/s wall ({wall:.1f}s total; device-timed "
          f"{n / max(stats['device_s'], 1e-9):.1f} img/s; steady "
          f"{stats['steady_images'] / max(stats['steady_s'], 1e-9):.1f} img/s over "
          f"{stats['steady_images']} repeat-shape images; host assembly "
          f"{stats['assembly_ms_per_image']:.1f} ms/img; {stats['wait_s']:.3f}s between batches "
          f"after the first)", flush=True)
    buckets = stats["shape_buckets"]
    print(f"shape buckets: {len(buckets)} distinct padded shapes over {n} images")
    for hw, k in sorted(buckets.items(), key=lambda kv: -kv[1]):
        print(f"  {hw[0]}x{hw[1]}: {k} images")


def write_vis(imdb_obj, roidb, i, boxes, scores, classes, valid, out_dir) -> None:
    """--vis: the detections (score >= 0.3) drawn on the original image with
    Pillow, saved as `out_dir/det_<i>.jpg`."""
    from PIL import Image, ImageDraw

    im = Image.open(roidb[i]["image"]).convert("RGB")
    draw = ImageDraw.Draw(im)
    for b, s, c, v in zip(boxes, scores, classes, valid):
        if not v or s < 0.3:
            continue
        x1, y1, x2, y2 = (int(round(float(x))) for x in b)
        draw.rectangle((x1, y1, x2, y2), outline=(0, 204, 0), width=2)
        name = imdb_obj.classes[int(c)] if int(c) < imdb_obj.num_classes else str(c)
        draw.text((x1, y1 + 2), f"{name}: {s:.2f}", fill=(255, 0, 0))
    os.makedirs(out_dir, exist_ok=True)
    im.save(os.path.join(out_dir, f"det_{i:04d}.jpg"))


def main(argv=None):
    """Returns what `evaluate_detections` returns (VOC: the mean AP; COCO:
    the 12 summary stats)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.batch < 1:
        sys.exit("--batch must be >= 1")
    cfg = build_config(args.dataset, args.set_cfgs, large_scale=args.large_scale,
                       cfg_file=args.cfg_file)

    imdb_name = DATASET_MAP.get(args.dataset, args.dataset)
    imdb_obj, roidb, ratio_list, ratio_index = combined_roidb(
        imdb_name, training=False, use_flipped=False)
    print(f"{len(roidb)} images for evaluation")

    payload = None
    if any(v is not None for v in (args.load_dir, args.session, args.checkepoch)):
        path = checkpoint_path(args.load_dir or "models", args.net, args.dataset,
                               args.session or 1, args.checkepoch or 1)
        payload = read_checkpoint(path)
        if payload.get("pooling_mode"):
            cfg = cfg_update(cfg, {"POOLING_MODE": payload["pooling_mode"]})
        print(f"load checkpoint {path} (pooling_mode {cfg.POOLING_MODE})")
    model = FasterRCNN(imdb_obj.num_classes, BACKBONES[args.net], cfg,
                       class_agnostic=args.class_agnostic, device=dev)
    if payload is not None:
        load_checkpoint(payload, model)
    elif args.weights:
        model.load_state_dict(merge_pretrained(model.state_dict(), load_params(args.weights)))
    elif args.load_npz:
        load_net_npz(args.load_npz, model)
    else:
        print("no checkpoint, --weights or --load_npz: evaluating seeded random weights")

    dets, stats = detect_loop(model, cfg, roidb, ratio_list, ratio_index, args.batch)
    print_rates(stats)
    if args.vis:
        for i, d in enumerate(dets):
            if args.vis_max <= 0 or i < args.vis_max:
                write_vis(imdb_obj, roidb, i, *d, os.path.join("output", "vis"))

    all_boxes = detections_to_all_boxes(dets, imdb_obj.num_classes)
    output_dir = os.path.join("output", args.net, imdb_name)
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "detections.pkl"), "wb") as f:
        pickle.dump(all_boxes, f, pickle.HIGHEST_PROTOCOL)

    print("Evaluating detections")
    # competition mode: stable, unsalted result files that stay after scoring
    imdb_obj.competition_mode(on=True)
    return imdb_obj.evaluate_detections(all_boxes, output_dir)


if __name__ == "__main__":
    main()
