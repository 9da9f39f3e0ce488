"""The RL pipeline end to end on a detector error it can learn
(counterpart of the JAX package's `tools/rl_hw_validate.py`).

    python -m rlobjectdetection_tpu_torch.engine.rl_hw_validate \
        [--epochs 3] [--layers 50] [--batch_size 4] [--img_short 224] \
        [--img_size 320] [--images 16] [--device cuda] [--pretrained F] [--work_dir W]

A synthetic COCO val split whose detections are its gt boxes shifted by a
constant (7, −5) px (clipped to the image), so some moves help every
detection. It scores the detections as they are (the pre-move mAP),
trains `engine/trainval_rl.py` on them, evaluates the last checkpoint
(`-e --resume`, top-1 teacher-forced moves) and scores the moved boxes
(the post-move mAP). Teacher forcing moves a box only where its action
helps it, so the post-move mAP must be at least the pre-move one. Prints
one JSON line {"metric": "rl_e2e_hw_validation", "pre_map", "post_map",
"preck", ..., "ok"}; exits 1 where post < pre.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import tempfile

SHIFT = (7.0, -5.0)


def build_fixture(root: str, num_images: int = 16, image_size=(240, 320), shift=SHIFT,
                  classes=("widget", "gadget", "gizmo")) -> tuple[str, str, str]:
    """(gt json, detections json, image dir): synthetic COCO val2014, each
    gt box shifted by `shift` and clipped to the image, score 0.9."""
    from ..data.synthetic import make_coco_dataset

    ann = make_coco_dataset(root, num_images=num_images, split="val", year="2014",
                            image_size=image_size, classes=classes)
    with open(ann) as f:
        gt = json.load(f)
    h, w = image_size
    dets = []
    for a in gt["annotations"]:
        x, y, bw, bh = a["bbox"]
        x = min(max(x + shift[0], 0.0), w - bw - 1)
        y = min(max(y + shift[1], 0.0), h - bh - 1)
        dets.append({"image_id": a["image_id"], "category_id": a["category_id"],
                     "bbox": [float(x), float(y), float(bw), float(bh)], "score": 0.9})
    dt_file = os.path.join(root, "dets.json")
    with open(dt_file, "w") as f:
        json.dump(dets, f)
    return ann, dt_file, os.path.join(root, "coco", "images", "val2014")


def score(ann: str, res_file: str):
    """cocoval's 12 stats, its table kept off stdout."""
    from ..data.coco_eval import cocoval

    with contextlib.redirect_stdout(io.StringIO()):
        return cocoval(ann, res_file)


def main(argv=None) -> dict:
    from . import trainval_rl

    p = argparse.ArgumentParser(description="RL pipeline on a learnable detector shift")
    p.add_argument("--epochs", default=3, type=int)
    p.add_argument("--layers", default=50, type=int)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--img_short", default=224, type=int)
    p.add_argument("--img_size", default=320, type=int)
    p.add_argument("--images", default=16, type=int)
    p.add_argument("--lr", default=0.01, type=float)
    p.add_argument("--device", default="cuda")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--work_dir", default=None)
    args = p.parse_args(argv)

    root = args.work_dir or tempfile.mkdtemp(prefix="rl_hw_")
    try:
        ann, dt_file, img_dir = build_fixture(root, args.images)
        pre = score(ann, dt_file)
        save_dir = os.path.join(root, "rl_models")
        common = ["--ann_file", ann, "--dt_file", dt_file, "--data_dir", img_dir,
                  "--save_dir", save_dir, "--img_short", str(args.img_short),
                  "--img_size", str(args.img_size), "--layers", str(args.layers),
                  "--batch_size", str(args.batch_size), "--lr", str(args.lr),
                  "--device", args.device]
        if args.pretrained:
            common += ["--pretrained", args.pretrained]
        trainval_rl.main(["--epochs", str(args.epochs)] + common)
        ev = trainval_rl.main(["-e", "--resume", os.path.join(save_dir,
                                                              f"rl_epoch_{args.epochs}.pth"),
                               "--maxk", "1"] + common)
        post = score(ann, os.path.join(save_dir, "rl_results.json"))
        rec = {"metric": "rl_e2e_hw_validation", "device": args.device,
               "pre_map50": float(pre[1]), "post_map50": float(post[1]),
               "pre_map": float(pre[0]), "post_map": float(post[0]),
               "delta_map": float(post[0] - pre[0]), "preck": ev["preck"],
               "ok": bool(post[0] >= pre[0])}
        print(json.dumps(rec), flush=True)
    finally:
        if args.work_dir is None:
            shutil.rmtree(root, ignore_errors=True)
    if not rec["ok"]:
        raise SystemExit(1)
    return rec


if __name__ == "__main__":
    main()
